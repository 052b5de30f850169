"""The port's int8/fp16 wire codec kernels (``distlearn_tpu_torch/ops/
wire_kernels.py``) against the JAX package's (``distlearn_tpu/ops/
wire_kernels.py``) on the same numpy inputs.

* The host route and the plain PyTorch versions of B3 (quantize with error
  feedback) and B4 (dequantize and add) equal JAX's host route bit for bit:
  q, scale, r and the applied center, at ragged and tile-sized lengths and
  at the 18 leaf sizes of the full-width CIFAR-10 convnet.
* The plain versions against the Pallas kernels run in interpret mode, with
  the JAX suite's own tolerances (tests/test_wire_kernels.py): q and scale
  bit for bit, r and the dequantized add within one ulp (the Pallas kernel
  may contract a multiply-add).
* Non-finite input raises, a zero leaf carries its whole delta, an empty
  leaf works — through the host route, the plain version and the CUDA
  wrapper on a CPU tensor (which takes the plain version).
* ``encode_ef_into`` builds the same manifest and wire bytes as JAX's for
  int8 and fp16 — numpy leaves through the host route and torch leaves
  through the tensor route — and the same residuals.

* B4 over a list of leaves (the server's one call per delta): the plain
  twin bit for bit against JAX's host route and within one ulp of its
  Pallas kernel at the convnet's 18 leaves cut from one byte frame at
  unaligned offsets; the port server's apply of a delta the JAX codec
  encoded; the list wrapper's launch count, one per table of leaves.

* B3 over a list of leaves (the client's one call per delta): two
  launches per table of leaves, the quantize reading the amax slots; the
  encode of a delta with a non-finite leaf raises as the JAX package's
  route does and leaves the same residuals (the leaves before it encoded,
  the rest untouched).

The CUDA kernels run on the card, where ``chip_smoke.py`` holds them against
the plain versions bit for bit.  Their code also runs here:
``ops/csrc/wire_kernels.cu`` compiles with g++ as host C++ over
``tests/torch_cuda_emu.h`` (as tests/test_torch_flash_emulated.py does for
the flash kernels), and the emulated kernels are held against the plain
versions bit for bit: B3's two passes over the convnet's 18 leaves with q
in one byte frame at unaligned offsets (and the twin against JAX's host
route there), over more leaves than one table holds with empty and zero
leaves, and with a NaN or an infinity in one leaf (the guard across
tables); the multi-leaf B4 likewise.  Those cases skip where no g++ is.
"""

import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu.comm import wire as jwire  # noqa: E402
from distlearn_tpu.ops import wire_kernels as jwk  # noqa: E402
from distlearn_tpu_torch.comm import wire  # noqa: E402
from distlearn_tpu_torch.models import cifar_convnet  # noqa: E402
from distlearn_tpu_torch.ops import wire_kernels as wk  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

#: the 18 leaf sizes of the full-width CIFAR-10 convnet, in wire order
CONVNET_SIZES = [p.numel() for p in
                 tree_leaves(cifar_convnet().init(0, device="cpu")[0])]
SIZES = [1, 5000, 4096, 3 * 4096 + 17] + CONVNET_SIZES


def _delta(n, seed):
    rng = np.random.default_rng([n, seed])
    return (rng.standard_normal(n) * 3).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.reshape(-1).view(np.dtype(f"u{a.dtype.itemsize}"))


def test_convnet_has_18_leaves():
    assert len(CONVNET_SIZES) == 18 and sum(CONVNET_SIZES) == 4_328_970


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_ef_host_and_plain_bitwise_vs_jax_host(n, seed):
    d = _delta(n, seed)
    q_ref, r_ref = np.empty(n, np.int8), np.empty(n, np.float32)
    s_ref = jwk.quantize_ef_into(d, q_ref, r_ref)
    q, r = np.empty(n, np.int8), np.empty(n, np.float32)
    assert wk.quantize_ef_into(d, q, r) == s_ref
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(_bits(r), _bits(r_ref))
    tq, ts, tr = wk.quantize_ef_plain(torch.from_numpy(d))
    assert ts == s_ref
    np.testing.assert_array_equal(tq.numpy(), q_ref)
    np.testing.assert_array_equal(_bits(tr.numpy()), _bits(r_ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_dequant_add_host_and_plain_bitwise_vs_jax_host(n, seed):
    rng = np.random.default_rng([n, seed, 1])
    c = rng.standard_normal(n).astype(np.float32)
    q = rng.integers(-127, 128, n).astype(np.int8)
    scale = float(np.abs(_delta(n, seed)).max()) / 127.0
    want = jwk.dequant_add(c, q, scale)
    np.testing.assert_array_equal(_bits(wk.dequant_add(c, q, scale)),
                                  _bits(want))
    got = wk.dequant_add_plain(torch.from_numpy(c), torch.from_numpy(q),
                               scale)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # in place, as the server applies it
    cc = torch.from_numpy(c.copy())
    wk.dequant_add_cuda(cc, torch.from_numpy(q), scale, out=cc)
    np.testing.assert_array_equal(_bits(cc.numpy()), _bits(want))


def _assert_within_one_ulp_of(got, want, magnitude):
    """|got - want| bounded per element by one ulp at the magnitude of the
    contracted product (tests/test_wire_kernels.py)."""
    tol = np.spacing(np.abs(magnitude).astype(np.float32))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.sum()} elements beyond 1 ulp; worst "
                           f"{np.abs(got - want).max()} vs tol {tol.max()}")


@pytest.mark.parametrize("n", [1, 5000, jwk._TILE_Q])
def test_quantize_ef_plain_vs_pallas_interpret(n):
    rng = np.random.default_rng(n)
    d = (rng.standard_normal(n) * 2).astype(np.float32)
    q_ref, s_ref, r_ref = jwk.quantize_ef_jax(d)
    q, s, r = wk.quantize_ef_plain(torch.from_numpy(d))
    assert s == s_ref
    np.testing.assert_array_equal(q.numpy(), q_ref)
    _assert_within_one_ulp_of(r.numpy(), r_ref.astype(np.float32), d)


@pytest.mark.parametrize("n", [1, 5000, jwk._TILE_Q])
def test_dequant_add_plain_vs_pallas_interpret(n):
    rng = np.random.default_rng(n + 5)
    t = rng.standard_normal(n).astype(np.float32)
    q = rng.integers(-127, 128, t.shape).astype(np.int8)
    want = jwk.dequant_add_jax(t, q, 0.021)
    got = wk.dequant_add_plain(torch.from_numpy(t), torch.from_numpy(q),
                               0.021).numpy()
    _assert_within_one_ulp_of(got, want,
                              np.abs(t) + np.abs(q.astype(np.float32) * 0.021))


def _poisoned(bad, n=130000):
    d = np.ones(n, np.float32)
    d[n - 1] = bad                     # in the LAST chunk
    return d


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_nonfinite_raises_everywhere(bad):
    d = _poisoned(bad)
    with pytest.raises(ValueError, match="non-finite"):
        wk.quantize_ef_into(d, np.empty(d.shape, np.int8), np.empty_like(d))
    with pytest.raises(ValueError, match="non-finite"):
        wk.quantize_ef_plain(torch.from_numpy(d))
    with pytest.raises(ValueError, match="non-finite"):
        wk.quantize_ef_cuda(torch.from_numpy(d))
    with pytest.raises(ValueError, match="non-finite"):
        wk.encode_ef_into([torch.from_numpy(d)],
                          [torch.zeros(d.shape)], "int8")
    with pytest.raises(ValueError, match="non-finite"):      # the reference
        jwk.quantize_ef_into(d, np.empty(d.shape, np.int8), np.empty_like(d))


@pytest.mark.parametrize("values", ["zeros", "denormal"])
def test_zero_scale_carries_whole_delta(values):
    d = np.zeros(64, np.float32) if values == "zeros" \
        else np.full(64, 1e-42, np.float32)
    q_ref, r_ref = np.empty(64, np.int8), np.empty(64, np.float32)
    s_ref = jwk.quantize_ef_into(d, q_ref, r_ref)
    q, s, r = wk.quantize_ef_cuda(torch.from_numpy(d))
    assert s == s_ref
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(r_ref))
    if values == "zeros":
        assert s == 0.0 and not q.any() and torch.equal(r, torch.zeros(64))


def test_empty_leaf():
    q, s, r = wk.quantize_ef_cuda(torch.zeros(0))
    assert s == 0.0 and q.shape == (0,) and r.shape == (0,)
    assert q.dtype == torch.int8
    assert wk.amax_cuda([torch.zeros(0), torch.ones(3) * -2]) == [0.0, 2.0]
    assert wk.dequant_add_cuda(torch.zeros(0), torch.zeros(0, dtype=torch.int8),
                               0.5).shape == (0,)
    payload = wk.encode_ef_into([torch.zeros((0, 4))], [torch.zeros((0, 4))],
                                "int8")
    assert payload.manifest == jwire.encode_leaves(
        [np.zeros((0, 4), np.float32)], "int8").manifest


def _zoo(seed):
    """Mixed raw/quantized frames, non-contiguous and zero-size leaves,
    f32/f64 (tests/test_wire_kernels.py::test_encode_ef_into_randomized_
    parity)."""
    rng = np.random.default_rng(seed)
    big = rng.standard_normal((64, 64)).astype(np.float32)
    return [
        (rng.standard_normal(977) * 5).astype(np.float32),
        np.arange(17, dtype=np.int32),
        big[::2, ::2],
        np.empty((0, 4), np.float32),
        rng.standard_normal((3, 1, 9)).astype(np.float64),
        np.zeros(33, np.float32),
        np.float32(2.5).reshape(()),
    ]


@pytest.mark.parametrize("route", ["host", "tensor"])
@pytest.mark.parametrize("use_fb", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("codec", ["int8", "fp16"])
def test_encode_ef_into_matches_jax(codec, seed, use_fb, route):
    leaves = _zoo(seed)
    ref = jwire.encode_leaves(leaves, codec)
    ref_dec = ref.decoded()
    # the JAX package's own fused encode gives the same manifest (its
    # residuals are checked against ref_dec below, like its own suite does)
    jres = [np.zeros(np.shape(a), np.float32 if a.dtype.kind != "f"
                     else a.dtype) for a in leaves]
    assert jwk.encode_ef_into(leaves, jres, codec).manifest == ref.manifest
    rdt = [a.dtype if a.dtype.kind == "f" else np.dtype(np.float32)
           for a in leaves]
    if route == "host":
        xs = leaves
        res = [np.full(a.shape, np.nan, dt) for a, dt in zip(leaves, rdt)]
    else:
        xs = [torch.tensor(a) for a in leaves]
        res = [torch.full(a.shape, float("nan"),
                          dtype=torch.from_numpy(np.empty(0, dt)).dtype)
               for a, dt in zip(leaves, rdt)]
    fb = wire.FrameBuffer() if use_fb else None
    payload = wk.encode_ef_into(xs, res, codec, out=fb)
    assert json.dumps(payload.manifest) == json.dumps(ref.manifest)
    for buf, rbuf in zip(payload.bufs, ref.bufs):
        np.testing.assert_array_equal(_bits(buf), _bits(rbuf))
    for a, r, dec in zip(leaves, res, ref_dec):
        r = r.numpy() if isinstance(r, torch.Tensor) else r
        want = (np.asarray(a, r.dtype) - dec if a.dtype.kind == "f"
                else np.zeros(a.shape, r.dtype))
        np.testing.assert_array_equal(_bits(r), _bits(want))
    if payload.frame is not None:
        cat = np.concatenate([np.asarray(b).reshape(-1).view(np.uint8)
                              for b in ref.bufs])
        np.testing.assert_array_equal(payload.frame, cat)
    assert (payload.frame is not None) == (use_fb or route == "tensor")


def test_encode_ef_into_raw_codec_stages_bytes():
    """The port's client stages raw deltas through the same path (the JAX
    package's encode_ef_into is for lossy codecs only)."""
    leaves = _zoo(0)
    ref = jwire.encode_leaves(leaves, "raw")
    payload = wk.encode_ef_into(
        [torch.tensor(a) for a in leaves], None,
        "raw", out=wire.FrameBuffer())
    assert payload.manifest == ref.manifest
    for buf, rbuf in zip(payload.bufs, ref.bufs):
        np.testing.assert_array_equal(_bits(buf), _bits(rbuf))


def test_wrappers_count_no_launch_on_the_cpu():
    before = (wk.amax_cuda.launches, wk.quantize_ef_cuda.launches,
              wk.dequant_add_cuda.launches)
    d = torch.from_numpy(_delta(100, 0))
    q, s, _ = wk.quantize_ef_cuda(d)
    wk.dequant_add_cuda(d, q, s)
    assert (wk.amax_cuda.launches, wk.quantize_ef_cuda.launches,
            wk.dequant_add_cuda.launches) == before


@pytest.mark.parametrize("rc", [1, -700])
def test_launch_counts_what_the_entry_point_reports(monkeypatch, rc):
    """A wrapper's count grows by the number of kernels the C entry point
    says it launched; a negative return is a refused launch and raises."""
    monkeypatch.setattr(wk._build, "function",
                        lambda source, name, sig: lambda *args: rc)
    monkeypatch.setattr(wk.dequant_add_cuda, "launches", 0)
    if rc < 0:
        with pytest.raises(RuntimeError, match="cudaError 700"):
            wk._launch(wk.dequant_add_cuda, "dl_dequant_add_f32")
        assert wk.dequant_add_cuda.launches == 0
    else:
        wk._launch(wk.dequant_add_cuda, "dl_dequant_add_f32")
        assert wk.dequant_add_cuda.launches == rc


# ---------------------------------------------------------------------------
# B4 over a list of leaves
# ---------------------------------------------------------------------------

def _frame_leaves(sizes, seed):
    """Centers, int8 leaves cut from one byte frame at the offsets a packed
    frame gives them (the first at byte 1: none 4-byte aligned by design)
    and scales."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(-127, 128, sum(sizes) + 1).astype(np.int8)
    offs = np.cumsum([1] + sizes[:-1])
    cs = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    qs = [frame[o:o + n] for o, n in zip(offs, sizes)]
    scales = [float(np.abs(_delta(n + 1, seed)).max()) / 127.0
              for n in sizes]
    return frame, cs, qs, scales


def test_dequant_add_leaves_plain_vs_jax_on_one_frame():
    """The twin of the server's one-call apply at the convnet's 18 leaves:
    bit for bit JAX's host route (the reference codec) and within one ulp
    of its Pallas kernel in interpret mode, which fuses the multiply-add
    (tests/test_wire_kernels.py's tolerance); the list wrapper on CPU
    tensors, in place, gives the same bits."""
    _, cs, qs, scales = _frame_leaves(CONVNET_SIZES, 7)
    tqs = [torch.from_numpy(q) for q in qs]     # views into the frame
    got = wk.dequant_add_leaves_plain([torch.from_numpy(c) for c in cs],
                                      tqs, scales)
    centers = [torch.from_numpy(c.copy()) for c in cs]
    assert wk.dequant_add_leaves_cuda(centers, tqs, scales,
                                      outs=centers) == centers
    for c, q, s, g, inplace in zip(cs, qs, scales, got, centers):
        want = jwk.dequant_add(c, q, s)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))
        np.testing.assert_array_equal(_bits(inplace.numpy()), _bits(want))
        _assert_within_one_ulp_of(
            g.numpy(), jwk.dequant_add_jax(c, q, s),
            np.abs(c) + np.abs(q.astype(np.float32) * np.float32(s)))


def test_server_apply_matches_the_jax_codec():
    """The port server's apply (one B4 call for the int8 leaves, raw leaves
    added) on the CPU route, of a frame the JAX package's codec encoded:
    the center equals JAX's host decode-and-add bit for bit.  The server
    is a standby (it awaits no client), seeded through ``init_server``."""
    from distlearn_tpu_torch.parallel import async_ea as pea
    from tests.net_util import reserve_port_window
    rng = np.random.default_rng(3)
    sizes = CONVNET_SIZES + [17]
    center = [rng.standard_normal(n).astype(np.float32) for n in sizes[:-1]]
    center.append(np.arange(17, dtype=np.int32))
    delta = [(rng.standard_normal(n) * 0.01).astype(np.float32)
             for n in sizes[:-1]] + [np.full(17, 3, np.int32)]
    ref = jwire.encode_leaves(delta, "int8")
    srv = pea.AsyncEAServer("127.0.0.1", reserve_port_window(4), 1,
                            standby=True, device="cpu")
    try:
        srv.init_server({f"{i:02d}": torch.from_numpy(a.copy())
                         for i, a in enumerate(center)})
        rx = srv._frame("rx")
        nbytes = sum(b.nbytes for b in ref.bufs)
        rx.reserve(nbytes)
        frame = rx.host_tensor(nbytes).numpy()
        frame[:] = np.concatenate([np.asarray(b).reshape(-1).view(np.uint8)
                                   for b in ref.bufs])
        srv._apply_delta(wire.PackedPayload(ref.manifest, ref.bufs, "int8",
                                            nbytes, 0, frame=frame), rx)
        assert srv.syncs_completed == 1
        for c, a, e, b in zip(srv.center, center, ref.manifest["leaves"],
                              ref.bufs):
            want = (jwk.dequant_add(a, b, e["scale"]) if e["enc"] == "int8"
                    else a + b)
            np.testing.assert_array_equal(_bits(c.numpy()), _bits(want))
    finally:
        srv.close()


@pytest.mark.parametrize("n_leaves,tables", [(1, 1), (18, 1), (64, 1),
                                             (65, 2), (130, 3)])
def test_dequant_add_leaves_counts_one_launch_per_table(monkeypatch,
                                                        n_leaves, tables):
    """The list wrapper hands every leaf to ONE entry-point call and counts
    the launches it reports: one per table of up to LEAF_CAPACITY leaves
    (device-less meta tensors stand in for the card's)."""
    calls = []

    def entry(outs, cs, qs, ns, scales, count, stream):
        calls.append((list(ns), list(scales), count))
        return -(-sum(n > 0 for n in list(ns)[:count]) // wk.LEAF_CAPACITY)

    monkeypatch.setattr(wk._build, "function", lambda source, name, sig:
                        entry if name == "dl_dequant_add_leaves_f32"
                        else None)
    monkeypatch.setattr(wk, "_stream", lambda device: None)
    monkeypatch.setattr(wk.dequant_add_leaves_cuda, "launches", 0)
    sizes = [1 + i % 7 for i in range(n_leaves)]
    cs = [torch.empty(n, device="meta") for n in sizes]
    qs = [torch.empty(n, dtype=torch.int8, device="meta") for n in sizes]
    scales = [0.1 * (i + 1) for i in range(n_leaves)]
    outs = wk.dequant_add_leaves_cuda(cs, qs, scales, outs=cs)
    assert outs == cs
    assert calls == [(sizes, [wk._f32(s) for s in scales], n_leaves)]
    assert wk.dequant_add_leaves_cuda.launches == tables
    with pytest.raises(ValueError, match="one q, scale and out"):
        wk.dequant_add_leaves_cuda(cs, qs[:-1], scales)


# ---------------------------------------------------------------------------
# The kernels' own code on the CPU (tests/torch_cuda_emu.h)
# ---------------------------------------------------------------------------

SOURCE = Path(wk.__file__).resolve().parent / "csrc" / "wire_kernels.cu"
SHIM = Path(__file__).resolve().parent / "torch_cuda_emu.h"


def host_source(cu: str) -> str:
    """The CUDA source as host C++ over the shim: each ``<<<grid, ...>>>``
    launch becomes the shim's ``emu_launch``."""
    assert cu.count("#include <cuda_runtime.h>") == 1
    text = cu.replace("#include <cuda_runtime.h>", f'#include "{SHIM.name}"')
    text, n = re.subn(r"(\w+)<<<(.+?), kThreads, 0, stream>>>\(",
                      r"emu_launch(\1, dim3(\2), kThreads, ", text,
                      flags=re.S)
    assert n == 3, n
    return text


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    d = tmp_path_factory.mktemp("wire_emu")
    src = d / "wire_emu.cpp"
    src.write_text(host_source(SOURCE.read_text()))
    so = d / "libwire_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{SHIM.parent}", "-o", str(so), str(src)],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, sig in wk._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sig, ctypes.c_int
    return lib


def _ptrs(ts, ctype=ctypes.c_void_p):
    return (ctype * len(ts))(*(t.data_ptr() for t in ts))


def test_emulated_dequant_add_leaves_past_the_table(emu):
    """140 leaves, three tables: empty ones, lengths off a multiple
    of 4, centers and outputs off their 16-byte alignment, q leaves at odd
    offsets of one byte frame, half of them in place.  Every output equals
    the twin bit for bit, and the entry point reports one launch per table
    of up to LEAF_CAPACITY non-empty leaves."""
    rng = np.random.default_rng(5)
    sizes = [int(n) for n in rng.integers(1, 6000, 140)]
    sizes[:4] = [0, 1, 4 * 4096 + 3, 0]
    _, cs, qs, scales = _frame_leaves(sizes, 5)
    tcs = []
    for i, c in enumerate(cs):      # every third off its 16-byte alignment
        t = torch.empty(c.size + 1)[i % 3 == 0:][:c.size]
        t.copy_(torch.from_numpy(c))
        tcs.append(t)
    tqs = [torch.from_numpy(q) for q in qs]
    outs = [c if i % 2 else torch.empty_like(c) for i, c in enumerate(tcs)]
    want = wk.dequant_add_leaves_plain(tcs, tqs, scales)
    nonempty = sum(n > 0 for n in sizes)
    rc = emu.dl_dequant_add_leaves_f32(
        _ptrs(outs), _ptrs(tcs), _ptrs(tqs),
        (ctypes.c_int64 * len(sizes))(*sizes),
        (ctypes.c_float * len(sizes))(*map(wk._f32, scales)), len(sizes),
        None)
    assert rc == -(-nonempty // wk.LEAF_CAPACITY) == 3
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(_bits(o.numpy()), _bits(w.numpy()))
    assert emu.dl_dequant_add_leaves_f32(None, None, None, None, None, 0,
                                         None) == 0


def test_emulated_single_leaf_codec_kernels(emu):
    """amax, quantize with error feedback and the one-leaf dequantize-add
    at a ragged length, aligned and a float off alignment (B3's passes as
    the one-leaf table that amax_cuda and quantize_ef_cuda launch)."""
    d = torch.from_numpy(_delta(5003, 9))
    for off in (0, 1):
        x = torch.empty(5004)[off:off + 5003]
        x.copy_(d)
        slot = torch.full((1,), -1, dtype=torch.int32)
        xp, n = _ptrs([x]), (ctypes.c_int64 * 1)(5003)
        assert emu.dl_amax_leaves_f32(slot.data_ptr(), xp, n, 1, None) == 1
        assert slot.view(torch.float32).item() == wk.amax_plain(x)
        q0, s, r0 = wk.quantize_ef_plain(x)
        q = torch.empty(5004, dtype=torch.int8)[off:off + 5003]
        r = torch.empty(5004)[off:off + 5003]
        assert emu.dl_quant_ef_leaves_f32(_ptrs([q]), _ptrs([r]), xp, n,
                                          slot.data_ptr(), 1, None) == 1
        assert wk.scales_of(slot) == [s]
        assert torch.equal(q, q0)
        np.testing.assert_array_equal(_bits(r.numpy()), _bits(r0.numpy()))
        out = torch.empty(5004)[off:off + 5003]
        assert emu.dl_dequant_add_f32(out.data_ptr(), x.data_ptr(),
                                      q.data_ptr(), 5003, wk._f32(s),
                                      None) == 1
        np.testing.assert_array_equal(
            _bits(out.numpy()), _bits(wk.dequant_add_plain(x, q, s).numpy()))


def _quant_leaves_emulated(emu, xs, qs, rs):
    """B3's two entry points over the leaves: (slots, amax launches,
    quantize launches)."""
    n = len(xs)
    slots = torch.full((n,), -1, dtype=torch.int32)
    ns = (ctypes.c_int64 * n)(*(x.numel() for x in xs))
    xp = _ptrs(xs)
    amax = emu.dl_amax_leaves_f32(slots.data_ptr(), xp, ns, n, None)
    quant = emu.dl_quant_ef_leaves_f32(_ptrs(qs), _ptrs(rs), xp, ns,
                                       slots.data_ptr(), n, None)
    return slots, amax, quant


# B3 over every leaf of a delta: the two entry points against the twin

_SENTINEL_Q = 0x55          # q and r bytes a pass must leave untouched


def _b3_inputs(sizes, seed, off_x=False, poison=None, bad=np.nan):
    """Float32 leaves (every third one element off its 16-byte alignment
    when ``off_x``), leaf ``poison`` holding ``bad`` at one element, leaf
    4 all zeros of both signs when there are more than 4; and a maker of
    fresh outputs: q windows cut from one byte frame at the offsets a
    packed frame gives them (the first at byte 1), r leaves, both filled
    with sentinels."""
    rng = np.random.default_rng(seed)
    xs = []
    for i, n in enumerate(sizes):
        t = torch.empty(n + 1)[int(off_x and i % 3 == 0):][:n]
        a = (rng.standard_normal(n) * 3).astype(np.float32)
        if i == 4 and len(sizes) > 4:
            a = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        if i == poison:
            a[rng.integers(n)] = bad
        t.copy_(torch.from_numpy(a))
        xs.append(t)
    offs = np.cumsum([1] + list(sizes[:-1]))

    def outputs():
        frame = torch.full((sum(sizes) + 1,), _SENTINEL_Q, dtype=torch.int8)
        qs = [frame[o:o + n] for o, n in zip(offs, sizes)]
        rs = [torch.full((n,), -7.5) for n in sizes]
        return frame, qs, rs
    return xs, outputs


def _assert_b3_equals_twin(emu, sizes, xs, outputs):
    """The emulated passes against quantize_ef_leaves_plain: q bytes (the
    whole frame, sentinels included), r bits and the amax slots bit for
    bit; one launch of each pass per table.  Returns the slots and the
    kernels' q and r."""
    frame, qs, rs = outputs()
    tframe, tqs, trs = outputs()
    slots, amax_launches, quant_launches = _quant_leaves_emulated(
        emu, xs, qs, rs)
    amaxes = wk.quantize_ef_leaves_plain(xs, tqs, trs)
    tables = -(-sum(n > 0 for n in sizes) // wk.LEAF_CAPACITY)
    assert amax_launches == quant_launches == tables
    np.testing.assert_array_equal(slots.numpy(),
                                  wk.amax_bits_plain(xs).numpy())
    assert wk.first_nonfinite(slots) == wk.first_nonfinite(amaxes)
    assert torch.equal(frame, tframe)
    for r, t in zip(rs, trs):
        np.testing.assert_array_equal(_bits(r.numpy()), _bits(t.numpy()))
    return slots, qs, rs


def test_emulated_quantize_ef_leaves_on_one_frame(emu):
    """B3 over the convnet's 18 leaves in two launches, q written into
    windows of one byte frame at unaligned offsets, as the client's encode
    writes them: bit for bit the twin, and the twin bit for bit JAX's host
    route (the reference codec), scales included."""
    xs, outputs = _b3_inputs(CONVNET_SIZES, 11)
    slots, qs, rs = _assert_b3_equals_twin(emu, CONVNET_SIZES, xs, outputs)
    for x, q, r, s in zip(xs, qs, rs, wk.scales_of(slots)):
        a = x.numpy()
        q_ref, r_ref = np.empty(a.size, np.int8), np.empty(a.size, np.float32)
        assert jwk.quantize_ef_into(a, q_ref, r_ref) == s
        np.testing.assert_array_equal(q.numpy(), q_ref)
        np.testing.assert_array_equal(_bits(r.numpy()), _bits(r_ref))


@pytest.mark.parametrize("poison", [None, 10, 66])
def test_emulated_quantize_ef_leaves_past_the_table(emu, poison):
    """70 leaves, two tables of each pass: empty leaves, a leaf of zeros
    of both signs (q = 0, r = x bit for bit), ragged lengths, leaves off
    their 16-byte alignment.  A NaN in leaf 10 (first table) stops every
    later leaf, the second table's too; one in leaf 66 (second table)
    stops that table's leaves from 66 on and no leaf before it."""
    rng = np.random.default_rng(12)
    sizes = [int(n) for n in rng.integers(1, 3000, 70)]
    sizes[:5] = [0, 1, 4 * 4096 + 3, 0, 37]
    xs, outputs = _b3_inputs(sizes, 12, off_x=True, poison=poison)
    slots, qs, rs = _assert_b3_equals_twin(emu, sizes, xs, outputs)
    stop = 70 if poison is None else poison
    assert wk.first_nonfinite(slots) == stop
    assert not qs[4].any() and torch.equal(rs[4].view(torch.int32),
                                           xs[4].view(torch.int32))
    for i, (q, r) in enumerate(zip(qs, rs)):
        untouched = bool((q == _SENTINEL_Q).all() and (r == -7.5).all())
        assert untouched == (i >= stop or sizes[i] == 0), i
    if poison is not None:
        with pytest.raises(ValueError, match="non-finite"):
            wk.scales_of(slots)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_emulated_quantize_ef_leaves_stop_at_a_nonfinite_leaf(emu, bad):
    """A NaN, +inf or -inf in leaf 5 of 18: leaves 0-4 are encoded, the q
    and r bytes of leaves 5-17 are untouched, as the JAX route leaves them
    when it raises at leaf 5; the slots make the host raise."""
    sizes = [int(n) for n in np.random.default_rng(13).integers(1, 9000, 18)]
    xs, outputs = _b3_inputs(sizes, 13, poison=5, bad=bad)
    slots, qs, rs = _assert_b3_equals_twin(emu, sizes, xs, outputs)
    for i, (x, q, r) in enumerate(zip(xs, qs, rs)):
        if i < 5:
            q0, _, r0 = wk.quantize_ef_plain(x)
            assert torch.equal(q, q0) and torch.equal(r, r0)
        else:
            assert (q == _SENTINEL_Q).all() and (r == -7.5).all()
    assert wk.first_nonfinite(slots) == 5
    with pytest.raises(ValueError, match="non-finite"):
        wk.scales_of(slots)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_encode_nonfinite_leaf_matches_jax_route(bad):
    """encode_ef_into on torch leaves (the port's tensor route, on the CPU
    through the twin) and the JAX package's host route, on the same numpy
    leaves with leaf 5 poisoned and raw int32 leaves before and after it:
    both raise ValueError, and afterwards the residual lists are bit for
    bit equal (leaves 0-4 carry their new residuals, raw ones zero; the
    rest keep what they held)."""
    rng = np.random.default_rng(14)
    leaves = [(rng.standard_normal(n) * 2).astype(np.float32)
              for n in (300, 17, 4099, 1, 64, 513, 77, 2000)]
    leaves[1] = np.arange(17, dtype=np.int32)
    leaves[6] = np.arange(77, dtype=np.int32)
    leaves[5][100] = bad
    held = [np.full(a.shape, -7.5, np.float32) for a in leaves]
    jres = [h.copy() for h in held]
    with pytest.raises(ValueError, match="non-finite"):
        jwk.encode_ef_into(leaves, jres, "int8")
    tres = [torch.from_numpy(h.copy()) for h in held]
    with pytest.raises(ValueError, match="non-finite"):
        wk.encode_ef_into([torch.from_numpy(a) for a in leaves], tres,
                          "int8", out=wire.FrameBuffer())
    for i, (j, t, h) in enumerate(zip(jres, tres, held)):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))
        assert np.array_equal(j, h) == (i >= 5), i


@pytest.mark.parametrize("n_leaves,tables", [(1, 1), (18, 1), (64, 1),
                                             (65, 2), (130, 3)])
def test_quantize_ef_leaves_counts_two_launches_per_table(monkeypatch,
                                                          n_leaves, tables):
    """The list wrapper hands every leaf to ONE call of each entry point,
    the quantize reading the slots the amax wrote, and counts the launches
    they report: one of each per table of up to LEAF_CAPACITY leaves, the
    amax on amax_leaves_cuda (device-less meta tensors stand in for the
    card's)."""
    calls = []

    def per_table(ns, count):
        return -(-sum(n > 0 for n in list(ns)[:count]) // wk.LEAF_CAPACITY)

    def amax(slots, xs, ns, count, stream):
        calls.append(("amax", slots, list(ns), count))
        return per_table(ns, count)

    def quant(qs, rs, xs, ns, slots, count, stream):
        calls.append(("quant", slots, list(ns), count))
        return per_table(ns, count)

    entries = {"dl_amax_leaves_f32": amax, "dl_quant_ef_leaves_f32": quant}
    monkeypatch.setattr(wk._build, "function",
                        lambda source, name, sig: entries[name])
    monkeypatch.setattr(wk, "_stream", lambda device: None)
    for fn in (wk.amax_leaves_cuda, wk.quantize_ef_leaves_cuda,
               wk.amax_cuda, wk.quantize_ef_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    sizes = [1 + i % 7 for i in range(n_leaves)]
    xs = [torch.empty(n, device="meta") for n in sizes]
    slots = torch.empty(n_leaves, dtype=torch.int32, device="meta")
    qs, got, rs = wk.quantize_ef_leaves_cuda(xs, slots=slots)
    assert got is slots and [q.dtype for q in qs] == [torch.int8] * n_leaves
    assert [tuple(r.shape) for r in rs] == [(n,) for n in sizes]
    ptr = slots.data_ptr()
    assert calls == [("amax", ptr, sizes, n_leaves),
                     ("quant", ptr, sizes, n_leaves)]
    assert (wk.amax_leaves_cuda.launches,
            wk.quantize_ef_leaves_cuda.launches) == (tables, tables)
    assert wk.amax_cuda.launches == wk.quantize_ef_cuda.launches == 0
    with pytest.raises(ValueError, match="one q and one r"):
        wk.quantize_ef_leaves_cuda(xs, qs[:-1], rs)


def test_amax_slots_on_the_cpu():
    """amax_leaves_cuda on CPU leaves takes amax_bits_plain: the bits of
    each max|x| (an empty leaf 0, a NaN leaf its largest NaN's bits), into
    the given slots; the host helpers read them as the JAX route would."""
    nan = np.float32(np.nan).view(np.uint32) | np.uint32(0x1234)
    xs = [torch.zeros(0), torch.tensor([-2.0, 1.5]), torch.tensor([3.0, 0.0]),
          torch.from_numpy(np.array([1.0, nan.view(np.float32)], np.float32))]
    slots = torch.full((4,), -1, dtype=torch.int32)
    assert wk.amax_leaves_cuda(xs, slots) is slots
    np.testing.assert_array_equal(
        slots.numpy().view(np.uint32),
        [0, np.float32(2).view(np.uint32), np.float32(3).view(np.uint32),
         nan])
    assert torch.equal(wk.amax_leaves_cuda(xs), slots)
    assert wk.amaxes_of(slots)[:3] == [0.0, 2.0, 3.0]
    assert wk.first_nonfinite(slots) == 3 and wk.first_nonfinite(slots[:3]) == 3
    assert wk.scales_of(slots[:3]) == [0.0, 2.0 / 127.0, 3.0 / 127.0]
    with pytest.raises(ValueError, match="non-finite"):
        wk.scales_of(slots)


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """Threads that reach a kernel's first use at once (the AsyncEA roles
    running as threads, each encoding its first delta) wait for ONE build:
    they would otherwise share its temporary file, and all but one fail.
    A stand-in ``nvcc`` that takes a while and counts its runs."""
    import threading

    from distlearn_tpu_torch.ops import _build
    runs = tmp_path / "runs"
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {runs}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
        "  shift\n"
        "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    got, errs = [], []

    def first_use():
        try:
            got.append(_build.built("wire_kernels.cu"))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errs == [] and len(got) == 4 and len(set(got)) == 1
    assert got[0].read_text() == "lib\n"
    assert runs.read_text().count("run") == 1
