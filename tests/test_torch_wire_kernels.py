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

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against the plain versions bit for bit.
"""

import json

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
