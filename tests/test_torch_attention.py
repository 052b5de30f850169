"""The port's single-device attention against the JAX package's, on the CPU
at L = 256: ``local_attention`` with impl xla, chunked and flash (on the
CPU the flash impl runs kernel B5a's plain twin) against JAX's
``impl="xla"``/``"chunked"``.  The Pallas flash kernel does not run off the
TPU (``tests/test_sequence.py`` skips it), so JAX's xla path is its
oracle.  Also the shared impl resolution (``DISTLEARN_TPU_ATTN``,
``DISTLEARN_TPU_FLASH``, ``DISTLEARN_TPU_CHUNK``), the explicit-flash error
at ``L % 128 != 0``, the kernel route's error at a head dim it is not
built for, and the plain twin against a float64 softmax.

Tolerances: float32 1e-5 absolute (outputs of order 1; different
summation orders and, for flash, the online softmax's rescaling, measured
below 2e-6); bfloat16 2e-2, the reference's own flash tolerance
(``tests/test_sequence.py``)."""

from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.parallel import sequence as js  # noqa: E402
from distlearn_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distlearn_tpu_torch.parallel import sequence as ts  # noqa: E402

B, L, H, D = 2, 256, 4, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_ENV = ("DISTLEARN_TPU_ATTN", "DISTLEARN_TPU_FLASH", "DISTLEARN_TPU_CHUNK")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def _qkv(dtype="float32", shape=(B, L, H, D), seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["xla", "flash", "chunked"])
def test_local_attention_matches_jax(impl, causal, dtype):
    jx, tx = _qkv(dtype)
    # JAX's flash needs the TPU: its xla path is the oracle for flash
    want = js.local_attention(*jx, causal=causal,
                              impl="xla" if impl == "flash" else impl)
    got = ts.local_attention(*tx, causal=causal, impl=impl)
    assert got.dtype == tx[0].dtype and got.shape == (B, L, H, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("chunk", [None, 64, 128])
def test_chunked_causal_matches_jax(monkeypatch, chunk):
    jx, tx = _qkv()
    np.testing.assert_allclose(
        _np(ts.chunked_causal_attention(*tx, chunk=chunk)),
        _np(js.chunked_causal_attention(*jx, chunk=chunk)), atol=1e-5)


@pytest.mark.parametrize("head_dim", [8, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_against_float64_softmax(head_dim, causal):
    _, (q, k, v) = _qkv(shape=(1, 192, 2, head_dim), seed=4)
    qf, kf, vf = (t.permute(0, 2, 1, 3).double() for t in (q, k, v))
    s = qf @ kf.transpose(-1, -2) / math.sqrt(head_dim)
    if causal:
        s = s.masked_fill(torch.ones(192, 192, dtype=torch.bool).triu(1),
                          -math.inf)
    want = (s.softmax(-1) @ vf).permute(0, 2, 1, 3)
    got = fa.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal))
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=1e-5)


def test_flash_plain_rounds_p_to_bfloat16():
    """For bfloat16 inputs P is rounded to bfloat16 before PV (the Pallas
    kernel's ``p.astype(v.dtype)``): the plain twin equals a float32
    blockwise computation that does the same rounding, and differs from
    one that does not."""
    _, (q, k, v) = _qkv("bfloat16", shape=(1, 128, 1, 64), seed=5)
    out = fa.flash_attention_plain(q, k, v, True)
    ref32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), True)
    assert out.dtype == torch.bfloat16
    assert not torch.equal(out, ref32.to(torch.bfloat16))
    np.testing.assert_allclose(out.float().numpy(), ref32.numpy(), atol=2e-2)


def test_flash_wrapper_on_cpu_counts_no_launch_and_checks_shapes():
    _, (q, k, v) = _qkv(shape=(1, 128, 2, 64))
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention(q, k[:, :64], v)
    with pytest.raises(ValueError, match="CUDA"):
        fa._check(q, k, v)


def _spy(monkeypatch):
    calls = []
    real = ts.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)
    monkeypatch.setattr(ts, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("env,value,length,flash_runs", [
    ("DISTLEARN_TPU_ATTN", "flash", 256, True),
    ("DISTLEARN_TPU_ATTN", "flash", 200, False),    # env: quiet fallback
    ("DISTLEARN_TPU_ATTN", "flash", 64, False),     # below one 128 block
    ("DISTLEARN_TPU_FLASH", "1", 256, True),
    ("DISTLEARN_TPU_FLASH", "0", 256, False),
    ("DISTLEARN_TPU_ATTN", "xla", 256, False),
    ("DISTLEARN_TPU_ATTN", "chunked", 256, False),
])
def test_env_resolution_matches_jax(monkeypatch, env, value, length,
                                    flash_runs):
    monkeypatch.setenv(env, value)
    calls = _spy(monkeypatch)
    jx, tx = _qkv(shape=(1, length, 2, 64))
    got = ts.local_attention(*tx, causal=True)
    assert bool(calls) == flash_runs
    # JAX resolves the same impl; off the TPU its flash falls back to xla
    want = js.local_attention(*jx, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_explicit_flash_refuses_ragged_length(monkeypatch):
    _, tx = _qkv(shape=(1, 200, 2, 64))
    with pytest.raises(ValueError, match="multiple of 128"):
        ts.local_attention(*tx, causal=True, impl="flash")
    with pytest.raises(ValueError, match="multiple of 128"):
        ts.local_attention(*tx, causal=True, flash=True)
    monkeypatch.setenv("DISTLEARN_TPU_ATTN", "flash")
    calls = _spy(monkeypatch)
    _, tx = _qkv(shape=(1, 256, 2, 64))
    ts.local_attention(*tx, causal=True, flash=False)   # arg beats env
    assert not calls
    with pytest.raises(ValueError, match="impl"):
        ts.local_attention(*tx, impl="ring")


@pytest.mark.parametrize("request_by", ["env", "explicit"])
@pytest.mark.parametrize("head_dim,error", [
    (48, "head dim 48"),     # not built: raises, never a quiet xla
    (32, "CUDA device"),     # built: reaches the kernel's device check
])
def test_flash_off_cpu_goes_to_the_kernel_at_any_head_dim(
        monkeypatch, request_by, head_dim, error):
    """Off the CPU the flash impl reaches the kernel wrapper at every head
    dim once L engages it, as JAX's flash engages on L alone: a head dim
    the kernel is not built for raises instead of running xla.  Meta
    tensors stand in for the card's here: they are not CPU tensors, so they
    take the kernel route, and the wrapper checks their shape first."""
    kw = {"impl": "flash"} if request_by == "explicit" else {}
    if request_by == "env":
        monkeypatch.setenv("DISTLEARN_TPU_ATTN", "flash")
    q, k, v = (torch.empty((1, 256, 2, head_dim), device="meta")
               for _ in range(3))
    with pytest.raises(ValueError, match=error):
        ts.local_attention(q, k, v, causal=True, **kw)
    # on CPU tensors the plain twin takes any head dim
    jx, tx = _qkv(shape=(1, 256, 2, head_dim))
    np.testing.assert_allclose(
        _np(ts.local_attention(*tx, causal=True, **kw)),
        _np(js.local_attention(*jx, causal=True, impl="xla")), atol=1e-5)


@pytest.mark.parametrize("env", [None, "64", "100", "0", "x"])
@pytest.mark.parametrize("length", [128, 256, 4096])
def test_chunk_resolution_matches_jax(monkeypatch, env, length):
    if env is not None:
        monkeypatch.setenv("DISTLEARN_TPU_CHUNK", env)
    if env in ("0", "x"):
        with pytest.raises(ValueError) as want:
            js.resolve_chunk(length)
        with pytest.raises(ValueError) as got:
            ts.resolve_chunk(length)
        assert str(got.value) == str(want.value)
        return
    assert ts.resolve_chunk(length) == js.resolve_chunk(length)
    assert ts.chunked_engages(length) == js.chunked_engages(length)
