"""The port's SIMD C host codec (``distlearn_tpu_torch/ops/wire_native.py``)
against the JAX package's (the same C source and flags, built apart):
bit for bit on the same inputs — normal, huge, tiny and subnormal scales,
non-finite input — and the port's host route with and without it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.ops import wire_native as jax_native  # noqa: E402
from distlearn_tpu_torch.comm import wire  # noqa: E402
from distlearn_tpu_torch.ops import wire_kernels as wk  # noqa: E402
from distlearn_tpu_torch.ops import wire_native  # noqa: E402

# 10**e spans scales from subnormal (amax/127 below 1.2e-38) to huge
EXPONENTS = [0, -12, 12, -37, -40, -42, 30]


def _delta(seed, e, n=40013):
    rng = np.random.default_rng(abs(seed))
    return (rng.standard_normal(n) * 10.0 ** e).astype(np.float32)


def _quant(mod, d):
    flat = d.copy()
    amax = mod.amax_checked(flat)
    scale = np.float32(amax / 127.0)
    q = np.empty(flat.size, np.int8)
    r = np.empty_like(flat)
    if scale != 0:
        mod.quant_ef_f32(flat, scale, q, r)
    return amax, scale, q, r


def test_both_codecs_build_here():
    assert wire_native.available(), wire_native.why_unavailable()
    assert jax_native.available(), jax_native.why_unavailable()
    assert wire_native.why_unavailable() is None


@pytest.mark.parametrize("e", EXPONENTS)
def test_codec_bit_for_bit_with_jax(e):
    d = _delta(e + 50, e)
    ja, js, jq, jr = _quant(jax_native, d)
    pa, ps, pq, pr = _quant(wire_native, d)
    assert np.float32(ja).tobytes() == np.float32(pa).tobytes()
    assert js.tobytes() == ps.tobytes()
    if e <= -40:
        assert 0 < ps < np.finfo(np.float32).tiny      # a subnormal scale
    np.testing.assert_array_equal(jq, pq)
    assert jr.tobytes() == pr.tobytes()
    t = _delta(e + 7, 0)
    jo, po = np.empty_like(t), np.empty_like(t)
    assert jax_native.dequant_add_f32(t, pq, ps, jo)
    assert wire_native.dequant_add_f32(t, pq, ps, po)
    assert jo.tobytes() == po.tobytes()
    ji, pi = t.copy(), t.copy()
    jax_native.dequant_add_f32(ji, pq, ps, ji)          # in place
    wire_native.dequant_add_f32(pi, pq, ps, pi)
    assert ji.tobytes() == pi.tobytes() == jo.tobytes()


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_input(bad):
    d = _delta(1, 0)
    d[777] = bad
    assert np.isnan(wire_native.amax_checked(d))
    assert np.isnan(jax_native.amax_checked(d))
    q, r = np.empty(d.size, np.int8), np.empty_like(d)
    with pytest.raises(ValueError, match="non-finite"):
        wk.quantize_ef_into(d, q, r)


@pytest.mark.parametrize("e", EXPONENTS)
def test_host_route_with_and_without_the_codec(monkeypatch, e):
    """``quantize_ef_into`` and ``dequant_add`` give the same bits through
    the C codec and through the blocked numpy loops (pinned with
    ``DISTLEARN_TPU_WIREC=0``), and the same payload as the reference
    encoder ``wire.encode_leaves``."""
    d = _delta(e + 3, e, 167 * 239).reshape(167, 239)
    t = _delta(e + 4, 0, 167 * 239).reshape(167, 239)

    def route():
        q, r = np.empty(d.shape, np.int8), np.empty_like(d)
        s = wk.quantize_ef_into(d, q, r)
        fresh = wk.dequant_add(t, q, s)
        inpl = t.copy()
        wk.dequant_add(inpl, q, s, out=inpl)
        return s, q, r, fresh, inpl

    assert wire_native.usable_quant(d, np.empty(d.shape, np.int8), d.copy())
    native = route()
    monkeypatch.setenv("DISTLEARN_TPU_WIREC", "0")
    assert not wire_native.available()
    assert "disabled" in wire_native.why_unavailable()
    blocked = route()
    assert native[0] == blocked[0]
    for a, b in zip(native[1:], blocked[1:]):
        assert a.tobytes() == b.tobytes()
    ref = wire.encode_leaves([d], "int8")
    assert ref.manifest["leaves"][0]["scale"] == native[0]
    np.testing.assert_array_equal(ref.bufs[0], native[1])


def test_unusable_inputs_take_numpy():
    big = np.zeros((8, 8), np.float32)
    assert not wire_native.usable_quant(
        big[::2, ::2], np.zeros((4, 4), np.int8), np.zeros((4, 4), np.float32))
    d64 = np.zeros(8, np.float64)
    assert not wire_native.usable_quant(d64, np.zeros(8, np.int8), d64.copy())
    base = np.zeros(150, np.float32)
    base[:100] = np.arange(100, dtype=np.float32)
    q = np.full(100, 3, np.int8)
    want = base[:100].copy() + q * np.float32(0.5)
    got = wk.dequant_add(base[:100], q, 0.5, out=base[50:150])  # overlap
    np.testing.assert_array_equal(got, want)
