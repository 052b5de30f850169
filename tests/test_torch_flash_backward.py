"""Flash attention's gradient on the port (kernels B5a with residuals, B5b
and B5c; on the CPU their plain twins) against the actual Pallas kernels.

The JAX package's ``local_attention(impl="flash")`` calls the library
``flash_attention`` (``jax/experimental/pallas/ops/tpu/flash_attention.py``)
on the TPU only.  Under ``pltpu.force_tpu_interpret_mode()`` that library
function runs here on the CPU, forward and backward: the three
``pallas_call``s of B5a, B5b (``_flash_attention_dkv_kernel``) and B5c
(``_flash_attention_dq_kernel``), interpreted.  A child process (this file
run as a script) calls it directly on every case, with the transposes
``distlearn_tpu/parallel/sequence.py`` applies around it, and the tests
hold the port's forward twin and :class:`FlashAttention`'s dQ, dK and dV
against its outputs; the child takes about two seconds a case.  It runs
apart because importing ``jax.experimental.pallas.tpu`` into a test
process made ``tests/test_allreduce_ea.py``'s eight-device collectives
abort under the tier-1 run's load (``Fatal Python error: Aborted``; three
of three runs of that file beside busy processes, none without the
import).

Also: the port's flash, xla and chunked gradients through
``local_attention`` against the JAX package's xla and chunked gradients;
``gradcheck`` of the twins in float64; the launch counters stay put on the
CPU; the kernel wrappers refuse tensors that are not on the card.

Tolerances.  bfloat16: ``rtol = atol = 2e-2``, the reference's flash
tolerance (``tests/test_sequence.py``).  float32: ``rtol = 1e-4, atol =
1e-5`` against the Pallas kernels (measured at most 1.2e-6 absolute on
outputs and gradients of magnitude up to 4.3: the two differ only in the
order of float32 sums and the forward's rescaling; in bfloat16 at most
1 ulp of the output rounding), inside the reference's gradient tolerance
``rtol=2e-3, atol=2e-4`` (``tests/test_sequence.py``), which the float32
comparisons with JAX's xla and chunked routes use."""

from __future__ import annotations

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.parallel import sequence as js  # noqa: E402
from distlearn_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distlearn_tpu_torch.parallel import sequence as ts  # noqa: E402

B, H = 1, 2
#: (L, D, dtype, causal, q multiplier) of the cases held against the Pallas
#: kernels: the grid below, then D = 128 and q multiplied by 8 (scaled
#: scores of standard deviation 8, where the online rescale and the
#: backward's dP - di cancellation work hardest)
PALLAS_GRID = [(L, D, dtype, causal, 1.0)
               for L, D in ((128, 32), (128, 64), (256, 32), (256, 64))
               for dtype in ("float32", "bfloat16")
               for causal in (True, False)]
PALLAS_WIDE = [(128, 128, "float32", True, 1.0),
               (128, 128, "bfloat16", True, 1.0)]
PALLAS_LARGE = [(128, 64, "bfloat16", True, 8.0),
                (128, 64, "bfloat16", False, 8.0)]
PALLAS_CASES = PALLAS_GRID + PALLAS_WIDE + PALLAS_LARGE
ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
REF_TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("DISTLEARN_TPU_ATTN", "DISTLEARN_TPU_FLASH",
              "DISTLEARN_TPU_CHUNK"):
        monkeypatch.delenv(k, raising=False)


def _inputs(L, D, dtype, seed=0, mult=1.0):
    """q, k, v and the cotangent dO, ``[B, L, H, D]``, as numpy float32
    (rounded to ``dtype`` first) and as the port's tensors; q multiplied
    by ``mult`` before the rounding."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(4)]
    arrs[0] = arrs[0] * np.float32(mult)
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return [t.float().numpy() for t in tx], tx


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _port_grads(q, k, v, do, causal, impl=None):
    """o and (dq, dk, dv) of the port: :func:`fa.flash_attention`
    (``impl=None``) or ``local_attention(impl=...)``."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(q, k, v, causal) if impl is None else \
        ts.local_attention(q, k, v, causal=causal, impl=impl)
    return o, torch.autograd.grad(o, (q, k, v), do)


def _case_key(L, D, dtype, causal, mult=1.0):
    return f"{L}-{D}-{dtype}-{'causal' if causal else 'full'}" + (
        "" if mult == 1 else f"-q{mult:g}")


def _write_pallas_outputs(path: str) -> None:
    """The child process: o, dq, dk and dv of the library Pallas kernels,
    interpreted on the CPU, in the port's [B, L, H, D] layout, for every
    case of :data:`PALLAS_CASES`, into the npz file ``path``."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import \
        flash_attention as pallas_flash

    out = {}
    for L, D, dtype, causal, mult in PALLAS_CASES:
        arrs, _ = _inputs(L, D, dtype, seed=L + D, mult=mult)
        q, k, v, do = (jnp.asarray(a).astype(dtype).transpose(0, 2, 1, 3)
                       for a in arrs)

        def f(q, k, v, causal=causal, D=D):
            return pallas_flash(q, k, v, causal=causal,
                                sm_scale=1.0 / math.sqrt(D))

        with pltpu.force_tpu_interpret_mode():
            o, vjp = jax.vjp(f, q, k, v)
            grads = vjp(do)
        for name, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            out[f"{_case_key(L, D, dtype, causal, mult)}-{name}"] = np.asarray(
                t.transpose(0, 2, 1, 3).astype(jnp.float32))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def pallas_outputs(tmp_path_factory):
    """The child's outputs.  It starts from a plain environment: 64-bit
    mode off (the library indexes with int32 and does not trace with
    ``jax_enable_x64``, which tests/conftest.py turns on) and the JAX
    package importable from the repo root."""
    path = tmp_path_factory.mktemp("pallas") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    env.pop("JAX_ENABLE_X64", None)
    subprocess.run([sys.executable, __file__, str(path)], env=env,
                   check=True, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,D", [(128, 32), (128, 64), (256, 32),
                                 (256, 64)])
def test_twins_match_pallas_kernels_in_interpret_mode(pallas_outputs, L, D,
                                                      dtype, causal):
    _check_against_pallas(pallas_outputs, L, D, dtype, causal)


@pytest.mark.parametrize("L,D,dtype,causal,mult", PALLAS_WIDE,
                         ids=lambda x: str(x))
def test_twins_match_pallas_kernels_at_head_dim_128(pallas_outputs, L, D,
                                                    dtype, causal, mult):
    """The same at D = 128, the width whose B5b keeps K and V in shared
    memory on the card."""
    _check_against_pallas(pallas_outputs, L, D, dtype, causal, mult)


@pytest.mark.parametrize("L,D,dtype,causal,mult", PALLAS_LARGE,
                         ids=lambda x: str(x))
def test_backward_twins_match_pallas_kernels_at_large_scores(
        pallas_outputs, L, D, dtype, causal, mult):
    """q multiplied by 8, as ``chip_smoke.py`` also holds the card's
    tensor-core kernels.  The forward twin's o against the library's; the
    backward twins on the library's own di (``sum(o * dO)`` of its o) and
    the forward twin's m and l against its gradients.  End to end the two
    differ by more than the tolerance in dK: o agrees to one bfloat16 ulp,
    but where P is nearly one-hot ``dP - di`` cancels and scales that ulp
    of di up (measured 0.19 on dK of magnitude up to 20)."""
    key = _case_key(L, D, dtype, causal, mult)
    _, (q, k, v, do) = _inputs(L, D, dtype, seed=L + D, mult=mult)
    want_o, *want_g = (pallas_outputs[f"{key}-{n}"]
                       for n in ("o", "dq", "dk", "dv"))
    o, m, l = fa.flash_attention_fwd(q, k, v, causal)
    np.testing.assert_allclose(_np(o), want_o, **TOL[dtype])
    di = fa.flash_attention_di_plain(
        torch.from_numpy(want_o).to(q.dtype), do)
    dq = fa.flash_attention_dq_plain(q, k, v, do, m, l, di, causal)
    dk, dv = fa.flash_attention_dkv_plain(q, k, v, do, m, l, di, causal)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), want_g):
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(_np(got), want, err_msg=name,
                                   **TOL[dtype])


def _check_against_pallas(pallas_outputs, L, D, dtype, causal, mult=1.0):
    _, (q, k, v, do) = _inputs(L, D, dtype, seed=L + D, mult=mult)
    key = _case_key(L, D, dtype, causal, mult)
    want_o, *want_g = (pallas_outputs[f"{key}-{n}"]
                       for n in ("o", "dq", "dk", "dv"))
    o, m, l = fa.flash_attention_fwd(q, k, v, causal)
    assert o.dtype == q.dtype and m.shape == l.shape == (B, H, L)
    got_o, got_g = _port_grads(q, k, v, do, causal)
    assert torch.equal(got_o, o)
    np.testing.assert_allclose(_np(o), _np(want_o), **TOL[dtype])
    for name, got, want in zip(("dq", "dk", "dv"), got_g, want_g):
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "xla", "chunked"])
def test_local_attention_gradients_match_jax(impl, dtype):
    """Every impl of the port's ``local_attention`` differentiates: its
    gradients against JAX's xla route (flash, whose JAX kernel needs the
    TPU outside interpret mode) or JAX's own impl (xla, chunked)."""
    L, D = 256, 64
    arrs, (q, k, v, do) = _inputs(L, D, dtype, seed=7)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in arrs)
    jimpl = "xla" if impl == "flash" else impl
    want_o, vjp = jax.vjp(
        lambda a, b, c: js.local_attention(a, b, c, causal=True,
                                           impl=jimpl), jq, jk, jv)
    want_g = vjp(jdo)
    got_o, got_g = _port_grads(q, k, v, do, True, impl=impl)
    np.testing.assert_allclose(_np(got_o), _np(want_o), **REF_TOL[dtype])
    for name, got, want in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name,
                                   **REF_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_twins_pass_gradcheck_in_float64(causal):
    """The backward twins are the derivative of the forward twin: float64
    inputs (the twins accumulate in float64 there) through
    :class:`FlashAttention` pass ``torch.autograd.gradcheck``, at two
    64-row tiles so the causal walk crosses a tile boundary."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((1, 128, 1, 4), generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttention.apply(a, b, c, causal),
        (q, k, v), fast_mode=True)


def test_backward_twins_agree_with_float64_autograd():
    """dQ, dK and dV of the twins in float32 against autograd of a float64
    softmax attention on the same inputs."""
    _, (q, k, v, do) = _inputs(192, 64, "float32", seed=3)
    _, got = _port_grads(q, k, v, do, True)
    qd, kd, vd = (t.double().permute(0, 2, 1, 3).requires_grad_()
                  for t in (q, k, v))
    s = qd @ kd.transpose(-1, -2) / 8.0
    s = s.masked_fill(torch.ones(192, 192, dtype=torch.bool).triu(1),
                      -math.inf)
    want = torch.autograd.grad(s.softmax(-1) @ vd, (qd, kd, vd),
                               do.double().permute(0, 2, 1, 3))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.double().numpy(),
                                   b.permute(0, 2, 1, 3).numpy(), atol=2e-5)


def test_residuals_are_the_softmax_statistics():
    """m is the row max of the scaled causal scores and l the row sum of
    ``exp(s - m)`` (the library's residuals, whose reciprocal the backward
    multiplies by)."""
    _, (q, k, v, _) = _inputs(128, 32, "float32", seed=5)
    _, m, l = fa.flash_attention_fwd(q, k, v, True)
    s = (q.permute(0, 2, 1, 3).double() @ k.permute(0, 2, 3, 1).double()) \
        / math.sqrt(32)
    s = s.masked_fill(torch.ones(128, 128, dtype=torch.bool).triu(1),
                      -math.inf)
    want_m = s.amax(-1)
    np.testing.assert_allclose(m.double().numpy(), want_m.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        l.double().numpy(), (s - want_m[..., None]).exp().sum(-1).numpy(),
        rtol=1e-5)


def test_no_gradient_no_residuals_and_no_launch_on_cpu():
    """Without a gradient, flash_attention returns the forward twin's output
    directly; with one it goes through :class:`FlashAttention`.  On CPU
    tensors no wrapper counts a launch."""
    _, (q, k, v, do) = _inputs(128, 64, "bfloat16", seed=9)
    before = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, True))
    got_o, _ = _port_grads(q, k, v, do, True)
    assert type(got_o.grad_fn).__name__ == "FlashAttentionBackward"
    fa.flash_attention_bwd(q, k, v, *fa.flash_attention_fwd(q, k, v), do)
    assert (fa.flash_attention.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before


def test_kernel_wrappers_refuse_tensors_off_the_card():
    """Tensors that are not on the CPU take the kernel route, which checks
    them and raises before any launch: meta tensors stand in for the
    card's here."""
    q, k, v, do = (torch.empty((1, 128, 2, 64), device="meta")
                   for _ in range(4))
    st = torch.empty((1, 2, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_dq(q, k, v, q, do, st, st)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_dkv(q, k, v, do, st, st, st)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_dkv(*(torch.empty((1, 128, 2, 48), device="meta")
                                 for _ in range(4)), st, st, st)


if __name__ == "__main__":
    _write_pallas_outputs(sys.argv[1])
