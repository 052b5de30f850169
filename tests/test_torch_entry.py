"""The port's entry points in ``distlearn_tpu_torch/graft_entry.py``
against the root ``__graft_entry__.py`` of the JAX package, on the CPU:
``entry()``'s forward on the JAX weights (``from_jax``) within 1e-5 of the
JAX forward (the float32 log-probs tolerance of tests/test_torch_models.py),
and ``dryrun_multichip(2)`` on two gloo ranks, finite and naming what waits.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import __graft_entry__  # noqa: E402
from distlearn_tpu_torch import graft_entry  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax  # noqa: E402

LOGP_ATOL = 1e-5


def test_entry_matches_the_jax_entry():
    jfn, (jparams, jx) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jx))
    fn, (params, x) = graft_entry.entry(device="cpu")
    assert x.shape == (8, 32, 32, 3) and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    got = fn(from_jax(jax.device_get(jparams), {})[0], x)
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGP_ATOL)
    # the port's own seeded weights give finite log-probs summing to 1
    own = fn(params, x)
    assert torch.isfinite(own).all()
    torch.testing.assert_close(own.exp().sum(-1), torch.ones(8))


def test_entry_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_dryrun_multichip_two_ranks(capsys):
    out = graft_entry.dryrun_multichip(2)
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip(2): sgd loss")
    for key in ("sgd_loss", "ea_loss", "lm_loss"):
        assert math.isfinite(out[key]), out
    assert len(out["scan_losses"]) == len(out["cycle_losses"]) == 2
    # the scan's first step is the per-call step, from the same init
    assert out["scan_losses"][0] == out["sgd_loss"]
    assert out["cycle_losses"][0] == out["ea_loss"]
    for part, item in graft_entry.WAITING.items():
        assert item.startswith("ROADMAP A1") and out["waiting"][part] == item
        assert f"{part} ({item})" in line
    assert "pipeline-parallel LM (GPipe) (ROADMAP A11)" in line
    assert "zigzag" in line and "ZeRO" in line
