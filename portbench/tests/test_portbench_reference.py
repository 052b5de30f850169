"""The plain models against the port's on seeded weights, on the CPU: the
same parameter layout, and in float64 the same loss, gradients and
running statistics (the comparison a run makes on the card, at a size a
test holds)."""

from functools import partial

import pytest
import torch

from portbench import reference, spec, system
from portbench.reference.common import (generator, leaves, make_params,
                                        sgd_steps, tree_map)

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _program_model(cfg, dtype=torch.float32):
    from distlearn_tpu_torch import models
    return system.program_model(models, cfg, dtype=dtype, compute_dtype=None)


@pytest.mark.parametrize("workload", CELLS)
def test_parameter_layout_is_the_programs(workload):
    cfg = spec.cell(workload).config
    params, state = _program_model(cfg).init(0, "cpu")
    mine = sorted((p, s) for p, s, _, _ in
                  reference.model(cfg).param_specs(cfg))
    assert [(p, tuple(t.shape)) for p, t in leaves(params)] == mine
    ref_state = reference.model(cfg).state_init(cfg, "cpu")
    assert [(p, tuple(t.shape)) for p, t in leaves(state)] == \
        [(p, tuple(t.shape)) for p, t in leaves(ref_state)]


@pytest.mark.parametrize("workload", CELLS)
def test_float64_step_matches_the_program(workload):
    from distlearn_tpu_torch.models.core import loss_fn
    cfg = dict(spec.cell(workload).config)
    cfg.update(image_size=32, num_classes=10)
    ref = reference.model(cfg)
    model = _program_model(cfg, torch.float64)
    p0 = tree_map(torch.Tensor.double,
                  make_params(ref.param_specs(cfg), 5, "cpu"))
    s0 = tree_map(torch.Tensor.double, ref.state_init(cfg, "cpu"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 32, 3, generator=g, dtype=torch.float64)
    y = torch.randint(0, cfg["num_classes"], (4,), generator=g)

    req = tree_map(lambda t: t.clone().requires_grad_(), p0)
    loss, (_, state) = loss_fn(model, req, s0, x, y, train=True,
                               rng=generator(5, "dropout", "cpu"))
    grads = torch.autograd.grad(loss, [t for _, t in leaves(req)])
    out = sgd_steps(partial(ref.loss, cfg), p0, s0, [(x, y)], 0.1,
                    generator(5, "dropout", "cpu"))
    # float64; the port's batchnorm takes the variance as E[x^2] - E[x]^2,
    # the reference in two passes, which differ where a channel's mean is
    # far from its spread (up to about 1e-5 of an element here)
    assert float(loss.detach()) == pytest.approx(out["loss"][0], rel=1e-10)
    for (path, a), b in zip(leaves(out["grad1"]), grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-8,
                                   msg=lambda m: f"{path}: {m}")
    for (path, a), (_, b) in zip(leaves(out["state"]), leaves(state)):
        torch.testing.assert_close(b, a, rtol=1e-10, atol=1e-12)


def test_lower_precisions_round_as_stated():
    from portbench.reference.common import round_to
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    # float8 keeps its relative step where the scaled value is normal
    normal = x.abs() >= x.abs().max() / 2 ** 14
    rel = lambda f: ((round_to(x, f) - x).abs() / x.abs())[normal].max()  # noqa
    assert rel("tf32") <= 2.0 ** -11
    assert 2.0 ** -6 < rel("e4m3") <= 2.0 ** -4
    assert 2.0 ** -4 < rel("e5m2") <= 2.0 ** -3
    assert rel(None) == 0
