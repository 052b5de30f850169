"""The port's ResNet-50 v1.5 against the JAX package's (tests/test_resnet.py
replayed on the port, on the CPU):

* 25,557,032 parameters in 161 leaves, in the JAX model's sorted-key order
  and shapes, cut into the JAX package's 8 buckets at 16 MiB;
* ``from_jax``/``to_jax`` carry the tree both ways, the SkipInit variant's
  0-d ``alpha`` leaves included;
* forward log-probs, gradients and batchnorm statistics against JAX at 32^2
  with 10 classes, from the same weights (the residual branches switched on
  with seeded batchnorm scales and alphas), for ``norm="batch"`` and
  ``"none"``;
* zero-init of each block's last scale, the eval path, SkipInit's structure
  and its alpha gradients, the norm validation;
* a two-rank bucketed SGD step over gloo against the JAX package's
  two-node mesh.

Tolerances.  ``norm="batch"`` is compared in float64: across 53 batchnorms
E[x^2] - E[x]^2 amplifies float32's convolution-order differences (XLA's
against PyTorch's) to 1e-3 in the log-probs at this size, far past
tests/test_torch_models.py's 1e-5, while in float64 the two packages agree
to 1e-12; the float64 checks use ``F64_*`` below, tighter than that file's.
``norm="none"`` has no batchnorm and is compared in float32 at that file's
own tolerances.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import resnet as jresnet  # noqa: E402
from distlearn_tpu.models.core import loss_fn as jloss_fn  # noqa: E402
from distlearn_tpu.ops import flatten as jflatten  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.train import trainer as jtr  # noqa: E402
from distlearn_tpu_torch.models import loss_fn, param_count, resnet  # noqa: E402
from distlearn_tpu_torch.models import nn  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax, to_jax  # noqa: E402
from distlearn_tpu_torch.ops import flatten  # noqa: E402
from distlearn_tpu_torch.utils.tree import (tree_flatten,  # noqa: E402
                                            tree_unflatten)

import torch_optim_dist_worker  # noqa: E402
from test_torch_models import GRAD_ATOL, GRAD_RTOL_OF_MAX, LOGP_ATOL  # noqa: E402

F64_LOGP_ATOL = 1e-9
F64_GRAD_RTOL_OF_MAX = 1e-9
BUCKETS_16MIB = (3_631_104, 3_875_840, 3_620_864, 3_407_872, 3_151_872,
                 3_414_016, 3_407_872, 1_048_576)


def _jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_resnet50_leaves_and_buckets_match_jax():
    tp, ts = resnet(50, num_classes=1000).init(0, "cpu")
    jp, js = jresnet(50, num_classes=1000).init(random.PRNGKey(0))
    assert param_count(tp) == 25_557_032
    leaves, _ = tree_flatten(tp)
    assert len(leaves) == 161
    # the same paths and shapes in the same order, after the layout move
    jpaths = [(jax.tree_util.keystr(k), v.shape) for k, v in
              jax.tree_util.tree_leaves_with_path(jp)]
    ppaths = [(jax.tree_util.keystr(k), v.shape) for k, v in
              jax.tree_util.tree_leaves_with_path(to_jax(tp))]
    assert ppaths == jpaths
    assert jax.tree_util.tree_structure(to_jax(ts)) == \
        jax.tree_util.tree_structure(_jax_np(js))
    spec = flatten.make_bucket_spec(tp, 16 * 1024 * 1024)
    jspec = jflatten.make_bucket_spec(jp, 16 * 1024 * 1024)
    assert tuple(b.padded for b in spec.buckets) == BUCKETS_16MIB
    assert tuple(b.padded for b in jspec.buckets) == BUCKETS_16MIB
    assert [b.idx for b in spec.buckets] == [b.idx for b in jspec.buckets]


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_convert_round_trips_the_tree(norm):
    m = jresnet(50, num_classes=10, image_size=32, norm=norm)
    jp, js = _jax_np(m.init(random.PRNGKey(1)))
    tp, ts = from_jax(jp, js)
    back = to_jax(tp)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                               jax.tree_util.tree_leaves_with_path(back)):
        assert a.shape == b.shape and a.dtype == b.dtype, kp
        np.testing.assert_array_equal(a, b)
    if norm == "none":
        alpha = tp["stage1_block1"]["alpha"]
        assert alpha.shape == () and alpha.dtype == torch.float32
        assert not tree_flatten(ts)[0]


def _active(params, seed=1):
    """The JAX weights with each block's last batchnorm scale (or SkipInit
    alpha) drawn in [0.5, 1.5], so every residual branch is on."""
    rng = np.random.RandomState(seed)

    def act(path, a):
        s = jax.tree_util.keystr(path)
        if ("bn3" in s and "scale" in s) or "alpha" in s:
            return jnp.asarray(rng.uniform(0.5, 1.5, np.shape(a)), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(act, params)


@pytest.mark.parametrize("norm,dtype", [("batch", "float64"),
                                        ("none", "float64"),
                                        ("none", "float32")])
def test_forward_gradients_and_stats_match_jax(norm, dtype):
    jm = jresnet(50, num_classes=10, image_size=32, norm=norm,
                 dtype=getattr(jnp, dtype))
    tm = resnet(50, num_classes=10, image_size=32, norm=norm,
                dtype=getattr(torch, dtype))
    params, state = jm.init(random.PRNGKey(0))
    params = _active(params)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 32, 32, 3).astype(dtype)
    y = np.array([3, 7, 0, 9], np.int32)

    def _jl(p):
        return jloss_fn(jm, p, state, jnp.asarray(x), jnp.asarray(y),
                        train=True)
    (_, (jlp, jstate)), jg = jax.jit(jax.value_and_grad(
        _jl, has_aux=True))(params)
    tp, ts = from_jax(_jax_np(params), _jax_np(state))
    leaves, td = tree_flatten(tp)
    req = [p.requires_grad_() for p in leaves]
    loss, (tlp, tstate) = loss_fn(tm, tree_unflatten(td, req), ts,
                                  torch.from_numpy(x), torch.from_numpy(y))
    tg = torch.autograd.grad(loss, req)
    f64 = dtype == "float64"
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp),
                               rtol=0, atol=F64_LOGP_ATOL if f64 else LOGP_ATOL)
    want = tree_flatten(from_jax(_jax_np(jg), {})[0])[0]
    rel, floor = (F64_GRAD_RTOL_OF_MAX, 0.0) if f64 else \
        (GRAD_RTOL_OF_MAX, GRAD_ATOL)
    for g, e in zip(tg, want):
        e = e.numpy()
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=rel * np.abs(e).max() + floor)
    for a, b in zip(tree_flatten(to_jax(tstate))[0],
                    jax.tree_util.tree_leaves(_jax_np(jstate))):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_zero_gamma_start_and_eval_path():
    m = resnet(50, num_classes=10, image_size=64)
    params, state = m.init(0, "cpu")
    for name, block in params.items():
        if name.startswith("stage"):
            assert float(block["bn3"]["scale"].abs().max()) == 0.0
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3)
                         .astype(np.float32))
    with torch.no_grad():
        lp, ns = m.apply(params, state, x, train=True)
        assert lp.shape == (2, 10)
        np.testing.assert_allclose(lp.double().exp().sum(-1).numpy(), 1.0,
                                   rtol=1e-4)
        lp2, ns2 = m.apply(params, ns, x, train=False)
    assert lp2.shape == (2, 10)
    # eval keeps the running statistics: the same tensors come back
    assert all(a is b for a, b in zip(tree_flatten(ns2)[0],
                                      tree_flatten(ns)[0]))
    assert not torch.equal(ns["bn_stem"]["mean"], state["bn_stem"]["mean"])


def test_skipinit_structure_and_alpha_gradients():
    m = resnet(50, num_classes=10, image_size=32, norm="none")
    params, state = m.init(0, "cpu")
    names = " ".join(jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_leaves_with_path(to_jax(params)))
    assert "bn" not in names and "alpha" in names
    assert not tree_flatten(state)[0]
    leaves, td = tree_flatten(params)
    req = [p.requires_grad_() for p in leaves]
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3)
                         .astype(np.float32))
    loss, (lp, _) = loss_fn(m, tree_unflatten(td, req), state, x,
                            torch.zeros(2, dtype=torch.int64))
    assert torch.isfinite(lp).all()
    grads = tree_unflatten(td, list(torch.autograd.grad(loss, req)))
    alphas = [b["alpha"] for k, b in grads.items() if k.startswith("stage")]
    assert alphas and any(float(a.abs()) > 0 for a in alphas)


def test_norm_and_depth_validation():
    with pytest.raises(ValueError, match="norm"):
        resnet(50, norm="layer")
    with pytest.raises(ValueError, match="depth"):
        resnet(34)


def test_pooling_and_strided_conv_match_jax():
    """The extended layers alone: strided, explicitly padded and VALID
    convs, the -inf-padded max pool (asymmetric pads too) and the average
    pool, against the JAX package's on one NHWC input."""
    from distlearn_tpu.models import nn as jnn
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 9, 4)
    jp = jnn.conv2d_init(random.PRNGKey(0), 4, 6, 3, 3, jnp.float64)
    tp, _ = from_jax({"c": _jax_np(jp)}, {})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for stride, pad in (((2, 2), ((1, 1), (1, 1))), ((1, 1), "VALID"),
                        ((2, 2), ((0, 1), (2, 1)))):
        want = jnn.conv2d(jp, jnp.asarray(x), stride=stride, padding=pad)
        got = nn.conv2d(tp["c"], xt, padding=pad, stride=stride)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-12, atol=1e-12)
    for pad in (((1, 1), (1, 1)), ((0, 1), (1, 0)), "VALID"):
        want = jnn.max_pool2d(jnp.asarray(x), window=(3, 3), stride=(2, 2),
                              padding=pad)
        got = nn.max_pool2d(xt, window=(3, 3), stride=(2, 2), padding=pad)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))
    want = jnn.avg_pool2d(jnp.asarray(x), window=(3, 3), stride=(3, 3))
    got = nn.avg_pool2d(xt, window=(3, 3), stride=(3, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-12)


def test_two_rank_bucketed_step_matches_the_jax_mesh(tmp_path):
    """Two gloo ranks, 8-MiB buckets (fused route: B1's plain twin on the
    CPU), one step of the float64 ResNet-50: bit for bit across ranks and
    within float64 tolerance of the JAX package's two-node mesh."""
    jm = jresnet(50, num_classes=10, image_size=32, dtype=jnp.float64)
    params, state = jm.init(random.PRNGKey(0))
    params = _active(params)
    rng = np.random.RandomState(2)
    x = rng.randn(4, 32, 32, 3)
    y = np.arange(4, dtype=np.int32) % 10
    inp = {"params": _jax_np(params), "state": _jax_np(state), "x": x,
           "y": y, "lr": 0.05, "steps": 1}
    ranks = torch_optim_dist_worker.run_ranks("resnet_step", inp, tmp_path)

    jtree = JaxMeshTree(num_nodes=2)
    sh = NamedSharding(jtree.mesh, P("data"))
    step = jtr.build_sgd_step(jm, jtree, lr=0.05, donate=False, fused=False)
    ts = jtr.init_train_state(jm, jtree, random.PRNGKey(0), 10)
    ts = ts._replace(params=params, model_state=state)
    ts, loss = step(ts, jax.device_put(x, sh), jax.device_put(y, sh))
    want = jax.tree_util.tree_leaves(_jax_np(ts.params))
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    np.testing.assert_allclose(ranks[0]["losses"], [float(loss)], rtol=1e-9)
    for i, w in enumerate(want):      # entries that cancel to ~1e-15
        np.testing.assert_allclose(           # are held to the leaf's scale
            ranks[0][f"p{i}"], w, rtol=0,
            atol=F64_GRAD_RTOL_OF_MAX * np.abs(w).max())
