"""The port's optimizer steps against the JAX package's and optax
(tests/test_optax_step.py's convnet cases replayed on the port, on the
CPU):

* the optax-shaped transformations against optax step by step — sgd with
  and without momentum and Nesterov, adam, adamw, a global-norm clip, and
  the cosine and warm-up cosine schedules (the port computes its counts and
  schedules in float32; the JAX tests run optax with 64-bit mode on, so its
  bias corrections and schedules round in float64: hence a tolerance);
* ``build_optax_step`` with ``sgd`` bit for bit the bare SGD step; with
  momentum and adam it trains, and matches the JAX package's optax step on
  the same weights and batch (float64);
* ZeRO-1 on two gloo ranks against the full-state step and, from the JAX
  weights, against the JAX package's ZeRO-1 step on a two-node mesh; at
  one rank bit for bit;
* the elementwise probe refuses ``chain(clip_by_global_norm, adam)``; ZeRO
  refuses non-float32 params;
* gradient accumulation against the full batch and against the JAX
  package's ``accum_steps`` step (float64, with and without batchnorm),
  and its validation.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import mnist_cnn as jmnist  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.train import optim as joptim  # noqa: E402
from distlearn_tpu_torch.data import synthetic_mnist  # noqa: E402
from distlearn_tpu_torch.models import mnist_cnn  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax, to_jax  # noqa: E402
from distlearn_tpu_torch.models.core import Model  # noqa: E402
from distlearn_tpu_torch.parallel.mesh import init_mesh  # noqa: E402
from distlearn_tpu_torch.train import optim  # noqa: E402
from distlearn_tpu_torch.train import trainer as ttr  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_map  # noqa: E402

import torch_optim_dist_worker  # noqa: E402

# tests/test_optax_step.py's ZeRO tolerance, used for every comparison of
# float32 results computed in different orders or precisions
RTOL, ATOL = 1e-6, 1e-7
# The port's float32 steps against the JAX package's: torch's and XLA's
# float32 convolutions sum in different orders, so the gradients differ by
# ~1e-7 of their size, and batchnorm's E[x^2] - E[x]^2 amplifies that
# (tests/test_torch_models.py); Adam divides each by its own sqrt(v), so
# where a gradient element is small its update moves by up to a fraction
# of lr (1e-3) a step.  Worst seen: 1.1e-7 on a parameter after 3 ZeRO
# Adam steps, 5.1e-7 after 2 accumulated steps of the batchnorm convnet.
XPKG_RTOL, XPKG_ATOL = 1e-6, 1e-6
# The running batchnorm statistics after those steps carry the params'
# drift into every microbatch's mean (worst seen 1.5e-6): tests/
# test_train.py's tolerance for the same math summed in another order.
STATS_RTOL, STATS_ATOL = 1e-5, 1e-5


@pytest.fixture
def tree():
    t = init_mesh(store=dist.HashStore(), device="cpu")
    yield t
    dist.destroy_process_group()


def _batch(n=16):
    x, y, nc = synthetic_mnist(n, seed=0)
    return torch.from_numpy(x), torch.from_numpy(y), nc


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------------------- the transformations

def _pairs():
    cos = (optim.cosine_decay_schedule(0.1, 5),
           optax.cosine_decay_schedule(0.1, 5))
    warm = (optim.warmup_cosine_decay_schedule(0.0, 0.01, 2, 6,
                                               end_value=1e-4),
            optax.warmup_cosine_decay_schedule(0.0, 0.01, 2, 6,
                                               end_value=1e-4))
    return {
        "sgd": (optim.sgd(0.1), optax.sgd(0.1)),
        "momentum": (optim.sgd(0.05, momentum=0.9),
                     optax.sgd(0.05, momentum=0.9)),
        "nesterov": (optim.sgd(0.05, momentum=0.9, nesterov=True),
                     optax.sgd(0.05, momentum=0.9, nesterov=True)),
        "adam": (optim.adam(1e-3), optax.adam(1e-3)),
        "adamw": (optim.adamw(1e-3, weight_decay=0.01),
                  optax.adamw(1e-3, weight_decay=0.01)),
        "clip_adam": (optim.chain(optim.clip_by_global_norm(0.5),
                                  optim.adam(1e-3)),
                      optax.chain(optax.clip_by_global_norm(0.5),
                                  optax.adam(1e-3))),
        "cosine_sgd": (optim.sgd(cos[0], momentum=0.9),
                       optax.sgd(cos[1], momentum=0.9)),
        "warmup_adam": (optim.adam(warm[0]), optax.adam(warm[1])),
    }


@pytest.mark.parametrize("name", sorted(_pairs()))
def test_transformation_matches_optax_step_by_step(name):
    ptx, jtx = _pairs()[name]
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pst, jst = ptx.init(pp), jtx.init(jp)
    for step in range(7):
        g = {k: (rng.standard_normal(v.shape) * (1 + step)).astype(np.float32)
             for k, v in params.items()}
        pu, pst = ptx.update({k: torch.from_numpy(v) for k, v in g.items()},
                             pst, pp)
        ju, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                             jst, jp)
        for k in params:
            assert pu[k].dtype == torch.float32
            np.testing.assert_allclose(_np(pu[k]), np.asarray(ju[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} {k}")
        pp = tree_map(lambda a, u: a + u, pp, pu)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, ju)
    # the states' counts and moments too
    pl = [_np(x) for x in tree_flatten(pst)[0]]
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("make", ["cosine", "warmup", "linear"])
def test_schedules_match_optax(make):
    ours, theirs = {
        "cosine": (optim.cosine_decay_schedule(0.1, 40, alpha=0.05),
                   optax.cosine_decay_schedule(0.1, 40, alpha=0.05)),
        "warmup": (optim.warmup_cosine_decay_schedule(0.0, 0.2, 5, 40, 1e-3),
                   optax.warmup_cosine_decay_schedule(0.0, 0.2, 5, 40,
                                                      1e-3)),
        "linear": (optim.linear_schedule(0.3, 0.1, 10),
                   optax.linear_schedule(0.3, 0.1, 10)),
    }[make]
    for c in range(0, 50):
        got = ours(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(theirs(c)), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{make} at {c}")


def test_count_saturates_at_int32_max():
    st = optim.adam(1e-3).init(torch.zeros(3))
    top = torch.tensor(2 ** 31 - 1, dtype=torch.int32)
    assert int(optim._increment(top)) == 2 ** 31 - 1
    assert st[0].count.dtype == torch.int32


# ------------------------------------------------------- the optax step

def test_optax_sgd_matches_bare_sgd_bitwise(tree):
    x, y, nc = _batch()
    model = mnist_cnn()
    ts = ttr.init_train_state(model, tree, 0, nc)
    ots = optim.init_optax_state(model, tree, optim.sgd(0.1), 0, nc)
    step = ttr.build_sgd_step(model, tree, lr=0.1, fused=False)
    ostep = optim.build_optax_step(model, tree, optim.sgd(0.1))
    for _ in range(3):
        ts, loss = step(ts, x, y)
        ots, oloss = ostep(ots, x, y)
    assert torch.equal(loss, oloss)
    for a, b in zip(tree_flatten(ts.params)[0], tree_flatten(ots.params)[0]):
        assert torch.equal(a, b)
    assert torch.equal(ts.cm, ots.cm)
    assert int(ots.sync.my_steps) == 3


def test_optax_momentum_and_adam_train(tree):
    x, y, nc = _batch()
    model = mnist_cnn()
    for tx in (optim.sgd(0.05, momentum=0.9), optim.adam(1e-3)):
        ots = optim.init_optax_state(model, tree, tx, 1, nc)
        ostep = optim.build_optax_step(model, tree, tx)
        losses = []
        for _ in range(8):
            ots, loss = ostep(ots, x, y)
            losses.append(float(loss))
        assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_optax_step_matches_the_jax_step(name, tree):
    """One node, the same float64 weights and batch: three steps of the
    port's optax step within tolerance of the JAX package's with optax."""
    ptx, jtx = {"momentum": (optim.sgd(0.05, momentum=0.9),
                             optax.sgd(0.05, momentum=0.9)),
                "adam": (optim.adam(1e-3), optax.adam(1e-3))}[name]
    jm = jmnist(dtype=jnp.float64)
    jtree = JaxMeshTree(num_nodes=1)
    x, y, nc = _batch()
    jts = joptim.init_optax_state(jm, jtree, jtx, random.PRNGKey(0), nc)
    jstep = joptim.build_optax_step(jm, jtree, jtx, donate=False)
    sh = NamedSharding(jtree.mesh, P("data"))
    params_np = jax.device_get(jts.params)
    model = mnist_cnn(dtype=torch.float64)
    params, _ = from_jax(params_np, {})
    ots = optim.init_optax_state(model, tree, ptx, 0, nc)
    ots = ots._replace(params=params, opt_state=ptx.init(params))
    step = optim.build_optax_step(model, tree, ptx)
    for _ in range(3):
        jts, jloss = jstep(jts, jax.device_put(x.numpy().astype(np.float64),
                                               sh),
                           jax.device_put(y.numpy(), sh))
        ots, loss = step(ots, x.double(), y)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(to_jax(ots.params)),
                    jax.tree_util.tree_leaves(jax.device_get(jts.params))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- ZeRO-1

def test_zero_at_one_rank_is_the_full_adam_step_bitwise(tree):
    x, y, nc = _batch()
    model = mnist_cnn()
    tx = optim.adam(1e-3)
    ots = optim.init_optax_state(model, tree, tx, 3, nc)
    zts = optim.init_zero_state(model, tree, tx, 3, nc)
    ostep = optim.build_optax_step(model, tree, tx)
    zstep = optim.build_zero_optax_step(model, tree, tx)
    for _ in range(3):
        ots, oloss = ostep(ots, x, y)
        zts, zloss = zstep(zts, x, y)
    assert torch.equal(oloss, zloss)
    for a, b in zip(tree_flatten(ots.params)[0], tree_flatten(zts.params)[0]):
        assert torch.equal(a, b)
    # the state is one flat slice (the whole packed vector at n = 1)
    mu = zts.opt_state[0].mu
    assert mu.ndim == 1 and mu.numel() % 1024 == 0


def test_zero_two_ranks_match_the_full_step(tmp_path):
    """Two gloo ranks (allreduce-and-slice route): ZeRO-1 Adam against the
    full-state Adam step within tests/test_optax_step.py's tolerance, each
    rank's state covering half the packed vector."""
    x, y, _ = synthetic_mnist(16, seed=0)
    ranks = torch_optim_dist_worker.run_ranks(
        "zero_adam", {"x": x, "y": y, "lr": 1e-3, "steps": 3}, tmp_path)
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    r = ranks[0]
    np.testing.assert_allclose(r["zero_losses"], r["full_losses"], rtol=RTOL)
    n_leaves = sum(1 for k in r if k.startswith("full_p"))
    assert n_leaves == 6
    total = 0
    for i in range(n_leaves):
        np.testing.assert_allclose(r[f"zero_p{i}"], r[f"full_p{i}"],
                                   rtol=RTOL, atol=ATOL)
        total += r[f"full_p{i}"].size
    assert int(r["zero_mu_size"]) * 2 >= total
    assert int(r["zero_mu_size"]) * 2 < total + 2 * 1024


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_zero_two_ranks_match_the_jax_zero_step(name, tmp_path):
    """Two gloo ranks from the JAX weights: the port's ZeRO-1 step against
    the JAX package's build_zero_optax_step on a two-node mesh, and the
    port's full-state step against the JAX build_optax_step, params and
    losses within float32's cross-package tolerance (XPKG_*)."""
    jtx, lr = {"adam": (optax.adam, 1e-3),
               "momentum": (lambda lr: optax.sgd(lr, momentum=0.9),
                            0.05)}[name]
    jtx = jtx(lr)
    jm = jmnist()
    jtree = JaxMeshTree(num_nodes=2)
    x, y, nc = synthetic_mnist(16, seed=0)
    jz = joptim.init_zero_state(jm, jtree, jtx, random.PRNGKey(3), nc)
    jf = joptim.init_optax_state(jm, jtree, jtx, random.PRNGKey(3), nc)
    params_np = jax.device_get(jz.params)
    ranks = torch_optim_dist_worker.run_ranks(
        "zero_from_jax", {"params": params_np, "x": x, "y": y, "lr": lr,
                          "tx": name, "steps": 3}, tmp_path)
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    sh = NamedSharding(jtree.mesh, P("data"))
    bx, by = jax.device_put(x, sh), jax.device_put(y, sh)
    for tag, jts, build in (("zero", jz, joptim.build_zero_optax_step),
                            ("full", jf, joptim.build_optax_step)):
        jstep = build(jm, jtree, jtx, donate=False)
        losses = []
        for _ in range(3):
            jts, jloss = jstep(jts, bx, by)
            losses.append(float(jloss))
        np.testing.assert_allclose(ranks[0][f"{tag}_losses"], losses,
                                   rtol=XPKG_RTOL, err_msg=tag)
        want = jax.tree_util.tree_leaves(jax.device_get(jts.params))
        assert len(want) == 6
        for i, w in enumerate(want):
            np.testing.assert_allclose(ranks[0][f"{tag}_p{i}"], w,
                                       rtol=XPKG_RTOL, atol=XPKG_ATOL,
                                       err_msg=f"{tag} leaf {i}")


@pytest.mark.parametrize("n", [2, 4])
def test_zero_rejects_slice_coupling_optimizer(n):
    """The probe at n shards (tests/test_optax_step.py runs it at n = 4):
    a global-norm clip before adam couples the slices and is refused;
    elementwise transforms pass.  (At one rank there is one slice, so
    nothing can couple.)"""
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(1e-3))
    with pytest.raises(ValueError, match="not elementwise"):
        optim._check_elementwise(tx, n)
    optim._check_elementwise(optim.adam(1e-3), n)
    optim._check_elementwise(optim.sgd(0.1, momentum=0.9), n)


def test_zero_rejects_non_f32_params(tree):
    def init(seed=0, device=None):
        return {"w": torch.zeros(4, dtype=torch.float64)}, {}
    bad = Model(init=init, apply=lambda *a, **k: None, name="bad",
                input_shape=(4,), num_classes=2)
    with pytest.raises(ValueError, match="f32"):
        optim.init_zero_state(bad, tree, optim.adam(1e-3), 0, 2)


# ------------------------------------------------------- accumulation

def test_gradient_accumulation_matches_full_batch(tree):
    """accum_steps=2 on the batchnorm-free MNIST convnet against the
    single-shot step: the same effective batch and summed gradient."""
    x, y, nc = _batch()
    model = mnist_cnn()
    tx = optim.sgd(0.1)
    ts1 = optim.init_optax_state(model, tree, tx, 5, nc)
    ts2 = optim.init_optax_state(model, tree, tx, 5, nc)
    full = optim.build_optax_step(model, tree, tx)
    accum = optim.build_optax_step(model, tree, tx, accum_steps=2)
    for _ in range(2):
        ts1, l1 = full(ts1, x, y)
        ts2, l2 = accum(ts2, x, y)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(tree_flatten(ts1.params)[0], tree_flatten(ts2.params)[0]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert torch.equal(ts1.cm, ts2.cm)


@pytest.mark.parametrize("name", ["mnist", "cifar"])
def test_gradient_accumulation_matches_the_jax_step(name, tree):
    """accum_steps=2 from the same float32 weights and batch (the JAX
    step's scan carries a float32 loss, so it takes float32 models): two
    steps of the port's optax step against the JAX package's
    build_optax_step(accum_steps=2) on one node — losses and params within
    XPKG_*, and (the convnet with batchnorm) the running statistics
    threaded through the microbatches within STATS_*."""
    from distlearn_tpu.models import cifar_convnet as jcifar
    from distlearn_tpu_torch.models import cifar_convnet
    rng = np.random.default_rng(1)
    if name == "mnist":
        jm, model = jmnist(), mnist_cnn()
        x, y, nc = _batch()
    else:
        jm, model = jcifar(dropout_rate=0.0), cifar_convnet(dropout_rate=0.0)
        x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3))
                             .astype(np.float32))
        y, nc = torch.arange(4) % 10, 10
    ptx, jtx = optim.sgd(0.05, momentum=0.9), optax.sgd(0.05, momentum=0.9)
    jtree = JaxMeshTree(num_nodes=1)
    jts = joptim.init_optax_state(jm, jtree, jtx, random.PRNGKey(5), nc)
    jstep = joptim.build_optax_step(jm, jtree, jtx, accum_steps=2,
                                    donate=False)
    params, mstate = from_jax(jax.device_get(jts.params),
                              jax.device_get(jts.model_state))
    ots = optim.init_optax_state(model, tree, ptx, 0, nc)
    ots = ots._replace(params=params, model_state=mstate,
                       opt_state=ptx.init(params))
    step = optim.build_optax_step(model, tree, ptx, accum_steps=2)
    sh = NamedSharding(jtree.mesh, P("data"))
    for _ in range(2):
        jts, jloss = jstep(jts, jax.device_put(x.numpy(), sh),
                           jax.device_put(y.numpy().astype(np.int32), sh))
        ots, loss = step(ots, x, y)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=XPKG_RTOL)
    # the JAX state's confusion matrix is stacked per node, [1, nc, nc]
    np.testing.assert_array_equal(_np(ots.cm), np.asarray(jts.cm)[0])
    assert bool(tree_flatten(ots.model_state)[0]) == (name == "cifar")
    for part, rtol, atol in (("params", XPKG_RTOL, XPKG_ATOL),
                             ("model_state", STATS_RTOL, STATS_ATOL)):
        got = jax.tree_util.tree_leaves(to_jax(getattr(ots, part)))
        want = jax.tree_util.tree_leaves(jax.device_get(getattr(jts, part)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=part)


def test_gradient_accumulation_threads_batchnorm_state(tree):
    """With batchnorm the running statistics pass through every microbatch
    in turn (the JAX package's scan carry): two momentum-0.1 updates."""
    from distlearn_tpu_torch.models import cifar_convnet
    model = cifar_convnet(dropout_rate=0.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3))
                         .astype(np.float32))
    y = torch.arange(4) % 10
    tx = optim.sgd(0.0)
    ts = optim.init_optax_state(model, tree, tx, 0, 10)
    new, _ = optim.build_optax_step(model, tree, tx, accum_steps=2)(ts, x, y)
    _, _, st1, _ = ttr.value_and_grad(model, ts.params, ts.model_state,
                                      x[:2], y[:2], ts.rng, tree)
    _, _, st2, _ = ttr.value_and_grad(model, ts.params, st1, x[2:], y[2:],
                                      ts.rng, tree)
    for a, b in zip(tree_flatten(new.model_state)[0], tree_flatten(st2)[0]):
        assert torch.equal(a, b)


def test_gradient_accumulation_rejects_indivisible(tree):
    x, y, nc = _batch()
    model = mnist_cnn()
    tx = optim.sgd(0.1)
    ts = optim.init_optax_state(model, tree, tx, 6, nc)
    step = optim.build_optax_step(model, tree, tx, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(ts, x, y)


def test_accum_steps_validated_at_build(tree):
    with pytest.raises(ValueError, match="accum_steps must be"):
        optim.build_optax_step(mnist_cnn(), tree, optim.sgd(0.1),
                               accum_steps=0)
