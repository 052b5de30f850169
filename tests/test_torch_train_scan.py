"""The port's scanned steps, ``build_sgd_scan_step`` and
``build_ea_cycle`` (``distlearn_tpu_torch/train/trainer.py``), on the CPU
(their plain route: the steps in a loop; the CUDA-graph route runs in
chip_smoke.py):

* against K per-call steps of the port — the oracles
  tests/test_train.py::test_sgd_scan_step_matches_per_call_steps,
  ``test_sgd_scan_step_uneven_participation_matches_per_call`` and
  ``test_ea_cycle_matches_local_steps_plus_round`` with their tolerances
  (losses rtol 1e-5 / atol 1e-6, params 1e-5), at dropout 0.5 from the same
  generator seed, on one gloo rank and, with uneven participation, on two;
* against the JAX package's ``build_sgd_scan_step`` / ``build_ea_cycle`` on
  the same numpy batches at dropout 0 and the same weights (``from_jax``),
  in float64 with tests/test_torch_train.py's tolerances (rtol 1e-9, atol
  1e-12), on one node and on two (tests/torch_scan_dist_worker.py);
* the ``DeviceDataset`` route (index vectors) against the batch route, the
  calls the dispatch histogram counts, and a wrong number of batch
  arguments.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.models import mnist_cnn as jax_mnist  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.train import trainer as jtr  # noqa: E402
from distlearn_tpu_torch import obs  # noqa: E402
from distlearn_tpu_torch.data import (DeviceDataset, synthetic_cifar10,  # noqa: E402
                                      synthetic_mnist)
from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax  # noqa: E402
from distlearn_tpu_torch.parallel.mesh import init_mesh  # noqa: E402
from distlearn_tpu_torch.train import trainer as ttr  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

import torch_scan_dist_worker  # noqa: E402

# the JAX oracles' tolerances (tests/test_train.py:168-177)
LOSS_RTOL, LOSS_ATOL, PARAM_TOL = 1e-5, 1e-6, 1e-5
# float64 against JAX, as tests/test_torch_train.py
RTOL, ATOL = 1e-9, 1e-12
K, BATCH, LR, ALPHA = 3, 8, 0.05, 0.25
WORLD, PER_RANK = 2, 2
CONTRIBS = np.array([[1, 1], [1, 0], [0, 1]], np.int32)   # [K, WORLD]
JOIN_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def tree():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    mesh = init_mesh(store=dist.HashStore(), device="cpu")
    yield mesh
    dist.destroy_process_group()
    torch.set_num_threads(threads)


def _stacked(make, k=K, batch=BATCH, seed=0, dtype=np.float32):
    x, y, _ = make(k * batch, seed=seed)
    return (x.astype(dtype).reshape(k, batch, *x.shape[1:]),
            y.reshape(k, batch))


def _assert_close(got, want, tol=PARAM_TOL):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=tol, atol=tol)


def _assert_jax_close(port, jax_tree):
    want = from_jax(jax.device_get(jax_tree), {})[0]
    for u, v in zip(tree_leaves(port), tree_leaves(want)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=RTOL, atol=ATOL)


_MODELS = {"mnist_cnn": (mnist_cnn, synthetic_mnist),
           "cifar_convnet": (cifar_convnet, synthetic_cifar10)}


# ---------------------------------------------------------------------------
# against K per-call steps

@pytest.mark.parametrize("with_contrib", [False, True],
                         ids=["all", "contrib"])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_sgd_scan_step_matches_per_call_steps(tree, name, with_contrib):
    make_model, make_data = _MODELS[name]
    model = make_model()                 # cifar: dropout 0.5
    xs, ys = _stacked(make_data)
    cs = np.array([1, 0, 1], np.int32)
    ts_ref = ttr.init_train_state(model, tree, 0, 10)
    step = ttr.build_sgd_step(model, tree, LR, with_contrib=with_contrib)
    ref_losses = []
    for k in range(K):
        args = (xs[k], ys[k]) + ((cs[k],) if with_contrib else ())
        ts_ref, loss = step(ts_ref, *args)
        ref_losses.append(float(loss))
    ts = ttr.init_train_state(model, tree, 0, 10)
    scan = ttr.build_sgd_scan_step(model, tree, LR, with_contrib=with_contrib)
    ts, losses = scan(ts, xs, ys, *((cs,) if with_contrib else ()))
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _assert_close(ts.params, ts_ref.params)
    _assert_close(ts.model_state, ts_ref.model_state)
    assert int(ts.sync.my_steps) == int(ts_ref.sync.my_steps) == \
        (int(cs.sum()) if with_contrib else K)
    assert torch.equal(ts.cm, ts_ref.cm)
    # the dropout generator advanced as the per-call steps advanced theirs
    assert torch.equal(ts.rng.get_state(), ts_ref.rng.get_state())


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_ea_cycle_matches_local_steps_plus_round(tree, momentum):
    model = cifar_convnet()              # dropout 0.5
    xs, ys = _stacked(synthetic_cifar10, seed=1)
    ets_ref = ttr.init_ea_state(model, tree, 0, 10)
    # start the center elsewhere, or the round moves nothing
    off = lambda t: {k: {n: v + 0.01 for n, v in d.items()}
                     for k, d in t.items()}
    ets_ref = ets_ref._replace(center=off(ets_ref.center))
    local, rnd = ttr.build_ea_steps(model, tree, LR, ALPHA, momentum=momentum)
    ref_losses = []
    for k in range(K):
        ets_ref, loss = local(ets_ref, xs[k], ys[k])
        ref_losses.append(float(loss))
    ets_ref = rnd(ets_ref)
    ets = ttr.init_ea_state(model, tree, 0, 10)
    ets = ets._replace(center=off(ets.center))
    cycle = ttr.build_ea_cycle(model, tree, LR, ALPHA, momentum=momentum)
    ets, losses = cycle(ets, xs, ys)
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for field in ("params", "center", "vel", "model_state"):
        _assert_close(getattr(ets, field), getattr(ets_ref, field))
    assert torch.equal(ets.cm, ets_ref.cm)


# ---------------------------------------------------------------------------
# against the JAX package's scanned steps, one node

def test_sgd_scan_step_matches_jax(tree):
    jtree = JaxMeshTree(num_nodes=1)
    jm = jax_cifar(dtype=jnp.float64, dropout_rate=0.0)
    jts = jtr.init_train_state(jm, jtree, random.PRNGKey(0), 10)
    params, mstate = from_jax(jax.device_get(jts.params),
                              jax.device_get(jts.model_state))
    xs, ys = _stacked(synthetic_cifar10, k=2, batch=4, dtype=np.float64)
    sh = NamedSharding(jtree.mesh, P(None, "data"))
    jts, jlosses = jtr.build_sgd_scan_step(jm, jtree, lr=LR, donate=False)(
        jts, jax.device_put(xs, sh), jax.device_put(ys, sh))
    ts = ttr.TrainState(params, mstate, ttr.allreduce_sgd.init_state("cpu"),
                        torch.zeros((10, 10), dtype=torch.int64),
                        torch.Generator())
    scan = ttr.build_sgd_scan_step(
        cifar_convnet(torch.float64, dropout_rate=0.0), tree, LR)
    ts, losses = scan(ts, xs, ys)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=RTOL)
    _assert_jax_close(ts.params, jts.params)
    _assert_jax_close(ts.model_state, jts.model_state)
    assert int(ts.sync.my_steps) == int(np.asarray(jts.sync.my_steps)[0])
    np.testing.assert_array_equal(ts.cm.numpy(), np.asarray(jts.cm)[0])


def test_ea_cycle_matches_jax(tree):
    jtree = JaxMeshTree(num_nodes=1)
    jm = jax_mnist(dtype=jnp.float64)
    jts = jtr.init_ea_state(jm, jtree, random.PRNGKey(0), 10)
    shift = lambda a: a + 0.01 * np.cos(np.arange(a.size).reshape(a.shape))
    jts = jts._replace(center=jax.tree_util.tree_map(
        lambda a: jtree.put_per_node(shift(np.asarray(a))), jts.center))
    first = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a)[0], t)
    params = from_jax(first(jts.params), {})[0]
    center = from_jax(first(jts.center), {})[0]
    xs, ys = _stacked(synthetic_mnist, dtype=np.float64)
    sh = NamedSharding(jtree.mesh, P(None, "data"))
    jts, jlosses = jtr.build_ea_cycle(jm, jtree, lr=LR, alpha=ALPHA,
                                      donate=False, momentum=0.9)(
        jts, jax.device_put(xs, sh), jax.device_put(ys, sh))
    ets = ttr.EATrainState(params, {}, center,
                           jax.tree_util.tree_map(torch.zeros_like, params),
                           torch.zeros((10, 10), dtype=torch.int64),
                           torch.Generator())
    cycle = ttr.build_ea_cycle(mnist_cnn(torch.float64), tree, LR, ALPHA,
                               momentum=0.9)
    ets, losses = cycle(ets, xs, ys)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses)[:, 0],
                               rtol=RTOL)
    _assert_jax_close(ets.params, first(jts.params))
    _assert_jax_close(ets.center, first(jts.center))
    _assert_jax_close(ets.vel, first(jts.vel))
    np.testing.assert_array_equal(ets.cm.numpy(), np.asarray(jts.cm)[0])


# ---------------------------------------------------------------------------
# the dataset route, telemetry, arguments

def test_scan_step_gathers_from_device_dataset(tree):
    """Index vectors gathered from a DeviceDataset give the same steps as
    the batches themselves, bit for bit."""
    x, y, _ = synthetic_mnist(64, seed=3)
    dds = DeviceDataset(x, y, 10, device="cpu")
    idxs = np.random.RandomState(0).permutation(64)[:K * BATCH] \
        .reshape(K, BATCH).astype(np.int32)
    model = mnist_cnn()
    runs = []
    for dataset, batch in ((None, (x[idxs], y[idxs])), (dds, (idxs,))):
        scan = ttr.build_sgd_scan_step(model, tree, LR, dataset=dataset)
        runs.append(scan(ttr.init_train_state(model, tree, 0, 10), *batch))
    (ts_a, la), (ts_b, lb) = runs
    assert torch.equal(la, lb)
    for u, v in zip(tree_leaves(ts_a.params), tree_leaves(ts_b.params)):
        assert torch.equal(u, v)


def test_scanned_steps_count_calls_and_check_arguments(tree):
    model = mnist_cnn()
    xs, ys = _stacked(synthetic_mnist, k=2)
    scan = ttr.build_sgd_scan_step(model, tree, LR)
    cycle = ttr.build_ea_cycle(model, tree, LR, ALPHA)
    calls = obs.histogram("train_step_dispatch_seconds", labels=("step",))
    count = lambda name: calls.labels(step=name).count
    before = count("sgd_scan"), count("ea_cycle")
    ts, _ = scan(ttr.init_train_state(model, tree, 0, 10), xs, ys)
    ts, _ = scan(ts, xs, ys)
    cycle(ttr.init_ea_state(model, tree, 0, 10), xs, ys)
    assert (count("sgd_scan"), count("ea_cycle")) == \
        (before[0] + 2, before[1] + 1)
    with pytest.raises(TypeError, match="expected 2 batch arguments"):
        scan(ts, xs)
    with pytest.raises(TypeError, match="expected 3 batch arguments"):
        ttr.build_sgd_scan_step(model, tree, LR, with_contrib=True)(
            ts, xs, ys)


# ---------------------------------------------------------------------------
# two gloo ranks: uneven participation and the EA cycle against JAX

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("torch_scan_dist")
    jm = jax_cifar(dtype=jnp.float64, dropout_rate=0.0)
    params, state = jax.jit(jm.init)(random.PRNGKey(0))
    xs, ys = _stacked(synthetic_cifar10, batch=WORLD * PER_RANK, seed=4,
                      dtype=np.float64)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray,
                                               jax.device_get(t))
    inp = {"params": np_tree(params), "state": np_tree(state), "xs": xs,
           "ys": ys, "contribs": CONTRIBS, "lr": LR, "alpha": ALPHA}
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=torch_scan_dist_worker.run,
                         args=(r, WORLD, str(out_dir / "store"), inp,
                               str(out_dir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jtree = JaxMeshTree(num_nodes=WORLD)
        sh = NamedSharding(jtree.mesh, P(None, "data"))
        put = lambda a: jax.device_put(a, sh)
        jts = jtr.init_train_state(jm, jtree, random.PRNGKey(0), 10)
        jts = jts._replace(params=params, model_state=state)
        scan = jtr.build_sgd_scan_step(jm, jtree, lr=LR, donate=False,
                                       with_contrib=True)
        jts, jlosses = scan(jts, put(xs), put(ys), put(CONTRIBS))
        stack = lambda t: jtree.put_per_node(jax.tree_util.tree_map(
            lambda a: np.broadcast_to(np.asarray(a)[None],
                                      (WORLD,) + a.shape), t))
        jets = jtr.init_ea_state(jm, jtree, random.PRNGKey(0), 10)
        jets = jets._replace(
            params=stack(params), model_state=stack(state),
            center=stack(jax.tree_util.tree_map(lambda a: a + 0.01,
                                                params)))
        cycle = jtr.build_ea_cycle(jm, jtree, lr=LR, alpha=ALPHA,
                                   donate=False)
        jets, jea_losses = cycle(jets, put(xs), put(ys))
        ref = {"sgd": np_tree(jts), "sgd_losses": np.asarray(jlosses),
               "ea": np_tree(jets), "ea_losses": np.asarray(jea_losses)}
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(5)
    assert not alive, f"ranks still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, ref


def test_sgd_scan_step_uneven_participation_matches_per_call(two_ranks):
    ranks, _ = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r["scan_losses"].numpy(),
                                   r["call_losses"].numpy(),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _assert_close(r["scan"].params, r["call"].params)
        _assert_close(r["scan"].model_state, r["call"].model_state)
        assert int(r["scan"].sync.my_steps) == int(r["call"].sync.my_steps)
        assert torch.equal(r["scan"].cm, r["call"].cm)
    # only the contributing steps advanced each rank's counter
    assert [int(r["scan"].sync.my_steps) for r in ranks] == \
        list(CONTRIBS.sum(axis=0))
    # params stay replicated across the ranks, bit for bit
    for u, v in zip(tree_leaves(ranks[0]["scan"].params),
                    tree_leaves(ranks[1]["scan"].params)):
        assert torch.equal(u, v)


def test_two_rank_scan_and_cycle_match_jax(two_ranks):
    ranks, ref = two_ranks
    jts, jets = ref["sgd"], ref["ea"]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["scan_losses"].numpy(),
                                   ref["sgd_losses"], rtol=RTOL)
        _assert_jax_close(r["scan"].params, jts.params)
        _assert_jax_close(r["scan"].model_state, jts.model_state)
        np.testing.assert_array_equal(r["scan"].cm.numpy(), jts.cm[rank])
        mine = lambda t: jax.tree_util.tree_map(lambda a: a[rank], t)
        np.testing.assert_allclose(r["ea_losses"].numpy(),
                                   ref["ea_losses"][:, rank], rtol=RTOL)
        _assert_jax_close(r["ea"].params, mine(jets.params))
        _assert_jax_close(r["ea"].center, mine(jets.center))
        _assert_jax_close(r["ea"].model_state, mine(jets.model_state))
