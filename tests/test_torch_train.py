"""The port's train steps against the JAX package's at world size 1 (one
gloo rank against ``MeshTree(num_nodes=1)``): the same weights and the same
batches through ``build_sgd_step`` (fused and plain) and ``build_ea_steps``
(with and without EAMSGD momentum).

The comparison runs in float64, as the JAX suite's EA oracles do
(tests/conftest.py turns on x64 for them).  In float32 the two frameworks'
convolutions round differently, and batchnorm's E[x^2] - E[x]^2 amplifies
that to ~1e-3 of a gradient per step at these batch sizes, which would hide
a real fault; in float64 the port lands within ~1e-15 of JAX (measured), so
the tolerance below is tight.  The float32 forward and backward are held
by tests/test_torch_models.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.models import mnist_cnn as jax_mnist  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.train import trainer as jtr  # noqa: E402
from distlearn_tpu.utils import metrics as jax_metrics  # noqa: E402
from distlearn_tpu_torch.data import synthetic_cifar10, synthetic_mnist  # noqa: E402
from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax  # noqa: E402
from distlearn_tpu_torch.ops import fused_update  # noqa: E402
from distlearn_tpu_torch.parallel.mesh import init_mesh  # noqa: E402
from distlearn_tpu_torch.train import trainer as ttr  # noqa: E402
from distlearn_tpu_torch.utils import metrics  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

# float64 on both sides; measured differences are below 1e-14.
RTOL, ATOL = 1e-9, 1e-12
BATCH, STEPS, LR = 8, 3, 0.01


@pytest.fixture(scope="module")
def tree():
    # the tier-1 run shares the cores between several worker processes
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    mesh = init_mesh(store=dist.HashStore(), device="cpu")
    yield mesh
    dist.destroy_process_group()
    torch.set_num_threads(threads)


def _assert_trees_close(port, jax_tree, rtol=RTOL, atol=ATOL):
    want = from_jax(jax.device_get(jax_tree), {})[0]
    got, exp = tree_leaves(port), tree_leaves(want)
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)


def _batches(make, n):
    x, y, _ = make(n * BATCH, seed=0)
    x = x.astype(np.float64)
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_sgd_run():
    """3 JAX AllReduceSGD steps on the float64 convnet (compiled once)."""
    jtree = JaxMeshTree(num_nodes=1)
    jm = jax_cifar(dtype=jnp.float64, dropout_rate=0.0)
    ts0 = jtr.init_train_state(jm, jtree, random.PRNGKey(0), 10)
    step = jtr.build_sgd_step(jm, jtree, lr=LR, donate=False)
    sh = NamedSharding(jtree.mesh, P("data"))
    ts, losses = ts0, []
    for x, y in _batches(synthetic_cifar10, STEPS):
        ts, loss = step(ts, jax.device_put(x, sh), jax.device_put(y, sh))
        losses.append(float(loss))
    return ts0, ts, losses


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_sgd_steps_match_jax(tree, jax_sgd_run, fused):
    ts0, jts, jlosses = jax_sgd_run
    params, mstate = from_jax(jax.device_get(ts0.params),
                              jax.device_get(ts0.model_state))
    ts = ttr.TrainState(params, mstate, ttr.allreduce_sgd.init_state("cpu"),
                        torch.zeros((10, 10), dtype=torch.int64),
                        torch.Generator())
    step = ttr.build_sgd_step(cifar_convnet(torch.float64, dropout_rate=0.0),
                              tree, LR, fused=fused)
    before = fused_update.fused_sgd.launches
    losses = []
    for x, y in _batches(synthetic_cifar10, STEPS):
        ts, loss = step(ts, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(loss))
    assert fused_update.fused_sgd.launches == before   # CPU: plain route
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    _assert_trees_close(ts.params, jts.params)
    _assert_trees_close(ts.model_state, jts.model_state)
    assert int(ts.sync.my_steps) == int(np.asarray(jts.sync.my_steps)[0]) \
        == STEPS
    np.testing.assert_array_equal(ts.cm.numpy(), np.asarray(jts.cm)[0])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_ea_steps_match_jax(tree, fused, momentum):
    """tau = 2 local steps then one elastic round, on the float64 MNIST CNN
    (its compile is cheap; the convnet's elastic round on the same buckets
    is held in tests/test_torch_fused_update.py)."""
    tau, alpha = 2, 0.2
    jtree = JaxMeshTree(num_nodes=1)
    jm = jax_mnist(dtype=jnp.float64)
    jts = jtr.init_ea_state(jm, jtree, random.PRNGKey(0), 10)
    jlocal, jround = jtr.build_ea_steps(jm, jtree, lr=0.05, alpha=alpha,
                                        donate=False, momentum=momentum)
    # the elastic round moves nothing from identical params and center, so
    # start the center elsewhere
    shift = lambda a: a + 0.01 * np.cos(np.arange(a.size).reshape(a.shape))
    jts = jts._replace(center=jax.tree_util.tree_map(
        lambda a: jtree.put_per_node(shift(np.asarray(a))), jts.center))
    params, _ = from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                                jts.params), {})
    center, _ = from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                                jts.center), {})
    ts = ttr.EATrainState(params, {}, center,
                          jax.tree_util.tree_map(torch.zeros_like, params),
                          torch.zeros((10, 10), dtype=torch.int64),
                          torch.Generator())
    local, rnd = ttr.build_ea_steps(mnist_cnn(torch.float64), tree, lr=0.05,
                                    alpha=alpha, fused=fused,
                                    momentum=momentum)
    sh = NamedSharding(jtree.mesh, P("data"))
    for x, y in _batches(synthetic_mnist, tau):
        jts, jloss = jlocal(jts, jax.device_put(x, sh), jax.device_put(y, sh))
        ts, loss = local(ts, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(np.asarray(jloss)[0]),
                                   rtol=RTOL)
    jts, ts = jround(jts), rnd(ts)
    first = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a)[0], t)
    _assert_trees_close(ts.params, first(jts.params))
    _assert_trees_close(ts.center, first(jts.center))
    _assert_trees_close(ts.vel, first(jts.vel))
    np.testing.assert_array_equal(ts.cm.numpy(), np.asarray(jts.cm)[0])


def test_eval_step_matches_jax(tree):
    jtree = JaxMeshTree(num_nodes=1)
    jm = jax_mnist(dtype=jnp.float64)
    params, mstate = jm.init(random.PRNGKey(3))
    (x, y), = _batches(synthetic_mnist, 1)
    sh = NamedSharding(jtree.mesh, P("data"))
    jcm, jloss = jtr.build_eval_step(jm, jtree)(
        params, mstate, jax.device_put(jnp.zeros((1, 10, 10), jnp.int32), sh),
        jax.device_put(x, sh), jax.device_put(y, sh))
    tp, _ = from_jax(jax.device_get(params), {})
    cm, loss = ttr.build_eval_step(mnist_cnn(torch.float64), tree)(
        tp, {}, torch.zeros((10, 10), dtype=torch.int64), torch.from_numpy(x),
        torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm)[0])
    assert int(cm.sum()) == BATCH
    assert metrics.total_valid(cm) == jax_metrics.total_valid(
        np.asarray(jcm)[0])


def test_sgd_step_with_dropout_trains_on_its_own_generator(tree):
    """The default convnet (dropout 0.5) from the port's own init: losses
    finite and falling, every example counted, and the dropout generator
    advanced by the step."""
    model = cifar_convnet(torch.float32)
    ts = ttr.init_train_state(model, tree, seed=0, num_classes=10)
    state0 = ts.rng.get_state().clone()
    # lr 0.002: the 2048-wide linear layer turns larger rates into a loss
    # spike at these small batches
    step = ttr.build_sgd_step(model, tree, lr=0.002)
    x, y, _ = synthetic_cifar10(10 * 16, seed=1)
    losses = []
    for i in range(10):
        ts, loss = step(ts, torch.from_numpy(x[i * 16:(i + 1) * 16]),
                        torch.from_numpy(y[i * 16:(i + 1) * 16]))
        losses.append(float(loss))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int(ts.cm.sum()) == 10 * 16
    assert not torch.equal(ts.rng.get_state(), state0)
