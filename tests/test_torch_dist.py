"""Two gloo ranks of the port against the JAX package's two-node mesh.

The ranks (tests/torch_dist_worker.py, spawned with torch.multiprocessing)
import only the port; this process runs JAX on ``MeshTree(num_nodes=2)`` on
the same weights and the same global batch, and compares:

* one sync-batchnorm SGD step — parameters equal JAX's and equal bit for bit
  across ranks (the counterpart of tests/test_train.py:49);
* a step in which rank 1 does not contribute, then the winner-takes-all
  sync (tests/test_train.py:81,107), plus the sync's tie-breaks;
* one elastic round — the center moves by the sum of the deltas;
* the reference closure API (``AllReduceSGD``, ``AllReduceEA``), the in-step
  tau gating and center/parameter syncs, on small hand-checked values.

float64 throughout (see tests/test_torch_train.py): the port lands within
~1e-15 of JAX, so the tolerance is tight.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.train import trainer as jtr  # noqa: E402
from distlearn_tpu_torch.data import synthetic_cifar10  # noqa: E402

import torch_dist_worker  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12
WORLD, PER_RANK, LR, ALPHA = 2, 2, 0.01, 0.2
JOIN_TIMEOUT_S = 120
TIE_CASES = {"one_stepped": (1, 0), "tie_goes_last": (2, 2),
             "none_stepped": (0, 0), "most_wins": (1, 3)}
TIE_WINNERS = {"one_stepped": 0, "tie_goes_last": 1, "none_stepped": 0,
               "most_wins": 1}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _port_layout(name, a):
    """JAX leaf layout -> the port's (HWIO -> OIHW, [in,out] -> [out,in])."""
    if name.endswith("/w") and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if name.endswith("/w") and a.ndim == 2:
        return a.T
    return a


def _assert_prefix_close(ranks, jax_flat, prefix, jax_prefix):
    keys = sorted(k for k in jax_flat if k.startswith(jax_prefix + "/"))
    assert keys
    for k in keys:
        want = _port_layout(k, jax_flat[k])
        for r in ranks:
            np.testing.assert_allclose(
                r[prefix + k[len(jax_prefix):]], want, rtol=RTOL, atol=ATOL,
                err_msg=k)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("torch_dist")
    jm = jax_cifar(dtype=jnp.float64, dropout_rate=0.0)
    params, state = jax.jit(jm.init)(random.PRNGKey(0))
    x, y, _ = synthetic_cifar10(WORLD * PER_RANK, seed=0)
    x = x.astype(np.float64)
    rng = np.random.RandomState(5)
    np_params = _np_tree(params)
    ea_params = [jax.tree_util.tree_map(
        lambda a: a + rng.randn(*a.shape) * 1e-2, np_params)
        for _ in range(WORLD)]
    ea_center = jax.tree_util.tree_map(lambda a: a + rng.randn(*a.shape) * 1e-2,
                                       np_params)
    inp = {"params": np_params, "state": _np_tree(state), "x": x, "y": y,
           "lr": LR, "alpha": ALPHA, "contrib": [1, 0],
           "tie_cases": TIE_CASES, "ea_params": ea_params,
           "ea_center": ea_center}

    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, WORLD, str(out_dir / "store"), inp,
                               str(out_dir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the JAX reference, while the ranks run
        jtree = JaxMeshTree(num_nodes=WORLD)
        sh = NamedSharding(jtree.mesh, P("data"))
        step = jtr.build_sgd_step(jm, jtree, lr=LR, donate=False,
                                  with_contrib=True)
        ref = {}
        for tag, contrib in (("all", [1, 1]), ("contrib", [1, 0])):
            ts = jtr.init_train_state(jm, jtree, random.PRNGKey(0), 10)
            ts = ts._replace(params=params, model_state=state)
            ts, loss = step(ts, jax.device_put(x, sh), jax.device_put(y, sh),
                            jax.device_put(np.array(contrib, np.int32), sh))
            _flat(tag, _np_tree(ts.params), ref)
            _flat(tag + "_stats", _np_tree(ts.model_state), ref)
            ref[tag + "_loss"] = float(loss)
            ref[tag + "_steps"] = np.asarray(ts.sync.my_steps)
            ref[tag + "_cm"] = np.asarray(ts.cm)
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(5)
    assert not alive, f"ranks still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, ref, inp


@pytest.mark.parametrize("tag", ["plain", "fused"])
def test_sync_bn_sgd_step_matches_jax_and_replicates(run, tag):
    ranks, ref, _ = run
    _assert_prefix_close(ranks, ref, f"sgd_{tag}", "all")
    _assert_prefix_close(ranks, ref, f"sgd_{tag}_stats", "all_stats")
    for k in ranks[0]:
        if k.startswith(f"sgd_{tag}"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r[f"sgd_{tag}_loss"], ref["all_loss"],
                                   rtol=RTOL)


def test_contrib_step_masks_the_non_contributor(run):
    ranks, ref, _ = run
    _assert_prefix_close(ranks, ref, "contrib", "contrib")
    _assert_prefix_close(ranks, ref, "contrib_stats", "contrib_stats")
    assert [int(r["contrib_steps"]) for r in ranks] == \
        list(ref["contrib_steps"]) == [1, 0]
    for r, jcm in zip(ranks, ref["contrib_cm"]):
        np.testing.assert_array_equal(r["contrib_cm"], jcm)
    assert int(ranks[1]["contrib_cm"].sum()) == 0
    for r in ranks:
        np.testing.assert_allclose(r["contrib_loss"], ref["contrib_loss"],
                                   rtol=RTOL)


def test_winner_takes_all_sync(run):
    ranks, _, _ = run
    synced = sorted(k for k in ranks[0] if k.startswith("synced/"))
    assert synced
    for k in synced:
        winner = ranks[0]["drifted/" + k[len("synced/"):]]   # rank 0 stepped
        for r in ranks:
            np.testing.assert_array_equal(r[k], winner, err_msg=k)
    assert [int(r["synced_steps"]) for r in ranks] == [0, 0]


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_winner_tie_breaks(run, case):
    ranks, _, _ = run
    for r in ranks:
        np.testing.assert_array_equal(r[f"tie_{case}"],
                                      np.full(3, float(TIE_WINNERS[case])))


@pytest.mark.parametrize("tag", ["plain", "fused"])
def test_ea_round_center_moves_by_sum_of_deltas(run, tag):
    ranks, _, inp = run
    deltas = [jax.tree_util.tree_map(lambda p, c: (p - c) * ALPHA, p,
                                     inp["ea_center"])
              for p in inp["ea_params"]]
    center = jax.tree_util.tree_map(lambda c, *d: c + sum(d),
                                    inp["ea_center"], *deltas)
    want_c = {}
    _flat("c", center, want_c)
    for r, (p, d) in enumerate(zip(inp["ea_params"], deltas)):
        want_p = {}
        _flat("p", jax.tree_util.tree_map(lambda a, b: a - b, p, d), want_p)
        _assert_prefix_close([ranks[r]], want_p, f"ea_{tag}_params", "p")
    _assert_prefix_close(ranks, want_c, f"ea_{tag}_center", "c")
    for k in ranks[0]:
        if k.startswith(f"ea_{tag}_center"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_allreduce_sgd_closure_api(run):
    ranks, _, _ = run
    for r in ranks:
        # only rank 0 contributes: its gradient (1), normalised by n = 1
        np.testing.assert_array_equal(r["api_sgd_normed"], np.full(4, 1.0))
        assert int(r["api_sgd_n"]) == 1
        np.testing.assert_array_equal(r["api_sgd_summed"], np.full(4, 3.0))
        assert int(r["api_sgd_n_all"]) == 2
        # rank 0 stepped 3 times, rank 1 twice: rank 0's params win
        np.testing.assert_array_equal(r["api_sgd_synced"], np.full(4, 10.0))


def test_allreduce_ea_closure_api(run):
    ranks, _, _ = run
    for rank, r in enumerate(ranks):
        # center 0 after synchronize_parameters; local moves to rank + 1;
        # the round at step tau = 2 pulls by alpha = 0.25
        np.testing.assert_array_equal(r["api_ea_before"],
                                      np.full(2, rank + 1.0))
        np.testing.assert_array_equal(r["api_ea_params"],
                                      np.full(2, (rank + 1) * 0.75))
        np.testing.assert_array_equal(r["api_ea_center"], np.full(2, 0.75))


def test_ea_in_step_functions(run):
    ranks, _, _ = run
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["fn_ea_step1"], np.full(2, rank + 1.0))
        # rank 1 sat the second step out, yet rank 0 was due: both round
        assert int(r["fn_ea_steps"]) == (2 if rank == 0 else 1)
        np.testing.assert_array_equal(r["fn_ea_params"],
                                      np.full(2, (rank + 1) * 0.5))
        np.testing.assert_array_equal(r["fn_ea_center"], np.full(2, 1.5))
        np.testing.assert_array_equal(r["fn_ea_sync_center"], np.full(2, 7.0))
        np.testing.assert_array_equal(r["fn_ea_sync_params"], np.full(2, 5.0))
        np.testing.assert_array_equal(r["fn_ea_sync_params_center"],
                                      np.full(2, 5.0))
        np.testing.assert_array_equal(r["cm_all"], np.full((10, 10), 3))
