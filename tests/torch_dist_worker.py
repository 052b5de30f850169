"""One rank of the two-rank gloo run in tests/test_torch_dist.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX: the parent runs the JAX reference and compares.  Each rank
writes what it computed to ``<out_dir>/rank<r>.npz``.
"""

import numpy as np
import torch
import torch.distributed as dist

from distlearn_tpu_torch.models import cifar_convnet
from distlearn_tpu_torch.models.convert import from_jax
from distlearn_tpu_torch.parallel import allreduce_ea, allreduce_sgd
from distlearn_tpu_torch.parallel.mesh import init_mesh
from distlearn_tpu_torch.train import trainer as ttr
from distlearn_tpu_torch.utils import metrics
from distlearn_tpu_torch.utils.tree import tree_map


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = v.detach().numpy().copy()


def _train_state(inp):
    params, mstate = from_jax(inp["params"], inp["state"])
    return ttr.TrainState(params, mstate, allreduce_sgd.init_state("cpu"),
                          torch.zeros((10, 10), dtype=torch.int64),
                          torch.Generator())


def run(rank, world, store_path, inp, out_dir):
    torch.set_num_threads(2)     # two ranks and the parent share the cores
    tree = init_mesh(rank, world, store=dist.FileStore(store_path, world),
                     device="cpu")
    try:
        out = {}
        model = cifar_convnet(torch.float64, dropout_rate=0.0)
        per = len(inp["y"]) // world
        x = torch.from_numpy(inp["x"][rank * per:(rank + 1) * per])
        y = torch.from_numpy(inp["y"][rank * per:(rank + 1) * per])

        # one sync-BN step, every rank contributing
        for fused in (False, True):
            tag = "fused" if fused else "plain"
            step = ttr.build_sgd_step(model, tree, inp["lr"], fused=fused)
            ts, loss = step(_train_state(inp), x, y)
            _flat(f"sgd_{tag}", ts.params, out)
            _flat(f"sgd_{tag}_stats", ts.model_state, out)
            out[f"sgd_{tag}_loss"] = loss.numpy()

        # rank `inp["contrib"][rank]` == 0 sits this step out
        step = ttr.build_sgd_step(model, tree, inp["lr"], with_contrib=True,
                                  fused=True)
        ts, loss = step(_train_state(inp), x, y,
                        torch.tensor(inp["contrib"][rank]))
        _flat("contrib", ts.params, out)
        _flat("contrib_stats", ts.model_state, out)
        out["contrib_loss"] = loss.numpy()
        out["contrib_steps"] = ts.sync.my_steps.numpy()
        out["contrib_cm"] = ts.cm.numpy()
        # the nodes drift apart; the winner-takes-all sync must undo it
        drift = tree_map(lambda p: p + (rank + 1) * 1e-3, ts.params)
        _flat("drifted", drift, out)
        synced = ttr.build_sync_step(tree)(ts._replace(params=drift))
        _flat("synced", synced.params, out)
        out["synced_steps"] = synced.sync.my_steps.numpy()

        # tie-breaks: (my_steps per rank) -> params of the winner
        for name, steps in inp["tie_cases"].items():
            st = allreduce_sgd.SGDSyncState(
                torch.tensor(steps[rank], dtype=torch.int32))
            mine = {"v": torch.full((3,), float(rank))}
            got, _ = allreduce_sgd.synchronize_parameters(mine, st, tree)
            out[f"tie_{name}"] = got["v"].numpy()

        # one elastic round from diverged params
        p_r, _ = from_jax(inp["ea_params"][rank], {})
        center, _ = from_jax(inp["ea_center"], {})
        for fused in (False, True):
            tag = "fused" if fused else "plain"
            _, rnd = ttr.build_ea_steps(model, tree, lr=0.0, alpha=inp["alpha"],
                                        fused=fused)
            ets = ttr.EATrainState(p_r, {}, center, {}, None, None)
            ets = rnd(ets)
            _flat(f"ea_{tag}_params", ets.params, out)
            _flat(f"ea_{tag}_center", ets.center, out)

        out.update(_host_api(rank, tree))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _host_api(rank, tree):
    """The reference closure API and the in-step EA functions on small
    tensors; the parent checks them against hand-computed values."""
    f64 = lambda v, n=4: torch.full((n,), float(v), dtype=torch.float64)
    out = {}
    sgd = allreduce_sgd.AllReduceSGD(tree)
    normed, n = sgd.sum_and_normalize_gradients({"w": f64(rank + 1)},
                                                contrib=rank == 0)
    out["api_sgd_normed"], out["api_sgd_n"] = normed["w"].numpy(), n
    summed, n = sgd.sum_gradients({"w": f64(rank + 1)})
    out["api_sgd_summed"], out["api_sgd_n_all"] = summed["w"].numpy(), n
    sgd.sum_gradients({"w": f64(0)})     # steps so far: rank 0: 3, rank 1: 2
    out["api_sgd_synced"] = sgd.synchronize_parameters(
        {"w": f64(10 * (rank + 1))})["w"].numpy()

    ea = allreduce_ea.AllReduceEA(tree, tau=2, alpha=0.25)
    p = ea.synchronize_parameters({"w": f64(rank, 2)})      # all take rank 0's
    p = {"w": p["w"] + (rank + 1)}                          # local steps
    p = ea.average_parameters(p)                            # step 1: no round
    out["api_ea_before"] = p["w"].numpy()
    p = ea.average_parameters(p)                            # step 2: round
    ea.synchronize_center(p)
    out["api_ea_params"] = p["w"].numpy()
    out["api_ea_center"] = ea._center["w"].numpy()

    # the in-step tau gating: only rank 0 reaches the boundary, all round
    st = allreduce_ea.init_state({"w": f64(0, 2)})
    p = {"w": f64(rank + 1, 2)}
    p, st = allreduce_ea.average_parameters(p, st, 2, 0.5, tree)
    out["fn_ea_step1"] = p["w"].numpy()
    p, st = allreduce_ea.average_parameters(p, st, 2, 0.5, tree,
                                            contrib=int(rank == 0))
    out["fn_ea_params"], out["fn_ea_center"] = p["w"].numpy(), \
        st.center["w"].numpy()
    out["fn_ea_steps"] = st.step.numpy()
    st = st._replace(center={"w": f64(7 * (rank + 1), 2)})
    _, st = allreduce_ea.synchronize_center(p, st, tree)
    out["fn_ea_sync_center"] = st.center["w"].numpy()
    p, st = allreduce_ea.synchronize_parameters({"w": f64(rank + 5, 2)}, st,
                                                tree)
    out["fn_ea_sync_params"] = p["w"].numpy()
    out["fn_ea_sync_params_center"] = st.center["w"].numpy()

    cm = torch.full((10, 10), rank + 1, dtype=torch.int64)
    out["cm_all"] = metrics.all_reduce_confusion(cm, tree).numpy()
    return out
