"""One rank of the two-rank gloo run in tests/test_torch_train_scan.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX: the parent runs the JAX reference and compares.  Each rank
takes its shard of every step's global batch, runs ``build_sgd_scan_step``
with its column of the participation flags against the same per-call steps,
and one ``build_ea_cycle``, and saves what it computed to
``<out_dir>/rank<r>.pt``.
"""

import torch
import torch.distributed as dist

from distlearn_tpu_torch.models import cifar_convnet
from distlearn_tpu_torch.models.convert import from_jax
from distlearn_tpu_torch.parallel import allreduce_sgd
from distlearn_tpu_torch.parallel.mesh import init_mesh
from distlearn_tpu_torch.train import trainer as ttr
from distlearn_tpu_torch.utils.tree import tree_map


def _sgd_state(inp):
    params, mstate = from_jax(inp["params"], inp["state"])
    return ttr.TrainState(params, mstate, allreduce_sgd.init_state("cpu"),
                          torch.zeros((10, 10), dtype=torch.int64),
                          torch.Generator())


def run(rank, world, store_path, inp, out_dir):
    torch.set_num_threads(2)     # two ranks and the parent share the cores
    tree = init_mesh(rank, world, store=dist.FileStore(store_path, world),
                     device="cpu")
    try:
        model = cifar_convnet(torch.float64, dropout_rate=0.0)
        per = inp["xs"].shape[1] // world
        xs = torch.from_numpy(inp["xs"][:, rank * per:(rank + 1) * per])
        ys = torch.from_numpy(inp["ys"][:, rank * per:(rank + 1) * per])
        cs = torch.from_numpy(inp["contribs"][:, rank].copy())
        out = {}

        scan = ttr.build_sgd_scan_step(model, tree, inp["lr"],
                                       with_contrib=True)
        out["scan"], out["scan_losses"] = scan(_sgd_state(inp), xs, ys, cs)
        step = ttr.build_sgd_step(model, tree, inp["lr"], with_contrib=True)
        ts, losses = _sgd_state(inp), []
        for k in range(xs.shape[0]):
            ts, loss = step(ts, xs[k], ys[k], cs[k])
            losses.append(loss)
        out["call"], out["call_losses"] = ts, torch.stack(losses)

        params, mstate = from_jax(inp["params"], inp["state"])
        ets = ttr.EATrainState(
            params, mstate, tree_map(lambda p: p + 0.01, params),
            tree_map(torch.zeros_like, params),
            torch.zeros((10, 10), dtype=torch.int64), torch.Generator())
        cycle = ttr.build_ea_cycle(model, tree, inp["lr"], inp["alpha"])
        out["ea"], out["ea_losses"] = cycle(ets, xs, ys)
        for key in ("scan", "call", "ea"):     # a Generator does not pickle
            out[key] = out[key]._replace(rng=None)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
