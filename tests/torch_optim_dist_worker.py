"""One rank of the two-rank gloo runs in tests/test_torch_resnet.py and
tests/test_torch_optim.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX: the parent runs the references and compares.  Each rank
writes what it computed to ``<out_dir>/rank<r>.npz``.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from distlearn_tpu_torch.models import mnist_cnn, resnet50
from distlearn_tpu_torch.models.convert import from_jax, to_jax
from distlearn_tpu_torch.parallel.mesh import init_mesh
from distlearn_tpu_torch.train import optim
from distlearn_tpu_torch.train import trainer as ttr
from distlearn_tpu_torch.utils.tree import tree_flatten


def _flat(tree) -> list[np.ndarray]:
    return [np.asarray(a) for a in tree_flatten(to_jax(tree))[0]]


def _shard(inp, rank, world):
    per = len(inp["y"]) // world
    rows = slice(rank * per, (rank + 1) * per)
    return torch.from_numpy(inp["x"][rows]), torch.from_numpy(inp["y"][rows])


def resnet_step(tree, inp, out):
    """``inp["steps"]`` bucketed SGD steps of the float64 ResNet-50 (10
    classes, 32^2) from the JAX weights, buckets capped at 8 MiB."""
    model = resnet50(num_classes=10, dtype=torch.float64, image_size=32)
    params, mstate = from_jax(inp["params"], inp["state"])
    ts = ttr.init_train_state(model, tree, 0, 10)._replace(
        params=params, model_state=mstate)
    step = ttr.build_sgd_step(model, tree, inp["lr"], fused=True,
                              max_bucket_bytes=8 * 1024 * 1024)
    x, y = _shard(inp, tree.node_index, tree.num_nodes)
    losses = []
    for _ in range(inp["steps"]):
        ts, loss = step(ts, x, y)
        losses.append(float(loss))
    out["losses"] = np.array(losses)
    for i, a in enumerate(_flat(ts.params)):
        out[f"p{i}"] = a


def zero_adam(tree, inp, out):
    """``inp["steps"]`` ZeRO-1 Adam steps and as many full-state Adam steps
    of the float32 MNIST convnet (seed 0)."""
    model = mnist_cnn()
    tx = optim.adam(inp["lr"])
    x, y = _shard(inp, tree.node_index, tree.num_nodes)
    for tag, init, build in (
            ("full", optim.init_optax_state, optim.build_optax_step),
            ("zero", optim.init_zero_state, optim.build_zero_optax_step)):
        ts = init(model, tree, tx, 0, 10)
        step = build(model, tree, tx)
        losses = []
        for _ in range(inp["steps"]):
            ts, loss = step(ts, x, y)
            losses.append(float(loss))
        out[f"{tag}_losses"] = np.array(losses)
        for i, a in enumerate(_flat(ts.params)):
            out[f"{tag}_p{i}"] = a
        if tag == "zero":
            out["zero_mu_size"] = np.array(ts.opt_state[0].mu.numel())


def zero_from_jax(tree, inp, out):
    """``inp["steps"]`` ZeRO-1 steps and as many full-state steps of the
    float32 MNIST convnet from the JAX weights ``inp["params"]``, with
    ``inp["tx"]`` ("adam" or "momentum")."""
    model = mnist_cnn()
    tx = {"adam": lambda: optim.adam(inp["lr"]),
          "momentum": lambda: optim.sgd(inp["lr"], momentum=0.9)}[
              inp["tx"]]()
    params, _ = from_jax(inp["params"], {})
    x, y = _shard(inp, tree.node_index, tree.num_nodes)
    for tag, init, build in (
            ("full", optim.init_optax_state, optim.build_optax_step),
            ("zero", optim.init_zero_state, optim.build_zero_optax_step)):
        # both optimizers start from zero moments, whatever the params
        ts = init(model, tree, tx, 0, 10)._replace(params=params)
        step = build(model, tree, tx)
        losses = []
        for _ in range(inp["steps"]):
            ts, loss = step(ts, x, y)
            losses.append(float(loss))
        out[f"{tag}_losses"] = np.array(losses)
        for i, a in enumerate(_flat(ts.params)):
            out[f"{tag}_p{i}"] = a


def run(rank, world, store_path, inp, out_dir, fn):
    torch.set_num_threads(2)     # two ranks and the parent share the cores
    tree = init_mesh(rank, world, store=dist.FileStore(store_path, world),
                     device="cpu")
    try:
        out = {}
        {"resnet_step": resnet_step, "zero_adam": zero_adam,
         "zero_from_jax": zero_from_jax}[fn](tree, inp, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: str, inp: dict, out_dir, world: int = 2,
              timeout: float = 300.0) -> list[dict]:
    """``run(..., fn)`` on ``world`` spawned gloo ranks (the parent's side);
    returns each rank's arrays."""
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, str(out_dir / "store"),
                                           inp, str(out_dir), fn))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(5)
    assert not alive, f"ranks still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
