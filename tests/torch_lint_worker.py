"""One rank of the gloo ranks in tests/test_torch_lint_spmd.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX.  Every rank runs every case of :func:`run_cases` in order
inside :func:`distlearn_tpu_torch.lint.spmd.record` (dry where the ranks
disagree on purpose, so that nothing hangs) and pickles ``{case: result}``
to ``<out_dir>/rank<r>.pkl``; the parent lints the records.
"""

import os
import pickle

import torch
import torch.distributed as dist

from distlearn_tpu_torch.lint import spmd
from distlearn_tpu_torch.models import nn as port_nn
from distlearn_tpu_torch.parallel import mesh as pmesh
from distlearn_tpu_torch.train import trainer

WORLD = 4


def _x(rank, n=8, dtype=torch.float32):
    return torch.arange(n, dtype=torch.float32).add(rank).to(dtype)


def run_cases(rank):
    mesh = pmesh.Mesh((2, 2), ("data", "model"), device="cpu",
                      backend="gloo")
    flat = pmesh.Mesh((WORLD,), ("data",), device="cpu", backend="gloo")
    data, model = mesh.axis("data"), mesh.axis("model")
    axes = spmd.axis_map(mesh)
    out = {}

    def case(name, fn, m=mesh, dry=False, **extra):
        with spmd.record(spmd.axis_map(m), dry=dry) as rec:
            fn()
        out[name] = dict(rec=rec, **extra)

    case("psum_quiet", lambda: (pmesh.psum_raw(_x(rank), data),
                                pmesh.psum_raw(_x(rank, 4), model)))
    case("unknown_axis", lambda: pmesh.psum_raw(_x(rank),
                                                flat.axis("model")), m=flat)
    case("stray_group", lambda: dist.all_reduce(_x(rank)), m=mesh)
    case("diverge_shape", lambda: dist.all_reduce(
        _x(rank, 4 if data.index == 0 else 8), group=data.group), dry=True)
    case("diverge_extra", lambda: [pmesh.psum_raw(_x(rank), data)
                                   for _ in range(1 + (data.index == 0))],
         dry=True)

    def lone_send():
        if data.index == 0:
            peer = data.ranks[1]
            dist.batch_isend_irecv([dist.P2POp(dist.isend, _x(rank), peer,
                                               data.group)])
    case("permute_unmatched", lone_send, dry=True)
    case("permute_quiet", lambda: pmesh.ppermute_raw(
        _x(rank), data, [(0, 1), (1, 0)]))
    case("bf16_psum", lambda: pmesh.psum_raw(_x(rank, dtype=torch.bfloat16),
                                             data))
    case("bf16_max", lambda: dist.all_reduce(
        _x(rank, dtype=torch.bfloat16), op=dist.ReduceOp.MAX,
        group=data.group))
    case("f32_upcast", lambda: pmesh.psum_raw(
        _x(rank, dtype=torch.bfloat16).float(), data).to(torch.bfloat16))

    groups = [data.ranks]

    def draw(gen):
        return lambda: port_nn.dropout(gen, torch.ones(16), 0.5, True)
    case("dropout_shared", draw(torch.Generator().manual_seed(0)),
         draw_groups=groups)
    case("dropout_per_node", draw(trainer._node_generator(0, data.index,
                                                          "cpu")),
         draw_groups=groups)

    # every mesh collective beside Mesh.stats (which counts them too)
    mesh.stats.reset()

    def kinds():
        x = _x(rank, 8).reshape(4, 2)
        pmesh.psum_raw(x, data)
        pmesh.ppermute_raw(x, model, [(0, 1), (1, 0)])
        pmesh.all_to_all_raw(x, data, 0, 1)
        pmesh.all_gather_raw(x, model, 0)
        pmesh.psum_scatter_raw(x, data)
    case("stats", kinds)
    out["stats"]["stats"] = (dict(mesh.stats.calls), dict(mesh.stats.bytes))
    out["axes"] = sorted(set(axes.values()))
    return out


def run(rank, store_path, out_dir):
    os.nice(10)         # a burst of ranks beside other workers' tests
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            store=dist.FileStore(store_path, WORLD))
    try:
        out = run_cases(rank)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(out_dir, timeout=240):
    """Every rank's ``{case: result}``."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, f"{out_dir}/store", out_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"lint ranks still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
