"""One rank of the gloo meshes in tests/test_torch_mesh_lm.py and
tests/test_torch_moe.py.

Started with ``torch.multiprocessing`` (spawn), so it imports the port and
nothing of JAX: the parent runs the JAX package on its CPU mesh and
compares.  Every rank walks the same list of cases; a case names its mesh
shape, and every rank builds each mesh in the same order (group creation
is collective), those outside it included, which then skip the case.  Each
rank pickles ``{case name: result}`` (numpy arrays and floats) to
``<out_dir>/rank<r>.pkl``.
"""

import fcntl
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from distlearn_tpu_torch.models.convert import lm_gather, lm_shard
from distlearn_tpu_torch.models.transformer import transformer_lm
from distlearn_tpu_torch.parallel import ep as pep
from distlearn_tpu_torch.parallel import mesh as pmesh
from distlearn_tpu_torch.parallel import sequence as pseq
from distlearn_tpu_torch.train import lm as tlm
from distlearn_tpu_torch.utils.tree import tree_leaves

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy().copy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy().copy()


def _collectives(mesh, case):
    """psum, ppermute and all_to_all forward and backward on rank-indexed
    inputs: ``out`` and the gradient of ``sum(out * w)``."""
    ax = mesh.axis(case["axis"])
    x_all = torch.from_numpy(case["x"])            # [n, ...]
    res = {}
    ops = {
        "psum": lambda x: pmesh.psum(x, ax),
        "ring": lambda x: pmesh.ppermute(
            x, ax, [(j, (j + 1) % ax.size) for j in range(ax.size)]),
        "partial": lambda x: pmesh.ppermute(x, ax, case["perm"]),
        "a2a_01": lambda x: pmesh.all_to_all(x, ax, 0, 1),
        "a2a_21": lambda x: pmesh.all_to_all(x, ax, 2, 1),
    }
    for name, op in ops.items():
        x = x_all[ax.index].clone().requires_grad_()
        out = op(x)
        w = torch.from_numpy(case["w"][name][ax.index])
        (g,) = torch.autograd.grad((out * w).sum(), x)
        res[name] = (_np(out), _np(g))
    res["gather"] = _np(pmesh.all_gather_raw(x_all[ax.index], ax, 1))
    tree = mesh.tree(case["axis"])
    res["tree"] = (tree.node_index, _np(tree.all_reduce(x_all[ax.index])[0]))
    return res


def _attention(mesh, case):
    """This rank's sequence shard of q, k, v (already in the case's layout)
    through ring, zigzag or Ulysses attention: the output shard and the
    gradients of ``sum(out**2)``."""
    ax = mesh.axis("seq")
    Lloc = case["q"].shape[1] // ax.size
    sl = slice(ax.index * Lloc, (ax.index + 1) * Lloc)
    q, k, v = (torch.from_numpy(case[n][:, sl]).requires_grad_()
               for n in ("q", "k", "v"))
    if case["fn"] == "alltoall":
        out = pseq.alltoall_attention(q, k, v, ax, causal=case["causal"],
                                      impl=case.get("impl"))
    else:
        out = pseq.ring_attention(q, k, v, ax, causal=case["causal"],
                                  layout=case.get("layout", "contig"))
    grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    return {"out": _np(out), "grads": [_np(g) for g in grads]}


def _tokens_block(mesh, tokens):
    """This rank's block of the global batch: rows over data, columns over
    seq (when the mesh has those axes)."""
    names = mesh.axis_names
    t = tokens
    if "data" in names:
        d = mesh.axis("data")
        per = t.shape[0] // d.size
        t = t[d.index * per:(d.index + 1) * per]
    if "seq" in names:
        s = mesh.axis("seq")
        per = t.shape[1] // s.size
        t = t[:, s.index * per:(s.index + 1) * per]
    return torch.from_numpy(np.ascontiguousarray(t))


def _axis_names(mesh, case):
    names = mesh.axis_names
    return dict(seq_axis="seq" if "seq" in names else None,
                tp_axis="model" if "model" in names else None,
                ep_axis=case.get("ep_axis"))


def _lm_step(mesh, case):
    """``steps`` steps of ``build_lm_step`` (or the mixed step) from the
    JAX params, sharded; returns the losses and the gathered params (and
    the masters, with the invariant, for the mixed step)."""
    dtype = DTYPES[case.get("dtype", "float32")]
    model = transformer_lm(dtype=dtype, **case["cfg"])
    axes = _axis_names(mesh, case)
    params = lm_shard(case["params"], mesh, axes["tp_axis"],
                      axes["ep_axis"], dtype=dtype)
    toks = _tokens_block(mesh, case["tokens"])
    kw = dict(case.get("kw", {}), **axes)
    res = {"losses": []}
    if case.get("mixed"):
        step = tlm.build_lm_mixed_step(model, mesh, lr=case["lr"], **kw)
        state = tlm.init_lm_mixed_state(
            params, param_dtype=DTYPES[case.get("param_dtype", "bfloat16")])
    else:
        step = tlm.build_lm_step(model, mesh, lr=case["lr"], **kw)
        state = params
    invariant = True
    for _ in range(case["steps"]):
        state, loss = step(state, toks)
        res["losses"].append(float(loss))
        if case.get("mixed"):
            invariant = invariant and all(
                torch.equal(p, m.to(p.dtype)) for p, m in
                zip(tree_leaves(state.params), tree_leaves(state.master)))
    if case.get("mixed"):
        res["invariant"] = invariant
        res["master"] = lm_gather(state.master, mesh, axes["tp_axis"],
                                  axes["ep_axis"])
    else:
        res["params"] = lm_gather(state, mesh, axes["tp_axis"],
                                  axes["ep_axis"])
    return res


def _shard_roundtrip(mesh, case):
    """``lm_gather(lm_shard(p)) == p`` bit for bit, and this rank's shard
    shapes."""
    axes = _axis_names(mesh, case)
    shard = lm_shard(case["params"], mesh, axes["tp_axis"], axes["ep_axis"])
    back = lm_gather(shard, mesh, axes["tp_axis"], axes["ep_axis"])
    return {"back": back, "shapes": {
        f"{b}/{k}": tuple(v.shape) for b, blk in shard.items()
        if isinstance(blk, dict) for k, v in blk.items()
        if isinstance(v, torch.Tensor)}}


def _moe_metrics(mesh, case):
    model = transformer_lm(**case["cfg"])
    axes = _axis_names(mesh, case)
    params = lm_shard(case["params"], mesh, axes["tp_axis"], axes["ep_axis"])
    metrics = tlm.build_lm_moe_metrics(model, mesh, **axes)
    m = metrics(params, _tokens_block(mesh, case["tokens"]))
    return {k: float(v) for k, v in m.items()}


def _moe_ffn(mesh, case):
    """``moe_ffn`` with this rank's expert ``tanh(h @ W_e)``: the output and
    the gradients of ``sum(y**2)`` for the local expert and the router."""
    ax = mesh.axis("expert")
    experts = torch.from_numpy(case["experts"][ax.index]).requires_grad_()
    router = torch.from_numpy(case["router"]).requires_grad_()
    x = torch.from_numpy(case["x"][ax.index])
    y = pep.moe_ffn(lambda p, h: torch.tanh(h @ p), experts, router, x,
                    capacity_factor=case["capacity_factor"], axis=ax,
                    top_k=case["top_k"])
    g_e, g_r = torch.autograd.grad((y ** 2).sum(), (experts, router))
    res = {"y": _np(y), "g_expert": _np(g_e), "g_router": _np(g_r)}
    bad = torch.zeros((x.shape[1], 2 * ax.size))
    try:
        pep.moe_ffn(lambda p, h: h, experts, bad, x, axis=ax)
    except ValueError as e:
        res["bad_router"] = str(e)
    return res


KINDS = {"collectives": _collectives, "attention": _attention,
         "lm_step": _lm_step, "shard_roundtrip": _shard_roundtrip,
         "moe_metrics": _moe_metrics, "moe_ffn": _moe_ffn}


def run(rank, world, store_path, cases, out_dir):
    torch.set_num_threads(1)     # the ranks and the parent share the cores
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store_path, world))
    try:
        meshes, out = {}, {}
        for case in cases:
            key = (tuple(case["mesh"]), tuple(case["names"]))
            if key not in meshes:
                meshes[key] = pmesh.Mesh(
                    key[0], key[1], device="cpu",
                    ranks=range(int(np.prod(key[0]))))
            mesh = meshes[key]
            if mesh.member:
                out[case["name"]] = KINDS[case["kind"]](mesh, case)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(world, cases, out_dir, meanwhile=None, timeout=240):
    """Run ``cases`` on ``world`` spawned gloo ranks; ``meanwhile()`` runs
    in this process while they do (the JAX references) and its result
    comes back beside the ranks' ``[{case name: result}]``."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, f"{out_dir}/store",
                                           cases, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        ref = meanwhile() if meanwhile is not None else None
    finally:
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(5)
    assert not alive, f"ranks still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(f"{out_dir}/rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, ref


def once_per_session(name, tmp_path_factory, compute):
    """``compute()`` once per test session, shared by the xdist workers:
    the first worker to get here computes and pickles the result beside
    the session's temporary directories, the others wait on a file lock
    and read it (the pytest-xdist recipe for a fixture that runs once).
    Without xdist it just computes."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            result = compute()
            with open(path, "wb") as f:
                pickle.dump(result, f)
            return result
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
