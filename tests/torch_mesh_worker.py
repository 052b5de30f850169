"""One rank of the gloo meshes in tests/test_torch_mesh_lm.py,
tests/test_torch_moe.py, tests/test_torch_pp.py,
tests/test_torch_optim_lm.py and tests/test_torch_checkpoint_sharded.py.

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

from distlearn_tpu_torch.models import convert
from distlearn_tpu_torch.models.convert import lm_gather, lm_shard
from distlearn_tpu_torch.models.transformer import transformer_lm
from distlearn_tpu_torch.parallel import ep as pep
from distlearn_tpu_torch.parallel import mesh as pmesh
from distlearn_tpu_torch.parallel import pp as ppp
from distlearn_tpu_torch.parallel import sequence as pseq
from distlearn_tpu_torch.train import lm as tlm
from distlearn_tpu_torch.train import optim as topt
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


def _pipeline(mesh, case):
    """``pipeline_apply`` of ``tanh(h @ w + b)`` stages: the output, and the
    gradients of one rank's share (1/S) of the replicated ``sum(out**2)``;
    the errors of a shape-changing stage and an indivisible batch."""
    ax = mesh.axis("pipe")
    w = torch.from_numpy(case["w"][ax.index]).requires_grad_()
    b = torch.from_numpy(case["b"][ax.index]).requires_grad_()

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    out = ppp.pipeline_apply(stage, {"w": w, "b": b},
                             torch.from_numpy(case["x"]), case["M"], ax)
    gw, gb = torch.autograd.grad((out ** 2).sum() / ax.size, (w, b))
    res = {"out": _np(out), "gw": _np(gw), "gb": _np(gb), "errors": []}
    x = torch.zeros(16, case["x"].shape[1])
    for args in (({"w": torch.zeros(x.shape[1], x.shape[1] + 1)},
                  lambda p, h: h @ p["w"], 2),
                 ({"w": w, "b": b}, stage, 3)):
        for fn in ("apply", "1f1b"):
            try:
                if fn == "apply":
                    ppp.pipeline_apply(args[1], args[0], x, args[2], ax)
                else:
                    ppp.pipeline_1f1b(args[1], args[0],
                                      lambda c, o, m: o.sum(), {}, x,
                                      args[2], ax)
            except ValueError as e:
                res["errors"].append(str(e))
    return res


def _pp_step(mesh, case):
    """One GPipe or 1F1B step from the JAX params on this rank's stage:
    the loss and the whole updated tree (``lm_pp_gather``)."""
    depth = case["cfg"]["depth"]
    shared, stacked = convert.lm_pp_shard(case["params"], mesh, depth)
    builder = tlm.build_lm_pp_1f1b_step if case["schedule"] == "1f1b" \
        else tlm.build_lm_pp_step
    step = builder(mesh, *tlm.stack_blocks(
        convert.lm_from_jax(case["params"]), depth), lr=case["lr"],
        num_microbatches=case["M"], remat=case["remat"],
        **case.get("kw", {}))
    shared, stacked, loss = step(shared, stacked,
                                 _tokens_block(mesh, case["tokens"]))
    return {"loss": float(loss),
            "params": convert.lm_pp_gather(shared, stacked, mesh, depth)}


class _Held:
    """A saved tensor's storage, counted live while autograd keeps it."""

    def __init__(self, t, live):
        self.t, self.live = t, live
        self.key = t.untyped_storage().data_ptr()
        refs = live["refs"]
        if refs.get(self.key, 0) == 0:
            live["bytes"] += t.untyped_storage().nbytes()
            live["peak"] = max(live["peak"], live["bytes"])
        refs[self.key] = refs.get(self.key, 0) + 1

    def __del__(self):
        refs = self.live["refs"]
        refs[self.key] -= 1
        if refs[self.key] == 0:
            self.live["bytes"] -= self.t.untyped_storage().nbytes()


def _pp_liveness(mesh, case):
    """The peak bytes of the storages autograd holds saved during one GPipe
    and one 1F1B step (``saved_tensors_hooks``), and the bytes of 1F1B's
    ring of ``2S - 1`` stage inputs, which it holds outside autograd."""
    depth, M = case["cfg"]["depth"], case["M"]
    whole = convert.lm_from_jax(case["params"])
    toks = _tokens_block(mesh, case["tokens"])
    res = {}
    for name, builder in (("gpipe", tlm.build_lm_pp_step),
                          ("1f1b", tlm.build_lm_pp_1f1b_step)):
        shared, stacked = convert.lm_pp_shard(case["params"], mesh, depth)
        step = builder(mesh, *tlm.stack_blocks(whole, depth), lr=1.0,
                       num_microbatches=M)
        live = {"refs": {}, "bytes": 0, "peak": 0}
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: _Held(t, live), lambda h: h.t):
            step(shared, stacked, toks)
        res[name] = live["peak"]
    S = mesh.axis_size("pipe")
    mb = toks.shape[0] // M
    res["ring"] = (2 * S - 1) * mb * toks.shape[1] * case["cfg"]["dim"] * 4
    return res


def _wait_for_pickle(path, timeout=240.0):
    """The object the parent pickles to ``path`` while the ranks run."""
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _opt_states(st):
    return [_np(t) for t in tree_leaves(st.opt_state)]


def _lm_zero(mesh, case):
    """``steps`` ZeRO-1 steps over the data axis (the data-only mesh) or the
    (data, seq, model) mesh: losses, the whole params, this rank's master
    and optimizer rows, and the initial state's rows."""
    dtype = DTYPES[case.get("dtype", "float32")]
    model = transformer_lm(dtype=dtype, **case["cfg"])
    tx = topt.adam(case["lr"])
    on_mesh = "seq" in mesh.axis_names
    if on_mesh:
        params = lm_shard(case["params"], mesh, "model", dtype=dtype)
        st = topt.init_lm_zero_mesh_state(params, mesh, tx,
                                          tp_axis="model")
        step = topt.build_lm_zero_mesh_step(model, mesh, tx,
                                            seq_axis="seq", tp_axis="model")
    else:
        params = convert.lm_from_jax(case["params"], dtype=dtype)
        st = topt.init_lm_zero_state(params, mesh, tx)
        step = topt.build_lm_zero_step(model, mesh, tx)
    res = {"init_master": _np(st.master), "init_opt": _opt_states(st)}
    if "jax_state_file" in case:   # start from the JAX package's state
        js = _wait_for_pickle(case["jax_state_file"])
        if on_mesh:
            index = (mesh.axis_index("data"), mesh.axis_index("model"))
            params = lm_shard(js.params, mesh, "model", dtype=dtype)
        else:
            index = mesh.axis_index("data")
            params = convert.lm_from_jax(js.params, dtype=dtype)
        st = convert.lm_zero_from_jax(js, tx, index, params=params)
    toks = _tokens_block(mesh, case["tokens"])
    res["losses"] = []
    for _ in range(case["steps"]):
        st, loss = step(st, toks)
        res["losses"].append(float(loss))
    res["params"] = lm_gather(st.params, mesh,
                              "model" if on_mesh else None)
    res["dtypes"] = sorted({str(t.dtype) for t in tree_leaves(st.params)})
    res["master"], res["opt"] = _np(st.master), _opt_states(st)
    res["stacked"] = convert.lm_zero_to_jax([st])
    return res


def _lm_optax(mesh, case):
    """``steps`` of the replicated-state optimizer step (or the mixed one)
    over the (data, seq, model) mesh's data and seq axes."""
    model = transformer_lm(**case["cfg"])
    tx = getattr(topt, case.get("tx", "adam"))(case["lr"])
    params = convert.lm_from_jax(case["params"])
    kw = dict(seq_axis="seq", **case.get("kw", {}))
    if case.get("mixed"):
        step = topt.build_lm_mixed_optax_step(model, mesh, tx, **kw)
        st = topt.init_lm_mixed_optax_state(params, tx,
                                            param_dtype=torch.float32)
    else:
        step = topt.build_lm_optax_step(model, mesh, tx, **kw)
        st = topt.LMOptaxState(params, tx.init(params))
    toks = _tokens_block(mesh, case["tokens"])
    losses = []
    for _ in range(case["steps"]):
        st, loss = step(st, toks)
        losses.append(float(loss))
    res = {"losses": losses, "params": convert.lm_to_jax(st.params),
           "opt": _opt_states(st)}
    if case.get("mixed"):
        res["master"] = convert.lm_to_jax(st.master)
    return res


def _lm_fsdp(mesh, case):
    """FSDP steps from the JAX params: this rank's storage (per leaf, shard
    and whole sizes), losses, the gathered params and the collectives of
    the last step; and ``build_lm_step`` on the same mesh and rows."""
    model = transformer_lm(**case["cfg"])
    whole = convert.lm_from_jax(case["params"])
    shards = topt.init_lm_fsdp_params(case["params"], mesh)
    res = {"sizes": [(s.numel(), w.numel()) for s, w in
                     zip(tree_leaves(shards), tree_leaves(whole))]}
    step = topt.build_lm_fsdp_step(model, mesh, whole, lr=case["lr"],
                                   accum_steps=case.get("accum", 1))
    toks = _tokens_block(mesh, case["tokens"])
    res["losses"] = []
    for _ in range(case["steps"]):
        mesh.stats.reset()
        shards, loss = step(shards, toks)
        res["losses"].append(float(loss))
    res["calls"], res["bytes"] = dict(mesh.stats.calls), \
        dict(mesh.stats.bytes)
    res["kept"] = [(s.numel(), w.numel()) for s, w in
                   zip(tree_leaves(shards), tree_leaves(whole))]
    res["params"] = convert.fsdp_gather(shards, mesh, whole)
    if case.get("ref"):
        ref = tlm.build_lm_step(model, mesh, lr=case["lr"])
        p, loss = ref(whole, toks)
        res["ref"] = (float(loss), convert.lm_to_jax(p))
    return res


def _zero_ckpt(mesh, case):
    """The ZeRO-1 LM resume through sharded checkpoints (over the data
    axis, or the (data, seq, model) mesh's state): two steps, every rank
    saves its records, two more steps (the reference); a fresh state
    restored from the files takes the same two steps.  Then, given the
    JAX package's checkpoint of its own state, this rank's state restored
    from it."""
    from distlearn_tpu_torch.utils.checkpoint import save_sharded_checkpoint
    model = transformer_lm(**case["cfg"])
    tx = topt.adam(case["lr"])
    on_mesh = "model" in mesh.axis_names
    tp = "model" if on_mesh else None
    if on_mesh:
        params = lm_shard(case["params"], mesh, tp)
        step = topt.build_lm_zero_mesh_step(model, mesh, tx, seq_axis="seq",
                                            tp_axis=tp)
    else:
        params = convert.lm_from_jax(case["params"])
        step = topt.build_lm_zero_step(model, mesh, tx)
    toks = _tokens_block(mesh, case["tokens"])
    st = topt.init_lm_zero_state(params, mesh, tx)
    for _ in range(2):
        st, _ = step(st, toks)
    save_sharded_checkpoint(case["dir"], 2,
                            convert.lm_zero_records(st, mesh, tp_axis=tp),
                            metadata={"note": "zero"},
                            process_index=dist.get_rank())
    res = {"saved": convert.lm_zero_to_jax([st]),
           "params": lm_gather(st.params, mesh, tp),
           "index": tuple(mesh.axis_index(a) for a in mesh.axis_names)}
    ref = st
    for _ in range(2):
        ref, ref_loss = step(ref, toks)
    dist.barrier()                 # every rank's file is on disk
    fresh = topt.init_lm_zero_state(params, mesh, tx)
    st2, meta = convert.lm_zero_restore(case["dir"], fresh, mesh,
                                        tp_axis=tp)
    res["meta"] = meta
    res["restored_equal"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(st2),
                                          tree_leaves(st)))
    for _ in range(2):
        st2, loss2 = step(st2, toks)
    res["losses"] = (float(ref_loss), float(loss2))
    res["params_equal"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(ref.params),
                                          tree_leaves(st2.params)))
    if "jax_state_file" in case:
        # the JAX package's checkpoint of its own state after two steps
        js = _wait_for_pickle(case["jax_state_file"])
        st3, _ = convert.lm_zero_restore(case["jax_dir"], fresh, mesh)
        want = convert.lm_zero_from_jax(js, tx, mesh.axis_index("data"))
        res["from_jax_equal"] = [torch.equal(a, b) for a, b in
                                 zip(tree_leaves(st3), tree_leaves(want))]
    return res


KINDS = {"collectives": _collectives, "attention": _attention,
         "lm_step": _lm_step, "shard_roundtrip": _shard_roundtrip,
         "moe_metrics": _moe_metrics, "moe_ffn": _moe_ffn,
         "pipeline": _pipeline, "pp_step": _pp_step,
         "pp_liveness": _pp_liveness, "lm_zero": _lm_zero,
         "lm_optax": _lm_optax, "lm_fsdp": _lm_fsdp,
         "zero_ckpt": _zero_ckpt}


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
