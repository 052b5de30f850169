"""Named step-function families for the port's distlint — counterpart of
``distlearn_tpu/lint/registry.py``, with its 14 family names.

A family is a list of units.  Host-analysis families (``protocol``,
``model``, ``races``) and the one-process ones (``wirek``, ``sync``) run in
the calling process.  The step families (``sgd``, ``ea``, ``lm``,
``lm_mixed``, ``pp``, ``optax``, ``ep``, ``seq``, ``decode``) run on
:data:`WORLD` gloo rank processes, started once for all of them
(:func:`run_families_costed`): every rank builds every family's meshes in
one order (group creation is collective), a mesh's members run its units,
and each unit runs inside :func:`~distlearn_tpu_torch.lint.spmd.record` on
every member, so the parent holds each rank's calls.  From them it draws
the SPMD findings (DL001-DL004), a
:class:`~distlearn_tpu_torch.lint.cost.CostReport` of the unit's first
rank (bytes and calls per kind and axis; on the card the rise of its peak
memory and its kernel launches, by the wrappers' counters and by the
names a profile of the unit reads) and, through
:mod:`~distlearn_tpu_torch.lint.budget`, the lockfile findings.

The ranks are gloo processes on the CPU and on ``cuda:0`` alike (NCCL
cannot put two ranks on one card; :class:`~distlearn_tpu_torch.parallel.
mesh.Mesh` stages gloo over the card through pinned host memory), so the
recorded calls, and the lockfiles' bytes, are the same in both places.
Sizes are the JAX registry's, except that the LM-type families take head
dim 32 (dim 128, 4 heads; 8 heads where Ulysses splits them over 8 ranks)
and 128 positions a sequence shard, so one configuration engages the flash
kernels on the card (``DISTLEARN_TPU_ATTN=flash`` in the ranks) and their
plain twins on the CPU.  ``sgd_scan_step`` and ``ea_cycle`` are CUDA graphs
on the card; the lint records them on their eager route
(``GraphedProgram.program``), which issues the same calls a capture
holds.  The fused bucket path (B1, B2) is asked for explicitly, so the
CPU and the card issue one allreduce a bucket alike.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Sequence

from distlearn_tpu_torch.lint.core import Finding, LintResult, \
    filter_suppressed

__all__ = ["Entry", "Unit", "MIN_DEVICES", "WORLD", "KERNEL_NAMES",
           "families", "run_family", "run_family_costed",
           "run_families_costed", "run_all"]

#: Rank processes the step families run on (the JAX registry's device
#: count: its 8-device meshes are 8 ranks here).
WORLD = MIN_DEVICES = 8
#: Seconds the parent waits for the ranks.
RANK_TIMEOUT_S = 900
#: Profile substrings of each counted kernel (``ops/csrc/*.cu``).
KERNEL_NAMES = {"B1": ("sgd_chunk",), "B2": ("elastic_vec4",
                                              "elastic_scalar"),
                "B3_amax": ("amax_leaves",), "B3_quant": ("quant_ef_leaves",),
                "B4": ("dequant_add",), "B5a": ("flash_fwd",),
                "B5b": ("flash_bwd_dkv",), "B5c": ("flash_bwd_dq",)}


@dataclass
class Unit:
    """One lintable unit's findings and metadata."""

    name: str
    findings: list[Finding] = field(default_factory=list)
    info: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Entry:
    """A family: ``run(device)`` returns its in-process units (each a
    :class:`Unit`, or a ``(name, callable)`` pair to measure);
    ``ranks(ctx)`` is its body on every rank process."""

    name: str
    description: str
    run: Callable | None = None
    ranks: Callable | None = None


# ---------------------------------------------------------------------------
# Measuring one unit (on a rank or in this process)
# ---------------------------------------------------------------------------

def _launch_counts() -> dict:
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.ops import wire_kernels as wk
    return {"B1": fu.fused_sgd.launches, "B2": fu.fused_elastic.launches,
            "B3_amax": wk.amax_leaves_cuda.launches,
            "B3_quant": wk.quantize_ef_leaves_cuda.launches,
            "B4": wk.dequant_add_leaves_cuda.launches,
            "B5a": fa.flash_attention.launches,
            "B5b": fa.flash_attention_dkv.launches,
            "B5c": fa.flash_attention_dq.launches}


def _profiled(device, run):
    """``run()`` under a settled profile on the card: ``(result, {kernel:
    launches named})``; on the CPU ``(run(), None)``."""
    import torch
    if torch.device(device).type != "cuda":
        return run(), None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile
    with settled_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         torch.cuda.synchronize) as prof:
        out = run()
        torch.cuda.synchronize()
    named = {k: 0 for k in KERNEL_NAMES}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for k, subs in KERNEL_NAMES.items():
            if any(s in e.key for s in subs):
                named[k] += e.count
    return out, named


def measure(device, run, axes=None) -> dict:
    """Run one unit inside a record: ``{"rec", "peak", "launches",
    "named"}`` (peak, launches and profile names on the card only)."""
    from distlearn_tpu_torch.lint import cost, spmd
    before = _launch_counts()
    got = {"peak": None, "named": None}
    with spmd.record(axes) as rec:
        (_, got["named"]), got["peak"] = cost.peak_rise(
            device, lambda: _profiled(device, run))
    after = _launch_counts()
    cuda = str(device).startswith("cuda")
    return {"rec": rec, "peak": got["peak"], "named": got["named"],
            "launches": {k: after[k] - before[k] for k in after}
            if cuda else None}


class RankCtx:
    """What a family's rank body gets: ``rank``, ``device``, and ``unit``
    to record a unit into this rank's results."""

    def __init__(self, rank: int, device):
        self.rank = rank
        self.device = device
        self.results: dict[str, dict] = {}

    def unit(self, name: str, run, axes, *, draw_groups=(),
             findings=()) -> None:
        out = measure(self.device, run, axes)
        out.update(draw_groups=[tuple(g) for g in draw_groups],
                   findings=list(findings))
        self.results[name] = out


# ---------------------------------------------------------------------------
# The step families' rank bodies
# ---------------------------------------------------------------------------

def _seeded(shape, seed, dtype="float32", high=None):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if high is not None:
        return torch.from_numpy(rng.integers(0, high, shape).astype(dtype))
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype))


def _mesh(ctx, shape, names, ranks=None):
    from distlearn_tpu_torch.parallel.mesh import Mesh
    import numpy as np
    ranks = tuple(range(int(np.prod(shape)))) if ranks is None else ranks
    return Mesh(shape, names, device=ctx.device, backend="gloo", ranks=ranks)


def _mnist_batches(ctx, tree, k=None, seed=0):
    """This node's rows of the JAX registry's global batch of 8 (``k``
    stacked batches when given)."""
    n, i = tree.num_nodes, tree.node_index
    per = 8 // n
    lead = () if k is None else (k,)
    x = _seeded(lead + (8, 32, 32, 1), seed)[..., i * per:(i + 1) * per,
                                             :, :, :]
    y = _seeded(lead + (8,), seed + 1, "int64", high=10)[
        ..., i * per:(i + 1) * per]
    return x.to(ctx.device), y.to(ctx.device)


def _mnist_mesh(ctx):
    mesh = _mesh(ctx, (2,), ("data",), ranks=(0, 1))
    return mesh, (mesh.tree("data") if mesh.member else None)


def _sgd_ranks(ctx):
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.models import mnist_cnn
    from distlearn_tpu_torch.train import trainer
    mesh, tree = _mnist_mesh(ctx)
    if tree is None:
        return
    model = mnist_cnn()
    ts = trainer.init_train_state(model, tree, 0, 10)
    x, y = _mnist_batches(ctx, tree)
    xs, ys = _mnist_batches(ctx, tree, k=3)
    axes = axis_map(mesh)
    groups = [mesh.axis("data").ranks]
    sgd = trainer.build_sgd_step(model, tree, lr=0.1, fused=True)
    scan = trainer.build_sgd_scan_step(model, tree, lr=0.1, fused=True)
    ctx.unit("sgd_step", lambda: sgd(ts, x, y), axes, draw_groups=groups)
    ctx.unit("sgd_scan_step", lambda: scan.program(ts, xs, ys), axes,
             draw_groups=groups)
    ctx.unit("sync_step", lambda: trainer.build_sync_step(tree)(ts), axes)
    ctx.unit("eval_step", lambda: trainer.build_eval_step(model, tree)(
        ts.params, ts.model_state, ts.cm, x, y), axes)


def _ea_ranks(ctx):
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.models import mnist_cnn
    from distlearn_tpu_torch.train import trainer
    mesh, tree = _mnist_mesh(ctx)
    if tree is None:
        return
    model = mnist_cnn()
    ts = trainer.init_ea_state(model, tree, 0, 10)
    x, y = _mnist_batches(ctx, tree)
    xs, ys = _mnist_batches(ctx, tree, k=4)
    axes = axis_map(mesh)
    groups = [mesh.axis("data").ranks]
    local, ea_round = trainer.build_ea_steps(model, tree, lr=0.1, alpha=0.5,
                                             fused=True)
    cycle = trainer.build_ea_cycle(model, tree, lr=0.1, alpha=0.5,
                                   fused=True)
    ctx.unit("ea_local_step", lambda: local(ts, x, y), axes,
             draw_groups=groups)
    ctx.unit("ea_round", lambda: ea_round(ts), axes)
    ctx.unit("ea_cycle", lambda: cycle.program(ts, xs, ys), axes,
             draw_groups=groups)


def _optax_ranks(ctx):
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.models import mnist_cnn
    from distlearn_tpu_torch.train import optim
    mesh, tree = _mnist_mesh(ctx)
    if tree is None:
        return
    model = mnist_cnn()
    x, y = _mnist_batches(ctx, tree)
    axes = axis_map(mesh)
    tx = optim.sgd(0.1, momentum=0.9)
    ts = optim.init_optax_state(model, tree, tx, 0, 10)
    step = optim.build_optax_step(model, tree, tx)
    adam = optim.adam(1e-3)
    zts = optim.init_zero_state(model, tree, adam, 0, 10)
    zstep = optim.build_zero_optax_step(model, tree, adam)
    ctx.unit("optax_step", lambda: step(ts, x, y), axes)
    ctx.unit("zero_optax_step", lambda: zstep(zts, x, y), axes)


#: The LM-type families' model: head dim 32 (flash's smallest), 128
#: positions a sequence shard.
LM_DIM, LM_HEADS, LM_SHARD_L = 128, 4, 128


def _lm_block(mesh, tokens):
    """This rank's ``[rows/dp, L/sp]`` block of the global batch."""
    t = tokens
    if "data" in mesh.axis_names:
        d = mesh.axis("data")
        per = t.shape[0] // d.size
        t = t[d.index * per:(d.index + 1) * per]
    if "seq" in mesh.axis_names:
        s = mesh.axis("seq")
        per = t.shape[1] // s.size
        t = t[:, s.index * per:(s.index + 1) * per]
    return t.contiguous().to(mesh.device)


def _lm_setup(ctx, mixed: bool):
    from distlearn_tpu_torch.lint import cost
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.models.convert import lm_shard
    from distlearn_tpu_torch.models.transformer import (param_specs,
                                                        transformer_lm)
    from distlearn_tpu_torch.train import lm as tlm
    dp, sp, tp = 2, 2, 2
    mesh = _mesh(ctx, (dp, sp, tp), ("data", "seq", "model"))
    L = LM_SHARD_L * sp
    model = transformer_lm(vocab=32, dim=LM_DIM, depth=2, heads=LM_HEADS,
                           max_len=L)
    whole = model.init(0, device="cpu")[0]
    shard = lm_shard(whole, mesh, "model")
    name = "lm_mixed_step" if mixed else "lm_step"
    dl202 = cost.replicated_params(
        shard, whole, param_specs(whole, "model"), {"model": tp},
        name=f"{'lm_mixed' if mixed else 'lm'}:{name}")
    tokens = _lm_block(mesh, _seeded((2 * dp, L), 7, "int64", high=32))
    kw = dict(seq_axis="seq", tp_axis="model")
    if mixed:
        step = tlm.build_lm_mixed_step(model, mesh, lr=0.1, **kw)
        state = tlm.init_lm_mixed_state(shard)
    else:
        step = tlm.build_lm_step(model, mesh, lr=0.1, **kw)
        state = shard
    ctx.unit(name, lambda: step(state, tokens), axis_map(mesh),
             findings=dl202)


def _lm_ranks(ctx):
    _lm_setup(ctx, mixed=False)


def _lm_mixed_ranks(ctx):
    _lm_setup(ctx, mixed=True)


def _pp_ranks(ctx):
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.models.convert import lm_pp_shard
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.train import lm as tlm
    depth = 2
    mesh = _mesh(ctx, (2, 2), ("data", "pipe"), ranks=(0, 1, 2, 3))
    if not mesh.member:
        return
    model = transformer_lm(vocab=64, dim=LM_DIM, depth=depth,
                           heads=LM_HEADS, max_len=LM_SHARD_L)
    whole = model.init(0, device="cpu")[0]
    templates = tlm.stack_blocks(whole, depth)
    shared, stacked = lm_pp_shard(whole, mesh, depth)
    tokens = _lm_block(mesh, _seeded((8, LM_SHARD_L), 8, "int64", high=64))
    axes = axis_map(mesh)
    for name, builder in (("lm_pp_step", tlm.build_lm_pp_step),
                          ("lm_pp_1f1b_step", tlm.build_lm_pp_1f1b_step)):
        step = builder(mesh, *templates, lr=0.1, num_microbatches=2)
        ctx.unit(name, lambda step=step: step(shared, stacked, tokens), axes)


def _ep_ranks(ctx):
    import torch
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.models.convert import lm_shard
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.parallel.ep import moe_ffn
    from distlearn_tpu_torch.parallel.mesh import psum
    from distlearn_tpu_torch.train import lm as tlm
    E, N, D = WORLD, 16, 32
    mesh = _mesh(ctx, (E,), ("expert",))
    lm_mesh = _mesh(ctx, (E,), ("data",))
    ax = mesh.axis("expert")
    experts = _seeded((E, D, D), 11).to(ctx.device)
    router = _seeded((D, E), 12).to(ctx.device)
    x = _seeded((E, N, D), 13)[ax.index].to(ctx.device)

    def expert(p, h):
        return torch.tanh(h @ p)

    def fwd():
        with torch.no_grad():
            return moe_ffn(expert, experts[ax.index], router, x, axis=ax)

    def train():
        w = experts[ax.index].clone().requires_grad_()
        r = router.clone().requires_grad_()
        loss = torch.mean(moe_ffn(expert, w, r, x, axis=ax) ** 2)
        g_w, g_r = torch.autograd.grad(loss, [w, r])
        g_r = psum(g_r, ax)
        return w - 0.1 * g_w, r - 0.1 * g_r, psum(loss.detach(), ax) / E

    axes = axis_map(mesh)
    ctx.unit("moe_fwd", fwd, axes)
    ctx.unit("moe_train_step", train, axes)
    # the MoE LM: one expert a data rank, the all-to-all dispatch in every
    # second block, the attention B5a-B5c on the card
    model = transformer_lm(vocab=32, dim=LM_DIM, depth=2, heads=LM_HEADS,
                           max_len=LM_SHARD_L, moe_experts=E)
    shard = lm_shard(model.init(0, device="cpu")[0], lm_mesh, None, "data")
    step = tlm.build_lm_step(model, lm_mesh, lr=0.1, ep_axis="data")
    tokens = _lm_block(lm_mesh, _seeded((E, LM_SHARD_L), 14, "int64",
                                        high=32))
    ctx.unit("lm_moe_step", lambda: step(shard, tokens), axis_map(lm_mesh))


def _seq_ranks(ctx):
    import torch
    from distlearn_tpu_torch.lint.spmd import axis_map
    from distlearn_tpu_torch.parallel.sequence import (alltoall_attention,
                                                       ring_attention)
    n = WORLD
    mesh = _mesh(ctx, (n,), ("seq",))
    ax = mesh.axis("seq")
    B, L, H, D = 2, LM_SHARD_L * n, n, 32   # H divisible by n (Ulysses)
    sl = slice(ax.index * LM_SHARD_L, (ax.index + 1) * LM_SHARD_L)
    q, k, v = (_seeded((B, L, H, D), 20 + i)[:, sl].contiguous()
               .to(ctx.device) for i in range(3))
    axes = axis_map(mesh)

    def run(fn, **kw):
        def go():
            with torch.no_grad():
                return fn(q, k, v, ax, **kw)
        return go
    ctx.unit("ring_attention", run(ring_attention, causal=True), axes)
    ctx.unit("zigzag_ring_attention",
             run(ring_attention, causal=True, layout="zigzag"), axes)
    ctx.unit("ulysses_attention", run(alltoall_attention, causal=True),
             axes)


#: The decode family's engine: the JAX registry's slots and page, the LM
#: types' width, positions up to one flash bucket.
DECODE_MAX_LEN = 128


def _decode_ranks(ctx):
    import numpy as np
    from distlearn_tpu_torch.lint import spmd
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.serve.engine import DecodeEngine
    mesh = _mesh(ctx, (2,), ("model",), ranks=(0, 1))
    if not mesh.member:
        return
    model = transformer_lm(vocab=64, dim=LM_DIM, depth=2, heads=LM_HEADS,
                           max_len=DECODE_MAX_LEN)
    whole = model.init(0, device="cpu")[0]
    eng = DecodeEngine(whole, num_slots=4, page=8, mesh=mesh,
                       tp_axis="model", device=ctx.device)
    axes = spmd.axis_map(mesh, (eng._ctl, "model"))
    rng = np.random.default_rng(30)

    def prompt(n):
        return rng.integers(0, 64, n).astype(np.int32)
    if not eng.is_leader:
        # the follower replays every op the leader sends, one record for
        # the whole family; the parent holds it against the leader's
        ctx.results["tp_follow"] = measure(ctx.device, eng.follow, axes)
        return
    with spmd.record(axes) as whole_rec:
        for b in eng.buckets:
            def prefill(b=b):
                slot, _ = eng.admit(prompt(b - 1), 1)
                eng.finish(slot)
            ctx.unit(f"decode_prefill[{b}]", prefill, axes)
        for b in eng.buckets[:-1]:    # a first chunk of b needs plen > b
            def chunk(b=b):
                job = eng.begin(prompt(b + 1), 1)
                eng.prefill_step(job, chunk=b)
                eng.abort_prefill(job)
            ctx.unit(f"decode_chunk[{b}]", chunk, axes)
        slots = [eng.admit(prompt(n), 16)[0] for n in (5, 9, 12)]
        ctx.unit("decode_tick", eng.tick, axes)
        ctx.unit("decode_verify",
                 lambda: eng.verify({s: [1, 2, 3] for s in slots}), axes)
        for s in slots:
            eng.finish(s)
        eng.stop()
    ctx.results["tp_follow"] = {"rec": whole_rec, "peak": None,
                                "named": None, "launches": None}


# ---------------------------------------------------------------------------
# In-process families
# ---------------------------------------------------------------------------

def _wirek_family(device):
    """B3 (amax, then quantize with error feedback) and B4 (dequantize and
    apply) on a wire-stripe-shaped block: the JAX registry's 4 x 256 rows
    of 128 lanes, float32; no mesh, no collectives."""
    import torch
    from distlearn_tpu_torch.ops import wire_kernels as wk
    n = 4 * 256 * 128
    x = _seeded((n,), 40).to(device)
    c = _seeded((n,), 41).to(device)
    q = torch.randint(-127, 128, (n,), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(42)).to(device)
    return [("quant_ef", lambda: wk.quantize_ef_leaves_cuda([x])),
            ("dequant_add",
             lambda: wk.dequant_add_leaves_cuda([c], [q], [0.01])),
            ("wire_amax", lambda: wk.amax_leaves_cuda([x]))]


def _sync_family(device):
    """The stacked-rows backends of ``comm/backend.py`` over 8 rows: the
    MeshBackend allreduce (plain and masked) and the HybridBackend's two
    device phases (the local sum, each row's chunk of it; the return to
    every row), a matrix and a bias a row as in the JAX registry."""
    import torch
    from distlearn_tpu_torch.comm.backend import HybridBackend, MeshBackend
    mb = MeshBackend(num_nodes=8, device=device)
    val = {"b": _seeded((8, 64), 50).to(device),
           "w": _seeded((8, 128, 64), 51).to(device)}
    cvec = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32)
    hb = HybridBackend(0, 1, num_devices=8, device=device)
    leaves = [val["b"], val["w"]]
    plans = hb._groups(leaves)
    sums = hb._local_sums(leaves, None, plans)
    return [("sync_mesh_allreduce", lambda: mb.all_reduce(val)),
            ("sync_mesh_allreduce_masked",
             lambda: mb.all_reduce(val, contrib=cvec)),
            ("sync_hybrid_reduce_scatter",
             lambda: hb._local_sums(leaves, cvec.tolist(), plans)),
            ("sync_hybrid_all_gather",
             lambda: hb._back_to_rows(leaves, plans, sums))]


def _protocol_family(device=None):
    from distlearn_tpu_torch.lint.protocol import (async_ea_sync_schedule,
                                                   check_schedules,
                                                   lint_comm_protocols,
                                                   ring_allreduce_schedule,
                                                   tree_allreduce_schedule)
    units = [Unit("comm_protocols", lint_comm_protocols(num_nodes=7))]
    for n in (2, 3, 5, 8):
        units.append(Unit(f"tree[{n}]",
                          check_schedules(tree_allreduce_schedule(n),
                                          name=f"tree[{n}]")))
        units.append(Unit(f"ring[{n}]",
                          check_schedules(ring_allreduce_schedule(n),
                                          name=f"ring[{n}]")))
    units.append(Unit("async_ea[L=5]",
                      check_schedules(async_ea_sync_schedule(num_leaves=5),
                                      name="async_ea[L=5]")))
    return units


def _model_family(device=None):
    from distlearn_tpu_torch.lint.conformance import (lint_conformance,
                                                      lint_serve_frames)
    from distlearn_tpu_torch.lint.model import lint_models
    units = [Unit(spec.name, rep.findings, info=rep.info)
             for rep, spec in lint_models()]
    units.append(Unit("conformance", lint_conformance()))
    units.append(Unit("serve_frames", lint_serve_frames()))
    return units


def _races_family(device=None):
    from distlearn_tpu_torch.lint.races import (core_targets, fleet_targets,
                                                lint_races)
    return [Unit("lockset", lint_races(core_targets())),
            Unit("router", lint_races(fleet_targets()))]


def _decode_host(device=None):
    from distlearn_tpu_torch.lint.cost import lint_tick_loop
    return [Unit("tick_loop", lint_tick_loop())]


_FAMILIES = {
    "sgd": Entry("sgd", "fused AllReduceSGD steps (sgd/scan/sync/eval)",
                 ranks=_sgd_ranks),
    "ea": Entry("ea", "elastic-averaging steps (local/round/cycle)",
                ranks=_ea_ranks),
    "lm": Entry("lm", "3D-parallel LM train step", ranks=_lm_ranks),
    "lm_mixed": Entry("lm_mixed", "bf16-working/f32-master LM step",
                      ranks=_lm_mixed_ranks),
    "pp": Entry("pp", "pipeline-parallel LM steps (GPipe + 1F1B)",
                ranks=_pp_ranks),
    "optax": Entry("optax", "optax-backed data-parallel + ZeRO-sharded steps",
                   ranks=_optax_ranks),
    "ep": Entry("ep", "MoE expert-parallel steps (all-to-all dispatch)",
                ranks=_ep_ranks),
    "seq": Entry("seq", "sequence-parallel attention (ring/zigzag/ulysses)",
                 ranks=_seq_ranks),
    "decode": Entry("decode",
                    "serving decode programs (tp=2 leader and follower: "
                    "tick, every prefill and chunk bucket, verify)",
                    run=_decode_host, ranks=_decode_ranks),
    "wirek": Entry("wirek",
                   "fused wire-codec kernels (int8 quantize+EF / "
                   "dequantize+apply / amax)", run=_wirek_family),
    "sync": Entry("sync",
                  "collective-backend sync programs (mesh allreduce + "
                  "hybrid reduce-scatter/all-gather)", run=_sync_family),
    "protocol": Entry("protocol",
                      "host comm schedules (tree/ring/AsyncEA) + lock audit",
                      run=_protocol_family),
    "model": Entry("model",
                   "explicit-state protocol models (sync/sharded/replay/"
                   "failover/serve) + schedule↔code conformance",
                   run=_model_family),
    "races": Entry("races",
                   "static lockset race detection over the threaded modules",
                   run=_races_family),
}

#: Families whose units run (or measure) on the device.
DEVICE_FAMILIES = frozenset({"sgd", "ea", "lm", "lm_mixed", "pp", "optax",
                             "ep", "seq", "decode", "wirek", "sync"})


def families() -> dict[str, Entry]:
    return dict(_FAMILIES)


# ---------------------------------------------------------------------------
# The rank processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, store_path: str, names: list,
               device: str, out_dir: str) -> None:
    """One rank: every family's body in order, the results pickled to
    ``<out_dir>/rank<r>.pkl``."""
    import torch
    import torch.distributed as dist
    os.environ["DISTLEARN_TPU_ATTN"] = "flash"
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store_path, world))
    try:
        out = {}
        for name in names:
            ctx = RankCtx(rank, dev)
            _FAMILIES[name].ranks(ctx)
            out[name] = ctx.results
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(names: list, device: str, meanwhile) -> tuple[list[dict], object]:
    """Run the step families ``names`` on :data:`WORLD` gloo ranks, and
    ``meanwhile()`` here while they run; returns each rank's ``{family:
    {unit: measured}}`` and what ``meanwhile`` returned."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="distlint_") as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, WORLD, os.path.join(d, "store"),
                                   names, device, d))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            here = meanwhile()
        finally:
            for p in procs:
                p.join(RANK_TIMEOUT_S)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * WORLD:
            raise RuntimeError(f"distlint rank processes failed (exit codes "
                               f"{codes}) running {names}")
        out = []
        for r in range(WORLD):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out, here


def card_label() -> str:
    """``"<name>, <power limit>"`` of the card, as nvidia-smi reports it
    (the name alone when nvidia-smi is not there)."""
    import subprocess
    import torch
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def _unit(family: str, uname: str, got: dict, memory_device):
    """``(Unit, CostReport or None)`` of one unit from ``{rank:
    measured}``: the SPMD findings over every rank's record, the report
    and the card's figures of its first rank.  The tp engine's
    ``tp_follow`` pair carries DL002 and no report."""
    from distlearn_tpu_torch.lint import cost, spmd
    m = got[min(got)]
    findings = [f for g in got.values() for f in g.get("findings", ())]
    findings += spmd.lint_records({r: g["rec"] for r, g in got.items()},
                                  name=f"{family}:{uname}",
                                  draw_groups=m.get("draw_groups", ()))
    info = {"ranks": sorted(got), "calls": len(m["rec"].calls)}
    if m["launches"] is not None:
        info.update(launches=m["launches"], named=m["named"])
    if uname == "tp_follow":
        info["calls_by_rank"] = {r: len(g["rec"].calls)
                                 for r, g in got.items()}
        return Unit(uname, findings, info), None
    if m["peak"] is not None:
        info["peak_bytes"] = m["peak"]
    report = cost.report_from_record(
        uname, m["rec"].calls, peak=m["peak"],
        memory_device=memory_device if m["peak"] is not None else None)
    return Unit(uname, findings, info), report


def _assemble(family: str, per_rank: dict, memory_device):
    """``(units, reports)`` of one step family from ``{rank: {unit:
    measured}}``, the units in the first rank's order."""
    names: list[str] = []
    for res in per_rank.values():
        names += [n for n in res if n not in names]
    units, reports = [], {}
    for uname in names:
        unit, report = _unit(family, uname, {
            r: res[uname] for r, res in per_rank.items() if uname in res},
            memory_device)
        units.append(unit)
        if report is not None:
            reports[uname] = report
    return units, reports


def _in_process(family: str, device, memory_device):
    """``(units, reports)`` of an in-process family."""
    units, reports = [], {}
    for item in _FAMILIES[family].run(device):
        if isinstance(item, Unit):
            units.append(item)
            continue
        uname, run = item
        unit, reports[uname] = _unit(family, uname,
                                     {0: measure(device, run)},
                                     memory_device)
        units.append(unit)
    return units, reports


# Per (family, device): the built units and reports.  Everything a family
# analyses is fixed once the process has imported the package, so a
# second run in one process (the CLI's tests) reuses the first's.
_BUILD_CACHE: dict[tuple[str, str], tuple[list, dict]] = {}


def build(names: Sequence[str], device: str = "cuda") -> None:
    """Build (and cache) the families ``names`` on ``device``: the step
    families in one spawn of :data:`WORLD` ranks, the in-process ones here
    while the ranks run.  A device family asked for on the card where
    there is none raises; it never falls back to the CPU."""
    import torch
    dev = str(torch.device(device).type)
    todo = [n for n in names if (n, dev) not in _BUILD_CACHE]
    if not todo:
        return
    on_card = dev == "cuda" and any(n in DEVICE_FAMILIES for n in todo)
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"distlint: families {sorted(set(todo) & DEVICE_FAMILIES)} "
                "run on the card and none is available; pass --device cpu "
                "to lint on the CPU")
        from distlearn_tpu_torch.ops import _build
        _build.build_all()
    memory_device = card_label() if on_card else None
    here = torch.device("cuda", 0) if dev == "cuda" else torch.device("cpu")

    def in_process():
        return {n: _in_process(n, here, memory_device) for n in todo
                if _FAMILIES[n].run is not None}
    rank_names = [n for n in todo if _FAMILIES[n].ranks is not None]
    if rank_names:
        ranks, local = _spawn(rank_names, dev, in_process)
    else:
        ranks, local = [], in_process()
    for n in todo:
        units, reports = [], {}
        if n in rank_names:
            units, reports = _assemble(
                n, {r: res[n] for r, res in enumerate(ranks) if res.get(n)},
                memory_device)
        if n in local:
            lu, lr = local[n]
            units, reports = units + lu, {**reports, **lr}
        _BUILD_CACHE[(n, dev)] = (
            [(u.name, u.findings, u.info) for u in units], reports)


def run_families_costed(names: Sequence[str], *, device: str = "cuda",
                        suppress: Sequence[str] = (), cost: bool = True,
                        budget_dir: str | None = None):
    """Lint every family in ``names``: ``(results, {family: reports})``,
    one :class:`LintResult` a unit plus a ``<family>:budget`` result where
    the lockfile comparison finds anything."""
    import torch
    build(names, device)
    dev = str(torch.device(device).type)
    results, all_reports = [], {}
    for name in names:
        per_unit, reports = _BUILD_CACHE[(name, dev)]
        for uname, findings, info in per_unit:
            results.append(LintResult(
                f"{name}:{uname}", filter_suppressed(list(findings),
                                                     suppress),
                info=dict(info)))
        if cost:
            from distlearn_tpu_torch.lint import budget as budget_mod
            bfindings = filter_suppressed(
                budget_mod.check_family(name, reports,
                                        budget_dir=budget_dir), suppress)
            if bfindings:
                results.append(LintResult(f"{name}:budget", bfindings))
        all_reports[name] = reports
    return results, all_reports


def run_family_costed(name: str, *, device: str = "cuda",
                      suppress: Sequence[str] = (), cost: bool = True,
                      budget_dir: str | None = None):
    """:func:`run_families_costed` of one family: ``(results, reports)``."""
    results, reports = run_families_costed(
        [name], device=device, suppress=suppress, cost=cost,
        budget_dir=budget_dir)
    return results, reports[name]


def run_family(name: str, *, device: str = "cuda",
               suppress: Sequence[str] = (),
               cost: bool = True) -> list[LintResult]:
    return run_family_costed(name, device=device, suppress=suppress,
                             cost=cost)[0]


def run_all(*, device: str = "cuda", suppress: Sequence[str] = (),
            cost: bool = True) -> list[LintResult]:
    return run_families_costed(list(_FAMILIES), device=device,
                               suppress=suppress, cost=cost)[0]
