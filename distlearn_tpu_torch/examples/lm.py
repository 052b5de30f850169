"""Train the transformer LM with data parallelism, then serve it with
continuous batching — the JAX package's ``examples/lm.py`` with the same
flag names (``--tpu`` becomes ``--device``, the card by default).

    python -m distlearn_tpu_torch.examples.lm --steps 30 --bf16 \\
        --attnImpl flash --seqLen 256
    python -m distlearn_tpu_torch.examples.lm --steps 0 --serve 4 \\
        --servePort 9123
    python -m distlearn_tpu_torch.examples.lm_client --port 9123

``--steps N`` trains N steps (``train/lm.py``: ``--mixed`` for
bfloat16 working params with float32 masters, ``--remat``/``--rematMode``,
``--accumSteps``) on the JAX example's synthetic order-2 Markov corpus,
over a ``(data, seq, model)`` mesh of ``--dp`` x ``--sp`` x ``--tp`` ranks
(``parallel/mesh.py``): sequence parallelism by ``--seqImpl ring|alltoall``
and ``--seqLayout contig|zigzag``, Megatron tensor parallelism, and MoE
blocks (``--moeExperts`` = ``--dp``, one expert a data rank;
``--moeTopK``, ``--moeBalanceWeight``).  One process a rank over NCCL,
one card each (``cuda:<rank>``), or gloo with ``--device cpu``; rank 0
runs in this process, the others are spawned.  ``--generate`` then runs
on rank 0 with the trained params gathered from the shards, and
``--serve`` there too, or with ``--tp > 1`` tensor-parallel over the
``model`` line of ranks ``0..tp-1`` (``DecodeEngine(mesh=, tp_axis=)``:
rank 0 leads and serves, the others follow), as the JAX example serves
over a ``("model",)`` submesh (``--steps 0``: the seeded initialisation;
not after ``--pp/--zero/--fsdp``).  ``--pp S``
trains over a ``(data, pipe)`` mesh of ``--dp`` x ``S`` ranks instead,
GPipe or 1F1B (``--ppSchedule``, ``--microbatches``); ``--optimizer
adam|adamw`` runs the replicated-state optimizer step (with ``--mixed``
over float32 masters), ``--zero`` Adam under ZeRO-1 over the mesh,
``--fsdp`` the fully-sharded step (``train/optim.py``); the JAX example's
flag checks hold.  SIGTERM or Ctrl-C drains the in-flight requests, then
exits.

    python -m distlearn_tpu_torch.examples.lm --device cpu --dp 2 --sp 2 \
        --moeExperts 2 --steps 3 --dim 64 --depth 2 --seqLen 64
    python -m distlearn_tpu_torch.examples.lm --device cpu --pp 2 \
        --ppSchedule 1f1b --steps 3 --dim 64 --depth 2 --seqLen 64
    python -m distlearn_tpu_torch.examples.lm --device cpu --steps 0 \
        --serve 2 --tp 2 --dim 64 --depth 2 --seqLen 64
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys

import numpy as np
import torch

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.models.transformer import (greedy_generate,
                                                    transformer_lm)
from distlearn_tpu_torch.obs import trace as obs_trace
from distlearn_tpu_torch.serve import DecodeEngine, ServeServer
from distlearn_tpu_torch.utils.flags import parse_flags
from distlearn_tpu_torch.utils.logging import print_server, root_print
from distlearn_tpu_torch.utils.platform import rank_device, resolve_device

#: ``--optimizer``'s choices besides sgd (``train/optim.py``)
OPTIMIZERS = ("adam", "adamw")

FLAGS = {
    "dp": (1, "data-parallel axis size"),
    "sp": (1, "sequence-parallel axis size"),
    "tp": (1, "tensor-parallel axis size (Megatron)"),
    "pp": (0, "pipeline-parallel stages (depth/pp blocks per stage; "
              "requires --sp 1 --tp 1 and --depth % --pp == 0)"),
    "ppSchedule": ("gpipe", "pipeline schedule: gpipe | 1f1b (1f1b starts "
                            "each microbatch's backward as it leaves the "
                            "last stage: O(stages) activation liveness)"),
    "microbatches": (4, "pipeline microbatches per step (with --pp)"),
    "dim": (128, "model width"),
    "depth": (4, "number of blocks"),
    "vocab": (256, "vocabulary size"),
    "seqLen": (128, "sequence length (the model's max_len)"),
    "batchSize": (8, "global batch size (split over the --dp axis)"),
    "steps": (0, "training steps (0 = serve or decode the initialised "
                 "model)"),
    "learningRate": (0.1, "SGD learning rate"),
    "seqImpl": ("ring", "sequence attention with --sp > 1: ring | "
                        "alltoall (Ulysses)"),
    "seqLayout": ("contig", "sequence shard layout: contig | zigzag "
                            "(balanced causal ring)"),
    "attnImpl": ("", "attention kernel of training and --generate: '' "
                     "(env default) | xla | flash | chunked; the engine "
                     "follows DISTLEARN_TPU_ATTN"),
    "scanBlocks": (False, "scanned-depth layout: block params stacked"),
    "moeExperts": (0, "experts per MoE block (every 2nd block; must equal "
                      "--dp: one expert a data rank)"),
    "moeTopK": (1, "experts per token (1 = Switch, 2 = GShard)"),
    "moeBalanceWeight": (0.01, "weight of the Switch balance loss"),
    "remat": (False, "recompute each block in the backward pass (same "
                     "as --rematMode full)"),
    "rematMode": ("", "'' | full | mlp — mlp recomputes only the FFN half, "
                      "keeping the attention residuals saved"),
    "zero": (False, "train with Adam under ZeRO-1: optimizer state + f32 "
                    "masters sharded over the data axis, composed with the "
                    "sp/tp axes (train.build_lm_zero_mesh_step; dense "
                    "models only)"),
    "mixed": (False, "bf16 working params + f32 masters "
                     "(train.build_lm_mixed_step / "
                     "build_lm_mixed_optax_step; not with --pp/--zero)"),
    "fsdp": (False, "fully-sharded data parallelism: params live sharded "
                    "1/dp a rank, each leaf gathered before use "
                    "(train.build_lm_fsdp_step; needs --sp 1 --tp 1, sgd, "
                    "dense)"),
    "generate": (0, "after training, greedy-decode this many tokens from "
                    "held-out prompts with the KV-cached decoder "
                    "(models.greedy_generate)"),
    "serve": (0, "after training, serve the model with this many "
                 "continuous-batching decode slots ('G'/'R' frames; drive "
                 "with distlearn_tpu_torch.examples.lm_client)"),
    "servePort": (0, "serving port (0 = ephemeral, printed at startup)"),
    "optimizer": ("sgd", "sgd | adam | adamw — non-sgd runs the "
                         "replicated-state optimizer step "
                         "(train.build_lm_optax_step; needs --tp 1)"),
    "accumSteps": (1, "gradient-accumulation microbatches per step "
                      "(memory lever; effective batch unchanged)"),
    "profile": ("", "torch.profiler trace of steps 6..10 into this "
                    "directory (trace.json)"),
    "bf16": (False, "bfloat16 compute"),
    "device": ("cuda", "torch device (replaces --tpu); 'cpu' only when "
                       "asked for"),
    "seed": (0, "init seed"),
    "obsLog": ("", "telemetry JSONL path: spans spill live, one registry "
                   "snapshot on exit (empty = off)"),
    "obsPort": (0, "serve /metrics + /healthz on 127.0.0.1:PORT (0 = off)"),
    "obsTrace": (0, "1 = stamp trace context onto outgoing wire frames"),
}


def parse(argv=None):
    opt = parse_flags("Train a transformer LM over a (data, seq, model) "
                      "mesh, then serve it with continuous batching.", FLAGS,
                      argv)
    remat = opt.rematMode or ("full" if opt.remat else False)
    if opt.seqLayout not in ("contig", "zigzag"):
        raise SystemExit(f"--seqLayout {opt.seqLayout!r}: contig | zigzag")
    if opt.seqLayout == "zigzag":
        if opt.seqImpl != "ring":
            raise SystemExit("--seqLayout zigzag needs --seqImpl ring")
        if opt.pp or opt.zero:
            raise SystemExit("--seqLayout zigzag composes with the fused "
                             "sgd/optax steps (not --pp/--zero)")
    if opt.seqImpl not in ("ring", "alltoall"):
        raise SystemExit(f"--seqImpl {opt.seqImpl!r}: ring | alltoall")
    if opt.scanBlocks and (opt.moeExperts or opt.pp):
        raise SystemExit("--scanBlocks needs a homogeneous dense stack "
                         "and the non-pp step (pipeline stages shard the "
                         "per-block layout)")
    if opt.ppSchedule not in ("gpipe", "1f1b"):
        raise SystemExit(f"--ppSchedule {opt.ppSchedule!r}: gpipe | 1f1b")
    if opt.mixed and (opt.pp or opt.zero):
        raise SystemExit("--mixed composes with the fused sgd/optax steps "
                         "(--pp stages and --zero shards manage their own "
                         "parameter layouts)")
    if opt.fsdp and (opt.sp != 1 or opt.tp != 1 or opt.pp or opt.zero
                     or opt.mixed or opt.moeExperts
                     or opt.optimizer != "sgd"):
        raise SystemExit("--fsdp shards the whole model over the data "
                         "axis: pass --sp 1 --tp 1 and no "
                         "--pp/--zero/--mixed/--moeExperts/--optimizer")
    if opt.pp:
        if opt.sp != 1 or opt.tp != 1:
            raise SystemExit("--pp composes with data parallelism only: "
                             "pass --sp 1 --tp 1 (PP and TP/SP cover "
                             "different model regimes)")
        if opt.depth % opt.pp:
            raise SystemExit(f"--pp {opt.pp} needs --depth divisible by "
                             f"{opt.pp} (equal blocks per stage)")
        if (opt.accumSteps != 1 or opt.moeExperts or opt.zero
                or opt.optimizer != "sgd"):
            raise SystemExit("--pp does not support --accumSteps/"
                             "--moeExperts/--zero/--optimizer (GPipe "
                             "microbatching IS the accumulation lever on "
                             "this path; MoE/ZeRO/optax need the non-pp "
                             "step)")
        if remat == "mlp":
            raise SystemExit("--rematMode mlp is the non-pp step's "
                             "selective mode; the pipeline stage fn "
                             "checkpoints whole blocks — use --remat "
                             "(full) with --pp")
    if opt.serve and (opt.pp or opt.zero or opt.fsdp):
        raise SystemExit("--serve needs a single-replica param layout "
                         "(not --pp/--zero/--fsdp)")
    if opt.generate and (opt.pp or opt.zero or opt.fsdp):
        raise SystemExit("--generate needs a single-replica param "
                         "layout (not --pp/--zero/--fsdp)")
    if opt.moeExperts and opt.moeExperts != opt.dp:
        raise SystemExit(f"--moeExperts {opt.moeExperts} must equal --dp "
                         f"{opt.dp} (one expert per data-parallel device)")
    if opt.zero and (opt.moeExperts or opt.accumSteps != 1
                     or opt.optimizer != "sgd"):
        raise SystemExit("--zero supports dense models without "
                         "--accumSteps/--moeExperts, and picks its "
                         "own optimizer (Adam against the sharded "
                         "f32 masters) — drop --optimizer")
    if not opt.zero and opt.optimizer != "sgd":
        if opt.tp != 1 or opt.moeExperts:
            raise SystemExit(f"--optimizer {opt.optimizer} uses the "
                             "replicated-state optax step: pass --tp 1 "
                             "(TP needs --zero's sharded masters) and "
                             "no --moeExperts (expert-sharded state)")
        if opt.optimizer not in OPTIMIZERS:
            raise SystemExit(f"unknown --optimizer {opt.optimizer!r} "
                             f"(sgd | {' | '.join(OPTIMIZERS)})")
    if opt.rematMode not in ("", "full", "mlp"):
        raise SystemExit(f"--rematMode {opt.rematMode!r}: '' | full | mlp")
    if (opt.serve or opt.generate) and opt.moeExperts:
        raise SystemExit("--serve/--generate support dense models (per-tick "
                         "MoE routing would not match the trained capacity "
                         "math)")
    if opt.generate and opt.seqLayout == "zigzag":
        raise SystemExit("--generate decodes in natural order — drop "
                         "--seqLayout zigzag")
    if min(opt.dp, opt.sp, opt.tp) < 1 or opt.pp < 0 \
            or opt.batchSize % opt.dp:
        raise SystemExit(f"--batchSize {opt.batchSize} must split evenly "
                         f"over --dp {opt.dp} ranks")
    return opt


def install_signal_flush(srv, signums=(signal.SIGTERM,)) -> None:
    """On each of ``signums``, drain ``srv`` (``srv.checkpoint_now``), then
    deliver the signal's prior disposition: a chained Python handler runs,
    a default one is re-raised so the exit code stays honest.  A small copy
    of the JAX package's ``parallel/ha.py::install_signal_flush``.  Call
    from the main thread."""
    for signum in signums:
        prev = signal.getsignal(signum)

        def _flush(num, frame, _prev=prev):
            try:
                srv.checkpoint_now(wait=True)
            except Exception as e:  # noqa: BLE001 — dying anyway
                print_server(f"final drain failed: {e!r}")
            if callable(_prev):
                _prev(num, frame)
            elif _prev is not signal.SIG_IGN:
                signal.signal(num, signal.SIG_DFL)
                os.kill(os.getpid(), num)

        signal.signal(signum, _flush)


def _compute_dtype(opt):
    return torch.bfloat16 if opt.bf16 else None


def _model(opt):
    """The flags' :func:`transformer_lm` (the JAX example's head count)."""
    return transformer_lm(vocab=opt.vocab, dim=opt.dim, depth=opt.depth,
                          heads=max(4, opt.dim // 64), max_len=opt.seqLen,
                          compute_dtype=_compute_dtype(opt),
                          seq_impl=opt.seqImpl,
                          remat=opt.rematMode or bool(opt.remat),
                          attn_impl=opt.attnImpl or None,
                          scan_blocks=opt.scanBlocks,
                          moe_experts=opt.moeExperts,
                          moe_top_k=opt.moeTopK)


def _ranks(opt) -> int:
    return opt.dp * (opt.pp or opt.sp * opt.tp)


def _init(lm, opt, device):
    return lm.init(torch.Generator().manual_seed(opt.seed), device=device)[0]


def build_model(opt):
    """``(params, compute_dtype)``: the seeded initialisation on
    ``opt.device``."""
    return _init(_model(opt), opt, opt.device), _compute_dtype(opt)


def _engine(opt, params, compute_dtype, mesh):
    """The decode engine: one rank's, or over ``mesh``'s ``model`` axis."""
    if mesh is None:
        return DecodeEngine(params, num_slots=opt.serve,
                            compute_dtype=compute_dtype, device=opt.device)
    return DecodeEngine(params, num_slots=opt.serve,
                        compute_dtype=compute_dtype, mesh=mesh,
                        tp_axis="model")


def start_server(opt, params, compute_dtype=None, mesh=None, **server_kw):
    """The engine (tensor-parallel over ``mesh``'s ``model`` axis when
    given: this rank leads) warmed up (one smallest-bucket prefill and one
    tick, as the JAX example does) behind a started :class:`ServeServer`."""
    engine = _engine(opt, params, compute_dtype, mesh)
    slot, _ = engine.admit(np.ones(4, np.int32), 2)
    engine.tick()
    engine.finish(slot)
    return ServeServer(engine, port=opt.servePort, **server_kw).start()


def _follow(opt, params, compute_dtype, mesh) -> None:
    """A follower rank of the tensor-parallel engine: replay the leader's
    ops (its warm-up included) until the server stops."""
    engine = _engine(opt, params, compute_dtype, mesh)
    done = engine.follow()
    print(f"[rank {mesh.axis_index('model')}] follower stopped after "
          f"{done} engine ops", flush=True)


def _corpus(opt) -> np.ndarray:
    """The JAX example's synthetic order-2 Markov tokens."""
    rng = np.random.RandomState(opt.seed)
    trans = rng.dirichlet(np.ones(opt.vocab) * 0.05,
                          size=opt.vocab).astype(np.float64)
    toks = np.zeros((opt.batchSize, opt.seqLen), np.int32)
    toks[:, 0] = rng.randint(0, opt.vocab, opt.batchSize)
    for t in range(1, opt.seqLen):
        for b in range(opt.batchSize):
            toks[b, t] = rng.choice(opt.vocab, p=trans[toks[b, t - 1]])
    return toks


def _build_step(opt, lm, mesh, whole, log):
    """``(step, state, moe_metrics)`` for the flags: ``step(state, tokens)
    -> (state, loss)`` on this rank's shard of ``whole``."""
    from distlearn_tpu_torch.models.convert import lm_pp_shard, lm_shard
    from distlearn_tpu_torch.train import lm as tlm
    from distlearn_tpu_torch.train import optim
    if opt.pp:
        builder = (tlm.build_lm_pp_1f1b_step if opt.ppSchedule == "1f1b"
                   else tlm.build_lm_pp_step)
        pp_step = builder(mesh, *tlm.stack_blocks(whole, opt.depth),
                          lr=opt.learningRate,
                          num_microbatches=opt.microbatches,
                          compute_dtype=_compute_dtype(opt),
                          remat=bool(opt.rematMode or opt.remat),
                          attn_impl=opt.attnImpl or None)

        def step(st, tokens):
            shared, stacked, loss = pp_step(*st, tokens)
            return (shared, stacked), loss
        log(f"pipeline {opt.ppSchedule}: {opt.depth // opt.pp} blocks a "
            f"stage, {opt.microbatches} microbatches")
        return step, lm_pp_shard(whole, mesh, opt.depth), None
    ep_axis = "data" if opt.moeExperts else None
    axes = dict(seq_axis="seq", tp_axis="model", ep_axis=ep_axis)
    params = lm_shard(whole, mesh, "model", ep_axis)
    kw = dict(axes, accum_steps=opt.accumSteps,
              moe_balance_weight=(opt.moeBalanceWeight
                                  if opt.moeExperts else 0.0),
              seq_layout=opt.seqLayout)
    moe_metrics = tlm.build_lm_moe_metrics(lm, mesh, **axes) \
        if opt.moeExperts else None
    if opt.zero:
        if opt.learningRate > 0.01:
            log(f"NOTE: --learningRate {opt.learningRate} is large for "
                "Adam; --zero usually wants ~1e-3 (large Adam steps "
                "diverge)")
        tx = optim.adam(opt.learningRate)
        log("ZeRO-1: Adam state + f32 masters sharded over the data axis "
            "(composed with sp/tp)")
        return (optim.build_lm_zero_mesh_step(lm, mesh, tx, seq_axis="seq",
                                              tp_axis="model"),
                optim.init_lm_zero_mesh_state(params, mesh, tx,
                                              tp_axis="model"), None)
    if opt.optimizer != "sgd":
        tx = getattr(optim, opt.optimizer)(opt.learningRate)
        kw = {k: v for k, v in kw.items() if k not in ("tp_axis", "ep_axis")}
        if opt.mixed:
            log(f"{opt.optimizer}, mixed precision: bf16 working params + "
                "f32 masters")
            return (optim.build_lm_mixed_optax_step(lm, mesh, tx, **kw),
                    optim.init_lm_mixed_optax_state(params, tx), moe_metrics)
        log(f"{opt.optimizer} via the replicated-state optimizer LM step")
        return (optim.build_lm_optax_step(lm, mesh, tx, **kw),
                optim.LMOptaxState(params, tx.init(params)), moe_metrics)
    if opt.fsdp:
        log("FSDP: params live sharded 1/dp a rank; each leaf gathered "
            "before use, its gradient reduce-scattered")
        return (optim.build_lm_fsdp_step(lm, mesh, whole,
                                         lr=opt.learningRate,
                                         accum_steps=opt.accumSteps),
                optim.init_lm_fsdp_params(whole, mesh), None)
    if opt.mixed:
        log("mixed precision: bf16 working params + f32 masters")
        return (tlm.build_lm_mixed_step(lm, mesh, lr=opt.learningRate, **kw),
                tlm.init_lm_mixed_state(params), moe_metrics)
    return (tlm.build_lm_step(lm, mesh, lr=opt.learningRate, **kw), params,
            moe_metrics)


def train(opt, rank: int = 0, init_method: str | None = None):
    """``opt.steps`` steps of this rank of the ``(dp, sp, tp)`` mesh (``(dp,
    pp)`` with ``--pp``) on its block of the corpus; returns ``(params,
    compute_dtype, corpus, mesh)`` with the trained params gathered whole
    (the working copy under ``--mixed``; None where neither
    ``--generate`` nor ``--serve`` asks for them).  The mesh's process
    group starts here; the caller destroys it
    (``torch.distributed.destroy_process_group``) when done with the mesh,
    which serves under ``--tp > 1``."""
    import torch.distributed as dist

    from distlearn_tpu_torch.models.convert import lm_from_jax, lm_gather
    from distlearn_tpu_torch.parallel.mesh import (init_named_mesh,
                                                   local_init_method)
    from distlearn_tpu_torch.utils.profiling import StepTimer, trace

    log = root_print(rank)
    device = rank_device(torch.device(opt.device), rank)
    shape, names = ((opt.dp, opt.pp), ("data", "pipe")) if opt.pp else \
        ((opt.dp, opt.sp, opt.tp), ("data", "seq", "model"))
    mesh = init_named_mesh(shape, names, rank=rank, device=device,
                           init_method=init_method or local_init_method())
    try:
        lm = _model(opt)
        step, params, moe_metrics = _build_step(opt, lm, mesh,
                                                _init(lm, opt, "cpu"), log)
        if opt.pp:
            log(f"mesh dp={opt.dp} pipe={opt.pp} ({mesh.backend} on "
                f"{mesh.device}); remat "
                f"{'full' if opt.rematMode or opt.remat else 'off'}, "
                f"attention {opt.attnImpl or 'env default'}")
        else:
            log(f"mesh dp={opt.dp} sp={opt.sp} tp={opt.tp} ({mesh.backend} "
                f"on {mesh.device}); seq_impl={opt.seqImpl}"
                + (f"; {opt.moeExperts} experts, top-{opt.moeTopK}"
                   if opt.moeExperts else "")
                + f"; remat "
                f"{opt.rematMode or ('full' if opt.remat else 'off')}, "
                f"attention {opt.attnImpl or 'env default'}")
        if opt.attnImpl and opt.sp > 1 and opt.seqImpl == "ring":
            log(f"NOTE: --attnImpl {opt.attnImpl} is inert with --sp "
                f"{opt.sp} > 1 on the ring — its blockwise path takes over")
        corpus = _corpus(opt)
        toks = corpus
        if opt.seqLayout == "zigzag":
            from distlearn_tpu_torch.parallel.sequence import zigzag_indices
            toks = corpus[:, zigzag_indices(opt.sp, opt.seqLen)]
            log("zigzag sequence layout: balanced causal ring (masked "
                "blocks never computed)")
        d = mesh.axis("data")
        q = None if opt.pp else mesh.axis("seq")
        rows = opt.batchSize // d.size
        cols = opt.seqLen if q is None else opt.seqLen // q.size
        qi = 0 if q is None else q.index
        tokens = torch.from_numpy(np.ascontiguousarray(
            toks[d.index * rows:(d.index + 1) * rows,
                 qi * cols:(qi + 1) * cols])).to(mesh.device)
        timer = StepTimer()
        do_profile = bool(opt.profile) and opt.steps >= 6 and rank == 0
        if opt.profile and opt.steps < 6:
            log(f"--profile ignored: needs --steps >= 6 (warmup is steps "
                f"1-5), got {opt.steps}")
        sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
            else (lambda: None)
        with contextlib.ExitStack() as stack:   # stops the trace on error
            for i in range(1, opt.steps + 1):
                if do_profile and i == 6:
                    sync()
                    timer.reset_window()
                    stack.enter_context(trace(opt.profile, mesh.device))
                timer.tick()
                params, loss = step(params, tokens)
                if do_profile and i == min(10, opt.steps):
                    sync()
                    timer.reset_window()
                    stack.close()
                    log(f"profiler trace written to {opt.profile}")
                if i % 10 == 0 or i == opt.steps:
                    extra = ""
                    if moe_metrics is not None:
                        m = moe_metrics(getattr(params, "params", params),
                                        tokens)
                        extra = (f" [router balance "
                                 f"{float(m['moe_balance_loss']):.3f}, "
                                 f"dropped "
                                 f"{float(m['moe_dropped_frac']):.3f}]")
                    log(f"step {i}: loss {float(loss):.4f}{extra} "
                        f"({timer.steps_per_sec():.2f} steps/s)")
        sync()
        whole = None
        if opt.generate or opt.serve:
            ep_axis = "data" if opt.moeExperts else None
            whole = lm_from_jax(lm_gather(getattr(params, "params", params),
                                          mesh, "model", ep_axis),
                                device=mesh.device)
    except BaseException:
        dist.destroy_process_group()
        raise
    return whole, _compute_dtype(opt), corpus, mesh


def _rank_main(index: int, opt, init_method: str, first: int = 0) -> None:
    """Rank ``first + index`` of the mesh: trains, then rank 0 generates,
    and rank 0 serves (with ``--tp > 1`` the ``model`` line of ranks
    ``0..tp-1`` does, rank 0 leading)."""
    import torch.distributed as dist
    rank = first + index
    params, cd, corpus, mesh = train(opt, rank, init_method)
    try:
        if rank == 0 or opt.serve and opt.tp > 1:
            _after_training(opt, params, cd, corpus, mesh)
    finally:
        dist.destroy_process_group()


def _serving_line(opt, mesh) -> bool:
    """This rank is on the ``model`` line that serves under ``--tp > 1``
    (data and seq index 0)."""
    return mesh is not None and opt.tp > 1 and \
        mesh.axis_index("data") == 0 and mesh.axis_index("seq") == 0


def _after_training(opt, params, cd, corpus, mesh=None) -> None:
    """``--generate`` on rank 0 and ``--serve`` on the whole ``params``:
    on rank 0, or with ``--tp > 1`` tensor-parallel over ``mesh``'s
    ``model`` line through data and seq index 0."""
    if _serving_line(opt, mesh):
        rank = mesh.axis_index("model")
        if rank != 0:
            _follow(opt, params, cd, mesh)
            return
    elif mesh is not None and opt.tp > 1:
        return                       # not on the serving line
    log = root_print(0)
    if opt.generate:
        Pq = max(4, opt.seqLen // 8)
        steps = min(opt.generate, opt.seqLen - Pq)
        # two prompts of different lengths, left-padded to Pq
        plens = np.array([Pq, max(2, Pq // 2)], np.int32)
        prompts = np.zeros((2, Pq), np.int32)
        for b, L in enumerate(plens):
            prompts[b, Pq - L:] = corpus[b % corpus.shape[0], :L]
        gen = greedy_generate(params, prompts, steps, compute_dtype=cd,
                              attn_impl=opt.attnImpl or None,
                              prompt_lens=plens).cpu().numpy()
        for b, L in enumerate(plens):
            log(f"generated {gen.shape[1]} tokens (KV-cached greedy, "
                f"prompt len {L}): {gen[b].tolist()}")
    if opt.serve:
        srv = start_server(opt, params, cd, mesh=mesh
                           if _serving_line(opt, mesh) else None)
        install_signal_flush(srv)
        log(f"serving on {srv.host}:{srv.port} ({opt.serve} slots, max_len "
            f"{srv.engine.max_len}, {srv.engine.device}"
            + (f", tp={opt.tp}" if opt.tp > 1 else "") + ") — drive with: "
            f"python -m distlearn_tpu_torch.examples.lm_client --port "
            f"{srv.port}")
        try:
            while srv._thread is not None and srv._thread.is_alive():
                srv._thread.join(0.5)
        except KeyboardInterrupt:
            log("draining...")
            srv.checkpoint_now(wait=True)
        srv.stop()
        log("serve drained")


def main(argv=None) -> int:
    opt = parse(argv)
    log = root_print(0)
    if opt.obsTrace:
        obs_trace.set_propagate(True)
    if opt.obsLog:
        obs.set_spill(opt.obsLog)
    http = obs.start_http_server(opt.obsPort) if opt.obsPort else None
    if _ranks(opt) > 1 and (opt.steps > 0 or opt.serve and opt.tp > 1):
        import torch.multiprocessing as mp

        from distlearn_tpu_torch.parallel.mesh import local_init_method
        from distlearn_tpu_torch.utils.platform import available_nodes
        device = resolve_device(opt.device)   # no card, no --device cpu: raise
        avail = available_nodes(device)
        if avail is not None and avail < _ranks(opt):
            raise SystemExit(f"need {_ranks(opt)} devices (dp*sp*tp*pp), "
                             f"have {avail}")
        init = local_init_method()
        # rank 0 here (it serves, and takes SIGTERM/Ctrl-C), the rest
        # spawned
        others = mp.start_processes(_rank_main, args=(opt, init, 1),
                                    nprocs=_ranks(opt) - 1, join=False,
                                    start_method="spawn")
        _rank_main(0, opt, init)
        while not others.join():
            pass
    else:
        if opt.steps > 0:
            import torch.distributed as dist
            params, cd, corpus, _ = train(opt)
            dist.destroy_process_group()
        else:
            params, cd = build_model(opt)
            corpus = _corpus(opt) if opt.generate else None
        _after_training(opt, params, cd, corpus)
    if opt.obsLog:
        obs.write_snapshot(opt.obsLog)
        obs.set_spill(None)
    if http is not None:
        http.close()
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
