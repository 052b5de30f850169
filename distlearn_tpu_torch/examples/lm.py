"""Train the transformer LM with data parallelism, then serve it with
continuous batching — the JAX package's ``examples/lm.py`` with the same
flag names (``--tpu`` becomes ``--device``, the card by default).

    python -m distlearn_tpu_torch.examples.lm --steps 30 --bf16 \\
        --attnImpl flash --seqLen 256
    python -m distlearn_tpu_torch.examples.lm --steps 0 --serve 4 \\
        --servePort 9123
    python -m distlearn_tpu_torch.examples.lm_client --port 9123

``--steps N`` trains N SGD steps (``train/lm.py``: ``--mixed`` for
bfloat16 working params with float32 masters, ``--remat``/``--rematMode``,
``--accumSteps``) on the JAX example's synthetic order-2 Markov corpus,
over a ``(data, seq, model)`` mesh of ``--dp`` x ``--sp`` x ``--tp`` ranks
(``parallel/mesh.py``): sequence parallelism by ``--seqImpl ring|alltoall``
and ``--seqLayout contig|zigzag``, Megatron tensor parallelism, and MoE
blocks (``--moeExperts`` = ``--dp``, one expert a data rank;
``--moeTopK``, ``--moeBalanceWeight``).  One process a rank over NCCL,
one card each (``cuda:<rank>``), or gloo with ``--device cpu``; one rank
runs in this process.  ``--generate`` and ``--serve`` then run on rank 0
with the trained params gathered from the shards (``--steps 0``: the
seeded initialisation).  Pipeline parallelism (``--pp``), ZeRO, FSDP and
the LM's optax optimizers wait for ROADMAP A11, so those flags only accept
their defaults here.  SIGTERM or Ctrl-C drains the in-flight requests,
then exits.

    python -m distlearn_tpu_torch.examples.lm --device cpu --dp 2 --sp 2 \
        --moeExperts 2 --steps 3 --dim 64 --depth 2 --seqLen 64
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

_A11 = "waits for ROADMAP A11 (the pipeline-parallel LM, ZeRO, FSDP and " \
    "the LM's optax optimizers)"

FLAGS = {
    "dp": (1, "data-parallel axis size"),
    "sp": (1, "sequence-parallel axis size"),
    "tp": (1, "tensor-parallel axis size (Megatron)"),
    "pp": (0, "pipeline-parallel stages (ROADMAP A11)"),
    "ppSchedule": ("gpipe", "pipeline schedule (ROADMAP A11)"),
    "microbatches": (4, "pipeline microbatches (ROADMAP A11)"),
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
    "zero": (False, "ZeRO-1 training (ROADMAP A11)"),
    "mixed": (False, "bf16 working params + f32 masters "
                     "(train.build_lm_mixed_step)"),
    "fsdp": (False, "fully-sharded data parallelism (ROADMAP A11)"),
    "generate": (0, "after training, greedy-decode this many tokens from "
                    "held-out prompts with the KV-cached decoder "
                    "(models.greedy_generate)"),
    "serve": (0, "after training, serve the model with this many "
                 "continuous-batching decode slots ('G'/'R' frames; drive "
                 "with distlearn_tpu_torch.examples.lm_client)"),
    "servePort": (0, "serving port (0 = ephemeral, printed at startup)"),
    "optimizer": ("sgd", "sgd only (the LM's adam/adamw: ROADMAP A11)"),
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
    for name in ("pp", "zero", "fsdp"):
        if getattr(opt, name):
            raise SystemExit(f"--{name}: {_A11}")
    if opt.optimizer != "sgd":
        raise SystemExit(f"--optimizer {opt.optimizer}: the optax LM steps "
                         f"wait for ROADMAP A11; pass sgd")
    if opt.seqLayout not in ("contig", "zigzag"):
        raise SystemExit(f"--seqLayout {opt.seqLayout!r}: contig | zigzag")
    if opt.seqLayout == "zigzag" and opt.seqImpl != "ring":
        raise SystemExit("--seqLayout zigzag needs --seqImpl ring")
    if opt.seqImpl not in ("ring", "alltoall"):
        raise SystemExit(f"--seqImpl {opt.seqImpl!r}: ring | alltoall")
    if opt.scanBlocks and opt.moeExperts:
        raise SystemExit("--scanBlocks needs a homogeneous dense stack "
                         "and the non-pp step (pipeline stages shard the "
                         "per-block layout)")
    if opt.rematMode not in ("", "full", "mlp"):
        raise SystemExit(f"--rematMode {opt.rematMode!r}: '' | full | mlp")
    if opt.moeExperts and opt.moeExperts != opt.dp:
        raise SystemExit(f"--moeExperts {opt.moeExperts} must equal --dp "
                         f"{opt.dp} (one expert per data-parallel device)")
    if (opt.serve or opt.generate) and opt.moeExperts:
        raise SystemExit("--serve/--generate support dense models (per-tick "
                         "MoE routing would not match the trained capacity "
                         "math)")
    if opt.generate and opt.seqLayout == "zigzag":
        raise SystemExit("--generate decodes in natural order — drop "
                         "--seqLayout zigzag")
    if min(opt.dp, opt.sp, opt.tp) < 1 or opt.batchSize % opt.dp:
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
    return opt.dp * opt.sp * opt.tp


def _init(lm, opt, device):
    return lm.init(torch.Generator().manual_seed(opt.seed), device=device)[0]


def build_model(opt):
    """``(params, compute_dtype)``: the seeded initialisation on
    ``opt.device``."""
    return _init(_model(opt), opt, opt.device), _compute_dtype(opt)


def start_server(opt, params, compute_dtype=None, **server_kw):
    """The engine warmed up (one smallest-bucket prefill and one tick, as
    the JAX example does) behind a started :class:`ServeServer`."""
    engine = DecodeEngine(params, num_slots=opt.serve,
                          compute_dtype=compute_dtype, device=opt.device)
    slot, _ = engine.admit(np.ones(4, np.int32), 2)
    engine.tick()
    engine.finish(slot)
    return ServeServer(engine, port=opt.servePort, **server_kw).start()


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


def train(opt, rank: int = 0, init_method: str | None = None):
    """``opt.steps`` SGD steps of this rank of the ``(dp, sp, tp)`` mesh on
    its block of the corpus; returns ``(params, compute_dtype, corpus)``
    with the trained params gathered whole (the working copy under
    ``--mixed``; None where neither ``--generate`` nor ``--serve`` asks for
    them).  The mesh's process group starts here and is destroyed before
    returning."""
    import torch.distributed as dist

    from distlearn_tpu_torch.models.convert import (lm_from_jax, lm_gather,
                                                    lm_shard)
    from distlearn_tpu_torch.parallel.mesh import (init_named_mesh,
                                                   local_init_method)
    from distlearn_tpu_torch.train.lm import (build_lm_mixed_step,
                                              build_lm_moe_metrics,
                                              build_lm_step,
                                              init_lm_mixed_state)
    from distlearn_tpu_torch.utils.profiling import StepTimer, trace

    log = root_print(rank)
    device = rank_device(torch.device(opt.device), rank)
    mesh = init_named_mesh((opt.dp, opt.sp, opt.tp), rank=rank,
                           device=device,
                           init_method=init_method or local_init_method())
    try:
        lm = _model(opt)
        ep_axis = "data" if opt.moeExperts else None
        axes = dict(seq_axis="seq", tp_axis="model", ep_axis=ep_axis)
        params = lm_shard(_init(lm, opt, "cpu"), mesh, "model", ep_axis)
        kw = dict(axes, accum_steps=opt.accumSteps,
                  moe_balance_weight=(opt.moeBalanceWeight
                                      if opt.moeExperts else 0.0),
                  seq_layout=opt.seqLayout)
        if opt.mixed:
            step = build_lm_mixed_step(lm, mesh, lr=opt.learningRate, **kw)
            params = init_lm_mixed_state(params)
            log("mixed precision: bf16 working params + f32 masters")
        else:
            step = build_lm_step(lm, mesh, lr=opt.learningRate, **kw)
        moe_metrics = build_lm_moe_metrics(lm, mesh, **axes) \
            if opt.moeExperts else None
        log(f"mesh dp={opt.dp} sp={opt.sp} tp={opt.tp} ({mesh.backend} on "
            f"{mesh.device}); seq_impl={opt.seqImpl}"
            + (f"; {opt.moeExperts} experts, top-{opt.moeTopK}"
               if opt.moeExperts else "")
            + f"; remat {opt.rematMode or ('full' if opt.remat else 'off')}"
            f", attention {opt.attnImpl or 'env default'}")
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
        d, q = mesh.axis("data"), mesh.axis("seq")
        rows, cols = opt.batchSize // d.size, opt.seqLen // q.size
        tokens = torch.from_numpy(np.ascontiguousarray(
            toks[d.index * rows:(d.index + 1) * rows,
                 q.index * cols:(q.index + 1) * cols])).to(mesh.device)
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
            whole = lm_from_jax(lm_gather(getattr(params, "params", params),
                                          mesh, "model", ep_axis),
                                device=mesh.device)
    finally:
        dist.destroy_process_group()
    return whole, _compute_dtype(opt), corpus


def _rank_main(rank: int, opt, init_method: str) -> None:
    """A spawned rank of the mesh: trains, then rank 0 runs the rest."""
    params, cd, corpus = train(opt, rank, init_method)
    if rank == 0:
        _after_training(opt, params, cd, corpus)


def _after_training(opt, params, cd, corpus) -> None:
    """``--generate`` and ``--serve`` on the whole ``params``."""
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
        srv = start_server(opt, params, cd)
        install_signal_flush(srv)
        log(f"serving on {srv.host}:{srv.port} ({opt.serve} slots, max_len "
            f"{srv.engine.max_len}, {srv.engine.device}) — drive with: "
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
    if opt.steps > 0 and _ranks(opt) > 1:
        import torch.multiprocessing as mp

        from distlearn_tpu_torch.parallel.mesh import local_init_method
        from distlearn_tpu_torch.utils.platform import available_nodes
        device = resolve_device(opt.device)   # no card, no --device cpu: raise
        avail = available_nodes(device)
        if avail is not None and avail < _ranks(opt):
            raise SystemExit(f"need {_ranks(opt)} devices (dp*sp*tp), have "
                             f"{avail}")
        mp.start_processes(_rank_main, args=(opt, local_init_method()),
                           nprocs=_ranks(opt), start_method="spawn")
    else:
        if opt.steps > 0:
            params, cd, corpus = train(opt)
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
