"""Serve the transformer LM with continuous batching — the serving half of
the JAX package's ``examples/lm.py``, with the same flag names (``--tpu``
becomes ``--device``, the card by default).

    python -m distlearn_tpu_torch.examples.lm --steps 0 --serve 4 \\
        --servePort 9123
    python -m distlearn_tpu_torch.examples.lm_client --port 9123

``--steps 0`` serves (or, with ``--generate N``, greedy-decodes from) the
model's seeded initialisation.  LM training and its parallel layouts
(``--steps`` > 0, ``--dp/--sp/--tp/--pp`` > 1, MoE, ZeRO, FSDP, mixed
precision) wait for ROADMAP A11, so those flags only accept their serving
values here; the mesh flags default to 1 (one card).  SIGTERM or Ctrl-C
drains the in-flight requests, then exits.
"""

from __future__ import annotations

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

_A11 = "LM training is ROADMAP A11"

FLAGS = {
    "dp": (1, "data-parallel mesh axis size (LM training: ROADMAP A11)"),
    "sp": (1, "sequence-parallel axis size (ROADMAP A11)"),
    "tp": (1, "tensor-parallel axis size (ROADMAP A11)"),
    "pp": (0, "pipeline-parallel stages (ROADMAP A11)"),
    "ppSchedule": ("gpipe", "pipeline schedule (ROADMAP A11)"),
    "microbatches": (4, "pipeline microbatches (ROADMAP A11)"),
    "dim": (128, "model width"),
    "depth": (4, "number of blocks"),
    "vocab": (256, "vocabulary size"),
    "seqLen": (128, "sequence length (the model's max_len)"),
    "batchSize": (8, "global batch size (the --generate corpus rows)"),
    "steps": (0, "training steps (0 = serve the initialised model; "
                 "training is ROADMAP A11)"),
    "learningRate": (0.1, "SGD learning rate (ROADMAP A11)"),
    "seqImpl": ("ring", "sequence attention with --sp > 1 (ROADMAP A11)"),
    "seqLayout": ("contig", "sequence shard layout (ROADMAP A11)"),
    "attnImpl": ("", "attention kernel of --generate: '' (env default) | "
                     "xla | flash | chunked; the engine follows "
                     "DISTLEARN_TPU_ATTN"),
    "scanBlocks": (False, "scanned-depth layout: block params stacked"),
    "moeExperts": (0, "experts per MoE block (ROADMAP A11)"),
    "moeTopK": (1, "experts per token (ROADMAP A11)"),
    "moeBalanceWeight": (0.01, "MoE balance loss weight (ROADMAP A11)"),
    "remat": (False, "activation recomputation (ROADMAP A11)"),
    "rematMode": ("", "'' | full | mlp (ROADMAP A11)"),
    "zero": (False, "ZeRO-1 training (ROADMAP A11)"),
    "mixed": (False, "bf16 working params + f32 masters (ROADMAP A11)"),
    "fsdp": (False, "fully-sharded data parallelism (ROADMAP A11)"),
    "generate": (0, "greedy-decode this many tokens from held-out prompts "
                    "with the KV-cached decoder (models.greedy_generate)"),
    "serve": (0, "serve the model with this many continuous-batching "
                 "decode slots ('G'/'R' frames; drive with "
                 "distlearn_tpu_torch.examples.lm_client)"),
    "servePort": (0, "serving port (0 = ephemeral, printed at startup)"),
    "optimizer": ("sgd", "sgd | adam | adamw (ROADMAP A11)"),
    "accumSteps": (1, "gradient-accumulation microbatches (ROADMAP A11)"),
    "profile": ("", "profiler trace of training steps (ROADMAP A11)"),
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
    opt = parse_flags("Serve a transformer LM with continuous batching.",
                      FLAGS, argv)
    if opt.steps > 0:
        raise SystemExit(f"--steps {opt.steps}: {_A11}; pass --steps 0 to "
                         "serve or decode the initialised model")
    for name in ("dp", "sp", "tp"):
        if getattr(opt, name) != 1:
            raise SystemExit(f"--{name} {getattr(opt, name)}: the parallel "
                             f"LM layouts wait for ROADMAP A11; pass 1")
    for name in ("pp", "moeExperts", "zero", "mixed", "fsdp", "remat",
                 "rematMode"):
        if getattr(opt, name):
            raise SystemExit(f"--{name}: {_A11}")
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


def build_model(opt):
    """``(params, compute_dtype)``: the seeded initialisation on
    ``opt.device``."""
    lm = transformer_lm(vocab=opt.vocab, dim=opt.dim, depth=opt.depth,
                        heads=max(4, opt.dim // 64), max_len=opt.seqLen,
                        scan_blocks=opt.scanBlocks)
    params, _ = lm.init(torch.Generator().manual_seed(opt.seed),
                        device=opt.device)
    return params, (torch.bfloat16 if opt.bf16 else None)


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


def main(argv=None) -> int:
    opt = parse(argv)
    log = root_print(0)
    if opt.obsTrace:
        obs_trace.set_propagate(True)
    if opt.obsLog:
        obs.set_spill(opt.obsLog)
    http = obs.start_http_server(opt.obsPort) if opt.obsPort else None
    params, cd = build_model(opt)
    if opt.generate:
        toks = _corpus(opt)
        Pq = max(4, opt.seqLen // 8)
        steps = min(opt.generate, opt.seqLen - Pq)
        # two prompts of different lengths, left-padded to Pq
        plens = np.array([Pq, max(2, Pq // 2)], np.int32)
        prompts = np.zeros((2, Pq), np.int32)
        for b, L in enumerate(plens):
            prompts[b, Pq - L:] = toks[b % toks.shape[0], :L]
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
    if opt.obsLog:
        obs.write_snapshot(opt.obsLog)
        obs.set_spill(None)
    if http is not None:
        http.close()
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
