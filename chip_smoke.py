#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distlearn_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device  — require CUDA; print the card's name and power limit
   (nvidia-smi); float32 everywhere (TF32 off for convolutions and matmuls,
   cuDNN deterministic) for parity and timing alike.
2. build   — compile every CUDA source of the port (one nvcc each, started
   together) into the git-ignored build directory; B1's two 128-bit loads
   before its first store (``cuobjdump -sass``); per flash kernel, ptxas's
   registers and spills (none allowed in the D=64 B5a, B5b and B5c,
   bfloat16 and float32 alike; float32 B5a's registers logged at every
   head dim) and the HMMA count of its SASS (``cuobjdump -sass``):
   non-zero in every one, the bfloat16 kernels and the float32 (3xTF32)
   B5a, B5b and B5c alike.
3. kernels — each kernel against its plain PyTorch version, bit for bit, at
   the full-width CIFAR-10 bucket and at a ragged length, aligned and one
   element in, B1 also at lengths 1, 3 and around four chunks, one launch a
   call; median times over CUDA events (L2 flushed before each launch)
   beside the plain version, the one PyTorch call computing the same
   function where there is one, and the bound (bytes over the card's HBM
   rate, operations over its FP32 rate); B1 also on the host's clock
   (flush, synchronize, call, synchronize) beside ``torch.add``.
4. sgd     — the main path: AllReduceSGD on the full-width convnet
   (dropout 0.5, global batch 256) through ``build_sgd_step`` on a
   single-rank NCCL group, then ``build_sync_step``; the fused-SGD kernel
   must have launched once per bucket per step.  Then fused against plain
   (dropout 0) from the same weights and batches, and the card against the
   port's CPU path on a small batch.
5. ea      — AllReduceEA (tau 4, alpha 0.2) for 2 cycles through
   ``build_ea_steps``; the fused-elastic kernel must have launched once per
   bucket per round.  Then fused against plain.
5a. graph sgd — ``build_sgd_scan_step`` at full width, batch 256, K=4 on
   the same NCCL rank: 5 CUDA graph replays bit for bit against 20 eager
   ``build_sgd_step`` calls from the same weights, batches and generator
   seed (params, batchnorm stats, confusion matrix, step count, losses) at
   dropout 0 and 0.5; a ``with_contrib`` replay with flags [1, 0, 1, 1]
   against its four eager calls; a fresh seed-9 state carrying its own
   generator through the dropout-0.5 capture, one replay bit for bit
   against 4 eager steps; a profiled replay names B1 (``sgd_chunk``)
   K times and makes one ``cudaGraphLaunch`` (torch.profiler's runtime
   calls), with the replay's device idle share; steps/s eager against
   graph on the host clock (median of 5 windows of 20 steps, each ending
   in a synchronize), and the graph fed by ``DeviceDataset`` index vectors.
5b. graph ea — ``build_ea_cycle`` (tau 4, alpha 0.2) for 2 cycles, each
   replay bit for bit against 4 ``local_step`` calls and ``ea_round``; a
   profiled replay names B2 once and makes one ``cudaGraphLaunch``.
6. wire    — the AsyncEA int8 codec kernels (B3 amax + quantize with error
   feedback, B4 dequantize-and-add) against their plain versions, bit for
   bit: the one-leaf wrappers at the convnet's 18 leaf sizes and at a
   ragged, unaligned length, one launch of each per call; B3 over all 18
   leaves (q cut from one byte frame at unaligned offsets, as the client's
   encode writes them) in one amax and one quantize launch, over more
   leaves than one table holds in one of each per table, and with a NaN,
   +inf or -inf in leaf 5 (leaves 0-4 encoded, 5-17 untouched, the scales
   raise) or a NaN in leaf 10 of 147 (every later table untouched); B4 likewise in one launch per table; the client's encode on the
   card against the CPU route (manifest bytes, frame, residuals; with a
   poisoned leaf both raise alike), with two B3 launches and one
   synchronize an encode (CUDA runtime calls by torch.profiler);
   non-finite input raises and writes nothing, a zero leaf gives q = 0, r
   = x; times over the whole 18-leaf delta (one call each) and the
   largest leaf (conv4) beside the plain versions, the loop of
   ``torch.add(c, q, alpha=s)`` over the leaves (not bit for bit) and the
   bound, and the whole call on the host's clock.
7. async trajectory — a serial AsyncEA server and one client with their
   tensors on the card, at the convnet's 18 leaves on the JAX package's
   wire layout (``CONVNET_WIRE``), 20 int8 and 5 raw rounds with a seeded
   drift: center and client params bit for bit the
   same run on the port's CPU route (B3, B4, the copies and the transport
   together), one launch of each B3 pass and of B4 an int8 round.
8. async train — the AsyncEA path: the example's roles as threads on the
   card (a serial server, 2 clients, a tester), the full-width CIFAR-10
   convnet, batch 128 per client, tau 4, alpha 0.2, int8, 8 syncs per
   client; 16 syncs applied, 5 tester pushes, finite losses, and the B3/B4
   launch counts the design implies (one amax, one quantize and one B4
   launch a sync).  Prints where a sync's time goes.
8a. async concurrent — the rest of AsyncEA on the card: (a) a concurrent
   server striped 4 ways (conv4 split into 4 chunks) and one client, 20
   int8 and 5 raw rounds of phase 7's drift, center and params bit for bit
   the CPU route's, raw bit for bit the one-stripe run, B3 (amax,
   quantize) and B4 launched once a stripe a sync; 3 int8 rounds at S = 3
   (conv4 chunks at offsets that are not multiples of 4) bit for bit the
   CPU route's; (b) the example's roles as threads: an elastic S = 4
   concurrent server, 3 founding clients (overlapped pushes) of the
   full-width convnet at batch 128, tau 4, int8, client 2 dropping its
   channels after 3 syncs and rejoining, client 3 leaving after 4, a
   capacity-2 client joining: every counted sync applied once, client 2's
   ledger at its last sync on every stripe, the live weights summing to
   3, finite losses, B3 4 + 4 launches a sync and B4 one a weight-1
   stripe apply; (c) HA: checkpoints every 2 syncs, the primary stopped
   after 5, a standby promoted (its center the checkpoint's bit for bit,
   epoch 1), the clients failing over (the missed sync replayed once: the
   primary's final center bit for bit) and syncing again, a stale center
   refused; (d) syncs/s and the client sync split for the serial server
   and the concurrent one (S = 1, 4, 4 with overlap) with the same 2
   clients, and B3/B4 at two stripes' shapes (CUDA events, L2 flushed,
   busy time, plain twins, the ``torch.add`` loop, the bound).
9. flash   — kernel B5a (causal flash-attention forward) against its plain
   twin and the xla route at the serving shape (B=1, H=16, D=64) for L =
   128, 256, 1024, 2048, at B=4, H=8, D=128, L=1024 and at B=2, H=4, D=32,
   L=512, float32 and bfloat16; in bfloat16 also non-causal, L=64 and q
   multiplied by 8 (FLASH_BF16_CASES, untimed);
   median times (L2 flushed) beside the plain twin,
   ``F.scaled_dot_product_attention(is_causal=True)`` (timed as the
   library yardstick only) and the bound (float32: S on the CUDA cores
   beside P V in 3xTF32, and what the CUDA cores alone would bound it at).
10. serve  — the served transformer LM at full width (vocab 32768, dim
   1024, depth 8, 16 heads, max_len 2048, the seeded init, float32
   params) under ``DISTLEARN_TPU_ATTN=flash``: (a) float32 compute, TF32
   off, a 1024-token prompt, the engine with the flash and the xla route
   against ``greedy_generate`` on the xla route, B5a launched once a
   layer on the flash route (its float32 kernel) and never on the xla
   route; (b) bfloat16 compute, 4 slots, a
   ``ServeServer`` on loopback answering 8 requests (prompts of 100-1500
   tokens, 32 new tokens each) from 4 client threads, some admitted while
   others decode (the chunk pass): every stream against its isolated
   ``greedy_generate`` stream on the xla route, B5a launched 8 times per full-prompt
   prefill at a bucket of 128 or more, and TTFT, TPOT, tokens/s and B5a's
   share of a prefill's device time; the profiled prefill names the
   tensor-core B5a (``flash_fwd_mma``) and no other flash kernel.
11. flash backward — kernel B5a with its residuals (m, l), B5c (dQ, with
   di in its prologue) and B5b (dK, dV) at the LM training shape (B=8,
   H=16, D=64, L=1024) and at B=1, H=16, D=64, L=1024; B=2, H=4, D=32,
   L=512; B=4, H=8, D=128, L=1024; causal, float32 and bfloat16: each
   kernel against its plain twin, dQ/dK/dV against autograd of the xla
   route, the backward run twice bit for bit; median times (L2 flushed)
   beside the twins, the bound, and the backward of
   ``F.scaled_dot_product_attention(is_causal=True)`` (timed as the
   library yardstick only) against B5c + B5b together; the FLASH_BF16_CASES
   and FLASH_F32_CASES checked the same way, untimed; a profiled float32
   call names only the 3xTF32 tensor-core kernels (``*_tf32x3``), a
   bfloat16 one only the bfloat16 tensor-core kernels (``*_mma``).
12. train LM — the full-width LM of ``bench.py:1690-1713`` (vocab 32768,
   dim 1024, depth 8, 16 heads, max_len 1024, bfloat16 compute, float32
   params, batch 8 of uniform tokens, lr 1e-2) on one NCCL rank with
   ``attn_impl="flash"``: (a) 20 steps of ``build_lm_step``, the loss
   finite and falling, B5a, B5b and B5c launched 8 times a step; (b) one
   step on the flash route against the xla route; (c) ``remat="full"``
   and ``"mlp"`` against none, with their launch counts (B5a 16 a step
   under full remat); (d) ``build_lm_mixed_step``, ``params ==
   master.to(bfloat16)`` bit for bit; (e) steps/s, tokens/s and peak
   memory per mode, one profiled step (device busy, B5a/B5b/B5c shares,
   each by its tensor-core kernel's name and with 8 launches: the profile
   lost no device event) and MFU against the bfloat16 dense peak (the run
   fails above 1); (f) the float32 leg: float32 compute (TF32 off), flash,
   one step whose loss and every leaf's update are held against the xla
   route's, then 3 timed steps and one profiled: B5a, B5c and B5b 8
   launches a step by count and by the 3xTF32 kernels' names, and the
   pair's and B5a's shares of the step's device time.
13. examples — ``python -m distlearn_tpu_torch.examples.cifar10
   --numEpochs 1 --numExamples 2048 --testExamples 512 --batchSize 256
   --learningRate 0.01 --parity``, plain and with ``--deviceData --bf16``;
   ``...examples.mnist_ea --scanCycle --communicationTime 4 --numEpochs
   2``; ``...examples.mnist --numNodes 4 --numEpochs 1 --parity`` (warns
   and runs one node on one card): each its own process on the card, each
   parity line printed, every accuracy finite and above chance.
14. entry  — ``graft_entry.entry()`` on the card against its CPU route
   within phase 4's card-against-CPU log-prob tolerance.
15. host    — the reference's process-per-node path: the native reduce
   and the SIMD C host codec built (no numpy fallback), the codec bit for
   bit B3's plain twin; ``examples/client_remote.py`` as 4 processes
   sharing ``cuda:0`` (tau 4, 2 epochs of 4096 examples, global batch
   128), over the tree and then the ring: the nodes' final digests agree,
   each rank's B2 launches equal its elastic rounds (> 0), the loss falls;
   4 spawned rank processes on ``cuda:0``: the convnet's 18 leaves (17.3
   MB float32) as tensors on the card through the tree and the ring, bit
   for bit the same round with numpy leaves, with the median of 10
   rounds' staging, host round and return and the NIC bytes (the tree's
   root, a ring rank); ``TreeAllReduceSGD`` with 3, 4, 5 and 6 steps,
   every rank's params equal after ``synchronize_parameters``; an int8
   tree round bit for bit the numpy route's; then
   ``parallel.init.initialize`` as one NCCL process and 3
   ``build_sgd_step`` steps of the toy model, the loss finite.
16. backends — A9(d): (a) ``MeshBackend``, 4 rows of the convnet's 18
   leaves on the card, sum, rider and a contrib mask bit for bit the CPU
   route; (b) ``HybridBackend`` as 2 host processes sharing ``cuda:0``, 2
   rows each, over the tree and the ring (raw, dyadic rows): every row bit
   for bit a 4-row ``MeshBackend``, the median stage, host round and return
   of 10 rounds; int8 over the tree bit for bit the CPU route (the host
   codec); (c) ``examples/sync_backends.py`` with ``--backend mesh``,
   ``host`` and ``hybrid`` on the card: one digest; (d) the slice client,
   4 rows of the full-width convnet against a serial server on the card,
   int8, 8 syncs: one push a sync, B3 one amax and one quantize launch a
   sync and B4 one a server apply, center and rows bit for bit the CPU
   route; a raw sync moves the center by the row-sum of the deltas, bit
   for bit.
17. resnet — A10, ResNet-50 v1.5 at full width (1000 classes, 224^2,
   global batch 256, 16-MiB buckets) on one NCCL rank: (a) float32 (TF32
   off) and (b) bfloat16 compute: 10 ``build_sgd_step`` steps, the loss
   finite, B1 launched 8 times a step, then ``build_sync_step``; fused
   against plain from the same weights and batches (phase 4's tolerance);
   the card against the CPU route at batch 2, 64^2 in float64 (phase 4's
   card-against-CPU tolerances; float32 is ill-conditioned there, see
   RESNET_CPU_BATCH); (c) steps/s, images/s, peak memory and MFU (analytic
   FLOPs over 67 TFLOP/s float32, 989 TFLOP/s bfloat16; fails above 1) and
   one profiled step (busy, idle share, convolution, reduction, elementwise
   and B1 shares); (d) ``build_optax_step`` with momentum and adam and
   ``build_zero_optax_step`` with adam, 5 steps each, ZeRO-1 at n = 1
   against the full adam step (bit for bit, or rtol 1e-6 and atol 1e-7;
   the log says which); (e) the ``resnet50`` example as its own process,
   plain and ``--bf16 --deviceData`` (run together), every loss finite; (f)
   B1 at the largest bucket (CUDA events, L2 flushed) beside its plain twin,
   ``torch.add`` and the bound.
18. mesh_lm — A11's first half: 4 rank processes on ``cuda:0``, each mesh
   a gloo group over CUDA tensors passed explicitly (NCCL cannot put two
   ranks on one card; every collective staged through pinned host memory,
   so its times are that host route's, not NCCL's).  First what gloo
   itself does with CUDA tensors (all_reduce, all_gather,
   all_to_all_single, broadcast, bfloat16; send/recv in two processes of
   their own).  Then, at phase 12's width (vocab 32768, dim 1024, depth 8,
   16 heads, max_len 1024, float32 params, bfloat16 compute, flash, batch
   8 x 1024) from phase 12's seeded init sharded by ``lm_shard``, on the
   meshes (dp, sp, tp) (1, 1, 2) Megatron tp with ``fused=True``, (1, 2,
   1) ring, zigzag and Ulysses, (2, 1, 1) MoE (2 experts, top-2, balance
   weight 0.01) and (1, 2, 2): (a) 3 ``build_lm_step`` steps, every loss
   finite and equal on the ranks, the first within 1e-2 of one rank's loss
   on the same batch and weights, B5a/B5b/B5c a step by count and by
   profile names (8 each where flash engages: tp, Ulysses, MoE; none on
   the ring), B1 on the tp mesh, the step on the host clock and the
   collectives' share of it; (b) one float64 step (dim 64, depth 2, L 128,
   xla) whose implied update is within 1e-5 of one rank's gradient on the
   card; (c) ``build_lm_mixed_step`` once on (1, 1, 2), ``params ==
   master.to(bfloat16)`` bit for bit.  The phase fails past 150 s.
19. pp_lm — A11's second half, 4 rank processes on ``cuda:0`` over gloo as
   in 18, phase 12's model, weights and batch: (a) GPipe on (dp, pipe)
   (1, 4) (2 blocks a stage) and (2, 2) (4 blocks a stage) and 1F1B on
   (1, 4), 4 microbatches, 3 steps each: every loss finite and equal on
   the ranks, the first within 1e-2 of one rank's loss, B5a/B5b/B5c a step
   by count and by profile names on every rank equal to
   ``pp_launches`` (the schedule as ported), the step on the host clock
   and the collectives' share of it, one float64 step (dim 64, depth 4, L
   128, xla) whose implied update is within 1e-5 of one rank's gradient;
   (b) at S = 4 and M = 16 (batch 16 x 1024) each rank's peak
   ``max_memory_allocated`` of a 1F1B step below its GPipe step's, the
   losses equal; (c) Adam (lr 1e-4) through ``build_lm_optax_step``,
   ``build_lm_mixed_optax_step`` (``params == master.to(bfloat16)``),
   ``build_lm_zero_step`` on dp 4 (within rtol 1e-6, atol 1e-7 of the
   replicated step) and ``build_lm_zero_mesh_step`` on (2, 1, 2);
   ``build_lm_fsdp_step`` on dp 4 against ``build_lm_step`` (loss rtol
   1e-6, params rtol 1e-5, atol 1e-6), 1/4 of every leaf stored a rank, its
   gathers and reduce-scatters counted; 3 steps each, every loss finite,
   B5a-B5c 8 a step by count and profile names.  Inside (c)'s ZeRO-1 run,
   every rank saves its records of the state after step 2 to a sharded
   checkpoint (``save_sharded_checkpoint`` of ``lm_zero_records``: its
   master and Adam rows, the params once); a fresh state restored from the
   files (``lm_zero_restore``) takes step 3, which must equal the
   uninterrupted step 3 bit for bit, and the params restored whole from
   the files must equal ``lm_gather``'s.  The phase fails past 240 s.
20. fleet — A12, phase 10's LM from its seeded init: (a) the
   tensor-parallel engine as 2 rank processes on ``cuda:0`` over gloo
   (each holding 8 of the 16 heads; rank 0 leads, rank 1 replays its ops
   in ``follow()``): a 1024-token prompt and 16 greedy tokens through the
   full prefill, 256-token chunks and verify, in float32 (TF32 off) and
   bfloat16 compute with flash, each stream held against the single-rank
   engine on the same weights (a mismatch passes only at a near-tie of
   the reference's logits, reported with its gap); B5a 8 a full prefill
   on each rank by count and by profile names (tensor cores in
   bfloat16); a tick's psums and their host seconds (``Mesh.stats``).
   (b) the fleet: a port ``Router`` over replica A (a single-rank engine
   serving from a thread here) and replica B (the tp=2 leader and its
   follower), float32: 8 requests from 4 threads, prompts of 100-1500
   tokens, 32 new tokens; A stops as request 4 is submitted; every request
   ends complete (its stream ``greedy_generate``'s) or failed mid-stream
   on A (a prefix of it); then an epoch-2 checkpoint lands, replica B
   swaps (each rank reads it and takes its shard) and echoes 2, and 2
   requests after it are epoch 2 and ``greedy_generate``'s on the new
   weights; TTFT and TPOT p50 per replica.  The phase fails past 150 s.
21. tools — A13, the port's fleet tools (``distlearn_tpu_torch/tools``)
   on the card: (a) ``chaos.run_parity`` (8 rounds, a kill at round 3 on
   a round boundary and mid-flight, S = 4) and ``run_churn`` (3 clients:
   raw, int8, fp16; 1 center kill) on the convnet's 18 leaves (17.3 MB),
   the promoted centers bit for bit the unkilled run's; B3's and B4's
   launches in the churn equal the int8 encodes and fused applies that
   ``diststat``'s codec table reads from the run's trail, and the
   profile's kernel names; (b) ``run_scenario`` ``zipf_mix`` (128-token
   shared prefixes), ``replica_kill`` (prompts of 100-1500 tokens) and
   ``flash_crowd`` (the JAX tool's 3-8-token prompts, its bounds kept)
   over phase 10's LM at full width in float32 with flash: B5a's launches
   equal 8 (depth) a ``serve.prefill`` span of bucket >= 128 in the
   trails, and one profiled 1000-token prefill launches it 8 times and
   names it on its float32 3xTF32 route (``flash_fwd_tf32x3``); (c)
   ``diststat merge`` and ``tracecat`` over every trail: non-empty fleet
   tables, one stitched router-to-replica trace a request; (d)
   ``ea_convergence`` SGD and EA (tau 4), 4 ranks of 3 s: the EA curve
   descends, B2 once a rank an elastic round; (e) ``profile_resnet`` at
   batch 256 for 4 bfloat16 steps through ``utils/profiling.trace``, then
   ``analyze_trace`` on its trace: B1 named 8 times a step, the class
   shares beside phase 17's.  The phase fails past 150 s.
22. lint — A14, the port's distlint (``python -m
   distlearn_tpu_torch.tools.distlint --all --device cuda --format
   json``) in a fresh process: its 8 gloo rank processes share ``cuda:0``
   and run every step family once.  Exit 0 and no finding in all 14
   families (so the tp engine's leader and follower records are equal:
   DL002 quiet); every unit's peak memory rise within the lockfile's
   memory tolerance of the committed card figure; each unit's launches on
   its first rank, by the wrappers' counters and by profile names, equal
   to ``lint_expected`` (B3 amax + quantize in ``wirek:quant_ef``, B4 in
   ``dequant_add``, B1 a fused step, B2 a round, B5a-B5c as the pipeline
   schedules, the MoE LM, Ulysses and the 128-token prefill run them, 0
   elsewhere).  The phase fails past 150 s.
23. report — a ``{"kernels": [...]}`` line (the flash rows and B1 with
   their phase-18 launches under ``mesh_lm_launches``, the flash rows
   with phase 19's under ``pp_lm_launches``, B5a with phase 20's under
   ``tp_serve_launches`` and ``fleet_launches``, B1-B5a with phase 21's
   under ``tools_launches``, every row with phase 22's by unit under
   ``lint_launches``), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SGD_BATCH = 256          # global batch = per-node batch on one rank
SGD_STEPS = 20           # >= 10 fused steps on the main path
LR = 0.002               # the 2048-wide linear layer spikes the loss above this
EA_TAU, EA_ALPHA, EA_CYCLES = 4, 0.2, 2
# graph phase: K steps a replay, replays per check, timing windows, and the
# contributor flags of the with_contrib replay
GRAPH_K, GRAPH_REPLAYS, GRAPH_WINDOWS = 4, 5, 5
GRAPH_FLAGS = (1, 0, 1, 1)
PARITY_STEPS = 3
# Fused and plain runs differ only in the update (the kernels equal their
# plain versions bit for bit) and in how gradients are packed for the
# allreduce, which moves no value; with cuDNN deterministic the expected
# difference is 0.  1e-6 leaves room for reduction-order noise only.
PARITY_TOL = 1e-6
# The card against the port's CPU path, one step at batch CPU_REF_BATCH:
# the two libraries' float32 convolutions sum in different orders, and
# batchnorm's E[x^2] - E[x]^2 amplifies that to ~1e-3 of a gradient
# (measured against JAX on the CPU); times lr 0.002 that is < 1e-5 on a
# parameter, and the log-probs agree to ~1e-5.
CPU_REF_BATCH = 32
CPU_REF_PARAM_TOL = 1e-4
CPU_REF_LOGP_TOL = 1e-3
TIMING_ITERS = 100
CIFAR_BUCKET = 4_329_472
RAGGED = CIFAR_BUCKET - 1021     # not a multiple of 4 or of 1024
# B1: one block's chunk (1 float4 x 128 threads) and the short and ragged
# lengths around it
SGD_CHUNK = 4 * 128
SGD_SHORT = (1, 3, 4 * SGD_CHUNK - 1, 4 * SGD_CHUNK + 5)

# AsyncEA phases: 2 clients of batch 128 (global 256, as in the SGD phase)
ASYNC_CLIENTS, ASYNC_BATCH, ASYNC_TAU, ASYNC_ALPHA = 2, 128, 4, 0.2
ASYNC_SYNCS_PER_CLIENT, ASYNC_TEST_TIME = 8, 4
TRAJ_ROUNDS = (("int8", 20), ("raw", 5))
# phase 8a: 4 stripes (S = 3 cuts conv4 at element offsets that are not
# multiples of 4); 3 founding clients, client 2 cut after 3 syncs, client 3
# leaving after 4, a capacity-2 joiner
ASYNC8A_SHARDS, ASYNC8A_RAGGED_SHARDS, ASYNC8A_CLIENTS = 4, 3, 3
ASYNC8A_CUT_AFTER, ASYNC8A_LEAVE_AFTER, ASYNC8A_JOIN_CAPACITY = 3, 4, 2.0
CONVNET_LEAVES, CONVNET_PARAMS, CONV4 = 18, 4_328_970, 3_276_800
RAGGED_LEAF = CONV4 - 1021               # not a multiple of 4
B3_SENTINEL_Q, B3_SENTINEL_R = 0x55, -7.5  # what B3 must leave unwritten
ROLE_TIMEOUT_S = 300
# the examples as processes on the card (phase 13); the cifar10 runs take
# lr 0.01: at the default 0.1 one epoch of 8 steps leaves the training
# accuracy at chance, in this port and in the JAX example alike (PERF.md)
EXAMPLE_TIMEOUT_S = 300
CHANCE = 0.1                   # ten classes
_CIFAR = ["cifar10", "--numEpochs", "1", "--numExamples", "2048",
          "--testExamples", "512", "--batchSize", "256", "--learningRate",
          "0.01", "--parity"]
EXAMPLES = (_CIFAR, _CIFAR + ["--deviceData", "--bf16"],
            ["mnist_ea", "--scanCycle", "--communicationTime", "4",
             "--numEpochs", "2"],
            ["mnist", "--numNodes", "4", "--numEpochs", "1", "--parity"])

# Card rates for the bound (NVIDIA's H100 and H200 SXM data sheets): HBM
# bytes/s by part, FP32 (non-tensor-core) FLOP/s, dense bf16 and TF32
# tensor-core FLOP/s.
HBM_BYTES_PER_S = {"H200": 4.8e12, "H100": 3.35e12}
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# TF32 passes a float32 product of the 3xTF32 kernels (float32 B5a, B5b,
# B5c)
TF32_PASSES = 3

# Phase 9: B5a at (B, H, D, L): the served LM's head shape at the prompt
# buckets phase 10 prefills at, one shape per other head dim the kernel is
# built for; the kernels line reports bfloat16 at the serving shape
# FLASH_MAIN, the dtype and shape the served LM runs.
FLASH_SHAPES = ((1, 16, 64, 128), (1, 16, 64, 256), (1, 16, 64, 1024),
                (1, 16, 64, 2048), (4, 8, 128, 1024), (2, 4, 32, 512))
FLASH_MAIN = (1, 16, 64, 1024)
# float32 (TF32 off): the kernel and the plain twin differ only in the
# order of float32 sums and FMA contraction (measured ~1e-6 on outputs of
# order 1), so 1e-5 absolute, against the twin and the xla route alike.
FLASH_F32_TOL = 1e-5
# bfloat16: the reference's own flash tolerance, rtol = atol = 2e-2
# (tests/test_sequence.py:161-162), never looser.
FLASH_BF16_TOL = 2e-2

# Phases 9 and 11, bfloat16 only, untimed, at the same tolerances: where
# the tensor-core kernels can break.  (B, H, D, L, causal, q multiplier):
# full (non-causal) attention; L = 64, one diagonal tile; q multiplied by 8
# (scaled scores of standard deviation 8, up to about +-50), which works
# the online rescale in the fragment layout, at D = 64 and D = 128.  With q
# x 8 the gradients are held against the twins only: there the library's
# own roundings (di from the bfloat16 o, then dP - di cancelling where P is
# nearly one-hot) put even the twin up to ~0.3 off the xla route's dK
# (measured on the CPU for both compute dtypes), so that distance is
# logged beside the twin's own, not held.  And dK = dS^T Q: where the
# kernel's S (summed in another order) rounds a bfloat16 dS the other way
# than the twin's, dK moves by that ulp times |q|, which q x 8 scales, so
# dK's absolute tolerance against its twin is 8 x 2e-2 there (rtol stays
# 2e-2; measured 0.125 at D = 128 on the card).  The forward is held
# against both at the unchanged tolerance.
FLASH_BF16_CASES = ((2, 4, 64, 512, False, 1.0), (2, 4, 64, 64, True, 1.0),
                    (1, 16, 64, 1024, True, 8.0),
                    (4, 8, 128, 1024, True, 8.0))
# Phase 11, float32, untimed: q multiplied by 8 at D = 64 and D = 128, where
# dP - di cancels wherever P is nearly one-hot and the 3xTF32 products
# meet their largest scores.  The rule of the bfloat16 cases above: held
# against the twins at FLASH_BWD_TOL float32 with dK's atol times 8 (even
# plain float32 puts dK past the unscaled atol there: a rounding in dS
# moves dK by it times |q|), the xla route's distance measured, not held.
FLASH_F32_CASES = ((1, 16, 64, 1024, True, 8.0),
                   (4, 8, 128, 1024, True, 8.0))

# Phase 10: the LM of bench.py:1705, served at 4 slots.
LM_FLAGS = ["--steps", "0", "--serve", "4", "--vocab", "32768", "--dim",
            "1024", "--depth", "8", "--seqLen", "2048", "--bf16",
            "--device", "cuda"]
LM_CHECK_PROMPT, LM_CHECK_STEPS = 1024, 16
SERVE_REQUESTS, SERVE_THREADS, SERVE_MAX_NEW = 8, 4, 32
SERVE_PROMPTS = (100, 1500)
SERVE_PREFILL_CHUNK = 256
PROFILE_PROMPT = 1000     # one full prefill profiled for B5a's share
# Greedy streams are compared token by token.  Two computations of the same
# logits (other shapes, other summation orders) may pick different argmax
# tokens only where the top two logits nearly tie: a mismatch passes only if
# the token taken scores within this much of the top logit of the
# reference's own logits at that position (teacher forced), and the streams
# are compared up to it.  float32: logits of order 1 carry ~1e-5 of
# rounding difference, so 1e-3.  bfloat16: 4 ulps of a logit of magnitude
# 2 to 4 (one ulp there is 2^-6).
TIE_TOL = {"float32": 1e-3, "bfloat16": 0.0625}

# Phase 11: the flash backward at (B, H, D, L); FLASH_TRAIN is the LM
# training shape of phase 12, the one the kernels line reports (bfloat16).
FLASH_BWD_SHAPES = ((8, 16, 64, 1024), (1, 16, 64, 1024), (2, 4, 32, 512),
                    (4, 8, 128, 1024))
FLASH_TRAIN = (8, 16, 64, 1024)
# float32 (TF32 off) against autograd of the xla route: the reference's
# gradient tolerance (tests/test_sequence.py:61-62).  Against the twins,
# which take the kernels' own o, m, l and make the same roundings, 10x
# tighter: the two differ only in the order of float32 sums (FMA
# contraction and 64-term tile products against cuBLAS's), which the CPU
# emulation and the Pallas comparison put near 1e-6 of gradients of order
# 1-10.  bfloat16: rtol = atol = 2e-2 (tests/test_sequence.py:161-162),
# never looser.
FLASH_BWD_TOL = {"float32": {"twin": (2e-4, 2e-5), "xla": (2e-3, 2e-4)},
                 "bfloat16": {"twin": (2e-2, 2e-2), "xla": (2e-2, 2e-2)}}

# Phase 12: the LM training configuration of bench.py:1690-1713.
LM_TRAIN = dict(vocab=32768, dim=1024, depth=8, heads=16, max_len=1024)
LM_TRAIN_BATCH, LM_TRAIN_LR, LM_TRAIN_STEPS = 8, 1e-2, 20
LM_TIMED_STEPS = 5        # per mode in (e), after 2 untimed steps
# (b) flash against xla in bfloat16 compute: the loss is a float32 mean of
# 8184 NLLs of bfloat16 logits whose roundings differ between the routes
# and average down, so rtol 2e-3 (half a bfloat16 ulp); each leaf's update
# ``p1 - p0 = -lr g`` within 5e-2 of the xla route's in norm (bfloat16
# gradients agree to about 1e-2; the leaf's norm keeps small elements from
# deciding).  (c) remat recomputes with the same deterministic kernels:
# JAX's remat tolerance (tests/test_transformer.py:107-112), rtol 1e-5 and
# atol 1e-7 on params, 1e-6 on the loss.
LM_ROUTE_LOSS_RTOL, LM_ROUTE_UPDATE_TOL = 2e-3, 5e-2
# (f) flash against xla in float32 compute (TF32 off), the reference's
# float32 tolerances for another attention route: the LM loss within rtol
# 1e-4 (tests/test_transformer.py:78, lm_loss over a sequence mesh
# against one device), each leaf's gradient within rtol 2e-3, atol 2e-4
# (tests/test_sequence.py:61-62, ring attention's gradients against local
# attention's), held on the update p1 - p0 = -lr g as rtol 2e-3 and atol
# lr * 2e-4.
LM_F32_LOSS_RTOL = 1e-4
LM_F32_GRAD_TOL = (2e-3, 2e-4)
LM_F32_TIMED_STEPS = 3    # after 1 untimed (the compared step)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def hbm_rate(name: str) -> tuple[float, str]:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate, key
    return HBM_BYTES_PER_S["H100"], "H100 (assumed)"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def free_port_window(n: int) -> int:
    """A base port ``p`` such that ``p .. p+n-1`` were all bindable a moment
    ago (an AsyncEA server binds port .. port+numNodes+1)."""
    for _ in range(256):
        base = free_port()
        if base + n >= 65535:
            continue
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sk.bind(("127.0.0.1", base + i))
                socks.append(sk)
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise SmokeFailure(f"no window of {n} free ports")


def run_threads(*fns):
    """Run ``fns`` as threads of this process; fail on the first error or on
    a role still running after ROLE_TIMEOUT_S."""
    errs = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — reported below
                errs.append(e)
        return run

    threads = [threading.Thread(target=wrap(f), daemon=True) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=ROLE_TIMEOUT_S)
    check(not any(t.is_alive() for t in threads), "an AsyncEA role hung")
    if errs:
        raise SmokeFailure(f"an AsyncEA role failed: {errs[0]!r}") \
            from errs[0]


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | nvidia-smi: {smi_line} | capability "
        f"{torch.cuda.get_device_capability(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log("[device] parity and timing: float32, TF32 off (cudnn and matmul), "
        "cudnn deterministic")
    return name, smi_line


def kernel_label(sym: str) -> str | None:
    """``flash_fwd_mma<bf16, 64>`` or ``flash_bwd_dq_tf32x3<f32, 64>`` from
    a flash kernel's mangled name."""
    m = re.search(r"(flash_(?:fwd|bwd)[a-z0-9_]*?)I(f|13__nv_bfloat16)?"
                  r"Li(\d+)E", sym)
    if m is None:
        return None
    name, t, d = m.groups()
    dtype = "bf16" if name.endswith("_mma") or t == "13__nv_bfloat16" \
        else "f32"
    return f"{name}<{dtype}, {d}>"


def ptxas_report(out: str) -> dict:
    """{kernel label: {"regs": n, "spill": (stores, loads)}} from nvcc's
    ``-Xptxas -v`` output."""
    info, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", line)
        if m:
            cur = kernel_label(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info.setdefault(cur, {})["spill"] = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info.setdefault(cur, {})["regs"] = int(m.group(1))
    return info


def sass_hmma(lib: str) -> dict:
    """{kernel label: HMMA instructions in its SASS} by ``cuobjdump``."""
    from distlearn_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-500:]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        label = kernel_label(part.split(None, 1)[0])
        if label is not None:
            counts[label] = sum("HMMA" in ln for ln in part.splitlines())
    return counts


def sass_loads_before_store(lib: str, key: str) -> dict:
    """{kernel: 128-bit global loads (LDG.E.128, LDG.E.EF.128, ...) before
    its first global store} for the kernels of ``lib`` whose mangled name
    holds ``key``, from ``cuobjdump -sass``."""
    from distlearn_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-500:]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if key not in name:
            continue
        n = 0
        for line in part.splitlines():
            if "STG" in line:
                break
            n += "LDG" in line and ".128" in line
        counts[name] = n
    return counts


def phase_build():
    from distlearn_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}")
    for src, out in logs.items():
        for line in out.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                log(f"[build] {src}: {line.strip()}")
    # every flash kernel runs its products on the tensor cores (the
    # float32 ones in 3xTF32, beside their CUDA-core scores)
    if "flash_attention.cu" in logs:
        info = ptxas_report(logs["flash_attention.cu"])
        log("[build] flash kernels (registers, spill stores/loads bytes): "
            + ", ".join(f"{k} {v.get('regs')} regs, spill "
                        f"{v.get('spill')}" for k, v in sorted(info.items())))
        for label in ("flash_fwd_mma<bf16, 64>",
                      "flash_bwd_dkv_mma<bf16, 64>",
                      "flash_bwd_dq_mma<bf16, 64>",
                      "flash_fwd_tf32x3<f32, 64>",
                      "flash_bwd_dkv_tf32x3<f32, 64>",
                      "flash_bwd_dq_tf32x3<f32, 64>"):
            check(label in info and info[label].get("spill") == (0, 0),
                  f"{label}: ptxas reports spills or no entry: "
                  f"{info.get(label)}")
        log("[build] float32 B5a (flash_fwd_tf32x3): " + ", ".join(
            f"D={d} {info.get(f'flash_fwd_tf32x3<f32, {d}>', {})}"
            for d in (32, 64, 128)))
    # B1's design issues both loads of a thread (a float4 of p and one of
    # g) before its store
    order = sass_loads_before_store(
        str(_build.library_path("fused_update.cu")), "sgd_chunk")
    log(f"[build] B1 (sgd_chunk): 128-bit loads before the first store "
        f"(cuobjdump -sass): {order}")
    check(list(order.values()) == [2],
          f"B1: expected one sgd_chunk kernel with both 128-bit loads "
          f"before its first store, found {order}")
    hmma = sass_hmma(str(_build.library_path("flash_attention.cu")))
    log("[build] HMMA instructions per flash kernel (cuobjdump -sass): "
        + ", ".join(f"{k} {n}" for k, n in sorted(hmma.items())))
    check(len(hmma) == 18, f"expected 18 flash kernels, found {sorted(hmma)}")
    for label, n in hmma.items():
        check(n > 0 and ("_mma<" in label or "_tf32x3<" in label),
              f"{label}: {n} HMMA instructions; every flash kernel, the "
              "bfloat16 (mma) and float32 (3xTF32) B5a, B5b and B5c, runs "
              "its products on tensor cores")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def time_ms(torch, fn, flush, iters=TIMING_ITERS):
    """Median milliseconds of one call of ``fn`` over ``iters`` calls, each
    between two CUDA events, with the L2 cache flushed before each."""
    for _ in range(5):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(torch, fn, flush, iters=TIMING_ITERS):
    """Median milliseconds of one whole call of ``fn`` on the host's clock
    over ``iters`` calls: flush the L2, synchronize, start the clock, call,
    synchronize.  Unlike :func:`time_ms`, the wrapper's host time cannot
    hide behind the flush still running on the card."""
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_kernels(torch, card):
    from distlearn_tpu_torch.ops import fused_update as fu
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda n: torch.randn(n, generator=gen, device=dev)
    lr, alpha = 0.1, EA_ALPHA
    errs = {"fused_sgd": 0.0, "fused_elastic": 0.0}
    for n in (CIFAR_BUCKET, RAGGED) + SGD_SHORT:
        p, g, c = rand(n + 1), rand(n + 1), rand(n + 1)
        # the aligned buckets, and views one element in (no 16-byte
        # alignment: the kernels' scalar path)
        for pv, gv, cv in ((p[:n], g[:n], c[:n]), (p[1:], g[1:], c[1:])):
            before = fu.fused_sgd.launches
            out, ref = fu.fused_sgd(pv, gv, lr), fu.sgd_plain(pv, gv, lr)
            torch.cuda.synchronize()
            check(fu.fused_sgd.launches == before + 1,
                  f"fused_sgd at n={n} launched "
                  f"{fu.fused_sgd.launches - before} kernels, expected 1")
            check(torch.equal(out, ref),
                  f"fused_sgd differs from sgd_plain at n={n}: max abs "
                  f"{max_abs(torch, out, ref)}")
            (np_, d), (rp, rd) = fu.fused_elastic(pv, cv, alpha), \
                fu.elastic_plain(pv, cv, alpha)
            torch.cuda.synchronize()
            check(torch.equal(np_, rp) and torch.equal(d, rd),
                  f"fused_elastic differs from elastic_plain at n={n}: max abs "
                  f"{max(max_abs(torch, np_, rp), max_abs(torch, d, rd))}")
            errs["fused_sgd"] = max(errs["fused_sgd"], max_abs(torch, out, ref))
            errs["fused_elastic"] = max(errs["fused_elastic"],
                                        max_abs(torch, np_, rp),
                                        max_abs(torch, d, rd))
    log(f"[kernels] bitwise equal to the plain versions at n={CIFAR_BUCKET}, "
        f"n={RAGGED} and n in {SGD_SHORT}, aligned and unaligned; B1 one "
        f"launch per call")

    rate, part = hbm_rate(card)
    n = CIFAR_BUCKET
    p, g, c = rand(n), rand(n), rand(n)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = []
    for name, bytes_moved, flops, kern, plain, library, note in (
            ("fused_sgd", 12 * n, 2 * n,
             lambda: fu.fused_sgd(p, g, lr), lambda: fu.sgd_plain(p, g, lr),
             lambda: torch.add(p, g, alpha=-lr), "torch.add(p, g, alpha=-lr)"),
            ("fused_elastic", 16 * n, 2 * n,
             lambda: fu.fused_elastic(p, c, alpha),
             lambda: fu.elastic_plain(p, c, alpha), None,
             "none: no single PyTorch call returns both p' and delta")):
        bound_bytes = bytes_moved / rate * 1e3
        bound_ops = flops / FP32_FLOPS * 1e3
        row = {
            "ms": time_ms(torch, kern, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "library_ms": None if library is None else
            time_ms(torch, library, flush),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "max_abs_err": errs[name],
        }
        log(f"[kernels] {name} n={n}: {row['ms']:.5f} ms | plain "
            f"{row['plain_ms']:.5f} ms | library ({note}) "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 5)} ms"
            f" | bound {row['bound_ms']:.5f} ms ({bytes_moved / 1e6:.1f} MB at "
            f"{rate / 1e12:.2f} TB/s, {part}) | {bytes_moved / row['ms'] / 1e6:.0f} "
            f"GB/s achieved, {row['bound_ms'] / row['ms']:.1%} of bound")
        if name == "fused_sgd":
            # the whole call on the host's clock, beside the library's
            host = (host_ms(torch, kern, flush), host_ms(torch, library, flush))
            log(f"[kernels] fused_sgd whole call on the host clock (flush, "
                f"synchronize, call, synchronize; median of {TIMING_ITERS}): "
                f"{host[0]:.5f} ms | torch.add {host[1]:.5f} ms")
        rows.append((name, row))
    del flush
    return dict(rows)


# ---------------------------------------------------------------------------
# Phase 4-5: the main path
# ---------------------------------------------------------------------------

def reset_counts(fu):
    fu.fused_sgd.launches = 0
    fu.fused_elastic.launches = 0


def max_tree_diff(torch, a, b) -> float:
    from distlearn_tpu_torch.utils.tree import tree_leaves
    return max(max_abs(torch, x, y.to(x.device))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def cifar_batches(torch, n_batches, batch, seed=0):
    from distlearn_tpu_torch.data import synthetic_cifar10
    x, y, _ = synthetic_cifar10(n_batches * batch, seed=seed)
    x = torch.from_numpy(x).cuda()
    y = torch.from_numpy(y).cuda()
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch])
            for i in range(n_batches)]


KERNEL_CLASSES = (            # (class, substrings of a kernel's name)
    ("convolution", ("xmma", "implicit_gemm", "cudnn", "conv", "winograd")),
    ("nccl", ("nccl",)),
    ("fused update", ("sgd_chunk", "elastic_vec4", "elastic_scalar")),
    ("copy/cat", ("CatArrayBatchedCopy", "copy")),
)


def profile_step(torch, run, classes=KERNEL_CLASSES,
                 other="elementwise/reduce"):
    """Run ``run()`` once under torch.profiler and log the device's busy
    time by kernel class (``classes``, the rest ``other``) and the top
    kernels beside the wall time.  A profiler fault is logged and does not
    fail the run.  Returns what ``run()`` returned, the busy and wall
    milliseconds (busy None if not profiled) and ``{class: [busy ms,
    launches]}``."""
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile
    torch.cuda.synchronize()
    try:
        with settled_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             torch.cuda.synchronize) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        log(f"[profile] torch.profiler failed: {exc!r}")
        out = run()
        torch.cuda.synchronize()
        return out, None, None, {}
    kernels = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class: dict[str, list] = {}
    for e in kernels:
        cls = next((c for c, keys in classes
                    if any(k in e.key for k in keys)), other)
        ms_n = by_class.setdefault(cls, [0.0, 0])
        ms_n[0] += e.self_device_time_total / 1e3
        ms_n[1] += e.count
    log(f"[profile] one step: {wall_ms:.3f} ms wall (profiler on), kernels "
        f"busy {busy_ms:.3f} ms, device idle {1 - busy_ms / wall_ms:.1%}; "
        + ", ".join(f"{c} {v[0]:.3f} ms in {v[1]} launches" for c, v in
                    sorted(by_class.items(), key=lambda kv: -kv[1][0])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  "
            f"x{e.count:<4d} {e.key[:100]}")
    return out, busy_ms, wall_ms, by_class


def phase_sgd(torch, tree, cpu_tree):
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.ops import flatten as flatten_lib
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.train import trainer as tr
    check(fu.fused_enabled(None, tree.device), "fused path is off on the card")
    model = cifar_convnet()                       # dropout 0.5
    ts = tr.init_train_state(model, tree, seed=0, num_classes=10)
    n_buckets = len(flatten_lib.make_bucket_spec(ts.params).buckets)
    batches = cifar_batches(torch, SGD_STEPS, SGD_BATCH)
    step = tr.build_sgd_step(model, tree, LR)
    sync = tr.build_sync_step(tree)

    torch.cuda.synchronize()
    reset_counts(fu)
    losses, times = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        ts, loss = step(ts, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    ts = sync(ts)
    torch.cuda.synchronize()
    launches = fu.fused_sgd.launches
    elastic_in_sgd = fu.fused_elastic.launches

    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == SGD_STEPS * n_buckets,
          f"fused_sgd launched {launches} times, expected "
          f"{SGD_STEPS} steps x {n_buckets} buckets")
    check(elastic_in_sgd == 0, "fused_elastic launched on the SGD path")
    check(int(ts.sync.my_steps) == 0, "sync step did not reset the counts")
    check(int(ts.cm.sum()) == SGD_STEPS * SGD_BATCH, "confusion matrix count")
    sps = 1.0 / statistics.median(times[1:])
    log(f"[sgd] {SGD_STEPS} fused steps at batch {SGD_BATCH}: losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; fused_sgd launches {launches} "
        f"({n_buckets} bucket(s)); first step {times[0] * 1e3:.2f} ms, median "
        f"{statistics.median(times[1:]) * 1e3:.3f} ms = {sps:.2f} steps/s")

    # where the time goes: one profiled step
    x, y = batches[0]
    ts, busy_ms, _, _ = profile_step(torch, lambda: step(ts, x, y)[0])
    if busy_ms is not None:
        med_ms = statistics.median(times[1:]) * 1e3
        log(f"[sgd] device idle {1 - busy_ms / med_ms:.1%} of the median "
            f"unprofiled step ({busy_ms:.3f} of {med_ms:.3f} ms busy)")

    # fused against plain, dropout 0, same weights and batches
    model0 = cifar_convnet(dropout_rate=0.0)
    finals = {}
    for fused in (True, False):
        st = tr.init_train_state(model0, tree, seed=1, num_classes=10)
        st_step = tr.build_sgd_step(model0, tree, LR, fused=fused)
        for x, y in batches[:PARITY_STEPS]:
            st, _ = st_step(st, x, y)
        finals[fused] = st.params
    torch.cuda.synchronize()
    diff = max_tree_diff(torch, finals[True], finals[False])
    log(f"[sgd] fused vs plain after {PARITY_STEPS} steps (dropout 0): max "
        f"param diff {diff:.3e} (tolerance {PARITY_TOL:.0e})")
    check(diff <= PARITY_TOL, f"fused and plain SGD differ by {diff}")

    # the card against the port's CPU path on a small batch
    x, y = batches[0]
    x, y = x[:CPU_REF_BATCH], y[:CPU_REF_BATCH]
    outs = []
    for t in (tree, cpu_tree):
        st = tr.init_train_state(model0, t, seed=2, num_classes=10)
        logp, _ = model0.apply(st.params, st.model_state, x.to(t.device),
                               train=True)
        st, _ = tr.build_sgd_step(model0, t, LR)(st, x.to(t.device),
                                                 y.to(t.device))
        outs.append((logp, st.params))
    torch.cuda.synchronize()
    (card_logp, card_params), (cpu_logp, cpu_params) = outs
    dlogp = max_abs(torch, card_logp, cpu_logp.to(card_logp.device))
    dpar = max_tree_diff(torch, card_params, cpu_params)
    log(f"[sgd] card vs CPU path at batch {CPU_REF_BATCH}: log-probs max diff "
        f"{dlogp:.3e} (tol {CPU_REF_LOGP_TOL:.0e}), params after one step "
        f"{dpar:.3e} (tol {CPU_REF_PARAM_TOL:.0e})")
    check(dlogp <= CPU_REF_LOGP_TOL and dpar <= CPU_REF_PARAM_TOL,
          "the card disagrees with the CPU path")
    return {"launches": launches, "steps_per_s": sps, "buckets": n_buckets}


def phase_ea(torch, tree):
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.ops import flatten as flatten_lib
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.train import trainer as tr
    batches = cifar_batches(torch, EA_TAU * EA_CYCLES, SGD_BATCH, seed=1)

    def run(model, fused, seed):
        ets = tr.init_ea_state(model, tree, seed=seed, num_classes=10)
        local, rnd = tr.build_ea_steps(model, tree, LR, EA_ALPHA, fused=fused)
        losses, local_t, round_t = [], [], []
        for cycle in range(EA_CYCLES):
            for x, y in batches[cycle * EA_TAU:(cycle + 1) * EA_TAU]:
                t0 = time.perf_counter()
                ets, loss = local(ets, x, y)
                torch.cuda.synchronize()
                local_t.append(time.perf_counter() - t0)
                losses.append(float(loss))
            t0 = time.perf_counter()
            ets = rnd(ets)
            torch.cuda.synchronize()
            round_t.append(time.perf_counter() - t0)
        return ets, losses, local_t, round_t

    model = cifar_convnet()                       # dropout 0.5
    n_buckets = len(flatten_lib.make_bucket_spec(
        tr.init_ea_state(model, tree, 0, 10).params).buckets)
    torch.cuda.synchronize()
    reset_counts(fu)
    ets, losses, local_t, round_t = run(model, None, 0)
    launches = fu.fused_elastic.launches
    check(all(math.isfinite(v) for v in losses), f"non-finite EA loss {losses}")
    check(launches == EA_CYCLES * n_buckets,
          f"fused_elastic launched {launches} times, expected "
          f"{EA_CYCLES} rounds x {n_buckets} buckets")
    check(fu.fused_sgd.launches == 0, "fused_sgd launched on the EA path")
    log(f"[ea] {EA_CYCLES} cycles of tau={EA_TAU}, alpha={EA_ALPHA}: losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; fused_elastic launches "
        f"{launches}; local step median {statistics.median(local_t) * 1e3:.3f}"
        f" ms, round {statistics.median(round_t) * 1e3:.3f} ms")

    model0 = cifar_convnet(dropout_rate=0.0)
    fused_ets = run(model0, True, 3)[0]
    plain_ets = run(model0, False, 3)[0]
    dp = max_tree_diff(torch, fused_ets.params, plain_ets.params)
    dc = max_tree_diff(torch, fused_ets.center, plain_ets.center)
    log(f"[ea] fused vs plain (dropout 0): max param diff {dp:.3e}, center "
        f"{dc:.3e} (tolerance {PARITY_TOL:.0e})")
    check(max(dp, dc) <= PARITY_TOL, f"fused and plain EA differ by {dp}, {dc}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phases 5a-5b: the scanned steps as CUDA graphs
# ---------------------------------------------------------------------------

def stack_batches(torch, batches):
    return (torch.stack([x for x, _ in batches]),
            torch.stack([y for _, y in batches]))


def trees_equal(torch, a, b) -> bool:
    from distlearn_tpu_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def device_events(prof) -> list:
    """A profile's device rows, less the device side of ``record_function``
    ranges (the port's spans, such as ``train.step``), which would count
    the kernels under them a second time."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_replay(torch, fn) -> dict:
    """One profiled, synchronised ``fn()``: its device kernels by name with
    their counts, the busy and wall milliseconds; and the CUDA runtime calls
    of another ``fn()`` by name (graph launches among them), less the
    profiler's own."""
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile
    torch.cuda.synchronize()
    with settled_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         torch.cuda.synchronize) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    kernels = {e.key: e.count for e in events}
    busy = sum(e.self_device_time_total for e in events) / 1e3
    return {"kernels": kernels, "busy_ms": busy, "wall_ms": wall_ms,
            "calls": runtime_calls(torch, fn)}


def kernel_count(kernels: dict, sub: str) -> int:
    return sum(n for k, n in kernels.items() if sub in k)


def steps_per_s(torch, run_window, steps, windows=GRAPH_WINDOWS) -> float:
    """Median over ``windows`` of ``steps`` over a window's host time; each
    window ends in a synchronize."""
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_window()
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t0))
    return statistics.median(rates)


def phase_graph_sgd(torch, tree):
    """K AllReduceSGD steps a replay against the eager steps, bit for bit;
    B1 and the graph launch in a profiled replay; steps/s eager against
    graph, and the graph fed by DeviceDataset index vectors."""
    from distlearn_tpu_torch.data import DeviceDataset, synthetic_cifar10
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.ops import flatten as flatten_lib
    from distlearn_tpu_torch.train import trainer as tr
    K = GRAPH_K
    batches = cifar_batches(torch, K * GRAPH_REPLAYS, SGD_BATCH, seed=2)
    groups = [stack_batches(torch, batches[i * K:(i + 1) * K])
              for i in range(GRAPH_REPLAYS)]
    out = {}
    for rate in (0.0, 0.5):
        model = cifar_convnet(dropout_rate=rate)
        ts_e = tr.init_train_state(model, tree, seed=4, num_classes=10)
        step = tr.build_sgd_step(model, tree, LR)
        eager = []
        for x, y in batches:
            ts_e, loss = step(ts_e, x, y)
            eager.append(loss)
        ts_g = tr.init_train_state(model, tree, seed=4, num_classes=10)
        scan = tr.build_sgd_scan_step(model, tree, LR)
        graph = []
        for xs, ys in groups:
            ts_g, losses = scan(ts_g, xs, ys)
            graph.append(losses)
        torch.cuda.synchronize()
        check(len(scan.captures) == 1, f"{len(scan.captures)} captures for "
              "one K")
        same = {"params": trees_equal(torch, ts_g.params, ts_e.params),
                "batchnorm stats": trees_equal(torch, ts_g.model_state,
                                               ts_e.model_state),
                "confusion matrix": torch.equal(ts_g.cm, ts_e.cm),
                "step count": torch.equal(ts_g.sync.my_steps,
                                          ts_e.sync.my_steps),
                "losses": torch.equal(torch.cat(graph), torch.stack(eager))}
        log(f"[graph] sgd dropout {rate}: {GRAPH_REPLAYS} replays of K={K} "
            f"against {K * GRAPH_REPLAYS} eager steps at batch {SGD_BATCH}: "
            + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                        for k, v in same.items())
            + f"; losses {float(eager[0]):.4f} -> {float(eager[-1]):.4f}")
        check(all(same.values()), f"graph SGD (dropout {rate}) differs from "
              f"the eager steps: {same}")
        out[rate] = (model, scan, ts_g)

    # one profiled replay: B1 K times, one graph launch
    model, scan, ts_g = out[0.5]
    n_buckets = len(flatten_lib.make_bucket_spec(ts_g.params).buckets)
    xs, ys = groups[0]
    prof = profile_replay(torch, lambda: scan(ts_g, xs, ys))
    b1 = kernel_count(prof["kernels"], "sgd_chunk")
    launches = prof["calls"].get("cudaGraphLaunch", 0)
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    log(f"[graph] profiled replay: {len(prof['kernels'])} kernel kinds, B1 "
        f"(sgd_chunk) {b1} launches, cudaGraphLaunch {launches}, device busy "
        f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms (idle "
        f"{idle:.1%}); runtime calls "
        + ", ".join(f"{k} {n}" for k, n in sorted(prof["calls"].items())))
    check(b1 == K * n_buckets, f"a replay ran B1 {b1} times, expected "
          f"{K} steps x {n_buckets} bucket(s)")
    check(launches == 1, f"a replay made {launches} cudaGraphLaunch calls")

    # with_contrib: flags [1, 0, 1, 1] against four eager calls
    flags = torch.tensor(GRAPH_FLAGS, dtype=torch.int32, device="cuda")
    ts_e = tr.init_train_state(model, tree, seed=5, num_classes=10)
    step = tr.build_sgd_step(model, tree, LR, with_contrib=True)
    eager = []
    for (x, y), c in zip(batches[:K], flags):
        ts_e, loss = step(ts_e, x, y, c)
        eager.append(loss)
    scan_c = tr.build_sgd_scan_step(model, tree, LR, with_contrib=True)
    ts_c, losses = scan_c(tr.init_train_state(model, tree, seed=5,
                                              num_classes=10), xs, ys, flags)
    torch.cuda.synchronize()
    ok = (trees_equal(torch, ts_c.params, ts_e.params)
          and trees_equal(torch, ts_c.model_state, ts_e.model_state)
          and torch.equal(ts_c.cm, ts_e.cm)
          and torch.equal(losses, torch.stack(eager))
          and int(ts_c.sync.my_steps) == sum(GRAPH_FLAGS))
    log(f"[graph] with_contrib flags {list(GRAPH_FLAGS)}: one replay against "
        f"{K} eager calls {'bit for bit' if ok else 'DIFFER'}; step count "
        f"{int(ts_c.sync.my_steps)}")
    check(ok, "the with_contrib replay differs from its eager calls")

    # a state from another init, with its own generator, through the scan
    # captured above: the generator's state is copied into the registered
    # one, and the replay still equals the eager steps at dropout 0.5
    ts_e = tr.init_train_state(model, tree, seed=9, num_classes=10)
    step = tr.build_sgd_step(model, tree, LR)
    eager = []
    for x, y in batches[:K]:
        ts_e, loss = step(ts_e, x, y)
        eager.append(loss)
    ts_f, losses = scan(tr.init_train_state(model, tree, seed=9,
                                            num_classes=10), xs, ys)
    torch.cuda.synchronize()
    ok = (len(scan.captures) == 1
          and trees_equal(torch, ts_f.params, ts_e.params)
          and trees_equal(torch, ts_f.model_state, ts_e.model_state)
          and torch.equal(ts_f.cm, ts_e.cm)
          and torch.equal(losses, torch.stack(eager)))
    log(f"[graph] a fresh seed-9 state with its own generator through the "
        f"dropout-0.5 capture: one replay against {K} eager steps "
        f"{'bit for bit' if ok else 'DIFFER'}")
    check(ok, "a replay of a state carrying another generator differs from "
          "its eager steps")

    # steps/s on the host clock, eager against graph, from one call
    step = tr.build_sgd_step(model, tree, LR)
    box = {"e": tr.init_train_state(model, tree, seed=6, num_classes=10),
           "g": ts_g}

    def eager_window():
        for x, y in batches:
            box["e"] = step(box["e"], x, y)[0]

    def graph_window():
        for gx, gy in groups:
            box["g"] = scan(box["g"], gx, gy)[0]

    x_all, y_all, _ = synthetic_cifar10(4096, seed=7)
    dds = DeviceDataset(x_all, y_all, 10, device=tree.device)
    scan_d = tr.build_sgd_scan_step(model, tree, LR, dataset=dds)
    idx = [torch.randint(0, 4096, (K, SGD_BATCH), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(i))
           .numpy() for i in range(GRAPH_REPLAYS)]
    box["d"] = tr.init_train_state(model, tree, seed=6, num_classes=10)
    box["d"] = scan_d(box["d"], idx[0])[0]          # capture

    def dataset_window():
        for ix in idx:
            box["d"] = scan_d(box["d"], ix)[0]

    eager_window()                                  # warm
    steps = K * GRAPH_REPLAYS
    rates = {"eager": steps_per_s(torch, eager_window, steps),
             "graph": steps_per_s(torch, graph_window, steps),
             "graph_device_data": steps_per_s(torch, dataset_window, steps)}
    log(f"[graph] steps/s at batch {SGD_BATCH} (host clock, median of "
        f"{GRAPH_WINDOWS} windows of {steps} steps, each ending in a "
        f"synchronize): eager {rates['eager']:.2f}, graph K={K} "
        f"{rates['graph']:.2f}, graph fed by DeviceDataset index vectors "
        f"{rates['graph_device_data']:.2f}; one replay's device idle "
        f"{idle:.1%}")
    return {"b1_per_replay": b1, "idle": idle, **rates}


def phase_graph_ea(torch, tree):
    """The EASGD cycle a replay against tau local steps and the round, bit
    for bit; B2 once a replay."""
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.ops import flatten as flatten_lib
    from distlearn_tpu_torch.train import trainer as tr
    from distlearn_tpu_torch.utils.tree import tree_map
    batches = cifar_batches(torch, EA_TAU * EA_CYCLES, SGD_BATCH, seed=3)
    model = cifar_convnet()                       # dropout 0.5

    def start():
        ets = tr.init_ea_state(model, tree, seed=8, num_classes=10)
        return ets._replace(center=tree_map(lambda c: c * 0.99, ets.center))

    local, rnd = tr.build_ea_steps(model, tree, LR, EA_ALPHA)
    cycle = tr.build_ea_cycle(model, tree, LR, EA_ALPHA)
    ets_e, ets_g = start(), start()
    for c in range(EA_CYCLES):
        group = batches[c * EA_TAU:(c + 1) * EA_TAU]
        eager = []
        for x, y in group:
            ets_e, loss = local(ets_e, x, y)
            eager.append(loss)
        ets_e = rnd(ets_e)
        ets_g, losses = cycle(ets_g, *stack_batches(torch, group))
        torch.cuda.synchronize()
        same = {f: trees_equal(torch, getattr(ets_g, f), getattr(ets_e, f))
                for f in ("params", "center", "model_state")}
        same["confusion matrix"] = torch.equal(ets_g.cm, ets_e.cm)
        same["losses"] = torch.equal(losses, torch.stack(eager))
        log(f"[graph] ea cycle {c + 1} (tau {EA_TAU}, alpha {EA_ALPHA}): "
            + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                        for k, v in same.items()))
        check(all(same.values()), f"EA cycle {c + 1} differs from the eager "
              f"steps: {same}")
    n_buckets = len(flatten_lib.make_bucket_spec(ets_g.params).buckets)
    xs, ys = stack_batches(torch, batches[:EA_TAU])
    prof = profile_replay(torch, lambda: cycle(ets_g, xs, ys))
    b2 = kernel_count(prof["kernels"], "elastic")
    launches = prof["calls"].get("cudaGraphLaunch", 0)
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    log(f"[graph] profiled EA replay: B2 (elastic) {b2} launches, "
        f"cudaGraphLaunch {launches}, device busy {prof['busy_ms']:.3f} of "
        f"{prof['wall_ms']:.3f} ms (idle {idle:.1%})")
    check(b2 == n_buckets, f"an EA replay ran B2 {b2} times, expected one "
          f"per bucket ({n_buckets})")
    check(launches == 1, f"an EA replay made {launches} cudaGraphLaunch "
          "calls")
    return {"b2_per_replay": b2, "idle": idle}


# ---------------------------------------------------------------------------
# Phase 6: the AsyncEA wire codec kernels (B3, B4)
# ---------------------------------------------------------------------------

def convnet_shapes() -> list[tuple]:
    """The full-width convnet's 18 parameter shapes, in wire order."""
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.utils.tree import tree_leaves
    return [tuple(p.shape) for p in
            tree_leaves(cifar_convnet().init(0, device="cpu")[0])]


def b3_inputs(torch, gen, dev, sizes, poison=None, bad=float("nan")):
    """B3's inputs on the card: float32 leaves of ``sizes`` (leaf
    ``poison`` holding ``bad`` at its last element), and a maker of fresh
    outputs: q windows cut from one byte frame at the offsets a packed
    frame gives them (the first at byte 1: none 4-byte aligned by design)
    and r leaves, both filled with sentinels a pass must not touch where
    it does not write."""
    xs = [torch.randn(n, generator=gen, device=dev) * 3 for n in sizes]
    if poison is not None:
        xs[poison][-1] = bad
    offs = [1 + sum(sizes[:i]) for i in range(len(sizes))]

    def outputs():
        frame = torch.full((sum(sizes) + 1,), B3_SENTINEL_Q, dtype=torch.int8,
                           device=dev)
        qs = [frame[o:o + n] for o, n in zip(offs, sizes)]
        rs = [torch.full((n,), B3_SENTINEL_R, device=dev) for n in sizes]
        return frame, qs, rs
    return xs, outputs


def bits_equal(torch, a, b) -> bool:
    """Bit for bit (-0.0 is not 0.0, a NaN equals its own bits)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def runtime_calls(torch, fn) -> dict:
    """{CUDA runtime call: count} that ``fn`` makes, from torch.profiler:
    the calls of a profiled ``fn`` less those of a profiled no-op (the
    profiler's own, such as its closing device synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    def calls(f):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
        return {e.key: e.count for e in prof.key_averages()
                if e.key.startswith("cuda")}
    base, got = calls(lambda: None), calls(fn)
    return {k: n - base.get(k, 0) for k, n in got.items()
            if n != base.get(k, 0)}


def phase_wire_kernels(torch, card):
    from distlearn_tpu_torch.comm import wire
    from distlearn_tpu_torch.ops import wire_kernels as wk
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = convnet_shapes()
    sizes = [math.prod(sh) for sh in shapes]
    check(len(sizes) == CONVNET_LEAVES and sum(sizes) == CONVNET_PARAMS
          and max(sizes) == CONV4, f"unexpected convnet leaves {sizes}")
    errs = {"quantize_ef": 0.0, "dequant_add": 0.0}
    lib_equal = True
    for n in sizes + [RAGGED_LEAF]:
        d = torch.randn(n + 1, generator=gen, device=dev) * 3
        c = torch.randn(n + 1, generator=gen, device=dev)
        qin = torch.randint(-127, 128, (n + 1,), generator=gen, device=dev,
                            dtype=torch.int8)
        cases = [(d[:n], c[:n], qin[:n], None, None)]
        if n == RAGGED_LEAF:       # every pointer off its vector alignment
            cases.append((d[1:], c[1:], qin[1:],
                          torch.empty(n + 1, dtype=torch.int8,
                                      device=dev)[1:],
                          torch.empty(n + 1, device=dev)[1:]))
        for dv, cv, qv, q_out, r_out in cases:
            amax = wk.amax_cuda([dv])[0]
            check(amax == wk.amax_plain(dv),
                  f"amax_cuda differs from amax_plain at n={n}")
            calls = (wk.quantize_ef_cuda.launches,
                     wk.dequant_add_cuda.launches)
            if q_out is None:
                q, s, r = wk.quantize_ef_cuda(dv)
            else:
                q, s, r = wk.quantize_ef_cuda(dv, q=q_out, r=r_out)
            q0, s0, r0 = wk.quantize_ef_plain(dv)
            torch.cuda.synchronize()
            check(s == s0 and torch.equal(q, q0) and torch.equal(r, r0),
                  f"quantize_ef_cuda differs from quantize_ef_plain at n={n}"
                  f": scale {s} vs {s0}, q max abs "
                  f"{max_abs(torch, q, q0)}, r max abs {max_abs(torch, r, r0)}")
            o = wk.dequant_add_cuda(cv, qv, s)
            check((wk.quantize_ef_cuda.launches, wk.dequant_add_cuda.launches)
                  == (calls[0] + 1, calls[1] + 1),
                  f"one quantize_ef_cuda and one dequant_add_cuda call at "
                  f"n={n} launched {wk.quantize_ef_cuda.launches - calls[0]} "
                  f"and {wk.dequant_add_cuda.launches - calls[1]} kernels")
            o0 = wk.dequant_add_plain(cv, qv, s)
            inplace = cv.clone()
            wk.dequant_add_cuda(inplace, qv, s, out=inplace)
            lib = torch.add(cv, qv, alpha=s)
            torch.cuda.synchronize()
            check(torch.equal(o, o0) and torch.equal(inplace, o0),
                  f"dequant_add_cuda differs from dequant_add_plain at n={n}:"
                  f" max abs {max_abs(torch, o, o0)}")
            lib_equal = lib_equal and torch.equal(lib, o0)
            errs["quantize_ef"] = max(errs["quantize_ef"],
                                      max_abs(torch, q, q0),
                                      max_abs(torch, r, r0))
            errs["dequant_add"] = max(errs["dequant_add"],
                                      max_abs(torch, o, o0))
    log(f"[wire] B3 (amax + quantize_ef, one leaf) and B4 (dequant_add) "
        f"bitwise equal to their plain versions at the {len(sizes)} convnet "
        f"leaf sizes and n={RAGGED_LEAF}, aligned and unaligned, one kernel "
        f"launch per call of each; torch.add(c, q, alpha=s) "
        f"{'is' if lib_equal else 'is NOT'} bitwise equal to B4")

    # B4 over a list of leaves, as the server applies a delta: the 18 leaves
    # and the ragged one with q cut from one byte frame at the offsets a
    # packed frame gives them (the first at byte 1), in one launch; then
    # more leaves than one table holds, one launch per table
    for leaf_sizes in (sizes + [RAGGED_LEAF],
                       (sizes + [RAGGED_LEAF, 1, 3]) * 7):
        frame = torch.randint(-127, 128, (sum(leaf_sizes) + 1,),
                              generator=gen, device=dev, dtype=torch.int8)
        offs = [1 + sum(leaf_sizes[:i]) for i in range(len(leaf_sizes))]
        qs = [frame[o:o + n] for o, n in zip(offs, leaf_sizes)]
        cs = [torch.randn(n, generator=gen, device=dev) for n in leaf_sizes]
        scales = [0.5 ** (i % 9) / 127.0 for i in range(len(leaf_sizes))]
        want = wk.dequant_add_leaves_plain(cs, qs, scales)
        before = wk.dequant_add_leaves_cuda.launches
        got = wk.dequant_add_leaves_cuda(cs, qs, scales)
        launches = wk.dequant_add_leaves_cuda.launches - before
        wk.dequant_add_leaves_cuda(cs, qs, scales, outs=cs)     # in place
        torch.cuda.synchronize()
        tables = -(-len(leaf_sizes) // wk.LEAF_CAPACITY)
        check(launches == tables, f"dequant_add_leaves_cuda over "
              f"{len(leaf_sizes)} leaves launched {launches} kernels, "
              f"expected {tables}")
        err = max(max_abs(torch, g, w) for g, w in zip(got, want))
        check(all(torch.equal(g, w) and torch.equal(c, w)
                  for g, w, c in zip(got, want, cs)),
              f"dequant_add_leaves_cuda differs from dequant_add_leaves_plain"
              f" over {len(leaf_sizes)} leaves: max abs {err}")
        errs["dequant_add"] = max(errs["dequant_add"], err)
        log(f"[wire] B4 over {len(leaf_sizes)} leaves (q at unaligned "
            f"offsets of one byte frame), copied and in place: bitwise equal "
            f"to dequant_add_leaves_plain, {launches} launch(es) per call "
            f"(table capacity {wk.LEAF_CAPACITY})")
        del frame, qs, cs, want, got

    # B3 over a list of leaves, as the client encodes a delta: the 18
    # leaves and the ragged one, then more leaves than one table holds (a
    # zero leaf and short ones among them), q written into windows of one
    # byte frame at unaligned offsets; one amax and one quantize launch per
    # table, the scale computed on the card; then a NaN in leaf 10 of the
    # 147 (the first table: the guard must stop every later table's blocks
    # too), and a NaN, +inf or -inf in leaf 5 of the 18
    for leaf_sizes, poison, bad in (
            (sizes + [RAGGED_LEAF], None, None),
            ((sizes + [RAGGED_LEAF, 1, 3]) * 7, None, None),
            ((sizes + [RAGGED_LEAF, 1, 3]) * 7, 10, float("nan")),
            (sizes, 5, float("nan")), (sizes, 5, float("inf")),
            (sizes, 5, float("-inf"))):
        xs, outputs = b3_inputs(torch, gen, dev, leaf_sizes, poison, bad)
        if poison is None and len(leaf_sizes) > wk.LEAF_CAPACITY:
            xs[3].zero_()
            xs[3][::2] = -0.0
        (frame, qs, rs), (tframe, tqs, trs) = outputs(), outputs()
        before = (wk.amax_leaves_cuda.launches,
                  wk.quantize_ef_leaves_cuda.launches)
        _, slots, _ = wk.quantize_ef_leaves_cuda(xs, qs, rs)
        launches = (wk.amax_leaves_cuda.launches - before[0],
                    wk.quantize_ef_leaves_cuda.launches - before[1])
        amaxes = wk.quantize_ef_leaves_plain(xs, tqs, trs)
        torch.cuda.synchronize()
        slots = slots.cpu()
        tables = -(-len(leaf_sizes) // wk.LEAF_CAPACITY)
        what = (f"B3 over {len(leaf_sizes)} leaves" + (
            "" if poison is None else f" with {bad} in leaf {poison}"))
        check(launches == (tables, tables),
              f"{what}: (amax, quantize) launches {launches}, expected "
              f"{tables} of each")
        check(torch.equal(slots, wk.amax_bits_plain(xs)),
              f"{what}: amax slots differ from amax_bits_plain")
        check(wk.first_nonfinite(slots) == wk.first_nonfinite(amaxes) ==
              (len(leaf_sizes) if poison is None else poison),
              f"{what}: first non-finite leaf {wk.first_nonfinite(slots)}")
        check(torch.equal(frame, tframe) and all(
            bits_equal(torch, r, t) for r, t in zip(rs, trs)),
            f"{what}: q or r differ from quantize_ef_leaves_plain: max abs "
            f"{max(max_abs(torch, r, t) for r, t in zip(rs, trs))}")
        if poison is None:
            check(wk.scales_of(slots) == wk.scales_of(amaxes),
                  f"{what}: scales differ from the plain route's")
            errs["quantize_ef"] = max(
                errs["quantize_ef"], max_abs(torch, frame, tframe),
                max(max_abs(torch, r, t) for r, t in zip(rs, trs)))
        else:
            check(all((q == B3_SENTINEL_Q).all() and (r == B3_SENTINEL_R)
                      .all() for q, r in zip(qs[poison:], rs[poison:])),
                  f"{what}: a leaf from {poison} on was written")
            try:
                wk.scales_of(slots)
            except ValueError:
                pass
            else:
                raise SmokeFailure(f"{what}: the host took the scales")
        log(f"[wire] {what}, q at unaligned offsets of one byte frame: q, r "
            f"and the amax slots bitwise equal to quantize_ef_leaves_plain; "
            f"(amax, quantize) launches {launches}" + (
                "" if poison is None else
                f"; leaves {poison}-{len(leaf_sizes) - 1} untouched, the "
                "scales raise ValueError"))
        del xs, frame, qs, rs, tframe, tqs, trs

    # the client's encode on the card against the port's CPU route: the
    # manifest's bytes, the frame and the residuals bit for bit; one
    # synchronize and two B3 launches an encode; with a poisoned leaf 5,
    # both raise and leave the same residuals
    leaves = [torch.randn(sh, generator=gen, device=dev) * 0.01
              for sh in shapes] + [torch.arange(17, dtype=torch.int32,
                                                device=dev)]
    held = [torch.full(x.shape, B3_SENTINEL_R, device=dev) for x in leaves]
    fb = wire.FrameBuffer(pinned=True)
    res = [h.clone() for h in held]
    wk.encode_ef_into(leaves, res, "int8", out=fb)    # allocates the stage
    reset_wire_counts(wk)
    calls = runtime_calls(torch, lambda: wk.encode_ef_into(leaves, res, "int8",
                                                           out=fb))
    launches = (wk.amax_leaves_cuda.launches,
                wk.quantize_ef_leaves_cuda.launches)
    syncs = sum(n for k, n in calls.items() if "Synchronize" in k or (
        k.startswith("cudaMemcpy") and "Async" not in k))
    log(f"[wire] one encode of the 18 leaves and a raw one: (amax, quantize) "
        f"launches {launches}; CUDA runtime calls (torch.profiler): "
        + ", ".join(f"{k} {n}" for k, n in sorted(calls.items())))
    check(launches == (1, 1), f"an encode launched (amax, quantize) "
          f"{launches}, expected one of each")
    check(calls, "torch.profiler recorded no CUDA runtime call")
    check(syncs == 1, f"an encode synchronized {syncs} times, expected once")
    for poison in (None, 5):
        xs = [x.clone() for x in leaves]
        if poison is not None:
            xs[poison][-1] = float("nan")
        out = {}
        for route in ("card", "cpu"):
            tx = xs if route == "card" else [x.cpu() for x in xs]
            rr = [h.clone() if route == "card" else h.cpu() for h in held]
            try:
                payload = wk.encode_ef_into(tx, rr, "int8", out=(
                    wire.FrameBuffer(pinned=True) if route == "card" else None))
                out[route] = (json.dumps(payload.manifest),
                              bytes(payload.frame), [r.cpu() for r in rr])
            except ValueError:
                out[route] = (None, None, [r.cpu() for r in rr])
        (m_card, f_card, r_card), (m_cpu, f_cpu, r_cpu) = \
            out["card"], out["cpu"]
        check(m_card == m_cpu and f_card == f_cpu and all(
            bits_equal(torch, a, b) for a, b in zip(r_card, r_cpu)),
            "encode_ef_into on the card differs from the CPU route" + (
                "" if poison is None else f" with a NaN in leaf {poison}"))
        check((m_card is None) == (poison is not None),
              f"encode_ef_into with poison {poison}: raised "
              f"{m_card is None}")
    log("[wire] encode_ef_into of the 18 leaves and a raw one on the card: "
        "the manifest's bytes, the frame and the residuals equal the CPU "
        "route's; with a NaN in leaf 5 both raise ValueError and leave the "
        f"same residuals (leaves 0-4 encoded); {syncs} synchronize an encode")

    x = torch.ones(CONV4, device=dev)
    for bad in (float("nan"), float("inf"), float("-inf")):
        x[-1] = bad
        q = torch.full((CONV4,), B3_SENTINEL_Q, dtype=torch.int8, device=dev)
        r = torch.full((CONV4,), B3_SENTINEL_R, device=dev)
        try:
            wk.quantize_ef_cuda(x, q=q, r=r)
        except ValueError:
            check(bool((q == B3_SENTINEL_Q).all() and (r == B3_SENTINEL_R)
                       .all()), f"quantize_ef_cuda wrote a leaf holding {bad}")
            continue
        raise SmokeFailure(f"quantize_ef_cuda accepted a {bad} at the last "
                           f"element of a {CONV4}-element leaf")
    zero = torch.zeros(CONV4, device=dev)
    zero[::3] = -0.0
    q, s, r = wk.quantize_ef_cuda(zero)
    torch.cuda.synchronize()
    check(s == 0.0 and not q.any() and bits_equal(torch, r, zero),
          "a zero leaf: q not 0 or r not the leaf bit for bit")
    log("[wire] nan, +inf and -inf at the last element raise ValueError and "
        "write nothing; a zero leaf gives q = 0 and r = x bit for bit "
        "(-0.0 kept)")

    # times: the whole 18-leaf delta (what a sync encodes and applies) and
    # the conv4 leaf alone
    rate, part = hbm_rate(card)
    leaves = [torch.randn(sh, generator=gen, device=dev) * 0.01
              for sh in shapes]
    centers = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    qs = [torch.empty(sh, dtype=torch.int8, device=dev) for sh in shapes]
    rs = [torch.empty(sh, device=dev) for sh in shapes]
    scales = wk.scales_of(wk.quantize_ef_leaves_cuda(leaves, qs, rs)[1].cpu())
    big = sizes.index(CONV4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def b3(idx):    # one call over the leaves and the scales' read back
        _, slots, _ = wk.quantize_ef_leaves_cuda(
            [leaves[i] for i in idx], [qs[i] for i in idx],
            [rs[i] for i in idx])
        wk.scales_of(slots.cpu())

    def b3_plain(idx):
        wk.quantize_ef_leaves_plain([leaves[i] for i in idx],
                                    [qs[i] for i in idx],
                                    [rs[i] for i in idx])

    def b4(idx):    # one call over the leaves, as the server's apply
        cl = [centers[i] for i in idx]
        wk.dequant_add_leaves_cuda(cl, [qs[i] for i in idx],
                                   [scales[i] for i in idx], outs=cl)

    def b4_plain(idx):
        wk.dequant_add_leaves_plain([centers[i] for i in idx],
                                    [qs[i] for i in idx],
                                    [scales[i] for i in idx])

    def b4_lib(idx):    # the yardstick: one torch.add a leaf, not bitwise
        for i in idx:
            torch.add(centers[i], qs[i], alpha=scales[i])

    rows = {}
    for name, per_elem_bytes, per_elem_ops, kern, plain, library, note in (
            # B3 reads d and writes q and r: 9 bytes (this design reads d
            # twice, amax then quantize, which the bound does not count)
            ("quantize_ef", 9, 6, b3, b3_plain, None,
             "none: no PyTorch call quantizes with error feedback"),
            ("dequant_add", 9, 2, b4, b4_plain, b4_lib,
             "torch.add(c, q, alpha=s) a leaf")):
        for label, idx in (("whole delta", list(range(len(shapes)))),
                           ("conv4", [big])):
            n = sum(sizes[i] for i in idx)
            bound_bytes = per_elem_bytes * n / rate * 1e3
            bound_ops = per_elem_ops * n / FP32_FLOPS * 1e3
            row = {
                "ms": time_ms(torch, lambda: kern(idx), flush),
                "plain_ms": time_ms(torch, lambda: plain(idx), flush),
                "library_ms": None if library is None else
                time_ms(torch, lambda: library(idx), flush),
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": "bytes" if bound_bytes >= bound_ops
                else "operations",
                "max_abs_err": errs[name],
            }
            lib_txt = "null" if row["library_ms"] is None \
                else f"{row['library_ms']:.5f}"
            log(f"[wire] {name} {label} (n={n}, {len(idx)} leaves): "
                f"{row['ms']:.5f} ms | plain {row['plain_ms']:.5f} ms | "
                f"library ({note}) {lib_txt} ms | bound {row['bound_ms']:.5f}"
                f" ms ({per_elem_bytes * n / 1e6:.1f} MB at "
                f"{rate / 1e12:.2f} TB/s, {part}) | {row['bound_ms'] / row['ms']:.1%}"
                " of bound")
            if label == "whole delta":
                rows[name] = row
                host = host_ms(torch, lambda: kern(idx), flush)
                lib_host = "" if library is None else (
                    f" | library {host_ms(torch, lambda: library(idx), flush):.5f} ms")
                log(f"[wire] {name} whole delta on the host clock (flush, "
                    f"synchronize, call, synchronize; median of "
                    f"{TIMING_ITERS}): {host:.5f} ms{lib_host}")
                log(f"[wire] {name} whole delta: kernels busy "
                    f"{device_ms(torch, lambda: kern(idx)):.5f} ms per call "
                    "(torch.profiler, device time of this file's kernels "
                    "only, L2 warm: the calls repeat unflushed); the rest of "
                    "the call is host time between launches")
    del flush
    return rows


WIRE_KERNEL_NAMES = ("amax_leaves", "quant_ef_leaves", "dequant_add")


def device_ms(torch, fn, calls=10):
    """Device milliseconds per call of ``fn`` spent in the wire codec's
    kernels, from torch.profiler (NaN if the profiler fails)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile
    torch.cuda.synchronize()
    try:
        with settled_profile([ProfilerActivity.CUDA],
                             torch.cuda.synchronize) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:
        log(f"[profile] torch.profiler failed: {exc!r}")
        return float("nan")
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in WIRE_KERNEL_NAMES)) / 1e3 / calls


# ---------------------------------------------------------------------------
# Phase 7-8: the AsyncEA path
# ---------------------------------------------------------------------------

def reset_wire_counts(wk):
    for fn in (wk.amax_cuda, wk.amax_leaves_cuda, wk.quantize_ef_cuda,
               wk.quantize_ef_leaves_cuda, wk.dequant_add_cuda,
               wk.dequant_add_leaves_cuda):
        fn.launches = 0


def b3_launches(wk) -> tuple[int, int]:
    """B3's (amax, quantize) launches on the client's path (the list
    wrappers'); a launch of a one-leaf wrapper there fails the run."""
    check(wk.amax_cuda.launches == wk.quantize_ef_cuda.launches == 0,
          "the client encoded a leaf through a one-leaf B3 wrapper")
    return wk.amax_leaves_cuda.launches, wk.quantize_ef_leaves_cuda.launches


def b4_launches(wk) -> int:
    """B4's launches on the server's path (the list wrapper's); a launch
    of the one-leaf wrapper there fails the run."""
    check(wk.dequant_add_cuda.launches == 0, "the server applied a leaf "
          "through the one-leaf B4 wrapper")
    return wk.dequant_add_leaves_cuda.launches


def run_async_pair(torch, device, codec, rounds):
    """A serial server and one tau-1 client on ``device``, from the
    convnet's seed-0 init, each round's drift drawn on the host from a
    fixed seed.  Returns the final center and client params on the host."""
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.models.convert import CONVNET_WIRE
    from distlearn_tpu_torch.parallel import async_ea
    from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map
    params0 = cifar_convnet().init(0, device="cpu")[0]
    port = free_port_window(3)
    out = {}

    def drift(r, p):
        g = torch.Generator().manual_seed(1000 + r)
        return tree_map(lambda v: v + (0.01 * torch.randn(
            tuple(v.shape), generator=g)).to(v.device), p)

    def server_fn():
        srv = async_ea.AsyncEAServer("127.0.0.1", port, 1, device=device,
                                     layout=CONVNET_WIRE)
        try:
            srv.init_server(params0)
            for _ in range(rounds):
                srv.sync_server(params0)
            out["center"] = [t.cpu() for t in srv.center]
        finally:
            srv.close()

    def client_fn():
        c = async_ea.AsyncEAClient("127.0.0.1", port, node=1, tau=1,
                                   alpha=ASYNC_ALPHA, codec=codec,
                                   device=device, layout=CONVNET_WIRE)
        try:
            p = c.init_client(params0)
            for r in range(rounds):
                p, synced = c.sync_client(drift(r, p))
                check(synced, "a tau-1 client did not sync")
            out["params"] = [t.cpu() for t in tree_leaves(p)]
        finally:
            c.close()

    run_threads(server_fn, client_fn)
    return out["center"], out["params"]


def phase_async_trajectory(torch):
    from distlearn_tpu_torch.ops import wire_kernels as wk
    for codec, rounds in TRAJ_ROUNDS:
        reset_wire_counts(wk)
        t0 = time.perf_counter()
        card = run_async_pair(torch, "cuda", codec, rounds)
        t_card = time.perf_counter() - t0
        launches = (*b3_launches(wk), b4_launches(wk))
        t0 = time.perf_counter()
        cpu = run_async_pair(torch, "cpu", codec, rounds)
        t_cpu = time.perf_counter() - t0
        for what, a, b in (("center", card[0], cpu[0]),
                           ("client params", card[1], cpu[1])):
            check(len(a) == CONVNET_LEAVES and all(
                torch.equal(x, y) for x, y in zip(a, b)),
                f"{codec}: the card's {what} after {rounds} rounds differs "
                f"from the CPU route's: max abs "
                f"{max(max_abs(torch, x, y) for x, y in zip(a, b))}")
        if codec == "int8":
            check(launches == (rounds, rounds, rounds),
                  f"{rounds} int8 rounds on the card launched (amax, "
                  f"quantize, dequant_add) = {launches}; expected one of "
                  "each per sync")
        log(f"[async] {rounds} {codec} rounds, card against the CPU route: "
            f"center and client params bitwise equal (18 leaves); card "
            f"{t_card:.2f} s, CPU {t_cpu:.2f} s; (amax, quantize, "
            f"dequant_add) launches {launches}")


def p50(xs):
    return statistics.median(xs) if xs else float("nan")


def phase_async_train(torch):
    from distlearn_tpu_torch import obs
    from distlearn_tpu_torch.examples import easgd
    from distlearn_tpu_torch.obs import trace as obs_trace
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.ops import wire_kernels as wk

    steps = ASYNC_SYNCS_PER_CLIENT * ASYNC_TAU
    syncs = ASYNC_CLIENTS * ASYNC_SYNCS_PER_CLIENT
    tests = syncs // ASYNC_TEST_TIME + 1
    port = free_port_window(ASYNC_CLIENTS + 2)
    common = ["--numNodes", str(ASYNC_CLIENTS), "--port", str(port),
              "--model", "cifar", "--wireCodec", "int8", "--device", "cuda",
              "--batchSize", str(ASYNC_BATCH),
              "--communicationTime", str(ASYNC_TAU),
              "--alpha", str(ASYNC_ALPHA), "--learningRate", str(LR),
              "--numEpochs", "1", "--testTime", str(ASYNC_TEST_TIME),
              "--numExamples", str(ASYNC_CLIENTS * steps * ASYNC_BATCH)]
    out = {}

    def role(name, kind, extra):
        return lambda: out.__setitem__(name, easgd.ROLES[kind](
            easgd.parse_role(kind, common + extra)))

    obs_trace.clear()
    torch.cuda.synchronize()
    reset_wire_counts(wk)
    reset_counts(fu)
    t0 = time.perf_counter()
    run_threads(role("server", "server", ["--tester"]),
                *[role(f"client{i}", "client", ["--nodeIndex", str(i)])
                  for i in range(1, ASYNC_CLIENTS + 1)],
                role("tester", "tester", ["--numTests", str(tests)]))
    wall = time.perf_counter() - t0
    amax, quant = b3_launches(wk)
    launches = {"amax": amax, "quantize_ef": quant,
                "dequant_add": b4_launches(wk)}

    check(out["server"] == {"served": syncs, "tests": tests},
          f"server: {out['server']}, expected {syncs} syncs, {tests} pushes")
    check(len(out["tester"]["rounds"]) == tests,
          f"tester evaluated {len(out['tester']['rounds'])} pushes")
    losses = []
    for i in range(1, ASYNC_CLIENTS + 1):
        c = out[f"client{i}"]
        check(c["syncs"] == ASYNC_SYNCS_PER_CLIENT and len(c["losses"]) ==
              steps, f"client {i}: {c['syncs']} syncs, {len(c['losses'])} "
              "steps")
        losses += c["losses"]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(launches == {"amax": syncs, "quantize_ef": syncs,
                       "dequant_add": syncs},
          f"launches {launches}: expected {syncs} of each (one a sync)")
    check(fu.fused_sgd.launches == 0 and fu.fused_elastic.launches == 0,
          "a fused update kernel launched on the AsyncEA path")

    spans: dict[str, list[float]] = {}
    for rec in obs.spans():
        spans.setdefault(rec["name"], []).append(rec["dur"] * 1e3)
    step_ms = [t for i in range(1, ASYNC_CLIENTS + 1)
               for t in out[f"client{i}"]["step_ms"]]
    sync_ms = [t for i in range(1, ASYNC_CLIENTS + 1)
               for t in out[f"client{i}"]["sync_ms"]]
    parts = {k: p50(spans.get(k, [])) for k in (
        "async_ea.fetch_center", "async_ea.delta", "async_ea.encode",
        "wire_kernels.frame_d2h", "async_ea.push_delta", "async_ea.apply",
        "async_ea.center_d2h", "async_ea.handshake")}
    rounds = out["tester"]["rounds"]
    log(f"[async] AsyncEA training on the card: {ASYNC_CLIENTS} clients x "
        f"{steps} steps at batch {ASYNC_BATCH}, tau {ASYNC_TAU}, alpha "
        f"{ASYNC_ALPHA}, int8: {syncs} syncs applied, {tests} tester pushes,"
        f" losses {losses[0]:.4f} -> {losses[-1]:.4f} (all finite); test "
        f"error {rounds[0]['test_error']:.4f} -> {rounds[-1]['test_error']:.4f}")
    log(f"[async] launches on the path: amax {launches['amax']}, "
        f"quantize_ef {launches['quantize_ef']}, dequant_add "
        f"{launches['dequant_add']} (one of each per sync)")
    log(f"[async] local step p50 {p50(step_ms):.3f} ms; client sync p50 "
        f"{p50(sync_ms):.3f} ms = center fetch {parts['async_ea.fetch_center']:.3f}"
        f" + delta {parts['async_ea.delta']:.3f} + encode (B3 + D2H) "
        f"{parts['async_ea.encode']:.3f} (of which the wait for B3 and the "
        f"frame's D2H {parts['wire_kernels.frame_d2h']:.3f}) + push "
        f"{parts['async_ea.push_delta']:.3f} (p50 of each part)")
    log(f"[async] server: apply (H2D + B4) p50 {parts['async_ea.apply']:.3f}"
        f" ms, center D2H p50 {parts['async_ea.center_d2h']:.3f} ms, "
        f"handshake p50 {parts['async_ea.handshake']:.3f} ms; {syncs} syncs "
        f"in {wall:.2f} s wall = {syncs / wall:.2f} syncs/s (model build, "
        "init broadcast and tester evaluation included)")
    return {"launches": launches, "syncs_per_s": syncs / wall}


# ---------------------------------------------------------------------------
# Phase 8a: the concurrent server — stripes, overlap, rejoin, elastic, HA
# ---------------------------------------------------------------------------

def applies_by_path(obs) -> dict:
    """The server's center applies so far, by path ('fused' = weight 1,
    B4 over the int8 leaves; 'scaled' = a capacity weight, plain ops)."""
    for fam in obs.REGISTRY.snapshot():
        if fam["name"] == "async_ea_center_applies_total":
            return {s["labels"]["path"]: s["value"] for s in fam["samples"]}
    return {}


def spawn_concurrent(device, num_clients, shards, codec, params0,
                     centers=None, tau=1):
    """A concurrent server (S = ``shards``) and ``num_clients`` clients on
    ``device``, the convnet on the JAX package's wire layout; started
    together (both constructors wait for the other side).  Returns
    ``(server, clients, params)`` with the server serving."""
    from distlearn_tpu_torch.models.convert import CONVNET_WIRE
    from distlearn_tpu_torch.parallel import async_ea
    port = free_port_window(num_clients + shards + 2)
    box = {}

    def dial(i):
        box[i] = async_ea.AsyncEAClient(
            "127.0.0.1", port, node=i + 1, tau=tau, alpha=ASYNC_ALPHA,
            codec=codec, device=device, layout=CONVNET_WIRE,
            centers=centers)

    def serve():
        box["srv"] = async_ea.AsyncEAServerConcurrent(
            "127.0.0.1", port, num_clients, shards=shards, device=device,
            layout=CONVNET_WIRE, accept_timeout=120.0)

    run_threads(serve, *[lambda i=i: dial(i) for i in range(num_clients)])
    srv, clients = box["srv"], [box[i] for i in range(num_clients)]
    ps = [None] * num_clients

    def init(i):
        ps[i] = clients[i].init_client(params0)

    # the initial broadcast (the whole center to each client) outgrows the
    # socket buffers: the clients receive while the server sends
    run_threads(lambda: srv.init_server(params0),
                *[lambda i=i: init(i) for i in range(num_clients)])
    srv.start()
    return srv, clients, ps


def settle(srv, timeout=120.0):
    """Wait until nothing is in flight on ``srv`` and its sync count holds
    still over two polls."""
    deadline = time.monotonic() + timeout
    last = -1
    while time.monotonic() < deadline:
        with srv._lock:
            quiet = srv._inflight == 0
        if quiet:
            n = srv.syncs_completed
            if n == last:
                return
            last = n
        else:
            last = -1
        time.sleep(0.05)
    raise SmokeFailure("the concurrent server did not settle")


def run_async_concurrent(torch, device, codec, rounds, shards):
    """One tau-1 client on a concurrent server with ``shards`` stripes, on
    ``device``, phase 7's seeded drift.  Returns the final center (wire
    layout) and client params on the host."""
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map
    params0 = cifar_convnet().init(0, device="cpu")[0]
    srv, (cl,), (p,) = spawn_concurrent(device, 1, shards, codec, params0)
    try:
        try:
            for r in range(rounds):
                g = torch.Generator().manual_seed(1000 + r)
                p = tree_map(lambda v: v + (0.01 * torch.randn(
                    tuple(v.shape), generator=g)).to(v.device), p)
                p, synced = cl.sync_client(p)
                check(synced, "a tau-1 client did not sync")
        finally:
            cl.close()
        check_wait(lambda: srv.drained, 60, "the concurrent server to drain")
        center = [t.cpu() for t in srv._center_clone()]
    finally:
        srv.stop()
        srv.close()
    return center, [t.cpu() for t in tree_leaves(p)], list(srv.splits)


def check_wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.02)


def trees_bitwise(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_async_concurrent_trajectory(torch):
    """8a(a): the concurrent, striped trajectory on the card against the
    CPU route and the one-stripe run."""
    from distlearn_tpu_torch.ops import wire_kernels as wk
    S = ASYNC8A_SHARDS
    card = {}
    for codec, rounds in TRAJ_ROUNDS:
        reset_wire_counts(wk)
        t0 = time.perf_counter()
        card[codec] = run_async_concurrent(torch, "cuda", codec, rounds, S)
        t_card = time.perf_counter() - t0
        launches = (*b3_launches(wk), b4_launches(wk))
        cpu = run_async_concurrent(torch, "cpu", codec, rounds, S)
        for what, i in (("center", 0), ("client params", 1)):
            check(len(card[codec][i]) == CONVNET_LEAVES and trees_bitwise(
                torch, card[codec][i], cpu[i]),
                f"8a {codec}: the card's {what} at S={S} differs from the "
                "CPU route's")
        want = (S * rounds,) * 3 if codec == "int8" else (0, 0, 0)
        check(launches == want,
              f"8a: {rounds} {codec} rounds at S={S} launched (amax, "
              f"quantize, dequant_add) = {launches}; expected {want} (one "
              "of each per stripe per int8 sync)")
        log(f"[async8a] {rounds} {codec} rounds, concurrent S={S} "
            f"(splits {card[codec][2]}), card against the CPU route: "
            f"center and client params bitwise equal; (amax, quantize, "
            f"dequant_add) launches {launches}; card {t_card:.2f} s")
    one = run_async_concurrent(torch, "cuda", "raw", TRAJ_ROUNDS[1][1], 1)
    check(trees_bitwise(torch, one[0], card["raw"][0])
          and trees_bitwise(torch, one[1], card["raw"][1]),
          f"8a: raw rounds at S={S} differ from S=1 on the card")
    one8 = run_async_concurrent(torch, "cuda", "int8", TRAJ_ROUNDS[0][1], 1)
    diff = max(max_abs(torch, x, y) for x, y in zip(one8[0],
                                                    card["int8"][0]))
    log(f"[async8a] raw: S={S} bitwise equal to S=1 on the card (striping "
        f"is transport only); int8: S={S} against S=1 max abs center "
        f"difference {diff:.3e} (each conv4 chunk carries its own scale)")
    reset_wire_counts(wk)
    r3, rounds3 = ASYNC8A_RAGGED_SHARDS, 3
    ragged = run_async_concurrent(torch, "cuda", "int8", rounds3, r3)
    launches = (*b3_launches(wk), b4_launches(wk))
    cpu = run_async_concurrent(torch, "cpu", "int8", rounds3, r3)
    check(ragged[2][15] == 3 and trees_bitwise(torch, ragged[0], cpu[0])
          and trees_bitwise(torch, ragged[1], cpu[1])
          and launches == (r3 * rounds3,) * 3,
          f"8a: int8 at S={r3} (conv4 in chunks at offsets that are not "
          f"multiples of 4): card against CPU or launches {launches}")
    log(f"[async8a] {rounds3} int8 rounds at S={r3} (conv4 cut at element "
        "offsets 1092267 and 2184534): card bitwise the CPU route; "
        f"launches {launches}")


def phase_async_fleet(torch):
    """8a(b): the example's roles as threads on an elastic, striped,
    concurrent server on the card, with a cut-and-rejoin, a leave and a
    capacity-2 join."""
    from distlearn_tpu_torch import obs
    from distlearn_tpu_torch.examples import easgd
    from distlearn_tpu_torch.obs import trace as obs_trace
    from distlearn_tpu_torch.ops import wire_kernels as wk

    S, n = ASYNC8A_SHARDS, ASYNC8A_CLIENTS
    steps = ASYNC_SYNCS_PER_CLIENT * ASYNC_TAU
    port = free_port_window(n + S + 2)
    common = ["--numNodes", str(n), "--port", str(port), "--model", "cifar",
              "--wireCodec", "int8", "--device", "cuda",
              "--batchSize", str(ASYNC_BATCH),
              "--communicationTime", str(ASYNC_TAU),
              "--alpha", str(ASYNC_ALPHA), "--learningRate", str(LR),
              "--numEpochs", "1", "--numExamples",
              str(n * steps * ASYNC_BATCH), "--shards", str(S),
              "--overlapSync"]
    out = {}
    serving = threading.Event()

    def served(srv):
        out["srv"] = srv
        serving.set()

    def join_later():
        # the joiner dials once the founders have synced twice each: the
        # applies before it joins carry weight 1 (B4), those after it a
        # capacity weight (the plain ops)
        check(serving.wait(ROLE_TIMEOUT_S), "the server never served")
        check_wait(lambda: out["srv"].syncs_completed >= 2 * n,
                   ROLE_TIMEOUT_S, "the founders' first syncs")

    def role(name, kind, extra, wait=False):
        def run():
            opt = easgd.parse_role(kind, common + extra)
            if kind == "server":
                out[name] = easgd.run_server(opt, on_serving=served)
            else:
                out[name] = easgd.run_client(
                    opt, before_dial=join_later if wait else None)
        return run

    obs_trace.clear()
    torch.cuda.synchronize()
    reset_wire_counts(wk)
    before = applies_by_path(obs)
    t0 = time.perf_counter()
    run_threads(
        role("server", "server", ["--concurrent", "--elastic",
                                  "--numSyncs", "100000",
                                  "--syncTimeout", "30"]),
        role("c1", "client", ["--nodeIndex", "1"]),
        role("c2", "client", ["--nodeIndex", "2", "--cutAfter",
                              str(ASYNC8A_CUT_AFTER)]),
        role("c3", "client", ["--nodeIndex", "3", "--leaveAfterSyncs",
                              str(ASYNC8A_LEAVE_AFTER)]),
        role("c4", "client", ["--nodeIndex", "4", "--joinFleet",
                              "--capacity", str(ASYNC8A_JOIN_CAPACITY)],
             wait=True))
    wall = time.perf_counter() - t0
    amax, quant = b3_launches(wk)
    b4 = b4_launches(wk)
    after = applies_by_path(obs)
    applied = {k: after.get(k, 0) - before.get(k, 0)
               for k in ("fused", "scaled")}
    srv = out["server"]
    clients = [out[f"c{i}"] for i in range(1, n + 2)]
    syncs = sum(c["syncs"] for c in clients)
    check(srv["served"] == syncs, f"8a: the server applied {srv['served']} "
          f"syncs, the clients counted {syncs}")
    check(out["c2"]["recoveries"] == 1 and out["c2"]["syncs"] ==
          ASYNC_SYNCS_PER_CLIENT - 1, f"8a: client 2 (cut after "
          f"{ASYNC8A_CUT_AFTER}): {out['c2']['syncs']} syncs, "
          f"{out['c2']['recoveries']} recoveries")
    check(srv["ledger"].get(2) == [out["c2"]["seq"]] * S,
          f"8a: client 2's ledger {srv['ledger'].get(2)}, its last sync "
          f"seq {out['c2']['seq']}")
    check(out["c3"]["left"] and out["c3"]["syncs"] == ASYNC8A_LEAVE_AFTER,
          f"8a: client 3 left={out['c3']['left']} after "
          f"{out['c3']['syncs']} syncs")
    for i, c in enumerate(clients, start=1):
        if c["failures"]:
            log(f"[async8a] client {i}'s failed syncs: {c['failures']}")
    check(out["c4"]["node"] == n + 1 and out["c4"]["syncs"] ==
          ASYNC_SYNCS_PER_CLIENT, f"8a: joiner cid {out['c4']['node']}, "
          f"{out['c4']['syncs']} syncs, {len(out['c4']['losses'])} steps, "
          f"failures {out['c4']['failures']}")
    check(srv["members"] == [1, 2, n + 1] and srv["evicted"] == [],
          f"8a: members {srv['members']}, evicted {srv['evicted']}")
    weights = srv["weights"]
    check(abs(sum(weights.values()) - n) < 1e-9,
          f"8a: live capacity weights {weights} do not sum to {n}")
    losses = [v for c in clients for v in c["losses"]]
    check(all(math.isfinite(v) for v in losses), "8a: non-finite loss")
    check(amax == quant == S * syncs,
          f"8a: B3 (amax, quantize) = ({amax}, {quant}); expected {S} of "
          f"each per sync ({S * syncs})")
    check(b4 == applied["fused"] > 0 and applied["scaled"] > 0
          and applied["fused"] + applied["scaled"] == S * syncs,
          f"8a: B4 launched {b4} times; center applies {applied} (expected "
          f"one B4 launch per weight-1 stripe apply, {S} applies a sync)")
    log(f"[async8a] elastic fleet on the card (S={S}, int8, overlap, tau "
        f"{ASYNC_TAU}, batch {ASYNC_BATCH}, full-width CIFAR-10 convnet): "
        f"{syncs} syncs applied = the clients' count; client 2 cut after "
        f"{ASYNC8A_CUT_AFTER} syncs and rejoined (ledger {srv['ledger'][2]}"
        f" = its last seq on every stripe), client 3 left after "
        f"{ASYNC8A_LEAVE_AFTER}, client 4 joined (capacity "
        f"{ASYNC8A_JOIN_CAPACITY}); live weights {weights} (sum {n}); "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; {wall:.2f} s wall")
    log(f"[async8a] launches: amax {amax}, quantize_ef {quant} ({S} each a "
        f"sync), dequant_add {b4} = the weight-1 stripe applies "
        f"({applied['fused']}; {applied['scaled']} capacity-weighted "
        "applies took the plain ops)")
    return {"launches": {"amax": amax, "quantize_ef": quant,
                         "dequant_add": b4}, "syncs": syncs}


def phase_async_ha(torch):
    """8a(c): checkpoints every 2 syncs, the primary stopped, a standby on
    the card promoted; failover with a replay; the epoch fence."""
    import tempfile

    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.models.convert import CONVNET_WIRE
    from distlearn_tpu_torch.parallel import async_ea, ha
    from distlearn_tpu_torch.utils.checkpoint import latest_step
    from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map
    S = ASYNC8A_SHARDS
    params0 = cifar_convnet().init(0, device="cpu")[0]
    standby_port = free_port_window(2 + S + 2)
    ckdir = tempfile.mkdtemp(prefix="distlearn_ha_")
    srv, clients, ps = spawn_concurrent(
        "cuda", 2, S, "int8", params0, centers=[("127.0.0.1", standby_port)])
    standby = zombie = None

    def drift(p, r):
        g = torch.Generator().manual_seed(2000 + r)
        return tree_map(lambda v: v + (0.01 * torch.randn(
            tuple(v.shape), generator=g)).to(v.device), p)

    try:
        srv.enable_checkpoint(ckdir, every=2)
        for r in range(2):
            for i, cl in enumerate(clients):
                ps[i], _ = cl.sync_client(drift(ps[i], r))
                settle(srv)
        srv._ckpt.wait()
        check(latest_step(ckdir) == 4, f"8a: newest checkpoint "
              f"{latest_step(ckdir)}, expected 4 (every 2 syncs)")
        at_ckpt = [t.cpu() for t in srv._center_clone()]
        ps[0], _ = clients[0].sync_client(drift(ps[0], 2))
        settle(srv)
        final = [t.cpu() for t in srv._center_clone()]
        srv.stop()
        srv.close()
        standby = async_ea.AsyncEAServerConcurrent(
            "127.0.0.1", standby_port, 2, shards=S, standby=True,
            device="cuda", layout=CONVNET_WIRE)
        ha.promote(standby, ckdir, params0)
        restored, _ = ha.restore_center(ckdir, params0, layout=CONVNET_WIRE)
        got = [t.cpu() for t in standby._center_clone()]
        check(standby.epoch == 1 and trees_bitwise(torch, got, at_ckpt)
              and trees_bitwise(torch, got, [t.cpu() for t in tree_leaves(
                  CONVNET_WIRE.to_wire(restored))]),
              "8a: the promoted center is not the checkpoint's bit for bit")
        standby.start()
        for cl, p in zip(clients, ps):
            cl.failover(p, retries=20, retry_interval=0.05,
                        handshake_timeout=30.0)
        settle(standby)
        replayed = [t.cpu() for t in standby._center_clone()]
        check(trees_bitwise(torch, replayed, final)
              and standby._applied_seq == {1: [3] * S, 2: [2] * S},
              "8a: after the failover replay the promoted center is not the "
              f"primary's final one (ledger {standby._applied_seq})")
        for i, cl in enumerate(clients):
            ps[i], synced = cl.sync_client(drift(ps[i], 3))
            check(synced, "8a: a client did not sync after failover")
        settle(standby)
        check(standby.syncs_completed == 7, f"8a: the promoted center "
              f"counts {standby.syncs_completed} syncs, expected 7")
        zport = free_port_window(2 + S + 2)
        zombie = async_ea.AsyncEAServerConcurrent(
            "127.0.0.1", zport, 2, shards=S, standby=True, device="cuda",
            layout=CONVNET_WIRE)
        zombie.init_server(params0)         # epoch 0: behind the fleet
        zombie.start()
        clients[1]._centers = [("127.0.0.1", zport)]
        try:
            clients[1].failover(ps[1], retries=3, retry_interval=0.05,
                                handshake_timeout=10.0)
        except ConnectionError:
            pass
        else:
            raise SmokeFailure("8a: a client failed over to a stale center")
        check(clients[1]._centers == [], "8a: the stale center was not "
              "dropped from the dial list")
        log(f"[async8a] HA on the card: checkpoints every 2 syncs (newest "
            f"step 4), primary stopped after 5; standby (S={S}) promoted to "
            "epoch 1, its center the checkpoint's bit for bit; failover "
            "replayed client 1's missing sync once (center = the primary's "
            "final one bit for bit), both clients synced again (7 syncs); a "
            "stale epoch-0 center refused and dropped from the dial list")
    finally:
        for cl in clients:
            cl.close()
        for s in (srv, standby, zombie):    # stop() again is a no-op
            if s is not None:
                s.stop()
                s.close()


def timed_trio(torch, server_extra, client_extra):
    """The example's server and 2 clients as threads on the card (int8,
    tau 4, batch 128, 8 syncs a client, no tester).  Returns syncs/s over
    the clients' training loops, the client sync p50 and span p50s."""
    from distlearn_tpu_torch import obs
    from distlearn_tpu_torch.examples import easgd
    from distlearn_tpu_torch.obs import trace as obs_trace
    steps = ASYNC_SYNCS_PER_CLIENT * ASYNC_TAU
    port = free_port_window(ASYNC_CLIENTS + ASYNC8A_SHARDS + 2)
    common = ["--numNodes", str(ASYNC_CLIENTS), "--port", str(port),
              "--model", "cifar", "--wireCodec", "int8", "--device", "cuda",
              "--batchSize", str(ASYNC_BATCH),
              "--communicationTime", str(ASYNC_TAU),
              "--alpha", str(ASYNC_ALPHA), "--learningRate", str(LR),
              "--numEpochs", "1",
              "--numExamples", str(ASYNC_CLIENTS * steps * ASYNC_BATCH)]
    out = {}

    def role(name, kind, extra):
        return lambda: out.__setitem__(name, easgd.ROLES[kind](
            easgd.parse_role(kind, common + extra)))

    obs_trace.clear()
    torch.cuda.synchronize()
    run_threads(role("server", "server", server_extra),
                *[role(f"c{i}", "client", ["--nodeIndex", str(i)]
                       + client_extra)
                  for i in range(1, ASYNC_CLIENTS + 1)])
    cs = [out[f"c{i}"] for i in range(1, ASYNC_CLIENTS + 1)]
    syncs = sum(c["syncs"] for c in cs)
    check(out["server"]["served"] == syncs == ASYNC_CLIENTS *
          ASYNC_SYNCS_PER_CLIENT, f"8a timing: {out['server']['served']} "
          f"served, {syncs} synced")
    spans: dict[str, list[float]] = {}
    for rec in obs.spans():
        spans.setdefault(rec["name"], []).append(rec["dur"] * 1e3)
    return {"syncs_per_s": syncs / max(c["train_s"] for c in cs),
            "sync_p50": p50([t for c in cs for t in c["sync_ms"]]),
            "parts": {k: p50(spans.get(k, [])) for k in (
                "async_ea.wait", "async_ea.fetch_center", "async_ea.delta",
                "async_ea.encode", "async_ea.push_delta", "async_ea.apply",
                "async_ea.handshake")}}


def phase_async_numbers(torch, card):
    """8a(d): the serial and the concurrent server (S = 1, 4) with the
    same 2 clients; B3 and B4 at one stripe's shape."""
    from distlearn_tpu_torch.parallel.async_ea import _split_views
    from distlearn_tpu_torch.comm import wire
    from distlearn_tpu_torch.ops import wire_kernels as wk
    S = ASYNC8A_SHARDS
    rows = {}
    for label, srv_extra, cl_extra in (
            ("serial", [], []),
            ("concurrent S=1", ["--concurrent"], []),
            (f"concurrent S={S}", ["--concurrent", "--shards", str(S)], []),
            (f"concurrent S={S} + overlap",
             ["--concurrent", "--shards", str(S)], ["--overlapSync"])):
        r = rows[label] = timed_trio(torch, srv_extra, cl_extra)
        pt = r["parts"]
        log(f"[async8a] {label}: {ASYNC_CLIENTS} clients x "
            f"{ASYNC_SYNCS_PER_CLIENT} syncs, {r['syncs_per_s']:.3f} syncs/s "
            f"(over the clients' training loops), client sync p50 "
            f"{r['sync_p50']:.3f} ms = wait {pt['async_ea.wait']:.3f} + fetch "
            f"{pt['async_ea.fetch_center']:.3f} + move "
            f"{pt['async_ea.delta']:.3f} + encode {pt['async_ea.encode']:.3f}"
            f" + push {pt['async_ea.push_delta']:.3f} (p50 of each span; "
            f"striped: one fetch, encode and push span a stripe); server "
            f"apply p50 {pt['async_ea.apply']:.3f} ms (a stripe, or a whole "
            f"delta at S=1), handshake p50 {pt['async_ea.handshake']:.3f} ms")
    # B3 and B4 at one stripe's shape: the S = 4 plan of the convnet
    dev = torch.device("cuda")
    shapes = convnet_shapes()
    sizes = [math.prod(sh) for sh in shapes]
    splits = wire.plan_splits([4 * n for n in sizes], sizes, S)
    gen = torch.Generator(device=dev).manual_seed(7)
    full = [torch.randn(sh, generator=gen, device=dev) * 0.01
            for sh in shapes]
    centers_full = [torch.randn(sh, generator=gen, device=dev)
                    for sh in shapes]
    vleaves = _split_views(full, splits)
    vcenters = _split_views(centers_full, splits)
    stripes = wire.plan_stripes([4 * v.numel() for v in vleaves], S)
    rate, part = hbm_rate(card)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for idx in (0, max(range(len(stripes)), key=lambda i: sum(
            v.numel() for v in vleaves[stripes[i][0]:stripes[i][1]]))):
        lo, hi = stripes[idx]
        xs, cs = vleaves[lo:hi], vcenters[lo:hi]
        qs = [torch.empty(x.shape, dtype=torch.int8, device=dev) for x in xs]
        rs = [torch.empty_like(x) for x in xs]
        scales = wk.scales_of(wk.quantize_ef_leaves_cuda(xs, qs, rs)[1].cpu())
        n = sum(x.numel() for x in xs)
        bound = max(9 * n / rate, 6 * n / FP32_FLOPS) * 1e3
        b3 = time_ms(torch, lambda: wk.scales_of(
            wk.quantize_ef_leaves_cuda(xs, qs, rs)[1].cpu()), flush)
        b3p = time_ms(torch, lambda: wk.quantize_ef_leaves_plain(xs, qs, rs),
                      flush)
        b4 = time_ms(torch, lambda: wk.dequant_add_leaves_cuda(
            cs, qs, scales, outs=cs), flush)
        b4p = time_ms(torch, lambda: wk.dequant_add_leaves_plain(
            cs, qs, scales), flush)

        def lib():
            for c, q, s in zip(cs, qs, scales):
                torch.add(c, q, alpha=s)
        b4l = time_ms(torch, lib, flush)
        busy3 = device_ms(torch, lambda: wk.quantize_ef_leaves_cuda(
            xs, qs, rs))
        busy4 = device_ms(torch, lambda: wk.dequant_add_leaves_cuda(
            cs, qs, scales, outs=cs))
        log(f"[async8a] stripe {idx} of S={S} ({hi - lo} virtual leaves, "
            f"n={n}): B3 {b3:.5f} ms (busy {busy3:.5f}) | plain {b3p:.5f} ms "
            f"| B4 {b4:.5f} ms (busy {busy4:.5f}) | plain {b4p:.5f} ms | "
            f"torch.add loop {b4l:.5f} ms | bound {bound:.5f} ms each (9 "
            f"bytes an element at {rate / 1e12:.2f} TB/s, {part})")
    del flush
    return rows


def phase_async_concurrent(torch, card):
    phase_async_concurrent_trajectory(torch)
    fleet = phase_async_fleet(torch)
    phase_async_ha(torch)
    phase_async_numbers(torch, card)
    return fleet


# ---------------------------------------------------------------------------
# Phase 9: kernel B5a against its plain twin and the xla route
# ---------------------------------------------------------------------------

def attn_bound(torch, nbytes, flops, dtype, rate, core_flops=None):
    """(bound ms, bound_by): bytes over the HBM rate against operations over
    the peaks of the units the kernel's route runs them on.  bfloat16:
    every flop on the tensor cores.  float32: ``core_flops`` of them on the
    CUDA cores (the score product of B5a, B5b and B5c, and di of B5c) and
    the rest in 3xTF32, three TF32 tensor-core passes a product; the two
    units run side by side, so the slower of them bounds.  Without
    ``core_flops``, every float32 flop on the CUDA cores: what they alone
    would bound a kernel at."""
    if dtype != torch.float32:
        ops_s = flops / BF16_FLOPS
    elif core_flops is None:
        ops_s = flops / FP32_FLOPS
    else:
        ops_s = max(core_flops / FP32_FLOPS,
                    TF32_PASSES * (flops - core_flops) / TF32_FLOPS)
    by_bytes, by_ops = nbytes / rate * 1e3, ops_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def flash_bound(torch, B, H, D, L, dtype, rate):
    """(bound ms, bound_by, bytes, flops, CUDA-core bound ms) of B5a without
    residuals: q, k, v read once and o written once; the causal products
    2*B*H*L*L*D, half of them the score product, which float32 runs on the
    CUDA cores (the other half, P V, in 3xTF32); the last figure is what
    the CUDA cores alone would bound float32 at (None for bfloat16)."""
    elt = 4 if dtype == torch.float32 else 2
    nbytes = 4 * B * L * H * D * elt
    flops = 2 * B * H * L * L * D
    f32 = dtype == torch.float32
    core = attn_bound(torch, nbytes, flops, dtype, rate)[0] if f32 else None
    return (*attn_bound(torch, nbytes, flops, dtype, rate,
                        flops // 2 if f32 else None), nbytes, flops, core)


def flash_inputs(torch, gen, B, H, D, L, dtype, n, mult=1.0):
    """``n`` standard normal ``[B, L, H, D]`` tensors on the card in
    ``dtype``, the first (q) multiplied by ``mult`` before the cast."""
    ts = [torch.randn((B, L, H, D), generator=gen, device="cuda")
          for _ in range(n)]
    ts[0] = ts[0] * mult
    return [t.to(dtype) for t in ts]


def case_name(B, H, D, L, dtype, causal=True, mult=1.0):
    return (f"B={B} H={H} D={D} L={L} {str(dtype)[6:]}"
            + ("" if causal else " full") + ("" if mult == 1 else
                                             f" q x{mult:g}"))


def check_forward(torch, name, out, plain, xla, dtype):
    """B5a's output against its twin and the xla route; the two max abs
    errors."""
    check(bool(torch.isfinite(out).all()),
          f"flash_attention {name}: non-finite output")
    err_plain, err_xla = max_abs(torch, out, plain), max_abs(torch, out, xla)
    if dtype == torch.float32:
        check(err_plain <= FLASH_F32_TOL and err_xla <= FLASH_F32_TOL,
              f"flash_attention {name}: max abs {err_plain} against "
              f"the plain twin, {err_xla} against xla (> "
              f"{FLASH_F32_TOL})")
    else:
        for ref, what in ((plain, "plain twin"), (xla, "xla route")):
            check(torch.allclose(out.float(), ref.float(),
                                 rtol=FLASH_BF16_TOL, atol=FLASH_BF16_TOL),
                  f"flash_attention {name}: outside rtol = atol = "
                  f"{FLASH_BF16_TOL} of the {what}")
    return err_plain, err_xla


def phase_flash(torch, card):
    import torch.nn.functional as F
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.parallel.sequence import local_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rate, part = hbm_rate(card)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    main_row = None
    for B, H, D, L in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, gen, B, H, D, L, dtype, 3)
            out = fa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            plain = fa.flash_attention_plain(q, k, v, True)
            xla = local_attention(q, k, v, causal=True, impl="xla")
            name = case_name(B, H, D, L, dtype)
            err_plain, err_xla = check_forward(torch, name, out, plain, xla,
                                               dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound, bound_by, nbytes, flops, core = flash_bound(
                torch, B, H, D, L, dtype, rate)
            row = {
                "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v),
                              flush),
                "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, True), flush),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush),
                "bound_ms": bound, "bound_by": bound_by,
                "max_abs_err": err_plain,
            }
            if core is not None:
                row["core_bound_ms"] = core
            log(f"[flash] {name}: {row['ms']:.4f} ms | plain "
                f"{row['plain_ms']:.4f} ms | sdpa {row['library_ms']:.4f} ms"
                f" | bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB"
                f" at {rate / 1e12:.2f} TB/s ({part}), {flops / 1e9:.2f} "
                f"GFLOP) = {bound / row['ms']:.1%} of bound"
                + ("" if core is None else f", CUDA-core bound {core:.4f}")
                + " | max abs err "
                f"{err_plain:.3g} (plain), {err_xla:.3g} (xla)")
            if (B, H, D, L) == FLASH_MAIN and dtype == torch.bfloat16:
                main_row = row
    del flush
    for B, H, D, L, causal, mult in FLASH_BF16_CASES:
        q, k, v = flash_inputs(torch, gen, B, H, D, L, torch.bfloat16, 3,
                               mult)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        name = case_name(B, H, D, L, torch.bfloat16, causal, mult)
        errs = check_forward(torch, name, out,
                             fa.flash_attention_plain(q, k, v, causal),
                             local_attention(q, k, v, causal=causal,
                                             impl="xla"), torch.bfloat16)
        log(f"[flash] {name}: max abs err {errs[0]:.3g} (plain), "
            f"{errs[1]:.3g} (xla)")
    log(f"[flash] float32 within {FLASH_F32_TOL} of the plain twin and the "
        f"xla route, bfloat16 within rtol = atol = {FLASH_BF16_TOL}, all "
        "outputs finite")
    return main_row


# ---------------------------------------------------------------------------
# Phase 10: the served transformer LM
# ---------------------------------------------------------------------------

def compare_stream(torch, model, params, prompt, got, ref, tol):
    """``None`` when ``got == ref``; else ``(t, gap, margin)`` at the first
    mismatch ``t``, from the reference's own logits there (a teacher-forced
    forward of the prompt and ``ref[:t]``): how far the taken token scores
    below the top logit, and the top-2 margin.  Raises when the gap exceeds
    ``tol``."""
    check(len(got) == len(ref), f"stream of {len(got)} tokens, reference "
          f"{len(ref)}")
    for t, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        seq = torch.tensor([list(prompt) + list(ref[:t])],
                           device=params["embed"].device)
        with torch.no_grad():
            logits = model.apply(params, {}, seq)[0][0, -1].float()
        top2 = logits.topk(2).values
        gap = float(top2[0] - logits[a])
        margin = float(top2[0] - top2[1])
        check(gap <= tol, f"stream diverges from greedy_generate at token "
              f"{t} ({a} against {b}) where the reference's logits do not "
              f"tie: the taken token is {gap:.4g} below the top (> {tol}; "
              f"top-2 margin {margin:.4g})")
        return t, gap, margin
    return None


def phase_serve_lm(torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile

    import numpy as np
    from distlearn_tpu_torch import obs
    from distlearn_tpu_torch.examples import lm as lm_example
    from distlearn_tpu_torch.models.transformer import (greedy_generate,
                                                        transformer_lm)
    from distlearn_tpu_torch.obs import trace as obs_trace
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.serve import DecodeEngine, ServeClient
    from distlearn_tpu_torch.utils.tree import tree_leaves

    opt = lm_example.parse(LM_FLAGS)
    heads = max(4, opt.dim // 64)
    t0 = time.perf_counter()
    params, cd = lm_example.build_model(opt)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] transformer_lm vocab {opt.vocab}, dim {opt.dim}, depth "
        f"{opt.depth}, {heads} heads, max_len {opt.seqLen}: {n_params:,} "
        f"float32 params from the seeded init in "
        f"{time.perf_counter() - t0:.1f} s")
    models = {dt: transformer_lm(vocab=opt.vocab, dim=opt.dim,
                                 depth=opt.depth, heads=heads,
                                 max_len=opt.seqLen, compute_dtype=dt,
                                 attn_impl="xla")
              for dt in (torch.float32, cd)}
    rng = np.random.default_rng(10)
    env = os.environ.get("DISTLEARN_TPU_ATTN")
    try:
        # (a) float32 compute, TF32 off: one 1024-token prompt; the
        # reference takes the xla route, so B5a is on one side only
        prompt = rng.integers(0, opt.vocab, LM_CHECK_PROMPT).astype(np.int32)
        ref = greedy_generate(params, prompt[None], LM_CHECK_STEPS,
                              attn_impl="xla")[0].tolist()
        for impl in ("flash", "xla"):
            os.environ["DISTLEARN_TPU_ATTN"] = impl
            eng = DecodeEngine(params, num_slots=1, device="cuda")
            fa.flash_attention.launches = 0
            slot, first = eng.admit(prompt, LM_CHECK_STEPS)
            got = [first] + [eng.tick()[slot]
                             for _ in range(LM_CHECK_STEPS - 1)]
            eng.finish(slot)
            del eng
            # one full prefill: B5a (float32, flash_fwd_tf32x3) once a
            # layer on the flash route, never on the xla route
            b5a = fa.flash_attention.launches
            check(b5a == (opt.depth if impl == "flash" else 0),
                  f"[serve] (a) float32 on {impl}: B5a launched {b5a} "
                  f"times in one full prefill of {opt.depth} layers")
            tie = compare_stream(torch, models[torch.float32], params,
                                 prompt, got, ref, TIE_TOL["float32"])
            how = "equal" if tie is None else (
                f"equal up to a near-tie at token {tie[0]} (gap {tie[1]:.3g},"
                f" top-2 margin {tie[2]:.3g})")
            log(f"[serve] (a) float32, engine on {impl}, greedy_generate on "
                f"xla: {how} over {LM_CHECK_STEPS} tokens of a "
                f"{LM_CHECK_PROMPT}-token prompt; B5a launches {b5a}")

        # (b) bfloat16 compute, the server on loopback
        os.environ["DISTLEARN_TPU_ATTN"] = "flash"
        lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                            SERVE_REQUESTS)
        prompts = [rng.integers(0, opt.vocab, n).astype(np.int32)
                   for n in lens]
        srv = lm_example.start_server(opt, params, cd,
                                      prefill_chunk=SERVE_PREFILL_CHUNK)
        engine = srv.engine
        buckets, chunks = [], []
        real_prefill, real_chunk = engine._prefill, engine._chunk
        engine._prefill = lambda btrow, tokens, plen: (
            buckets.append(tokens.shape[1]) or real_prefill(btrow, tokens,
                                                            plen))
        engine._chunk = lambda btrow, tokens, p0, clen: (
            chunks.append(clen) or real_chunk(btrow, tokens, p0, clen))
        results, errs = {}, []

        def client(i):
            try:
                with ServeClient(srv.host, srv.port) as c:
                    for j in range(i, SERVE_REQUESTS, SERVE_THREADS):
                        results[j] = c.generate(prompts[j], SERVE_MAX_NEW,
                                                rid=f"r{j}", timeout=300)
            except BaseException as e:  # noqa: BLE001 — reported below
                errs.append(e)

        obs_trace.set_ring_size(1 << 16)
        obs_trace.clear()
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(ROLE_TIMEOUT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        srv.stop()
        engine._prefill, engine._chunk = real_prefill, real_chunk
        check(not errs, f"a serving client failed: {errs[:1]!r}")
        check(len(results) == SERVE_REQUESTS and all(
            r["reason"] == "complete" for r in results.values()),
            f"{len(results)} of {SERVE_REQUESTS} requests completed")
        full = sum(b >= 128 for b in buckets)
        check(launches == opt.depth * full and full >= 1,
              f"B5a launched {launches} times; the run made {full} "
              f"full-prompt prefills at buckets >= 128 (buckets {buckets}), "
              f"expected {opt.depth} launches each")
        check(len(chunks) > 0, "no request went through the chunk pass")
        spans = {}
        for rec in obs.spans():
            spans.setdefault(rec["name"], []).append(rec["dur"] * 1e3)
        ttft, tpot = p50(spans.get("serve.ttft", [])), \
            p50(spans.get("serve.tpot", []))
        tokens = sum(len(r["tokens"]) for r in results.values())

        matched, ties = 0, []
        for j in range(SERVE_REQUESTS):
            ref = greedy_generate(params, prompts[j][None], SERVE_MAX_NEW,
                                  compute_dtype=cd,
                                  attn_impl="xla")[0].tolist()
            tie = compare_stream(torch, models[cd], params, prompts[j],
                                 results[j]["tokens"], ref,
                                 TIE_TOL["bfloat16"])
            if tie is None:
                matched += 1
            else:
                ties.append((j, int(lens[j])) + tie)

        # one full prefill and one 4-slot tick, each timed on the host
        # clock and then profiled: device time, kernels, B5a's share
        def measure(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            with settled_profile([ProfilerActivity.CUDA],
                                 torch.cuda.synchronize) as prof:
                fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            kernels = [e for e in evs if not e.key.startswith("Mem")]
            return {"wall_ms": wall,
                    "device_ms": sum(e.self_device_time_total
                                     for e in evs) / 1e3,
                    "kernels": sum(e.count for e in kernels),
                    "copies": sum(e.count for e in evs) - sum(
                        e.count for e in kernels),
                    "flash_ms": sum(e.self_device_time_total for e in evs
                                    if "flash_fwd" in e.key) / 1e3,
                    "routes": flash_routes(e.key for e in evs)}

        def prefill_once():
            job = engine.begin(rng.integers(0, opt.vocab, PROFILE_PROMPT)
                               .astype(np.int32), 1)
            engine.prefill_step(job)
            engine.finish(job.slot)

        prefill = measure(prefill_once)
        slots = [engine.admit(rng.integers(0, opt.vocab, PROFILE_PROMPT // 4)
                              .astype(np.int32), 8)[0]
                 for _ in range(engine.cache.num_slots)]
        engine.tick()
        tick = measure(engine.tick)
        for slot in slots:
            engine.finish(slot)
    finally:
        if env is None:
            os.environ.pop("DISTLEARN_TPU_ATTN", None)
        else:
            os.environ["DISTLEARN_TPU_ATTN"] = env
    check(prefill["routes"] == {"B5a": {"mma"}},
          f"the bfloat16 prefill ran flash kernels {prefill['routes']}, "
          "expected B5a on tensor cores only")
    share = prefill["flash_ms"] / prefill["device_ms"] \
        if prefill["device_ms"] else float("nan")
    log(f"[serve] (b) bfloat16, {SERVE_REQUESTS} requests from "
        f"{SERVE_THREADS} threads, prompts {sorted(int(n) for n in lens)}, "
        f"{SERVE_MAX_NEW} new tokens each: all complete; {len(buckets)} "
        f"full-prompt prefills (buckets {buckets}), {len(chunks)} chunk "
        f"passes; B5a launches {launches} = {opt.depth} x {full}")
    log(f"[serve] streams against isolated greedy_generate (bfloat16, "
        f"xla route): "
        f"{matched} of {SERVE_REQUESTS} equal"
        + ("" if not ties else "; near-ties (request, prompt len, token, "
           f"gap, top-2 margin): {ties}"))
    log("[serve] engine passes during the run (p50 ms, count): " + ", ".join(
        f"{k[6:]} {p50(spans.get(k, [])):.2f} ({len(spans.get(k, []))})"
        for k in ("serve.prefill", "serve.prefill_chunk", "serve.tick",
                  "serve.verify")))
    for what, m in ((f"one {PROFILE_PROMPT}-token prefill (bucket "
                     f"{engine.bucket_for(PROFILE_PROMPT)})", prefill),
                    (f"one tick of {engine.cache.num_slots} slots", tick)):
        log(f"[serve] {what}: {m['wall_ms']:.3f} ms on the host clock, "
            f"{m['device_ms']:.3f} ms of device time (idle "
            f"{1 - m['device_ms'] / m['wall_ms']:.1%}) in {m['kernels']} "
            f"kernels and {m['copies']} copies; B5a {m['flash_ms']:.3f} ms"
            + (" (flash_fwd_mma: tensor cores)" if m["routes"] else ""))
    log(f"[serve] TTFT p50 {ttft:.2f} ms, TPOT p50 {tpot:.2f} ms, {tokens} "
        f"tokens in {wall:.2f} s = {tokens / wall:.1f} tokens/s; B5a "
        f"{share:.1%} of a full prefill's device time")
    return {"launches": launches, "ttft_ms": ttft, "tpot_ms": tpot,
            "tokens_per_s": tokens / wall, "flash_share": share}


# ---------------------------------------------------------------------------
# Phase 11: kernels B5a (with residuals), B5b and B5c
# ---------------------------------------------------------------------------

def flash_work(B, H, D, L, elt):
    """Compulsory bytes, flops and the flops float32 runs on the CUDA cores
    (:func:`attn_bound`) of B5a (with m, l), B5c (with di) and B5b at one
    causal shape: N = B*H*L*(L+1)/2 (query, key) pairs; each [B, L, H, D]
    tensor read or written once, m, l and di 4 bytes a row; the score
    product S = Q K^T is 2*D*N of each."""
    pairs = B * H * L * (L + 1) // 2
    t, st = B * L * H * D * elt, B * H * L * 4
    di = 2 * B * H * L * D
    return {"fwd": (4 * t + 2 * st, 4 * D * pairs, 2 * D * pairs),
            "dq": (6 * t + 3 * st, 6 * D * pairs + di, 2 * D * pairs + di),
            "dkv": (6 * t + 3 * st, 8 * D * pairs, 2 * D * pairs)}


def within(torch, got, want, rtol, atol) -> tuple[bool, float]:
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    return ok, max_abs(torch, got, want)


def check_backward(torch, name, q, k, v, do, causal=True, mult=1.0):
    """B5a with residuals, B5c and B5b on one case: each against its twin
    (on the kernels' own residuals) and the xla route's autograd, the
    backward repeated bit for bit.  Returns ``(o, m, l, di)``, the max abs
    errors ``{"dq": (twin, xla, twin's own from xla), ...}`` and B5a's
    against its twin.  With q scaled by ``mult`` != 1 (FLASH_*_CASES)
    the gradients' distance from the xla route is measured, not held, and
    two absolute tolerances scale with ``mult``: m's (its float32 rounding
    scales with the scores) and dK's against its twin (see there)."""
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.parallel.sequence import local_attention
    dtype = q.dtype
    o, m, l = fa.flash_attention_fwd(q, k, v, causal)
    dq, di = fa.flash_attention_dq(q, k, v, o, do, m, l, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, m, l, di, causal)
    torch.cuda.synchronize()
    # bit for bit from run to run: no atomics, one owner per tile
    dq2, di2 = fa.flash_attention_dq(q, k, v, o, do, m, l, causal)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, m, l, di2, causal)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in
              ((dq, dq2), (di, di2), (dk, dk2), (dv, dv2))),
          f"flash backward {name}: a second run differs")
    for t, what in ((o, "o"), (m, "m"), (l, "l"), (dq, "dq"),
                    (dk, "dk"), (dv, "dv")):
        check(bool(torch.isfinite(t).all()),
              f"flash {name}: non-finite {what}")
    # the twins on the kernels' own residuals
    po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, causal)
    pdi = fa.flash_attention_di_plain(o, do)
    pdq = fa.flash_attention_dq_plain(q, k, v, do, m, l, pdi, causal)
    pdk, pdv = fa.flash_attention_dkv_plain(q, k, v, do, m, l, pdi, causal)
    # autograd of the xla route
    qx, kx, vx = (t.detach().clone().requires_grad_() for t in (q, k, v))
    xo = local_attention(qx, kx, vx, causal=causal, impl="xla")
    xdq, xdk, xdv = torch.autograd.grad(xo, (qx, kx, vx), do)
    del xo, qx, kx, vx
    tol = FLASH_BWD_TOL[str(dtype)[6:]]
    errs = {}
    for what, got, twin, xla in (("dq", dq, pdq, xdq), ("dk", dk, pdk, xdk),
                                 ("dv", dv, pdv, xdv)):
        rtol, atol = tol["twin"]
        ok_t, e_t = within(torch, got, twin, rtol,
                           atol * (mult if what == "dk" else 1))
        ok_x, e_x = within(torch, got, xla, *tol["xla"])
        check(ok_t, f"flash {name}: {what} outside rtol {rtol}, atol "
              f"{atol}{f' x {mult:g}' if what == 'dk' and mult != 1 else ''}"
              f" of its twin (max abs {e_t:.3g})")
        check(ok_x or mult != 1, f"flash {name}: {what} outside rtol, "
              f"atol = {tol['xla']} of the xla route's gradient (max abs "
              f"{e_x:.3g})")
        errs[what] = (e_t, e_x, max_abs(torch, twin, xla))
    ok_o, e_o = within(torch, o, po, *(
        (FLASH_F32_TOL, FLASH_F32_TOL) if dtype == torch.float32
        else (FLASH_BF16_TOL, FLASH_BF16_TOL)))
    e_m = max_abs(torch, m, pm)
    e_l = float(((l - pl).abs() / pl).max())
    e_di = max_abs(torch, di, pdi)
    check(ok_o and e_m <= 1e-5 * mult and e_l <= 1e-5 and e_di <= 1e-3 *
          max(1.0, float(pdi.abs().max())),
          f"flash {name}: forward residuals off their twins (o "
          f"{e_o:.3g}, m {e_m:.3g}, l {e_l:.3g} relative, di "
          f"{e_di:.3g})")
    return (o, m, l, di), errs, e_o


def phase_flash_backward(torch, card):
    import torch.nn.functional as F
    from distlearn_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rate, part = hbm_rate(card)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    # which kernels a call runs, by name in a profile of five forwards and
    # backwards per dtype at the training shape, taken first: after the
    # timing loops below the profiler was seen to drop a session's first
    # device events (one after one shape, all of one call after all)
    route_gen = torch.Generator(device=dev).manual_seed(12)
    for dtype, want in ((torch.float32, FLASH_F32_ROUTES),
                        (torch.bfloat16, FLASH_BF16_ROUTES)):
        q, k, v, do = flash_inputs(torch, route_gen, *FLASH_TRAIN, dtype, 4)
        keys = profiled_counts(torch, lambda: [fa.flash_attention_bwd(
            q, k, v, *fa.flash_attention_fwd(q, k, v), do)
            for _ in range(5)])
        routes = flash_routes(keys)
        log(f"[flash-bwd] {str(dtype)[6:]} call at the training shape ran: "
            + ", ".join(f"{t} {'/'.join(sorted(r))}"
                        for t, r in sorted(routes.items())))
        check(routes == want, f"{dtype} flash call ran {routes}, expected "
              f"{want} (mma: bfloat16 tensor cores, tf32x3: float32 tensor "
              f"cores in 3xTF32, core: CUDA cores); device events "
              f"{[key[:60] for key in keys]}")
    del q, k, v, do
    rows = {}
    for B, H, D, L in FLASH_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            name = case_name(B, H, D, L, dtype)
            q, k, v, do = flash_inputs(torch, gen, B, H, D, L, dtype, 4)
            (o, m, l, di), errs, e_o = check_backward(torch, name, q, k, v,
                                                      do)

            work = flash_work(B, H, D, L, 4 if dtype == torch.float32 else 2)
            main = (B, H, D, L) == FLASH_TRAIN
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2)
            so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            timed = {
                "fwd": (lambda: fa.flash_attention_fwd(q, k, v),
                        lambda: fa.flash_attention_fwd_plain(q, k, v)),
                "dq": (lambda: fa.flash_attention_dq(q, k, v, o, do, m, l),
                       lambda: fa.flash_attention_dq_plain(
                           q, k, v, do, m, l,
                           fa.flash_attention_di_plain(o, do))),
                "dkv": (lambda: fa.flash_attention_dkv(q, k, v, do, m, l,
                                                       di),
                        lambda: fa.flash_attention_dkv_plain(
                            q, k, v, do, m, l, di)),
            }
            line = []
            for kern, (fn, plain) in timed.items():
                nbytes, flops, core_flops = work[kern]
                bound, bound_by = attn_bound(torch, nbytes, flops, dtype,
                                             rate, core_flops)
                ms = time_ms(torch, fn, flush)
                row = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
                       "plain_ms": time_ms(torch, plain, flush) if main
                       else None}
                core = ""
                if dtype == torch.float32:
                    # what the CUDA cores alone would bound it at
                    row["core_bound_ms"] = max(nbytes / rate,
                                               flops / FP32_FLOPS) * 1e3
                    core = f", CUDA-core bound {row['core_bound_ms']:.4f}"
                rows[(B, H, D, L, dname, kern)] = row
                line.append(f"{kern} {ms:.4f} ms (bound {bound:.4f}, "
                            f"{bound_by}; {bound / ms:.1%}{core})")
            sdpa_ms = time_ms(torch, lambda: torch.autograd.grad(
                so, (qt, kt, vt), dot, retain_graph=True), flush)
            with torch.no_grad():
                rows[(B, H, D, L, dname, "fwd")]["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush)
            for kern in ("dq", "dkv"):
                rows[(B, H, D, L, dname, kern)]["library_ms"] = sdpa_ms
            bwd_ms = rows[(B, H, D, L, dname, "dq")]["ms"] + \
                rows[(B, H, D, L, dname, "dkv")]["ms"]
            log(f"[flash-bwd] {name}: " + ", ".join(line)
                + f" | B5c + B5b {bwd_ms:.4f} ms against sdpa backward "
                f"{sdpa_ms:.4f} ms ({bwd_ms / sdpa_ms:.1f}x), sdpa forward "
                f"{rows[(B, H, D, L, dname, 'fwd')]['library_ms']:.4f} ms"
                + ("" if not main else " | plain twins: " + ", ".join(
                    f"{kk} {rows[(B, H, D, L, dname, kk)]['plain_ms']:.3f} "
                    "ms" for kk in timed))
                + " | max abs err (twin, xla): " + ", ".join(
                    f"{kk} {e[0]:.3g}, {e[1]:.3g}" for kk, e in errs.items()))
            for kern, what in (("dq", "dq"), ("dkv", "dk")):
                rows[(B, H, D, L, dname, kern)]["max_abs_err"] = \
                    errs[what][0] if kern == "dq" else max(errs["dk"][0],
                                                           errs["dv"][0])
            rows[(B, H, D, L, dname, "fwd")]["max_abs_err"] = e_o
            del so, qt, kt, vt, q, k, v, do, o, m, l, di
    del flush
    for dtype, (B, H, D, L, causal, mult) in (
            [(torch.bfloat16, c) for c in FLASH_BF16_CASES]
            + [(torch.float32, c) for c in FLASH_F32_CASES]):
        name = case_name(B, H, D, L, dtype, causal, mult)
        q, k, v, do = flash_inputs(torch, gen, B, H, D, L, dtype, 4, mult)
        _, errs, e_o = check_backward(torch, name, q, k, v, do, causal,
                                      mult)
        log(f"[flash-bwd] {name}: max abs err (twin, xla; the twin's own "
            "from xla): " + ", ".join(
                f"{kk} {a:.3g}, {b:.3g}; {c:.3g}"
                for kk, (a, b, c) in errs.items())
            + f"; o {e_o:.3g} (twin)"
            + ("" if mult == 1 else "; xla distance measured, not held"))
    torch.cuda.empty_cache()
    log(f"[flash-bwd] every shape and dtype: dQ, dK, dV within "
        f"{FLASH_BWD_TOL['float32']['twin']} (float32) of the twins and "
        f"{FLASH_BWD_TOL['float32']['xla']} of the xla route, bfloat16 "
        f"within rtol = atol = {FLASH_BF16_TOL}; a second backward equal bit "
        "for bit; bounds at "
        f"{rate / 1e12:.2f} TB/s ({part}), {FP32_FLOPS / 1e12:.0f} TFLOP/s "
        f"float32 CUDA cores (S of B5a, B5b, B5c; di of B5c), "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 / {TF32_PASSES} passes (the "
        "other float32 products), "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bfloat16")
    B, H, D, L = FLASH_TRAIN
    return {kern: dict(rows[(B, H, D, L, "bfloat16", kern)],
                       float32=rows[(B, H, D, L, "float32", kern)])
            for kern in ("fwd", "dq", "dkv")}


# ---------------------------------------------------------------------------
# Phase 12: LM training at full width
# ---------------------------------------------------------------------------

def lm_train_flops(vocab, dim, depth, max_len, batch, mlp_ratio=4):
    """Model FLOPs of one training step (forward and backward, no
    recompute): per token and block 2*(4 E^2 + 2 E F) for the
    projections and FFN and 2*E*(L+1) for causal attention, 2*E*V for the
    tied logits; the backward twice the forward."""
    E, F, L = dim, dim * mlp_ratio, max_len
    per_token = depth * (2 * (4 * E * E + 2 * E * F) + 2 * E * (L + 1)) \
        + 2 * E * vocab
    return 3 * per_token * batch * L


FLASH_KERNELS = (("B5a", "flash_fwd"), ("B5b", "flash_bwd_dkv"),
                 ("B5c", "flash_bwd_dq"))
# the kernels a bfloat16 call runs: all three on tensor cores (mma)
FLASH_BF16_ROUTES = {"B5a": {"mma"}, "B5b": {"mma"}, "B5c": {"mma"}}
# the kernels a float32 call runs: all three on the tensor cores in 3xTF32
# (their scores on the CUDA cores)
FLASH_F32_ROUTES = {"B5a": {"tf32x3"}, "B5b": {"tf32x3"}, "B5c": {"tf32x3"}}


def flash_routes(keys) -> dict:
    """{"B5a": {"mma"}, ...}: the flash kernels that profiler ``keys`` name,
    each with the routes seen, "mma" (``*_mma``: bfloat16 tensor cores),
    "tf32x3" (``*_tf32x3``: float32 on the tensor cores in 3xTF32) or
    "core" (any other: a CUDA-core kernel, which no call should run)."""
    routes = {}
    for key in keys:
        for tag, sub in FLASH_KERNELS:
            if sub in key:
                routes.setdefault(tag, set()).add(
                    "mma" if f"{sub}_mma" in key else "tf32x3"
                    if f"{sub}_tf32x3" in key else "core")
    return routes


def flash_profile(evs) -> tuple[dict, dict, dict]:
    """Each flash kernel's device ms, launches and routes among profiler
    events ``evs``."""
    shares = {tag: sum(e.self_device_time_total for e in evs
                       if key in e.key) / 1e3 for tag, key in FLASH_KERNELS}
    counts = {tag: sum(e.count for e in evs if key in e.key)
              for tag, key in FLASH_KERNELS}
    return shares, counts, flash_routes(e.key for e in evs)


def profiled_counts(torch, fn) -> dict:
    """``{name: launches}`` of the device events of one profiled,
    synchronised ``fn()`` (CPU and CUDA activities, as phase 12's
    profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile
    torch.cuda.synchronize()
    with settled_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         torch.cuda.synchronize) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def flash_counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_dkv.launches,
            fa.flash_attention_dq.launches)


def reset_flash_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention_dkv.launches = 0
    fa.flash_attention_dq.launches = 0


def phase_train_lm(torch, tree):
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.utils.profiling import settled_profile

    import numpy as np
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.train import lm as tlm
    from distlearn_tpu_torch.utils.tree import tree_leaves

    cfg = dict(LM_TRAIN, compute_dtype=torch.bfloat16)
    B, L = LM_TRAIN_BATCH, LM_TRAIN["max_len"]
    depth = LM_TRAIN["depth"]
    models = {(impl, remat): transformer_lm(attn_impl=impl, remat=remat,
                                            **cfg)
              for impl, remat in (("flash", False), ("xla", False),
                                  ("flash", "full"), ("flash", "mlp"))}
    t0 = time.perf_counter()
    params0, _ = models[("flash", False)].init(0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, LM_TRAIN["vocab"], (B, L)).astype(np.int32)).cuda()
    log(f"[train] transformer_lm {LM_TRAIN}, bfloat16 compute: {n_params:,} "
        f"float32 params from the seeded init in "
        f"{time.perf_counter() - t0:.1f} s; batch {B} x {L} uniform tokens, "
        f"lr {LM_TRAIN_LR}, one NCCL rank")

    def steps(step, state, n, timed=False):
        """n steps; returns the state, the float losses and (timed) the
        host seconds of the last n-2 steps, synchronised."""
        losses = []
        for i in range(n):
            if timed and i == 2:
                torch.cuda.synchronize()
                t = time.perf_counter()
            state, loss = step(state, tokens)
            losses.append(loss)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t) / (n - 2) if timed else None
        return state, [float(x) for x in losses], secs

    def update_err(p1, ref1):
        """Largest per-leaf norm of the update's difference from the
        reference update, over the reference update's norm."""
        worst = 0.0
        for a, b, z in zip(tree_leaves(p1), tree_leaves(ref1),
                           tree_leaves(params0)):
            du = (a.double() - z.double()) - (b.double() - z.double())
            ref = (b.double() - z.double()).norm()
            worst = max(worst, float(du.norm() / ref) if ref > 0 else
                        float(du.norm()))
        return worst

    def max_diff(p1, ref1):
        return max(max_abs(torch, a, b) for a, b in
                   zip(tree_leaves(p1), tree_leaves(ref1)))

    per_mode = {}

    # (a) the main path: 20 steps of build_lm_step on the flash route
    step = tlm.build_lm_step(models[("flash", False)], tree,
                             lr=LM_TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts(fa)
    t = time.perf_counter()
    params, losses, _ = steps(step, params0, LM_TRAIN_STEPS)
    wall = time.perf_counter() - t
    launches = flash_counts(fa)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the LM loss did not fall: {losses}")
    check(launches == (depth * LM_TRAIN_STEPS,) * 3,
          f"B5a/B5b/B5c launched {launches} times in {LM_TRAIN_STEPS} "
          f"steps, expected {depth} each a step")
    log(f"[train] (a) {LM_TRAIN_STEPS} steps: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} ({' '.join(f'{x:.4f}' for x in losses)}); "
        f"launches B5a {launches[0]}, B5b {launches[1]}, B5c {launches[2]} "
        f"= {depth} each a step; {wall:.2f} s with the first step")
    del params

    # (b) one step on the flash route against the xla route
    one = {}
    for impl in ("flash", "xla"):
        st = tlm.build_lm_step(models[(impl, False)], tree,
                               lr=LM_TRAIN_LR)
        p1, loss = st(params0, tokens)
        one[impl] = (p1, float(loss))
        torch.cuda.synchronize()
    dl = abs(one["flash"][1] - one["xla"][1])
    du = update_err(one["flash"][0], one["xla"][0])
    log(f"[train] (b) one step, flash against xla: loss {one['flash'][1]:.6f}"
        f" against {one['xla'][1]:.6f} (|diff| {dl:.3g}, rtol "
        f"{LM_ROUTE_LOSS_RTOL}); worst leaf update off by {du:.3g} of its "
        f"norm (tolerance {LM_ROUTE_UPDATE_TOL})")
    check(dl <= LM_ROUTE_LOSS_RTOL * abs(one["xla"][1]),
          "flash and xla routes' losses differ")
    check(du <= LM_ROUTE_UPDATE_TOL, "flash and xla routes' updates differ")
    del one["xla"]
    torch.cuda.empty_cache()

    # (c) remat full and mlp against none, with their launch counts
    for remat, b5a in (("full", 2 * depth), ("mlp", depth)):
        st = tlm.build_lm_step(models[("flash", remat)], tree,
                               lr=LM_TRAIN_LR)
        torch.cuda.synchronize()
        reset_flash_counts(fa)
        p1, loss = st(params0, tokens)
        torch.cuda.synchronize()
        got = flash_counts(fa)
        check(got == (b5a, depth, depth),
              f"remat {remat}: launches B5a/B5b/B5c {got}, expected "
              f"{(b5a, depth, depth)} in one step")
        dl = abs(float(loss) - one["flash"][1])
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in
                 zip(tree_leaves(p1), tree_leaves(one["flash"][0])))
        log(f"[train] (c) remat {remat}: loss |diff| {dl:.3g}, params max "
            f"diff {max_diff(p1, one['flash'][0]):.3g} against no remat; "
            f"launches B5a {got[0]}, B5b {got[1]}, B5c {got[2]}")
        check(dl <= 1e-6 * abs(one["flash"][1]) and ok,
              f"remat {remat} changes the step")
        del p1
    del one

    # (d) the mixed step: bfloat16 working params, float32 masters
    mixed = tlm.build_lm_mixed_step(models[("flash", False)], tree,
                                    lr=LM_TRAIN_LR)
    mst = tlm.init_lm_mixed_state(params0)
    mlosses = []
    for _ in range(10):
        mst, loss = mixed(mst, tokens)
        mlosses.append(float(loss))
        check(all(torch.equal(p, m.to(torch.bfloat16)) for p, m in
                  zip(tree_leaves(mst.params), tree_leaves(mst.master))),
              "mixed step: params != master.to(bfloat16)")
    check(all(math.isfinite(x) for x in mlosses) and mlosses[-1] < mlosses[0],
          f"mixed step: the loss did not fall: {mlosses}")
    log(f"[train] (d) mixed step, 10 steps: loss {mlosses[0]:.5f} -> "
        f"{mlosses[-1]:.5f}; params == master.to(bfloat16) bit for bit "
        "after every step")
    del mst
    torch.cuda.empty_cache()

    # (e) throughput and memory per mode, then one profiled step
    flops = lm_train_flops(LM_TRAIN["vocab"], LM_TRAIN["dim"], depth, L, B)
    modes = (("none", models[("flash", False)], tlm.build_lm_step, False),
             ("full", models[("flash", "full")], tlm.build_lm_step, False),
             ("mlp", models[("flash", "mlp")], tlm.build_lm_step, False),
             ("mixed", models[("flash", False)], tlm.build_lm_mixed_step,
              True))
    for name, model, build, is_mixed in modes:
        st = build(model, tree, lr=LM_TRAIN_LR)
        state = tlm.init_lm_mixed_state(params0) if is_mixed else params0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, _, secs = steps(st, state, LM_TIMED_STEPS + 2, timed=True)
        mfu = flops / secs / BF16_FLOPS
        per_mode[name] = {"step_ms": secs * 1e3, "steps_per_s": 1 / secs,
                          "tokens_per_s": B * L / secs, "mfu": mfu,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(mfu <= 1.0, f"MFU {mfu:.3f} > 1 in mode {name}: the timing "
              "or the FLOP count is wrong")
        del state
    log(f"[train] (e) model FLOPs a step {flops / 1e12:.3f} TFLOP "
        f"(analytic); per mode, the mean of {LM_TIMED_STEPS} steps after 2 "
        "untimed: " + "; ".join(
            f"{k} {v['step_ms']:.2f} ms = {v['steps_per_s']:.2f} steps/s, "
            f"{v['tokens_per_s']:.0f} tokens/s, MFU {v['mfu']:.3f}, peak "
            f"{v['peak_gb']:.2f} GB" for k, v in per_mode.items()))

    torch.cuda.synchronize()
    with settled_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         torch.cuda.synchronize) as prof:
        t = time.perf_counter()
        p1, _ = step(params0, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    del p1
    evs = device_events(prof)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    check(busy > 0, "torch.profiler saw no device time in the LM step")
    shares, counts, routes = flash_profile(evs)
    check(routes == FLASH_BF16_ROUTES,
          f"the bfloat16 LM step ran flash kernels {routes}, expected "
          f"{FLASH_BF16_ROUTES} (mma: tensor cores, core: CUDA cores)")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[train] (e) one profiled step: {wall_ms:.2f} ms wall (profiler "
        f"on), device busy {busy:.2f} ms, idle {1 - busy / wall_ms:.1%}; "
        + ", ".join(f"{tag} {ms:.2f} ms = {ms / busy:.1%} in "
                    f"{counts[tag]} launches" for tag, ms in shares.items())
        + "; all three on tensor cores (flash_fwd_mma, flash_bwd_dkv_mma, "
        "flash_bwd_dq_mma)")
    for e in top:
        log(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms  "
            f"x{e.count:<4d} {e.key[:90]}")
    # the profile lost no device event: every flash launch of the step is
    # in it (phase 11's late sessions once dropped a session's first ones)
    check(counts == {tag: depth for tag, _ in FLASH_KERNELS},
          f"the profiled step names flash launches {counts}, expected "
          f"{depth} of each: the profile lost device events")
    del models, step
    torch.cuda.empty_cache()
    f32 = train_lm_float32(torch, tree, params0, tokens)
    return {"launches": {"flash_attention_dkv": launches[1],
                         "flash_attention_dq": launches[2],
                         "flash_attention_train": launches[0]},
            "modes": per_mode, "busy_ms": busy, "wall_ms": wall_ms,
            "shares": shares, "float32": f32}


def train_lm_float32(torch, tree, params0, tokens):
    """Phase 12(f): the LM step in float32 compute (TF32 off since phase
    1) on the flash route, B5a, B5b and B5c on their 3xTF32 kernels: the
    first step's loss and every leaf's update against the xla route's, 3
    timed steps after it, one profiled step.  Returns the launches, the
    step time, the pair's (B5b + B5c) and B5a's device time."""
    from torch.profiler import ProfilerActivity
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.train import lm as tlm
    from distlearn_tpu_torch.utils.profiling import settled_profile
    from distlearn_tpu_torch.utils.tree import tree_leaves

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "the float32 leg needs TF32 off for matmuls and cuDNN")
    depth, lr = LM_TRAIN["depth"], LM_TRAIN_LR
    step = tlm.build_lm_step(transformer_lm(attn_impl="flash", **LM_TRAIN),
                             tree, lr=lr)
    xla_step = tlm.build_lm_step(transformer_lm(attn_impl="xla",
                                                **LM_TRAIN), tree, lr=lr)
    # the first step against the xla route's
    p_x, loss_x = xla_step(params0, tokens)
    loss_x = float(loss_x)
    torch.cuda.synchronize()
    reset_flash_counts(fa)
    params, loss = step(params0, tokens)
    loss = float(loss)
    dl = abs(loss - loss_x)
    rtol, atol = LM_F32_GRAD_TOL
    worst, worst_leaf = 0.0, None
    for i, (a, b, z) in enumerate(zip(tree_leaves(params), tree_leaves(p_x),
                                      tree_leaves(params0))):
        ua, ub = a.double() - z.double(), b.double() - z.double()
        # the largest ratio of |difference| to its allowance, 1 at the edge
        ratio = float(((ua - ub).abs() / (lr * atol + rtol * ub.abs()))
                      .max())
        if ratio > worst:
            worst, worst_leaf = ratio, (i, tuple(a.shape))
    del p_x
    log(f"[train] (f) float32 compute, TF32 off, one step, flash against "
        f"xla: loss {loss:.7f} against {loss_x:.7f} (|diff| {dl:.3g}, rtol "
        f"{LM_F32_LOSS_RTOL}); every leaf's update within rtol {rtol}, atol "
        f"lr x {atol} of the xla route's, worst at {worst:.3g} of its "
        f"allowance (leaf {worst_leaf})")
    check(math.isfinite(loss) and dl <= LM_F32_LOSS_RTOL * abs(loss_x),
          "float32: the flash and xla routes' losses differ")
    check(worst <= 1.0, f"float32: leaf {worst_leaf}'s update is off the "
          "xla route's")
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = []
    for _ in range(LM_F32_TIMED_STEPS):
        params, loss = step(params, tokens)
        losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / LM_F32_TIMED_STEPS * 1e3
    launches = flash_counts(fa)
    n = LM_F32_TIMED_STEPS + 1
    check(all(math.isfinite(x) for x in losses),
          f"float32: non-finite loss {losses}")
    check(launches == (depth * n,) * 3,
          f"float32: B5a/B5b/B5c launched {launches} times in {n} steps, "
          f"expected {depth} each a step")
    torch.cuda.synchronize()
    with settled_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         torch.cuda.synchronize) as prof:
        params, _ = step(params, tokens)
        torch.cuda.synchronize()
    del params
    evs = device_events(prof)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    check(busy > 0, "torch.profiler saw no device time in the float32 step")
    shares, counts, routes = flash_profile(evs)
    pair = shares["B5b"] + shares["B5c"]
    log(f"[train] (f) float32 step: {step_ms:.2f} ms (mean of "
        f"{LM_F32_TIMED_STEPS} after 1, host clock, synchronised), losses "
        f"{' '.join(f'{x:.5f}' for x in losses)}; launches B5a "
        f"{launches[0]}, B5b {launches[1]}, B5c {launches[2]} in {n} steps; "
        f"one profiled step: device busy {busy:.2f} ms, B5c + B5b "
        f"{pair:.2f} ms = {pair / busy:.1%} (B5b {shares['B5b']:.2f}, B5c "
        f"{shares['B5c']:.2f} ms), B5a {shares['B5a']:.2f} ms = "
        f"{shares['B5a'] / busy:.1%}; names {counts}, routes {routes}")
    check(routes == FLASH_F32_ROUTES,
          f"the float32 LM step ran flash kernels {routes}, expected "
          f"{FLASH_F32_ROUTES}")
    check(counts == {tag: depth for tag, _ in FLASH_KERNELS},
          f"the profiled float32 step names flash launches {counts}, "
          f"expected {depth} of each")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        log(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms  "
            f"x{e.count:<4d} {e.key[:90]}")
    return {"launches": launches, "step_ms": step_ms, "busy_ms": busy,
            "pair_ms": pair, "b5a_ms": shares["B5a"], "loss_diff": dl,
            "update_ratio": worst}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phases 13-14: the examples and the entry point
# ---------------------------------------------------------------------------

def run_example(args: list[str]) -> str:
    """One example as its own process on the card; its stdout."""
    cmd = [sys.executable, "-m", f"distlearn_tpu_torch.examples.{args[0]}",
           *args[1:]]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                         timeout=EXAMPLE_TIMEOUT_S)
    check(out.returncode == 0, f"{' '.join(args)} exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    log(f"[examples] {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
    for line in out.stderr.splitlines():
        if "numNodes" in line:
            log(f"[examples]   stderr: {line}")
    return out.stdout


def accuracies(stdout: str) -> tuple[dict | None, list[float]]:
    """The last parity line (or None) and every accuracy an epoch line or
    the parity line reports."""
    parity, accs = None, []
    for line in stdout.splitlines():
        if line.startswith("{"):
            parity = json.loads(line)
            accs += [v for k, v in parity.items() if k.endswith("_acc")]
        elif line.startswith("epoch "):
            accs += [float(v) for v in re.findall(r"accuracy ([-\w.]+)",
                                                  line)]
    return parity, accs


def phase_examples(torch):
    for args in EXAMPLES:
        stdout = run_example(args)
        parity, accs = accuracies(stdout)
        if parity is not None:
            log(f"[examples]   {json.dumps(parity)}")
        else:
            log("[examples]   " + " | ".join(
                ln for ln in stdout.splitlines() if ln.startswith("epoch")))
        check(accs and all(math.isfinite(a) and a > CHANCE for a in accs),
              f"{' '.join(args)}: accuracies {accs} not all finite and above "
              f"chance ({CHANCE})")
        if "--parity" in args:
            check(parity is not None, f"{' '.join(args)}: no parity line")
        if "--numNodes" in args:
            check(parity["nodes"] == torch.cuda.device_count(),
                  f"--numNodes 4 on {torch.cuda.device_count()} card(s) ran "
                  f"{parity['nodes']} node(s)")


def phase_entry(torch):
    from distlearn_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    check(args[1].device.type == "cuda", "entry() did not run on the card")
    card = fn(*args)
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    cpu = cpu_fn(*cpu_args)
    torch.cuda.synchronize()
    diff = max_abs(torch, card, cpu.to(card.device))
    log(f"[entry] graft_entry.entry() on the card: log-probs {tuple(card.shape)}"
        f", max diff against the CPU route {diff:.3e} (tol "
        f"{CPU_REF_LOGP_TOL:.0e})")
    check(bool(torch.isfinite(card).all()) and diff <= CPU_REF_LOGP_TOL,
          "entry() on the card disagrees with its CPU route")


# ---------------------------------------------------------------------------
# Phase 15: the process-per-node path over the TCP tree and ring
# ---------------------------------------------------------------------------

HOST_NODES = 4
CLIENT_REMOTE = ["--numNodes", str(HOST_NODES), "--communicationTime", "4",
                 "--numEpochs", "2", "--numExamples", "4096",
                 "--batchSize", "128"]
HOST_ROUNDS = 10              # timed device-tensor allreduces a topology
HOST_SGD_STEPS = (3, 4, 5, 6)  # rank i's TreeAllReduceSGD steps
HOST_EA_STEPS = (2, 4, 6, 8)   # rank i's local steps an epoch, TreeAllReduceEA
HOST_EA_TAU, HOST_EA_EPOCHS = 2, 2
HOST_TIMEOUT_S = 300
HOST_DEVICE = "cuda"           # the rank processes' device (cuda:0)


def run_client_remote(backend: str) -> list[dict]:
    """``examples/client_remote.py`` as HOST_NODES processes on the card;
    each rank's digest, elastic rounds, B2 launches and epoch losses."""
    port = free_port_window(1)
    cmd = [sys.executable, "-m", "distlearn_tpu_torch.examples.client_remote",
           *CLIENT_REMOTE, "--backend", backend, "--port", str(port),
           "--device", HOST_DEVICE]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--nodeIndex", str(i + 1)], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(HOST_NODES)]
    ranks = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=HOST_TIMEOUT_S)
            check(p.returncode == 0, f"client_remote --backend {backend} "
                  f"node {i + 1} exited {p.returncode}: {err[-2000:]}")
            digest = re.search(r"final params digest (\w+)", out)
            counts = re.search(r"elastic rounds (\d+), fused_elastic "
                               r"launches (\d+)", out)
            check(digest and counts, f"client_remote node {i + 1} printed "
                  f"no digest or counts: {out[-1000:]}")
            ranks.append({"digest": digest.group(1),
                          "rounds": int(counts.group(1)),
                          "launches": int(counts.group(2)),
                          "losses": [float(v) for v in re.findall(
                              r"mean loss ([-\w.]+)", out)]})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[host] client_remote --backend {backend} x{HOST_NODES} on "
        f"{HOST_DEVICE}:"
        f" {time.perf_counter() - t0:.1f} s; digests "
        f"{[r['digest'] for r in ranks]}; elastic rounds / B2 launches "
        f"{[(r['rounds'], r['launches']) for r in ranks]}; node 1's epoch "
        f"losses {ranks[0]['losses']}")
    return ranks


def host_worker(rank: int, n: int, ports: tuple, device: str, q) -> None:
    """One rank of the device-tensor checks (a spawned process on
    ``device``, ``cuda:0`` on the card): the convnet's 18 leaves through
    the tree and the ring against the numpy route, timed; one int8-codec
    tree round against the numpy route; TreeAllReduceSGD with uneven steps
    and TreeAllReduceEA with uneven rounds and ``synchronize_center``, each
    run twice over the tree on the same seeds, with tensors on ``device``
    and with numpy arrays (the JAX package's arithmetic)."""
    try:
        import hashlib

        import numpy as np
        import torch
        from distlearn_tpu_torch.comm.ring import LocalhostRing
        from distlearn_tpu_torch.comm.tree import LocalhostTree
        from distlearn_tpu_torch.ops import fused_update as fu
        from distlearn_tpu_torch.parallel.host_algorithms import (
            TreeAllReduceEA, TreeAllReduceSGD)
        from distlearn_tpu_torch.utils.flags import EA_FLAGS
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def raw(leaves) -> list[bytes]:
            return [(x.cpu().numpy() if isinstance(x, torch.Tensor)
                     else x).tobytes() for x in leaves]

        def on_dev(leaves) -> bool:
            return all(isinstance(x, torch.Tensor) and x.device == dev
                       for x in leaves)

        def card_leaf(a):
            return torch.from_numpy(a).to(dev)

        def host_leaf(a):
            return a

        def sgd_run(h, leaf):
            r = np.random.RandomState(2000 + rank)
            sgd = TreeAllReduceSGD(h)
            params = sgd.synchronize_parameters(
                [leaf(np.zeros_like(a)) for a in host])
            for _ in range(HOST_SGD_STEPS[rank]):
                g = [leaf(r.randn(*a.shape).astype(np.float32))
                     for a in host]
                g, _ = sgd.sum_and_normalize_gradients(g)
                params = [p - 0.01 * gi for p, gi in zip(params, g)]
            return sgd.synchronize_parameters(params)

        def ea_run(h, leaf):
            # client_remote's alpha; each local step subtracts the same
            # float32 drift in both runs, so only the sync differs
            r = np.random.RandomState(3000 + rank)
            ea = TreeAllReduceEA(h, tau=HOST_EA_TAU,
                                 alpha=EA_FLAGS["alpha"][0])
            params = ea.synchronize_parameters([leaf(a.copy()) for a in host])
            for _ in range(HOST_EA_EPOCHS):
                for _ in range(HOST_EA_STEPS[rank]):
                    params = [p - leaf((r.randn(*a.shape) * 0.01).astype(
                        np.float32)) for p, a in zip(params, host)]
                    params = ea.average_parameters(params)
                params = ea.synchronize_center(params)
            return params, ea.center, ea.rounds

        rng = np.random.RandomState(1000 + rank)
        host = [rng.randn(*s).astype(np.float32) for s in convnet_shapes()]
        card = [card_leaf(a) for a in host]
        res = {"rank": rank}
        for name, make, port in (("tree", LocalhostTree, ports[0]),
                                 ("ring", LocalhostRing, ports[1])):
            h = make(rank, n, port)
            want, m = h.all_reduce(host)
            splits = []
            for i in range(HOST_ROUNDS + 1):         # the first is warm-up
                nic = h.nic_bytes()
                sync()
                t0 = time.perf_counter()
                got, m = h.all_reduce(card)
                sync()
                wall = time.perf_counter() - t0
                stage, rnd, _ = h.last_split
                if i:
                    splits.append((stage, rnd, wall - stage - rnd,
                                   h.nic_bytes() - nic))
            same = all(g.device == dev and g.dtype == torch.float32
                       for g in got) and raw(got) == raw(want)
            kept = raw(card) == raw(host)
            res[name] = {"bits": same and kept and m == n, "splits": splits}
            if name == "tree":
                want8, _ = h.all_reduce_ex(host, codec="int8")[:2]
                got8, _ = h.all_reduce_ex(card, codec="int8")[:2]
                res["int8_bits"] = raw(got8) == raw(want8)
                params = sgd_run(h, card_leaf)
                res["sgd_digest"] = hashlib.sha256(
                    b"".join(raw(params))).hexdigest()
                res["sgd_bits"] = (on_dev(params) and raw(params)
                                   == raw(sgd_run(h, host_leaf)))
                before = fu.fused_elastic.launches
                params, center, rounds = ea_run(h, card_leaf)
                launches = fu.fused_elastic.launches - before
                want_p, want_c, want_rounds = ea_run(h, host_leaf)
                res["ea"] = {
                    "bits": (on_dev(params) and on_dev(center)
                             and raw(params) == raw(want_p)
                             and raw(center) == raw(want_c)),
                    "rounds": rounds, "numpy_rounds": want_rounds,
                    "launches": launches}
            h.close()
        q.put(("ok", res))
    except Exception as e:  # noqa: BLE001 — reported by the parent
        import traceback
        q.put(("err", {"rank": rank, "error": repr(e),
                       "trace": traceback.format_exc()[-2000:]}))


def run_workers(target, n: int, args: tuple, timeout: float, what: str
                ) -> list[dict]:
    """``target(i, *args, q)`` in ``n`` spawned processes; each puts one
    ``("ok", result)`` or ``("err", traceback)`` on ``q``.  Returns the
    results by ``result["rank"]``; a failed process fails the run."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(i, *args, q))
             for i in range(n)]
    for p in procs:
        p.start()
    try:
        results = [q.get(timeout=timeout) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errs = [r for kind, r in results if kind == "err"]
    check(not errs, f"a {what} failed: {errs[:1]}")
    return sorted((r for _, r in results), key=lambda r: r["rank"])


def toy_model(torch):
    """The toy linear classifier of tests/test_multihost.py::_spmd_worker."""
    from distlearn_tpu_torch.models.core import Model

    def init(seed=0, device=None):
        g = torch.Generator().manual_seed(seed)
        params = {"w": torch.randn(16, 10, generator=g) * 0.1,
                  "b": torch.zeros(10)}
        return {k: v.to(device) for k, v in params.items()}, {}

    def apply(params, state, x, train=True, rng=None, tree=None,
              bn_weight=None):
        logits = x.reshape(x.shape[0], -1) @ params["w"] + params["b"]
        return torch.log_softmax(logits, dim=-1), state

    return Model(init=init, apply=apply, name="toy", input_shape=(4, 4, 1),
                 num_classes=10)


def phase_host(torch) -> dict:
    import numpy as np
    import torch.distributed as dist
    from distlearn_tpu_torch.comm import native
    from distlearn_tpu_torch.models import mnist_cnn
    from distlearn_tpu_torch.ops import flatten as flatten_lib
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.ops import wire_kernels as wk
    from distlearn_tpu_torch.ops import wire_native
    from distlearn_tpu_torch.parallel import init as pinit
    from distlearn_tpu_torch.train import build_sgd_step, init_train_state
    from distlearn_tpu_torch.utils.flags import EA_FLAGS

    # the host libraries, built from the checkout: no quiet numpy fallback
    check(native.available(), "comm/native.py did not build src/comm/"
          "distcomm.cpp (the transport and the tree's reduction)")
    check(wire_native.available(), "ops/wire_native.py is unavailable: "
          f"{wire_native.why_unavailable()}")
    rng = np.random.RandomState(5)
    delta = [rng.randn(*s).astype(np.float32) * 1e-3
             for s in convnet_shapes()]
    for d in delta:
        q, r = np.empty(d.shape, np.int8), np.empty_like(d)
        scale = wk.quantize_ef_into(d, q, r)       # the C codec
        pq, ps, pr = wk.quantize_ef_plain(torch.from_numpy(d))
        check(scale == ps and np.array_equal(q, pq.numpy())
              and r.tobytes() == pr.numpy().tobytes(),
              "the SIMD host codec disagrees with B3's plain twin")
    log("[host] native reduce and the SIMD C host codec built; the codec "
        "bit for bit B3's plain twin over the convnet's 18 leaves")

    # B2 at the bucket client_remote gives it (mnist_cnn's, padded) and at
    # client_remote's alpha, against its plain twin
    # B2 counts only launches on the card: the CPU rehearsal's twin none
    b2_per_round = 1 if HOST_DEVICE == "cuda" else 0
    alpha = EA_FLAGS["alpha"][0]
    params = mnist_cnn().init(0, device=HOST_DEVICE)[0]
    spec = flatten_lib.make_bucket_spec(params)
    for p in flatten_lib.pack_buckets(spec, params):
        gen = torch.Generator(device=p.device).manual_seed(11)
        c = p + 0.01 * torch.randn(p.shape, generator=gen, device=p.device)
        (got_p, got_d), (want_p, want_d) = (fu.fused_elastic(p, c, alpha),
                                            fu.elastic_plain(p, c, alpha))
        check(torch.equal(got_p, want_p) and torch.equal(got_d, want_d),
              f"fused_elastic differs from elastic_plain at mnist_cnn's "
              f"bucket (n={p.numel()}, alpha {alpha})")
    log(f"[host] B2 bit for bit its plain twin at mnist_cnn's buckets "
        f"{[b.padded for b in spec.buckets]}, alpha {alpha}")

    out = {}
    for backend in ("tree", "ring"):
        ranks = run_client_remote(backend)
        check(len({r["digest"] for r in ranks}) == 1,
              f"client_remote --backend {backend}: the nodes' final params "
              "differ")
        check(all(r["launches"] == b2_per_round * r["rounds"]
                  and r["rounds"] > 0 for r in ranks),
              f"client_remote --backend {backend}: B2 did not launch once "
              "an elastic round in every rank")
        losses = ranks[0]["losses"]
        check(len(losses) == 2 and all(map(math.isfinite, losses))
              and losses[1] < losses[0],
              f"client_remote --backend {backend}: loss did not fall "
              f"({losses})")
        out[f"client_remote_{backend}"] = ranks

    t0 = time.perf_counter()
    ports = (free_port_window(1), free_port_window(1))
    ranks = run_workers(host_worker, HOST_NODES,
                        (HOST_NODES, ports, HOST_DEVICE), HOST_TIMEOUT_S,
                        "host-collective rank")
    log(f"[host] {HOST_NODES} rank processes on {HOST_DEVICE}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, who in (("tree", 0), ("ring", 0)):
        check(all(r[name]["bits"] for r in ranks),
              f"the device-tensor {name} allreduce is not bit for bit the "
              "numpy route's (or touched its inputs)")
        splits = ranks[who][name]["splits"]
        ms = [p50([s[i] for s in splits]) * 1e3 for i in range(3)]
        nic = p50([s[3] for s in splits])
        log(f"[host] {name}: 18 leaves (17.3 MB f32) x {HOST_NODES} ranks, "
            f"bit for bit the numpy route; rank {who}'s median of "
            f"{HOST_ROUNDS}: stage {ms[0]:.3f} ms, host round {ms[1]:.3f} "
            f"ms, return {ms[2]:.3f} ms; NIC bytes {int(nic)}")
        out[name] = {"stage_ms": ms[0], "round_ms": ms[1],
                     "return_ms": ms[2], "nic_bytes": int(nic)}
    check(all(r["int8_bits"] for r in ranks),
          "an int8-codec tree round with tensors on the card differs from "
          "the numpy route")
    check(all(r["sgd_bits"] for r in ranks)
          and len({r["sgd_digest"] for r in ranks}) == 1,
          "TreeAllReduceSGD: a rank's params on the card differ from its "
          "numpy run, or ranks differ after synchronize_parameters")
    for r in ranks:
        ea = r["ea"]
        check(ea["bits"], f"TreeAllReduceEA rank {r['rank']}: params or "
              "center on the card differ from its numpy run")
        check(ea["rounds"] == ea["numpy_rounds"] > 0
              and ea["launches"] == b2_per_round * ea["rounds"],
              f"TreeAllReduceEA rank {r['rank']}: {ea['rounds']} elastic "
              f"rounds (numpy run {ea['numpy_rounds']}), "
              f"{ea['launches']} B2 launches")
    log(f"[host] int8 tree round bit for bit the numpy route; "
        f"TreeAllReduceSGD with {HOST_SGD_STEPS} steps: params bit for bit "
        "the numpy run's on every rank, equal across ranks; "
        f"TreeAllReduceEA with {HOST_EA_STEPS} steps (tau {HOST_EA_TAU}) x "
        f"{HOST_EA_EPOCHS} epochs and synchronize_center: params and center "
        "bit for bit the numpy run's on every rank; elastic rounds / B2 "
        f"launches {[(r['ea']['rounds'], r['ea']['launches']) for r in ranks]}")

    info = pinit.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                            device=HOST_DEVICE)
    try:
        tree = pinit.global_mesh_tree()
        check(HOST_DEVICE == "cpu" or (dist.get_backend() == "nccl"
                                       and tree.device.type == "cuda"),
              "parallel.init.initialize did not join NCCL on the card")
        model = toy_model(torch)
        ts = init_train_state(model, tree, 0, 10)
        step = build_sgd_step(model, tree, lr=0.1)
        rs = np.random.RandomState(7)
        bx = pinit.host_local_batch(tree, rs.randn(8, 4, 4, 1).astype(
            np.float32))
        by = pinit.host_local_batch(tree, rs.randint(0, 10, (8,)))
        for _ in range(3):
            ts, loss = step(ts, bx, by)
        loss = float(loss)
    finally:
        dist.destroy_process_group()
    check(math.isfinite(loss), f"toy model loss {loss} after 3 steps")
    log(f"[host] parallel.init.initialize: {info.num_processes} process on "
        f"{info.device}, 3 build_sgd_step steps, loss {loss:.4f}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the collective backends and the AsyncEA slice client (A9(d))
# ---------------------------------------------------------------------------

BACKEND_ROWS = 4          # MeshBackend's rows and the slice client's
HYBRID_HOSTS, HYBRID_LOCAL, HYBRID_ROUNDS = 2, 2, 10
BACKEND_DEVICE = "cuda"   # phase 16's device (the hybrid processes' cuda:0)
BACKEND_TIMEOUT_S = 300
SLICE_SYNCS = 8


def backend_rows(torch, rows, seed, dyadic):
    """``rows`` rows of each of the convnet's 18 leaves on the host:
    multiples of 1/8 in [-8, 8) (every sum of up to 4 rows exact in
    float32), or seeded normals."""
    g = torch.Generator().manual_seed(seed)
    if dyadic:
        return [torch.randint(-64, 64, (rows,) + s, generator=g).float()
                * 0.125 for s in convnet_shapes()]
    return [torch.randn((rows,) + s, generator=g) for s in convnet_shapes()]


def hybrid_worker(rank: int, ports: tuple, device: str, q) -> None:
    """One host of the hybrid checks (a spawned process, its L rows on
    ``device``): the convnet's 18 leaves (dyadic) over the tree and the
    ring against a ``MeshBackend`` of all H x L rows, timed; one int8 tree
    round on ``device`` against the same round on the CPU (the host codec's
    route)."""
    try:
        import torch
        from distlearn_tpu_torch.comm.backend import (HybridBackend,
                                                      MeshBackend)
        dev = torch.device(device)
        H, L = HYBRID_HOSTS, HYBRID_LOCAL
        lo = rank * L
        rows = backend_rows(torch, H * L, 21, dyadic=True)
        want, _ = MeshBackend(H * L, device=dev).all_reduce(
            [r.to(dev) for r in rows])
        mine = [r[lo:lo + L].to(dev) for r in rows]
        res = {"rank": rank}
        for transport, port in (("tree", ports[0]), ("ring", ports[1])):
            b = HybridBackend(rank, H, "127.0.0.1", port, num_devices=L,
                              device=dev, transport=transport)
            try:
                ok, splits = True, []
                for _ in range(HYBRID_ROUNDS):
                    red, n, rider = b.all_reduce_ex(mine, rider=1)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    splits.append(b.last_split)
                    ok = ok and n == H * L and rider == H * L and all(
                        torch.equal(x, w[:L]) for x, w in zip(red, want))
                res[transport] = {"bits": ok, "splits": splits,
                                  "nic": b.host_leg.nic_bytes()}
            finally:
                b.close()
        noisy = [r[lo:lo + L] * 1e-2 for r in
                 backend_rows(torch, H * L, 22, dyadic=False)]
        got = {}
        for tag, d, port in (("card", dev, ports[2]),
                             ("cpu", torch.device("cpu"), ports[3])):
            b = HybridBackend(rank, H, "127.0.0.1", port, num_devices=L,
                              device=d, codec="int8")
            try:
                red, _ = b.all_reduce([x.to(d) for x in noisy])
                got[tag] = [x.cpu() for x in red]
            finally:
                b.close()
        res["int8_bits"] = all(torch.equal(a, b) for a, b in
                               zip(got["card"], got["cpu"]))
        res["int8_lossy"] = not all(torch.equal(a, b.sum(0).expand_as(a))
                                    for a, b in zip(got["cpu"], noisy))
        q.put(("ok", res))
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        import traceback
        q.put(("err", traceback.format_exc()))


def run_slice_pair(torch, device, codec, syncs):
    """A serial server and one tau-1 slice client of BACKEND_ROWS rows of
    the full-width convnet (``MeshBackend`` on ``device``), on the JAX
    package's wire layout, each sync's per-row drift drawn on the host from
    a fixed seed.  Returns the center, the rows, the rows and center after
    the first sync's drift, and the client's pushes."""
    from distlearn_tpu_torch.comm.backend import MeshBackend
    from distlearn_tpu_torch.models import cifar_convnet
    from distlearn_tpu_torch.models.convert import CONVNET_WIRE
    from distlearn_tpu_torch.parallel import async_ea
    from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map
    params0 = cifar_convnet().init(0, device="cpu")[0]
    port = free_port_window(3)
    out = {"centers": []}

    def drift(r, p):
        g = torch.Generator().manual_seed(2000 + r)
        return tree_map(lambda v: v + (0.01 * torch.randn(
            tuple(v.shape), generator=g)).to(v.device), p)

    def server_fn():
        srv = async_ea.AsyncEAServer("127.0.0.1", port, 1, device=device,
                                     layout=CONVNET_WIRE)
        try:
            srv.init_server(params0)
            for _ in range(syncs):
                got = srv.sync_server(params0)
                out["centers"].append([t.cpu() for t in tree_leaves(got)])
            out["center"] = [t.cpu() for t in srv.center]
        finally:
            srv.close()

    def client_fn():
        c = async_ea.AsyncEAClient(
            "127.0.0.1", port, node=1, tau=1, alpha=ASYNC_ALPHA, codec=codec,
            device=device, layout=CONVNET_WIRE,
            slice_backend=MeshBackend(BACKEND_ROWS, device=device))
        pushes = [0]
        send = c.conn.send_packed

        def counted(payload):
            pushes[0] += 1
            return send(payload)
        c.conn.send_packed = counted
        try:
            p = c.init_client(params0)
            check(all(x.shape[0] == BACKEND_ROWS for x in tree_leaves(p)),
                  "the slice client's params are not [rows, ...]")
            for r in range(syncs):
                p = drift(r, p)
                if r == 0:
                    out["first_rows"] = [t.cpu() for t in tree_leaves(p)]
                p, synced = c.sync_client(p)
                check(synced, "a tau-1 slice client did not sync")
            out["params"] = [t.cpu() for t in tree_leaves(p)]
            out["pushes"] = pushes[0]
        finally:
            c.close()

    run_threads(server_fn, client_fn)
    out["params0"] = tree_leaves(params0)
    return out


def phase_backends(torch) -> dict:
    from distlearn_tpu_torch.comm.backend import MeshBackend
    from distlearn_tpu_torch.examples import sync_backends
    from distlearn_tpu_torch.ops import wire_kernels as wk
    from distlearn_tpu_torch.ops.fused_update import cast_scalar
    from distlearn_tpu_torch.utils import logging

    # (a) MeshBackend: 4 rows of the convnet's 18 leaves, the card against
    # the CPU route (seeded normals: the row order decides the bits)
    rows = backend_rows(torch, BACKEND_ROWS, 20, dyadic=False)
    card = MeshBackend(BACKEND_ROWS, BACKEND_DEVICE)
    cpu = MeshBackend(BACKEND_ROWS, "cpu")
    for contrib in (True, [1, 0, 1, 1]):
        got, n, rider = card.all_reduce_ex(
            [r.to(card.device) for r in rows], contrib=contrib, rider=3)
        want, n2, rider2 = cpu.all_reduce_ex(rows, contrib=contrib, rider=3)
        torch.cuda.synchronize()
        check(n == n2 == (4 if contrib is True else 3)
              and rider == rider2 == 3 * BACKEND_ROWS,
              f"MeshBackend count/rider {n}/{rider} against {n2}/{rider2}")
        check(all(bits_equal(torch, a.cpu(), b) for a, b in zip(got, want)),
              f"MeshBackend on the card differs from the CPU route "
              f"(contrib {contrib})")
    log(f"[backends] (a) MeshBackend, {BACKEND_ROWS} rows of the convnet's "
        f"{CONVNET_LEAVES} leaves on the card: sum, rider and a [1,0,1,1] "
        "contrib mask bit for bit the CPU route")

    # (b) HybridBackend: 2 host processes sharing the card
    t0 = time.perf_counter()
    ports = tuple(free_port_window(1) for _ in range(4))
    ranks = run_workers(hybrid_worker, HYBRID_HOSTS, (ports, BACKEND_DEVICE),
                        BACKEND_TIMEOUT_S, "hybrid host process")
    hybrid = {}
    for transport in ("tree", "ring"):
        check(all(r[transport]["bits"] for r in ranks),
              f"hybrid over the {transport}: a row differs from the "
              f"{HYBRID_HOSTS * HYBRID_LOCAL}-row MeshBackend")
        splits = ranks[0][transport]["splits"]
        ms = [p50([s[i] for s in splits]) * 1e3 for i in range(3)]
        hybrid[transport] = {"stage_ms": ms[0], "round_ms": ms[1],
                             "return_ms": ms[2],
                             "nic_bytes": ranks[0][transport]["nic"]}
        log(f"[backends] (b) hybrid {HYBRID_HOSTS} hosts x {HYBRID_LOCAL} "
            f"rows over the {transport} (raw, dyadic): every row bit for "
            f"bit the {HYBRID_HOSTS * HYBRID_LOCAL}-row MeshBackend; host "
            f"0's median of {HYBRID_ROUNDS}: stage {ms[0]:.3f} ms, host "
            f"round {ms[1]:.3f} ms, return {ms[2]:.3f} ms; NIC bytes "
            f"{hybrid[transport]['nic_bytes']}")
    check(all(r["int8_bits"] and r["int8_lossy"] for r in ranks),
          "hybrid int8 on the card differs from its CPU route (or did not "
          "quantize)")
    log(f"[backends] (b) hybrid int8 over the tree: the card bit for bit "
        f"the CPU route (numpy host codec); {time.perf_counter() - t0:.1f} "
        "s with the processes' start")

    # (c) sync_backends: one digest for the three backends
    digests = {}
    for backend in ("mesh", "host", "hybrid"):
        opt = sync_backends.parse_flags(
            "", sync_backends.FLAGS,
            ["--backend", backend, "--device", BACKEND_DEVICE])
        line = sync_backends.run(opt)
        digests[backend] = line.split("digest=")[1]
        log(f"[backends] (c) {line}")
    check(len(set(digests.values())) == 1,
          f"sync_backends digests differ across backends: {digests}")

    # (d) the slice client: 4 rows, int8, 8 syncs, the card against the CPU
    logging.set_verbose(False)          # the roles' per-sync lines
    reset_wire_counts(wk)
    t0 = time.perf_counter()
    got = run_slice_pair(torch, BACKEND_DEVICE, "int8", SLICE_SYNCS)
    t_card = time.perf_counter() - t0
    launches = (*b3_launches(wk), b4_launches(wk))
    want = run_slice_pair(torch, "cpu", "int8", SLICE_SYNCS)
    check(got["pushes"] == SLICE_SYNCS,
          f"{SLICE_SYNCS} slice syncs made {got['pushes']} pushes")
    check(launches == (SLICE_SYNCS,) * 3,
          f"{SLICE_SYNCS} int8 slice syncs launched (amax, quantize, "
          f"dequant_add) = {launches}; expected one of each a sync")
    for what in ("center", "params"):
        check(all(bits_equal(torch, a, b) for a, b in
                  zip(got[what], want[what])),
              f"slice client: the card's {what} differs from the CPU route")
    # raw, one sync: the center moves by the row-sum of the row deltas
    raw = run_slice_pair(torch, BACKEND_DEVICE, "raw", 1)
    a = cast_scalar(ASYNC_ALPHA, torch.float32)
    moved = []
    for c0, p, c1 in zip(raw["params0"], raw["first_rows"],
                         raw["centers"][0]):
        d = (p - c0[None]) * a
        acc = d[0].clone()
        for r in range(1, BACKEND_ROWS):
            acc += d[r]
        moved.append(bits_equal(torch, c1, c0 + acc))
    check(all(moved), "raw slice sync: the center did not move by the "
          "row-sum of the row deltas")
    logging.set_verbose(True)
    log(f"[backends] (d) slice client, {BACKEND_ROWS} rows of the full-width "
        f"convnet, int8, {SLICE_SYNCS} syncs: one push a sync, (amax, "
        f"quantize, dequant_add) launches {launches}, center and rows bit "
        f"for bit the CPU route; raw: the center moved by the row-sum of "
        f"the deltas, bit for bit; card run {t_card:.2f} s")
    return {"hybrid": hybrid, "slice_launches": launches}


# ---------------------------------------------------------------------------
# Phase 17: ResNet-50 v1.5 and the optimizer steps (A10)
# ---------------------------------------------------------------------------

RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
RESNET_DEVICE = "cuda"
RESNET_STEPS, RESNET_LR = 10, 0.1
RESNET_BUCKET_BYTES = 16 * 1024 * 1024
RESNET_BUCKETS = (3_631_104, 3_875_840, 3_620_864, 3_407_872, 3_151_872,
                  3_414_016, 3_407_872, 1_048_576)
RESNET_WINDOWS, RESNET_WINDOW_STEPS, RESNET_OPTAX_STEPS = 3, 5, 5
# The card against the port's CPU route, one forward and one plain SGD
# step from the same weights and batch.  float64 at batch 2 and 64^2, to
# RESNET_F64_TOL (only the summation order differs).  float32 (TF32 off)
# at batch 2 and 128^2, 32 values a channel in stage 4's batchnorms, to
# phase 4's CPU_REF_*; bfloat16 compute on the card against the CPU's
# float32 route at the same size, to rtol = atol = FLASH_BF16_TOL (the
# bfloat16 logits' ulp moves a log-prob by about 1e-2).
RESNET_CPU_BATCH, RESNET_F64_SIZE, RESNET_F32_SIZE = 2, 64, 128
RESNET_F64_TOL = 1e-10
# ZeRO-1 at one rank against the full-state step: tests/test_optax_step.py's
RESNET_ZERO_TOL = (1e-6, 1e-7)
RESNET_EXAMPLE = ["resnet50", "--numExamples", "1280", "--stepsPerEpoch",
                  "5", "--numEpochs", "1"]
RESNET_CLASSES_OF = (         # (class, substrings of a kernel's name)
    ("B1", ("sgd_chunk",)),
    ("convolution", ("xmma", "implicit_gemm", "cudnn", "conv", "winograd",
                     "dgrad", "wgrad", "fprop", "gemm", "cutlass")),
    ("reduction (batchnorm statistics, pool)", ("reduce_kernel",
                                                "Reduce")),
    ("nccl", ("nccl",)),
    ("copy/cat", ("CatArrayBatchedCopy", "copy")),
)


def resnet50_flops(image_size: int, num_classes: int, batch: int) -> float:
    """Analytic FLOPs of a forward and backward step: 2 x the multiply-adds
    of every conv and the fc, times 3 (the backward is twice the
    forward)."""
    out = lambda n, k, s, p: (n + 2 * p - k) // s + 1     # noqa: E731
    h = out(image_size, 7, 2, 3)
    macs = 3 * 64 * 49 * h * h
    h = out(h, 3, 2, 1)
    in_ch = 64
    for si, (w, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for bi in range(blocks):
            s = 2 if (bi == 0 and si > 0) else 1
            h2 = out(h, 3, s, 1)
            macs += in_ch * w * h * h + w * w * 9 * h2 * h2 \
                + w * 4 * w * h2 * h2
            if bi == 0:
                macs += in_ch * 4 * w * h2 * h2
            in_ch, h = 4 * w, h2
    macs += in_ch * num_classes
    return 3 * 2 * macs * batch


def resnet_batches(torch, n, batch, size, classes, seed):
    dev = RESNET_DEVICE
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((batch, size, size, 3), generator=g, device=dev),
             torch.randint(0, classes, (batch,), generator=g, device=dev))
            for _ in range(n)]


def resnet_against_cpu(torch, tree, cpu_tree) -> None:
    """Phase 17 (a)/(b): ResNet-50 on ``tree``'s device against the port's
    CPU route in float64, float32 and bfloat16 compute, to the tolerances
    set beside RESNET_CPU_BATCH."""
    from distlearn_tpu_torch.models import resnet50
    from distlearn_tpu_torch.train import trainer as tr
    from distlearn_tpu_torch.utils.tree import tree_leaves

    def card_and_cpu(dtype, size, compute_dtypes):
        """(log-probs, params after one plain step) for each of
        ``compute_dtypes`` on the card, then float32/float64 on the CPU."""
        g = torch.Generator().manual_seed(3)
        x = torch.randn((RESNET_CPU_BATCH, size, size, 3), generator=g,
                        dtype=torch.float64).to(dtype)
        y = torch.randint(0, RESNET_CLASSES, (RESNET_CPU_BATCH,),
                          generator=g)
        res = []
        for t, cd in [(tree, c) for c in compute_dtypes] + [(cpu_tree,
                                                             None)]:
            m = resnet50(RESNET_CLASSES, dtype=dtype, compute_dtype=cd,
                         image_size=size)
            st = tr.init_train_state(m, t, 2, RESNET_CLASSES)
            logp, _ = m.apply(st.params, st.model_state, x.to(t.device),
                              train=True)
            # the plain update: B1 takes float32 buckets only, and the
            # step under test here is the model's, not the update's
            st, _ = tr.build_sgd_step(m, t, RESNET_LR, fused=False)(
                st, x.to(t.device), y.to(t.device))
            res.append((logp.cpu(), [a.cpu() for a in
                                     tree_leaves(st.params)]))
        torch.cuda.synchronize()
        return res

    def diffs(a, b):
        return (max_abs(torch, a[0], b[0]),
                max(max_abs(torch, p, q) for p, q in zip(a[1], b[1])))

    card64, cpu64 = card_and_cpu(torch.float64, RESNET_F64_SIZE, [None])
    dlogp, dpar = diffs(card64, cpu64)
    log(f"[resnet] (a) card vs CPU route at batch {RESNET_CPU_BATCH}, "
        f"{RESNET_F64_SIZE}^2, float64: log-probs max diff {dlogp:.3e}, "
        f"params after one step {dpar:.3e} (tol {RESNET_F64_TOL:.0e})")
    check(dlogp <= RESNET_F64_TOL and dpar <= RESNET_F64_TOL,
          "ResNet-50 in float64 on the card disagrees with the CPU route")
    card32, card16, cpu32 = card_and_cpu(torch.float32, RESNET_F32_SIZE,
                                         [None, torch.bfloat16])
    del card64, cpu64
    dlogp, dpar = diffs(card32, cpu32)
    log(f"[resnet] (a) card vs CPU route at batch {RESNET_CPU_BATCH}, "
        f"{RESNET_F32_SIZE}^2, float32 (TF32 off): log-probs max diff "
        f"{dlogp:.3e} (tol {CPU_REF_LOGP_TOL:.0e}), params after one step "
        f"{dpar:.3e} (tol {CPU_REF_PARAM_TOL:.0e})")
    check(dlogp <= CPU_REF_LOGP_TOL and dpar <= CPU_REF_PARAM_TOL,
          "ResNet-50 in float32 on the card disagrees with the CPU route")
    tol = FLASH_BF16_TOL
    close = torch.allclose(card16[0], cpu32[0], rtol=tol, atol=tol) and all(
        torch.allclose(p, q, rtol=tol, atol=tol)
        for p, q in zip(card16[1], cpu32[1]))
    dlogp, dpar = diffs(card16, cpu32)
    log(f"[resnet] (b) card's bfloat16 compute vs the CPU's float32 route "
        f"at batch {RESNET_CPU_BATCH}, {RESNET_F32_SIZE}^2: log-probs max "
        f"diff {dlogp:.3e}, params after one step {dpar:.3e} (rtol = atol "
        f"= {tol})")
    check(close, "ResNet-50's bfloat16 compute on the card is not within "
          f"rtol = atol = {tol} of the CPU's float32 route")
    del card32, card16, cpu32


def phase_resnet(torch, tree, cpu_tree) -> dict:
    from distlearn_tpu_torch.models import resnet50
    from distlearn_tpu_torch.ops import flatten as flatten_lib
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.train import optim
    from distlearn_tpu_torch.train import trainer as tr
    from distlearn_tpu_torch.utils.tree import tree_leaves
    flops = resnet50_flops(RESNET_SIZE, RESNET_CLASSES, RESNET_BATCH)
    batches = resnet_batches(torch, 2, RESNET_BATCH, RESNET_SIZE,
                             RESNET_CLASSES, 0)
    out = {"flops": flops}
    for tag, cd, peak in (("float32", None, FP32_FLOPS),
                          ("bfloat16", torch.bfloat16, BF16_FLOPS)):
        model = resnet50(RESNET_CLASSES, compute_dtype=cd)
        ts = tr.init_train_state(model, tree, 0, RESNET_CLASSES)
        spec = flatten_lib.make_bucket_spec(ts.params, RESNET_BUCKET_BYTES)
        check(tuple(b.padded for b in spec.buckets) == RESNET_BUCKETS,
              f"ResNet-50's 16-MiB buckets {[b.padded for b in spec.buckets]}"
              f" are not the JAX package's {RESNET_BUCKETS}")
        step = tr.build_sgd_step(model, tree, RESNET_LR,
                                 max_bucket_bytes=RESNET_BUCKET_BYTES)
        # (a)/(b) 10 steps on the main path: B1 once a bucket a step
        torch.cuda.synchronize()
        reset_counts(fu)
        losses = []
        for i in range(RESNET_STEPS):
            ts, loss = step(ts, *batches[i % 2])
            losses.append(float(loss))
        launches = fu.fused_sgd.launches
        check(all(map(math.isfinite, losses)),
              f"ResNet-50 {tag}: non-finite loss {losses}")
        check(launches == RESNET_STEPS * len(RESNET_BUCKETS),
              f"ResNet-50 {tag}: B1 launched {launches} times in "
              f"{RESNET_STEPS} steps, expected {len(RESNET_BUCKETS)} a step")
        ts = tr.build_sync_step(tree)(ts)
        check(int(ts.sync.my_steps) == 0, "the sync step kept the counts")
        log(f"[resnet] ({'a' if cd is None else 'b'}) {tag}: {RESNET_STEPS} "
            f"build_sgd_step steps at batch {RESNET_BATCH}, {RESNET_SIZE}^2, "
            f"{RESNET_CLASSES} classes, losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, B1 {launches} launches "
            f"({len(RESNET_BUCKETS)} buckets a step); then build_sync_step")
        # fused against plain from the same weights and batches
        finals = {}
        for fused in (True, False):
            st = tr.init_train_state(model, tree, 1, RESNET_CLASSES)
            st_step = tr.build_sgd_step(model, tree, RESNET_LR, fused=fused,
                                        max_bucket_bytes=RESNET_BUCKET_BYTES)
            for i in range(PARITY_STEPS):
                st, _ = st_step(st, *batches[i % 2])
            finals[fused] = st.params
        torch.cuda.synchronize()
        diff = max_tree_diff(torch, finals[True], finals[False])
        del finals
        log(f"[resnet]   fused vs plain after {PARITY_STEPS} steps: max "
            f"param diff {diff:.3e} (tolerance {PARITY_TOL:.0e})")
        check(diff <= PARITY_TOL, f"ResNet-50 {tag}: fused and plain SGD "
              f"differ by {diff}")
        # (c) steps/s, images/s, peak memory, MFU; one profiled step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        box = {"ts": ts}

        def window():
            for i in range(RESNET_WINDOW_STEPS):
                box["ts"], _ = step(box["ts"], *batches[i % 2])
        window()
        sps = steps_per_s(torch, window, RESNET_WINDOW_STEPS,
                          windows=RESNET_WINDOWS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mfu = flops * sps / peak
        check(mfu <= 1.0, f"ResNet-50 {tag}: MFU {mfu:.3f} > 1: the timing "
              "or the FLOP count is wrong")
        (box["ts"], _), busy, wall, by_class = profile_step(
            torch, lambda: step(box["ts"], *batches[0]), RESNET_CLASSES_OF,
            "elementwise (batchnorm normalize, ReLU, adds, casts)")
        check(busy is not None and busy > 0,
              "torch.profiler saw no device time in the step")
        b1_ms, b1_n = by_class.get("B1", [0.0, 0])
        check(b1_n == len(RESNET_BUCKETS),
              f"the profiled step names B1 {b1_n} times, expected "
              f"{len(RESNET_BUCKETS)}")
        out[tag] = {"steps_per_s": sps, "images_per_s": sps * RESNET_BATCH,
                    "mfu": mfu, "peak_gb": peak_gb, "busy_ms": busy,
                    "wall_ms": wall, "launches": launches,
                    "b1_ms": b1_ms, "classes": by_class}
        log(f"[resnet] (c) {tag}: {sps:.3f} steps/s = "
            f"{sps * RESNET_BATCH:.1f} images/s (median of {RESNET_WINDOWS} "
            f"windows of {RESNET_WINDOW_STEPS} steps), MFU {mfu:.3f} "
            f"({flops / 1e12:.3f} TFLOP a step, analytic, over "
            f"{peak / 1e12:.0f} TFLOP/s), peak memory {peak_gb:.2f} GB; "
            f"one profiled step {wall:.2f} ms wall (profiler on), device "
            f"busy {busy:.2f} ms, idle {1 - busy / wall:.1%}; " + ", ".join(
                f"{c} {v[0]:.2f} ms = {v[0] / busy:.1%} in {v[1]} launches"
                for c, v in sorted(by_class.items(), key=lambda kv: -kv[1][0])))
        del ts, box, step
        torch.cuda.empty_cache()

    resnet_against_cpu(torch, tree, cpu_tree)

    # (d) the optimizer steps at full width, float32
    model = resnet50(RESNET_CLASSES)
    finals = {}
    for name, tx, init, build in (
            ("momentum", optim.sgd(0.01, momentum=0.9),
             optim.init_optax_state, optim.build_optax_step),
            ("adam", optim.adam(1e-4), optim.init_optax_state,
             optim.build_optax_step),
            ("adam-zero1", optim.adam(1e-4), optim.init_zero_state,
             optim.build_zero_optax_step)):
        st = init(model, tree, tx, 4, RESNET_CLASSES)
        st_step = build(model, tree, tx)
        losses = []
        for i in range(RESNET_OPTAX_STEPS):
            st, loss = st_step(st, *batches[i % 2])
            losses.append(float(loss))
        check(all(map(math.isfinite, losses)),
              f"ResNet-50 {name}: non-finite loss {losses}")
        log(f"[resnet] (d) {name}: {RESNET_OPTAX_STEPS} steps, losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        finals[name] = (tree_leaves(st.params), losses)
        del st, st_step
        torch.cuda.empty_cache()
    (za, zl), (fa, fl) = finals["adam-zero1"], finals["adam"]
    bitwise = zl == fl and all(torch.equal(a, b) for a, b in zip(za, fa))
    rtol, atol = RESNET_ZERO_TOL
    close = all(torch.allclose(a, b, rtol=rtol, atol=atol)
                for a, b in zip(za, fa))
    check(bitwise or close, "ZeRO-1 adam at one rank differs from the "
          "full-state adam step beyond rtol 1e-6, atol 1e-7")
    log(f"[resnet] (d) ZeRO-1 adam at n = 1 against build_optax_step's adam "
        f"after {RESNET_OPTAX_STEPS} steps: "
        + ("bit for bit" if bitwise else
           f"within rtol {rtol:.0e}, atol {atol:.0e} (not bit for bit)"))
    out["zero_bitwise"] = bitwise
    del finals, batches
    torch.cuda.empty_cache()

    # (f) B1 at the largest bucket
    rate, part = hbm_rate(torch.cuda.get_device_name(0))
    n = max(RESNET_BUCKETS)
    g = torch.Generator(device=RESNET_DEVICE).manual_seed(5)
    p = torch.randn(n, generator=g, device=RESNET_DEVICE)
    gr = torch.randn(n, generator=g, device=RESNET_DEVICE)
    check(torch.equal(fu.fused_sgd(p, gr, RESNET_LR),
                      fu.sgd_plain(p, gr, RESNET_LR)),
          f"B1 differs from its plain twin at n={n}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=RESNET_DEVICE)
    bound = max(12 * n / rate, 2 * n / FP32_FLOPS) * 1e3
    b1 = {"ms": time_ms(torch, lambda: fu.fused_sgd(p, gr, RESNET_LR), flush),
          "plain_ms": time_ms(torch, lambda: fu.sgd_plain(p, gr, RESNET_LR),
                              flush),
          "library_ms": time_ms(torch, lambda: torch.add(p, gr,
                                                         alpha=-RESNET_LR),
                                flush),
          "bound_ms": bound}
    step_bound = sum(12 * b / rate for b in RESNET_BUCKETS) * 1e3
    del flush, p, gr
    log(f"[resnet] (f) B1 at the largest bucket n={n}: {b1['ms']:.5f} ms | "
        f"plain {b1['plain_ms']:.5f} ms | torch.add {b1['library_ms']:.5f} "
        f"ms | bound {bound:.5f} ms ({12 * n / 1e6:.1f} MB at "
        f"{rate / 1e12:.2f} TB/s, {part}), {bound / b1['ms']:.1%} of bound; "
        f"the 8 buckets' bound {step_bound:.4f} ms a step")
    out["b1"] = b1

    # (e) the example as its own process, plain and --bf16 --deviceData
    procs = []
    for extra in ([], ["--bf16", "--deviceData"]):
        args = RESNET_EXAMPLE + ["--device", RESNET_DEVICE] + extra
        procs.append((args, subprocess.Popen(
            [sys.executable, "-m", f"distlearn_tpu_torch.examples.{args[0]}",
             *args[1:]], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    t0 = time.perf_counter()
    for args, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, pr in procs:
                pr.kill()
                pr.communicate()
            raise SmokeFailure(f"{' '.join(args)} timed out")
        check(proc.returncode == 0, f"{' '.join(args)} exited "
              f"{proc.returncode}: {stderr[-2000:]}")
        losses = [float(v) for v in re.findall(r"epoch \d+: loss (\S+)",
                                               stdout)]
        check(losses and all(map(math.isfinite, losses)),
              f"{' '.join(args)}: losses {losses}")
        check("161 leaves, bucket 16 MiB" in stdout,
              f"{' '.join(args)}: no 161-leaf line")
        log(f"[resnet] (e) {' '.join(args)}: " + " | ".join(
            ln for ln in stdout.splitlines() if ln.startswith("epoch")))
    log(f"[resnet] (e) both example processes {time.perf_counter() - t0:.1f} "
        "s (run together)")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the LM over a (data, seq, model) mesh with MoE (A11, first half)
# ---------------------------------------------------------------------------

# Ranks of the mesh phase: processes sharing one card, their mesh built on
# a gloo group over CUDA tensors (NCCL cannot put two ranks on one card),
# so every collective takes the mesh's staged route through pinned host
# memory: its times are that host route's, not NCCL's.
MESH_RANKS = 4
MESH_DEVICE = "cuda"         # the rank processes' device (cuda:0)
MESH_TIMEOUT_S = 400
MESH_BUDGET_S = 150           # the phase's wall time, the probe included
MESH_STEPS = 3
# (name, (dp, sp, tp), model options, step options)
MESH_CASES = (
    ("tp", (1, 1, 2), {}, {"fused": True}),
    ("ring", (1, 2, 1), {}, {}),
    ("zigzag", (1, 2, 1), {}, {"seq_layout": "zigzag"}),
    ("ulysses", (1, 2, 1), {"seq_impl": "alltoall"}, {}),
    ("moe", (2, 1, 1), {"moe_experts": 2, "moe_top_k": 2},
     {"ep_axis": "data", "moe_balance_weight": 0.01}),
    ("sp_tp", (1, 2, 2), {}, {}),
)
# flash engages where the attention is local on the rank: with no sequence
# axis, and inside Ulysses; the ring's blocks are plain PyTorch
MESH_FLASH = {"tp", "ulysses", "moe"}
MESH_LOSS_RTOL = 1e-2          # the first step's loss against one rank's
# (b): float64, flash off, the implied update against one rank's gradient
MESH_F64 = dict(vocab=256, dim=64, depth=2, heads=4, max_len=128)
MESH_F64_BATCH, MESH_F64_TOL = 4, 1e-5


def mesh_block(mesh, toks):
    """This rank's block of a global ``[B, L]`` batch: rows over data,
    columns over seq."""
    d, s = mesh.axis("data"), mesh.axis("seq")
    rows, cols = toks.shape[0] // d.size, toks.shape[1] // s.size
    return toks[d.index * rows:(d.index + 1) * rows,
                s.index * cols:(s.index + 1) * cols].contiguous()


# send/recv last: it has been seen to abort the sending process
GLOO_PROBES = ("all_reduce", "all_gather", "all_to_all_single", "broadcast",
               "all_reduce bfloat16 on the host",
               "all_reduce bfloat16 on the card", "send/recv")


def gloo_probe_worker(rank: int, port: int, conn) -> None:
    """One of two processes calling each of GLOO_PROBES directly on tensors
    on ``cuda:0``, sending one ``(rank, op, outcome, detail)`` each through
    ``conn`` (a pipe: each send has landed before the next call, which may
    abort this process; that crash is itself a finding)."""
    import datetime

    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=rank, world_size=2,
                            init_method=f"tcp://localhost:{port}",
                            timeout=datetime.timedelta(seconds=20))
    try:
        dev = torch.device("cuda", 0)
        for op in GLOO_PROBES:
            x = torch.full((4,), float(rank + 1), device=dev)
            try:
                if op == "all_reduce":
                    dist.all_reduce(x)
                elif op == "all_gather":
                    parts = [torch.empty_like(x) for _ in range(2)]
                    dist.all_gather(parts, x)
                    x = torch.cat(parts)
                elif op == "all_to_all_single":
                    out = torch.empty_like(x)
                    dist.all_to_all_single(out, x)
                    x = out
                elif op == "broadcast":
                    dist.broadcast(x, 0)
                elif op == "send/recv":
                    if rank == 0:
                        dist.send(x, 1)
                    else:
                        dist.recv(x, 0)
                else:
                    x = torch.ones(4, dtype=torch.bfloat16,
                                   device=dev if op.endswith("card")
                                   else "cpu")
                    dist.all_reduce(x)
                torch.cuda.synchronize()
                conn.send((rank, op, "accepted", x.float().cpu().tolist()))
            except (RuntimeError, ValueError, TypeError) as e:
                conn.send((rank, op, "refused",
                           str(e).splitlines()[0][:120]))
    finally:
        dist.destroy_process_group()


def gloo_probe_start():
    """Start the two probe processes; :func:`gloo_probe_read` collects
    them."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = free_port()
    pipes = [ctx.Pipe(duplex=False) for _ in range(2)]
    procs = [ctx.Process(target=gloo_probe_worker, args=(r, port, w))
             for r, (_, w) in enumerate(pipes)]
    for p in procs:
        p.start()
    for _, w in pipes:
        w.close()
    return [r for r, _ in pipes], procs


def gloo_probe_read(probe) -> dict:
    """What gloo itself does with CUDA tensors on this machine: ``{op:
    line}``.  The mesh's routes stage every collective through host
    memory whatever this says."""
    readers, procs = probe
    got = []
    deadline = time.monotonic() + 60
    for conn in readers:
        # a pipe whose process aborted reads as closed: stop there
        while time.monotonic() < deadline and conn.poll(
                max(0.1, deadline - time.monotonic())):
            try:
                got.append(conn.recv())
            except EOFError:
                break
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    out = {}
    for op in GLOO_PROBES:
        mine = sorted((r, kind, detail) for r, o, kind, detail in got
                      if o == op)
        if [m[1] for m in mine] == ["accepted"] * 2:
            out[op] = f"accepted (rank 0 got {mine[0][2]})"
        else:
            out[op] = (f"not accepted: {mine}; the processes' exit codes "
                       f"{codes}")
    return out


def mesh_reference(torch, model, whole, toks, dp, weight):
    """One rank's objective of a mesh step on ``toks``: the mean over the dp
    row blocks of each block's loss (with its own MoE balance term), its
    value and gradient on the card."""
    from distlearn_tpu_torch.train import lm as tlm
    from distlearn_tpu_torch.utils.tree import tree_map
    rows = toks.shape[0] // dp
    loss, grads = 0.0, None
    for i in range(dp):
        li, gi = tlm.lm_local_grads(model, whole, toks[i * rows:(i + 1)
                                                      * rows],
                                    moe_balance_weight=weight)
        loss = loss + li / dp
        grads = tree_map(lambda g: g / dp, gi) if grads is None else \
            tree_map(lambda a, g: a + g / dp, grads, gi)
    return loss, grads


def mesh_config() -> dict:
    """Phase 18's sizes, handed to the rank processes (they re-import this
    module, so a rehearsal's smaller sizes reach them only this way)."""
    return {"lm": LM_TRAIN, "batch": LM_TRAIN_BATCH, "lr": LM_TRAIN_LR,
            "steps": MESH_STEPS, "cases": MESH_CASES, "f64": MESH_F64,
            "f64_batch": MESH_F64_BATCH}


def mesh_worker(rank: int, port: int, device: str, cfg: dict, q) -> None:
    """One rank of phase 18 (a spawned process on ``device``): (a), (b) and
    (c) for every mesh of ``cfg["cases"]``."""
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from distlearn_tpu_torch.utils.profiling import settled_profile

        from distlearn_tpu_torch.models.convert import lm_gather, lm_shard
        from distlearn_tpu_torch.models.transformer import (lm_loss,
                                                            transformer_lm)
        from distlearn_tpu_torch.ops import flash_attention as fa
        from distlearn_tpu_torch.ops import fused_update as fu
        from distlearn_tpu_torch.parallel.mesh import Mesh
        from distlearn_tpu_torch.parallel.sequence import zigzag_indices
        from distlearn_tpu_torch.train import lm as tlm
        from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
        sync = (lambda: torch.cuda.synchronize(dev)) if cuda else \
            (lambda: None)
        dist.init_process_group("gloo", rank=rank, world_size=MESH_RANKS,
                                init_method=f"tcp://localhost:{port}")
        res = {"rank": rank, "cases": {}, "up": time.time()}
        lmc, f64 = cfg["lm"], cfg["f64"]
        B, L = cfg["batch"], lmc["max_len"]
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, lmc["vocab"], (B, L)).astype(np.int32)).to(dev)
        wholes, refs = {}, {}
        # device events only; a process's first profile pays CUPTI's
        # start-up (about 10 s on the card), so pay it here, on every rank
        # at once, and not inside a case where the other ranks wait for it
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts):
            torch.ones(1, device=dev).add_(1)
            sync()
        res["warm"] = time.time()
        for name, shape, mopts, sopts in cfg["cases"]:
            mesh = Mesh(shape, device=dev, backend="gloo",
                        ranks=range(math.prod(shape)))
            if not mesh.member:
                continue
            kind = "moe" if "moe_experts" in mopts else "dense"
            if kind not in wholes:
                wholes[kind] = transformer_lm(
                    compute_dtype=torch.bfloat16, **lmc,
                    **{k: v for k, v in mopts.items()
                       if k.startswith("moe")}).init(0, device="cpu")[0]
            t_case = time.perf_counter()
            model = transformer_lm(compute_dtype=torch.bfloat16,
                                   attn_impl="flash", **lmc, **mopts)
            ep = sopts.get("ep_axis")
            weight = sopts.get("moe_balance_weight", 0.0)
            if rank == 0 and kind not in refs:
                # the one-rank loss of the same weights and batch
                with torch.no_grad():
                    whole = tree_map(lambda t: t.to(dev), wholes[kind])
                    refs[kind] = sum(float(lm_loss(
                        model, whole, tokens[i * B // shape[0]:
                                             (i + 1) * B // shape[0]],
                        moe_balance_weight=weight)) / shape[0]
                        for i in range(shape[0]))
                    del whole
                if cuda:
                    torch.cuda.empty_cache()
            params = lm_shard(wholes[kind], mesh, "model", ep)
            toks = tokens
            if sopts.get("seq_layout") == "zigzag":
                toks = tokens[:, torch.from_numpy(zigzag_indices(
                    shape[1], L)).long().to(dev)]
            toks = mesh_block(mesh, toks)
            step = tlm.build_lm_step(model, mesh, lr=cfg["lr"],
                                     seq_axis="seq", tp_axis="model",
                                     **sopts)
            reset_flash_counts(fa)
            fu.fused_sgd.launches = 0
            losses, secs, keys = [], [], []
            for i in range(cfg["steps"]):
                mesh.stats.reset()
                mesh.timed = i == 1
                sync()
                t = time.perf_counter()
                if i == 2:
                    with settled_profile(acts, sync) as prof:
                        t = time.perf_counter()
                        params, loss = step(params, toks)
                        sync()
                    keys = [e.key for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            for _ in range(e.count)]
                else:
                    params, loss = step(params, toks)
                    sync()
                secs.append(time.perf_counter() - t)
                losses.append(float(loss))
                if i == 1:
                    coll = dict(mesh.stats.seconds)
                    calls = dict(mesh.stats.calls)
                    nbytes = dict(mesh.stats.bytes)
            mesh.timed = False
            res["cases"][name] = {
                "losses": losses, "secs": secs, "coll_s": coll,
                "coll_calls": calls, "coll_bytes": nbytes,
                "counts": flash_counts(fa), "b1": fu.fused_sgd.launches,
                "routes": {k: sorted(v) for k, v in
                           flash_routes(keys).items()},
                "profiled": {tag: sum(sub in k for k in keys)
                             for tag, sub in FLASH_KERNELS},
                "ref_loss": refs.get(kind), "case_s":
                time.perf_counter() - t_case, "end": time.time()}
            del params, step
            if cuda:
                torch.cuda.empty_cache()

            # (b) float64, flash off: the implied update of one step
            fmodel = transformer_lm(dtype=torch.float64, attn_impl="xla",
                                    **f64, **mopts)
            fwhole = fmodel.init(1, device="cpu")[0]
            ftoks = torch.from_numpy(np.random.RandomState(1).randint(
                0, f64["vocab"], (cfg["f64_batch"], f64["max_len"]))
                .astype(np.int32)).to(dev)
            zt = ftoks
            if sopts.get("seq_layout") == "zigzag":
                zt = ftoks[:, torch.from_numpy(zigzag_indices(
                    shape[1], f64["max_len"])).long().to(dev)]
            fstep = tlm.build_lm_step(
                fmodel, mesh, lr=1.0, seq_axis="seq", tp_axis="model",
                **{k: v for k, v in sopts.items() if k != "fused"})
            newp, _ = fstep(lm_shard(fwhole, mesh, "model", ep),
                            mesh_block(mesh, zt))
            got = lm_gather(newp, mesh, "model", ep)
            if rank == 0:
                dwhole = tree_map(lambda t: t.to(dev), fwhole)
                _, g = mesh_reference(torch, fmodel, dwhole, ftoks,
                                      shape[0], weight)
                worst = 0.0
                for a, b, gg in zip(tree_leaves(fwhole),
                                    tree_leaves(got), tree_leaves(g)):
                    implied = a.numpy() - b
                    gg = gg.cpu().numpy()
                    denom = max(1e-12, float(np.abs(gg).max()))
                    worst = max(worst, float(np.abs(implied - gg).max())
                                / denom)
                res["cases"][name]["f64_err"] = worst

            # (c) the mixed step once on the tp mesh
            if name == "tp":
                mstep = tlm.build_lm_mixed_step(model, mesh,
                                                lr=cfg["lr"],
                                                seq_axis="seq",
                                                tp_axis="model")
                mst = tlm.init_lm_mixed_state(
                    lm_shard(wholes[kind], mesh, "model"))
                mst, mloss = mstep(mst, toks)
                sync()
                res["cases"][name]["mixed"] = (float(mloss), all(
                    torch.equal(p, m.to(torch.bfloat16)) for p, m in
                    zip(tree_leaves(mst.params), tree_leaves(mst.master))))
                del mst
                if cuda:
                    torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        res["done"] = time.time()
        q.put(("ok", res))
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        import traceback
        q.put(("err", traceback.format_exc()))


def phase_mesh_lm(torch) -> dict:
    """Phase 18: see the module docstring."""
    t0, wall0 = time.perf_counter(), time.time()
    # the probe's processes run beside the ranks' start-up, then exit
    probe = gloo_probe_start() if MESH_DEVICE == "cuda" else None
    log(f"[mesh] {MESH_RANKS} rank processes on {MESH_DEVICE}:0, each mesh "
        "a gloo group over CUDA tensors (passed explicitly: NCCL cannot put "
        "two ranks on one card), every collective staged through pinned "
        "host memory; collective times below are that host route's, not "
        "NCCL's")
    results = run_workers(mesh_worker, MESH_RANKS,
                          (free_port(), MESH_DEVICE, mesh_config()),
                          MESH_TIMEOUT_S, "mesh LM rank")
    for op, what in (gloo_probe_read(probe) if probe else {}).items():
        log(f"[mesh] gloo {op}, called directly on CUDA tensors in two "
            f"processes on the card: {what}")
    depth = LM_TRAIN["depth"]
    launches = {}
    b1 = 0
    for name, shape, _, sopts in MESH_CASES:
        mine = [r["cases"][name] for r in results[:math.prod(shape)]]
        c0 = mine[0]
        ref = c0["ref_loss"]
        for r, c in enumerate(mine):
            check(all(math.isfinite(x) for x in c["losses"]),
                  f"[{name}] rank {r}: non-finite loss {c['losses']}")
            check(c["losses"] == c0["losses"],
                  f"[{name}] the ranks' losses differ: "
                  f"{[m['losses'] for m in mine]}")
        rel = abs(c0["losses"][0] - ref) / abs(ref)
        check(rel <= MESH_LOSS_RTOL,
              f"[{name}] first loss {c0['losses'][0]} against one rank's "
              f"{ref}: {rel:.3g} > {MESH_LOSS_RTOL}")
        want = (depth,) * 3 if name in MESH_FLASH else (0, 0, 0)
        per_step = tuple(x / MESH_STEPS for x in c0["counts"])
        check(per_step == want, f"[{name}] B5a/B5b/B5c {per_step} a step "
              f"(counts), expected {want}")
        prof = tuple(c0["profiled"][t] for t, _ in FLASH_KERNELS)
        check(MESH_DEVICE != "cuda" or prof == want,
              f"[{name}] the profiled step names B5a/B5b/B5c {prof} times, "
              f"expected {want}")
        if name in MESH_FLASH:
            check(MESH_DEVICE != "cuda" or c0["routes"] == {
                k: sorted(v) for k, v in FLASH_BF16_ROUTES.items()},
                f"[{name}] flash routes {c0['routes']}")
        launches[name] = c0["counts"]
        if sopts.get("fused"):
            check(c0["b1"] > 0, f"[{name}] fused=True launched no B1")
            b1 += c0["b1"]
        step_s = c0["secs"][1]
        coll = sum(c0["coll_s"].values())
        check(c0["f64_err"] < MESH_F64_TOL,
              f"[{name}] float64 implied update off by {c0['f64_err']:.3g} "
              f"of the one-rank gradient (tolerance {MESH_F64_TOL})")
        log(f"[mesh] {name} {shape} (dp, sp, tp): losses "
            f"{' '.join(f'{x:.5f}' for x in c0['losses'])} (one rank "
            f"{ref:.5f}, first off by {rel:.2e}); B5a/B5b/B5c a step "
            f"{per_step} by count, {prof} by profile names (expected "
            f"{want}); B1 {c0['b1']} launches in {MESH_STEPS} steps; "
            f"step host clock {c0['secs'][0] * 1e3:.1f} (first) / "
            f"{step_s * 1e3:.1f} (timed) / {c0['secs'][2] * 1e3:.1f} "
            f"(profiled) ms, collectives {coll * 1e3:.1f} ms = "
            f"{coll / step_s:.1%} of the timed step on the gloo host route "
            f"(not NCCL): "
            + ", ".join(f"{k} {c0['coll_calls'][k]} calls "
                        f"{c0['coll_bytes'][k] / 1e6:.1f} MB "
                        f"{c0['coll_s'][k] * 1e3:.1f} ms"
                        for k in sorted(c0["coll_s"]))
            + f"; float64 implied update off by {c0['f64_err']:.2e} "
            f"(< {MESH_F64_TOL}); case {c0['case_s']:.1f} s")
    log("[mesh] timeline, seconds from the phase's start: " + "; ".join(
        f"rank {r['rank']} up {r['up'] - wall0:.1f}, profiler warm "
        f"{r['warm'] - wall0:.1f}, cases done at "
        + ", ".join(f"{n} {c['end'] - wall0:.1f}"
                    for n, c in r["cases"].items())
        + f", finished {r['done'] - wall0:.1f}" for r in results))
    mloss, inv = results[0]["cases"]["tp"]["mixed"]
    check(math.isfinite(mloss) and inv,
          f"[mesh] mixed step on the tp mesh: loss {mloss}, params == "
          f"master.to(bfloat16) {inv}")
    log(f"[mesh] (c) mixed step on (1, 1, 2): loss {mloss:.5f}, params == "
        "master.to(bfloat16) bit for bit on both ranks")
    wall = time.perf_counter() - t0
    log(f"[mesh] phase 18 took {wall:.1f} s (budget {MESH_BUDGET_S} s)")
    check(wall <= MESH_BUDGET_S, f"phase 18 took {wall:.1f} s, over its "
          f"{MESH_BUDGET_S}-s budget")
    return {"launches": launches, "b1": b1, "seconds": wall}


# ---------------------------------------------------------------------------
# Phase 19: the pipeline-parallel LM and the LM's optimizers (A11, second
# half)
# ---------------------------------------------------------------------------

# Ranks of phase 19: 4 processes sharing one card over gloo, as phase 18's
# (every collective staged through pinned host memory, not NCCL's).
PP_RANKS = 4
PP_DEVICE = "cuda"            # the rank processes' device (cuda:0)
PP_TIMEOUT_S = 500
PP_BUDGET_S = 240             # the phase's wall time
PP_STEPS = 3
PP_M = 4                      # microbatches a step in (a)
# (a): (name, (dp, pipe), schedule); phase 12's batch of 8 x 1024
PP_CASES = (("gpipe_14", (1, 4), "gpipe"), ("gpipe_22", (2, 2), "gpipe"),
            ("1f1b_14", (1, 4), "1f1b"))
# (b): S = 4 and M = 16 microbatches of one row each, no remat
PP_MEM_M = 16
# (a): float64, xla, the implied update against one rank's gradient
PP_F64 = dict(vocab=256, dim=64, depth=4, heads=4, max_len=128)
PP_F64_BATCH, PP_F64_TOL = 4, 1e-5
# (c): the optimizer steps, Adam's learning rate; FSDP and its reference
# SGD step at phase 12's
OPT_LR = 1e-4
# ZeRO-1 against the replicated Adam step: phase 17(d)'s tolerance; FSDP
# against build_lm_step: tests/test_optax_step.py:436's
OPT_ZERO_TOL = (1e-6, 1e-7)
OPT_FSDP_LOSS_RTOL, OPT_FSDP_TOL = 1e-6, (1e-5, 1e-6)


def pp_launches(schedule: str, S: int, M: int, k: int) -> tuple:
    """B5a/B5b/B5c launches a step on every rank, as ported (remat off):
    GPipe runs every stage in each of its ``T = M + S - 1`` ticks (bubble
    ticks on zeros) and autograd runs every tick's backward, so ``T*k``
    each; 1F1B runs the forward in each of its ``T = M + 2S - 2`` ticks
    (no grad: B5a), and recomputes and differentiates only the ``M`` ticks
    whose microbatch is in range (B5a, then B5b and B5c)."""
    if schedule == "gpipe":
        T = M + S - 1
        return (T * k,) * 3
    T = M + 2 * S - 2
    return (T * k + M * k, M * k, M * k)


def pp_config() -> dict:
    """Phase 19's sizes, handed to the rank processes (a rehearsal's
    smaller sizes reach them only this way)."""
    return {"lm": LM_TRAIN, "batch": LM_TRAIN_BATCH, "lr": LM_TRAIN_LR,
            "steps": PP_STEPS, "M": PP_M, "cases": PP_CASES,
            "mem_M": PP_MEM_M, "f64": PP_F64, "f64_batch": PP_F64_BATCH,
            "opt_lr": OPT_LR}


def pp_ckpt_dir(cfg: dict) -> dict:
    """``cfg`` with a new temporary directory for (c)'s sharded ZeRO-1
    checkpoint."""
    import tempfile
    return dict(cfg, ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_zero_"))


def pp_worker(rank: int, port: int, device: str, cfg: dict, q) -> None:
    """One rank of phase 19 (a spawned process on ``device``): (a) the
    pipeline cases, (b) the memory of both schedules, (c) the optimizer
    steps."""
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from distlearn_tpu_torch.utils.profiling import settled_profile

        from distlearn_tpu_torch.models.convert import (fsdp_gather,
                                                        lm_gather,
                                                        lm_pp_gather,
                                                        lm_pp_shard,
                                                        lm_shard, lm_to_jax,
                                                        lm_zero_records,
                                                        lm_zero_restore)
        from distlearn_tpu_torch.models.transformer import (lm_loss,
                                                            transformer_lm)
        from distlearn_tpu_torch.ops import flash_attention as fa
        from distlearn_tpu_torch.parallel.mesh import Mesh
        from distlearn_tpu_torch.train import lm as tlm
        from distlearn_tpu_torch.train import optim
        from distlearn_tpu_torch.utils.checkpoint import (
            restore_sharded_checkpoint, save_sharded_checkpoint)
        from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
        sync = (lambda: torch.cuda.synchronize(dev)) if cuda else \
            (lambda: None)
        dist.init_process_group("gloo", rank=rank, world_size=PP_RANKS,
                                init_method=f"tcp://localhost:{port}")
        res = {"rank": rank, "cases": {}, "opt": {}, "up": time.time()}
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts):       # CUPTI's start-up, here
            torch.ones(1, device=dev).add_(1)
            sync()
        res["warm"] = time.time()
        lmc, f64 = cfg["lm"], cfg["f64"]
        B, L, depth = cfg["batch"], lmc["max_len"], lmc["depth"]
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, lmc["vocab"], (B, L)).astype(np.int32)).to(dev)
        model = transformer_lm(compute_dtype=torch.bfloat16,
                               attn_impl="flash", **lmc)
        whole = model.init(0, device="cpu")[0]
        # every rank builds every mesh, in one order (group creation is
        # collective); the pipeline meshes' axes are (data, pipe)
        meshes = {shape: Mesh(shape, ("data", "pipe"), device=dev,
                              backend="gloo", ranks=range(PP_RANKS))
                  for shape in sorted({c[1] for c in cfg["cases"]})}
        opt_mesh = Mesh((PP_RANKS, 1, 1), device=dev, backend="gloo",
                        ranks=range(PP_RANKS))
        zm_mesh = Mesh((2, 1, 2), device=dev, backend="gloo",
                       ranks=range(PP_RANKS))
        if rank == 0:
            # one rank's loss of the same weights and batch
            with torch.no_grad():
                dwhole = tree_map(lambda t: t.to(dev), whole)
                res["ref_loss"] = float(lm_loss(model, dwhole, tokens))
                del dwhole
            if cuda:
                torch.cuda.empty_cache()

        def run_steps(mesh, step, state, toks, steps, after=None):
            """``steps`` steps, the second timed (collectives charged), the
            last profiled, ``after(i, state)`` after step ``i``: ``(state,
            record)``."""
            reset_flash_counts(fa)
            losses, secs, keys = [], [], []
            coll = calls = nbytes = {}
            for i in range(steps):
                mesh.stats.reset()
                mesh.timed = i == 1
                sync()
                t = time.perf_counter()
                if i == steps - 1:
                    with settled_profile(acts, sync) as prof:
                        t = time.perf_counter()
                        state, loss = step(state, toks)
                        sync()
                    keys = [e.key for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            for _ in range(e.count)]
                else:
                    state, loss = step(state, toks)
                    sync()
                secs.append(time.perf_counter() - t)
                losses.append(float(loss))
                if i == 1:
                    coll, calls = dict(mesh.stats.seconds), \
                        dict(mesh.stats.calls)
                    nbytes = dict(mesh.stats.bytes)
                if after is not None:
                    after(i, state)
            mesh.timed = False
            return state, {
                "losses": losses, "secs": secs, "coll_s": coll,
                "coll_calls": calls, "coll_bytes": nbytes,
                "counts": flash_counts(fa),
                "routes": {k: sorted(v) for k, v in
                           flash_routes(keys).items()},
                "profiled": {tag: sum(sub in k for k in keys)
                             for tag, sub in FLASH_KERNELS}}

        def pp_builder(schedule):
            return tlm.build_lm_pp_1f1b_step if schedule == "1f1b" \
                else tlm.build_lm_pp_step

        def pp_state_step(pp_step):
            def step(st, toks):
                shared, stacked, loss = pp_step(*st, toks)
                return (shared, stacked), loss
            return step

        def rows(mesh, toks):
            d = mesh.axis("data")
            per = toks.shape[0] // d.size
            return toks[d.index * per:(d.index + 1) * per].contiguous()

        # (a) the pipeline cases
        fmodel = transformer_lm(dtype=torch.float64, attn_impl="xla", **f64)
        fwhole = fmodel.init(1, device="cpu")[0]
        ftoks = torch.from_numpy(np.random.RandomState(1).randint(
            0, f64["vocab"], (cfg["f64_batch"], f64["max_len"]))
            .astype(np.int32)).to(dev)
        for name, shape, schedule in cfg["cases"]:
            t_case = time.perf_counter()
            mesh = meshes[shape]
            pp_step = pp_builder(schedule)(
                mesh, *tlm.stack_blocks(whole, depth), lr=cfg["lr"],
                num_microbatches=cfg["M"], compute_dtype=torch.bfloat16,
                attn_impl="flash")
            state = lm_pp_shard(whole, mesh, depth)
            state, rec = run_steps(mesh, pp_state_step(pp_step), state,
                                   rows(mesh, tokens), cfg["steps"])
            del state, pp_step
            if cuda:
                torch.cuda.empty_cache()
            fstep = pp_builder(schedule)(
                mesh, *tlm.stack_blocks(fwhole, f64["depth"]), lr=1.0,
                num_microbatches=2, attn_impl="xla")
            sh, st, _ = fstep(*lm_pp_shard(fwhole, mesh, f64["depth"]),
                              rows(mesh, ftoks))
            got = lm_pp_gather(sh, st, mesh, f64["depth"])
            if rank == 0:
                dwhole = tree_map(lambda t: t.to(dev), fwhole)
                _, g = mesh_reference(torch, fmodel, dwhole, ftoks,
                                      shape[0], 0.0)
                worst = 0.0
                for a, b, gg in zip(tree_leaves(lm_to_jax(fwhole)),
                                    tree_leaves(got),
                                    tree_leaves(lm_to_jax(g))):
                    denom = max(1e-12, float(np.abs(gg).max()))
                    worst = max(worst, float(np.abs(a - b - gg).max())
                                / denom)
                rec["f64_err"] = worst
            rec["case_s"] = time.perf_counter() - t_case
            rec["end"] = time.time()
            res["cases"][name] = rec

        # (b) the peak memory of each schedule at S = 4, M = 16
        mesh = meshes[(1, PP_RANKS)]
        mem_toks = torch.from_numpy(np.random.RandomState(2).randint(
            0, lmc["vocab"], (cfg["mem_M"], L)).astype(np.int32)).to(dev)
        res["mem"] = {}
        for schedule in ("gpipe", "1f1b"):
            state = lm_pp_shard(whole, mesh, depth)
            pp_step = pp_builder(schedule)(
                mesh, *tlm.stack_blocks(whole, depth), lr=cfg["lr"],
                num_microbatches=cfg["mem_M"], compute_dtype=torch.bfloat16,
                attn_impl="flash")
            sync()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            t = time.perf_counter()
            out = pp_step(*state, mem_toks)
            sync()
            secs = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            res["mem"][schedule] = {"peak": peak,
                                    "base": base if cuda else 0,
                                    "loss": float(out[2]), "secs": secs}
            del state, pp_step, out
        if cuda:
            torch.cuda.empty_cache()

        # (c) the optimizer steps, phase 12's batch over the data ranks
        tx = optim.adam(cfg["opt_lr"])
        params = lm_shard(whole, opt_mesh)
        def zero_save(i, state):
            """After the second ZeRO-1 step every rank saves its records
            (the master and Adam rows; the params once, by rank 0)."""
            if i != 1:
                return
            t = time.perf_counter()
            save_sharded_checkpoint(cfg["ckpt_dir"], 2,
                                    lm_zero_records(state, opt_mesh),
                                    process_index=rank)
            res["ckpt"] = {"save_s": time.perf_counter() - t,
                           "saved_params": lm_gather(state.params, opt_mesh)
                           if rank == 0 else None}

        def zero_resume(step, state, losses):
            """(c)'s resume: a fresh state restored from every rank's file
            takes step 3, which must equal the uninterrupted step 3 bit for
            bit; on rank 0 the params restored whole from the files must
            equal ``lm_gather``'s at the save."""
            dist.barrier()             # every rank's file is on disk
            t = time.perf_counter()
            fresh = optim.init_lm_zero_state(params, opt_mesh, tx)
            st2, meta = lm_zero_restore(cfg["ckpt_dir"], fresh, opt_mesh)
            sync()
            rec = res["ckpt"]
            rec["restore_s"] = time.perf_counter() - t
            rec["step"] = meta.get("step")
            st2, loss = step(st2, rows(opt_mesh, tokens))
            sync()
            rec["loss"], rec["loss_ref"] = float(loss), losses[2]
            rec["equal"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(st2), tree_leaves(state)))
            saved = rec.pop("saved_params")
            if saved is not None:
                whole, _ = restore_sharded_checkpoint(
                    cfg["ckpt_dir"], {"params": saved}, step=2)
                rec["whole_equal"] = all(
                    np.array_equal(a, b) for a, b in zip(
                        tree_leaves(whole["params"]), tree_leaves(saved)))
            rec["files_mb"] = sum(
                os.path.getsize(os.path.join(cfg["ckpt_dir"], f))
                for f in os.listdir(cfg["ckpt_dir"])) / 1e6
            del st2, fresh

        for name in ("optax", "mixed", "zero", "zero_mesh", "fsdp", "sgd"):
            t_case = time.perf_counter()
            mesh = opt_mesh
            after = None
            if name == "optax":
                step = optim.build_lm_optax_step(model, mesh, tx)
                state = optim.LMOptaxState(params, tx.init(params))
            elif name == "mixed":
                step = optim.build_lm_mixed_optax_step(model, mesh, tx)
                state = optim.init_lm_mixed_optax_state(params, tx)
            elif name == "zero":
                step = optim.build_lm_zero_step(model, mesh, tx)
                state = optim.init_lm_zero_state(params, mesh, tx)
                after = zero_save
            elif name == "zero_mesh":
                mesh = zm_mesh
                step = optim.build_lm_zero_mesh_step(
                    model, mesh, tx, seq_axis="seq", tp_axis="model")
                state = optim.init_lm_zero_mesh_state(
                    lm_shard(whole, mesh, "model"), mesh, tx,
                    tp_axis="model")
            elif name == "fsdp":
                step = optim.build_lm_fsdp_step(model, mesh, whole,
                                                lr=cfg["lr"])
                state = optim.init_lm_fsdp_params(whole, mesh)
                res["fsdp_sizes"] = [
                    (s.numel(), w.numel()) for s, w in
                    zip(tree_leaves(state), tree_leaves(whole))]
            else:
                step = tlm.build_lm_step(model, mesh, lr=cfg["lr"])
                state = params
            state, rec = run_steps(mesh, step, state, rows(mesh, tokens),
                                   cfg["steps"], after)
            if name == "zero":
                zero_resume(step, state, rec["losses"])
            if name == "mixed":
                rec["invariant"] = all(
                    torch.equal(p, m.to(torch.bfloat16)) for p, m in
                    zip(tree_leaves(state.params),
                        tree_leaves(state.master)))
            if name in ("optax", "zero"):
                res[name] = [t.cpu() for t in tree_leaves(state.params)]
            if name == "fsdp":
                res["fsdp"] = fsdp_gather(state, mesh, whole)
            if name == "sgd":
                res["sgd"] = lm_gather(state, mesh)
            rec["case_s"] = time.perf_counter() - t_case
            res["opt"][name] = rec
            del state, step
            if cuda:
                torch.cuda.empty_cache()
        # ZeRO-1 against the replicated Adam step, FSDP against SGD: here,
        # so that only numbers travel back
        pairs = list(zip(res.pop("zero"), res.pop("optax")))
        res["zero_err"] = max(
            float(((a - b).abs() - (OPT_ZERO_TOL[0] * b.abs()
                                    + OPT_ZERO_TOL[1])).max())
            for a, b in pairs)
        res["zero_diff"] = max(float((a - b).abs().max()) for a, b in pairs)
        pairs = list(zip(tree_leaves(res.pop("fsdp")),
                         tree_leaves(res.pop("sgd"))))
        res["fsdp_err"] = max(
            float((np.abs(a - b) - (OPT_FSDP_TOL[0] * np.abs(b)
                                    + OPT_FSDP_TOL[1])).max())
            for a, b in pairs)
        res["fsdp_diff"] = max(float(np.abs(a - b).max()) for a, b in pairs)
        dist.barrier()
        dist.destroy_process_group()
        res["done"] = time.time()
        q.put(("ok", res))
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        import traceback
        q.put(("err", traceback.format_exc()))


def coll_line(c) -> str:
    step_s = c["secs"][1]
    coll = sum(c["coll_s"].values())
    return (f"step host clock {c['secs'][0] * 1e3:.1f} (first) / "
            f"{step_s * 1e3:.1f} (timed) / {c['secs'][-1] * 1e3:.1f} "
            f"(profiled) ms, collectives {coll * 1e3:.1f} ms = "
            f"{coll / step_s:.1%} of the timed step on the gloo host route "
            f"(not NCCL): "
            + ", ".join(f"{k} {c['coll_calls'][k]} calls "
                        f"{c['coll_bytes'][k] / 1e6:.1f} MB "
                        f"{c['coll_s'][k] * 1e3:.1f} ms"
                        for k in sorted(c["coll_s"])))


def check_flash(name, c, want, steps, cuda):
    """B5a/B5b/B5c a step by count and in the profiled step by name."""
    per_step = tuple(x / steps for x in c["counts"])
    check(per_step == want, f"[{name}] B5a/B5b/B5c {per_step} a step "
          f"(counts), expected {want}")
    prof = tuple(c["profiled"][t] for t, _ in FLASH_KERNELS)
    check(not cuda or prof == want,
          f"[{name}] the profiled step names B5a/B5b/B5c {prof} times, "
          f"expected {want}")
    check(not cuda or c["routes"] == {
        k: sorted(v) for k, v in FLASH_BF16_ROUTES.items()},
        f"[{name}] flash routes {c['routes']}")
    return per_step, prof


def phase_pp_lm(torch) -> dict:
    """Phase 19: see the module docstring."""
    t0, wall0 = time.perf_counter(), time.time()
    cuda = PP_DEVICE == "cuda"
    log(f"[pp] {PP_RANKS} rank processes on {PP_DEVICE}:0 over gloo, every "
        "collective staged through pinned host memory (not NCCL)")
    import shutil
    cfg = pp_ckpt_dir(pp_config())
    try:
        results = run_workers(pp_worker, PP_RANKS,
                              (free_port(), PP_DEVICE, cfg),
                              PP_TIMEOUT_S, "pp LM rank")
    finally:
        shutil.rmtree(cfg["ckpt_dir"], ignore_errors=True)
    depth = LM_TRAIN["depth"]
    ref = results[0]["ref_loss"]
    launches = {}
    for name, shape, schedule in PP_CASES:
        mine = [r["cases"][name] for r in results]
        c0 = mine[0]
        for r, c in enumerate(mine):
            check(all(math.isfinite(x) for x in c["losses"]),
                  f"[{name}] rank {r}: non-finite loss {c['losses']}")
            check(c["losses"] == c0["losses"],
                  f"[{name}] the ranks' losses differ: "
                  f"{[m['losses'] for m in mine]}")
        rel = abs(c0["losses"][0] - ref) / abs(ref)
        check(rel <= MESH_LOSS_RTOL,
              f"[{name}] first loss {c0['losses'][0]} against one rank's "
              f"{ref}: {rel:.3g} > {MESH_LOSS_RTOL}")
        want = pp_launches(schedule, shape[1], PP_M, depth // shape[1])
        got = [check_flash(f"{name} rank {r}", c, want, PP_STEPS, cuda)
               for r, c in enumerate(mine)]
        launches[name] = c0["counts"]
        check(c0["f64_err"] < PP_F64_TOL,
              f"[{name}] float64 implied update off by {c0['f64_err']:.3g} "
              f"of the one-rank gradient (tolerance {PP_F64_TOL})")
        log(f"[pp] (a) {name} {shape} (dp, pipe), {schedule}, M {PP_M}: "
            f"losses {' '.join(f'{x:.5f}' for x in c0['losses'])} (one "
            f"rank {ref:.5f}, first off by {rel:.2e}); B5a/B5b/B5c a step "
            f"{got[0][0]} by count, {got[0][1]} by profile names on every "
            f"rank (predicted {want}); {coll_line(c0)}; float64 implied "
            f"update off by {c0['f64_err']:.2e} (< {PP_F64_TOL}); case "
            f"{c0['case_s']:.1f} s")
    for r, res in enumerate(results):
        g, f = res["mem"]["gpipe"], res["mem"]["1f1b"]
        check(math.isfinite(g["loss"]) and g["loss"] == f["loss"],
              f"[pp] (b) rank {r}: GPipe loss {g['loss']} against 1F1B's "
              f"{f['loss']} (one forward, one order of the shares)")
        check(not cuda or f["peak"] < g["peak"],
              f"[pp] (b) rank {r}: 1F1B's peak {f['peak'] / 1e9:.3f} GB is "
              f"not below GPipe's {g['peak'] / 1e9:.3f} GB")
        log(f"[pp] (b) rank {r} (stage {r}), S {PP_RANKS}, M {PP_MEM_M}: "
            f"peak allocated GPipe {g['peak'] / 1e9:.3f} GB, 1F1B "
            f"{f['peak'] / 1e9:.3f} GB (params and state before the step "
            f"{g['base'] / 1e9:.3f} GB); step {g['secs']:.2f} / "
            f"{f['secs']:.2f} s; loss {g['loss']:.5f} / {f['loss']:.5f}")
    want = (depth,) * 3
    for name in ("optax", "mixed", "zero", "zero_mesh", "fsdp", "sgd"):
        mine = [r["opt"][name] for r in results]
        c0 = mine[0]
        for r, c in enumerate(mine):
            check(all(math.isfinite(x) for x in c["losses"]),
                  f"[{name}] rank {r}: non-finite loss {c['losses']}")
            check(c["losses"] == c0["losses"],
                  f"[{name}] the ranks' losses differ")
        got = [check_flash(f"{name} rank {r}", c, want, PP_STEPS, cuda)
               for r, c in enumerate(mine)]
        launches[name] = c0["counts"]
        extra = ""
        if name == "mixed":
            check(all(c["invariant"] for c in mine),
                  "[mixed] params != master.to(bfloat16) after the steps")
            extra = "; params == master.to(bfloat16) bit for bit"
        log(f"[pp] (c) {name}: losses "
            f"{' '.join(f'{x:.5f}' for x in c0['losses'])}; B5a/B5b/B5c a "
            f"step {got[0][0]} by count, {got[0][1]} by profile names "
            f"(predicted {want}){extra}; {coll_line(c0)}; case "
            f"{c0['case_s']:.1f} s")
    zero_err = max(r["zero_err"] for r in results)
    check(zero_err <= 0, f"[zero] params off the replicated Adam step's by "
          f"{zero_err:.3g} beyond rtol {OPT_ZERO_TOL[0]}, atol "
          f"{OPT_ZERO_TOL[1]}")
    fsdp_err = max(r["fsdp_err"] for r in results)
    l_f, l_s = (results[0]["opt"][n]["losses"] for n in ("fsdp", "sgd"))
    check(all(abs(a - b) <= OPT_FSDP_LOSS_RTOL * abs(b)
              for a, b in zip(l_f, l_s)) and fsdp_err <= 0,
          f"[fsdp] against build_lm_step: losses {l_f} / {l_s}, params "
          f"beyond rtol {OPT_FSDP_TOL[0]}, atol {OPT_FSDP_TOL[1]} by "
          f"{fsdp_err:.3g}")
    for r, res in enumerate(results):
        ck = res["ckpt"]
        check(ck["step"] == 2 and ck["equal"] and ck["loss"] == ck["loss_ref"],
              f"[zero] rank {r}: the step after restoring the sharded "
              f"checkpoint of step 2 (loss {ck['loss']}) is not the "
              f"uninterrupted step 3 (loss {ck['loss_ref']}) bit for bit "
              f"(state equal: {ck['equal']})")
    check(results[0]["ckpt"].get("whole_equal") is True,
          "[zero] the params restored whole from the rank files differ "
          "from lm_gather's at the save")
    ck0 = results[0]["ckpt"]
    log(f"[pp] (c) ZeRO-1 sharded checkpoint after step 2: {PP_RANKS} rank "
        f"files, {ck0['files_mb']:.1f} MB (the params once, by rank 0; "
        f"each rank its master and Adam rows), save "
        f"{max(r['ckpt']['save_s'] for r in results):.2f} s, restore "
        f"{max(r['ckpt']['restore_s'] for r in results):.2f} s (slowest "
        f"rank); step 3 from the restored state equal to the "
        f"uninterrupted step 3 bit for bit on every rank (loss "
        f"{ck0['loss']:.6f}); the whole params restored from the files "
        f"equal lm_gather's")
    sizes = results[0]["fsdp_sizes"]
    held = sum(s for s, _ in sizes)
    whole = sum(w for _, w in sizes)
    check(all(s * PP_RANKS == w or s == w for s, w in sizes)
          and held * PP_RANKS == whole,
          f"[fsdp] a rank holds {held} of {whole} params")
    fs = results[0]["opt"]["fsdp"]
    log(f"[pp] (c) ZeRO-1 within rtol {OPT_ZERO_TOL[0]}, atol "
        f"{OPT_ZERO_TOL[1]} of the replicated Adam step (largest difference "
        f"{max(r['zero_diff'] for r in results):.3g}); FSDP within "
        f"rtol {OPT_FSDP_LOSS_RTOL} (loss), rtol {OPT_FSDP_TOL[0]}, atol "
        f"{OPT_FSDP_TOL[1]} of build_lm_step (largest difference "
        f"{max(r['fsdp_diff'] for r in results):.3g}); FSDP storage {held} of "
        f"{whole} params a rank, {fs['coll_calls'].get('all_gather', 0)} "
        f"gathers ({fs['coll_bytes'].get('all_gather', 0) / 1e6:.1f} MB) "
        f"and {fs['coll_calls'].get('psum_scatter', 0)} reduce-scatters "
        f"({fs['coll_bytes'].get('psum_scatter', 0) / 1e6:.1f} MB) a step")
    log("[pp] timeline, seconds from the phase's start: " + "; ".join(
        f"rank {r['rank']} up {r['up'] - wall0:.1f}, profiler warm "
        f"{r['warm'] - wall0:.1f}, cases done at "
        + ", ".join(f"{n} {c['end'] - wall0:.1f}"
                    for n, c in r["cases"].items())
        + f", finished {r['done'] - wall0:.1f}" for r in results))
    wall = time.perf_counter() - t0
    log(f"[pp] phase 19 took {wall:.1f} s (budget {PP_BUDGET_S} s)")
    check(wall <= PP_BUDGET_S, f"phase 19 took {wall:.1f} s, over its "
          f"{PP_BUDGET_S}-s budget")
    return {"launches": launches, "seconds": wall}


# ---------------------------------------------------------------------------
# Phase 20: the serving fleet (tensor-parallel engine, router, hot swap)
# ---------------------------------------------------------------------------

FLEET_RANKS = 2               # the tp engine's ranks (leader + follower)
FLEET_DEVICE = "cuda"         # the rank processes' device (cuda:0)
FLEET_TIMEOUT_S = 300
FLEET_BUDGET_S = 150          # the phase's wall time
FLEET_REQUESTS, FLEET_THREADS, FLEET_MAX_NEW = 8, 4, 32
FLEET_KILL_AT = 4             # replica A stops as request 4 is submitted
FLEET_SWAP_REQUESTS = 2       # requests after the epoch-2 swap
FLEET_SLOTS = 4
# (b)'s prompt lengths, 100-1500 tokens in a seeded order: the two below
# the 256-token prefill chunk take the full-prompt pass (B5a), the rest the
# chunk pass
FLEET_PROMPTS = (100, 200, 400, 600, 800, 1000, 1250, 1500)


def fleet_config() -> dict:
    """Phase 20's sizes, handed to the rank processes (a rehearsal's
    smaller sizes reach them only this way)."""
    return {"flags": LM_FLAGS, "check_prompt": LM_CHECK_PROMPT,
            "check_steps": LM_CHECK_STEPS, "chunk": SERVE_PREFILL_CHUNK,
            "slots": FLEET_SLOTS}


def fleet_model(lm_example, flags, device):
    """Phase 10's LM from its seeded init, on ``device``: ``(opt, params,
    heads)``."""
    opt = lm_example.parse(flags)
    params = lm_example._init(lm_example._model(opt), opt, device)
    return opt, params, max(4, opt.dim // 64)


def fleet_worker(rank: int, port: int, device: str, cfg: dict, ctl, stop,
                 q) -> None:
    """One rank of phase 20's tp=2 engine (a spawned process on
    ``device``): (a) rank 0 leads the float32 and bfloat16 checks and
    holds each stream against the single-rank engine on the same weights;
    (b) rank 0 serves as fleet replica B until ``stop`` is set.  Rank 1
    follows every engine, profiled."""
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from distlearn_tpu_torch.utils.profiling import settled_profile

        from distlearn_tpu_torch import obs
        from distlearn_tpu_torch.examples import lm as lm_example
        from distlearn_tpu_torch.models.transformer import transformer_lm
        from distlearn_tpu_torch.obs import trace as obs_trace
        from distlearn_tpu_torch.ops import flash_attention as fa
        from distlearn_tpu_torch.parallel.mesh import Mesh
        from distlearn_tpu_torch.serve import DecodeEngine, ServeServer

        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
        sync = (lambda: torch.cuda.synchronize(dev)) if cuda else \
            (lambda: None)
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        os.environ["DISTLEARN_TPU_ATTN"] = "flash"
        dist.init_process_group("gloo", rank=rank, world_size=FLEET_RANKS,
                                init_method=f"tcp://localhost:{port}")
        mesh = Mesh((FLEET_RANKS,), ("model",), device=dev, backend="gloo")
        opt, whole, heads = fleet_model(lm_example, cfg["flags"], dev)
        leader = rank == 0
        res = {"rank": rank, "checks": {}}

        def engine(cd, slots=1):
            return DecodeEngine(whole, num_slots=slots, compute_dtype=cd,
                                mesh=mesh, tp_axis="model")

        def follow(eng):
            """Replay the leader's ops, every device event profiled:
            ``(ops, B5a launches, B5a kernels named, routes)``."""
            fa.flash_attention.launches = 0
            with settled_profile(acts, sync) as prof:
                done = eng.follow()
                sync()
            keys = [e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    for _ in range(e.count)]
            return {"ops": done, "launches": fa.flash_attention.launches,
                    "named": sum("flash_fwd" in k for k in keys),
                    "routes": {k: sorted(v) for k, v in
                               flash_routes(keys).items()}}

        def stream(eng, prompt, n, chunk=None, drafts=None):
            job = eng.begin(prompt, n)
            first = eng.prefill_step(job, chunk)
            while first is None:
                first = eng.prefill_step(job, chunk)
            toks = [first]
            while len(toks) < n:
                if drafts is None:
                    toks.append(eng.tick()[job.slot])
                else:
                    k = len(toks)
                    toks.extend(eng.verify(
                        {job.slot: drafts[k:k + eng.spec_k]})[job.slot])
            eng.finish(job.slot)
            return toks[:n]

        rng = np.random.default_rng(20)
        prompt = rng.integers(0, opt.vocab, cfg["check_prompt"]) \
            .astype(np.int32)
        n_new = cfg["check_steps"]
        for tag, cd in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            eng = engine(cd)
            if not leader:
                res["checks"][tag] = follow(eng)
                del eng
                continue
            rec = {}
            fa.flash_attention.launches = 0
            full = stream(eng, prompt, n_new)
            chunked = stream(eng, prompt, n_new, chunk=cfg["chunk"])
            wrong = list(full)
            wrong[5] = (wrong[5] + 1) % opt.vocab
            verified = stream(eng, prompt, n_new, drafts=wrong)
            # two full prefills: the plain stream's and verify's
            rec["launches"] = fa.flash_attention.launches
            # one full prefill profiled: B5a by name and route
            sync()
            with settled_profile(acts, sync) as prof:
                job = eng.begin(prompt, 1)
                eng.prefill_step(job)
                sync()
            eng.finish(job.slot)
            keys = [e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    for _ in range(e.count)]
            rec["named"] = sum("flash_fwd" in k for k in keys)
            rec["routes"] = {k: sorted(v) for k, v in
                             flash_routes(keys).items()}
            # one tick with its collectives timed
            job = eng.begin(prompt, 8)
            eng.prefill_step(job)
            eng.tick()
            sync()
            mesh.stats.reset()
            mesh.timed = True
            t = time.perf_counter()
            eng.tick()
            sync()
            rec["tick_ms"] = (time.perf_counter() - t) * 1e3
            mesh.timed = False
            rec["tick_psums"] = mesh.stats.calls.get("psum", 0)
            rec["tick_psum_ms"] = mesh.stats.seconds.get("psum", 0.0) * 1e3
            rec["tick_psum_bytes"] = mesh.stats.bytes.get("psum", 0)
            eng.finish(job.slot)
            # four full prefills in all: the follower replayed them too
            rec["launches_all"] = fa.flash_attention.launches
            eng.stop()
            del eng
            # the single-rank engine on the same weights
            ref_eng = DecodeEngine(whole, num_slots=1, compute_dtype=cd,
                                   device=dev)
            ref = stream(ref_eng, prompt, n_new)
            del ref_eng
            model = transformer_lm(vocab=opt.vocab, dim=opt.dim,
                                   depth=opt.depth, heads=heads,
                                   max_len=opt.seqLen, compute_dtype=cd,
                                   attn_impl="xla")
            rec["ties"] = {}
            for name, got in (("full", full), ("chunked", chunked),
                              ("verify", verified)):
                tie = compare_stream(torch, model, whole, prompt, got, ref,
                                     TIE_TOL[tag])
                rec["ties"][name] = tie
            rec["equal"] = {name: got == ref for name, got in
                            (("full", full), ("chunked", chunked),
                             ("verify", verified))}
            res["checks"][tag] = rec
            if cuda:
                torch.cuda.empty_cache()

        # (b) replica B: tp=2, float32, behind a server until stopped
        eng = engine(None, cfg["slots"])
        if not leader:
            res["serve"] = follow(eng)
        else:
            slot, _ = eng.admit(np.ones(4, np.int32), 2)
            eng.tick()
            eng.finish(slot)
            obs_trace.set_ring_size(1 << 16)
            obs_trace.clear()
            fa.flash_attention.launches = 0
            srv = ServeServer(eng, prefill_chunk=cfg["chunk"],
                              ckpt_dir=cfg["ckpt_dir"], ckpt_poll=0.1,
                              epoch=1).start()
            ctl.put(("serving", srv.host, srv.port))
            stop.wait(FLEET_TIMEOUT_S)
            sync()
            launches = fa.flash_attention.launches
            spans = {}
            for r_ in obs.spans():
                spans.setdefault(r_["name"], []).append(r_["dur"] * 1e3)
            res["serve"] = {"launches": launches,
                            "ttft_ms": p50(spans.get("serve.ttft", [])),
                            "tpot_ms": p50(spans.get("serve.tpot", [])),
                            "prefills": len(spans.get("serve.prefill", [])),
                            "epoch": srv.epoch, "failed": srv._failed}
            srv.stop()              # the follower's stop op
        del eng
        dist.barrier()
        dist.destroy_process_group()
        q.put(("ok", res))
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        import traceback
        q.put(("err", traceback.format_exc()))


def fleet_traffic(router, prompts, max_new, kill_at=None, kill=None):
    """One request per prompt through ``router`` from FLEET_THREADS
    threads (thread i sends requests i, i + FLEET_THREADS, ...); ``kill``
    runs as request ``kill_at`` is submitted.  Returns the results (an
    exception's text where a request raised)."""
    results = [None] * len(prompts)

    def one(i):
        for j in range(i, len(prompts), FLEET_THREADS):
            if j == kill_at:
                kill()
            try:
                results[j] = router.generate(prompts[j], max_new,
                                             rid=f"f{j}", timeout=240)
            except Exception as e:  # noqa: BLE001 — checked by the caller
                results[j] = {"reason": f"raised {e!r}", "tokens": [],
                              "epoch": None, "replica": None}

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(min(FLEET_THREADS, len(prompts)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(FLEET_TIMEOUT_S)
    check(not any(t.is_alive() for t in threads), "fleet traffic hung")
    return results


def phase_fleet(torch) -> dict:
    """Phase 20: see the module docstring."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import numpy as np
    from distlearn_tpu_torch import obs
    from distlearn_tpu_torch.examples import lm as lm_example
    from distlearn_tpu_torch.models.transformer import (greedy_generate,
                                                        transformer_lm)
    from distlearn_tpu_torch.obs import core as obs_core
    from distlearn_tpu_torch.obs import trace as obs_trace
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.serve import Router
    from distlearn_tpu_torch.utils.checkpoint import save_checkpoint
    from distlearn_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cuda = FLEET_DEVICE == "cuda"
    log(f"[fleet] a tp=2 engine as {FLEET_RANKS} rank processes on "
        f"{FLEET_DEVICE}:0 (leader and follower, gloo: every psum staged "
        "through pinned host memory), a single-rank replica in this "
        "process, a port Router in front")
    cfg = dict(fleet_config(),
               ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    ctx = mp.get_context("spawn")
    q, ctl, stop = ctx.Queue(), ctx.Queue(), ctx.Event()
    port = free_port()
    procs = [ctx.Process(target=fleet_worker,
                         args=(r, port, FLEET_DEVICE, cfg, ctl, stop, q))
             for r in range(FLEET_RANKS)]
    for p in procs:
        p.start()
    env = os.environ.get("DISTLEARN_TPU_ATTN")
    os.environ["DISTLEARN_TPU_ATTN"] = "flash"
    srv_a = router = None
    try:
        device = "cuda" if cuda else "cpu"
        opt, params, heads = fleet_model(lm_example, LM_FLAGS, device)
        opt.device = device
        model = transformer_lm(vocab=opt.vocab, dim=opt.dim, depth=opt.depth,
                               heads=heads, max_len=opt.seqLen,
                               attn_impl="xla")
        obs_trace.set_ring_size(1 << 16)
        obs_trace.clear()
        srv_a = lm_example.start_server(opt, params, None,
                                        prefill_chunk=SERVE_PREFILL_CHUNK,
                                        ckpt_dir=cfg["ckpt_dir"],
                                        ckpt_poll=0.1, epoch=1)
        try:
            kind, host_b, port_b = ctl.get(timeout=FLEET_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — a rank failed before serving
            errs = []
            while not q.empty():
                errs.append(q.get())
            raise SmokeFailure(f"replica B never served: {errs[:1]}")
        t_up = time.perf_counter() - t0
        name_a = f"{srv_a.host}:{srv_a.port}"
        name_b = f"{host_b}:{port_b}"
        router = Router([(srv_a.host, srv_a.port), (host_b, port_b)],
                        health_ttl=0.05, retry_interval=0.02)
        check(router.health()["live"] == 2, "the fleet's two replicas are "
              "not both live")
        rng = np.random.default_rng(21)
        lens = rng.permutation(FLEET_PROMPTS)
        prompts = [rng.integers(0, opt.vocab, n).astype(np.int32)
                   for n in lens]
        if cuda:
            torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t_traffic = time.perf_counter()
        results = fleet_traffic(router, prompts, FLEET_MAX_NEW,
                                kill_at=FLEET_KILL_AT, kill=srv_a.stop)
        wall = time.perf_counter() - t_traffic
        launches_a = fa.flash_attention.launches
        spans = {}
        for rec in obs.spans():
            spans.setdefault(rec["name"], []).append(rec["dur"] * 1e3)
        ttft_a, tpot_a = p50(spans.get("serve.ttft", [])), \
            p50(spans.get("serve.tpot", []))
        retries = {}
        for fam in obs_core.REGISTRY.snapshot():
            if fam["name"] == "router_retries_total":
                retries = {s["labels"].get("replica"): s["value"]
                           for s in fam["samples"]}
        # every request terminal; complete streams are greedy_generate's,
        # failed ones (on A when it died mid-stream) a prefix of it
        ties, by = [], {}
        for j, r in enumerate(results):
            check(r["reason"] in ("complete", "failed"),
                  f"[fleet] request {j} ended {r['reason']!r}")
            by.setdefault(r["replica"], []).append(r["reason"])
            ref = greedy_generate(params, prompts[j][None], FLEET_MAX_NEW,
                                  attn_impl="xla")[0].tolist()
            got = r["tokens"]
            if r["reason"] == "failed":
                check(r["replica"] == name_a and got == ref[:len(got)],
                      f"[fleet] request {j} failed on {r['replica']} with "
                      f"{len(got)} tokens off greedy_generate's")
                continue
            check(r["epoch"] == 1, f"[fleet] request {j} epoch "
                  f"{r['epoch']}")
            tie = compare_stream(torch, model, params, prompts[j], got, ref,
                                 TIE_TOL["float32"])
            if tie is not None:
                ties.append((j,) + tie)
        check(by.get(name_b), "[fleet] replica B served no request")
        # the epoch-2 checkpoint: every live replica (B) swaps and echoes 2
        new_params = tree_map(lambda t: t * 0.5, params)
        t_swap = time.perf_counter()
        save_checkpoint(cfg["ckpt_dir"], 1, new_params,
                        metadata={"epoch": 2})
        deadline = time.monotonic() + 120
        while router.health()["epochs"] != [2]:
            check(time.monotonic() < deadline,
                  f"[fleet] the live replicas echo epochs "
                  f"{router.health()['epochs']}, not [2]")
            time.sleep(0.1)
        swap_s = time.perf_counter() - t_swap
        after = [router.generate(prompts[j], FLEET_MAX_NEW, rid=f"s{j}",
                                 timeout=240)
                 for j in range(FLEET_SWAP_REQUESTS)]
        for j, r in enumerate(after):
            check(r["reason"] == "complete" and r["epoch"] == 2
                  and r["replica"] == name_b,
                  f"[fleet] post-swap request {j}: {r['reason']}, epoch "
                  f"{r['epoch']} on {r['replica']}")
            ref = greedy_generate(new_params, prompts[j][None],
                                  FLEET_MAX_NEW, attn_impl="xla")[0].tolist()
            tie = compare_stream(torch, model, new_params, prompts[j],
                                 r["tokens"], ref, TIE_TOL["float32"])
            if tie is not None:
                ties.append((f"s{j}",) + tie)
        stop.set()
        got = [q.get(timeout=FLEET_TIMEOUT_S) for _ in procs]
    finally:
        stop.set()
        if router is not None:
            router.close()
        if srv_a is not None:
            srv_a.stop()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(cfg["ckpt_dir"], ignore_errors=True)
        if env is None:
            os.environ.pop("DISTLEARN_TPU_ATTN", None)
        else:
            os.environ["DISTLEARN_TPU_ATTN"] = env
    errs = [r for kind, r in got if kind == "err"]
    check(not errs, f"a fleet rank failed: {errs[:1]}")
    lead, follower = sorted((r for _, r in got), key=lambda r: r["rank"])
    depth = opt.depth
    for tag in ("float32", "bfloat16"):
        c, f = lead["checks"][tag], follower["checks"][tag]
        check(c["launches"] == 2 * depth and c["launches_all"] == 4 * depth
              and f["launches"] == c["launches_all"],
              f"[fleet] (a) {tag}: B5a launched {c['launches']} times in "
              f"the leader's two full prefills ({c['launches_all']} in its "
              f"four) and {f['launches']} times on the follower; expected "
              f"{depth} a full prefill")
        check(c["named"] == depth and (not cuda or f["named"]
                                       == f["launches"]),
              f"[fleet] (a) {tag}: profiles name B5a {c['named']} times "
              f"in one prefill on the leader (expected {depth}) and "
              f"{f['named']} times in the follower's run (expected "
              f"{f['launches']})")
        want = {"B5a": ["mma" if tag == "bfloat16" else "tf32x3"]}
        check(not cuda or c["routes"] == want,
              f"[fleet] (a) {tag} flash routes {c['routes']}, expected "
              f"{want}")
        check(c["tick_psums"] == 2 * depth,
              f"[fleet] (a) {tag}: a tick ran {c['tick_psums']} psums, "
              f"expected {2 * depth}")
        log(f"[fleet] (a) {tag}, tp=2 against the single-rank engine on "
            f"the same weights, {LM_CHECK_STEPS} tokens of a "
            f"{LM_CHECK_PROMPT}-token prompt: full "
            f"{fleet_how(c, 'full')}, chunked ({SERVE_PREFILL_CHUNK}) "
            f"{fleet_how(c, 'chunked')}, verify {fleet_how(c, 'verify')}; "
            f"B5a {c['launches_all']} launches on the leader, "
            f"{f['launches']} on the follower ({depth} a full prefill, 4 "
            f"full prefills), {c['named']} "
            f"named in the leader's profiled prefill, {f['named']} in the "
            f"follower's whole run ({f['ops']} ops replayed); a tick "
            f"{c['tick_ms']:.2f} ms on the host clock, {c['tick_psums']} "
            f"psums of {c['tick_psum_bytes'] / 1e3:.1f} kB in "
            f"{c['tick_psum_ms']:.2f} ms (gloo host route)")
    sv, fv = lead["serve"], follower["serve"]
    check(sv["failed"] is None and sv["epoch"] == 2,
          f"[fleet] replica B: failed {sv['failed']}, epoch {sv['epoch']}")
    check(fv["launches"] == sv["launches"],
          f"[fleet] replica B's ranks launched B5a {sv['launches']} / "
          f"{fv['launches']} times")
    check(launches_a + sv["launches"] > 0 or not cuda,
          "[fleet] (b) B5a launched no time on the fleet's path")
    done = sum(r["reason"] == "complete" for r in results)
    log(f"[fleet] (b) {FLEET_REQUESTS} requests from {FLEET_THREADS} "
        f"threads, prompts {sorted(int(n) for n in lens)}, "
        f"{FLEET_MAX_NEW} new tokens, float32: {done} complete, "
        f"{len(results) - done} failed mid-stream when replica A stopped "
        f"at request {FLEET_KILL_AT}; by replica "
        + ", ".join(f"{'A' if k == name_a else 'B'} {v}"
                    for k, v in by.items())
        + f"; resubmitted {retries or 'none'}; every stream greedy_generate's"
        + (f" up to near-ties (request, token, gap, margin) {ties}" if ties
           else "") + f"; traffic {wall:.1f} s")
    log(f"[fleet] (b) epoch-2 checkpoint landed: replica B swapped and "
        f"echoed 2 in {swap_s:.1f} s (each rank reads the checkpoint and "
        f"takes its shard), {FLEET_SWAP_REQUESTS} requests after it all "
        "epoch 2, greedy_generate's on the new weights; no stream mixed "
        "epochs")
    log(f"[fleet] (b) TTFT / TPOT p50: replica A (one rank) {ttft_a:.2f} / "
        f"{tpot_a:.2f} ms, replica B (tp=2) {sv['ttft_ms']:.2f} / "
        f"{sv['tpot_ms']:.2f} ms; B5a launches A {launches_a}, B "
        f"{sv['launches']} on each rank ({sv['prefills']} full prefills "
        f"on B)")
    wall = time.perf_counter() - t0
    log(f"[fleet] phase 20 took {wall:.1f} s (budget {FLEET_BUDGET_S} s; "
        f"fleet up after {t_up:.1f} s)")
    check(wall <= FLEET_BUDGET_S, f"phase 20 took {wall:.1f} s, over its "
          f"{FLEET_BUDGET_S}-s budget")
    return {"tp_launches": {t: lead["checks"][t]["launches"]
                            for t in ("float32", "bfloat16")},
            "fleet_launches": {"A": launches_a, "B": sv["launches"]},
            "seconds": wall}


def fleet_how(c, name) -> str:
    if c["equal"][name]:
        return "equal"
    tie = c["ties"][name]
    return (f"equal up to a near-tie at token {tie[0]} (gap {tie[1]:.3g}, "
            f"top-2 margin {tie[2]:.3g})")


# Phase 21: the fleet tools (ROADMAP A13) driving the port
TOOLS_DEVICE = "cuda"
TOOLS_BUDGET_S = 150          # the phase's wall time
TOOLS_ROUNDS = 8
TOOLS_KILLS = (3,)
TOOLS_SHARDS = 4
TOOLS_CHURN_CLIENTS, TOOLS_CHURN_KILLS = 3, 1
TOOLS_PREFIX = 128            # zipf_mix's system prompts (16 pages of 8)
TOOLS_PROMPTS = (100, 1501)   # replica_kill's prompt lengths, [lo, hi)
TOOLS_CHUNK = 256             # the replicas' prefill chunk (phase 10's)
TOOLS_EA_RANKS, TOOLS_EA_BUDGET_S, TOOLS_EA_LINK = 4, 3.0, 20e6
TOOLS_EA_TAU, TOOLS_EA_ALPHA = 4, 0.225
TOOLS_RESNET_BATCH, TOOLS_RESNET_STEPS = 256, 4
# PERF.md section 5, phase 17's profiled bfloat16 ResNet-50 step (NVIDIA
# H100 80GB HBM3 at 700 W): busy 248.3 ms of 269.5, elementwise 82.1%
PHASE17_BF16 = {"busy_ms": 248.3, "wall_ms": 269.5, "elementwise": 0.821}


def names_with(counts: dict, sub: str) -> int:
    return sum(n for k, n in counts.items() if sub in k)


def tool_run(what: str, fn, *args, **kw) -> dict:
    """A chaos run whose report must list no failure: the tool raises
    AssertionError with its report on any."""
    try:
        report = fn(*args, **kw)
    except AssertionError as exc:
        raise SmokeFailure(f"[tools] {what}: {str(exc)[:3000]}") from exc
    check(report["failures"] == [], f"[tools] {what}: {report['failures']}")
    return report


def phase_tools(torch) -> dict:
    """Phase 21: see the module docstring."""
    import shutil
    import tempfile

    from distlearn_tpu_torch.examples import lm as lm_example
    from distlearn_tpu_torch.obs import trace as obs_trace
    from distlearn_tpu_torch.ops import flash_attention as fa
    from distlearn_tpu_torch.ops import fused_update as fu
    from distlearn_tpu_torch.ops import wire_kernels as wk
    from distlearn_tpu_torch.tools import (analyze_trace, chaos, diststat,
                                           ea_convergence, profile_resnet,
                                           tracecat)
    from distlearn_tpu_torch.utils import logging as port_logging

    import numpy as np

    t0 = time.perf_counter()
    cuda = TOOLS_DEVICE == "cuda"
    device = torch.device(TOOLS_DEVICE)
    out = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    trails = {k: os.path.join(out, f"{k}.jsonl") for k in (
        "parity_boundary", "parity_mid_flight", "churn", "zipf_mix",
        "replica_kill", "flash_crowd")}
    shapes = tuple((f"leaf{i:02d}", s) for i, s in enumerate(convnet_shapes()))
    n_params = sum(math.prod(s) for _, s in shapes)
    port_logging.set_verbose(False)
    env = os.environ.get("DISTLEARN_TPU_ATTN")
    os.environ["DISTLEARN_TPU_ATTN"] = "flash"
    launches = {}
    try:
        # (a) AsyncEA chaos on the convnet's leaves
        ta = time.perf_counter()
        for mode, mid in (("boundary", False), ("mid_flight", True)):
            rep = tool_run(
                f"(a) parity {mode}", chaos.run_parity,
                rounds=TOOLS_ROUNDS, kills=TOOLS_KILLS, shards=TOOLS_SHARDS,
                mid_flight=mid, shapes=shapes, device=device,
                trail=trails[f"parity_{mode}"])
            check(rep["promotions"] == len(TOOLS_KILLS),
                  f"[tools] (a) parity {mode}: {rep['promotions']} "
                  "promotions")
            log(f"[tools] (a) parity, {mode} kill at round "
                f"{TOOLS_KILLS[0]} of {TOOLS_ROUNDS}, S = {TOOLS_SHARDS}, "
                f"the convnet's {len(shapes)} leaves ({n_params:,} params) "
                f"on {device}: promoted center and client params bit for "
                f"bit the unkilled S = 1 run's; promotions "
                f"{rep['promotions']}, re-dials {rep['redials']}, replays "
                f"{rep['replays']}, checkpoints {rep['ckpt_saves']}")
        reset_wire_counts(wk)
        box = {}
        counts = profiled_counts(torch, lambda: box.setdefault(
            "churn", tool_run(
                "(a) churn", chaos.run_churn, rounds=TOOLS_ROUNDS,
                num_clients=TOOLS_CHURN_CLIENTS, shards=TOOLS_SHARDS,
                server_kills=TOOLS_CHURN_KILLS, shapes=shapes,
                device=device, trail=trails["churn"])))
        rep = box["churn"]
        amax, quant = b3_launches(wk)
        b4 = b4_launches(wk)
        codec = diststat.summarize_run([trails["churn"]])["codec"]
        stripes = codec.get("stripes", {})
        encodes = sum(r["encodes"] for r in stripes.values())
        applies = sum(r["applies"] for r in stripes.values())
        # the trail's spans by codec: the int8 client's encodes (B3 each)
        # and the weight-1 int8 applies (B4 each); the codec table counts
        # every lossy encode and weight-1 lossy apply, as JAX's does
        wire = {}
        for r in trail_spans(trails["churn"]):
            lb = r.get("labels") or {}
            if r["name"] in ("async_ea.encode", "async_ea.apply") \
                    and "err" not in r and lb.get("path", "fused") == "fused":
                key = (r["name"].split(".")[1], lb.get("codec"))
                wire[key] = wire.get(key, 0) + 1
        int8_enc, int8_app = wire.get(("encode", "int8"), 0), wire.get(
            ("apply", "int8"), 0)
        lossy = {op: sum(n for (o, c), n in wire.items()
                         if o == op and c != "raw")
                 for op in ("encode", "apply")}
        log(f"[tools] (a) churn: {TOOLS_CHURN_CLIENTS} clients (raw, int8, "
            f"fp16), {TOOLS_ROUNDS} rounds, S = {TOOLS_SHARDS}, "
            f"{rep['server_kills']} center kill: promotions "
            f"{rep['promotions']}, evictions {rep['evictions']}, rejoins "
            f"{rep['rejoins']}; B3 {amax} amax + {quant} quantize, B4 {b4} "
            f"launches; the trail's spans: {int8_enc} int8 encodes, "
            f"{int8_app} weight-1 int8 applies; diststat's codec table: "
            f"{encodes} lossy encodes, {applies} fused lossy applies over "
            f"stripes {sorted(stripes)} (spans {lossy}); "
            f"profile names: amax_leaves {names_with(counts, 'amax_leaves')}"
            f", quant_ef_leaves {names_with(counts, 'quant_ef_leaves')}, "
            f"dequant_add_leaves {names_with(counts, 'dequant_add')}")
        check(rep["promotions"] == TOOLS_CHURN_KILLS,
              f"[tools] (a) churn: {rep['promotions']} promotions")
        check(quant > 0 and b4 > 0 or not cuda,
              "[tools] (a) B3 or B4 never launched in the churn")
        check(amax == quant == int8_enc or not cuda,
              f"[tools] (a) B3 launched {amax} amax / {quant} quantize, "
              f"the trail holds {int8_enc} int8 encodes")
        check(b4 == int8_app or not cuda,
              f"[tools] (a) B4 launched {b4} times, the trail holds "
              f"{int8_app} weight-1 int8 applies")
        check((encodes, applies) == (lossy["encode"], lossy["apply"]),
              f"[tools] (a) the codec table reads {encodes} encodes and "
              f"{applies} applies, the trail's lossy spans {lossy}")
        check((names_with(counts, "amax_leaves") == amax
               and names_with(counts, "quant_ef_leaves") == quant
               and names_with(counts, "dequant_add") == b4) or not cuda,
              f"[tools] (a) the churn's profile names B3/B4 other than "
              f"their launches: {counts}")
        launches.update(quantize_ef=quant, amax=amax, dequant_add=b4)
        log(f"[tools] (a) took {time.perf_counter() - ta:.1f} s")

        # (b) serving chaos with phase 10's LM at full width, float32
        tb = time.perf_counter()
        opt, params, heads = fleet_model(lm_example, LM_FLAGS, device)
        lm = dict(vocab=opt.vocab, dim=opt.dim, depth=opt.depth,
                  heads=heads, max_len=opt.seqLen)
        obs_trace.set_propagate(True)
        fa.flash_attention.launches = 0
        try:
            serving = {}
            for name, sizes in (
                    ("zipf_mix", dict(prefix_len=TOOLS_PREFIX)),
                    ("replica_kill", dict(prompt_lens=TOOLS_PROMPTS)),
                    ("flash_crowd", {})):
                ts = time.perf_counter()
                serving[name] = tool_run(
                    f"(b) {name}", chaos.run_scenario, name,
                    rounds=TOOLS_ROUNDS, device=device, trail=trails[name],
                    lm=lm, params=params, prefill_chunk=TOOLS_CHUNK,
                    **sizes)
                serving[name]["seconds"] = time.perf_counter() - ts
        finally:
            obs_trace.set_propagate(None)
        b5a = fa.flash_attention.launches
        prefills = [r for name in serving for r in trail_spans(trails[name])
                    if r.get("name") == "serve.prefill"
                    and int((r.get("labels") or {}).get("bucket", 0)) >= 128]
        z, k, f = (serving[n] for n in ("zipf_mix", "replica_kill",
                                        "flash_crowd"))
        log(f"[tools] (b) zipf_mix ({TOOLS_PREFIX}-token shared prefixes): "
            f"{z['completed']}/{z['requests']} complete, prefix-cache hits "
            f"{z['prefix_cache_hits']}, cached streams "
            f"{z['cached_streams']}, TTFT p95 bucket {z['ttft_p95']} s, "
            f"{z['seconds']:.1f} s; replica_kill (prompts "
            f"{TOOLS_PROMPTS[0]}-{TOOLS_PROMPTS[1] - 1}): "
            f"{k['completed']} complete, {k['failed_mid_stream']} failed "
            f"mid-stream, {k['retries']} resubmitted, "
            f"{k['seconds']:.1f} s; flash_crowd (JAX's 3-8-token prompts): "
            f"{f['completed']} complete, peak {f['peak_size']} replicas, "
            f"scale ups {f['scale_ups']} / downs {f['scale_downs']}, "
            f"breaches {f['breaches']} / recoveries {f['recoveries']}, "
            f"{f['seconds']:.1f} s")
        log(f"[tools] (b) B5a {b5a} launches, {len(prefills)} full-prompt "
            f"prefills of bucket >= 128 in the trails (x {opt.depth} "
            "layers)")
        check(b5a == opt.depth * len(prefills) or not cuda,
              f"[tools] (b) B5a launched {b5a} times, the trails hold "
              f"{len(prefills)} full prefills of bucket >= 128 "
              f"({opt.depth} layers each)")
        check(len(prefills) > 0, "[tools] (b) no full prefill of bucket "
              ">= 128 ran: B5a was never on the path")
        if cuda:
            # in a fresh process: late in this one torch.profiler drops
            # chunks of 45-84 kernel records from a window that the runtime
            # saw launched, after any pause (PERF.md section 7)
            prof = run_workers(prefill_profile_worker, 1, (), 300,
                               "(b) profiled prefill process")[0]
            routes = flash_routes(prof["counts"])
            named = names_with(prof["counts"], "flash_fwd")
            log(f"[tools] (b) one profiled {prof['plen']}-token prefill "
                f"(after one unprofiled, in a fresh process, "
                f"{prof['seconds']:.1f} s) names B5a {named} times for "
                f"{prof['window']} launches, routes {routes}")
            check(prof["window"] == named == opt.depth
                  and routes == {"B5a": {"tf32x3"}},
                  f"[tools] (b) the profiled prefill launched "
                  f"{prof['window']} B5a kernels and its profile named "
                  f"{named}, routes {routes} (expected {opt.depth} float32 "
                  "3xTF32 flash_fwd_tf32x3)")
        launches["flash_attention"] = b5a
        log(f"[tools] (b) took {time.perf_counter() - tb:.1f} s")

        # (c) the trails: the fleet view and one stitched trace a request
        paths = list(trails.values())
        doc = diststat.merge_runs(paths)
        tables = {n: diststat.summarize_run([trails[src]])[n]
                  for n, src in (("codec", "churn"), ("failover", "churn"),
                                 ("serving", "zipf_mix"),
                                 ("router", "replica_kill"))}
        check(doc["counters"] and doc["histograms"] and doc["spans"]
              and all(tables.values()),
              f"[tools] (c) an empty fleet table: merge counters "
              f"{len(doc['counters'])}, histograms "
              f"{len(doc['histograms'])}, spans {len(doc['spans'])}; "
              f"{[n for n, t in tables.items() if not t]}")
        stitched = {}
        for name in serving:
            traces = tracecat.group_traces(
                tracecat.load_spans([trails[name]]))
            roots = sum(1 for r in trail_spans(trails[name])
                        if r.get("name") == "router.generate")
            bad = []
            for tid, recs in traces.items():
                top, _ = tracecat.build_tree(recs)
                if ([r["name"] for r in top] != ["router.generate"]
                        or not any(r["name"].startswith("serve.")
                                   for r in recs)):
                    bad.append(tid)
            stitched[name] = (len(traces), roots)
            check(not bad and len(traces) == roots,
                  f"[tools] (c) {name}: {len(traces)} traces for {roots} "
                  f"routed requests, {len(bad)} not one router-to-replica "
                  "trace")
        merge_text = io_text(diststat.main, ["merge", *paths])
        log(f"[tools] (c) diststat merge over {len(paths)} trails: "
            f"{len(doc['counters'])} counters, {len(doc['histograms'])} "
            f"histograms, {len(doc['spans'])} span names "
            f"({len(merge_text.splitlines())} lines of text); one "
            "stitched router-to-replica trace a request: "
            + ", ".join(f"{n} {t}" for n, (t, _) in stitched.items()))

        # (d) ea_convergence: SGD and EA over the host tree on the card
        td = time.perf_counter()
        curves = {}
        for algo, kw in (("sgd", {}), ("ea", {"tau": TOOLS_EA_TAU,
                                              "alpha": TOOLS_EA_ALPHA})):
            fu.fused_elastic.launches = 0
            res = ea_convergence.run_algo(
                algo, TOOLS_EA_RANKS, TOOLS_EA_BUDGET_S, free_port(),
                TOOLS_EA_LINK, device=device, **kw)
            curves[algo] = (res, fu.fused_elastic.launches)
        (ea_res, b2) = curves["ea"]
        rounds = sum(r[2] for r in ea_res)
        curve = ea_res[0][0]
        log(f"[tools] (d) ea_convergence, {TOOLS_EA_RANKS} ranks, "
            f"{TOOLS_EA_BUDGET_S:.0f} s each at {TOOLS_EA_LINK / 1e6:.0f} "
            f"MB/s links: sgd {max(len(c) for c, _, _ in curves['sgd'][0])}"
            f" curve points, final loss "
            f"{np.mean([f for _, f, _ in curves['sgd'][0]]):.4f}; ea tau "
            f"{TOOLS_EA_TAU} loss {curve[0][1]:.4f} -> {curve[-1][1]:.4f}, "
            f"final {np.mean([f for _, f, _ in ea_res]):.4f}, {rounds} "
            f"elastic rounds over the ranks, B2 {b2} launches; "
            f"{time.perf_counter() - td:.1f} s")
        check(len(curve) >= 2 and curve[-1][1] < curve[0][1],
              f"[tools] (d) the EA curve did not descend: {curve[:3]} ... "
              f"{curve[-3:]}")
        check(all(math.isfinite(f) for _, f, _ in ea_res + curves["sgd"][0]),
              "[tools] (d) a non-finite final loss")
        check(rounds > 0 and (b2 == rounds or not cuda),
              f"[tools] (d) B2 launched {b2} times in {rounds} elastic "
              "rounds (one a rank a round)")
        launches["fused_elastic"] = b2

        # (e) profile_resnet and analyze_trace
        te = time.perf_counter()
        prof_dir = os.path.join(out, "prof_resnet")
        # 8 buckets a step: B1 launches 8 times in each warm-up step and
        # each traced one, and the trace names the traced steps' launches
        want_b1 = (8 * (profile_resnet.WARMUP + TOOLS_RESNET_STEPS),
                   8 * TOOLS_RESNET_STEPS)
        fu.fused_sgd.launches = 0
        text = io_text(profile_resnet.main, [
            prof_dir, "--batch", str(TOOLS_RESNET_BATCH), "--steps",
            str(TOOLS_RESNET_STEPS), "--device", TOOLS_DEVICE])
        b1 = fu.fused_sgd.launches
        kernels = analyze_trace.load_kernels(
            analyze_trace.find_trace(prof_dir))
        check(bool(kernels) or not cuda,
              "[tools] (e) the trace holds no device kernel")
        att = analyze_trace.attribute(kernels) if kernels else {
            "classes": {}, "total_us": 0.0, "launches": 0}
        named_b1 = att["classes"].get("B1 fused_sgd", {}).get("launches", 0)
        log(f"[tools] (e) {text.strip().splitlines()[-1]}")
        log(f"[tools] (e) analyze_trace: {att['total_us'] / 1e3:.1f} ms of "
            f"kernels in {att['launches']} launches over "
            f"{TOOLS_RESNET_STEPS} steps; "
            + "; ".join(f"{c} {r['share']:.1%} ({r['launches']})"
                        for c, r in att["classes"].items())
            + f"; beside phase 17's bfloat16 step (PERF.md section 5):"
            f" busy {PHASE17_BF16['busy_ms']} ms a step, elementwise "
            f"{PHASE17_BF16['elementwise']:.1%}")
        check((b1, named_b1) == want_b1 or not cuda,
              f"[tools] (e) B1 launched {b1} times in "
              f"{profile_resnet.WARMUP} warm-up and {TOOLS_RESNET_STEPS} "
              f"traced steps and the trace names it {named_b1} times, "
              f"expected {want_b1} (8 buckets a step)")
        launches["fused_sgd"] = b1
        log(f"[tools] (e) took {time.perf_counter() - te:.1f} s")
    finally:
        if env is None:
            os.environ.pop("DISTLEARN_TPU_ATTN", None)
        else:
            os.environ["DISTLEARN_TPU_ATTN"] = env
        port_logging.set_verbose(True)
        shutil.rmtree(out, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"[tools] phase 21 took {wall:.1f} s (budget {TOOLS_BUDGET_S} s)")
    check(wall <= TOOLS_BUDGET_S, f"phase 21 took {wall:.1f} s, over its "
          f"{TOOLS_BUDGET_S}-s budget")
    return {"launches": launches, "seconds": wall}


def prefill_profile_worker(rank: int, q) -> None:
    """Phase 21(b)'s profiled prefill, in a fresh process on the card:
    phase 10's LM from its seeded init, one full prefill outside the
    window, then one in ``profiled_counts``.  Puts the B5a launches of
    the window and its ``{kernel name: records}``."""
    try:
        t0 = time.perf_counter()
        import numpy as np
        import torch

        from distlearn_tpu_torch.examples import lm as lm_example
        from distlearn_tpu_torch.ops import flash_attention as fa
        from distlearn_tpu_torch.serve.engine import DecodeEngine
        from distlearn_tpu_torch.utils import logging as port_logging
        port_logging.set_verbose(False)
        opt, params, _ = fleet_model(lm_example, LM_FLAGS, "cuda")
        eng = DecodeEngine(params, num_slots=1, max_len=opt.seqLen, page=8,
                           device="cuda")
        plen = min(PROFILE_PROMPT, opt.seqLen - 1)
        prompt = np.arange(1, plen + 1, dtype=np.int32) % opt.vocab
        eng.finish(eng.admit(prompt, 1)[0])
        before = fa.flash_attention.launches
        counts = profiled_counts(torch, lambda: eng.admit(prompt, 1))
        q.put(("ok", {"rank": rank, "plen": plen, "counts": counts,
                      "window": fa.flash_attention.launches - before,
                      "seconds": time.perf_counter() - t0}))
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        import traceback
        q.put(("err", traceback.format_exc()))


def trail_spans(path: str) -> list[dict]:
    """Every span record of a JSONL trail (traced or not)."""
    out = []
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("type") == "span":
                out.append(rec)
    return out


def io_text(main, argv) -> str:
    """What ``main(argv)`` printed; a non-zero return fails the run."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(not rc, f"[tools] {main.__module__} {argv[:2]} returned {rc}")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Phase 22: distlint on the port (A14)
# ---------------------------------------------------------------------------

LINT_BUDGET_S = 150           # the phase's wall time
LINT_TIMEOUT_S = 600
#: The lint's CLI device: its 8 rank processes share ``cuda:0`` over gloo.
LINT_DEVICE = "cuda"
#: The lint report's kernels, by the rows of the ``kernels`` line.
LINT_KERNEL_ROWS = {"fused_sgd": ("B1",), "fused_elastic": ("B2",),
                    "quantize_ef": ("B3_amax", "B3_quant"),
                    "dequant_add": ("B4",), "flash_attention": ("B5a",),
                    "flash_attention_dkv": ("B5b",),
                    "flash_attention_dq": ("B5c",)}


def lint_expected() -> dict:
    """``{family:unit: {kernel: launches}}`` on a unit's first rank, from
    the registry's sizes (every other unit and kernel: 0).  B3 is two
    launches a delta (amax, quantize), B4 one; the convnet's gradients are
    one bucket (B1 once a fused step, K = 3 in the scan); B2 once a round;
    the pipeline as ported (:func:`pp_launches`, S = 2, M = 2, one block a
    stage); a flash launch a layer and pass of the MoE LM (depth 2), one
    in Ulysses' head shard, one a layer in the decode engine's 128-token
    prefill (the only bucket >= 128)."""
    flash = ("B5a", "B5b", "B5c")
    exp = {"wirek:quant_ef": {"B3_amax": 1, "B3_quant": 1},
           "wirek:dequant_add": {"B4": 1},
           "wirek:wire_amax": {"B3_amax": 1},
           "sgd:sgd_step": {"B1": 1}, "sgd:sgd_scan_step": {"B1": 3},
           "ea:ea_round": {"B2": 1}, "ea:ea_cycle": {"B2": 1},
           "pp:lm_pp_step": dict(zip(flash, pp_launches("gpipe", 2, 2, 1))),
           "pp:lm_pp_1f1b_step": dict(zip(flash,
                                          pp_launches("1f1b", 2, 2, 1))),
           "ep:lm_moe_step": {k: 2 for k in flash},
           "seq:ulysses_attention": {"B5a": 1},
           "decode:decode_prefill[128]": {"B5a": 2}}
    return exp


def lint_launches(linted: dict, row: str) -> dict:
    """One ``kernels`` row's phase-22 launches: ``{unit: n}``, or for B3
    ``{"amax": {unit: n}, "quantize": {unit: n}}``."""
    keys = LINT_KERNEL_ROWS[row]
    got = [linted["launches"].get(k, {}) for k in keys]
    return got[0] if len(keys) == 1 else {"amax": got[0], "quantize": got[1]}


def phase_lint(torch) -> dict:
    """Phase 22: see the module docstring."""
    from distlearn_tpu_torch.lint import budget as budget_mod
    from distlearn_tpu_torch.lint import registry
    from distlearn_tpu_torch.lint.core import RULES

    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "distlearn_tpu_torch.tools.distlint",
           "--all", "--device", LINT_DEVICE, "--format", "json"]
    try:
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=LINT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"lint: the CLI ran past {LINT_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"lint: the CLI exited {proc.returncode}: "
          f"{proc.stderr.strip()[-2000:]} {proc.stdout[-2000:]}")
    doc = json.loads(proc.stdout)
    check(not doc["findings"] and doc["errors"] == 0,
          f"lint: findings {doc['findings'][:10]}")
    fams = registry.families()
    check(sorted(doc["costs"]) == sorted(fams) and len(fams) == 14,
          f"lint: families {sorted(doc['costs'])}")
    check(doc["rules"] == sorted(RULES), "lint: the rule list differs")
    log(f"[lint] {' '.join(cmd[1:])}: exit 0, {doc['units']} units, no "
        f"finding, {seconds:.1f} s ({len(fams)} families)")
    info = doc["info"]
    # every measured unit's peak memory within its lockfile's tolerance
    worst = (0.0, "")
    for fam, reports in sorted(doc["costs"].items()):
        budget = budget_mod.load_budget(fam) or {"units": {}}
        tol = budget.get("tolerance", budget_mod.DEFAULT_TOLERANCE)["memory"]
        for unit, rep in sorted(reports.items()):
            peak = rep["peak_bytes"]
            committed = budget["units"].get(unit, {}).get("peak_bytes")
            check(peak is not None and committed,
                  f"lint: {fam}:{unit} has no peak memory ({peak}) or no "
                  f"committed one ({committed})")
            ratio = peak / committed
            check(ratio <= 1 + tol, f"lint: {fam}:{unit} peak {peak} B "
                  f"against {committed} B committed (tolerance {tol:.0%})")
            worst = max(worst, (ratio, f"{fam}:{unit}"))
    log(f"[lint] peak memory a unit within {budget_mod.DEFAULT_TOLERANCE['memory']:.0%} "
        f"of the lockfiles; largest ratio {worst[0]:.3f} ({worst[1]})")
    # launches by the wrappers' counters and by profile names
    expected = lint_expected()
    launches: dict = {}
    for name, got in sorted(info.items()):
        if "launches" not in got:
            continue
        want = {k: expected.get(name, {}).get(k, 0) for k in got["launches"]}
        check(got["launches"] == want,
              f"lint: {name} launched {got['launches']}, expected {want}")
        check(got["named"] == got["launches"],
              f"lint: {name} profile names {got['named']} against "
              f"launches {got['launches']}")
        for k, n in got["launches"].items():
            if n:
                launches.setdefault(k, {})[name] = n
    missing = sorted(set(expected) - {n for n, g in info.items()
                                      if "launches" in g})
    check(not missing, f"lint: no launch record for {missing}")
    log(f"[lint] launches on each unit's first rank, by count and by "
        f"profile names: {launches}")
    # the tp engine: the follower replayed exactly the leader's calls
    tp = info.get("decode:tp_follow", {}).get("calls_by_rank", {})
    check(len(tp) == 2 and len(set(tp.values())) == 1,
          f"lint: decode leader and follower records {tp}")
    log(f"[lint] decode tp=2: leader and follower each {list(tp.values())[0]} "
        "recorded calls, equal (DL002 quiet)")
    check(seconds <= LINT_BUDGET_S,
          f"lint: phase 22 took {seconds:.1f} s (budget {LINT_BUDGET_S} s)")
    return {"seconds": seconds, "launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import distlearn_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: FAIL: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.abspath(
            distlearn_tpu_torch.__file__))) != HERE:
        print("chip_smoke: FAIL: distlearn_tpu_torch was imported from "
              f"{distlearn_tpu_torch.__file__}, not from {HERE}",
              file=sys.stderr)
        return 1
    import torch.distributed as dist
    from distlearn_tpu_torch.parallel.mesh import MeshTree, init_mesh

    t_start = time.perf_counter()
    try:
        card, smi_line = phase_device(torch)
        phase_build()
        kernel_rows = phase_kernels(torch, card)
        kernel_rows.update(phase_wire_kernels(torch, card))
        tree = init_mesh(0, 1, init_method=f"tcp://localhost:{free_port()}",
                         device="cuda")
        try:
            cpu_tree = MeshTree(device="cpu",
                                group=dist.new_group(backend="gloo"))
            sgd = phase_sgd(torch, tree, cpu_tree)
            ea = phase_ea(torch, tree)
            graph_sgd = phase_graph_sgd(torch, tree)
            graph_ea = phase_graph_ea(torch, tree)
        finally:
            dist.destroy_process_group()
        phase_async_trajectory(torch)
        async_run = phase_async_train(torch)
        t8a = time.perf_counter()
        phase_async_concurrent(torch, card)
        log(f"[async8a] phase 8a took {time.perf_counter() - t8a:.1f} s")
        kernel_rows["flash_attention"] = phase_flash(torch, card)
        served = phase_serve_lm(torch)
        bwd_rows = phase_flash_backward(torch, card)
        tree = init_mesh(0, 1, init_method=f"tcp://localhost:{free_port()}",
                         device="cuda")
        try:
            trained = phase_train_lm(torch, tree)
        finally:
            dist.destroy_process_group()
        phase_examples(torch)
        phase_entry(torch)
        host = phase_host(torch)
        t16 = time.perf_counter()
        backends = phase_backends(torch)
        log(f"[backends] phase 16 took {time.perf_counter() - t16:.1f} s")
        t17 = time.perf_counter()
        tree = init_mesh(0, 1, init_method=f"tcp://localhost:{free_port()}",
                         device="cuda")
        try:
            cpu_tree = MeshTree(device="cpu",
                                group=dist.new_group(backend="gloo"))
            resnet = phase_resnet(torch, tree, cpu_tree)
        finally:
            dist.destroy_process_group()
        log(f"[resnet] phase 17 took {time.perf_counter() - t17:.1f} s")
        meshed = phase_mesh_lm(torch)
        piped = phase_pp_lm(torch)
        fleet = phase_fleet(torch)
        tools = phase_tools(torch)
        linted = phase_lint(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    src = "distlearn_tpu_torch/ops/csrc/fused_update.cu"
    wire_src = "distlearn_tpu_torch/ops/csrc/wire_kernels.cu"
    kernels = [
        {"name": "fused_sgd", "route": "cuda", "source": src,
         "replaces": "distlearn_tpu/ops/fused_update.py:71",
         "launches": sgd["launches"], **kernel_rows["fused_sgd"],
         "mesh_lm_launches": {"tp": meshed["b1"]},
         "tools_launches": tools["launches"]["fused_sgd"],
         "lint_launches": lint_launches(linted, "fused_sgd")},
        {"name": "fused_elastic", "route": "cuda", "source": src,
         "replaces": "distlearn_tpu/ops/fused_update.py:96",
         "launches": ea["launches"], **kernel_rows["fused_elastic"],
         "tools_launches": tools["launches"]["fused_elastic"],
         "lint_launches": lint_launches(linted, "fused_elastic")},
        {"name": "quantize_ef", "route": "cuda", "source": wire_src,
         "replaces": "distlearn_tpu/ops/wire_kernels.py:267",
         "launches": async_run["launches"]["quantize_ef"],
         **kernel_rows["quantize_ef"],
         "tools_launches": tools["launches"]["quantize_ef"],
         "lint_launches": lint_launches(linted, "quantize_ef")},
        {"name": "dequant_add", "route": "cuda", "source": wire_src,
         "replaces": "distlearn_tpu/ops/wire_kernels.py:335",
         "launches": async_run["launches"]["dequant_add"],
         **kernel_rows["dequant_add"],
         "tools_launches": tools["launches"]["dequant_add"],
         "lint_launches": lint_launches(linted, "dequant_add")},
        {"name": "flash_attention", "route": "cuda",
         "source": "distlearn_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758"
                     " via distlearn_tpu/parallel/sequence.py:420",
         "launches": served["launches"], **kernel_rows["flash_attention"],
         "float32": dict(bwd_rows["fwd"]["float32"],
                         route="cuda (3xTF32 tensor cores for P V, S on "
                               "the CUDA cores)",
                         launches=trained["float32"]["launches"][0]),
         "mesh_lm_launches": {k: v[0] for k, v in
                              meshed["launches"].items()},
         "pp_lm_launches": {k: v[0] for k, v in
                            piped["launches"].items()},
         "tp_serve_launches": fleet["tp_launches"],
         "fleet_launches": fleet["fleet_launches"],
         "tools_launches": tools["launches"]["flash_attention"],
         "lint_launches": lint_launches(linted, "flash_attention")},
        {"name": "flash_attention_dkv", "route": "cuda",
         "source": "distlearn_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"
                     " via distlearn_tpu/parallel/sequence.py:420",
         "launches": trained["launches"]["flash_attention_dkv"],
         **bwd_rows["dkv"],
         "float32": dict(bwd_rows["dkv"]["float32"],
                         route="cuda (3xTF32 tensor cores)",
                         launches=trained["float32"]["launches"][1]),
         "mesh_lm_launches": {k: v[1] for k, v in
                              meshed["launches"].items()},
         "pp_lm_launches": {k: v[1] for k, v in
                            piped["launches"].items()},
         "lint_launches": lint_launches(linted, "flash_attention_dkv")},
        {"name": "flash_attention_dq", "route": "cuda",
         "source": "distlearn_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"
                     " via distlearn_tpu/parallel/sequence.py:420",
         "launches": trained["launches"]["flash_attention_dq"],
         **bwd_rows["dq"],
         "float32": dict(bwd_rows["dq"]["float32"],
                         route="cuda (3xTF32 tensor cores)",
                         launches=trained["float32"]["launches"][2]),
         "mesh_lm_launches": {k: v[2] for k, v in
                              meshed["launches"].items()},
         "pp_lm_launches": {k: v[2] for k, v in
                            piped["launches"].items()},
         "lint_launches": lint_launches(linted, "flash_attention_dq")},
    ]
    log(f"[report] total {time.perf_counter() - t_start:.1f} s; "
        f"sgd {sgd['steps_per_s']:.2f} steps/s at batch {SGD_BATCH}; graph "
        f"sgd (K={GRAPH_K}) {graph_sgd['graph']:.2f} against eager "
        f"{graph_sgd['eager']:.2f} steps/s in one call, replay idle "
        f"{graph_sgd['idle']:.1%}, EA replay idle {graph_ea['idle']:.1%}; "
        f"AsyncEA {async_run['syncs_per_s']:.2f} syncs/s; served LM TTFT p50 "
        f"{served['ttft_ms']:.2f} ms, TPOT p50 {served['tpot_ms']:.2f} ms, "
        f"{served['tokens_per_s']:.1f} tokens/s; LM training "
        f"{trained['modes']['none']['steps_per_s']:.2f} steps/s, MFU "
        f"{trained['modes']['none']['mfu']:.3f}, float32 "
        f"{trained['float32']['step_ms']:.2f} ms a step (B5c + B5b "
        f"{trained['float32']['pair_ms']:.2f} ms, B5a "
        f"{trained['float32']['b5a_ms']:.2f} ms); host tree sync stage / "
        f"round / return {host['tree']['stage_ms']:.3f} / "
        f"{host['tree']['round_ms']:.3f} / {host['tree']['return_ms']:.3f} "
        f"ms, ring {host['ring']['stage_ms']:.3f} / "
        f"{host['ring']['round_ms']:.3f} / {host['ring']['return_ms']:.3f} "
        f"ms; hybrid tree stage / round / return "
        f"{backends['hybrid']['tree']['stage_ms']:.3f} / "
        f"{backends['hybrid']['tree']['round_ms']:.3f} / "
        f"{backends['hybrid']['tree']['return_ms']:.3f} ms; slice client "
        f"(amax, quantize, dequant_add) launches "
        f"{backends['slice_launches']}; ResNet-50 float32 "
        f"{resnet['float32']['images_per_s']:.1f} images/s (MFU "
        f"{resnet['float32']['mfu']:.3f}, peak "
        f"{resnet['float32']['peak_gb']:.2f} GB), bfloat16 "
        f"{resnet['bfloat16']['images_per_s']:.1f} images/s (MFU "
        f"{resnet['bfloat16']['mfu']:.3f}, peak "
        f"{resnet['bfloat16']['peak_gb']:.2f} GB), B1 "
        f"{resnet['float32']['launches']} launches in {RESNET_STEPS} steps, "
        f"largest bucket {resnet['b1']['ms']:.5f} ms against bound "
        f"{resnet['b1']['bound_ms']:.5f} ms; mesh LM phase "
        f"{meshed['seconds']:.1f} s; pp and optimizer LM phase "
        f"{piped['seconds']:.1f} s; fleet phase {fleet['seconds']:.1f} s; "
        f"tools phase {tools['seconds']:.1f} s; lint phase "
        f"{linted['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
