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
   registers and spills (none allowed in the D=64 bfloat16 B5a, B5b and
   B5c) and the HMMA count of its SASS (``cuobjdump -sass``): non-zero in
   exactly the tensor-core kernels, the bfloat16 B5a, B5b and B5c.
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
   tensors on the card, at the convnet's 18 leaves, 20 int8 and 5 raw
   rounds with a seeded drift: center and client params bit for bit the
   same run on the port's CPU route (B3, B4, the copies and the transport
   together), one launch of each B3 pass and of B4 an int8 round.
8. async train — the AsyncEA path: the example's roles as threads on the
   card (a serial server, 2 clients, a tester), the full-width CIFAR-10
   convnet, batch 128 per client, tau 4, alpha 0.2, int8, 8 syncs per
   client; 16 syncs applied, 5 tester pushes, finite losses, and the B3/B4
   launch counts the design implies (one amax, one quantize and one B4
   launch a sync).  Prints where a sync's time goes.
9. flash   — kernel B5a (causal flash-attention forward) against its plain
   twin and the xla route at the serving shape (B=1, H=16, D=64) for L =
   128, 256, 1024, 2048, at B=4, H=8, D=128, L=1024 and at B=2, H=4, D=32,
   L=512, float32 and bfloat16; in bfloat16 also non-causal, L=64 and q
   multiplied by 8 (FLASH_BF16_CASES, untimed);
   median times (L2 flushed) beside the plain twin,
   ``F.scaled_dot_product_attention(is_causal=True)`` (timed as the
   library yardstick only) and the bound.
10. serve  — the served transformer LM at full width (vocab 32768, dim
   1024, depth 8, 16 heads, max_len 2048, the seeded init, float32
   params) under ``DISTLEARN_TPU_ATTN=flash``: (a) float32 compute, TF32
   off, a 1024-token prompt, the engine with the flash and the xla route
   against ``greedy_generate`` on the xla route; (b) bfloat16 compute, 4 slots, a
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
   checked the same way, untimed; a profiled float32 call names only the
   CUDA-core kernels, a bfloat16 one only the tensor-core ones.
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
   fails above 1).
13. report — a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
CONVNET_LEAVES, CONVNET_PARAMS, CONV4 = 18, 4_328_970, 3_276_800
RAGGED_LEAF = CONV4 - 1021               # not a multiple of 4
B3_SENTINEL_Q, B3_SENTINEL_R = 0x55, -7.5  # what B3 must leave unwritten
ROLE_TIMEOUT_S = 300

# Card rates for the bound (NVIDIA's H100 and H200 SXM data sheets): HBM
# bytes/s by part, FP32 (non-tensor-core) FLOP/s, dense bf16 tensor-core
# FLOP/s.
HBM_BYTES_PER_S = {"H200": 4.8e12, "H100": 3.35e12}
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

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
    """``flash_fwd_mma<bf16, 64>`` from a flash kernel's mangled name."""
    m = re.search(r"(flash_[a-z_]+?)I(f|13__nv_bfloat16)?Li(\d+)E", sym)
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
    # the bfloat16 B5a, B5b and B5c run on tensor cores, the float32 ones
    # on CUDA cores
    if "flash_attention.cu" in logs:
        info = ptxas_report(logs["flash_attention.cu"])
        log("[build] flash kernels (registers, spill stores/loads bytes): "
            + ", ".join(f"{k} {v.get('regs')} regs, spill "
                        f"{v.get('spill')}" for k, v in sorted(info.items())))
        for label in ("flash_fwd_mma<bf16, 64>",
                      "flash_bwd_dkv_mma<bf16, 64>",
                      "flash_bwd_dq_mma<bf16, 64>"):
            check(label in info and info[label].get("spill") == (0, 0),
                  f"{label}: ptxas reports spills or no entry: "
                  f"{info.get(label)}")
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
        check((n > 0) == ("_mma<" in label),
              f"{label}: {n} HMMA instructions; exactly the bfloat16 B5a, "
              "B5b and B5c kernels run on tensor cores")


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


def profile_step(torch, run):
    """Run ``run()`` once under torch.profiler and log the device's busy
    time by kernel class and the top kernels beside the wall time.  A
    profiler fault is logged and does not fail the run.  Returns what
    ``run()`` returned and the busy milliseconds (None if not profiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        log(f"[profile] torch.profiler failed: {exc!r}")
        out = run()
        torch.cuda.synchronize()
        return out, None
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class: dict[str, float] = {}
    for e in kernels:
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.key for k in keys)), "elementwise/reduce")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    log(f"[profile] one step: {wall_ms:.3f} ms wall (profiler on), kernels "
        f"busy {busy_ms:.3f} ms, device idle {1 - busy_ms / wall_ms:.1%}; "
        + ", ".join(f"{c} {t:.3f} ms" for c, t in
                    sorted(by_class.items(), key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  "
            f"x{e.count:<4d} {e.key[:100]}")
    return out, busy_ms


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
    ts, busy_ms = profile_step(torch, lambda: step(ts, x, y)[0])
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        srv = async_ea.AsyncEAServer("127.0.0.1", port, 1, device=device)
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
                                   device=device)
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
# Phase 9: kernel B5a against its plain twin and the xla route
# ---------------------------------------------------------------------------

def attn_bound(torch, nbytes, flops, dtype, rate):
    """(bound ms, bound_by): bytes over the HBM rate against operations over
    the peak for the dtype (CUDA cores for float32, tensor cores for
    bfloat16)."""
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / rate * 1e3, flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def flash_bound(torch, B, H, D, L, dtype, rate):
    """(bound ms, bound_by, bytes, flops) of B5a without residuals: q, k, v
    read once and o written once; the causal products 2*B*H*L*L*D."""
    elt = 4 if dtype == torch.float32 else 2
    nbytes = 4 * B * L * H * D * elt
    flops = 2 * B * H * L * L * D
    return (*attn_bound(torch, nbytes, flops, dtype, rate), nbytes, flops)


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
            bound, bound_by, nbytes, flops = flash_bound(torch, B, H, D, L,
                                                         dtype, rate)
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
            log(f"[flash] {name}: {row['ms']:.4f} ms | plain "
                f"{row['plain_ms']:.4f} ms | sdpa {row['library_ms']:.4f} ms"
                f" | bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB"
                f" at {rate / 1e12:.2f} TB/s ({part}), {flops / 1e9:.2f} "
                f"GFLOP) = {bound / row['ms']:.1%} of bound | max abs err "
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
    from torch.profiler import ProfilerActivity, profile

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
            slot, first = eng.admit(prompt, LM_CHECK_STEPS)
            got = [first] + [eng.tick()[slot]
                             for _ in range(LM_CHECK_STEPS - 1)]
            eng.finish(slot)
            del eng
            tie = compare_stream(torch, models[torch.float32], params,
                                 prompt, got, ref, TIE_TOL["float32"])
            how = "equal" if tie is None else (
                f"equal up to a near-tie at token {tie[0]} (gap {tie[1]:.3g},"
                f" top-2 margin {tie[2]:.3g})")
            log(f"[serve] (a) float32, engine on {impl}, greedy_generate on "
                f"xla: {how} over {LM_CHECK_STEPS} tokens of a "
                f"{LM_CHECK_PROMPT}-token prompt")

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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """Compulsory bytes and flops of B5a (with m, l), B5c (with di) and B5b
    at one causal shape: N = B*H*L*(L+1)/2 (query, key) pairs; each
    [B, L, H, D] tensor read or written once, m, l and di 4 bytes a row."""
    pairs = B * H * L * (L + 1) // 2
    t, st = B * L * H * D * elt, B * H * L * 4
    return {"fwd": (4 * t + 2 * st, 4 * D * pairs),
            "dq": (6 * t + 3 * st, 6 * D * pairs + 2 * B * H * L * D),
            "dkv": (6 * t + 3 * st, 8 * D * pairs)}


def within(torch, got, want, rtol, atol) -> tuple[bool, float]:
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    return ok, max_abs(torch, got, want)


def check_backward(torch, name, q, k, v, do, causal=True, mult=1.0):
    """B5a with residuals, B5c and B5b on one case: each against its twin
    (on the kernels' own residuals) and the xla route's autograd, the
    backward repeated bit for bit.  Returns ``(o, m, l, di)``, the max abs
    errors ``{"dq": (twin, xla, twin's own from xla), ...}`` and B5a's
    against its twin.  With q scaled by ``mult`` != 1 (FLASH_BF16_CASES)
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
    for dtype, want in ((torch.float32, {"B5a": {"core"}, "B5b": {"core"},
                                         "B5c": {"core"}}),
                        (torch.bfloat16, FLASH_BF16_ROUTES)):
        q, k, v, do = flash_inputs(torch, route_gen, *FLASH_TRAIN, dtype, 4)
        keys = profiled_keys(torch, lambda: [fa.flash_attention_bwd(
            q, k, v, *fa.flash_attention_fwd(q, k, v), do)
            for _ in range(5)])
        routes = flash_routes(keys)
        log(f"[flash-bwd] {str(dtype)[6:]} call at the training shape ran: "
            + ", ".join(f"{t} {'/'.join(sorted(r))}"
                        for t, r in sorted(routes.items())))
        check(routes == want, f"{dtype} flash call ran {routes}, expected "
              f"{want} (mma: tensor cores, core: CUDA cores); device "
              f"events {[key[:60] for key in keys]}")
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
                nbytes, flops = work[kern]
                bound, bound_by = attn_bound(torch, nbytes, flops, dtype,
                                             rate)
                ms = time_ms(torch, fn, flush)
                row = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
                       "plain_ms": time_ms(torch, plain, flush) if main
                       else None}
                rows[(B, H, D, L, dname, kern)] = row
                line.append(f"{kern} {ms:.4f} ms (bound {bound:.4f}, "
                            f"{bound_by}; {bound / ms:.1%})")
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
    for B, H, D, L, causal, mult in FLASH_BF16_CASES:
        name = case_name(B, H, D, L, torch.bfloat16, causal, mult)
        q, k, v, do = flash_inputs(torch, gen, B, H, D, L, torch.bfloat16, 4,
                                   mult)
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
        f"float32, {BF16_FLOPS / 1e12:.0f} TFLOP/s bfloat16")
    B, H, D, L = FLASH_TRAIN
    return {kern: rows[(B, H, D, L, "bfloat16", kern)]
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


def flash_routes(keys) -> dict:
    """{"B5a": {"mma"}, ...}: the flash kernels that profiler ``keys`` name,
    each with the routes seen, "mma" (``*_mma``: tensor cores) or "core"
    (CUDA cores)."""
    routes = {}
    for key in keys:
        for tag, sub in FLASH_KERNELS:
            if sub in key:
                routes.setdefault(tag, set()).add(
                    "mma" if f"{sub}_mma" in key else "core")
    return routes


def profiled_keys(torch, fn) -> list[str]:
    """Names of the device events of one profiled, synchronised ``fn()``
    (CPU and CUDA activities, as phase 12's profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def flash_counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_dkv.launches,
            fa.flash_attention_dq.launches)


def reset_flash_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention_dkv.launches = 0
    fa.flash_attention_dq.launches = 0


def phase_train_lm(torch, tree):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        p1, _ = step(params0, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    del p1
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    check(busy > 0, "torch.profiler saw no device time in the LM step")
    shares = {tag: sum(e.self_device_time_total for e in evs
                       if key in e.key) / 1e3 for tag, key in FLASH_KERNELS}
    counts = {tag: sum(e.count for e in evs if key in e.key)
              for tag, key in FLASH_KERNELS}
    routes = flash_routes(e.key for e in evs)
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
    return {"launches": {"flash_attention_dkv": launches[1],
                         "flash_attention_dq": launches[2],
                         "flash_attention_train": launches[0]},
            "modes": per_mode, "busy_ms": busy, "wall_ms": wall_ms,
            "shares": shares}


# ---------------------------------------------------------------------------

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
        finally:
            dist.destroy_process_group()
        phase_async_trajectory(torch)
        async_run = phase_async_train(torch)
        kernel_rows["flash_attention"] = phase_flash(torch, card)
        served = phase_serve_lm(torch)
        bwd_rows = phase_flash_backward(torch, card)
        tree = init_mesh(0, 1, init_method=f"tcp://localhost:{free_port()}",
                         device="cuda")
        try:
            trained = phase_train_lm(torch, tree)
        finally:
            dist.destroy_process_group()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    src = "distlearn_tpu_torch/ops/csrc/fused_update.cu"
    wire_src = "distlearn_tpu_torch/ops/csrc/wire_kernels.cu"
    kernels = [
        {"name": "fused_sgd", "route": "cuda", "source": src,
         "replaces": "distlearn_tpu/ops/fused_update.py:71",
         "launches": sgd["launches"], **kernel_rows["fused_sgd"]},
        {"name": "fused_elastic", "route": "cuda", "source": src,
         "replaces": "distlearn_tpu/ops/fused_update.py:96",
         "launches": ea["launches"], **kernel_rows["fused_elastic"]},
        {"name": "quantize_ef", "route": "cuda", "source": wire_src,
         "replaces": "distlearn_tpu/ops/wire_kernels.py:267",
         "launches": async_run["launches"]["quantize_ef"],
         **kernel_rows["quantize_ef"]},
        {"name": "dequant_add", "route": "cuda", "source": wire_src,
         "replaces": "distlearn_tpu/ops/wire_kernels.py:335",
         "launches": async_run["launches"]["dequant_add"],
         **kernel_rows["dequant_add"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "distlearn_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758"
                     " via distlearn_tpu/parallel/sequence.py:420",
         "launches": served["launches"], **kernel_rows["flash_attention"]},
        {"name": "flash_attention_dkv", "route": "cuda",
         "source": "distlearn_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"
                     " via distlearn_tpu/parallel/sequence.py:420",
         "launches": trained["launches"]["flash_attention_dkv"],
         **bwd_rows["dkv"]},
        {"name": "flash_attention_dq", "route": "cuda",
         "source": "distlearn_tpu_torch/ops/csrc/flash_attention.cu",
         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"
                     " via distlearn_tpu/parallel/sequence.py:420",
         "launches": trained["launches"]["flash_attention_dq"],
         **bwd_rows["dq"]},
    ]
    log(f"[report] total {time.perf_counter() - t_start:.1f} s; "
        f"sgd {sgd['steps_per_s']:.2f} steps/s at batch {SGD_BATCH}; "
        f"AsyncEA {async_run['syncs_per_s']:.2f} syncs/s; served LM TTFT p50 "
        f"{served['ttft_ms']:.2f} ms, TPOT p50 {served['tpot_ms']:.2f} ms, "
        f"{served['tokens_per_s']:.1f} tokens/s; LM training "
        f"{trained['modes']['none']['steps_per_s']:.2f} steps/s, MFU "
        f"{trained['modes']['none']['mfu']:.3f}")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
