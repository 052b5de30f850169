#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distlearn_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device  — require CUDA; print the card's name and power limit
   (nvidia-smi); float32 everywhere (TF32 off for convolutions and matmuls,
   cuDNN deterministic) for parity and timing alike.
2. build   — compile every CUDA source of the port (one nvcc each, started
   together) into the git-ignored build directory.
3. kernels — each kernel against its plain PyTorch version, bit for bit, at
   the full-width CIFAR-10 bucket and at a ragged length; median times over
   CUDA events (L2 flushed before each launch) beside the plain version, the
   one PyTorch call computing the same function where there is one, and the
   bound (bytes over the card's HBM rate, operations over its FP32 rate).
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
   bit, at the convnet's 18 leaf sizes and at a ragged, unaligned length,
   one kernel launch per wrapper call; non-finite input raises, a zero
   leaf launches no quantize; times over
   the whole 18-leaf delta and the largest leaf (conv4) beside the plain
   versions, ``torch.add(c, q, alpha=s)`` and the bound.
7. async trajectory — a serial AsyncEA server and one client with their
   tensors on the card, at the convnet's 18 leaves, 20 int8 and 5 raw
   rounds with a seeded drift: center and client params bit for bit the
   same run on the port's CPU route (B3, B4, the copies and the transport
   together).
8. async train — the AsyncEA path: the example's roles as threads on the
   card (a serial server, 2 clients, a tester), the full-width CIFAR-10
   convnet, batch 128 per client, tau 4, alpha 0.2, int8, 8 syncs per
   client; 16 syncs applied, 5 tester pushes, finite losses, and the B3/B4
   launch counts the design implies.  Prints where a sync's time goes.
9. report  — a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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

# AsyncEA phases: 2 clients of batch 128 (global 256, as in the SGD phase)
ASYNC_CLIENTS, ASYNC_BATCH, ASYNC_TAU, ASYNC_ALPHA = 2, 128, 4, 0.2
ASYNC_SYNCS_PER_CLIENT, ASYNC_TEST_TIME = 8, 4
TRAJ_ROUNDS = (("int8", 20), ("raw", 5))
CONVNET_LEAVES, CONVNET_PARAMS, CONV4 = 18, 4_328_970, 3_276_800
RAGGED_LEAF = CONV4 - 1021               # not a multiple of 4
ROLE_TIMEOUT_S = 300

# Card rates for the bound (NVIDIA's H100 and H200 SXM data sheets): HBM
# bytes/s by part, FP32 (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = {"H200": 4.8e12, "H100": 3.35e12}
FP32_FLOPS = 67e12


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


def max_abs(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_kernels(torch, card):
    from distlearn_tpu_torch.ops import fused_update as fu
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda n: torch.randn(n, generator=gen, device=dev)
    lr, alpha = 0.1, EA_ALPHA
    errs = {"fused_sgd": 0.0, "fused_elastic": 0.0}
    for n in (CIFAR_BUCKET, RAGGED):
        p, g, c = rand(n + 1), rand(n + 1), rand(n + 1)
        # the aligned buckets, and views one element in (no 16-byte
        # alignment: the kernels' scalar path)
        for pv, gv, cv in ((p[:n], g[:n], c[:n]), (p[1:], g[1:], c[1:])):
            out, ref = fu.fused_sgd(pv, gv, lr), fu.sgd_plain(pv, gv, lr)
            torch.cuda.synchronize()
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
    log(f"[kernels] bitwise equal to the plain versions at n={CIFAR_BUCKET} "
        f"and n={RAGGED}, aligned and unaligned")

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
        log(f"[kernels] {name} n={n}: {row['ms']:.4f} ms | plain "
            f"{row['plain_ms']:.4f} ms | library ({note}) "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms"
            f" | bound {row['bound_ms']:.4f} ms ({bytes_moved / 1e6:.1f} MB at "
            f"{rate / 1e12:.2f} TB/s, {part}) | {bytes_moved / row['ms'] / 1e6:.0f} "
            f"GB/s achieved, {row['bound_ms'] / row['ms']:.1%} of bound")
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
    ("fused update", ("sgd_vec4", "sgd_scalar", "elastic_vec4",
                      "elastic_scalar")),
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


def phase_wire_kernels(torch, card):
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
    log(f"[wire] B3 (amax + quantize_ef) and B4 (dequant_add) bitwise equal "
        f"to their plain versions at the {len(sizes)} convnet leaf sizes and "
        f"n={RAGGED_LEAF}, aligned and unaligned, one kernel launch per call;"
        f" torch.add(c, q, alpha=s) "
        f"{'is' if lib_equal else 'is NOT'} bitwise equal to B4")

    x = torch.ones(CONV4, device=dev)
    for bad in (float("nan"), float("inf"), float("-inf")):
        x[-1] = bad
        try:
            wk.quantize_ef_cuda(x)
        except ValueError:
            continue
        raise SmokeFailure(f"quantize_ef_cuda accepted a {bad} at the last "
                           f"element of a {CONV4}-element leaf")
    before = wk.quantize_ef_cuda.launches
    q, s, r = wk.quantize_ef_cuda(torch.zeros(CONV4, device=dev))
    torch.cuda.synchronize()
    check(s == 0.0 and wk.quantize_ef_cuda.launches == before
          and not q.any() and not r.any(),
          "a zero leaf launched the quantize kernel or carried a value")
    log("[wire] nan, +inf and -inf at the last element raise ValueError; a "
        "zero leaf takes no quantize launch")

    # times: the whole 18-leaf delta (what a sync encodes and applies) and
    # the conv4 leaf alone
    rate, part = hbm_rate(card)
    leaves = [torch.randn(sh, generator=gen, device=dev) * 0.01
              for sh in shapes]
    centers = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    qs = [torch.empty(sh, dtype=torch.int8, device=dev) for sh in shapes]
    rs = [torch.empty(sh, device=dev) for sh in shapes]
    scales = [wk.quantize_ef_cuda(d, q=q, r=r)[1]
              for d, q, r in zip(leaves, qs, rs)]
    big = sizes.index(CONV4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def b3(idx):
        amaxes = wk.amax_cuda([leaves[i] for i in idx])
        for i, a in zip(idx, amaxes):
            wk.quantize_ef_cuda(leaves[i], a, q=qs[i], r=rs[i])

    def b3_plain(idx):
        for i in idx:
            wk.quantize_ef_plain(leaves[i])

    def b4(idx):
        for i in idx:
            wk.dequant_add_cuda(centers[i], qs[i], scales[i], out=centers[i])

    def b4_plain(idx):
        for i in idx:
            wk.dequant_add_plain(centers[i], qs[i], scales[i])

    def b4_lib(idx):
        for i in idx:
            torch.add(centers[i], qs[i], alpha=scales[i])

    rows = {}
    for name, per_elem_bytes, per_elem_ops, kern, plain, library, note in (
            # B3 reads d and writes q and r: 9 bytes (this design reads d
            # twice, amax then quantize, which the bound does not count)
            ("quantize_ef", 9, 6, b3, b3_plain, None,
             "none: no PyTorch call quantizes with error feedback"),
            ("dequant_add", 9, 2, b4, b4_plain, b4_lib,
             "torch.add(c, q, alpha=s)")):
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
                else f"{row['library_ms']:.4f}"
            log(f"[wire] {name} {label} (n={n}, {len(idx)} leaves): "
                f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
                f"library ({note}) {lib_txt} ms | bound {row['bound_ms']:.4f}"
                f" ms ({per_elem_bytes * n / 1e6:.1f} MB at "
                f"{rate / 1e12:.2f} TB/s, {part}) | {row['bound_ms'] / row['ms']:.1%}"
                " of bound")
            if label == "whole delta":
                rows[name] = row
                log(f"[wire] {name} whole delta: kernels busy "
                    f"{device_ms(torch, lambda: kern(idx)):.4f} ms per call "
                    "(torch.profiler, device time of this file's kernels "
                    "only); the rest of the call is host time between "
                    "launches")
    del flush
    return rows


WIRE_KERNEL_NAMES = ("amax_abs", "quant_ef", "dequant_add")


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
    wk.amax_cuda.launches = 0
    wk.quantize_ef_cuda.launches = 0
    wk.dequant_add_cuda.launches = 0


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
        launches = (wk.amax_cuda.launches, wk.quantize_ef_cuda.launches,
                    wk.dequant_add_cuda.launches)
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
            check(min(launches) > 0, f"int8 rounds on the card launched "
                  f"(amax, quantize, dequant_add) = {launches}")
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
    from distlearn_tpu_torch.parallel import async_ea

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

    # count the int8 leaves the server receives with a zero scale: the
    # design launches no quantize for those
    zero_scales = [0]
    apply = async_ea.AsyncEAServer._apply_delta

    def counting_apply(self, payload):
        zero_scales[0] += sum(e.get("scale") == 0.0
                              for e in payload.manifest["leaves"])
        return apply(self, payload)

    async_ea.AsyncEAServer._apply_delta = counting_apply
    obs_trace.clear()
    torch.cuda.synchronize()
    reset_wire_counts(wk)
    reset_counts(fu)
    t0 = time.perf_counter()
    try:
        run_threads(role("server", "server", ["--tester"]),
                    *[role(f"client{i}", "client", ["--nodeIndex", str(i)])
                      for i in range(1, ASYNC_CLIENTS + 1)],
                    role("tester", "tester", ["--numTests", str(tests)]))
    finally:
        async_ea.AsyncEAServer._apply_delta = apply
    wall = time.perf_counter() - t0
    launches = {"amax": wk.amax_cuda.launches,
                "quantize_ef": wk.quantize_ef_cuda.launches,
                "dequant_add": wk.dequant_add_cuda.launches}

    leaf_syncs = syncs * CONVNET_LEAVES
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
    check(launches == {"amax": leaf_syncs,
                       "quantize_ef": leaf_syncs - zero_scales[0],
                       "dequant_add": leaf_syncs},
          f"launches {launches}: expected amax and dequant_add {leaf_syncs} "
          f"({syncs} syncs x {CONVNET_LEAVES} leaves), quantize_ef "
          f"{leaf_syncs} - {zero_scales[0]} zero-scale leaves")
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
        f"quantize_ef {launches['quantize_ef']} ({zero_scales[0]} zero-scale "
        f"leaves), dequant_add {launches['dequant_add']}")
    log(f"[async] local step p50 {p50(step_ms):.3f} ms; client sync p50 "
        f"{p50(sync_ms):.3f} ms = center fetch {parts['async_ea.fetch_center']:.3f}"
        f" + delta {parts['async_ea.delta']:.3f} + encode (B3 + D2H) "
        f"{parts['async_ea.encode']:.3f} (of which D2H "
        f"{parts['wire_kernels.frame_d2h']:.3f}) + push "
        f"{parts['async_ea.push_delta']:.3f} (p50 of each part)")
    log(f"[async] server: apply (H2D + B4) p50 {parts['async_ea.apply']:.3f}"
        f" ms, center D2H p50 {parts['async_ea.center_d2h']:.3f} ms, "
        f"handshake p50 {parts['async_ea.handshake']:.3f} ms; {syncs} syncs "
        f"in {wall:.2f} s wall = {syncs / wall:.2f} syncs/s (model build, "
        "init broadcast and tester evaluation included)")
    return {"launches": launches, "syncs_per_s": syncs / wall}


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
    ]
    log(f"[report] total {time.perf_counter() - t_start:.1f} s; "
        f"sgd {sgd['steps_per_s']:.2f} steps/s at batch {SGD_BATCH}; "
        f"AsyncEA {async_run['syncs_per_s']:.2f} syncs/s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
