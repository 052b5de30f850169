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
6. report  — a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
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
        tree = init_mesh(0, 1, init_method=f"tcp://localhost:{free_port()}",
                         device="cuda")
        try:
            cpu_tree = MeshTree(device="cpu",
                                group=dist.new_group(backend="gloo"))
            sgd = phase_sgd(torch, tree, cpu_tree)
            ea = phase_ea(torch, tree)
        finally:
            dist.destroy_process_group()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1

    src = "distlearn_tpu_torch/ops/csrc/fused_update.cu"
    kernels = [
        {"name": "fused_sgd", "route": "cuda", "source": src,
         "replaces": "distlearn_tpu/ops/fused_update.py:71",
         "launches": sgd["launches"], **kernel_rows["fused_sgd"]},
        {"name": "fused_elastic", "route": "cuda", "source": src,
         "replaces": "distlearn_tpu/ops/fused_update.py:96",
         "launches": ea["launches"], **kernel_rows["fused_elastic"]},
    ]
    log(f"[report] total {time.perf_counter() - t_start:.1f} s; "
        f"sgd {sgd['steps_per_s']:.2f} steps/s at batch {SGD_BATCH}")
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
