"""One run of one cell: set-up, the first steps that ``correct`` compares,
warm-up, the measured window, the profiled window of a ``--trace 1`` run,
then the reference, and the result line.

:func:`run_cell` takes the device it is given; the entry point
(``run.py``) gives it the card, the tests the CPU at a small size.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from functools import partial

import torch

from portbench import check, feed, roofline, spec, stats, trace
from portbench import reference
from portbench.reference.common import (generator, make_params, sgd_steps,
                                        tf32_off, tree_map)
from portbench.system import System

#: the port's histogram of a step's host dispatch, and its label
DISPATCH = ("train_step_dispatch_seconds", {"step": "sgd"})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    cfg: dict
    mix: dict
    params: int
    flops_per_sample: float
    setup_s: float = 0.0
    steps: int = 0
    samples: int = 0
    window_s: float = 0.0
    step_ms: list = field(default_factory=list)
    data_wait_s: list = field(default_factory=list)
    dispatch: tuple = (0.0, 0)
    memory_peak_bytes: int = 0
    trace: trace.Trace | None = None


def _dispatch_totals() -> tuple[float, int]:
    """``(sum, count)`` of the port's dispatch histogram so far."""
    from distlearn_tpu_torch import obs
    name, labels = DISPATCH
    for fam in obs.REGISTRY.snapshot():
        if fam["name"] == name:
            for s in fam["samples"]:
                if s["labels"] == labels:
                    return float(s["sum"]), int(s["count"])
    return 0.0, 0


def card_lines(device) -> None:
    """The card's name, power limit and the precision flags, on stderr."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(f"[portbench] card {torch.cuda.get_device_name(device)} | "
        f"nvidia-smi: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"[portbench] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(tree: dict) -> dict:
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


class Driver:
    """The loop that feeds the system: a batch a step, the epoch-end sync
    where the mix has one, and the time spent taking each batch."""

    def __init__(self, system, batches):
        self.system, self.batches = system, batches

    def step(self, waits: list | None = None):
        """One step (after any epoch-end sync before it); returns its
        loss."""
        t = time.perf_counter()
        item = next(self.batches)
        while item is None:
            self.system.epoch_end()
            item = next(self.batches)
        if waits is not None:
            waits.append(time.perf_counter() - t)
        return self.system.train(*item)

    def close(self):
        self.batches.close()


def first_steps(driver: Driver, n: int) -> dict:
    """The first ``n`` steps, with what ``correct`` compares: each loss, the
    params after the first and the last, the state after the last (copies
    on the host)."""
    out, losses = {}, []
    for k in range(n):
        losses.append(driver.step())
        if k == 0:
            out["params1"] = _host(driver.system.params)
    out["params"] = _host(driver.system.params)
    out["state"] = _host(driver.system.state)
    out["loss"] = [float(v) for v in losses]
    return out


def reference_check(cell: spec.Cell, seed: int, device, x, y, rows: list,
                    prog: dict) -> dict:
    """The reference's first steps over the rows the program took, from the
    weights made from the seed; returns :func:`check.numbers`."""
    cfg = cell.config
    ref = reference.model(cfg)
    p0 = make_params(ref.param_specs(cfg), seed, device)
    s0 = ref.state_init(cfg, device)
    batches = [(torch.from_numpy(x[idx]).to(device),
                torch.from_numpy(y[idx]).to(device)) for idx in rows]
    out = sgd_steps(partial(ref.loss, cfg), p0, s0, batches,
                    cfg["optimizer"]["lr"], generator(seed, "dropout", device))
    return check.numbers(prog, out, p0, s0, cfg["optimizer"]["lr"])


def build(cell: spec.Cell, seed: int, device, system_cls=System):
    """``(x, y, system, driver, rows)``: the data, the system and its
    feed; the first steps' batch indices go to ``rows``."""
    cfg, mix = cell.config, cell.traffic
    x, y = feed.images(cfg, mix, seed, device)
    specs = reference.model(cfg).param_specs(cfg)
    system = system_cls(cfg, seed, device, specs)
    rows: list = []
    batches = feed.stream(mix, x, y, cfg["num_classes"], seed, device, rows,
                          mix["check_steps"])
    return x, y, system, Driver(system, batches), rows


def _window(driver: Driver, seconds: float, device, run: Run) -> list:
    """The measured window; returns the steps' losses."""
    on_card = device.type == "cuda"
    batch = run.mix["batch"]
    losses, marks = [], []
    d0 = _dispatch_totals()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        losses.append(driver.step(run.data_wait_s))
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
    _sync(device)
    run.window_s = time.perf_counter() - t0
    d1 = _dispatch_totals()
    run.dispatch = (d1[0] - d0[0], d1[1] - d0[1])
    run.steps, run.samples = len(losses), len(losses) * batch
    if on_card:
        times = [0.0] + [start.elapsed_time(ev) for ev in marks]
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    else:
        times = [0.0] + [(t - t0) * 1e3 for t in marks]
    run.step_ms = stats.gaps_ms(times)
    return losses


def _profile(driver: Driver, device, n: int) -> trace.Trace:
    from torch.profiler import record_function

    def run_steps():
        for _ in range(n):
            with record_function("portbench.step"):
                driver.step()
        _sync(device)
    return trace.profile_steps(run_steps, n, device.type == "cuda")


def read_metrics(entries: list, run: Run, pkg=spec.PKG) -> dict:
    """``{name: {"value", "unit"}}`` of every metric of ``entries`` whose
    reader (``<pkg>/metrics/<name>.py``) finds something to read."""
    out = {}
    for m in entries:
        value = spec.metric_module(m["name"], pkg).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _finite(v: float) -> float:
    """JSON has no infinity: a number past any limit stands for it."""
    return v if math.isfinite(v) else 1e300


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, wrap=None, system_cls=System) -> dict:
    """One run; returns the result line.  ``wrap(system)``, when given,
    changes the system before its first step, and ``system_cls`` stands in
    for the port's (the tests plant faults and the control with them)."""
    cfg, mix = cell.config, cell.traffic
    on_card = device.type == "cuda"
    if on_card:
        tf32_off()
        card_lines(device)
    run = Run(cfg, mix, roofline.param_count(cfg),
              roofline.train_flops_per_sample(cfg))
    x, y, system, driver, rows = build(cell, seed, device, system_cls)
    if wrap is not None:
        wrap(system)
    prog = first_steps(driver, mix["check_steps"])
    for _ in range(mix["warmup_steps"]):
        driver.step()
    if mix["epoch_sync"]:
        system.epoch_end()          # the sync's collectives, warmed up
    _sync(device)
    # the port's step leaves reference cycles that hold device memory until
    # the collector runs: every window starts from the same collector state
    gc.collect()
    run.setup_s = time.perf_counter() - t_start
    log(f"[portbench] {cell.name} seed {seed}: set-up {run.setup_s:.3f} s, "
        f"window {seconds} s")
    losses = _window(driver, seconds, device, run)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) \
        if losses else 0
    log(f"[portbench] window: {run.steps} steps ({run.samples} samples) in "
        f"{run.window_s:.4f} s; step times over {len(run.step_ms)} steps")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else "cpu", "count": cell.chips,
                   "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": False, "attempted": run.steps, "failed": failed}
    if traced:
        run.trace = _profile(driver, device, mix["profile_steps"])
        device_info["busy_s"] = trace.busy_s(run.trace)
        device_info["window_s"] = run.trace.window_s
        result["metrics"] = read_metrics(cell.per_layer, run, cell.pkg)
        result["breakdown"] = trace.breakdown(run.trace)
    else:
        result["metrics"] = read_metrics(cell.end_to_end, run, cell.pkg)
    result["device"] = device_info
    driver.close()
    del driver, system, losses
    if on_card:
        torch.cuda.empty_cache()
    nums = reference_check(cell, seed, device, x, y, rows, prog)
    if on_card:
        log(f"[portbench] peak with the reference: "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    correct, checks = check.judge(nums, cell.limits)
    log(f"[portbench] losses: program {nums['loss.program']} reference "
        f"{nums['loss.reference']}")
    log("[portbench] " + ", ".join(f"{k} {nums[k]:.6g}" for k in check.NUMBERS)
        + "; worst leaves: " + ", ".join(
            f"{k} {'/'.join(nums[k + '.leaf'])}"
            for k in ("grad_gap", "change_gap", "state_gap"))
        + "; unmoved: " + (", ".join("/".join(k) for k in
                                     nums["unmoved.leaves"]) or "none")
        + "; left out as cancelling (share of their terms): " + (", ".join(
            f"{'/'.join(k)} {v:.3g}" for k, v in nums["cancels"].items())
            or "none"))
    result["correct"] = bool(correct and failed == 0)
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result
