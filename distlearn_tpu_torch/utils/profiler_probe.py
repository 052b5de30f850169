"""Counts the kernel records ``torch.profiler`` loses at the start of a window.

Each process profiles ``--rounds`` windows.  A window launches a known
sequence of kernels: first ``HEAD`` in-place adds, then 40 x (20 in-place
multiplies and one 2048 x 2048 float32 matmul) and four 6144 x 6144 float32
matmuls.  After ``torch.cuda.synchronize()`` the window closes, and the probe
counts the window's device kernel records against the CUDA runtime's kernel
launches (``cudaLaunchKernel``, ``cuLaunchKernel`` and their variants,
recorded on the host side), and the head's adds among them.  ``--settle``
lists the pauses tried between the profiler's start and the first launch (a
device synchronize and a sleep); ``--procs`` the numbers of processes
sharing card 0 at once.
``utils/profiling.py::settled_profile`` opens every profile of the port and of
``chip_smoke.py`` with such a pause (``SETTLE_S``).
Prints the card's name and power limit (``nvidia-smi``), then one JSON
line per (processes, pause).  Nothing in the port imports
it.  Run on one card from the repo's root:

    python -m distlearn_tpu_torch.utils.profiler_probe
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.multiprocessing as mp

HEAD = 32


def _window(a, big, s):
    for _ in range(HEAD):
        s.add_(1.0)
    for i in range(40):
        for _ in range(20):
            s.mul_(1.0001)
        a @ a
        if i % 10 == 0:
            big @ big


def _worker(rank, rounds, settle, q):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts):               # CUPTI's start-up
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    a = torch.randn(2048, 2048, device="cuda")
    big = torch.randn(6144, 6144, device="cuda")
    s = torch.randn(4096, device="cuda")
    rows = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if settle:
                torch.cuda.synchronize()
                time.sleep(settle)
            _window(a, big, s)
            torch.cuda.synchronize()
        kernels = launches = adds = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                kernels += e.count
                adds += e.count if "elementwise" in e.key and \
                    "Mul" not in e.key else 0
            elif "LaunchKernel" in e.key:
                launches += e.count
        rows.append((launches, kernels, adds))
    q.put((rank, rows))


def run(procs, rounds, settle):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ps = [ctx.Process(target=_worker, args=(r, rounds, settle, q))
          for r in range(procs)]
    for p in ps:
        p.start()
    got = [q.get(timeout=900) for _ in ps]
    for p in ps:
        p.join()
    rows = [row for _, rs in got for row in rs]
    short = [(n - k, HEAD - h) for n, k, h in rows if k != n]
    return {"procs": procs, "settle_s": settle, "windows": len(rows),
            "launches_a_window": sorted({n for n, _, _ in rows}),
            "windows_short": len(short),
            "records_lost": sum(x for x, _ in short),
            "lost_from_the_head": sum(min(x, y) for x, y in short),
            "largest_loss": max((x for x, _ in short), default=0)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", default="1,4")
    ap.add_argument("--settle", default="0,0.01,0.05")
    ap.add_argument("--rounds", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card or torch.cuda.get_device_name(0)}", flush=True)
    for procs in (int(x) for x in args.procs.split(",")):
        for settle in (float(x) for x in args.settle.split(",")):
            print(json.dumps(run(procs, args.rounds, settle)), flush=True)


if __name__ == "__main__":
    main()
