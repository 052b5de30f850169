"""Attribute device time from a ``torch.profiler`` Chrome trace.

Reads the Chrome-trace JSON that ``utils/profiling.py::trace`` writes
(``<log_dir>/trace.json``: ``tools.profile_resnet``, ``examples/lm.py
--profile``) and prints the card's kernel time grouped by class — GEMM
and convolution, the flash kernels B5a-B5c, the update and codec kernels
B1-B4, elementwise and reduction work, copies — and by kernel name, with
each group's share of the kernel time and its launches.  The port's
counterpart of the root ``tools/analyze_trace.py``, which groups an XLA
trace's device ops by fusion kind and output shape.

Only device-kernel events count (``"cat": "kernel"``, and the card's
copies and sets, ``gpu_memcpy``/``gpu_memset``); host ops and runtime
calls do not.  Standard library only.

Usage:
    python -m distlearn_tpu_torch.tools.analyze_trace /tmp/prof_resnet [--top 25]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys

#: (class, substrings of a kernel's name), first match wins; the rest is
#: "elementwise/reduce".  The B-numbers are ROADMAP's kernel table.
CLASSES = (
    ("B1 fused_sgd", ("sgd_chunk",)),
    ("B2 fused_elastic", ("elastic_vec4", "elastic_scalar")),
    ("B3 quantize_ef", ("amax_leaves", "quant_ef_leaves")),
    ("B4 dequant_add", ("dequant_add",)),
    ("B5a flash forward", ("flash_fwd",)),
    ("B5b flash dK/dV", ("flash_bwd_dkv",)),
    ("B5c flash dQ", ("flash_bwd_dq",)),
    ("gemm/convolution", ("gemm", "xmma", "cutlass", "cudnn", "conv",
                          "winograd", "implicit", "dgrad", "wgrad",
                          "fprop", "cublas", "sm90_", "sm80_")),
    ("nccl", ("nccl",)),
    ("copy", ("Memcpy", "Memset", "CatArrayBatchedCopy", "copy_kernel")),
)
OTHER = "elementwise/reduce"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classify(name: str) -> str:
    for cls, subs in CLASSES:
        if any(s in name for s in subs):
            return cls
    return OTHER


def find_trace(path: str) -> str:
    """``path`` itself when it is a file, else the newest Chrome trace
    (``*.json`` or ``*.json.gz``) under it."""
    if os.path.isfile(path):
        return path
    hits = [p for pat in ("*.json", "*.json.gz")
            for p in glob.glob(os.path.join(path, "**", pat),
                               recursive=True)]
    if not hits:
        sys.exit(f"no Chrome trace (*.json, *.json.gz) under {path}")
    return max(hits, key=os.path.getmtime)


def load_kernels(path: str) -> list[tuple[str, float]]:
    """``[(name, dur_us)]`` for the trace's device-kernel events."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    ev = data["traceEvents"] if isinstance(data, dict) else data
    return [(str(e.get("name", "?")), float(e.get("dur", 0.0)))
            for e in ev
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def attribute(kernels: list[tuple[str, float]]) -> dict:
    """``{"total_us", "launches", "classes": {class: {"us", "share",
    "launches"}}, "names": [(name, us, launches), ...]}`` (classes and
    names by time, largest first)."""
    total = sum(t for _, t in kernels)
    by_cls: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for name, t in kernels:
        for key, tab in ((classify(name), by_cls), (name, by_name)):
            row = tab.setdefault(key, [0.0, 0])
            row[0] += t
            row[1] += 1
    classes = {c: {"us": us, "share": us / total if total else 0.0,
                   "launches": n}
               for c, (us, n) in sorted(by_cls.items(),
                                        key=lambda kv: -kv[1][0])}
    names = sorted(((n, us, k) for n, (us, k) in by_name.items()),
                   key=lambda r: -r[1])
    return {"total_us": total, "launches": len(kernels),
            "classes": classes, "names": names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir", help="a trace file or a directory holding one")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    path = find_trace(args.log_dir)
    kernels = load_kernels(path)
    if not kernels:
        sys.exit("no device kernel events in the trace (profile a run on "
                 "the card)")
    doc = attribute(kernels)
    total = doc["total_us"]
    print(f"device kernel time: {total / 1e3:.3f} ms over the trace window "
          f"({doc['launches']} launches), {path}")
    print("\n== by class ==")
    for cls, row in doc["classes"].items():
        print(f"  {row['us'] / 1e3:10.3f} ms {100 * row['share']:5.1f}%  "
              f"{row['launches']:7d}  {cls}")
    print(f"\n== top {args.top} kernels ==")
    for name, us, n in doc["names"][:args.top]:
        print(f"  {us / 1e3:10.3f} ms {100 * us / total:5.1f}%  {n:7d}  "
              f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
