"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs the cards the cell asks for; exits with another code than 0, and
prints no result, without them, without the port beside ``portbench/``,
or when ``jax``, ``jaxlib``, ``flax`` or the JAX package has been loaded.
The numbers ``correct`` compared, each beside its limit, are the last lines
on standard error and the last key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: top-level modules that may not be loaded in the process that reports
BANNED = ("jax", "jaxlib", "flax", "distlearn_tpu")


def loaded_banned() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    from portbench import spec
    from portbench.harness import log, run_cell
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"[portbench] {cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 2
    try:
        import distlearn_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"[portbench] the port is not beside portbench/: {e}")
        return 2
    from portbench import system
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    finally:
        system.close()
    found = loaded_banned()
    if found:
        log(f"[portbench] loaded in this process: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"[portbench] check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
