"""The readings a cell's limits for ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --mode <mode> \\
        --seeds 11,12,13 [--out FILE]

For each seed, in one process: the cell's data, weights and feed, the
first steps through ``mode``'s system, the reference over the same rows,
and :func:`portbench.check.numbers`, one JSON line a seed.  Modes:

* ``program``: the port's step, as a run takes it (the lower readings);
* ``control``: the reference in the program's place with its products
  and activations rounded to the configuration's ``control`` precision
  (the upper readings);
* ``unchanged``: the port's step returning the state it was given;
* ``halfbatch``: the port's step fed the first half of each batch, the
  mean taken over it;
* ``bucket``: the port's step with the middle one of its gradient buckets
  left out of the update (its leaves keep the params they had);
* ``float32``: the port's step with its products in float32 (a witness
  for a configuration that computes in another precision);
* ``reorder``: the reference in the program's place, float32, fed each
  batch's rows in reverse order: the same sums in another order, so its
  readings are what rounding alone does to each number.

Each line carries every leaf's gap (``<number>.by_leaf``) and the leaves
left out as cancelling (``cancels``), so a rule can be read off the lines
without another run.

The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness, reference, spec, system  # noqa: E402
from portbench.reference.common import (generator, make_params,  # noqa: E402
                                        sgd_steps, tf32_off)

MODES = ("program", "control", "unchanged", "halfbatch", "bucket",
         "float32", "reorder")


class ControlSystem:
    """The reference in the program's place: plain SGD over the
    configuration's model with its products and activations rounded to
    ``precision`` (:func:`~portbench.reference.common.round_to`)."""

    def __init__(self, cfg: dict, seed: int, device, specs: list,
                 precision: str):
        ref = reference.model(cfg)
        self.loss_fn = partial(ref.loss, cfg)
        self.params = make_params(specs, seed, device)
        self.state = ref.state_init(cfg, device)
        self.gen = generator(seed, "dropout", device)
        self.lr, self.precision = cfg["optimizer"]["lr"], precision

    def train(self, x, y):
        out = sgd_steps(self.loss_fn, self.params, self.state, [(x, y)],
                        self.lr, self.gen, self.precision)
        self.params, self.state = out["params"], out["state"]
        return torch.tensor(out["loss"][0])

    def epoch_end(self):
        pass


class ReorderSystem(ControlSystem):
    """The float32 reference in the program's place, each batch's rows
    taken in reverse order."""

    def __init__(self, cfg: dict, seed: int, device, specs: list):
        super().__init__(cfg, seed, device, specs, "float32")

    def train(self, x, y):
        return super().train(x.flip(0), y.flip(0))


def _keep_one_bucket(step, bucket_bytes):
    """``step`` with the leaves of the middle one of its gradient buckets
    left as they were."""
    from distlearn_tpu_torch.ops.flatten import make_bucket_spec
    from distlearn_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                                tree_unflatten)

    def stepped(ts, x, y):
        new, loss = step(ts, x, y)
        spec = make_bucket_spec(ts.params, bucket_bytes)
        kept = set(spec.buckets[len(spec.buckets) // 2].idx)
        old, treedef = tree_flatten(ts.params)
        moved = tree_leaves(new.params)
        params = [old[j] if j in kept else t for j, t in enumerate(moved)]
        return new._replace(params=tree_unflatten(treedef, params)), loss
    return stepped


def plant(mode: str, sys_: system.System) -> None:
    """Breaks the port's step as ``mode`` says."""
    step = sys_.step
    if mode == "unchanged":
        sys_.step = lambda ts, x, y: (ts, step(ts, x, y)[1])
    elif mode == "halfbatch":
        sys_.step = lambda ts, x, y: step(ts, x[:len(x) // 2],
                                          y[:len(y) // 2])
    elif mode == "bucket":
        sys_.step = _keep_one_bucket(step, sys_.bucket_bytes)


def reading(cell: spec.Cell, seed: int, mode: str, device) -> dict:
    cfg = cell.config
    if mode == "control":
        cls = partial(ControlSystem, precision=cfg["control"])
    elif mode == "reorder":
        cls = ReorderSystem
    else:
        cls = system.System
    if mode == "float32":
        cfg = {**cfg, "compute_dtype": "float32"}
        cell = spec.Cell(cell.name, cell.chips, cfg, cell.traffic,
                         cell.limits)
    x, y, sys_, driver, rows = harness.build(cell, seed, device, cls)
    if mode in ("unchanged", "halfbatch", "bucket"):
        plant(mode, sys_)
    prog = harness.first_steps(driver, cell.traffic["check_steps"])
    driver.close()
    del driver, sys_
    torch.cuda.empty_cache()
    nums = harness.reference_check(cell, seed, device, x, y, rows, prog)
    return {"mode": mode, "seed": seed,
            **{k: _plain(v) for k, v in nums.items()}}


def _plain(v):
    """``v`` for JSON: a path of keys as ``a/b``, also as a dict's key."""
    if isinstance(v, tuple):
        return "/".join(v)
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--out", default="", help="append the lines here too")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    device = torch.device("cuda", 0)
    tf32_off()
    harness.card_lines(device)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            line = json.dumps({**reading(cell, seed, args.mode, device),
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    finally:
        system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
