"""The comparison that decides ``correct`` for a training cell.

The program's first steps, taken in set-up through the window's own call
and feed, are set against the reference's over the same batches from the
same weights (:func:`portbench.reference.common.sgd_steps`).  The numbers,
each the worst case, that a cell's limits (``limits/<cell>.json``) name
are compared with them:

* ``loss_gap``: the largest gap between the two losses of a step;
* ``grad_gap``: the first gradient as the optimizer got it, worked out from
  the program's params after one step, ``(p0 - p1) / lr``; the gap between
  its norm and the reference gradient's, leaf by leaf, over the larger of
  the reference leaf's norm and the median leaf's;
* ``change_gap``: the same for the change of the params over all the
  steps, ``p - p0``, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (a bias under batchnorm, which
  moves by rounding alone);
* ``state_gap``: the same for the change of the batchnorm running
  statistics;
* ``change_gap.median``: the change's gap at the median leaf, the number a
  cell compares where rounding alone, in any precision, moves the worst
  leaf's change after three steps as far as a fault does (PERF.md);
* ``unmoved``: how many leaves that the reference moves (its gradient at
  least a thousandth of the median leaf's) the program left exactly as
  they were, an update skipped for some of the params (limit 0).

``grad_gap`` and ``change_gap`` leave out the leaves whose terms cancel:
a batchnorm leaf whose first reference gradient has a norm under
``CANCELS`` of its terms' summed magnitudes (``cancel1`` of
:func:`~portbench.reference.common.sgd_steps`) is a residue that rounding
decides, in any precision below the reference's (PERF.md).
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench.reference.common import leaves

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_gap.median",
           "state_gap", "unmoved")
#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the change
STILL = 1e-3
#: a leaf whose reference gradient is under this share of its terms'
#: summed magnitudes is left out of the gradient and the change
CANCELS = 3e-4


def _norms(pairs) -> dict:
    return {p: float(t.double().norm()) for p, t in pairs}


def _diff(a: dict, b: dict, device) -> list:
    """``[(path, a - b)]`` in float64 on ``device``."""
    bl = dict(leaves(b))
    return [(p, t.to(device, torch.float64) - bl[p].to(device, torch.float64))
            for p, t in leaves(a)]


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """``|prog - ref| / max(ref, median ref)`` of each leaf of ``keys``."""
    keys = list(keys)
    if not keys:
        return {}
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def _put(out: dict, name: str, gaps: dict) -> None:
    """The worst leaf's gap as ``name``, its leaf as ``name.leaf``, the
    median leaf's gap as ``name.median`` and every leaf's gap as
    ``name.by_leaf``."""
    worst = max(gaps, key=gaps.get) if gaps else ()
    out[name], out[name + ".leaf"] = gaps.get(worst, 0.0), worst
    out[name + ".median"] = statistics.median(gaps.values()) if gaps else 0.0
    out[name + ".by_leaf"] = gaps


def numbers(prog: dict, ref: dict, p0: dict, s0: dict, lr: float) -> dict:
    """Every number of ``NUMBERS``, the leaf that set each worst case
    (``"<name>.leaf"``) and every leaf's gap (``"<name>.by_leaf"``), and
    the leaves left out as cancelling (``"cancels"``, with their shares);
    a number that is not finite reads infinite.

    ``prog``: ``loss`` (a list), ``params1``, ``params``, ``state``;
    ``ref``: the same, ``grad1`` and ``cancel1``, from :func:`sgd_steps`;
    ``p0`` the params both started from."""
    dev = leaves(p0)[0][1].device
    lr32 = torch.tensor(lr, dtype=torch.float32).item()
    out = {"loss_gap": max(abs(a - b)
                           for a, b in zip(prog["loss"], ref["loss"])),
           "loss.program": prog["loss"], "loss.reference": ref["loss"]}
    g_ref = _norms(leaves(ref["grad1"]))
    g_prog = {p: n / lr32
              for p, n in _norms(_diff(p0, prog["params1"], dev)).items()}
    out["cancels"] = {k: v for k, v in ref["cancel1"].items()
                      if v < CANCELS}
    counted = [k for k in g_ref if k not in out["cancels"]]
    _put(out, "grad_gap", _gaps(g_prog, g_ref, counted))
    med = statistics.median(g_ref.values())
    stirred = {k for k, v in g_ref.items() if v >= STILL * med}
    moved = [k for k in counted if k in stirred]
    d_ref = _norms(_diff(ref["params"], p0, dev))
    d_prog = _norms(_diff(prog["params"], p0, dev))
    _put(out, "change_gap", _gaps(d_prog, d_ref, moved))
    s_ref = _norms(_diff(ref["state"], s0, dev))
    s_prog = _norms(_diff(prog["state"], s0, dev))
    _put(out, "state_gap", _gaps(s_prog, s_ref, s_ref))
    out["unmoved.leaves"] = [
        k for (k, a), (_, b) in zip(leaves(prog["params"]), leaves(p0))
        if k in stirred and torch.equal(a.to(b.device), b)]
    out["unmoved"] = len(out["unmoved.leaves"])
    for k in NUMBERS:
        if not math.isfinite(out[k]):
            out[k] = math.inf
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number that
    ``limits`` names at or under its limit."""
    checks = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
