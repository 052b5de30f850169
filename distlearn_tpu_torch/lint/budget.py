"""Per-family collective-traffic & memory budget lockfiles (DL203-DL205) —
counterpart of ``distlearn_tpu/lint/budget.py``, in its schema and with its
tolerances.

A budget lockfile is a committed JSON snapshot of what one step family is
*allowed* to cost, produced from the recorded collectives of a real run
on gloo ranks (``python -m distlearn_tpu_torch.tools.distlint
--update-budgets``).  Bytes and op counts are the same on the CPU and on
the card (the ranks are gloo processes in both), so tier-1 gates them;
the memory figure is the card's (``--device cuda``) and its entry names
the card and power limit it was taken on (``memory_device``).  A CPU
re-baseline keeps the committed memory figures.  The gate compares:

* **DL203** — collective bytes for any kind exceed the committed figure
  by more than the lockfile's ``tolerance.bytes`` (a *new* collective
  kind with nonzero traffic is always over budget);
* **DL204** — the card's peak memory rise over the unit exceeds the
  committed figure by more than ``tolerance.memory`` (on the card only:
  the CPU reads none);
* **DL205** — the recorded op count for any kind exceeds the committed
  count (integer, no tolerance: bucketing either held or broke);
DL207 (the distinct-compile count) and DL208 (entry relayouts) gate what
a compiled program has; the port has none, so its lockfiles carry no
``compiles`` entry and ``relayout_ops`` is null.

A family with cost-bearing units and *no* committed lockfile — or a unit
missing from the lockfile — is a DL203 error: every perf-relevant change
lands either inside budget or with a conscious re-baseline in the same
diff.  Shrinking is never an error; run ``--update-budgets`` to ratchet
the committed floor down after an optimization.

Lockfiles live in ``distlearn_tpu_torch/lint/budgets/<family>.json``;
the format is one ``units`` object keyed by unit name whose entries mirror
:meth:`distlearn_tpu_torch.lint.cost.CostReport.to_json`.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

from distlearn_tpu_torch.lint.core import Finding
from distlearn_tpu_torch.lint.cost import CostReport

__all__ = ["BUDGET_DIR", "DEFAULT_TOLERANCE", "budget_path", "load_budget",
           "save_budget", "check_family"]

#: Committed lockfile directory (inside the package so sdists carry it).
BUDGET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "budgets")

#: Relative slack before DL203/DL204 fire (the JAX package's figures).
#: Bytes are deterministic; the memory slack absorbs the allocator's
#: rounding and the caching of its blocks.
DEFAULT_TOLERANCE = {"bytes": 0.25, "memory": 0.35}


def budget_path(family: str, budget_dir: str | None = None) -> str:
    return os.path.join(budget_dir or BUDGET_DIR, f"{family}.json")


def load_budget(family: str, budget_dir: str | None = None) -> dict | None:
    """The committed lockfile for one family, or None when absent."""
    path = budget_path(family, budget_dir)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def save_budget(family: str, reports: Mapping[str, CostReport],
                budget_dir: str | None = None) -> str:
    """Write (or refresh) one family's lockfile from fresh reports.  A unit
    whose fresh report has no memory figure (a CPU run) keeps the one the
    lockfile already commits, with the card it was taken on."""
    path = budget_path(family, budget_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    old = (load_budget(family, budget_dir) or {}).get("units", {})
    units = {}
    for name, rep in sorted(reports.items()):
        entry = rep.to_json()
        prev = old.get(name, {})
        if entry["peak_bytes"] is None and prev.get("peak_bytes"):
            entry["peak_bytes"] = prev["peak_bytes"]
            if prev.get("memory_device"):
                entry["memory_device"] = prev["memory_device"]
        units[name] = entry
    doc = {
        "family": family,
        "tolerance": dict(DEFAULT_TOLERANCE),
        "units": units,
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def _over(actual: float, allowed: float, tol: float) -> bool:
    return actual > allowed * (1.0 + tol)


def check_family(family: str, reports: Mapping[str, CostReport],
                 budget: dict | None = None,
                 budget_dir: str | None = None) -> list[Finding]:
    """Compare fresh cost reports against the committed lockfile."""
    if budget is None:
        budget = load_budget(family, budget_dir)
    findings: list[Finding] = []
    if not reports:
        return findings
    if budget is None:
        findings.append(Finding(
            "DL203",
            f"family {family!r} has {len(reports)} cost-bearing unit(s) "
            "but no committed budget lockfile; run "
            "`python -m distlearn_tpu_torch.tools.distlint "
            f"--update-budgets` and commit lint/budgets/{family}.json",
            where=family))
        return findings
    tol = {**DEFAULT_TOLERANCE, **budget.get("tolerance", {})}
    units = budget.get("units", {})
    for name, rep in sorted(reports.items()):
        entry = units.get(name)
        if entry is None:
            findings.append(Finding(
                "DL203",
                f"unit {name!r} is not in the committed budget lockfile "
                f"for family {family!r}; re-baseline with --update-budgets",
                where=name))
            continue
        committed_bytes = entry.get("collective_bytes", {})
        for kind, actual in sorted(rep.bytes_by_kind.items()):
            allowed = committed_bytes.get(kind, 0)
            if actual and not allowed:
                findings.append(Finding(
                    "DL203",
                    f"{kind} traffic appeared ({actual} bytes/step) but "
                    "the committed budget has none; either remove the new "
                    "collective or re-baseline with --update-budgets",
                    where=name))
            elif _over(actual, allowed, tol["bytes"]):
                findings.append(Finding(
                    "DL203",
                    f"{kind} traffic {actual} bytes/step exceeds the "
                    f"committed {allowed} bytes/step by more than "
                    f"{tol['bytes']:.0%}",
                    where=name))
        committed_ops = entry.get("collective_ops", {})
        for kind, actual in sorted(rep.ops_by_kind.items()):
            allowed = committed_ops.get(kind, 0)
            if actual > allowed:
                findings.append(Finding(
                    "DL205",
                    f"{actual} recorded {kind} call(s) vs {allowed} "
                    "committed — bucketing regressed (e.g. a packed update "
                    "degraded to per-tensor collectives); fix the packing "
                    "or re-baseline with --update-budgets",
                    where=name))
        committed_peak = entry.get("peak_bytes")
        actual_peak = rep.peak_bytes
        if committed_peak and actual_peak and \
                _over(actual_peak, committed_peak, tol["memory"]):
            findings.append(Finding(
                "DL204",
                f"peak memory rise {actual_peak} bytes exceeds the "
                f"committed {committed_peak} bytes"
                + (f" ({entry['memory_device']})"
                   if entry.get("memory_device") else "")
                + f" by more than {tol['memory']:.0%}",
                where=name))
    return findings
