"""distlint CLI for the port: lint its step functions and comm protocols —
counterpart of the JAX package's ``tools/distlint.py``, with its flags, its
JSON keys and its exit codes, plus ``--device``.

    python -m distlearn_tpu_torch.tools.distlint --all          # the card
    python -m distlearn_tpu_torch.tools.distlint --all --device cpu
    python -m distlearn_tpu_torch.tools.distlint --family lm --device cpu
    python -m distlearn_tpu_torch.tools.distlint --list
    python -m distlearn_tpu_torch.tools.distlint --all --disable DL004
    python -m distlearn_tpu_torch.tools.distlint --all --format json
    python -m distlearn_tpu_torch.tools.distlint --model        # models
    python -m distlearn_tpu_torch.tools.distlint --races        # lockset
    python -m distlearn_tpu_torch.tools.distlint --update-budgets

Exit code 0 when no error-severity findings survive suppression, 1 when
findings remain, 2 on usage errors (and when a family that runs on the
card finds none: it never falls back to the CPU).

The step families run on 8 gloo rank processes started once for every
family asked for (``lint/registry.py``), on ``cuda:0`` by default and on
the CPU with ``--device cpu``.  ``--update-budgets`` runs every selected
family, rewrites its lockfile (``distlearn_tpu_torch/lint/budgets/
<family>.json``) and exits 0: bytes and calls are the same on the CPU and
on the card; the memory figures come from a ``--device cuda`` run, and a
CPU run keeps the committed ones.  ``--format json`` prints the findings
and the per-family cost tables (bytes per collective kind per mesh axis,
calls, peak memory on the card) with each step unit's kernel launches
under ``info``.
"""

import argparse
import json
import sys

from distlearn_tpu_torch.lint import budget as budget_mod
from distlearn_tpu_torch.lint import registry
from distlearn_tpu_torch.lint.core import RULES, format_findings


def _cost_table(reports) -> dict:
    return {name: rep.to_json() for name, rep in sorted(reports.items())}


def _print_cost_table(family: str, reports) -> None:
    for name, rep in sorted(reports.items()):
        ops = rep.ops_by_axis
        parts = [f"{k}: {v}B/{ops[k]}op"
                 for k, v in sorted(rep.bytes_by_axis.items())]
        peak = rep.peak_bytes
        parts.append(f"peak: {peak}B" if peak is not None else "peak: n/a")
        print(f"  {family}:{name:24s} " + ("; ".join(parts) or "no traffic"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="distlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="lint every registered family")
    ap.add_argument("--family", action="append", default=[],
                    metavar="NAME", help="lint one family (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list registered families and rules, then exit")
    ap.add_argument("--model", action="store_true",
                    help="run the explicit-state protocol models + "
                         "schedule conformance (shorthand for "
                         "--family model)")
    ap.add_argument("--races", action="store_true",
                    help="run the static lockset race detector "
                         "(shorthand for --family races)")
    ap.add_argument("--disable", action="append", default=[],
                    metavar="RULE", help="suppress a rule id (repeatable)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format (json: findings + cost tables)")
    ap.add_argument("--update-budgets", action="store_true",
                    help="rewrite the selected families' cost budget "
                         "lockfiles from a fresh run (then commit them)")
    ap.add_argument("--budget-dir", default=None, metavar="DIR",
                    help="override the lockfile directory "
                         "(default: distlearn_tpu_torch/lint/budgets)")
    ap.add_argument("--costs", action="store_true",
                    help="print the per-unit cost tables with text output")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the step families run (default: the card)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print findings only, no per-unit OK lines")
    args = ap.parse_args(argv)

    fams = registry.families()
    if args.list:
        print("families:")
        for name, e in fams.items():
            print(f"  {name:10s} {e.description}")
        print("rules:")
        for rid, (title, sev) in RULES.items():
            print(f"  {rid}  [{sev}] {title}")
        return 0

    if args.model:
        args.family.append("model")
    if args.races:
        args.family.append("races")
    wanted = list(fams) if (args.all or (args.update_budgets
                                         and not args.family)) \
        else list(dict.fromkeys(args.family))
    if not wanted:
        ap.print_usage(sys.stderr)
        print("distlint: pass --all, --family NAME, or --list",
              file=sys.stderr)
        return 2
    unknown = [f for f in wanted if f not in fams]
    if unknown:
        print(f"distlint: unknown family {unknown} "
              f"(have: {', '.join(fams)})", file=sys.stderr)
        return 2

    try:
        results, all_reports = registry.run_families_costed(
            wanted, device=args.device, suppress=set(args.disable),
            budget_dir=args.budget_dir)
    except ValueError as e:   # unknown rule id in --disable
        print(f"distlint: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:  # no card for a device family
        print(f"{e}", file=sys.stderr)
        return 2

    if args.update_budgets:
        for fam in wanted:
            reports = all_reports[fam]
            path = budget_mod.save_budget(fam, reports,
                                          budget_dir=args.budget_dir)
            print(f"distlint: wrote {path} ({len(reports)} unit(s))")
        return 0

    bad = sum(0 if r.ok else 1 for r in results)
    total = sum(len(r.findings) for r in results)

    if args.format == "json":
        doc = {
            "findings": [
                {"unit": r.name, "rule": f.rule, "severity": f.severity,
                 "where": f.where, "message": f.message}
                for r in results for f in r.findings],
            "costs": {fam: _cost_table(reports)
                      for fam, reports in all_reports.items()},
            "compiles": {},     # the port compiles no program (DL207)
            "rules": sorted(RULES),
            "info": {r.name: r.info for r in results if r.info},
            "units": len(results),
            "errors": bad,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 1 if bad else 0

    for res in results:
        if res.findings:
            print(format_findings(res.findings, header=f"{res.name}:"))
        elif not args.quiet:
            extra = ""
            if "states" in res.info:
                extra = f" ({res.info['states']:,} states)"
            elif "calls" in res.info:
                extra = f" ({res.info['calls']} collective call(s))"
            print(f"{res.name}: OK{extra}")
    if args.costs:
        print("costs (bytes/step per rank, recorded calls):")
        for fam, reports in all_reports.items():
            _print_cost_table(fam, reports)
    print(f"distlint: {len(results)} unit(s), {total} finding(s)"
          + (f", {bad} with errors" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
