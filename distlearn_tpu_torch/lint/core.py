"""Shared finding vocabulary for the port's distlint — counterpart of
``distlearn_tpu/lint/core.py``.

A :class:`Finding` is one rule violation at one program point.  Rules keep
the JAX package's stable IDs (``DL0xx`` SPMD rules, ``DL1xx`` host
communication, ``DL2xx`` cost and budget, ``DL3xx`` protocol models), so a
suppression (``suppress={"DL004"}``, ``--disable DL004``) means the same in
both packages.  Where the port reads a rule off something else than the
JAX package does (recorded collectives instead of a jaxpr, the card's
allocator instead of a compiled module), the title says so; the README's
port section is the rule catalog.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

#: Rule catalog: id -> (title, default severity).
RULES = {
    "DL001": ("collective over a mesh axis the unit's mesh lacks (port: a "
              "Mesh.axis lookup that fails, or a collective on a group of "
              "no axis of the unit's mesh)", "error"),
    "DL002": ("collective records diverge across the ranks of a group "
              "(port: the recorded calls of every rank, first index where "
              "kind, axis, dtype or shape differ; cross-rank deadlock "
              "hazard)", "error"),
    "DL003": ("ranks that should draw different dropout masks draw from "
              "the same generator state (port: generator states recorded "
              "at each draw)", "error"),
    "DL004": ("cross-rank reduction accumulates in a <32-bit float "
              "dtype", "error"),
    "DL005": ("donated input buffer has no shape/dtype-compatible output "
              "to alias (port: no donation; never fires)", "error"),
    "DL201": ("GSPMD inserted an implicit all-gather with a large operand "
              "(port: every gather is explicit; never fires)", "error"),
    "DL202": ("parameter-sized buffer materialized replicated despite a "
              "sharded in-spec (port: a rank holds a leaf at full size "
              "where its lm_shard spec splits it)", "error"),
    "DL203": ("collective traffic exceeds the family's committed budget "
              "lockfile", "error"),
    "DL204": ("peak memory regressed vs. the family's budget lockfile "
              "(port: the card's allocator peak over the unit)", "error"),
    "DL205": ("collective op count regressed vs. the family's budget "
              "lockfile (port: recorded calls)", "error"),
    "DL206": ("serve-path donation wasted or missing (port: the pools "
              "are updated in place; never fires)", "error"),
    "DL207": ("distinct-compile count exceeds the family's committed "
              "budget (port: nothing is compiled; never fires)", "error"),
    "DL208": ("compiled program relayouts an entry parameter beyond the "
              "committed budget (port: no compiled program; never fires)",
              "error"),
    "DL209": ("per-tick Python-level tensor math in the serve hot loop "
              "(port: numpy math in the per-tick host methods)", "error"),
    "DL101": ("host send/recv schedule admits a wait-for cycle "
              "(static deadlock)", "error"),
    "DL102": ("lock acquisition order forms a cycle across threads",
              "error"),
    "DL103": ("blocking network/queue call while holding a lock", "error"),
    "DL104": ("peers disagree on message order (protocol desync)", "error"),
    "DL111": ("field written with no common lock against another thread's "
              "access (lockset race)", "error"),
    "DL112": ("lock-guarded field read without the guard elsewhere "
              "(torn-read hazard)", "warning"),
    "DL301": ("protocol model reaches a state with no enabled action "
              "before completion (deadlock)", "error"),
    "DL302": ("a stale-epoch center applies a delta in some interleaving "
              "(epoch fence violated)", "error"),
    "DL303": ("a (client, seq) delta is applied more than once across "
              "failover (exactly-once violated)", "error"),
    "DL304": ("serve slot/page accounting diverges between scheduler and "
              "engine (resource leak)", "error"),
    "DL310": ("hand-written protocol schedule drifted from the code it "
              "models (conformance)", "error"),
}


@dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``where`` is a human-readable program point: for the SPMD rules a
    unit, rank and record index (``"lm:lm_step/rank 3#12"``), for protocol
    rules a rank or source location.
    """

    rule: str
    message: str
    where: str = ""
    severity: str = "error"

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.rule}{loc}: {self.message}"


def filter_suppressed(findings: Iterable[Finding],
                      suppress: Iterable[str] = ()) -> list[Finding]:
    """Drop findings whose rule id is suppressed (unknown ids rejected)."""
    suppress = set(suppress)
    bad = suppress - RULES.keys()
    if bad:
        raise ValueError(f"cannot suppress unknown rule(s): {sorted(bad)}")
    return [f for f in findings if f.rule not in suppress]


def format_findings(findings: Sequence[Finding], *, header: str = "") -> str:
    """Render findings for terminal output, one per line."""
    lines = []
    if header:
        lines.append(header)
    if not findings:
        lines.append("  no findings")
    for f in findings:
        lines.append(f"  {f.severity.upper()} {f}")
    return "\n".join(lines)


@dataclass
class LintResult:
    """Findings for one lintable unit (a step function or a protocol).

    ``info`` carries analysis metadata that is not a finding: the model
    checker's explored state/transition counts, a step unit's kernel
    launches, so the CLI can print them and the JSON output stays
    auditable.
    """

    name: str
    findings: list[Finding] = field(default_factory=list)
    info: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)
