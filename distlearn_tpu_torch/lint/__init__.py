"""distlint on the port: static SPMD/collective and host-communication
linting of ``distlearn_tpu_torch`` — counterpart of ``distlearn_tpu/lint``,
with its module names, its :class:`~distlearn_tpu_torch.lint.core.Finding`
vocabulary, its rule IDs and its 14 families, every analysis reading the
port's own code:

* :mod:`~distlearn_tpu_torch.lint.spmd` — the collectives a unit issues,
  recorded on every rank (no jaxpr here), checked for DL001-DL004.
* :mod:`~distlearn_tpu_torch.lint.protocol` — the host send/recv schedules
  of the port's ``comm.tree``/``comm.ring`` and the AsyncEA handshake,
  simulated, plus the lock audit of its threaded modules (DL101-DL104).
* :mod:`~distlearn_tpu_torch.lint.cost` — bytes and calls per collective
  kind and mesh axis from the records, the card's peak memory a unit,
  DL202 and the serve tick-loop rule DL209;
  :mod:`~distlearn_tpu_torch.lint.budget` gates them against the
  committed lockfiles (DL203-DL205).
* :mod:`~distlearn_tpu_torch.lint.model` — explicit-state model checking
  of the protocols (DL301-DL304).
* :mod:`~distlearn_tpu_torch.lint.races` — static lockset race detection
  over the port's threaded modules (DL111/DL112).
* :mod:`~distlearn_tpu_torch.lint.conformance` — pins the schedules to the
  port's wire constants and call sites (DL310).

``python -m distlearn_tpu_torch.tools.distlint`` is the CLI;
:mod:`~distlearn_tpu_torch.lint.registry` names the families.
"""

from distlearn_tpu_torch.lint.core import Finding, RULES, format_findings
from distlearn_tpu_torch.lint.spmd import lint_records, note, record
from distlearn_tpu_torch.lint.cost import (CollectiveOp, CostReport,
                                           report_from_record)
from distlearn_tpu_torch.lint.budget import (check_family, load_budget,
                                             save_budget)
from distlearn_tpu_torch.lint.conformance import lint_conformance
from distlearn_tpu_torch.lint.model import (ModelSpec, check_model,
                                            lint_models)
from distlearn_tpu_torch.lint.races import lint_races

__all__ = ["Finding", "RULES", "format_findings", "record", "note",
           "lint_records", "CollectiveOp", "CostReport",
           "report_from_record", "check_family", "load_budget",
           "save_budget", "ModelSpec", "check_model", "lint_models",
           "lint_races", "lint_conformance"]
