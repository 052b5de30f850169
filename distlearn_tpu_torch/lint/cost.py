"""Collective-traffic and memory cost of a unit (rules DL202, DL209) —
counterpart of ``distlearn_tpu/lint/cost.py``.

Where the JAX package compiles a step and walks its post-fusion HLO, the
port has the calls themselves: a :class:`CostReport` is built from one
rank's record (:mod:`distlearn_tpu_torch.lint.spmd`), every recorded call a
:class:`CollectiveOp`, so its numbers are

* **bytes per collective kind per mesh axis** — each call's result bytes
  on this rank (a gather's whole output, a reduce-scatter's slice), keyed
  like the JAX package's (``"all-reduce@data"``); a psum over two axes is
  two calls here, one an axis, where XLA emits one op over both;
* **collective op counts** — the calls the rank issued, which is what the
  wire sees: a step that degrades from one allreduce a bucket to one a
  tensor shows up here;
* **peak memory** — on the card only, the rise of
  ``torch.cuda.max_memory_allocated`` over the unit (:func:`peak_rise`),
  with the card's name and power limit beside it; on the CPU none is read.

The numbers are per rank per step, like the JAX package's per device per
step; the lockfile rules DL203-DL205 live in
:mod:`distlearn_tpu_torch.lint.budget`.

* **DL202** — :func:`replicated_params`: a rank holding a parameter leaf
  at its whole size where its ``param_specs`` entry splits the leaf over a
  mesh axis larger than one (``models/convert.py::lm_shard`` cuts it).
* **DL209** — :func:`lint_tick_loop`, the JAX package's AST pass: numpy
  tensor math in the per-tick host methods of the port's
  ``serve/{engine,scheduler,prefix_cache,speculate}.py``.

DL201 (GSPMD's implicit gathers), DL206 (donation), DL207 (compile
count) and DL208 (entry relayouts) read a compiled XLA program, which the
port does not have; they stay in the catalog and never fire (the README's
port section says why).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from distlearn_tpu_torch.lint.core import Finding
from distlearn_tpu_torch.lint.spmd import COLLECTIVE_KINDS

__all__ = ["CollectiveOp", "CostReport", "report_from_record", "peak_rise",
           "replicated_params", "lint_tick_loop", "COLLECTIVE_KINDS",
           "TICK_HOT_METHODS"]

#: Per-tick host methods on the serve hot path that DL209 audits (the JAX
#: package's list; the port's serve modules keep its method names).
#: Nested ``def``s inside them are exempt, as in the JAX package.
TICK_HOT_METHODS = frozenset({"tick", "admit", "step", "_tick", "_admit",
                              "_expire", "_dispatch", "verify", "begin",
                              "prefill_step", "_advance_prefills",
                              "_pump_prefill", "propose", "match",
                              "insert", "evict_nodes", "evict_for_free"})

#: numpy calls DL209 treats as tensor *math* when issued per tick on the
#: host; bookkeeping (``asarray``, ``flatnonzero``, ``zeros``, masks) is
#: the host loop's job and stays quiet.
_TENSOR_MATH_FNS = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "power", "tanh", "sin", "cos", "sinh", "cosh",
    "matmul", "dot", "vdot", "inner", "outer", "tensordot", "einsum",
    "argmax", "argmin", "softmax", "logsumexp",
    "cumsum", "cumprod", "mean", "std", "var", "median",
    "sort", "argsort", "take_along_axis", "top_k",
})


@dataclass(frozen=True)
class CollectiveOp:
    """One recorded collective call."""

    kind: str            # one of COLLECTIVE_KINDS
    bytes: int           # result bytes on this rank
    axes: tuple          # mesh axes the call communicates over
    shape: str           # the operand's shape, for messages

    @property
    def axis_key(self) -> str:
        return f"{self.kind}@{','.join(self.axes) or '-'}"


@dataclass
class CostReport:
    """Cost of one unit on one rank.

    ``bytes_by_kind`` / ``ops_by_kind`` aggregate over mesh axes,
    ``bytes_by_axis`` keeps the per-axis split.  ``memory`` is
    ``{"peak": bytes}`` on the card and None on the CPU;
    ``memory_device`` names the card and its power limit.  The JSON keeps
    the JAX package's keys; those of a compiled program (``temp_bytes``,
    ``flops``, ``relayout_ops``) are None."""

    name: str
    collectives: list[CollectiveOp] = field(default_factory=list)
    memory: dict | None = None
    memory_device: str | None = None

    @property
    def bytes_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.collectives:
            out[op.kind] = out.get(op.kind, 0) + op.bytes
        return out

    @property
    def ops_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.collectives:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out

    @property
    def bytes_by_axis(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.collectives:
            out[op.axis_key] = out.get(op.axis_key, 0) + op.bytes
        return out

    @property
    def ops_by_axis(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.collectives:
            out[op.axis_key] = out.get(op.axis_key, 0) + 1
        return out

    @property
    def peak_bytes(self) -> int | None:
        return self.memory.get("peak") if self.memory else None

    def to_json(self) -> dict:
        doc = {
            "collective_bytes": self.bytes_by_kind,
            "collective_ops": self.ops_by_kind,
            "bytes_by_axis": self.bytes_by_axis,
            "peak_bytes": self.peak_bytes,
            "temp_bytes": None,
            "flops": None,
            "relayout_ops": None,
        }
        if self.memory_device is not None:
            doc["memory_device"] = self.memory_device
        return doc


def report_from_record(name: str, calls: Sequence, *, peak: int | None = None,
                       memory_device: str | None = None) -> CostReport:
    """A :class:`CostReport` from one rank's recorded calls."""
    ops = [CollectiveOp(c.kind, int(c.bytes), (c.axis,),
                        f"{c.dtype.split('.')[-1]}{list(c.shape)}")
           for c in calls]
    return CostReport(name=name, collectives=ops,
                      memory=None if peak is None else {"peak": int(peak)},
                      memory_device=memory_device)


def peak_rise(device, run):
    """Run ``run()`` and return ``(result, rise)``: how far
    ``torch.cuda.max_memory_allocated`` climbed over what was allocated
    when the unit began (None off the card)."""
    import torch
    if torch.device(device).type != "cuda":
        return run(), None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = run()
    torch.cuda.synchronize(device)
    return out, int(torch.cuda.max_memory_allocated(device) - base)


def replicated_params(shard: Mapping, whole: Mapping, specs: Mapping,
                      sizes: Mapping[str, int], *,
                      name: str = "step") -> list[Finding]:
    """DL202: leaves of this rank's ``shard`` that keep the ``whole``
    tree's full size along a dimension ``specs`` (``param_specs``) splits
    over an axis of ``sizes[axis] > 1``."""
    findings = []

    def walk(s, w, sp, path):
        for k in s:
            if isinstance(s[k], Mapping):
                walk(s[k], w[k], sp[k], f"{path}{k}/")
                continue
            got, full = tuple(s[k].shape), tuple(w[k].shape)
            for dim, axis in enumerate(sp[k]):
                n = sizes.get(axis, 1) if axis else 1
                if n > 1 and got[dim] == full[dim]:
                    findings.append(Finding(
                        "DL202",
                        f"leaf {path}{k} is held at its whole shape "
                        f"{list(full)} but its spec splits dim {dim} over "
                        f"{axis!r} ({n} ranks): every rank stores and "
                        "updates the full buffer (take the rank's block "
                        "with lm_shard)", where=f"{name}:{path}{k}"))
                    break
    walk(shard, whole, specs, "")
    return findings


# --------------------------------------------------------------- DL209 --

def _scan_hot_method(node, modname: str, clsname: str) -> list[Finding]:
    findings = []

    def walk(n):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue     # a nested program body, exempt
            where = (f"{modname}.{clsname}.{node.name}:"
                     f"{getattr(child, 'lineno', node.lineno)}")
            if isinstance(child, ast.BinOp) and isinstance(child.op,
                                                           ast.MatMult):
                findings.append(Finding(
                    "DL209",
                    f"host-side matrix multiply (@) in per-tick method "
                    f"{clsname}.{node.name}() runs on every tick — it "
                    "belongs in the device pass",
                    where=where))
            elif (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and isinstance(child.func.value, ast.Name)
                    and child.func.value.id in ("np", "jnp", "numpy")
                    and child.func.attr in _TENSOR_MATH_FNS):
                findings.append(Finding(
                    "DL209",
                    f"per-tick host tensor math "
                    f"{child.func.value.id}.{child.func.attr}(...) in "
                    f"{clsname}.{node.name}() — every call is a Python-"
                    "level pass over tensor data in the serve hot loop; "
                    "move it into the device pass",
                    where=where))
            walk(child)

    walk(node)
    return findings


def lint_tick_loop(sources=None) -> list[Finding]:
    """DL209: numpy tensor math in the per-tick host methods.

    ``sources`` is a list of ``(source, modname)`` pairs (or raw source
    strings); defaults to the port's ``serve/engine.py``,
    ``serve/scheduler.py``, ``serve/prefix_cache.py`` and
    ``serve/speculate.py``.  Only methods named in
    :data:`TICK_HOT_METHODS` directly on a class body are scanned."""
    if sources is None:
        import inspect
        from distlearn_tpu_torch.serve import (engine, prefix_cache,
                                               scheduler, speculate)
        sources = [(inspect.getsource(m), m.__name__)
                   for m in (engine, scheduler, prefix_cache, speculate)]
    findings: list[Finding] = []
    for item in sources:
        src, modname = item if isinstance(item, tuple) else (item,
                                                             "<string>")
        for cls in ast.walk(ast.parse(src)):
            if not isinstance(cls, ast.ClassDef):
                continue
            for stmt in cls.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and stmt.name in TICK_HOT_METHODS:
                    findings += _scan_hot_method(stmt, modname, cls.name)
    return findings
