"""Recorded-collective SPMD linter (rules DL001-DL004) — counterpart of
``distlearn_tpu/lint/spmd.py``.

The JAX package traces a step to a jaxpr and walks it.  The port has no
jaxpr: a step is eager PyTorch whose collectives are calls on
``torch.distributed`` process groups, issued from ``parallel/mesh.py``,
``parallel/allreduce_{sgd,ea}.py``, ``ops/fused_update.py``,
``models/nn.py`` (sync batchnorm), ``train/optim.py`` and the tp engine's
control broadcasts (``serve/engine.py``).  So the rules read a **record**:
:func:`record` wraps the ``torch.distributed`` functions the port calls for
the length of one unit, on every rank, and appends one :class:`Call` per
collective, in order: its kind in the JAX package's HLO names
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``; ``broadcast`` for the port's own broadcasts), the
mesh axis its group is a line of, its dtype, shape and result bytes.  The
stacked-rows backends (``comm/backend.py``), whose sums run over a row axis
in one process with no group, report theirs through :func:`note`.

From the records:

* **DL001** — a collective on a group that is a line of no axis of the
  unit's mesh, or a ``Mesh.axis`` lookup of an axis the mesh lacks (which
  raises ``ValueError``; :func:`axis_error` turns it into the finding).
* **DL002** — :func:`diverging` compares the ranks' records group by
  group: the first index where kind, axis, dtype or shape differ between
  two ranks of one group (or where one rank issues a call the others do
  not) is a call that never completes.  Point-to-point calls
  (``collective-permute``) are held pair by pair instead: what rank a
  sends to b, in order, must be what b receives from a.
* **DL003** — :func:`shared_draws`: every dropout draw
  (``models/nn.py::dropout``) records a digest of its generator's state;
  two ranks of a group drawing from equal states draw the same mask.
* **DL004** — an ``all-reduce`` or ``reduce-scatter`` that sums a float16
  or bfloat16 operand (a max, a min or a gather in those types is quiet).

``record(dry=True)`` records without calling the backend (every rank then
keeps its own values), the counterpart of the JAX package's abstract
trace: a unit whose ranks disagree can be linted without hanging them.
"""

from __future__ import annotations

import contextlib
import hashlib
import pickle
import threading
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import torch
import torch.distributed as dist

from distlearn_tpu_torch.lint.core import Finding, filter_suppressed

__all__ = ["Call", "Recorder", "record", "note", "axis_map", "axis_error",
           "lint_records", "diverging", "shared_draws", "low_precision",
           "unbound_axes", "COLLECTIVE_KINDS"]

#: The kinds a record names, the JAX package's HLO opcodes first.
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "collective-permute", "all-to-all", "broadcast")
#: Kinds that accumulate across ranks when their op is a sum (DL004).
_ACCUMULATING = frozenset({"all-reduce", "reduce-scatter"})
_LOW_FLOATS = frozenset({"torch.float16", "torch.bfloat16"})
#: The axis of a group that is a line of no axis of the unit's mesh.
UNBOUND = "?"


@dataclass(frozen=True)
class Call:
    """One recorded collective on this rank.

    ``bytes`` is the result's size on this rank (what the JAX package
    reads off the HLO result shape): a gather's whole output, a
    reduce-scatter's slice.  ``group`` lists the group's global ranks;
    ``peers`` a permute's ``(("send", rank), ("recv", rank))`` legs."""

    kind: str
    axis: str
    dtype: str
    shape: tuple
    bytes: int
    op: str = "sum"
    group: tuple = ()
    peers: tuple = ()

    @property
    def signature(self) -> tuple:
        return (self.kind, self.axis, self.dtype, self.shape)


@dataclass(eq=False)
class Recorder:
    """What one rank did during one unit."""

    axes: dict
    rank: int
    dry: bool = False
    calls: list = field(default_factory=list)
    #: (index of the call the draw came after, generator-state digest)
    draws: list = field(default_factory=list)
    #: the ``Mesh.axis`` failure that ended the unit, if any (DL001)
    axis_errors: list = field(default_factory=list)

    def axis_of(self, group) -> str:
        key = _group_key(group)
        return self.axes.get(key, UNBOUND)


_ACTIVE: list[Recorder] = []
_PATCH_LOCK = threading.Lock()


def _group_key(group):
    """A hashable key for a process group (``None`` is the world)."""
    if group is None or group is dist.group.WORLD:
        return "WORLD"
    return id(group)


def _group_ranks(group) -> tuple:
    try:
        return tuple(dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD))
    except (RuntimeError, ValueError):
        return ()


def axis_map(*handles) -> dict:
    """``{group key: axis name}`` for the unit's handles: every axis of a
    :class:`~distlearn_tpu_torch.parallel.mesh.Mesh` this rank is in, a
    ``(MeshTree, name)`` pair, or a ``(group, name)`` pair."""
    out = {}
    for h in handles:
        if isinstance(h, tuple):
            obj, name = h
            group = getattr(obj, "group", obj)
            out[_group_key(group)] = name
            continue
        for name, ax in getattr(h, "_axes", {}).items():
            out[_group_key(ax.group)] = name
    return out


def _dtype(t) -> str:
    return str(getattr(t, "dtype", "object"))


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def _push(kind, tensor, group, nbytes, op="sum", peers=()):
    for rec in _ACTIVE:
        rec.calls.append(Call(
            kind=kind, axis=rec.axis_of(group), dtype=_dtype(tensor),
            shape=tuple(getattr(tensor, "shape", ())), bytes=int(nbytes),
            op=op, group=_group_ranks(group), peers=tuple(peers)))


def note(kind: str, axis: str, tensor: torch.Tensor, nbytes: int | None = None,
         op: str = "sum") -> None:
    """Record a collective that runs with no process group: the stacked
    rows of ``comm/backend.py`` summed over their row axis in one process
    (the JAX package's psum over the backend's ``data`` mesh axis).  A
    no-op unless a :func:`record` is open."""
    if not _ACTIVE:
        return
    for rec in _ACTIVE:
        rec.calls.append(Call(kind=kind, axis=axis, dtype=_dtype(tensor),
                              shape=tuple(tensor.shape),
                              bytes=_nbytes(tensor) if nbytes is None
                              else int(nbytes), op=op))


def _op_name(op) -> str:
    name = str(getattr(op, "name", op)).lower()
    return name.rsplit(".", 1)[-1]


def _wrap(real):
    """The recording stand-ins for the ``torch.distributed`` calls the port
    makes; each records, then runs ``real`` unless every open record is
    dry."""
    dry = lambda: all(r.dry for r in _ACTIVE)   # noqa: E731

    def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        _push("all-reduce", tensor, group, _nbytes(tensor), _op_name(op))
        if dry():
            return None
        return real["all_reduce"](tensor, op=op, group=group,
                                  async_op=async_op)

    def all_gather(tensor_list, tensor, group=None, async_op=False):
        _push("all-gather", tensor, group, _nbytes(tensor) * len(tensor_list),
              "gather")
        if dry():
            for t in tensor_list:
                t.copy_(tensor)
            return None
        return real["all_gather"](tensor_list, tensor, group=group,
                                  async_op=async_op)

    def all_gather_into_tensor(output_tensor, input_tensor, group=None,
                               async_op=False):
        _push("all-gather", input_tensor, group, _nbytes(output_tensor),
              "gather")
        if dry():
            n = output_tensor.numel() // max(1, input_tensor.numel())
            output_tensor.copy_(input_tensor.reshape(1, -1).expand(n, -1)
                                .reshape(output_tensor.shape))
            return None
        return real["all_gather_into_tensor"](output_tensor, input_tensor,
                                              group=group, async_op=async_op)

    def reduce_scatter_tensor(output, input, op=dist.ReduceOp.SUM,
                              group=None, async_op=False):
        _push("reduce-scatter", input, group, _nbytes(output), _op_name(op))
        if dry():
            output.copy_(input.reshape(-1)[:output.numel()]
                         .reshape(output.shape))
            return None
        return real["reduce_scatter_tensor"](output, input, op=op,
                                             group=group, async_op=async_op)

    def all_to_all_single(output, input, output_split_sizes=None,
                          input_split_sizes=None, group=None,
                          async_op=False):
        _push("all-to-all", input, group, _nbytes(input), "permute")
        if dry():
            output.copy_(input)
            return None
        return real["all_to_all_single"](
            output, input, output_split_sizes=output_split_sizes,
            input_split_sizes=input_split_sizes, group=group,
            async_op=async_op)

    def broadcast(tensor, src=None, group=None, async_op=False, **kw):
        _push("broadcast", tensor, group, _nbytes(tensor), "copy")
        if dry():
            return None
        return real["broadcast"](tensor, src, group=group,
                                 async_op=async_op, **kw)

    def batch_isend_irecv(p2p_op_list):
        legs, size, first, group = [], 0, None, None
        for p in p2p_op_list:
            send = p.op is dist.isend
            legs.append(("send" if send else "recv", int(p.peer)))
            size = max(size, _nbytes(p.tensor))
            first = first if first is not None else p.tensor
            group = p.group
        if first is not None:
            _push("collective-permute", first, group, size, "permute",
                  peers=legs)
        if dry():
            return []
        return real["batch_isend_irecv"](p2p_op_list)

    def broadcast_object_list(object_list, src=None, group=None,
                              device=None, **kw):
        me = dist.get_rank()
        size = len(pickle.dumps(object_list)) if src == me else 0
        _push("broadcast", object(), group, size, "copy")
        if dry():
            return None
        return real["broadcast_object_list"](object_list, src=src,
                                             group=group, device=device, **kw)

    def all_gather_object(object_list, obj, group=None):
        _push("all-gather", object(), group,
              len(pickle.dumps(obj)) * len(object_list), "gather")
        if dry():
            for i in range(len(object_list)):
                object_list[i] = obj
            return None
        return real["all_gather_object"](object_list, obj, group=group)

    return {"all_reduce": all_reduce, "all_gather": all_gather,
            "all_gather_into_tensor": all_gather_into_tensor,
            "reduce_scatter_tensor": reduce_scatter_tensor,
            "all_to_all_single": all_to_all_single, "broadcast": broadcast,
            "batch_isend_irecv": batch_isend_irecv,
            "broadcast_object_list": broadcast_object_list,
            "all_gather_object": all_gather_object}


_NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
          "reduce_scatter_tensor", "all_to_all_single", "broadcast",
          "batch_isend_irecv", "broadcast_object_list", "all_gather_object")


def _digest(gen) -> str:
    return hashlib.sha1(bytes(gen.get_state().cpu().numpy())).hexdigest()[:16]


@contextlib.contextmanager
def record(axes: Mapping | None = None, *, dry: bool = False,
           rank: int | None = None):
    """Record this rank's collectives (and dropout draws) until the block
    ends; yields the :class:`Recorder`.  ``axes`` maps group keys to axis
    names (:func:`axis_map`).  The wrappers are installed once for the
    outermost record and removed when it closes."""
    from distlearn_tpu_torch.models import nn as port_nn
    rec = Recorder(dict(axes or {}),
                   dist.get_rank() if rank is None and dist.is_initialized()
                   else int(rank or 0), dry=dry)
    with _PATCH_LOCK:
        outermost = not _ACTIVE
        if outermost:
            real = {n: getattr(dist, n) for n in _NAMES}
            real_dropout = port_nn.dropout
            for name, fn in _wrap(real).items():
                setattr(dist, name, fn)

            def dropout(gen, x, rate, train):
                if train and rate and gen is not None:
                    for r in _ACTIVE:
                        r.draws.append((len(r.calls), _digest(gen)))
                return real_dropout(gen, x, rate, train)
            port_nn.dropout = dropout
        _ACTIVE.append(rec)
    try:
        yield rec
    except ValueError as e:
        if not axis_error(e):
            raise
        rec.axis_errors.append(str(e))
    finally:
        with _PATCH_LOCK:
            _ACTIVE.remove(rec)
            if outermost:
                for name in _NAMES:
                    setattr(dist, name, real[name])
                port_nn.dropout = real_dropout


def axis_error(e: BaseException) -> bool:
    """Whether ``e`` is ``Mesh.axis``'s refusal of an axis the mesh lacks
    (``parallel/mesh.py``)."""
    return isinstance(e, ValueError) and str(e).startswith("no mesh axis ")


# ---------------------------------------------------------------------------
# The rules over the records
# ---------------------------------------------------------------------------

def unbound_axes(calls: Sequence[Call], axis_errors: Sequence[str] = (),
                 *, name: str = "step", rank: int = 0) -> list[Finding]:
    """DL001 on one rank's record."""
    out = [Finding("DL001", f"{msg}; the unit names an axis its mesh lacks",
                   where=f"{name}/rank {rank}") for msg in axis_errors]
    for i, c in enumerate(calls):
        if c.axis == UNBOUND:
            out.append(Finding(
                "DL001",
                f"{c.kind} on a group of ranks {list(c.group)} that is a "
                "line of no axis of the unit's mesh",
                where=f"{name}/rank {rank}#{i}"))
    return out


def low_precision(calls: Sequence[Call], *, name: str = "step",
                  rank: int = 0) -> list[Finding]:
    """DL004 on one rank's record."""
    return [Finding(
        "DL004",
        f"{c.kind} over {c.axis!r} sums in {c.dtype.split('.')[-1]}; upcast "
        "the operand to >=float32 before the reduction and cast back "
        "after", where=f"{name}/rank {rank}#{i}")
        for i, c in enumerate(calls)
        if c.kind in _ACCUMULATING and c.op == "sum"
        and c.dtype in _LOW_FLOATS]


def _fmt(c: Call | None) -> str:
    if c is None:
        return "nothing (the rank issues no further call on the group)"
    return f"{c.kind}@{c.axis} {c.dtype.split('.')[-1]}{list(c.shape)}"


def diverging(records: Mapping[int, Sequence[Call]], *,
              name: str = "step") -> list[Finding]:
    """DL002 over every rank's record of one unit: ``{rank: calls}``."""
    findings = []
    by_group: dict[tuple, dict[int, list]] = {}
    sends: dict[tuple, list] = {}
    recvs: dict[tuple, list] = {}
    for rank, calls in records.items():
        for c in calls:
            if c.kind == "collective-permute":
                for leg, peer in c.peers:
                    (sends if leg == "send" else recvs).setdefault(
                        (rank, peer) if leg == "send" else (peer, rank),
                        []).append(c)
                continue
            if c.group:
                by_group.setdefault(c.group, {}).setdefault(rank, []).append(c)
    for group, per_rank in sorted(by_group.items()):
        members = [r for r in group if r in records]
        seqs = {r: per_rank.get(r, []) for r in members}
        if len(seqs) < 2:
            continue
        ref_rank = members[0]
        ref = seqs[ref_rank]
        for r in members[1:]:
            seq = seqs[r]
            n = max(len(ref), len(seq))
            for i in range(n):
                a = ref[i] if i < len(ref) else None
                b = seq[i] if i < len(seq) else None
                if a is None or b is None or a.signature != b.signature:
                    findings.append(Finding(
                        "DL002",
                        f"ranks {ref_rank} and {r} of group {list(group)} "
                        f"disagree at their call {i} on the group: rank "
                        f"{ref_rank} issues {_fmt(a)}, rank {r} {_fmt(b)}; "
                        "the collective never completes (deadlock)",
                        where=f"{name}/group {list(group)}#{i}"))
                    break
    for pair in sorted(set(sends) | set(recvs)):
        a = [(c.dtype, c.shape) for c in sends.get(pair, [])]
        b = [(c.dtype, c.shape) for c in recvs.get(pair, [])]
        src, dst = pair
        if src in records and dst in records and a != b:
            findings.append(Finding(
                "DL002",
                f"rank {src} sends {len(a)} permute leg(s) to rank {dst} "
                f"but rank {dst} receives {len(b)} from it (or their shapes "
                "differ); a send or a receive never completes",
                where=f"{name}/ranks {src}->{dst}"))
    return findings


def shared_draws(draws: Mapping[int, Sequence[tuple]],
                 groups: Iterable[Sequence[int]], *,
                 name: str = "step") -> list[Finding]:
    """DL003: ranks of one group whose k-th dropout draws come from equal
    generator states (``draws``: ``{rank: [(call index, digest), ...]}``;
    ``groups``: the groups whose ranks must draw differently)."""
    findings = []
    for group in groups:
        members = [r for r in group if draws.get(r)]
        for i, a in enumerate(members):
            for b in members[i + 1:]:
                same = [k for k, (x, y) in enumerate(zip(draws[a], draws[b]))
                        if x[1] == y[1]]
                if same:
                    findings.append(Finding(
                        "DL003",
                        f"ranks {a} and {b} draw dropout masks from the same "
                        f"generator state ({len(same)} of "
                        f"{min(len(draws[a]), len(draws[b]))} draws, first "
                        f"at draw {same[0]}); seed each rank's generator "
                        "from its index (train/trainer.py _node_generator)",
                        where=f"{name}/group {list(group)}"))
    return findings


def lint_records(records: Mapping[int, Recorder], *, name: str = "step",
                 draw_groups: Iterable[Sequence[int]] = (),
                 suppress=()) -> list[Finding]:
    """Every SPMD rule over one unit's records (``{rank: Recorder}``)."""
    findings = []
    for rank, rec in sorted(records.items()):
        findings += unbound_axes(rec.calls, rec.axis_errors, name=name,
                                 rank=rank)
        findings += low_precision(rec.calls, name=name, rank=rank)
    findings += diverging({r: rec.calls for r, rec in records.items()},
                          name=name)
    findings += shared_draws({r: rec.draws for r, rec in records.items()},
                             draw_groups, name=name)
    return filter_suppressed(findings, suppress)
