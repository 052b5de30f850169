"""The port's protocol lint (``distlearn_tpu_torch/lint/protocol.py``,
DL101-DL104) against the JAX package's: the tree and ring schedules built
from the port's topology equal JAX's op for op, every AsyncEA schedule and
every seeded deadlock or desync of ``tests/test_lint_protocol.py`` gives
the same findings in both, and the lock audit gives JAX's findings on the
same sources and none on the port's threaded modules."""

import pytest

pytest.importorskip("torch")

from distlearn_tpu.lint import protocol as jp  # noqa: E402
from distlearn_tpu_torch.lint import protocol as tp  # noqa: E402


def _ops(sched):
    return {r: [(o.kind, o.peer, o.tag, o.timeout) for o in ops]
            for r, ops in sched.items()}


def _found(findings):
    return [(f.rule, f.message, f.where, f.severity) for f in findings]


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_tree_and_ring_schedules_equal_jax(n):
    for base in (2, 3, 4):
        assert _ops(tp.tree_allreduce_schedule(n, base)) == \
            _ops(jp.tree_allreduce_schedule(n, base))
    assert _ops(tp.ring_allreduce_schedule(n)) == \
        _ops(jp.ring_allreduce_schedule(n))
    for mod_sched in ((tp.tree_allreduce_schedule, jp.tree_allreduce_schedule),
                      (tp.ring_allreduce_schedule, jp.ring_allreduce_schedule)):
        for buffered in (True, False):
            assert _found(tp.check_schedules(mod_sched[0](n),
                                             buffered_sends=buffered)) == \
                _found(jp.check_schedules(mod_sched[1](n),
                                          buffered_sends=buffered))


ASYNC_CASES = [
    ("async_ea_sync_schedule", {}),
    ("async_ea_sync_schedule", {"packed": True}),
    ("async_ea_sync_schedule", {"num_leaves": 5}),
    ("async_ea_sync_schedule", {"client_order": ("delta?", "Center?")}),
    ("async_ea_sharded_schedule", {}),
    ("async_ea_sharded_schedule", {"server_timeouts": True,
                                   "truncate_tail": 1}),
    ("async_ea_sharded_schedule", {"truncate_tail": 1}),
    ("async_ea_rejoin_sharded_schedule", {}),
    ("async_ea_failover_schedule", {}),
    ("async_ea_failover_schedule", {"num_shards": 1}),
    ("async_ea_failover_schedule", {"strict": True}),
    ("async_ea_promote_rejoin_schedule", {}),
    ("async_ea_promote_rejoin_schedule", {"num_clients": 5}),
    ("async_ea_stale_epoch_schedule", {}),
    ("async_ea_join_schedule", {}),
    ("async_ea_leave_schedule", {"num_stripes": 2}),
]


@pytest.mark.parametrize("name,kw", ASYNC_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ASYNC_CASES)])
def test_async_ea_schedules_equal_jax(name, kw):
    mine, ref = getattr(tp, name)(**kw), getattr(jp, name)(**kw)
    assert _ops(mine) == _ops(ref)
    for buffered in (True, False):
        assert _found(tp.check_schedules(mine, buffered_sends=buffered,
                                         name=name)) == \
            _found(jp.check_schedules(ref, buffered_sends=buffered,
                                      name=name))


def _seeded(m):
    """The seeded deadlocks and desyncs of tests/test_lint_protocol.py,
    built with package ``m``'s own ops: (schedule, buffered_sends)."""
    s, r, ra = m.send, m.recv, m.recv_any
    return {
        "ring-rendezvous": (m.ring_allreduce_schedule(4), False),
        "recv-first": ({0: [r(1, "x"), s(1, "y")],
                        1: [r(0, "y"), s(0, "x")]}, True),
        "starve": ({0: [s(1, "a")], 1: [r(0, "a"), r(0, "b")]}, True),
        "swapped": (m.async_ea_sync_schedule(
            client_order=("delta?", "Center?")), True),
        "skew": ({0: [s(1, "hdr"), s(1, "tensor")],
                  1: [r(0, "tensor"), r(0, "hdr")]}, True),
        "any-skew": ({0: [s(1, "hdr")], 1: [ra("payload")]}, True),
        "any-skew-rdv": ({0: [s(1, "hdr")], 1: [ra("payload")]}, False),
        "skew-rdv": ({0: [s(1, "a"), r(1, "b")],
                      1: [r(0, "x"), s(0, "b")]}, False),
        "recv-any-either": ({0: [s(2, "hello")], 1: [s(2, "hello")],
                             2: [ra("hello"), ra("hello")]}, False),
        "failover-strict": (m.async_ea_failover_schedule(strict=True), True),
    }


@pytest.mark.parametrize("case", sorted(_seeded(jp)))
def test_seeded_schedules_give_jax_findings(case):
    mine, buffered = _seeded(tp)[case]
    ref, _ = _seeded(jp)[case]
    got = tp.check_schedules(mine, buffered_sends=buffered, name=case)
    assert _found(got) == _found(jp.check_schedules(
        ref, buffered_sends=buffered, name=case))
    if case != "recv-any-either":
        assert got, "a seeded fault must fire"


_BAD_LOCKS = """
class A:
    def f(self):
        with self._a_lock:
            with self._b_lock:
                pass
    def g(self):
        with self._b_lock:
            with self._a_lock:
                pass
"""

_BAD_BLOCKING = """
class B:
    def f(self):
        with self._lock:
            self.conn.recv_msg()
"""

_GOOD_LOCKS = """
class C:
    def f(self):
        with self._a_lock:
            with self._b_lock:
                pass
    def h(self):
        msg = self.conn.recv_msg()
        with self._b_lock:
            self.apply(msg)
    def spawn(self):
        with self._a_lock:
            def worker():
                self.conn.recv_msg()
            return worker
"""

_HALF_A = ("class A:\n    def f(self):\n        with self._a_lock:\n"
           "            with self._b_lock:\n                pass\n")
_HALF_B = ("class A:\n    def g(self):\n        with self._b_lock:\n"
           "            with self._a_lock:\n                pass\n")


@pytest.mark.parametrize("sources", [[_BAD_LOCKS], [_BAD_BLOCKING],
                                     [_GOOD_LOCKS], [_HALF_A, _HALF_B],
                                     [_HALF_A]],
                         ids=["cycle", "blocking", "good", "across",
                              "half"])
def test_lock_audit_gives_jax_findings(sources):
    assert _found(tp.lock_order_audit(sources)) == \
        _found(jp.lock_order_audit(sources))


def test_port_protocols_and_threaded_modules_are_clean():
    from distlearn_tpu_torch.comm import ring, transport, tree
    from distlearn_tpu_torch.parallel import async_ea
    assert tp.lock_order_audit([transport, tree, ring, async_ea]) == []
    assert tp.lint_comm_protocols(num_nodes=7) == []
    assert tp.tree_allreduce_schedule.__module__ == \
        "distlearn_tpu_torch.lint.protocol"
