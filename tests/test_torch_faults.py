"""The port's fault injection (``distlearn_tpu_torch/comm/faults.py``)
against the JAX package's: the same seed and the same calls give the same
decision log, and a partition under ``op_timeout`` surfaces as
:class:`TimeoutError` from a port tree and ring (the counterpart of
``test_op_timeout_detects_dead_rank``), with tensor leaves on the wire."""

import socket
from contextlib import closing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.comm import faults as jax_faults  # noqa: E402
from distlearn_tpu_torch.comm import faults as port_faults  # noqa: E402
from distlearn_tpu_torch.comm.ring import LocalhostRing  # noqa: E402
from distlearn_tpu_torch.comm.tree import (LocalhostTree,  # noqa: E402
                                           tree_map_spawn)

from tests.net_util import reserve_port_window  # noqa: E402


def _drive(mod, listen_port: int) -> list:
    """One fixed sequence of mutators and dials: scheduled and seeded
    flaky refusals (which never touch the network) and real dials to a
    listening socket, on two links."""
    plan = mod.FaultPlan(seed=7)
    plan.partition("a", "send")
    plan.delay("b", 0.01)
    plan.bandwidth("b", 1e6)
    plan.heal("a")
    plan.fail_dials("a", 2)
    conns = []
    plan.flaky_dials("b", 0.5)
    for link in ("a", "a", "a", "b", "b", "b", "b", "b", "b", "a"):
        try:
            conns.append(plan.connect("127.0.0.1", listen_port, link=link))
        except mod.FaultInjected:
            pass
    plan.flaky_dials("a", 1.0)
    with pytest.raises(mod.FaultInjected):
        plan.connect("127.0.0.1", listen_port, link="a")
    plan.cut_after("b", 64)
    plan.partition("b", "recv")
    for c in conns:
        c.close()
    return plan.decisions()


def test_same_seed_same_calls_same_decisions_as_jax():
    with closing(socket.socket()) as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(64)
        port = srv.getsockname()[1]
        jax_log = _drive(jax_faults, port)
        port_log = _drive(port_faults, port)
    assert port_log == jax_log
    assert any(e == ("b", "dial_refused") for e in port_log)
    assert any(e == ("b", "dial") for e in port_log)


@pytest.mark.parametrize("make", [LocalhostTree, LocalhostRing],
                         ids=["tree", "ring"])
def test_partition_under_op_timeout_raises_timeout(make):
    link = "tree" if make is LocalhostTree else "ring"
    plan = port_faults.FaultPlan(seed=0)
    plan.partition(link)
    port = reserve_port_window(1)
    errs = []

    def node(rank):
        h = make(rank, 2, port, op_timeout=1.0, fault_plan=plan)
        try:
            h.all_reduce({"w": torch.ones(4, dtype=torch.float64)})
        except (TimeoutError, ConnectionError) as e:
            errs.append(type(e))
        finally:
            h.close()

    tree_map_spawn(node, 2, timeout=60)
    assert TimeoutError in errs
    assert plan.dropped_bytes(link) > 0
    assert (link, "partition:both") in plan.decisions()


def test_healed_partition_resumes_the_stream():
    """A recv-side hold keeps the byte stream intact: after ``heal`` the
    held collective completes with the right sum."""
    plan = port_faults.FaultPlan(seed=1)
    port = reserve_port_window(1)

    def node(rank):
        h = LocalhostTree(rank, 2, port, fault_plan=plan if rank == 0
                          else None)
        try:
            if rank == 0:
                plan.partition("tree", "recv")
                import threading
                threading.Timer(0.3, plan.heal, args=("tree",)).start()
            red, m = h.all_reduce(torch.full((3,), float(rank + 1)))
            return red.numpy(), m
        finally:
            h.close()

    for red, m in tree_map_spawn(node, 2, timeout=60):
        np.testing.assert_array_equal(red, 3.0)
        assert m == 2
