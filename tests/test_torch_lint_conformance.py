"""The port's conformance lint (``distlearn_tpu_torch/lint/conformance.py``,
DL310): both passes are clean on the port's own sources, the JAX
package's seeded mutations applied to the port's source text fire, and
each gives the JAX package's findings on the counterpart JAX source."""

import inspect

import pytest

pytest.importorskip("torch")

from distlearn_tpu.lint import conformance as jc  # noqa: E402
from distlearn_tpu.lint import protocol as jp  # noqa: E402
from distlearn_tpu_torch.lint import conformance as tc  # noqa: E402
from distlearn_tpu_torch.lint import protocol as tp  # noqa: E402


def _found(findings):
    return [(f.rule, f.message, f.where) for f in findings]


def _sources(pkg):
    from importlib import import_module
    return {name: inspect.getsource(import_module(f"{pkg}.{mod}"))
            for name, mod in (("async_ea", "parallel.async_ea"),
                              ("server", "serve.server"),
                              ("router", "serve.router"),
                              ("client", "serve.client"))}


PORT, JAX = _sources("distlearn_tpu_torch"), _sources("distlearn_tpu")


def test_port_sources_are_conformant():
    assert tc.lint_conformance() == []
    assert tc.lint_serve_frames() == []
    # the passes read the port's own modules
    assert tc.lint_conformance(source=PORT["async_ea"]) == []


def _edit_tag(m):
    sched = m.async_ea_sync_schedule()
    sched["C"] = [m.Op(o.kind, o.peer,
                       "delta2?" if o.tag == "delta?" else o.tag, o.timeout)
                  for o in sched["C"]]
    return {"sync": sched}


SCHEDULE_MUTATIONS = {
    "edited-tag": _edit_tag,
    "swapped-order": lambda m: {"sync": m.async_ea_sync_schedule(
        client_order=("delta?", "Center?"))},
}

SOURCE_MUTATIONS = {
    "renamed-constant": lambda s: s.replace('DELTA_Q = "delta?"',
                                            'DELTA_Q = "delta2?"', 1),
    "unmodeled-type": lambda s: s + '\nSNAPSHOT_Q = "Snapshot?"\n',
    # the client asks delta? before Center?: every send swapped
    "code-swapped-order": lambda s: s.replace(
        "send_msg(CENTER_Q)", "send_msg(@Q)").replace(
        "send_msg(DELTA_Q)", "send_msg(CENTER_Q)").replace(
        "send_msg(@Q)", "send_msg(DELTA_Q)"),
    "dropped-trace-stamp": lambda s: s.replace("TRACE_KEY", "TRACE_KEY_"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_MUTATIONS))
def test_schedule_mutations_fire_as_in_jax(name):
    got = tc.lint_conformance(schedules=SCHEDULE_MUTATIONS[name](tp))
    ref = jc.lint_conformance(schedules=SCHEDULE_MUTATIONS[name](jp))
    assert [f.rule for f in got] and {f.rule for f in got} == {"DL310"}
    assert _found(got) == _found(ref)


@pytest.mark.parametrize("name", sorted(SOURCE_MUTATIONS))
def test_source_mutations_fire_as_in_jax(name):
    mine = SOURCE_MUTATIONS[name](PORT["async_ea"])
    assert mine != PORT["async_ea"]
    got = tc.lint_conformance(source=mine)
    assert got and {f.rule for f in got} == {"DL310"}
    ref = jc.lint_conformance(source=SOURCE_MUTATIONS[name](JAX["async_ea"]))
    assert _found(got) == _found(ref)


def _ghost(src):
    return src + ('\n\ndef _ghost(conn, rid):\n'
                  '    conn.send_stream({"rid": rid, "shard_hint": 1})\n')


def _renamed(srcs):
    return {k: v.replace('"retry_after"', '"retry_after_s"')
            for k, v in srcs.items()}


@pytest.mark.parametrize("name", ["ghost-field", "renamed-field",
                                  "dropped-g-field"])
def test_serve_frame_mutations_fire_as_in_jax(name):
    def apply(srcs):
        if name == "ghost-field":
            srcs = dict(srcs, server=_ghost(srcs["server"]))
        elif name == "renamed-field":
            srcs = _renamed(srcs)
        else:   # an unbound G field a client starts sending
            srcs = dict(srcs, client=srcs["client"] + (
                '\n\ndef _extra(msg):\n    msg["priority"] = 1\n'))
        return dict(server_source=srcs["server"],
                    router_source=srcs["router"],
                    client_source=srcs["client"])
    got = tc.lint_serve_frames(**apply(PORT))
    assert got and {f.rule for f in got} == {"DL310"}
    assert _found(got) == _found(jc.lint_serve_frames(**apply(JAX)))
