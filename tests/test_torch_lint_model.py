"""The port's model checker (``distlearn_tpu_torch/lint/model.py``,
DL301-DL304) against the JAX package's: every builtin model and each
mutation knob of ``tests/test_lint_model.py`` explores the same number of
states and transitions and reports the same findings in both packages
(JAX's numbers are read at test time)."""

import pytest

pytest.importorskip("torch")

from distlearn_tpu.lint import model as jm  # noqa: E402
from distlearn_tpu_torch.lint import model as tm  # noqa: E402

#: (builder, kwargs, the rule the mutation must fire, or None)
CASES = [
    ("sync_model", {}, None),
    ("sharded_model", {}, None),
    ("replay_model", {}, None),
    ("failover_model", {}, None),
    ("serve_model", {}, None),
    ("membership_model", {}, None),
    ("router_model", {}, None),
    ("backend_sync_model", {"backend": "host"}, None),
    ("backend_sync_model", {"backend": "hybrid"}, None),
    ("sync_model", {"server_timeouts": False}, "DL301"),
    ("sharded_model", {"server_timeouts": False}, "DL301"),
    ("backend_sync_model", {"backend": "host", "host_timeouts": False},
     "DL301"),
    ("backend_sync_model", {"backend": "hybrid", "host_timeouts": False},
     "DL301"),
    ("replay_model", {"ledger": False}, "DL303"),
    ("failover_model", {"fence": False}, "DL302"),
    ("serve_model", {"finish_on_evict": False}, "DL304"),
    ("membership_model", {"join_fence": False}, "DL302"),
    ("membership_model", {"leave_flush": False}, "DL303"),
    ("membership_model", {"renorm": False}, "DL304"),
    ("router_model", {"retry": False}, "DL301"),
    ("router_model", {"fence": False}, "DL302"),
    ("router_model", {"single_dispatch": False}, "DL303"),
]


def _report(rep):
    return (rep.states, rep.transitions,
            [(f.rule, f.message, f.where, f.severity) for f in rep.findings])


@pytest.mark.parametrize("builder,kw,rule", CASES,
                         ids=[f"{b}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for b, kw, _ in CASES])
def test_model_explores_as_jax(builder, kw, rule):
    mine = tm.check_model(getattr(tm, builder)(**kw))
    ref = jm.check_model(getattr(jm, builder)(**kw))
    assert _report(mine) == _report(ref)
    assert sorted({f.rule for f in mine.findings}) == \
        ([rule] if rule else [])


def test_builtin_models_match_jax_and_overflow_is_reported():
    mine = [(spec.name, rep.info, len(rep.findings))
            for rep, spec in tm.lint_models()]
    ref = [(spec.name, rep.info, len(rep.findings))
           for rep, spec in jm.lint_models()]
    assert mine == ref and len(mine) == 9
    assert all(n == 0 for _name, _info, n in mine)
    over = tm.check_model(tm.sharded_model(), max_states=10)
    assert _report(over) == _report(jm.check_model(jm.sharded_model(),
                                                   max_states=10))
    assert "state space exceeded" in over.findings[0].message
