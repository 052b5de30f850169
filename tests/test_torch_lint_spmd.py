"""The port's SPMD and cost rules (``distlearn_tpu_torch/lint/{spmd,cost,
budget}.py``): the counterparts of ``tests/test_lint_spmd.py``'s fire and
quiet cases read from the collectives 4 gloo ranks record
(``tests/torch_lint_worker.py``) — DL001 (an axis the mesh lacks, a group
of no axis), DL002 (ranks that disagree on a call or a permute leg), DL003
(dropout drawn from one generator state on every rank), DL004 (a float16
or bfloat16 sum) — the record against ``Mesh.stats``, DL202 on a rank's
shard, the lockfile rules DL203-DL205, and DL209 against the JAX
package's pass on the same sources."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu_torch.lint import budget, cost, spmd  # noqa: E402
from distlearn_tpu_torch.lint.core import RULES  # noqa: E402

from tests import torch_lint_worker, torch_mesh_worker  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute():
        out = tmp_path_factory.mktemp("lint_ranks")
        return torch_lint_worker.spawn(str(out))
    return torch_mesh_worker.once_per_session("torch_lint_spmd",
                                              tmp_path_factory, compute)


def _lint(ranks, case):
    got = {r: res[case] for r, res in enumerate(ranks)}
    groups = next(iter(got.values())).get("draw_groups", ())
    return spmd.lint_records({r: g["rec"] for r, g in got.items()},
                             name=case, draw_groups=groups)


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.mark.parametrize("case,rules", [
    ("psum_quiet", []), ("unknown_axis", ["DL001"]),
    ("stray_group", ["DL001"]), ("diverge_shape", ["DL002"]),
    ("diverge_extra", ["DL002"]), ("permute_unmatched", ["DL002"]),
    ("permute_quiet", []), ("bf16_psum", ["DL004"]), ("bf16_max", []),
    ("f32_upcast", []), ("dropout_shared", ["DL003"]),
    ("dropout_per_node", []), ("stats", []),
])
def test_rules_fire_and_stay_quiet(ranks, case, rules):
    findings = _lint(ranks, case)
    assert _rules(findings) == rules, [str(f) for f in findings]
    for f in findings:
        assert f.rule in RULES and f.severity == "error"


def test_records_name_axes_and_bytes(ranks):
    recs = [res["psum_quiet"]["rec"] for res in ranks]
    assert [[(c.kind, c.axis, c.shape, c.bytes) for c in r.calls]
            for r in recs] == [[("all-reduce", "data", (8,), 32),
                                ("all-reduce", "model", (4,), 16)]] * 4
    assert ranks[0]["axes"] == ["data", "model"]
    div = _lint(ranks, "diverge_shape")
    assert "float32[4]" in div[0].message and "float32[8]" in div[0].message
    assert [c.axis for c in ranks[0]["stray_group"]["rec"].calls] == \
        [spmd.UNBOUND]
    assert "no mesh axis 'model'" in _lint(ranks, "unknown_axis")[0].message


#: ``Mesh.stats`` kinds as the record names them (gloo has no
#: reduce-scatter: ``psum_scatter`` is an allreduce and a slice)
STATS_KINDS = {"psum": "all-reduce", "ppermute": "collective-permute",
               "all_to_all": "all-to-all", "all_gather": "all-gather",
               "psum_scatter": "all-reduce"}


def test_record_sees_every_mesh_collective(ranks):
    for res in ranks:
        calls, nbytes = res["stats"]["stats"]
        rep = cost.report_from_record("stats", res["stats"]["rec"].calls)
        want_calls, want_bytes = {}, {}
        for k, n in calls.items():
            kind = STATS_KINDS[k]
            want_calls[kind] = want_calls.get(kind, 0) + n
            want_bytes[kind] = want_bytes.get(kind, 0) + nbytes[k]
        assert rep.ops_by_kind == want_calls
        assert rep.bytes_by_kind == want_bytes
        assert sum(calls.values()) == 5


def _lm_whole():
    from distlearn_tpu_torch.models.transformer import (param_specs,
                                                        transformer_lm)
    whole = transformer_lm(vocab=32, dim=64, depth=2, heads=4,
                           max_len=32).init(0, device="cpu")[0]
    return whole, param_specs(whole, "model")


def _narrow(tree, specs, n=2, i=0):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _narrow(v, specs[k], n, i)
            continue
        for dim, axis in enumerate(specs[k]):
            if axis:
                v = v.narrow(dim, i * (v.shape[dim] // n), v.shape[dim] // n)
        out[k] = v
    return out


def test_dl202_whole_leaf_on_a_sharded_spec():
    whole, specs = _lm_whole()
    assert cost.replicated_params(_narrow(whole, specs), whole, specs,
                                  {"model": 2}) == []
    fs = cost.replicated_params(whole, whole, specs, {"model": 2})
    assert _rules(fs) == ["DL202"]
    assert {f.where.split(":")[1].split("/")[-1] for f in fs} == \
        {"wq", "wk", "wv", "wo", "w1", "b1", "w2"}
    # on a one-rank axis nothing is split
    assert cost.replicated_params(whole, whole, specs, {"model": 1}) == []


def _report(name, calls, peak=None):
    return cost.CostReport(name=name, collectives=[
        cost.CollectiveOp(k, b, ("data",), "f32[]") for k, b in calls],
        memory=None if peak is None else {"peak": peak})


def test_budget_rules_fire_and_keep_the_card_figures(tmp_path):
    base = {"u": _report("u", [("all-reduce", 1000)], peak=10_000)}
    budget.save_budget("fam", base, budget_dir=str(tmp_path))
    assert budget.check_family("fam", base, budget_dir=str(tmp_path)) == []
    over = {"u": _report("u", [("all-reduce", 1300)])}
    assert _rules(budget.check_family("fam", over,
                                      budget_dir=str(tmp_path))) == ["DL203"]
    new_kind = {"u": _report("u", [("all-reduce", 1000),
                                   ("all-gather", 8)])}
    fs = budget.check_family("fam", new_kind, budget_dir=str(tmp_path))
    assert _rules(fs) == ["DL203", "DL205"]
    more_ops = {"u": _report("u", [("all-reduce", 500)] * 2)}
    assert _rules(budget.check_family("fam", more_ops,
                                      budget_dir=str(tmp_path))) == ["DL205"]
    fat = {"u": _report("u", [("all-reduce", 1000)], peak=14_000)}
    assert _rules(budget.check_family("fam", fat,
                                      budget_dir=str(tmp_path))) == ["DL204"]
    assert budget.check_family("none", base,
                               budget_dir=str(tmp_path))[0].rule == "DL203"
    # a CPU re-baseline (no peak) keeps the committed card figure
    base["u"].memory_device = "card, 700 W"
    budget.save_budget("fam", base, budget_dir=str(tmp_path))
    budget.save_budget("fam", over, budget_dir=str(tmp_path))
    entry = budget.load_budget("fam", str(tmp_path))["units"]["u"]
    assert (entry["peak_bytes"], entry["memory_device"],
            entry["collective_bytes"]) == (10_000, "card, 700 W",
                                           {"all-reduce": 1300})
    assert budget.DEFAULT_TOLERANCE == {"bytes": 0.25, "memory": 0.35}


def _tick_sources(pkg):
    from importlib import import_module
    return [(inspect.getsource(import_module(f"{pkg}.serve.{m}")), m)
            for m in ("engine", "scheduler", "prefix_cache", "speculate")]


def _dl209(findings):
    """Rule, place and finding, less the advice (the port has no jitted
    tick program to move the math into)."""
    return [(f.rule, f.where, f.message.split(" — ")[0]) for f in findings]


def test_dl209_gives_jax_findings():
    from distlearn_tpu.lint.cost import lint_tick_loop as jax_tick_loop
    mine, ref = _tick_sources("distlearn_tpu_torch"), \
        _tick_sources("distlearn_tpu")
    assert cost.lint_tick_loop() == []
    for srcs in (mine, ref):
        assert _dl209(cost.lint_tick_loop(srcs)) == \
            _dl209(jax_tick_loop(srcs))
    eng = mine[0][0].replace(
        "        c = self.cache\n        runnable =",
        "        c = self.cache\n        np.exp(c.lengths)\n        runnable =",
        1)
    assert eng != mine[0][0]
    fs = cost.lint_tick_loop([(eng, "engine")])
    assert _rules(fs) == ["DL209"] and "np.exp" in fs[0].message
    assert _dl209(fs) == _dl209(jax_tick_loop([(eng, "engine")]))


def test_dry_record_issues_nothing():
    """Outside a process group a dry record still records, and a note from
    the stacked-rows backend lands in every open record."""
    from distlearn_tpu_torch.comm.backend import MeshBackend
    mb = MeshBackend(num_nodes=4, device="cpu")
    val = {"w": torch.ones(4, 3)}
    with spmd.record(rank=0) as outer, spmd.record(rank=0, dry=True) as rec:
        out, n = mb.all_reduce(val, contrib=np.array([1, 0, 1, 1]))
    assert n == 3 and torch.equal(out["w"][0], torch.full((3,), 3.0))
    assert [(c.kind, c.axis, c.bytes) for c in rec.calls] == \
        [("all-reduce", "data", 12)] == \
        [(c.kind, c.axis, c.bytes) for c in outer.calls]
    assert spmd._ACTIVE == []
