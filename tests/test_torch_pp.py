"""Pipeline parallelism on the port — ``parallel/pp.py``'s GPipe and 1F1B
schedules and ``train/lm.py``'s ``build_lm_pp_step`` /
``build_lm_pp_1f1b_step`` — against the JAX package on its CPU mesh.

The port runs as gloo ranks (``tests/torch_mesh_worker.py``; one spawn of
2 ranks and one of 4 serve every case of this file) on the JAX params
(``models/convert.py::lm_pp_shard``) and numpy inputs; the JAX package runs
in this process meanwhile.

Tolerances are the JAX package's own tests':

* ``pipeline_apply`` against running the stages one after another and
  against JAX's ``pipeline_apply`` under ``shard_map``: outputs
  ``rtol=1e-5, atol=1e-6``, gradients ``rtol=1e-4, atol=1e-5``
  (``tests/test_pp.py:43-71``); its two ``ValueError`` messages are JAX's
  word for word (``:74-98``);
* both pp steps against the one-device ``build_lm_step`` of the same
  batch and against JAX's pp step on the same mesh: loss ``rtol=1e-5,
  atol=1e-6``, params ``rtol=1e-4, atol=1e-6``
  (``tests/test_lm_step.py:270-331``, ``:434-445``), k = 2 blocks a stage
  with remat included;
* 1F1B liveness: at S = 4, M = 32, L = 64, dim 64 the peak of the storages
  autograd holds saved during a 1F1B step, plus its ring of ``2S - 1``
  stage inputs, is below 0.6 of GPipe's (``tests/test_lm_step.py:446-469``,
  where JAX compares compiled temp memory).  Both run without remat here:
  ``saved_tensors_hooks`` cannot see what ``torch.utils.checkpoint``
  keeps.
"""

from __future__ import annotations

import functools
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import transformer as jt  # noqa: E402
from distlearn_tpu.parallel import pp as jpp  # noqa: E402
from distlearn_tpu.train import lm as jlm  # noqa: E402

import torch_mesh_worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DIM = 8
PP_NAMES = ("data", "pipe")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# (name, (dp, S), depth, schedule, M, remat, extra step options)
PP_CASES = {
    2: [("gpipe12", (1, 2), 4, "gpipe", 2, False, {}),
        ("f1b12_remat", (1, 2), 4, "1f1b", 4, True, {}),
        ("gpipe21_unroll", (2, 1), 4, "gpipe", 4, False, {"unroll": True})],
    4: [("gpipe22", (2, 2), 4, "gpipe", 2, False, {}),
        ("gpipe14_k2_remat", (1, 4), 8, "gpipe", 4, True, {}),
        ("f1b14", (1, 4), 4, "1f1b", 4, False, {})],
}
# the cases also run through the JAX package's pp step on the same mesh
JAX_PP = {"f1b12_remat", "gpipe22", "f1b14"}
PIPE_CASES = {2: [(2, 8, 16)], 4: [(4, 4, 8)]}   # (S, M, B)


def _stage(params, h):
    return jnp.tanh(h @ params["w"] + params["b"])


def _stacked(S, seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(S, DIM, DIM).astype(np.float32) * 0.5,
            "b": rng.randn(S, DIM).astype(np.float32) * 0.1}


def _pipe_x(B, seed):
    return np.random.RandomState(seed).randn(B, DIM).astype(np.float32)


def _lm(depth):
    return dict(vocab=64, dim=32, depth=depth, heads=2, max_len=16)


@functools.lru_cache(maxsize=None)
def _params(depth):
    model = jt.transformer_lm(**_lm(depth))
    return jax.device_get(model.init(jax.random.PRNGKey(0))[0])


def _tokens():
    return np.random.RandomState(0).randint(0, 64, (8, 16)).astype(np.int32)


def _cases(world):
    cases = []
    for S, M, B in PIPE_CASES[world]:
        st = _stacked(S, seed=S)
        cases.append(dict(name=f"pipe{S}_{M}", kind="pipeline", mesh=(S,),
                          names=("pipe",), w=st["w"], b=st["b"],
                          x=_pipe_x(B, seed=M), M=M))
    for name, shape, depth, sched, M, remat, kw in PP_CASES[world]:
        cases.append(dict(name=name, kind="pp_step", mesh=shape,
                          names=PP_NAMES, cfg=_lm(depth),
                          params=_params(depth), tokens=_tokens(), lr=0.1,
                          schedule=sched, M=M, remat=remat, kw=kw))
    if world == 4:
        cfg = dict(vocab=64, dim=64, depth=4, heads=4, max_len=64)
        model = jt.transformer_lm(**cfg)
        cases.append(dict(
            name="liveness", kind="pp_liveness", mesh=(1, 4),
            names=PP_NAMES, cfg=cfg, M=32,
            params=jax.device_get(model.init(jax.random.PRNGKey(0))[0]),
            tokens=np.zeros((64, 64), np.int32)))
    return cases


# --------------------------------------------------------------------------
# The JAX side
# --------------------------------------------------------------------------

def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_pipeline(S, M, st, x):
    mesh = _jax_mesh((S,), ("pipe",))

    def fn(stacked, xx):
        local = jax.tree_util.tree_map(lambda a: jnp.squeeze(a, 0), stacked)
        return jpp.pipeline_apply(_stage, local, xx, M, axis_name="pipe")
    pipe = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("pipe"), P()),
                                 out_specs=P(), check_vma=False))

    def seq(stacked, xx):
        h = xx
        for s in range(S):
            h = _stage({"w": stacked["w"][s], "b": stacked["b"][s]}, h)
        return h
    out = np.asarray(pipe(st, x))
    g = jax.grad(lambda p: jnp.sum(pipe(p, x) ** 2))(st)
    g_seq = jax.grad(lambda p: jnp.sum(seq(p, x) ** 2))(st)
    return {"out": out, "seq": np.asarray(seq(st, x)),
            "grad": {k: np.asarray(v) for k, v in g.items()},
            "grad_seq": {k: np.asarray(v) for k, v in g_seq.items()}}


def _jax_errors():
    """JAX's messages for a shape-changing stage and for 3 microbatches of
    16 rows, from pipeline_apply and pipeline_1f1b."""
    mesh = _jax_mesh((2,), ("pipe",))
    x = jnp.zeros((16, DIM))
    bad = {"w": jnp.zeros((2, DIM, DIM + 1))}
    out = []
    for stacked, stage, M in ((bad, lambda p, h: h @ p["w"], 2),
                              (_stacked(2, 0), _stage, 3)):
        for fn in ("apply", "1f1b"):
            def body(st, xx, stage=stage, M=M, fn=fn):
                local = jax.tree_util.tree_map(lambda a: jnp.squeeze(a, 0),
                                               st)
                if fn == "apply":
                    return jpp.pipeline_apply(stage, local, xx, M,
                                              axis_name="pipe")
                return jpp.pipeline_1f1b(stage, local,
                                         lambda c, o, m: o.sum(), {}, xx,
                                         M, axis_name="pipe")[0]
            with pytest.raises(ValueError) as e:
                jax.shard_map(body, mesh=mesh, in_specs=(P("pipe"), P()),
                              out_specs=P(), check_vma=False)(stacked, x)
            out.append(str(e.value))
    return out


def _jax_sequential_step(depth, params, tokens):
    """JAX's reference of its pp tests: the one-device build_lm_step."""
    lm = jt.transformer_lm(**_lm(depth))
    mesh1 = _jax_mesh((1, 1, 1), ("data", "seq", "model"))
    step = jlm.build_lm_step(lm, mesh1, params, lr=0.1, donate=False)
    p, loss = step(params, jax.device_put(
        tokens, NamedSharding(mesh1, P("data", "seq"))))
    return float(loss), jax.device_get(p)


def _jax_pp_step(case):
    depth = case["cfg"]["depth"]
    mesh = _jax_mesh(case["mesh"], PP_NAMES)
    shared, stacked = jlm.stack_blocks(case["params"], depth)
    kw = dict(lr=case["lr"], num_microbatches=case["M"],
              remat=case["remat"], donate=False)
    builder = jlm.build_lm_pp_1f1b_step if case["schedule"] == "1f1b" \
        else jlm.build_lm_pp_step
    step = builder(mesh, shared, stacked, **kw, **case["kw"])
    sh, st, loss = step(jax.device_put(shared, NamedSharding(mesh, P())),
                        jax.device_put(stacked,
                                       NamedSharding(mesh, P("pipe"))),
                        jax.device_put(case["tokens"],
                                       NamedSharding(mesh, P("data"))))
    return float(loss), jlm.unstack_blocks(jax.device_get(sh),
                                           jax.device_get(st), depth)


def _references(world, cases):
    def run():
        ref = {"errors": _jax_errors()}
        for c in cases:
            if c["kind"] == "pipeline":
                ref[c["name"]] = _jax_pipeline(
                    c["mesh"][0], c["M"], {"w": c["w"], "b": c["b"]}, c["x"])
            elif c["kind"] == "pp_step":
                depth = c["cfg"]["depth"]
                if f"seq{depth}" not in ref:
                    ref[f"seq{depth}"] = _jax_sequential_step(
                        depth, c["params"], c["tokens"])
                if c["name"] in JAX_PP:
                    ref[c["name"]] = _jax_pp_step(c)
        return ref
    return run


def _spawn(world, tmp_path_factory):
    def compute():
        out_dir = tmp_path_factory.mktemp(f"torch_pp{world}")
        cases = _cases(world)
        ranks, ref = torch_mesh_worker.spawn(world, cases, str(out_dir),
                                             _references(world, cases))
        return ranks, ref, {c["name"]: c for c in cases}
    return torch_mesh_worker.once_per_session(f"torch_pp{world}",
                                              tmp_path_factory, compute)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture
def runs(request):
    return request.getfixturevalue(request.param)


def _sorted_leaves(tree):
    return [(str(p), np.asarray(a)) for p, a in sorted(
        jax.tree_util.tree_flatten_with_path(tree)[0],
        key=lambda t: str(t[0]))]


# --------------------------------------------------------------------------
# pipeline_apply
# --------------------------------------------------------------------------

@pytest.mark.parametrize("runs,S,M", [
    ("two", S, M) for S, M, _ in PIPE_CASES[2]] + [
    ("four", S, M) for S, M, _ in PIPE_CASES[4]], indirect=["runs"])
def test_pipeline_matches_sequential_and_jax(runs, S, M):
    """Every rank returns the last stage's outputs, equal to the stages run
    one after another and to JAX's pipeline; the gradients of sum(out**2)
    are the sequential ones and JAX's."""
    ranks, ref, _ = runs
    want = ref[f"pipe{S}_{M}"]
    for r, res in enumerate(ranks):
        got = res[f"pipe{S}_{M}"]
        np.testing.assert_allclose(got["out"], want["seq"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                                   atol=1e-6)
        for k in ("w", "b"):
            for g in (want["grad_seq"], want["grad"]):
                np.testing.assert_allclose(got[f"g{k}"], g[k][r],
                                           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("runs", ["two", "four"], indirect=True)
def test_pipeline_errors_are_jax_words(runs):
    """A stage that changes the activation's shape and 16 rows asked for in
    3 microbatches raise JAX's ValueErrors word for word, from both
    schedules, on every rank."""
    ranks, ref, _ = runs
    S, M, _ = PIPE_CASES[len(ranks)][0]
    for res in ranks:
        assert res[f"pipe{S}_{M}"]["errors"] == ref["errors"]


# --------------------------------------------------------------------------
# The pp steps
# --------------------------------------------------------------------------

PP_ALL = [("two", c[0]) for c in PP_CASES[2]] + \
    [("four", c[0]) for c in PP_CASES[4]]


@pytest.mark.parametrize("runs,name", PP_ALL, indirect=["runs"])
def test_pp_step_matches_sequential(runs, name):
    """The step's loss and every updated leaf against the one-device
    build_lm_step of the same global batch (JAX's reference)."""
    ranks, ref, cases = runs
    depth = cases[name]["cfg"]["depth"]
    want_loss, want_params = ref[f"seq{depth}"]
    for res in ranks:
        got = res[name]
        np.testing.assert_allclose(got["loss"], want_loss, **LOSS_TOL)
        for (pa, a), (pb, b) in zip(_sorted_leaves(want_params),
                                    _sorted_leaves(got["params"])):
            assert pa == pb
            np.testing.assert_allclose(b, a, err_msg=pa, **PARAM_TOL)


@pytest.mark.parametrize("runs,name", [(r, n) for r, n in PP_ALL
                                       if n in JAX_PP], indirect=["runs"])
def test_pp_step_matches_jax_pp_step(runs, name):
    ranks, ref, _ = runs
    want_loss, want_params = ref[name]
    for res in ranks:
        got = res[name]
        np.testing.assert_allclose(got["loss"], want_loss, **LOSS_TOL)
        for (pa, a), (pb, b) in zip(_sorted_leaves(want_params),
                                    _sorted_leaves(got["params"])):
            np.testing.assert_allclose(b, a, err_msg=pa, **PARAM_TOL)


def test_1f1b_liveness_beats_gpipe(four):
    """At M = 32 over 4 stages 1F1B holds a tick's graph and its ring of
    stage inputs; GPipe holds every tick's residuals."""
    ranks, _, _ = four
    for res in ranks:
        got = res["liveness"]
        assert got["1f1b"] + got["ring"] < 0.6 * got["gpipe"], got


# --------------------------------------------------------------------------
# Checks in one process
# --------------------------------------------------------------------------

def test_pp_step_checks_are_jax_words():
    """The shared-key and microbatch checks raise the JAX step's errors."""
    import torch.distributed as dist

    from distlearn_tpu_torch.models.convert import lm_from_jax
    from distlearn_tpu_torch.parallel.mesh import init_named_mesh
    from distlearn_tpu_torch.train import lm as tlm
    params = _params(2)
    shared, stacked = jlm.stack_blocks(params, 2)
    jmesh = _jax_mesh((1, 1), PP_NAMES)
    mesh = init_named_mesh((1, 1), PP_NAMES, store=dist.HashStore(),
                           device="cpu")
    try:
        tsh, tst = tlm.stack_blocks(lm_from_jax(params), 2)
        toks = _tokens()
        for builder, jbuilder in ((tlm.build_lm_pp_step,
                                   jlm.build_lm_pp_step),
                                  (tlm.build_lm_pp_1f1b_step,
                                   jlm.build_lm_pp_1f1b_step)):
            with pytest.raises(ValueError) as want:
                jbuilder(jmesh, {k: v for k, v in shared.items()
                                 if k != "pos"}, stacked, lr=0.1,
                         num_microbatches=2)
            with pytest.raises(ValueError) as got:
                builder(mesh, {k: v for k, v in tsh.items() if k != "pos"},
                        tst, lr=0.1, num_microbatches=2)
            assert str(got.value) == str(want.value)
            jstep = jbuilder(jmesh, shared, stacked, lr=0.1,
                             num_microbatches=3, donate=False)
            with pytest.raises(ValueError) as want:
                jstep(shared, stacked, toks)
            with pytest.raises(ValueError) as got:
                builder(mesh, tsh, tst, lr=0.1, num_microbatches=3)(
                    tsh, tst, torch.from_numpy(toks))
            assert str(got.value) == str(want.value)
    finally:
        dist.destroy_process_group()


def test_pp_depth_check_matches_jax_on_two_stages():
    """JAX's depth error for 3 blocks over two stages, word for word (the
    port's check reads the pipe axis's size and the template's shapes)."""
    from distlearn_tpu_torch.parallel.mesh import Mesh
    from distlearn_tpu_torch.train import lm as tlm
    shared, stacked = jlm.stack_blocks(_params(3), 3)
    with pytest.raises(ValueError) as want:
        jlm.build_lm_pp_step(_jax_mesh((1, 2), PP_NAMES), shared, stacked,
                             lr=0.1, num_microbatches=2)

    class TwoStages(Mesh):      # a mesh whose pipe axis has two ranks
        def __init__(self):
            pass

        def axis_size(self, name):
            return 2
    with pytest.raises(ValueError) as got:
        tlm._pp_checks(TwoStages(), shared, stacked, "pipe")
    assert str(got.value) == str(want.value)


def test_pp_stage_layout_round_trips():
    """lm_pp_shard hands pipe rank s rows [s*k, (s+1)*k) of the stacked
    blocks and the shared leaves whole; lm_pp_gather puts them back."""
    import torch.distributed as dist

    from distlearn_tpu_torch.models.convert import lm_pp_gather, lm_pp_shard
    from distlearn_tpu_torch.parallel.mesh import init_named_mesh
    params = _params(4)
    mesh = init_named_mesh((1, 1), PP_NAMES, store=dist.HashStore(),
                           device="cpu")
    try:
        shared, stacked = lm_pp_shard(params, mesh, 4)
        jsh, jst = jlm.stack_blocks(params, 4)
        for a, b in zip(jax.tree_util.tree_leaves(jst),
                        [stacked[k][n] if isinstance(stacked[k], dict)
                         else stacked[k] for k in sorted(stacked)
                         for n in (sorted(stacked[k])
                                   if isinstance(stacked[k], dict)
                                   else [None])]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        back = lm_pp_gather(shared, stacked, mesh, 4)
        for (pa, a), (pb, b) in zip(_sorted_leaves(params),
                                    _sorted_leaves(back)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The example's flags
# --------------------------------------------------------------------------

PP_FLAG_CASES = (
    ["--pp", "2", "--sp", "2"],
    ["--pp", "3", "--depth", "4"],
    ["--pp", "2", "--accumSteps", "2"],
    ["--pp", "2", "--optimizer", "adam"],
    ["--pp", "2", "--zero"],
    ["--pp", "2", "--rematMode", "mlp"],
    ["--pp", "2", "--mixed"],
    ["--pp", "2", "--scanBlocks"],
    ["--pp", "2", "--seqLayout", "zigzag"],
    ["--pp", "2", "--serve", "2"],
    ["--ppSchedule", "interleaved"],
)


#: the port example's mesh defaults, given to both (JAX's are 2, 2, 2)
MESH_1 = ["--dp", "1", "--sp", "1", "--tp", "1"]


def _jax_example_exit(argv, monkeypatch):
    """The JAX example's SystemExit message for ``argv`` (its flag checks
    run before it touches a device)."""
    monkeypatch.setattr(sys, "argv", ["lm.py"] + MESH_1 + argv)
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    with pytest.raises(SystemExit) as e:
        runpy.run_path(str(ROOT / "examples" / "lm.py"),
                       run_name="__main__")
    return str(e.value)


@pytest.mark.parametrize("argv", PP_FLAG_CASES, ids=" ".join)
def test_example_pp_flags_follow_jax_checks(argv, monkeypatch):
    from distlearn_tpu_torch.examples import lm
    want = _jax_example_exit(argv, monkeypatch)
    with pytest.raises(SystemExit) as got:
        lm.parse(["--steps", "1"] + MESH_1 + argv)
    assert str(got.value) == want


def test_example_trains_both_schedules(capfd, monkeypatch):
    """--pp 2 with each schedule: 2 gloo ranks train 3 steps, the same
    loss line (the two schedules compute one update)."""
    import re

    from distlearn_tpu_torch.examples import lm
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = []
    for sched in ("gpipe", "1f1b"):
        assert lm.main(["--device", "cpu", "--pp", "2", "--ppSchedule",
                        sched, "--steps", "3", "--dim", "32", "--depth",
                        "2", "--seqLen", "32", "--vocab", "32",
                        "--batchSize", "4", "--microbatches", "2"]) == 0
        out = capfd.readouterr().out
        assert "mesh dp=1 pipe=2" in out
        lines.append(re.search(r"step 3: loss (\d+\.\d+)", out).group(1))
    assert lines[0] == lines[1], lines
