"""The LM's optimizer steps on the port — ``train/optim.py``'s optax and
mixed optax steps, ZeRO-1 over the data axis and over the (data, seq,
model) mesh, FSDP — and ``parallel/mesh.py``'s ``psum_scatter_raw`` and
autograd ``all_gather`` under them, against the JAX package on its CPU
mesh.

The port runs as gloo ranks (``tests/torch_mesh_worker.py``; one spawn of
2 ranks and one of 4 serve every case of this file) on the JAX params and
numpy batches; the JAX package runs in this process meanwhile.  Adam is
the port's ``optim.adam``, held step by step against ``optax.adam`` in
``tests/test_torch_optim.py``.

Tolerances are the JAX package's own tests':

* ZeRO-1 on 4 data ranks against the single-device float32-master oracle
  (``tests/test_optax_step.py:171-189``): loss ``rtol=1e-5``, params
  ``rtol=1e-5, atol=1e-6`` (``:206-227``); bfloat16 params: the master
  ``rtol=5e-2, atol=5e-3`` and the params stay bfloat16 (``:230-258``);
  the state 1/N a rank (``:261-282``).  The port's initial master and
  Adam rows equal the JAX state's rows bit for bit, and a JAX state after
  one step carried across (``models/convert.py::lm_zero_from_jax``) trains
  on to JAX's third step within the oracle tolerance;
* ZeRO-1 on the (2, 1, 2) mesh against the oracle: loss ``rtol=1e-5``,
  params ``rtol=2e-5, atol=2e-6`` (``:285-322``);
* the replicated optax step on (2, 2, 1) against single-device optax: the
  same (``:325-362``), the optimizer state equal on every rank; MoE with
  the balance loss trains (``:365-389``);
* the mixed optax step with float32 working params against the plain one:
  loss ``rtol=1e-6``, masters ``rtol=1e-6, atol=1e-7``
  (``tests/test_lm_step.py:178-207``);
* FSDP against ``build_lm_step`` on the same ranks: loss ``rtol=1e-6``,
  params ``rtol=1e-5, atol=1e-6`` (``tests/test_optax_step.py:436-477``);
  storage 1/N of every divisible leaf; trains (``:480-512``);
  ``accum_steps=2`` against one shot ``rtol=1e-6`` / ``rtol=1e-5,
  atol=1e-7`` (``:515-545``); against JAX's FSDP step, float32 across the
  packages ``rtol=1e-4, atol=1e-6`` (``tests/test_torch_mesh_lm.py``).
"""

from __future__ import annotations

import os
import pickle
import runpy
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import transformer as jt  # noqa: E402
from distlearn_tpu.ops import flatten as jflat  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree  # noqa: E402
from distlearn_tpu.train import optim as jopt  # noqa: E402

import torch_mesh_worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("data", "seq", "model")
XTOL = dict(rtol=1e-4, atol=1e-6)
LMZ = dict(vocab=64, dim=32, depth=2, heads=4, max_len=16)
LMZ32 = dict(LMZ, max_len=32)
MIXED = dict(vocab=32, dim=32, depth=1, heads=2, max_len=32)
MOE = dict(vocab=32, dim=32, depth=2, heads=4, max_len=16, moe_experts=4,
           moe_every=2)
FSDP = dict(vocab=32, dim=32, depth=2, heads=4, max_len=32)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _params(cfg, seed=0, dtype=jnp.float32):
    model = jt.transformer_lm(dtype=dtype, **cfg)
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed))[0])


def _f32(tree):
    """bfloat16 numpy leaves as float32 (exact), which torch can read."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _toks(shape, seed, vocab):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.int32)


def _cases(world, out_dir):
    if world == 2:
        base = _toks((1, 16), 1, 32)
        fs = dict(FSDP, dim=64)
        cases = [dict(name="moe_optax", kind="lm_optax", mesh=(2, 1, 1),
                      names=NAMES, cfg=MOE, params=_params(MOE, 1)[1],
                      tokens=np.tile(base, (4, 1)), lr=3e-3, steps=20,
                      kw={"moe_balance_weight": 0.01}),
                 dict(name="fsdp_trains", kind="lm_fsdp", mesh=(2,),
                      names=("data",), cfg=fs, params=_params(fs)[1],
                      tokens=np.tile(_toks((1, 32), 0, 32), (2, 1)),
                      lr=0.1, steps=12)]
        for k in (1, 2):
            cfg = dict(FSDP, depth=1, heads=2)
            cases.append(dict(name=f"fsdp_accum{k}", kind="lm_fsdp",
                              mesh=(2,), names=("data",), cfg=cfg,
                              params=_params(cfg)[1], accum=k,
                              tokens=_toks((4, 32), 0, 32), lr=0.1,
                              steps=1))
        return cases
    _, p0 = _params(LMZ)
    t0 = _toks((8, 16), 0, 64)
    _, pb = _params(LMZ, 1, jnp.bfloat16)
    _, p32 = _params(LMZ32)
    _, pm = _params(MIXED)
    _, pf = _params(FSDP)
    zero = dict(kind="lm_zero", mesh=(4,), names=("data",), cfg=LMZ,
                lr=1e-3)
    return [
        dict(zero, name="zero_f32", params=p0, tokens=t0, steps=3),
        dict(zero, name="zero_bf16", params=_f32(pb), dtype="bfloat16",
             tokens=_toks((8, 16), 1, 64), steps=3),
        dict(zero, name="zero_mesh", mesh=(2, 1, 2), names=NAMES, cfg=LMZ32,
             params=p32, tokens=_toks((8, 32), 0, 64), steps=3),
        dict(name="optax", kind="lm_optax", mesh=(2, 2, 1), names=NAMES,
             cfg=LMZ32, params=p32, tokens=_toks((8, 32), 0, 64), lr=1e-3,
             steps=3),
        dict(name="plain_adam", kind="lm_optax", mesh=(2, 2, 1),
             names=NAMES, cfg=MIXED, params=pm, tokens=_toks((4, 32), 0, 32),
             lr=1e-2, steps=3),
        dict(name="mixed_adam", kind="lm_optax", mesh=(2, 2, 1),
             names=NAMES, cfg=MIXED, params=pm, tokens=_toks((4, 32), 0, 32),
             lr=1e-2, steps=3, mixed=True),
        dict(name="fsdp", kind="lm_fsdp", mesh=(4,), names=("data",),
             cfg=FSDP, params=pf, tokens=_toks((4, 32), 0, 32), lr=0.1,
             steps=1, ref=True),
        # last: the ranks read JAX's state from the file the references
        # write first, so that the two overlap
        dict(zero, name="zero_from_jax", params=p0, tokens=t0, steps=2,
             jax_state_file=f"{out_dir}/jax_zero_state.pkl"),
    ]


# --------------------------------------------------------------------------
# The JAX side
# --------------------------------------------------------------------------

def _oracle(cfg, params, tokens, lr, steps, dtype=jnp.float32):
    """``tests/test_optax_step.py::_lm_zero_oracle``: one device, the
    global batch's gradient packed float32, Adam against the float32
    master, params unpacked in the model dtype."""
    lm = jt.transformer_lm(dtype=dtype, **cfg)
    tx = optax.adam(lr)
    spec = jflat.make_spec(params)
    master = jflat.pack(spec, params)
    state = tx.init(master)
    toks = jnp.asarray(tokens)
    grad = jax.jit(jax.value_and_grad(
        lambda q: jt.lm_loss(lm, q, toks, seq_axis=None, tp_axis=None)))
    p = params
    for _ in range(steps):
        loss, g = grad(p)
        u, state = tx.update(jflat.pack(spec, g), state, master)
        master = master + u
        p = jflat.unpack(spec, master)
    return float(loss), jax.device_get(p), np.asarray(master)


def _jax_zero_states(params, tokens):
    """JAX's LM ZeRO-1 state on 4 nodes: at init, after one step and after
    three (with the third step's loss)."""
    tree = MeshTree(num_nodes=4)
    lm = jt.transformer_lm(**LMZ)
    tx = optax.adam(1e-3)
    st = jopt.init_lm_zero_state(params, tree, tx)
    step = jopt.build_lm_zero_step(lm, tree, tx, donate=False)
    tok = jax.device_put(tokens, NamedSharding(tree.mesh, P("data")))
    init = jax.device_get(st)
    st, _ = step(st, tok)
    one = jax.device_get(st)
    for _ in range(2):
        st, loss = step(st, tok)
    return one, init, (float(loss), jax.device_get(st))


def _portable(st):
    """A JAX LMZeroState with plain containers (the optimizer state as its
    leaf list), so that a rank process unpickles it without JAX."""
    return types.SimpleNamespace(
        params=st.params, master=np.asarray(st.master),
        opt_state=[np.asarray(a) for a in
                   jax.tree_util.tree_leaves(st.opt_state)])


def _jax_zero_mesh_init(params):
    mesh = _jax_mesh((2, 1, 2), NAMES)
    sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                jt.param_specs(params, tp_axis="model"))
    st = jopt.init_lm_zero_mesh_state(jax.device_put(params, sh), mesh,
                                      optax.adam(1e-3))
    return np.asarray(st.master), [np.asarray(a) for a in
                                   jax.tree_util.tree_leaves(st.opt_state)]


def _jax_fsdp(params, tokens):
    mesh = _jax_mesh((4,), ("data",))
    lm = jt.transformer_lm(**FSDP)
    step = jopt.build_lm_fsdp_step(lm, mesh, params, lr=0.1, donate=False)
    p, loss = step(jopt.init_lm_fsdp_params(params, mesh),
                   jax.device_put(tokens, NamedSharding(mesh, P("data"))))
    return float(loss), jax.device_get(p)


def _jax_moe_first_loss(params, tokens):
    """The MoE optax step's first loss: the mean over the two data rows'
    blocks of each block's loss with its balance term."""
    lm = jt.transformer_lm(**MOE)
    f = jax.jit(lambda p, t: jt.lm_loss(lm, p, t, moe_balance_weight=0.01))
    return float(np.mean([f(params, tokens[i * 2:(i + 1) * 2])
                          for i in range(2)]))


def _references(world, cases):
    def run():
        by = {c["name"]: c for c in cases}
        if world == 2:
            c = by["moe_optax"]
            return {"moe_first": _jax_moe_first_loss(c["params"],
                                                     c["tokens"])}
        ref = {}
        c = by["zero_from_jax"]
        one, ref["zero_init"], ref["zero_three"] = _jax_zero_states(
            c["params"], c["tokens"])
        path = c["jax_state_file"]
        with open(path + ".tmp", "wb") as f:
            pickle.dump(_portable(one), f)
        os.replace(path + ".tmp", path)
        c = by["zero_f32"]
        ref["zero_oracle"] = _oracle(LMZ, c["params"], c["tokens"], 1e-3, 3)
        c = by["zero_bf16"]
        pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    c["params"])
        ref["zero_bf16"] = _oracle(LMZ, pb, c["tokens"], 1e-3, 3,
                                   jnp.bfloat16)
        c = by["zero_mesh"]
        ref["mesh_oracle"] = _oracle(LMZ32, c["params"], c["tokens"], 1e-3,
                                     3)
        ref["mesh_init"] = _jax_zero_mesh_init(c["params"])
        c = by["fsdp"]
        ref["fsdp"] = _jax_fsdp(c["params"], c["tokens"])
        return ref
    return run


def _spawn(world, tmp_path_factory):
    def compute():
        out_dir = tmp_path_factory.mktemp(f"torch_optim_lm{world}")
        cases = _cases(world, out_dir)
        ranks, ref = torch_mesh_worker.spawn(world, cases, str(out_dir),
                                             _references(world, cases))
        return ranks, ref, {c["name"]: c for c in cases}
    return torch_mesh_worker.once_per_session(f"torch_optim_lm{world}",
                                              tmp_path_factory, compute)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _leaves(tree):
    return [np.asarray(a, np.float32) if np.asarray(a).dtype != np.float64
            else np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


# --------------------------------------------------------------------------
# ZeRO-1
# --------------------------------------------------------------------------

def test_lm_zero_step_matches_replicated_oracle_f32(four):
    ranks, ref, _ = four
    l_ref, p_ref, _ = ref["zero_oracle"]
    for res in ranks:
        got = res["zero_f32"]
        np.testing.assert_allclose(got["losses"][-1], l_ref, rtol=1e-5)
        for a, b in zip(_leaves(p_ref), _leaves(got["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_lm_zero_state_rows_are_the_jax_state_rows(four):
    """init_lm_zero_state's master slice and Adam state (count, mu, nu) are
    row r of JAX's [4, chunk] state, bit for bit: the padded layout is
    JAX's, rounded up to the node count."""
    ranks, ref, _ = four
    init = ref["zero_init"]
    jopt_leaves = [np.asarray(a) for a in
                   jax.tree_util.tree_leaves(init.opt_state)]
    for r, res in enumerate(ranks):
        got = res["zero_f32"]
        np.testing.assert_array_equal(got["init_master"],
                                      np.asarray(init.master)[r])
        assert len(got["init_opt"]) == len(jopt_leaves)
        for a, b in zip(got["init_opt"], jopt_leaves):
            np.testing.assert_array_equal(a, b[r])


def test_lm_zero_trains_on_from_a_jax_state(four):
    """A JAX state after one step, carried across row by row, trains two
    more port steps to JAX's third (the oracle's tolerance), and the
    port's rows stack back into JAX's layout."""
    ranks, ref, _ = four
    loss3, st3 = ref["zero_three"]
    masters = []
    for res in ranks:
        got = res["zero_from_jax"]
        np.testing.assert_allclose(got["losses"][-1], loss3, rtol=1e-5)
        for a, b in zip(_leaves(st3.params), _leaves(got["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        master, opt = got["stacked"]
        assert master.shape == (1,) + got["master"].shape
        assert [o.shape[0] for o in opt] == [1] * len(opt)
        masters.append(master[0])
    np.testing.assert_allclose(np.stack(masters), np.asarray(st3.master),
                               rtol=1e-5, atol=1e-6)


def test_lm_zero_step_bf16_params_f32_master(four):
    ranks, ref, _ = four
    _, _, m_ref = ref["zero_bf16"]
    m = np.concatenate([res["zero_bf16"]["master"] for res in ranks]
                       )[:m_ref.size]
    np.testing.assert_allclose(m, m_ref, rtol=5e-2, atol=5e-3)
    for res in ranks:
        assert res["zero_bf16"]["dtypes"] == ["torch.bfloat16"]


def test_lm_zero_state_memory_is_sharded(four):
    """Each rank holds a 1/N slice: master and every Adam moment [chunk],
    chunk * N >= the padded packed size, chunk <= padded/N + 1024."""
    ranks, _, cases = four
    spec = jflat.make_spec(cases["zero_f32"]["params"])
    chunk = ranks[0]["zero_f32"]["master"].shape[0]
    assert chunk * 4 >= spec.padded
    assert chunk <= spec.padded // 4 + 1024
    for res in ranks:
        got = res["zero_f32"]
        assert got["master"].shape == (chunk,)
        sliced = [o for o in got["opt"] if o.ndim == 1]
        assert sliced and all(o.shape == (chunk,) for o in sliced)


def test_lm_zero_mesh_step_composes_with_tp(four):
    """ZeRO-1 over the data axis of a (2, 1, 2) mesh: each rank's master
    covers 1/dp of its tp shard, row [d, t] of JAX's state; three steps
    match the single-device oracle."""
    ranks, ref, _ = four
    l_ref, p_ref, _ = ref["mesh_oracle"]
    j_master, j_opt = ref["mesh_init"]
    assert j_master.shape[:2] == (2, 2)
    for r, res in enumerate(ranks):
        got = res["zero_mesh"]
        d, t = divmod(r, 2)
        np.testing.assert_array_equal(got["init_master"], j_master[d, t])
        for a, b in zip(got["init_opt"], j_opt):
            np.testing.assert_array_equal(a, b[d, t])
        np.testing.assert_allclose(got["losses"][-1], l_ref, rtol=1e-5)
        for a, b in zip(_leaves(p_ref), _leaves(got["params"])):
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6)


# --------------------------------------------------------------------------
# The replicated optimizer steps
# --------------------------------------------------------------------------

def test_lm_optax_step_matches_single_device_oracle(four):
    """Adam over a (2, 2, 1) mesh against one device's Adam (the oracle's
    float32 packing changes nothing for a float32 tree); the optimizer
    state is the same on every rank."""
    ranks, ref, _ = four
    l_ref, p_ref, _ = ref["mesh_oracle"]
    for res in ranks:
        got = res["optax"]
        np.testing.assert_allclose(got["losses"][-1], l_ref, rtol=1e-5)
        for a, b in zip(_leaves(p_ref), _leaves(got["params"])):
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6)
        for a, b in zip(ranks[0]["optax"]["opt"], got["opt"]):
            np.testing.assert_array_equal(a, b)


def test_lm_mixed_optax_step_f32_matches_plain_optax(four):
    ranks, _, _ = four
    for res in ranks:
        plain, mixed = res["plain_adam"], res["mixed_adam"]
        np.testing.assert_allclose(mixed["losses"], plain["losses"],
                                   rtol=1e-6)
        for a, b in zip(_leaves(plain["params"]), _leaves(mixed["master"])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_lm_optax_step_moe_with_balance_trains(two):
    """All experts on each rank, the Switch balance loss folded in: the
    first loss is JAX's objective and 20 Adam steps cut it by 0.3."""
    ranks, ref, _ = two
    for res in ranks:
        losses = res["moe_optax"]["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] - 0.3, losses
        np.testing.assert_allclose(losses[0], ref["moe_first"], rtol=1e-5)


# --------------------------------------------------------------------------
# FSDP
# --------------------------------------------------------------------------

def _assert_sharded_storage(sizes, n):
    any_sharded = False
    for shard, whole in sizes:
        if shard != whole:
            assert whole == shard * n
            any_sharded = True
    assert any_sharded


def test_lm_fsdp_step_matches_replicated_step(four):
    """FSDP's update equals build_lm_step's on the same ranks and rows, and
    JAX's FSDP step's; a rank stores 1/4 of every divisible leaf; a step
    gathers every sharded leaf once and reduce-scatters its gradient
    once."""
    ranks, ref, cases = four
    l_jax, p_jax = ref["fsdp"]
    n_sharded = None
    for res in ranks:
        got = res["fsdp"]
        _assert_sharded_storage(got["sizes"], 4)
        assert got["kept"] == got["sizes"]
        l_ref, p_ref = got["ref"]
        np.testing.assert_allclose(got["losses"][0], l_ref, rtol=1e-6)
        for a, b in zip(_leaves(p_ref), _leaves(got["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["losses"][0], l_jax, **XTOL)
        for a, b in zip(_leaves(p_jax), _leaves(got["params"])):
            np.testing.assert_allclose(b, a, **XTOL)
        n_sharded = sum(s != w for s, w in got["sizes"])
        assert got["calls"]["all_gather"] == n_sharded
        assert got["calls"]["psum_scatter"] == n_sharded


def test_lm_fsdp_step_trains_and_keeps_storage(two):
    ranks, _, _ = two
    for res in ranks:
        got = res["fsdp_trains"]
        assert np.isfinite(got["losses"]).all()
        assert got["losses"][-1] < got["losses"][0], got["losses"]
        _assert_sharded_storage(got["kept"], 2)


def test_lm_fsdp_accum_matches_single_shot(two):
    ranks, _, _ = two
    for res in ranks:
        one, acc = res["fsdp_accum1"], res["fsdp_accum2"]
        np.testing.assert_allclose(acc["losses"], one["losses"], rtol=1e-6)
        for a, b in zip(_leaves(one["params"]), _leaves(acc["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
        # two microbatches: every sharded leaf gathered and scattered twice
        assert acc["calls"]["all_gather"] == 2 * one["calls"]["all_gather"]


# --------------------------------------------------------------------------
# Layouts and checks, in one process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_param_specs_match_jax(n):
    import torch.distributed as dist

    from distlearn_tpu_torch.parallel.mesh import init_named_mesh
    from distlearn_tpu_torch.train import optim as topt
    _, params = _params(dict(vocab=30, dim=24, depth=1, heads=3,
                             max_len=20))
    want = jopt.fsdp_param_specs(params, _jax_mesh((n,), ("data",)))
    mesh = init_named_mesh((1,), ("data",), store=dist.HashStore(),
                           device="cpu")
    try:
        class Sized:            # the port's spec needs only the axis size
            def axis_size(self, name):
                return n
        got = topt.fsdp_param_specs(params, Sized())
        flat_w = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda s: isinstance(s, P))[0]
        for path, spec in flat_w:
            node = got
            for p in path:
                node = node[p.key]
            assert tuple(spec) == node, (path, spec, node)
        assert mesh.axis_size("data") == 1
    finally:
        dist.destroy_process_group()


def test_lm_zero_layout_and_local_template_match_jax():
    from distlearn_tpu_torch.models.convert import lm_from_jax
    from distlearn_tpu_torch.models.transformer import param_specs
    from distlearn_tpu_torch.train import optim as topt
    _, params = _params(LMZ32)
    jmesh = _jax_mesh((2, 1, 2), NAMES)
    j_local = jopt._local_template(params, jt.param_specs(params, "model"),
                                   jmesh)

    class Sizes:
        def axis_size(self, name):
            return dict(zip(NAMES, (2, 1, 2)))[name]
    t_local = topt._local_template(lm_from_jax(params),
                                   param_specs(params, "model"), Sizes())
    from distlearn_tpu_torch.utils.tree import tree_leaves
    assert [tuple(s.shape) for s in jax.tree_util.tree_leaves(j_local)] == \
        [tuple(t.shape) for t in tree_leaves(t_local)]
    for n in (1, 2, 3, 4):
        want = jopt._lm_zero_layout(params, n)
        got = topt._lm_zero_layout(lm_from_jax(params), n)
        assert (want[0].padded, want[1], want[2]) == \
            (got[0].padded, got[1], got[2])


def test_zero_refuses_slice_coupling_optimizer_and_moe():
    import torch.distributed as dist

    from distlearn_tpu_torch.models.convert import lm_from_jax
    from distlearn_tpu_torch.parallel.mesh import init_named_mesh
    from distlearn_tpu_torch.train import optim as topt
    mesh = init_named_mesh((1, 1, 1), NAMES, store=dist.HashStore(),
                           device="cpu")
    try:
        tx = topt.chain(topt.clip_by_global_norm(1.0), topt.adam(1e-3))
        # the probe splits a vector into n chunks: one rank cannot show it
        with pytest.raises(ValueError, match="not elementwise"):
            topt._check_elementwise(tx, 4)
        topt.init_lm_zero_state(lm_from_jax(_params(LMZ)[1]),
                                mesh.tree("data"), tx)
        moe = lm_from_jax(_params(MOE)[1])
        with pytest.raises(ValueError, match="dense models"):
            topt.init_lm_zero_mesh_state(moe, mesh, topt.adam(1e-3))
        with pytest.raises(ValueError, match="floating leaves"):
            topt.init_lm_zero_state({"w": torch.zeros(4, dtype=torch.int32)},
                                    mesh.tree("data"), topt.adam(1e-3))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The example's flags
# --------------------------------------------------------------------------

MESH_1 = ["--dp", "1", "--sp", "1", "--tp", "1"]
# checks the JAX example makes before it touches a device: run it
LIVE = (["--fsdp", "--sp", "2"], ["--fsdp", "--optimizer", "adam"],
        ["--fsdp", "--zero"], ["--mixed", "--zero"],
        ["--seqLayout", "zigzag", "--zero"], ["--zero", "--serve", "2"],
        ["--fsdp", "--serve", "2"])
# checks it makes after choosing its platform: its words, from
# examples/lm.py:264-268 and :280-290
LATER = ((["--zero", "--optimizer", "adam"],
          "--zero supports dense models without --accumSteps/--moeExperts, "
          "and picks its own optimizer (Adam against the sharded f32 "
          "masters) — drop --optimizer"),
         (["--zero", "--accumSteps", "2"],
          "--zero supports dense models without --accumSteps/--moeExperts, "
          "and picks its own optimizer (Adam against the sharded f32 "
          "masters) — drop --optimizer"),
         (["--optimizer", "adam", "--tp", "2"],
          "--optimizer adam uses the replicated-state optax step: pass --tp "
          "1 (TP needs --zero's sharded masters) and no --moeExperts "
          "(expert-sharded state)"),
         (["--optimizer", "lion"],
          "unknown --optimizer 'lion' (sgd | adam | adamw)"))


@pytest.mark.parametrize("argv", LIVE, ids=" ".join)
def test_example_optimizer_flags_follow_jax_checks(argv, monkeypatch):
    from distlearn_tpu_torch.examples import lm
    monkeypatch.setattr(sys, "argv", ["lm.py"] + MESH_1 + argv)
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    with pytest.raises(SystemExit) as want:
        runpy.run_path(str(ROOT / "examples" / "lm.py"),
                       run_name="__main__")
    with pytest.raises(SystemExit) as got:
        lm.parse(["--steps", "1"] + MESH_1 + argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv,words", LATER, ids=lambda a: " ".join(a)
                         if isinstance(a, list) else "")
def test_example_later_optimizer_checks_are_jax_words(argv, words):
    from distlearn_tpu_torch.examples import lm
    with pytest.raises(SystemExit) as got:
        lm.parse(["--steps", "1"] + MESH_1 + argv)
    assert str(got.value) == words
