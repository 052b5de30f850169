"""Mixture of experts on the port — ``parallel/ep.py`` (routing, the local
and the expert-parallel FFN) and the MoE transformer LM with its expert
axis (``models/transformer.py``, ``train/lm.py``'s ``ep_axis`` and
``build_lm_moe_metrics``) — against the JAX package.

Routing tables and the local FFN run in this process; ``moe_ffn`` and the
MoE LM over a mesh run as 4 gloo ranks (``tests/torch_mesh_worker.py``,
one spawn for the file) while the JAX package runs here on its CPU mesh.

Tolerances are the JAX package's own tests': ``moe_ffn`` against the
dense reference and ``moe_ffn_local``, ``rtol=1e-5, atol=1e-6``, gradients
``rtol=2e-4, atol=2e-5`` (``tests/test_ep.py:64-78``); the ep step on a
(2, 2, 1) mesh against the single-device step, loss ``rtol=1e-5,
atol=1e-6`` and params ``rtol=2e-4, atol=2e-5`` (``tests/test_moe_lm.py:
55-83``); routing tables exact (integer slots, the same float32 gates);
float32 across the packages elsewhere ``rtol=1e-4, atol=1e-6``
(``tests/test_torch_lm_train.py``).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import transformer as jt  # noqa: E402
from distlearn_tpu.parallel import ep as jep  # noqa: E402
from distlearn_tpu.train import lm as jlm  # noqa: E402
from distlearn_tpu_torch.models import transformer as tt  # noqa: E402
from distlearn_tpu_torch.models.convert import lm_from_jax  # noqa: E402
from distlearn_tpu_torch.parallel import ep as tep  # noqa: E402
from distlearn_tpu_torch.train import lm as tlm  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

import torch_mesh_worker  # noqa: E402

E, N, D = 4, 12, 8           # tests/test_ep.py: 4 experts, 12 tokens a rank
V, DIM, DEPTH, HEADS, L, B = 64, 32, 2, 4, 16, 4     # tests/test_moe_lm.py
NAMES = ("data", "seq", "model")
XTOL = dict(rtol=1e-4, atol=1e-6)


def _cfg(**kw):
    return dict(vocab=V, dim=DIM, depth=DEPTH, heads=HEADS, max_len=L,
                moe_experts=2, moe_every=2, moe_capacity_factor=2.0, **kw)


def _jax_params(seed=1, **kw):
    model = jt.transformer_lm(**_cfg(**kw))
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed))[0])


def _tokens(seed=2):
    return np.random.RandomState(seed).randint(0, V, (B, L)).astype(np.int32)


def _ffn_params(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(E, D, D).astype(np.float32) * 0.5,
            rng.randn(D, E).astype(np.float32))


def _x_all(seed):
    return np.random.RandomState(seed).randn(E, N, D).astype(np.float32)


def _dense(experts, router, x_all, k):
    """tests/test_ep.py's dense reference: every expert on every token, the
    top-k chosen and weighted (k=1 the raw gate, k=2 renormalised)."""
    out = []
    for dev in range(E):
        x = x_all[dev]
        gates = jax.nn.softmax(x @ router, axis=-1)
        topv, topi = jax.lax.top_k(gates, k)
        w = topv if k == 1 else topv / topv.sum(-1, keepdims=True)
        ys = jnp.stack([jnp.tanh(x @ experts[e]) for e in range(E)], axis=1)
        out.append(sum(jnp.take_along_axis(ys, topi[:, j][:, None, None],
                                           1)[:, 0] * w[:, j][:, None]
                       for j in range(k)))
    return jnp.stack(out)


def _jax_moe_step(shape, jp, tokens, lr, **kw):
    model = jt.transformer_lm(**_cfg(moe_top_k=kw.pop("top_k", 1)))
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                NAMES)
    sh = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s),
        jt.param_specs(jp, tp_axis="model", ep_axis="data"))
    step = jlm.build_lm_step(model, mesh, jp, lr=lr, ep_axis="data",
                             donate=False, **kw)
    tok = jax.device_put(tokens, NamedSharding(mesh, P("data", "seq")))
    newp, loss = step(jax.device_put(jp, sh), tok)
    metrics = jlm.build_lm_moe_metrics(model, mesh, jp, ep_axis="data")
    m = jax.device_get(metrics(jax.device_put(jp, sh), tok))
    return float(loss), jax.device_get(newp), {k: float(v)
                                               for k, v in m.items()}


def _cases():
    cases = []
    for k in (1, 2):
        experts, router = _ffn_params(5 if k == 2 else 2)
        cases.append(dict(name=f"ffn_top{k}", kind="moe_ffn", mesh=(E,),
                          names=("expert",), experts=experts, router=router,
                          x=_x_all(6 if k == 2 else 3),
                          capacity_factor=float(E), top_k=k))
    for k in (1, 2):
        _, jp = _jax_params(moe_top_k=k)
        cases.append(dict(name=f"ep_top{k}", kind="lm_step",
                          mesh=(2, 2, 1), names=NAMES,
                          cfg=_cfg(moe_top_k=k), params=jp,
                          tokens=_tokens(), lr=0.3, steps=1,
                          ep_axis="data"))
    _, jp = _jax_params(moe_top_k=2)
    cases.append(dict(name="ep_balance", kind="lm_step", mesh=(2, 2, 1),
                      names=NAMES, cfg=_cfg(moe_top_k=2), params=jp,
                      tokens=_tokens(4), lr=0.3, steps=1, ep_axis="data",
                      kw={"moe_balance_weight": 0.01}))
    cases.append(dict(name="metrics", kind="moe_metrics", mesh=(2, 2, 1),
                      names=NAMES, cfg=_cfg(moe_top_k=2), params=jp,
                      tokens=_tokens(4), ep_axis="data"))
    _, jp = _jax_params(seed=3)
    cases.append(dict(name="roundtrip", kind="shard_roundtrip",
                      mesh=(2, 1, 2), names=NAMES, cfg=_cfg(), params=jp,
                      ep_axis="data"))
    return cases


def _references(cases):
    def run():
        by = {c["name"]: c for c in cases}
        ref = {}
        for k in (1, 2):
            c = by[f"ffn_top{k}"]
            e, r, x = (jnp.asarray(c[n]) for n in ("experts", "router", "x"))
            ref[f"ffn_top{k}"] = (
                np.asarray(jax.jit(_dense, static_argnums=3)(e, r, x, k)),
                [np.asarray(g) for g in jax.jit(jax.grad(
                    lambda ee, rr: jnp.sum(_dense(ee, rr, x, k) ** 2),
                    argnums=(0, 1)))(e, r)])
        for k in (1, 2):
            c = by[f"ep_top{k}"]
            model = jt.transformer_lm(**c["cfg"])
            toks = jnp.asarray(c["tokens"])
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: jt.lm_loss(model, p, toks)))(c["params"])
            ref[f"ep_top{k}"] = (float(loss), jax.device_get(
                jax.tree_util.tree_map(lambda p, gg: p - c["lr"] * gg,
                                       c["params"], g)))
        c = by["ep_balance"]
        ref["ep_balance"] = _jax_moe_step(
            (2, 2, 1), c["params"], c["tokens"], c["lr"], top_k=2,
            moe_balance_weight=0.01)
        return ref
    return run


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    def compute():
        out_dir = tmp_path_factory.mktemp("torch_moe")
        cases = _cases()
        ranks, ref = torch_mesh_worker.spawn(4, cases, str(out_dir),
                                             _references(cases))
        return ranks, ref, {c["name"]: c for c in cases}
    return torch_mesh_worker.once_per_session("torch_moe", tmp_path_factory,
                                              compute)


# --------------------------------------------------------------------------
# Routing, in one process
# --------------------------------------------------------------------------

def _route_both(logits, capacity, k):
    jd, jc, ja = jep.route_topk(jnp.asarray(logits), capacity, k)
    td, tc, ta = tep.route_topk(torch.from_numpy(np.asarray(logits)),
                                capacity, k)
    return (np.asarray(jd), np.asarray(jc), {n: float(v) for n, v in
                                              ja.items()}), \
        (td.numpy(), tc.numpy(), {n: float(v) for n, v in ta.items()})


@pytest.mark.parametrize("k,capacity", [(1, 1), (1, 4), (1, 16), (2, 1),
                                        (2, 3), (2, 16), (3, 8), (4, 64)])
def test_route_topk_tables_match_jax(k, capacity):
    """Dispatch slots (int32 cumsum positions, first choices before second
    ones), combine weights and aux terms equal JAX's."""
    logits = np.random.RandomState(7 + k).randn(64, E).astype(np.float32)
    (jd, jc, ja), (td, tc, ta) = _route_both(logits, capacity, k)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)
    for n in ja:
        np.testing.assert_allclose(ta[n], ja[n], rtol=1e-6, atol=1e-7)
    per_slot = td.sum(axis=0)
    assert per_slot.max() <= 1                      # no slot collisions
    assert td.sum(axis=(1, 2)).max() <= k


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tied_gates_route_like_lax_top_k(k):
    """Exactly tied gates: lax.top_k puts the lower expert first, and so
    does the port (torch.topk promises no order)."""
    rng = np.random.RandomState(3)
    logits = np.zeros((32, E), np.float32)
    logits[::3] = rng.randn(E)[None]             # ties within a row too
    logits[1::3, :2] = 1.5
    logits[2::3, 1:] = -0.25
    (jd, jc, ja), (td, tc, ta) = _route_both(logits, 40, k)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)
    for n in ja:
        np.testing.assert_allclose(ta[n], ja[n], rtol=1e-6, atol=1e-7)


def test_route_topk_aux_terms():
    """tests/test_ep.py:137-160 on the port: balance 1.0 uniform, E when
    collapsed, and the exact dropped fraction."""
    N2 = 4 * E
    bias = 1e-3 * np.eye(E, dtype=np.float32)[np.arange(N2) % E]
    _, _, aux = tep.route_topk(torch.from_numpy(bias), capacity=N2, k=1)
    np.testing.assert_allclose(float(aux["balance_loss"]), 1.0, rtol=1e-4)
    assert float(aux["dropped_frac"]) == 0.0
    big = torch.zeros((N2, E))
    big[:, 0] = 20.0
    _, _, aux = tep.route_topk(big, capacity=N2, k=1)
    np.testing.assert_allclose(float(aux["balance_loss"]), float(E),
                               rtol=1e-3)
    d3, c3, aux = tep.route_topk(big, capacity=1, k=1)
    assert float(aux["dropped_frac"]) == (N2 - 1) / N2
    kept = d3.any(dim=(1, 2))
    assert (c3.sum(dim=(1, 2))[~kept] == 0).all()


def test_route_top1_and_validation_match_jax():
    logits = np.random.RandomState(4).randn(64, E).astype(np.float32)
    jd, jc = jep.route_top1(jnp.asarray(logits), 16)
    td, tc = tep.route_top1(torch.from_numpy(logits), 16)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for k in (0, E + 1):
        with pytest.raises(ValueError) as want:
            jep.route_topk(jnp.asarray(logits), 4, k)
        with pytest.raises(ValueError) as got:
            tep.route_topk(torch.from_numpy(logits), 4, k)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, float(E)])
def test_moe_ffn_local_matches_jax(k, capacity_factor):
    """The all-experts-local FFN (capacity ceil(N * factor * k / E), copied
    exactly) with its aux terms, forward and backward."""
    experts, router = _ffn_params(9)
    x = np.random.RandomState(10).randn(3 * N, D).astype(np.float32)

    def jf(e, r):
        y, aux = jep.moe_ffn_local(lambda p, h: jnp.tanh(h @ p), e, r,
                                   jnp.asarray(x), capacity_factor, k,
                                   return_aux=True)
        return jnp.sum(y ** 2), (y, aux)
    (_, (jy, jaux)), jg = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(experts), jnp.asarray(router))
    e = torch.from_numpy(experts).requires_grad_()
    r = torch.from_numpy(router).requires_grad_()
    ty, taux = tep.moe_ffn_local(lambda p, h: torch.tanh(h @ p), e, r,
                                 torch.from_numpy(x), capacity_factor, k,
                                 return_aux=True)
    tg = torch.autograd.grad((ty ** 2).sum(), (e, r))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    for n in jaux:
        np.testing.assert_allclose(float(taux[n].detach()), float(jaux[n]),
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# The expert-parallel FFN and LM over 4 ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_dense_reference(four, k):
    """moe_ffn with one expert a rank and two all-to-alls equals the dense
    reference with non-binding capacity, forward and backward (the
    router's gradient summed over the ranks, as shard_map sums a
    replicated input's)."""
    ranks, ref, _ = four
    want_y, (want_ge, want_gr) = ref[f"ffn_top{k}"]
    got = [r[f"ffn_top{k}"] for r in ranks]
    np.testing.assert_allclose(np.stack([g["y"] for g in got]), want_y,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.stack([g["g_expert"] for g in got]),
                               want_ge, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sum(g["g_router"] for g in got), want_gr,
                               rtol=2e-4, atol=2e-5)


def test_moe_ffn_rejects_wrong_router_shape(four):
    ranks, _, _ = four
    for r in ranks:
        assert r["ffn_top1"]["bad_router"].startswith("router_w must be")


@pytest.mark.parametrize("k", [1, 2])
def test_moe_lm_ep_step_matches_single_device(four, k):
    """One build_lm_step with the experts over the data axis of a (2, 2, 1)
    mesh equals one plain single-device step with every expert resident
    (ample capacity): tests/test_moe_lm.py:55 on the port."""
    ranks, ref, _ = four
    want_loss, want = ref[f"ep_top{k}"]
    for r in ranks:
        got = r[f"ep_top{k}"]
        np.testing.assert_allclose(got["losses"][0], want_loss, rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_moe_lm_balance_step_and_metrics_match_jax(four):
    """With moe_balance_weight 0.01 (each data and seq shard's own balance
    term, the mesh objective) the step equals JAX's on the same mesh, and
    build_lm_moe_metrics equals JAX's."""
    ranks, ref, _ = four
    want_loss, want, want_m = ref["ep_balance"]
    for r in ranks:
        got = r["ep_balance"]
        np.testing.assert_allclose(got["losses"][0], want_loss, **XTOL)
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, **XTOL)
        for n, v in want_m.items():
            np.testing.assert_allclose(r["metrics"][n], v, **XTOL)


def test_shards_gather_back_bit_for_bit(four):
    """lm_shard cuts the dense blocks' heads and hidden over model and the
    experts over data; lm_gather puts the JAX tree back exactly."""
    ranks, _, cases = four
    jp = cases["roundtrip"]["params"]
    for r in ranks:
        got = r["roundtrip"]
        for a, b in zip(jax.tree_util.tree_leaves(got["back"]),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(a, b)
        shapes = got["shapes"]
        assert shapes["block0/wq"] == (DIM, HEADS // 2, DIM // HEADS)
        assert shapes["block0/w1"] == (DIM, 2 * DIM)
        assert shapes["block1/we1"] == (1, DIM, 4 * DIM)
        assert shapes["block1/router"] == (DIM, 2)


# --------------------------------------------------------------------------
# The MoE LM in one process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, "full", "mlp"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_lm_loss_and_grads_match_jax(k, remat):
    jmodel, jp = _jax_params(moe_top_k=k)
    toks = _tokens(5)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(jmodel, p, jnp.asarray(toks),
                             moe_balance_weight=0.01)))(jp)
    tmodel = tt.transformer_lm(remat=remat, **_cfg(moe_top_k=k))
    got_l, got_g = tlm.lm_local_grads(tmodel, lm_from_jax(jp),
                                      torch.from_numpy(toks),
                                      moe_balance_weight=0.01)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    for a, b in zip(tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **XTOL)
    _, jst = jax.jit(lambda p: jmodel.apply(p, {}, jnp.asarray(toks)))(jp)
    with torch.no_grad():
        _, tst = tmodel.apply(lm_from_jax(jp), {}, torch.from_numpy(toks))
    for n in ("moe_balance_loss", "moe_dropped_frac"):
        np.testing.assert_allclose(float(tst[n]), float(jst[n]), rtol=1e-6)


def test_moe_init_matches_jax_shapes_and_scales():
    jmodel, jp = _jax_params()
    tp, _ = tt.transformer_lm(**_cfg()).init(0, device="cpu")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, {k: v for k, v in jp.items()})) \
        == jax.tree_util.tree_structure(
            {k: jax.tree_util.tree_map(lambda t: t.numpy(), v)
             if isinstance(v, dict) else v.numpy() for k, v in tp.items()})
    for (pa, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                          tree_leaves(tp)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, pa
    blk = tp["block1"]
    assert torch.equal(blk["wb1"], torch.zeros(2, 4 * DIM))
    assert abs(float(blk["we1"].std()) - DIM ** -0.5) < 0.02
    assert abs(float(blk["we2"].std()) - (4 * DIM) ** -0.5) < 0.01
    assert "router" in blk and "w1" not in blk and "b2" not in blk


def test_moe_config_validation_matches_jax():
    for kw in ({"moe_experts": 4, "moe_every": 4},
               {"moe_experts": 4, "moe_every": 0},
               {"moe_experts": -1},
               {"moe_experts": 2, "moe_top_k": 3},
               {"moe_experts": 2, "scan_blocks": True}):
        args = dict(vocab=V, dim=DIM, depth=2, heads=HEADS, max_len=L, **kw)
        with pytest.raises(ValueError) as want:
            jt.transformer_lm(**args)
        with pytest.raises(ValueError) as got:
            tt.transformer_lm(**args)
        assert str(got.value) == str(want.value)
