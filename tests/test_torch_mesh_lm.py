"""The LM over a (data, seq, model) mesh on the port — ``parallel/mesh.py``'s
named mesh and collectives, ``parallel/tp.py``, ring, zigzag and Ulysses
attention (``parallel/sequence.py``), and ``train/lm.py``'s steps with
``seq_axis``/``tp_axis`` — against the JAX package on its CPU mesh.

The port runs as gloo ranks (``tests/torch_mesh_worker.py``; one spawn of
2 ranks and one of 4 serve every case of this file) on the JAX params and
numpy batches; the JAX package runs in this process meanwhile.

Tolerances are the JAX package's own tests':

* the collectives against ``lax.psum``/``ppermute``/``all_to_all`` under
  ``shard_map`` and their gradients: exact in float64 (data movement and
  sums of two or four values);
* ring and zigzag attention against local attention, ``rtol=2e-4,
  atol=2e-5``, gradients ``rtol=2e-3, atol=2e-4``
  (``tests/test_sequence.py:38-61``, ``:289-312``); Ulysses against ring
  ``rtol=2e-4, atol=2e-5`` (``:133``);
* ``build_lm_step``'s implied update ``(p - p')/lr`` on the meshes (2, 1,
  1), (1, 2, 1), (1, 1, 2), (2, 2, 1) and (1, 2, 2) against JAX's
  single-device gradient in float64: relative error < 1e-5
  (``tests/test_lm_step.py:60``), the zigzag step too, with its loss
  within 1e-5 (``:376``);
* the mixed step's accumulation against one shot and its float32 masters
  against the plain step: ``rtol=1e-6`` (loss), ``rtol=1e-6, atol=1e-7``
  (``tests/test_lm_step.py:128-176``); bfloat16 working params against
  the JAX package's mixed step on the same mesh: the loss within
  ``rtol=2e-3``, the masters within ``atol=1e-3`` after three steps
  (``tests/test_torch_lm_train.py``'s cross-package bfloat16 tolerance);
* float32 across the packages: ``rtol=1e-4, atol=1e-6``
  (``tests/test_torch_lm_train.py``).
"""

from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import transformer as jt  # noqa: E402
from distlearn_tpu.parallel import sequence as jseq  # noqa: E402
from distlearn_tpu.train import lm as jlm  # noqa: E402
from distlearn_tpu_torch.models import transformer as tt  # noqa: E402
from distlearn_tpu_torch.parallel import sequence as tseq  # noqa: E402

import torch_mesh_worker  # noqa: E402

NAMES = ("data", "seq", "model")
LM = dict(vocab=32, dim=32, depth=2, heads=4, max_len=32)
MIXED = dict(vocab=32, dim=32, depth=1, heads=2, max_len=32)
XTOL = dict(rtol=1e-4, atol=1e-6)
B, L, H, D = 2, 32, 4, 16          # the attention cases (test_sequence.py)
UPDATE_MESHES = {2: [(2, 1, 1), (1, 2, 1), (1, 1, 2)],
                 4: [(2, 2, 1), (1, 2, 2)]}
ZIGZAG_MESHES = {2: (1, 2, 1), 4: (2, 2, 1)}


def _jax_mesh(shape, names=NAMES):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_params(cfg, dtype, seed=0):
    model = jt.transformer_lm(dtype=dtype, **cfg)
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed))[0])


def _tokens(shape, seed, vocab=32):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.int32)


# --------------------------------------------------------------------------
# The JAX side
# --------------------------------------------------------------------------

def _collective_inputs(n):
    rng = np.random.RandomState(n)
    x = rng.randn(n, 4, 6, 8)
    shapes = {"psum": (4, 6, 8), "ring": (4, 6, 8), "partial": (4, 6, 8),
              "a2a_01": (4 // n, 6 * n, 8), "a2a_21": (4, 6 * n, 8 // n)}
    w = {k: rng.randn(n, *s) for k, s in shapes.items()}
    # ranks 0 (n = 2), 1 and 2 (n = 4) receive nothing
    perm = [(0, n - 1)] + ([(1, 0)] if n > 2 else [])
    return x, w, perm


def _jax_collectives(n):
    """Outputs and the gradients of sum(out * w) of lax's collectives
    under shard_map, stacked over the axis."""
    x, w, perm = _collective_inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    ops = {"psum": lambda t: lax.psum(t, "x"),
           "ring": lambda t: lax.ppermute(
               t, "x", [(j, (j + 1) % n) for j in range(n)]),
           "partial": lambda t: lax.ppermute(t, "x", perm),
           "a2a_01": lambda t: lax.all_to_all(t, "x", 0, 1, tiled=True),
           "a2a_21": lambda t: lax.all_to_all(t, "x", 2, 1, tiled=True)}
    ref = {}
    for name, op in ops.items():
        def f(xx, ww, op=op):
            return jax.shard_map(
                lambda a, b: (op(a[0]) * b[0]).sum()[None], mesh=mesh,
                in_specs=(P("x"), P("x")), out_specs=P("x"),
                check_vma=False)(xx, ww).sum()
        fwd = jax.shard_map(lambda a, op=op: op(a[0])[None], mesh=mesh,
                            in_specs=P("x"), out_specs=P("x"),
                            check_vma=False)
        ref[name] = (np.asarray(jax.jit(fwd)(x)),
                     np.asarray(jax.jit(jax.grad(f))(x, w[name])))
    return ref


def _attention_inputs():
    rng = np.random.RandomState(1)
    return [rng.randn(B, L, H, D).astype(np.float32) for _ in range(3)]


def _jax_local(q, k, v, causal):
    """Local attention and the gradients of sum(out**2), as JAX's tests."""
    f = lambda a, b, c: jnp.sum(jseq.local_attention(a, b, c,  # noqa: E731
                                                     causal=causal) ** 2)
    out = jax.jit(lambda a, b, c: jseq.local_attention(
        a, b, c, causal=causal))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in
                             jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)]


def _jax_step(cfg, dtype, shape, params, tokens, lr, steps, mixed=False,
              param_dtype=jnp.bfloat16, **kw):
    """The JAX package's build_lm_step (or mixed step) on its mesh: losses
    and the final params (masters)."""
    model = jt.transformer_lm(dtype=dtype, **cfg)
    mesh = _jax_mesh(shape)
    tok = jax.device_put(tokens, NamedSharding(mesh, P("data", "seq")))
    if mixed:
        step = jlm.build_lm_mixed_step(model, mesh, params, lr=lr,
                                       donate=False, **kw)
        st = jlm.init_lm_mixed_state(params, param_dtype)
    else:
        step = jlm.build_lm_step(model, mesh, params, lr=lr, donate=False,
                                 **kw)
        st = params
    losses = []
    for _ in range(steps):
        st, loss = step(st, tok)
        losses.append(float(loss))
    return losses, jax.device_get(st.master if mixed else st)


# --------------------------------------------------------------------------
# The cases and the fixtures
# --------------------------------------------------------------------------

def _lm64():
    _, jp = _jax_params(LM, jnp.float64)
    return jp


def _cases(world):
    x, w, perm = _collective_inputs(world)
    cases = [dict(name="collectives", kind="collectives", mesh=(world,),
                  names=("x",), axis="x", x=x, w=w, perm=perm)]
    jp64 = _lm64()
    toks = _tokens((4, 32), 0)
    for shape in UPDATE_MESHES[world]:
        cases.append(dict(name=f"update{shape}", kind="lm_step", mesh=shape,
                          names=NAMES, cfg=LM, dtype="float64", params=jp64,
                          tokens=toks, lr=1.0, steps=1))
    zz = ZIGZAG_MESHES[world]
    cases.append(dict(name="zigzag", kind="lm_step", mesh=zz, names=NAMES,
                      cfg=LM, dtype="float64", params=jp64,
                      tokens=_tokens((4, 32), 1)[
                          :, jseq.zigzag_indices(zz[1], 32)],
                      lr=1.0, steps=1, kw={"seq_layout": "zigzag"}))
    if world == 2:
        _, jp = _jax_params(MIXED, jnp.float32)
        t = _tokens((4, 32), 0)
        for k in (1, 2):
            cases.append(dict(name=f"mixed_accum{k}", kind="lm_step",
                              mesh=(2, 1, 1), names=NAMES, cfg=MIXED,
                              params=jp, tokens=t, lr=0.1, steps=1,
                              mixed=True, param_dtype="float32",
                              kw={"accum_steps": k}))
        _, jp = _jax_params(LM, jnp.float32)
        t = _tokens((4, 32), 2)
        for fused in (False, True):
            cases.append(dict(name=f"tp_fused{fused}", kind="lm_step",
                              mesh=(1, 1, 2), names=NAMES, cfg=LM,
                              params=jp, tokens=t, lr=0.1, steps=2,
                              kw={"fused": fused}))
        cases.append(dict(name="mixed_bf16_tp", kind="lm_step",
                          mesh=(1, 1, 2), names=NAMES, cfg=LM, params=jp,
                          tokens=t, lr=0.1, steps=3, mixed=True))
    else:
        q, k, v = _attention_inputs()
        attn = dict(kind="attention", mesh=(4,), names=("seq",), q=q, k=k,
                    v=v)
        for causal in (False, True):
            cases.append(dict(attn, name=f"ring{causal}", fn="ring",
                              causal=causal))
            cases.append(dict(attn, name=f"ulysses{causal}", fn="alltoall",
                              causal=causal))
        zi = jseq.zigzag_indices(4, L)
        cases.append(dict(attn, name="zigzag_attn", fn="ring", causal=True,
                          layout="zigzag", q=q[:, zi], k=k[:, zi],
                          v=v[:, zi]))
        cfg = dict(LM, max_len=64)
        _, jp = _jax_params(cfg, jnp.float32)
        base = _tokens((1, 64), 0)
        cases.append(dict(name="mixed_zigzag", kind="lm_step",
                          mesh=(1, 4, 1), names=NAMES, cfg=cfg, params=jp,
                          tokens=np.tile(base, (4, 1))[
                              :, jseq.zigzag_indices(4, 64)],
                          lr=0.1, steps=6, mixed=True,
                          kw={"seq_layout": "zigzag"}))
        _, jp = _jax_params(LM, jnp.float32)
        t = _tokens((4, 32), 3)
        cases.append(dict(name="plain_122", kind="lm_step", mesh=(1, 2, 2),
                          names=NAMES, cfg=LM, params=jp, tokens=t, lr=0.1,
                          steps=3))
        cases.append(dict(name="mixed_f32_122", kind="lm_step",
                          mesh=(1, 2, 2), names=NAMES, cfg=LM, params=jp,
                          tokens=t, lr=0.1, steps=3, mixed=True,
                          param_dtype="float32"))
    return cases


def _references(world, cases):
    """The JAX side of every case, computed while the ranks run."""
    def run():
        by = {c["name"]: c for c in cases}
        ref = {"collectives": _jax_collectives(world)}
        model = jt.transformer_lm(dtype=jnp.float64, **LM)
        jp64 = by[f"update{UPDATE_MESHES[world][0]}"]["params"]
        for name, seed in (("update", 0), ("zigzag", 1)):
            toks = jnp.asarray(_tokens((4, 32), seed))
            ref[name] = jax.device_get(jax.jit(jax.value_and_grad(
                lambda p, t=toks: jt.lm_loss(model, p, t)))(jp64))
        if world == 2:
            c = by["mixed_accum1"]
            ref["mixed_accum"] = _jax_step(MIXED, jnp.float32, (2, 1, 1),
                                           c["params"], c["tokens"], 0.1, 1,
                                           mixed=True,
                                           param_dtype=jnp.float32)
            c = by["mixed_bf16_tp"]
            ref["mixed_bf16_tp"] = _jax_step(LM, jnp.float32, (1, 1, 2),
                                             c["params"], c["tokens"], 0.1,
                                             3, mixed=True)
        else:
            q, k, v = _attention_inputs()
            for causal in (False, True):
                ref[f"local{causal}"] = _jax_local(q, k, v, causal)
            c = by["mixed_zigzag"]
            ref["mixed_zigzag"] = _jax_step(
                c["cfg"], jnp.float32, (1, 4, 1), c["params"], c["tokens"],
                0.1, 6, mixed=True, seq_layout="zigzag")
            c = by["plain_122"]
            ref["plain_122"] = _jax_step(LM, jnp.float32, (1, 2, 2),
                                         c["params"], c["tokens"], 0.1, 3)
        return ref
    return run


def _spawn(world, tmp_path_factory):
    def compute():
        out_dir = tmp_path_factory.mktemp(f"torch_mesh_lm{world}")
        cases = _cases(world)
        ranks, ref = torch_mesh_worker.spawn(world, cases, str(out_dir),
                                             _references(world, cases))
        return ranks, ref, {c["name"]: c for c in cases}
    return torch_mesh_worker.once_per_session(f"torch_mesh_lm{world}",
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


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


# --------------------------------------------------------------------------
# The collectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("runs", ["two", "four"], indirect=True)
@pytest.mark.parametrize("op", ["psum", "ring", "partial", "a2a_01",
                                "a2a_21"])
def test_collectives_match_lax(runs, op):
    """psum, ppermute (a rank no pair sends to gets zeros; the gradient
    rides the inverse permutation) and the tiled all_to_all (the gradient
    is the reverse all-to-all) against lax under shard_map."""
    ranks, ref, _ = runs
    want_out, want_grad = ref["collectives"][op]
    for r, res in enumerate(ranks):
        got_out, got_grad = res["collectives"][op]
        np.testing.assert_allclose(got_out, want_out[r], rtol=1e-12)
        np.testing.assert_allclose(got_grad, want_grad[r], rtol=1e-12)


@pytest.mark.parametrize("runs", ["two", "four"], indirect=True)
def test_all_gather_and_the_axis_tree(runs):
    """all_gather concatenates in axis order; ``mesh.tree(axis)`` is the
    axis as a MeshTree (the data-only and EA steps' handle), whose sum is
    psum's."""
    ranks, ref, cases = runs
    x = cases["collectives"]["x"]
    want = np.concatenate(list(x), axis=1)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["collectives"]["gather"], want)
        index, total = res["collectives"]["tree"]
        assert index == r
        np.testing.assert_allclose(total, ref["collectives"]["psum"][0][r],
                                   rtol=1e-12)


# --------------------------------------------------------------------------
# Ring, zigzag and Ulysses attention
# --------------------------------------------------------------------------

def _assemble(ranks, name, part=None, order=None):
    """The ranks' sequence shards of a case's output (or gradient ``part``)
    concatenated, back in natural order when ``order`` (the layout's
    permutation) is given."""
    shards = [r[name]["out"] if part is None else r[name]["grads"][part]
              for r in ranks]
    full = np.concatenate(shards, axis=1)
    if order is not None:
        full = full[:, np.argsort(order)]
    return full


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_local(four, causal):
    ranks, ref, _ = four
    want, want_g = ref[f"local{causal}"]
    got = _assemble(ranks, f"ring{causal}")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for i in range(3):
        np.testing.assert_allclose(_assemble(ranks, f"ring{causal}", i),
                                   want_g[i], rtol=2e-3, atol=2e-4)


def test_zigzag_ring_matches_local(four):
    """The zigzag layout's balanced causal ring on permuted q/k/v equals
    natural-order causal attention, forward and backward."""
    ranks, ref, _ = four
    want, want_g = ref["localTrue"]
    zi = jseq.zigzag_indices(4, L)
    np.testing.assert_allclose(_assemble(ranks, "zigzag_attn", order=zi),
                               want, rtol=2e-4, atol=2e-5)
    for i in range(3):
        np.testing.assert_allclose(
            _assemble(ranks, "zigzag_attn", i, order=zi), want_g[i],
            rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_ring(four, causal):
    ranks, ref, _ = four
    np.testing.assert_allclose(_assemble(ranks, f"ulysses{causal}"),
                               _assemble(ranks, f"ring{causal}"),
                               rtol=2e-4, atol=2e-5)
    for i in range(3):
        np.testing.assert_allclose(
            _assemble(ranks, f"ulysses{causal}", i),
            ref[f"local{causal}"][1][i], rtol=2e-3, atol=2e-4)


def test_zigzag_indices_match_jax():
    for n, length in ((1, 8), (2, 32), (4, 32), (4, 64)):
        np.testing.assert_array_equal(tseq.zigzag_indices(n, length),
                                      jseq.zigzag_indices(n, length))
    with pytest.raises(ValueError, match="zigzag"):
        tseq.zigzag_indices(4, 20)


def test_one_rank_axes_delegate_to_local_attention():
    """n == 1: ring, zigzag and Ulysses are local attention, as in JAX."""
    import torch.distributed as dist

    from distlearn_tpu_torch.parallel.mesh import init_named_mesh
    mesh = init_named_mesh((1,), ("seq",), store=dist.HashStore(),
                           device="cpu")
    try:
        q, k, v = (torch.from_numpy(a) for a in _attention_inputs())
        want = tseq.local_attention(q, k, v, causal=True)
        ax = mesh.axis("seq")
        for got in (tseq.ring_attention(q, k, v, ax, causal=True),
                    tseq.ring_attention(q, k, v, ax, causal=True,
                                        layout="zigzag"),
                    tseq.alltoall_attention(q, k, v, ax, causal=True)):
            assert torch.equal(got, want)
        with pytest.raises(ValueError, match="layout must be"):
            tseq.ring_attention(q, k, v, ax, layout="diag")
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# The LM steps
# --------------------------------------------------------------------------

def _assert_implied_update(got_params, jp, ref_g, lr=1.0):
    for a, b, g in zip(_leaves(jp), _leaves(got_params), _leaves(ref_g)):
        implied = (np.asarray(a) - np.asarray(b)) / lr
        denom = max(1e-12, float(np.abs(np.asarray(g)).max()))
        err = float(np.abs(implied - np.asarray(g)).max()) / denom
        assert err < 1e-5, err


@pytest.mark.parametrize("runs,shape", [
    ("two", s) for s in UPDATE_MESHES[2]] + [
    ("four", s) for s in UPDATE_MESHES[4]], indirect=["runs"])
def test_lm_step_gradients_match_single_device(runs, shape):
    """The implied update of one build_lm_step (lr 1) on every mesh equals
    JAX's single-device gradient of the same global batch (float64) —
    the psum-transpose scalings of dp, sp and tp all land."""
    ranks, ref, cases = runs
    jp = cases[f"update{shape}"]["params"]
    ref_loss, ref_g = ref["update"]
    for res in ranks:
        got = res[f"update{shape}"]
        assert abs(got["losses"][0] - float(ref_loss)) < 1e-5
        _assert_implied_update(got["params"], jp, ref_g)


@pytest.mark.parametrize("runs", ["two", "four"], indirect=True)
def test_lm_step_zigzag_matches_single_device(runs):
    """seq_layout='zigzag' on permuted tokens computes the same global
    objective: loss and implied update against the natural-order batch's
    single-device gradient."""
    ranks, ref, cases = runs
    ref_loss, ref_g = ref["zigzag"]
    for res in ranks:
        got = res["zigzag"]
        assert abs(got["losses"][0] - float(ref_loss)) < 1e-5
        _assert_implied_update(got["params"], cases["zigzag"]["params"],
                               ref_g)


def test_mixed_step_accum_matches_single_shot_and_jax(two):
    ranks, ref, _ = two
    want_losses, want_master = ref["mixed_accum"]
    for res in ranks:
        one, acc = res["mixed_accum1"], res["mixed_accum2"]
        np.testing.assert_allclose(acc["losses"], one["losses"], rtol=1e-6)
        for a, b in zip(_leaves(one["master"]), _leaves(acc["master"])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(one["losses"], want_losses, rtol=1e-6)
        for a, b in zip(_leaves(one["master"]), _leaves(want_master)):
            np.testing.assert_allclose(a, b, **XTOL)


def test_tp_fused_step_equals_plain(two):
    """B1's bucketed update on each rank's tp shards (its plain version on
    the CPU) gives the per-leaf update bit for bit."""
    ranks, _, _ = two
    for res in ranks:
        plain, fused = res["tp_fusedFalse"], res["tp_fusedTrue"]
        assert plain["losses"] == fused["losses"]
        for a, b in zip(_leaves(plain["params"]), _leaves(fused["params"])):
            np.testing.assert_array_equal(a, b)


def test_mixed_bf16_tp_step_matches_jax(two):
    ranks, ref, _ = two
    want_losses, want_master = ref["mixed_bf16_tp"]
    for res in ranks:
        got = res["mixed_bf16_tp"]
        assert got["invariant"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-3)
        for a, b in zip(_leaves(got["master"]), _leaves(want_master)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_mixed_zigzag_step_trains_like_jax(four):
    """--mixed composes with the zigzag layout: the loss is finite and
    falls, as JAX's, step for step."""
    ranks, ref, _ = four
    want_losses, _ = ref["mixed_zigzag"]
    for res in ranks:
        got = res["mixed_zigzag"]
        assert got["invariant"] and np.isfinite(got["losses"]).all()
        assert got["losses"][-1] < got["losses"][0], got["losses"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-3)


def test_mixed_f32_masters_equal_plain_step_on_sp_tp_mesh(four):
    ranks, ref, _ = four
    want_losses, want_params = ref["plain_122"]
    for res in ranks:
        plain, mixed = res["plain_122"], res["mixed_f32_122"]
        np.testing.assert_allclose(mixed["losses"], plain["losses"],
                                   rtol=1e-6)
        for a, b in zip(_leaves(plain["params"]), _leaves(mixed["master"])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(plain["losses"], want_losses, rtol=1e-6)
        for a, b in zip(_leaves(plain["params"]), _leaves(want_params)):
            np.testing.assert_allclose(a, b, **XTOL)


# --------------------------------------------------------------------------
# Sharding and validation, in one process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True], ids=["per_block", "scanned"])
@pytest.mark.parametrize("tp_axis,ep_axis", [(None, None), ("model", None),
                                             (None, "data"),
                                             ("model", "data")])
def test_param_specs_match_jax(scan, tp_axis, ep_axis):
    cfg = dict(LM, moe_experts=0 if scan else 2)
    jmodel = jt.transformer_lm(scan_blocks=scan, **cfg)
    jp = jax.device_get(jmodel.init(jax.random.PRNGKey(0))[0])
    want = jt.param_specs(jp, tp_axis, ep_axis)
    got = tt.param_specs(jp, tp_axis, ep_axis)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, P))[0]
    for path, spec in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        assert tuple(spec) == node, (path, spec, node)


def test_validation_errors_match_jax():
    for kw in ({"seq_impl": "ulysses"}, {"remat": "attn"}):
        with pytest.raises(ValueError) as want:
            jt.transformer_lm(**kw)
        with pytest.raises(ValueError) as got:
            tt.transformer_lm(**kw)
        assert str(got.value) == str(want.value)
    for seq_impl in ("ring", "alltoall"):
        jm = jt.transformer_lm(vocab=8, dim=8, depth=1, heads=1, max_len=8,
                               seq_impl=seq_impl)
        tm = tt.transformer_lm(vocab=8, dim=8, depth=1, heads=1, max_len=8,
                               seq_impl=seq_impl)
        jpar = jax.device_get(jm.init(jax.random.PRNGKey(0))[0])
        tpar, _ = tm.init(0, device="cpu")
        with pytest.raises(ValueError) as want:
            jm.apply(jpar, {}, jnp.zeros((1, 8), jnp.int32),
                     seq_layout="zigzag")
        with pytest.raises(ValueError) as got:
            tm.apply(tpar, {}, torch.zeros((1, 8), dtype=torch.long),
                     seq_layout="zigzag")
        assert str(got.value) == str(want.value)


def test_example_mesh_flags_follow_jax_checks():
    from distlearn_tpu_torch.examples import lm
    for argv, match in ((["--moeExperts", "2"], "must equal --dp"),
                        (["--seqLayout", "zigzag", "--seqImpl", "alltoall"],
                         "needs --seqImpl ring"),
                        (["--seqLayout", "diag"], "contig | zigzag"),
                        (["--scanBlocks", "--moeExperts", "2", "--dp", "2"],
                         "homogeneous"),
                        (["--pp", "2", "--sp", "2"],
                         "composes with data parallelism only")):
        with pytest.raises(SystemExit, match=match):
            lm.parse(["--steps", "1"] + argv)


def test_example_trains_moe_over_dp_sp_and_reports_routing(capfd,
                                                           monkeypatch):
    """The acceptance run: 4 gloo ranks (dp 2 x sp 2) of a 2-expert MoE LM
    train 3 steps and print JAX's routing-health report line."""
    from distlearn_tpu_torch.examples import lm
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert lm.main(["--device", "cpu", "--dp", "2", "--sp", "2", "--tp",
                    "1", "--moeExperts", "2", "--steps", "3", "--dim", "64",
                    "--depth", "2", "--seqLen", "64", "--vocab", "64"]) == 0
    out = capfd.readouterr().out
    assert "mesh dp=2 sp=2 tp=1" in out
    assert re.search(r"step 3: loss \d+\.\d+ \[router balance \d\.\d{3}, "
                     r"dropped \d\.\d{3}\]", out), out
