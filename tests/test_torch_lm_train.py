"""LM training on the port (``models/transformer.py::lm_loss`` and remat,
``train/lm.py``) against the JAX package's, on the CPU at a small size
(vocab 61, dim 32, depth 2, 4 heads of 8), on the same JAX params carried
across by ``lm_from_jax`` and the same numpy tokens.  At L = 128 the port's
flash impl engages (on the CPU: the twins of B5a, B5b and B5c), where the
JAX package's runs its xla route off the TPU.

* ``lm_loss`` and its gradients, per-block and scanned, every attention
  impl; remat ``full``/``mlp`` equal no remat, and rerun the flash forward
  in the backward only under ``full``;
* ``build_lm_step`` (plain, ``accum_steps=2``, ``fused=True``) and
  ``build_lm_mixed_step`` against JAX's on a one-device ``("data",)``
  mesh; the mixed step with float32 working params equals the plain step,
  and with bfloat16 keeps ``params == master.to(bfloat16)`` and trains;
* two gloo ranks (``tests/torch_lm_dist_worker.py``) against JAX's
  two-device data mesh: the SGD step, the mixed step and
  ``build_lm_ea_steps`` (EAMSGD local steps and the elastic round);
* the pipeline steps, which wait for ROADMAP A11, raise.

Tolerances.  float32 across the two packages: ``rtol=1e-4, atol=1e-6``
(different summation orders; measured at most 6e-8 on gradients and
parameters and 5e-7 on the loss after three steps).  Within the port,
remat against none: JAX's ``rtol=1e-5, atol=1e-7``
(``tests/test_transformer.py``); accumulation against one shot:
``tests/test_lm_step.py``'s ``rtol=1e-6`` (loss) and ``rtol=1e-5,
atol=1e-6``; the mixed step with float32 masters against the plain step:
``rtol=1e-6`` (loss) and ``rtol=1e-6, atol=1e-7`` (``tests/
test_lm_step.py``).  bfloat16 compute across the packages: the loss within
``rtol=2e-3`` and the float32 masters within ``atol=1e-3`` after three
steps of ``lr * g`` (the two frameworks round the bfloat16 products at
other places; measured 5e-6 relative and 4e-5)."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import transformer as jt  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.train import lm as jlm  # noqa: E402
from distlearn_tpu_torch.models import transformer as tt  # noqa: E402
from distlearn_tpu_torch.models.convert import lm_from_jax  # noqa: E402
from distlearn_tpu_torch.ops import flash_attention as fa  # noqa: E402
from distlearn_tpu_torch.parallel.mesh import init_mesh  # noqa: E402
from distlearn_tpu_torch.train import lm as tlm  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

import torch_lm_dist_worker  # noqa: E402

VOCAB, DIM, DEPTH, HEADS, L = 61, 32, 2, 4, 128
CFG = dict(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, max_len=L)
XTOL = dict(rtol=1e-4, atol=1e-6)
LR, ALPHA, MOMENTUM, STEPS, WORLD = 0.1, 0.25, 0.9, 3, 2
JOIN_TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpu_tree():
    tree = init_mesh(store=dist.HashStore(), device="cpu")
    yield tree
    dist.destroy_process_group()


def _jax_params(scan=False, seed=0):
    model = jt.transformer_lm(scan_blocks=scan, **CFG)
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed))[0])


def _tokens(B, seed=0, length=L):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, length)) \
        .astype(np.int32)


def _assert_trees_close(got, want, **tol):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


def _data_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


@pytest.mark.parametrize("impl", ["xla", "flash", "chunked"])
@pytest.mark.parametrize("scan", [False, True], ids=["per_block", "scanned"])
def test_lm_loss_and_grads_match_jax(scan, impl):
    jmodel, jp = _jax_params(scan)
    tokens = _tokens(2)
    want_l, want_g = jax.value_and_grad(
        lambda p: jt.lm_loss(jmodel, p, jnp.asarray(tokens)))(jp)
    tmodel = tt.transformer_lm(scan_blocks=scan, attn_impl=impl, **CFG)
    got_l, got_g = tlm.lm_local_grads(tmodel, lm_from_jax(jp),
                                      torch.from_numpy(tokens))
    assert got_l.dtype == torch.float32 and got_l.shape == ()
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    _assert_trees_close(got_g, want_g, **XTOL)


def _count_flash_forwards(monkeypatch):
    """Calls of B5a (the forward wrapper) with residuals, i.e. the ones a
    gradient records — on the card each is one launch."""
    calls = []
    real = fa.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    return calls


@pytest.mark.parametrize("scan", [False, True], ids=["per_block", "scanned"])
@pytest.mark.parametrize("mode", [True, "full", "mlp"])
def test_remat_matches_no_remat(monkeypatch, mode, scan):
    """Remat recomputes, it changes no number: loss, logits and gradients
    equal the plain model's within JAX's remat tolerance.  Under full remat
    the flash forward runs again in the backward (2 x depth calls); under
    ``"mlp"`` it does not (depth calls), as in the JAX package."""
    _, jp = _jax_params(scan)
    tokens = torch.from_numpy(_tokens(2, seed=1))
    out = {}
    for remat in (False, mode):
        model = tt.transformer_lm(scan_blocks=scan, attn_impl="flash",
                                  remat=remat, **CFG)
        calls = _count_flash_forwards(monkeypatch)
        out[remat] = tlm.lm_local_grads(model, lm_from_jax(jp), tokens)
        n_fwd = len(calls)
        with torch.no_grad():
            logits = model.apply(lm_from_jax(jp), {}, tokens)[0]
        out[remat] += (logits, n_fwd)
    assert out[False][3] == DEPTH
    assert out[mode][3] == (DEPTH if mode == "mlp" else 2 * DEPTH)
    np.testing.assert_allclose(float(out[mode][0]), float(out[False][0]),
                               rtol=1e-6)
    np.testing.assert_allclose(out[mode][2].numpy(), out[False][2].numpy(),
                               rtol=1e-6, atol=1e-7)
    for a, b in zip(tree_leaves(out[False][1]), tree_leaves(out[mode][1])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)


def test_remat_mode_validation_like_jax():
    for bad in ("ful", "attn"):
        with pytest.raises(ValueError, match="remat must be"):
            jt.transformer_lm(remat=bad)
        with pytest.raises(ValueError, match="remat must be"):
            tt.transformer_lm(remat=bad)


@pytest.mark.parametrize("accum_steps,fused", [(1, False), (2, False),
                                               (1, True)],
                         ids=["plain", "accum2", "fused"])
def test_lm_step_matches_jax(cpu_tree, accum_steps, fused):
    """Three steps of the port's ``build_lm_step`` (flash impl) against the
    JAX package's on a one-device data mesh (``seq_axis=None,
    tp_axis=None``): the loss at every step and the params after."""
    jmodel, jp = _jax_params()
    mesh = _data_mesh(1)
    jstep = jlm.build_lm_step(jmodel, mesh, jp, lr=LR, seq_axis=None,
                              tp_axis=None, accum_steps=accum_steps,
                              donate=False)
    tstep = tlm.build_lm_step(
        tt.transformer_lm(attn_impl="flash", **CFG), cpu_tree, lr=LR,
        accum_steps=accum_steps, fused=fused)
    tokens = _tokens(4, seed=2)
    jtok = jax.device_put(tokens, NamedSharding(mesh, P("data")))
    pj, pt = jp, lm_from_jax(jp)
    for _ in range(STEPS):
        pj, lj = jstep(pj, jtok)
        pt, lt = tstep(pt, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    _assert_trees_close(pt, pj, **XTOL)


def test_accum_and_fused_steps_equal_the_plain_step(cpu_tree):
    """Within the port: two microbatches give the single-shot step (JAX's
    accumulation tolerance), and the bucketed update (kernel B1's plain
    version on the CPU) gives the per-leaf update bit for bit."""
    _, jp = _jax_params()
    model = tt.transformer_lm(**CFG)
    tokens = torch.from_numpy(_tokens(4, seed=3))
    outs = {}
    for tag, kw in (("plain", {}), ("accum", {"accum_steps": 2}),
                    ("fused", {"fused": True})):
        step = tlm.build_lm_step(model, cpu_tree, lr=LR, **kw)
        p = lm_from_jax(jp)
        for _ in range(2):
            p, loss = step(p, tokens)
        outs[tag] = (float(loss), tree_leaves(p))
    np.testing.assert_allclose(outs["accum"][0], outs["plain"][0], rtol=1e-6)
    for a, b, c in zip(outs["plain"][1], outs["accum"][1], outs["fused"][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(c, a)
    assert outs["fused"][0] == outs["plain"][0]


def test_mixed_step_with_f32_masters_equals_plain_step(cpu_tree):
    _, jp = _jax_params()
    model = tt.transformer_lm(attn_impl="flash", **CFG)
    plain = tlm.build_lm_step(model, cpu_tree, lr=LR)
    mixed = tlm.build_lm_mixed_step(model, cpu_tree, lr=LR)
    st = tlm.init_lm_mixed_state(lm_from_jax(jp), param_dtype=torch.float32)
    p_ref = lm_from_jax(jp)
    tokens = torch.from_numpy(_tokens(4, seed=4))
    for _ in range(STEPS):
        p_ref, l_ref = plain(p_ref, tokens)
        st, l_mx = mixed(st, tokens)
        np.testing.assert_allclose(float(l_mx), float(l_ref), rtol=1e-6)
    for a, b in zip(tree_leaves(p_ref), tree_leaves(st.master)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_mixed_step_bf16_matches_jax(cpu_tree):
    """bfloat16 working params against the JAX package's mixed step: the
    loss, the float32 masters, and ``params == master.to(bfloat16)`` bit
    for bit after every step."""
    jmodel, jp = _jax_params()
    mesh = _data_mesh(1)
    jstep = jlm.build_lm_mixed_step(jmodel, mesh, jp, lr=LR, seq_axis=None,
                                    tp_axis=None, donate=False)
    tstep = tlm.build_lm_mixed_step(
        tt.transformer_lm(attn_impl="flash", **CFG), cpu_tree, lr=LR)
    sj, st = jlm.init_lm_mixed_state(jp), \
        tlm.init_lm_mixed_state(lm_from_jax(jp))
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(st.params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(st.master))
    tokens = _tokens(4, seed=5)
    jtok = jax.device_put(tokens, NamedSharding(mesh, P("data")))
    for _ in range(STEPS):
        sj, lj = jstep(sj, jtok)
        st, lt = tstep(st, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-3)
        for p, m in zip(tree_leaves(st.params), tree_leaves(st.master)):
            assert torch.equal(p, m.to(torch.bfloat16))
    _assert_trees_close(st.master, sj.master, rtol=0, atol=1e-3)


def test_mixed_step_bf16_trains(cpu_tree):
    """The JAX package's test at L = 32 (xla): on a repeated pattern the
    bfloat16 mixed step's loss falls over 12 steps."""
    model = tt.transformer_lm(vocab=32, dim=64, depth=2, heads=4, max_len=32)
    params, _ = model.init(0, device="cpu")
    step = tlm.build_lm_mixed_step(model, cpu_tree, lr=LR)
    st = tlm.init_lm_mixed_state(params)
    base = np.random.RandomState(0).randint(0, 32, (1, 32)).astype(np.int32)
    tokens = torch.from_numpy(np.tile(base, (4, 1)))
    losses = []
    for _ in range(12):
        st, loss = step(st, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for p, m in zip(tree_leaves(st.params), tree_leaves(st.master)):
        assert torch.equal(p, m.to(torch.bfloat16))


def test_stack_blocks_matches_jax():
    _, jp = _jax_params()
    j_shared, j_stacked = jlm.stack_blocks(jp, DEPTH)
    t_shared, t_stacked = tlm.stack_blocks(lm_from_jax(jp), DEPTH)
    _assert_trees_close(t_stacked, j_stacked, rtol=0, atol=0)
    _assert_trees_close(t_shared, j_shared, rtol=0, atol=0)
    back = tlm.unstack_blocks(t_shared, t_stacked, DEPTH)
    _assert_trees_close(back, jp, rtol=0, atol=0)


def test_unported_options_raise(cpu_tree):
    """Only the pipeline-parallel steps still wait (ROADMAP A11).  A data-only
    MeshTree has no seq or model axis, so asking for one raises; the
    mesh-axis steps are held against JAX in test_torch_mesh_lm.py."""
    model = tt.transformer_lm(**CFG)
    params = lm_from_jax(_jax_params()[1])
    tokens = torch.from_numpy(_tokens(2))
    for kw in ({"seq_axis": "seq"}, {"tp_axis": "model"}):
        for build in (tlm.build_lm_step, tlm.build_lm_mixed_step,
                      tlm.build_lm_moe_metrics):
            with pytest.raises(ValueError, match="no mesh axis"):
                build(model, cpu_tree, lr=LR, **kw) \
                    if build is not tlm.build_lm_moe_metrics \
                    else build(model, cpu_tree, **kw)
    with pytest.raises(ValueError, match="zigzag"):
        tlm.build_lm_step(model, cpu_tree, lr=LR,
                          seq_layout="zigzag")(params, tokens)
    with pytest.raises(ValueError, match="mesh="):
        tt.lm_loss(model, params, tokens, seq_axis="seq")
    for fn in (tlm.build_lm_pp_step, tlm.build_lm_pp_1f1b_step):
        with pytest.raises(NotImplementedError, match="A11"):
            fn(model, None, params)
    with pytest.raises(ValueError, match="accum_steps"):
        tlm.build_lm_step(model, cpu_tree, lr=LR, accum_steps=0)
    with pytest.raises(ValueError, match="not divisible"):
        tlm.lm_local_grads(model, params, tokens, accum_steps=3)


# ---------------------------------------------------------------------------
# Two gloo ranks against JAX's two-device data mesh
# ---------------------------------------------------------------------------

def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("torch_lm_dist")
    cfg = dict(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, max_len=32)
    jmodel = jt.transformer_lm(**cfg)
    jp = jax.device_get(jmodel.init(jax.random.PRNGKey(0))[0])
    tokens = _tokens(4, seed=6, length=32)
    inp = {"cfg": cfg, "params": jp, "tokens": tokens, "lr": LR,
           "alpha": ALPHA, "momentum": MOMENTUM, "steps": STEPS}
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=torch_lm_dist_worker.run,
                         args=(r, WORLD, str(out_dir / "store"), inp,
                               str(out_dir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the JAX reference, while the ranks run
        ref = {}
        mesh = _data_mesh(WORLD)
        jtok = jax.device_put(tokens, NamedSharding(mesh, P("data")))
        step = jlm.build_lm_step(jmodel, mesh, jp, lr=LR, seq_axis=None,
                                 tp_axis=None, donate=False)
        p = jp
        for i in range(STEPS):
            p, loss = step(p, jtok)
            ref[f"sgd_loss{i}"] = float(loss)
        _flat("sgd", jax.device_get(p), ref)
        step = jlm.build_lm_mixed_step(jmodel, mesh, jp, lr=LR,
                                       seq_axis=None, tp_axis=None,
                                       donate=False)
        st = jlm.init_lm_mixed_state(jp)
        for i in range(STEPS):
            st, loss = step(st, jtok)
            ref[f"mixed_loss{i}"] = float(loss)
        _flat("mixed_master", jax.device_get(st.master), ref)

        jtree = JaxMeshTree(num_nodes=WORLD)
        stack = lambda t: jtree.put_per_node(jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                       (WORLD,) + x.shape), t))
        est = jlm.LMEAState(params=stack(jp), center=stack(jp),
                            vel=stack(jax.tree_util.tree_map(np.zeros_like,
                                                             jp)))
        local, rnd = jlm.build_lm_ea_steps(jmodel, jtree, lr=LR, alpha=ALPHA,
                                           momentum=MOMENTUM, donate=False,
                                           fused=False)
        etok = jax.device_put(tokens, NamedSharding(jtree.mesh, P("data")))
        for i in range(STEPS):
            est, losses = local(est, etok)
            ref[f"ea_loss{i}"] = np.asarray(losses)
        est = jax.device_get(rnd(est))
        for r in range(WORLD):
            for part in ("params", "center", "vel"):
                _flat(f"ea_{part}_rank{r}", jax.tree_util.tree_map(
                    lambda a, r=r: a[r], getattr(est, part)), ref)
    finally:
        for proc in procs:
            proc.join(JOIN_TIMEOUT_S)
        alive = [proc for proc in procs if proc.is_alive()]
        for proc in alive:
            proc.terminate()
            proc.join(5)
    assert not alive, f"ranks still running after {JOIN_TIMEOUT_S} s"
    assert [proc.exitcode for proc in procs] == [0] * WORLD
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)], \
        ref


def _assert_flat_close(got, ref, got_prefix, ref_prefix, **tol):
    keys = sorted(k for k in ref if k.startswith(ref_prefix + "/"))
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[got_prefix + k[len(ref_prefix):]],
                                   ref[k], err_msg=k, **tol)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_two_rank_lm_step_matches_jax(two_ranks, fused):
    """The gradient averaged over two ranks (JAX's psum then 1/dp): both
    ranks hold JAX's params after three steps, and the same loss."""
    ranks, ref = two_ranks
    for r in ranks:
        for i in range(STEPS):
            np.testing.assert_allclose(r[f"sgd_{fused}_loss{i}"],
                                       ref[f"sgd_loss{i}"], rtol=1e-6)
        _assert_flat_close(r, ref, f"sgd_{fused}", "sgd", **XTOL)
    for k in ranks[0]:
        if k.startswith(f"sgd_{fused}/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_two_rank_mixed_step_matches_jax(two_ranks):
    ranks, ref = two_ranks
    for r in ranks:
        assert bool(r["mixed_invariant"])
        for i in range(STEPS):
            np.testing.assert_allclose(r[f"mixed_loss{i}"],
                                       ref[f"mixed_loss{i}"], rtol=2e-3)
        _assert_flat_close(r, ref, "mixed_master", "mixed_master", rtol=0,
                           atol=1e-3)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_two_rank_ea_steps_match_jax(two_ranks, fused):
    """EAMSGD local steps on each rank's own rows (no collective: the ranks
    diverge), then the elastic round: every rank's params, center and
    momentum equal JAX's node of the same index."""
    ranks, ref = two_ranks
    for rank, r in enumerate(ranks):
        for i in range(STEPS):
            np.testing.assert_allclose(r[f"ea_{fused}_loss{i}"],
                                       ref[f"ea_loss{i}"][rank], rtol=1e-6)
        for part in ("params", "center", "vel"):
            _assert_flat_close(r, ref, f"ea_{fused}_{part}",
                               f"ea_{part}_rank{rank}", **XTOL)
    # the round moves both centers by the same summed delta
    for k in ranks[0]:
        if k.startswith(f"ea_{fused}_center/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
