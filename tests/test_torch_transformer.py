"""The port's transformer LM against the JAX package's, on the CPU at the
JAX serve tests' size, on the same JAX params carried across by
``lm_from_jax``: logits in the per-block and the scanned layout, and
greedy tokens (equal-length, ragged and scanned prompts).

Logits are held to 1e-5 absolute: both sides compute in float32 with
different summation orders; the measured difference at this size is below
2e-6 for logits of order 1.  Tokens are compared exactly."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.models import transformer as jt  # noqa: E402
from distlearn_tpu_torch.models import transformer as tt  # noqa: E402
from distlearn_tpu_torch.models.convert import lm_from_jax, lm_to_jax  # noqa: E402

VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64
LOGITS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_params(scan=False, seed=0):
    model = jt.transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                              max_len=MAX_LEN, scan_blocks=scan)
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed))[0])


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, L)) \
        .astype(np.int32)


@pytest.mark.parametrize("scan", [False, True], ids=["per_block", "scanned"])
@pytest.mark.parametrize("L", [9, 32])
def test_logits_match_jax(scan, L):
    jmodel, jp = _jax_params(scan)
    tokens = _tokens(3, L)
    want = np.asarray(jmodel.apply(jp, {}, jnp.asarray(tokens))[0])
    tmodel = tt.transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH,
                               heads=HEADS, max_len=MAX_LEN, scan_blocks=scan)
    got, state = tmodel.apply(lm_from_jax(jp), {}, torch.from_numpy(tokens))
    assert state == {} and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)


def test_block_pieces_match_jax():
    """rmsnorm, the projections and the tanh-GELU FFN, one block alone."""
    _, jp = _jax_params()
    x = np.random.default_rng(1).standard_normal((2, 7, DIM)) \
        .astype(np.float32)
    jblk, tblk = jp["block0"], lm_from_jax(jp)["block0"]
    xt = torch.from_numpy(x)
    for a, b in zip(jt.attn_qkv(jblk, jnp.asarray(x), jnp.float32),
                    tt.attn_qkv(tblk, xt, torch.float32)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(
        tt.ffn_apply(tblk, xt, torch.float32).numpy(),
        np.asarray(jt.ffn_apply(jblk, jnp.asarray(x), jnp.float32)),
        atol=1e-5)
    np.testing.assert_allclose(
        tt._rmsnorm(tblk["ln1"], xt).numpy(),
        np.asarray(jt._rmsnorm(jblk["ln1"], jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("case", ["equal", "ragged", "scanned"])
def test_greedy_generate_matches_jax(case):
    _, jp = _jax_params(scan=case == "scanned")
    prompts = _tokens(3, 10, seed=2)
    kw = {}
    if case == "ragged":
        kw["prompt_lens"] = np.array([10, 4, 7], np.int32)
        for b, n in enumerate(kw["prompt_lens"]):
            prompts[b, :10 - n] = 0           # left padding
    want = np.asarray(jt.greedy_generate(jp, jnp.asarray(prompts), 12, **kw))
    got = tt.greedy_generate(lm_from_jax(jp), prompts, 12, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_zero_steps_like_jax():
    _, jp = _jax_params()
    prompts = _tokens(2, 5, seed=6)
    want = np.asarray(jt.greedy_generate(jp, jnp.asarray(prompts), 0))
    got = tt.greedy_generate(lm_from_jax(jp), prompts, 0)
    assert tuple(got.shape) == want.shape == (2, 0)


def test_greedy_generate_equals_no_cache_rollout():
    """Each cached step equals the argmax of a full forward over the
    prefix (the JAX package's own invariant, on the port)."""
    _, jp = _jax_params()
    params = lm_from_jax(jp)
    tmodel = tt.transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH,
                               heads=HEADS, max_len=MAX_LEN)
    seq = torch.from_numpy(_tokens(1, 6, seed=3))
    gen = tt.greedy_generate(params, seq, 5)[0].tolist()
    for t in gen:
        logits, _ = tmodel.apply(params, {}, seq)
        assert int(torch.argmax(logits[0, -1])) == t
        seq = torch.cat([seq, torch.tensor([[t]], dtype=seq.dtype)], 1)


def test_lm_convert_roundtrip_keeps_layouts():
    _, jp = _jax_params()
    tp = lm_from_jax(jp)
    for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
        assert tuple(tp["block0"][name].shape) == jp["block0"][name].shape
    back = lm_to_jax(tp)
    flat_a = jax.tree_util.tree_leaves(jp)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    bf = lm_from_jax(jp, dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16
    assert lm_to_jax(bf)["embed"].dtype == np.float32


def test_stack_unstack_roundtrip():
    _, jp = _jax_params()
    tp = lm_from_jax(jp)
    stacked = tt.stack_block_params(tp, DEPTH)
    _, js = _jax_params(scan=True)
    assert tuple(stacked["blocks"]["wq"].shape) == js["blocks"]["wq"].shape
    back = lm_to_jax(tt.unstack_block_params(stacked, DEPTH))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_init_draws_the_jax_distributions():
    """Same tree, shapes and dtypes as the JAX init; normal leaves with
    the JAX scales (not JAX's numbers); deterministic per generator."""
    _, jp = _jax_params()
    model = tt.transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                              max_len=MAX_LEN)
    a, _ = model.init(torch.Generator().manual_seed(5), device="cpu")
    b, _ = model.init(5, device="cpu")
    assert jax.tree_util.tree_structure(lm_to_jax(a)) == \
        jax.tree_util.tree_structure(jp)
    for x, y, z in zip(jax.tree_util.tree_leaves(lm_to_jax(a)),
                       jax.tree_util.tree_leaves(lm_to_jax(b)),
                       jax.tree_util.tree_leaves(jp)):
        assert x.shape == z.shape and x.dtype == z.dtype
        np.testing.assert_array_equal(x, y)
    blk = a["block0"]
    assert torch.equal(blk["ln1"]["scale"], torch.ones(DIM))
    assert torch.equal(blk["b1"], torch.zeros(4 * DIM))
    assert abs(float(a["embed"].std()) - DIM ** -0.5) < 0.02
    assert abs(float(blk["w2"].std()) - (4 * DIM) ** -0.5) < 0.01


def test_unported_options_raise():
    """Only the pipeline-parallel steps still wait (ROADMAP A11); a mesh
    axis asked for without the mesh names what is missing."""
    from distlearn_tpu_torch.train import lm as tlm
    _, jp = _jax_params()
    model = tt.transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                              max_len=MAX_LEN)
    for fn in (tlm.build_lm_pp_step, tlm.build_lm_pp_1f1b_step):
        with pytest.raises(NotImplementedError, match="A11"):
            fn(model, None, lm_from_jax(jp))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for kw in ({"seq_axis": "seq"}, {"tp_axis": "model"},
               {"ep_axis": "data"}):
        with pytest.raises(ValueError, match="mesh="):
            model.apply(lm_from_jax(jp), {}, tokens, **kw)


def test_generate_params_rejects_moe_like_jax():
    model = jt.transformer_lm(vocab=VOCAB, dim=DIM, depth=2, heads=HEADS,
                              max_len=MAX_LEN, moe_experts=2, moe_every=2)
    moe = jax.device_get(model.init(jax.random.PRNGKey(0))[0])
    with pytest.raises(ValueError) as want:
        jt.generate_params(moe)
    with pytest.raises(ValueError) as got:
        tt.generate_params(lm_from_jax(moe))
    assert str(got.value) == str(want.value)
