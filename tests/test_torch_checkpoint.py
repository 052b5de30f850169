"""The port's checkpoints against the JAX package's: one npz format, so a
checkpoint written by either package restores in the other bit for bit
(float32 and bfloat16 leaves), with the same step listing, pruning and
validation errors; and the port's ``WeightTailer`` hot-swaps a JAX-written
checkpoint into a serving port engine behind the epoch fence."""

from __future__ import annotations

import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.models.transformer import greedy_generate as jax_greedy  # noqa: E402
from distlearn_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from distlearn_tpu.utils import checkpoint as jck  # noqa: E402
from distlearn_tpu_torch.models.convert import lm_from_jax  # noqa: E402
from distlearn_tpu_torch.serve.client import ServeClient  # noqa: E402
from distlearn_tpu_torch.serve.engine import DecodeEngine  # noqa: E402
from distlearn_tpu_torch.serve.server import ServeServer, restore_center  # noqa: E402
from distlearn_tpu_torch.utils import checkpoint as tck  # noqa: E402

VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, (5,)).astype(np.int32),
                  "d": [rng.standard_normal((2,)).astype(np.float32),
                        np.float32(rng.standard_normal())]}}


def _as_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def test_jax_written_restores_in_port(tmp_path):
    tree = _tree()
    jck.save_checkpoint(str(tmp_path), 7, tree, metadata={"epoch": 3})
    got, meta = tck.restore_checkpoint(str(tmp_path), _as_torch(tree))
    assert meta["step"] == 7 and meta["epoch"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.numpy(), got))):
        np.testing.assert_array_equal(a, b)
    got_np, _ = tck.restore_checkpoint(str(tmp_path), tree)   # numpy like
    assert isinstance(got_np["a"], np.ndarray)
    np.testing.assert_array_equal(got_np["b"]["c"], tree["b"]["c"])


def test_port_written_restores_in_jax(tmp_path):
    tree = _tree(1)
    tck.save_checkpoint(str(tmp_path), 2, _as_torch(tree),
                        metadata={"step": -1, "keys": "x"})
    got, meta = jck.restore_checkpoint(str(tmp_path), tree)
    assert meta["step"] == 2 and meta["keys"] != "x"   # reserved keys win
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bfloat16_leaves_cross_packages(tmp_path, writer):
    x = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "s": np.float32(1.5)}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16),
             "s": torch.tensor(1.5)}
    if writer == "jax":
        jck.save_checkpoint(str(tmp_path), 1, jtree)
        got, _ = tck.restore_checkpoint(str(tmp_path), ttree)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], ttree["w"])
    else:
        tck.save_checkpoint(str(tmp_path), 1, ttree)
        got, _ = jck.restore_checkpoint(str(tmp_path), jtree)
        np.testing.assert_array_equal(
            np.asarray(got["w"], np.float32),
            np.asarray(jtree["w"].astype(jnp.float32)))


def test_latest_step_and_prune_agree(tmp_path):
    tree = _tree()
    for step in (1, 5, 3, 9):
        tck.save_checkpoint(str(tmp_path / "p"), step, _as_torch(tree),
                            keep=2)
        jck.save_checkpoint(str(tmp_path / "j"), step, tree, keep=2)
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["ckpt_5.npz", "ckpt_9.npz"]
    assert tck.latest_step(str(tmp_path / "p")) == 9
    assert tck.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("bad,err", [
    ({"a": np.zeros((4, 3), np.float32)}, ValueError),
    ({"a": np.zeros((3, 4), np.float64)}, ValueError),
    ({"zz": np.zeros((3, 4), np.float32)}, KeyError),
])
def test_restore_validation_matches_jax(tmp_path, bad, err):
    jck.save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(err):
        jck.restore_checkpoint(str(tmp_path), bad)
    with pytest.raises(err):
        tck.restore_checkpoint(str(tmp_path), _as_torch(bad))
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "empty"), _as_torch(bad))


def test_restore_center_layout(tmp_path):
    tree = _tree(3)
    leaves = jax.tree_util.tree_leaves(tree)
    jck.save_checkpoint(str(tmp_path), 4, {"center": {
        str(i): x for i, x in enumerate(leaves)}}, metadata={"epoch": 2})
    got, meta = restore_center(str(tmp_path), _as_torch(tree))
    assert meta["epoch"] == 2
    np.testing.assert_array_equal(got["b"]["c"].numpy(), tree["b"]["c"])


def test_jax_checkpoint_hot_swapped_by_port_tailer(tmp_path):
    """A port server tails a directory the JAX package writes to: after
    the swap, a request decodes under the new weights (the JAX greedy
    stream of the JAX params it restored) and carries the new epoch."""
    params = jax.device_get(jax_lm(vocab=VOCAB, dim=DIM, depth=DEPTH,
                                   heads=HEADS, max_len=MAX_LEN)
                            .init(jax.random.PRNGKey(0))[0])
    new = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, params)
    prompt = np.random.default_rng(4).integers(1, VOCAB, 6).astype(np.int32)
    ref_new = np.asarray(jax_greedy(new, prompt[None], 5))[0].tolist()
    engine = DecodeEngine(lm_from_jax(params), num_slots=2, max_len=MAX_LEN,
                          page=8, device="cpu")
    srv = ServeServer(engine, ckpt_dir=str(tmp_path), ckpt_poll=0.01,
                      epoch=0, idle_wait=0.01).start()
    try:
        jck.save_checkpoint(str(tmp_path), 11, new, metadata={"epoch": 4})
        deadline = time.monotonic() + 30
        while srv.epoch != 4 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.epoch == 4 and srv.ckpt_step == 11
        chunks = []
        with ServeClient(srv.host, srv.port) as c:
            out = c.generate(prompt, 5, rid="after-swap",
                             on_chunk=lambda toks: chunks.append(toks))
    finally:
        srv.stop()
    assert out["tokens"] == ref_new
    assert out["epoch"] == 4
