"""The port's sharded checkpoints against the JAX package's
(``distlearn_tpu/utils/checkpoint.py::save_sharded_checkpoint`` and
``restore_sharded_checkpoint``; ``tests/test_checkpoint.py:92-246`` and
``tests/test_multihost.py:167``): the same ``ckpt_{step}.shard{p}.npz``
files, key by key, so that a file either package writes restores in the
other bit for bit, bfloat16 leaves included; and the ZeRO-1 LM resume of
``tests/test_optax_step.py:385`` on 4 gloo ranks (child processes through
``tests/torch_mesh_worker.py``), each rank saving its own rows, at JAX's
tolerance (``rtol=1e-6`` on the loss) — here bit for bit — over the data
axis and over a (data, seq, model) mesh.
"""

from __future__ import annotations

import json
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu.utils import checkpoint as jckpt  # noqa: E402
from distlearn_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from distlearn_tpu_torch.utils.checkpoint import Shard  # noqa: E402

import torch_mesh_worker  # noqa: E402

LMZ = dict(vocab=64, dim=32, depth=2, heads=4, max_len=16)
NAMES = ("data", "seq", "model")


def _rows(a, n):
    """Row ``p`` of ``a`` (``[n, ...]``) as process ``p``'s record."""
    per = a.shape[0] // n
    return [Shard(a[p * per:(p + 1) * per],
                  [[p * per, (p + 1) * per]] + [[0, d] for d in a.shape[1:]],
                  a.shape) for p in range(n)]


def _save_by_process(d, step, trees, **kw):
    for p, tree in enumerate(trees):
        ckpt.save_sharded_checkpoint(d, step, tree, process_index=p, **kw)


def test_sharded_checkpoint_roundtrip_rows(tmp_path):
    """tests/test_checkpoint.py::test_sharded_checkpoint_roundtrip_mesh:
    8 processes, a leaf split by rows, a replicated leaf written once and a
    host leaf reassemble to the exact global arrays."""
    m = np.arange(64, dtype=np.float32).reshape(8, 8)
    w = np.arange(5, dtype=np.float64) * 1.5
    host = np.arange(3, dtype=np.int64)
    trees = [{"opt": {"m": r}, "w": w if p == 0 else None,
              "host": host if p == 0 else None}
             for p, r in enumerate(_rows(torch.from_numpy(m), 8))]
    d = str(tmp_path)
    _save_by_process(d, 7, trees, metadata={"note": "x"})
    like = {"opt": {"m": np.zeros((8, 8), np.float32)},
            "w": np.zeros(5, np.float64), "host": np.zeros(3, np.int64)}
    restored, meta = ckpt.restore_sharded_checkpoint(d, like)
    assert meta["step"] == 7 and meta["note"] == "x"
    np.testing.assert_array_equal(restored["opt"]["m"], m)
    np.testing.assert_array_equal(restored["w"], w)
    np.testing.assert_array_equal(restored["host"], host)
    # a process restores only its own region, as a tensor
    mine, _ = ckpt.restore_sharded_checkpoint(
        d, {"opt": {"m": _rows(torch.zeros(8, 8), 8)[3]},
            "w": torch.empty(5, dtype=torch.float64, device="meta"),
            "host": np.zeros(3, np.int64)})
    assert torch.equal(mine["opt"]["m"], torch.from_numpy(m[3:4]))
    assert torch.equal(mine["w"], torch.from_numpy(w))


def test_sharded_checkpoint_zero1_state(tmp_path):
    """tests/test_checkpoint.py::test_sharded_checkpoint_zero1_state: the
    ZeRO-1 state (params, the float32 master row and Adam's count, mu, nu)
    round-trips through the records on a one-rank tree."""
    import torch.distributed as dist
    from distlearn_tpu_torch.models.convert import (lm_zero_records,
                                                    lm_zero_restore)
    from distlearn_tpu_torch.models.transformer import transformer_lm
    from distlearn_tpu_torch.parallel.mesh import init_mesh
    from distlearn_tpu_torch.train import optim
    tree = init_mesh(store=dist.HashStore(), device="cpu")
    try:
        params = transformer_lm(**LMZ).init(0, device="cpu")[0]
        tx = optim.adam(1e-3)
        st = optim.init_lm_zero_state(params, tree, tx)
        d = str(tmp_path)
        ckpt.save_sharded_checkpoint(d, 1, lm_zero_records(st, tree))
        got, meta = lm_zero_restore(d, optim.init_lm_zero_state(
            params, tree, optim.adam(1e-3)), tree)
    finally:
        dist.destroy_process_group()
    assert meta["step"] == 1 and meta["process"] == 0
    from distlearn_tpu_torch.utils.tree import tree_leaves
    for a, b in zip(tree_leaves(got), tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sharded_checkpoint_missing_shard_file_raises(tmp_path):
    a = torch.arange(16, dtype=torch.float32)
    d = str(tmp_path)
    # two processes each hold half; only process 0's file is written
    ckpt.save_sharded_checkpoint(d, 1, {"a": _rows(a, 2)[0]},
                                 process_index=0)
    with pytest.raises(ValueError, match="cover"):
        ckpt.restore_sharded_checkpoint(d, {"a": np.zeros(16, np.float32)})


def test_sharded_checkpoint_bf16_leaf_roundtrip(tmp_path):
    vals = (torch.arange(64, dtype=torch.float32) / 7.0).reshape(8, 8)
    wp = vals.to(torch.bfloat16)
    d = str(tmp_path)
    _save_by_process(d, 2, [{"wp": r} for r in _rows(wp, 8)])
    restored, meta = ckpt.restore_sharded_checkpoint(
        d, {"wp": torch.empty(8, 8, dtype=torch.bfloat16, device="meta")})
    assert meta["step"] == 2
    assert restored["wp"].dtype == torch.bfloat16
    assert torch.equal(restored["wp"].view(torch.int16),
                       wp.view(torch.int16))


def test_sharded_checkpoint_dtype_and_shape_checked(tmp_path):
    d = str(tmp_path)
    ckpt.save_sharded_checkpoint(d, 1, {"a": torch.zeros(4)},
                                 process_index=0)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore_sharded_checkpoint(d, {"a": np.zeros(4, np.float64)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_sharded_checkpoint(d, {"a": np.zeros(5, np.float32)})
    with pytest.raises(KeyError):
        ckpt.restore_sharded_checkpoint(d, {"b": np.zeros(4, np.float32)})


def test_sharded_checkpoint_across_processes(tmp_path):
    """tests/test_multihost.py::test_sharded_checkpoint_across_processes:
    each process saves only its half; offline reassembly recovers the
    global array, with JAX's restore too."""
    glob = np.arange(32, dtype=np.float32).reshape(8, 4)
    d = str(tmp_path)
    _save_by_process(d, 3, [{"a": r} for r in
                            _rows(torch.from_numpy(glob), 2)])
    like = {"a": np.zeros((8, 4), np.float32)}
    restored, meta = ckpt.restore_sharded_checkpoint(d, like)
    assert meta["step"] == 3
    np.testing.assert_array_equal(restored["a"], glob)
    jrestored, _ = jckpt.restore_sharded_checkpoint(d, like)
    np.testing.assert_array_equal(jrestored["a"], glob)


def test_sharded_prune_keeps_newest_and_young_files(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save_sharded_checkpoint(d, step, {"a": torch.zeros(2)},
                                     keep=2, process_index=0)
    # files younger than the grace period survive the prune
    assert ckpt.latest_sharded_step(d) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_1.shard0.npz", "ckpt_2.shard0.npz", "ckpt_3.shard0.npz"]
    old = ckpt._PRUNE_GRACE_SECS
    ckpt._PRUNE_GRACE_SECS = -1.0
    try:
        ckpt.save_sharded_checkpoint(d, 4, {"a": torch.zeros(2)}, keep=2,
                                     process_index=0)
    finally:
        ckpt._PRUNE_GRACE_SECS = old
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_3.shard0.npz", "ckpt_4.shard0.npz"]


def _jax_mesh_state():
    tree = JaxMeshTree(num_nodes=8)
    vals = (np.arange(64, dtype=np.float32) / 7.0).reshape(8, 8)
    return {"opt": {"m": jax.device_put(
                jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                NamedSharding(tree.mesh, P("data")))},
            "w": jax.device_put(jnp.arange(5, dtype=jnp.float32) * 1.5,
                                NamedSharding(tree.mesh, P())),
            "wp": jax.device_put(jnp.asarray(vals, jnp.bfloat16),
                                 NamedSharding(tree.mesh, P("data"))),
            "host": np.arange(3, dtype=np.int64)}


def test_jax_written_files_restore_in_the_port(tmp_path):
    """A JAX sharded checkpoint of an 8-device mesh's arrays (rows, a
    replicated leaf, bfloat16 rows, a host leaf) restores in the port bit
    for bit: whole, and one process's region."""
    state = _jax_mesh_state()
    d = str(tmp_path)
    jckpt.save_sharded_checkpoint(d, 5, state, process_index=0)
    like = {"opt": {"m": torch.empty(8, 8, device="meta")},
            "w": np.zeros(5, np.float32),
            "wp": torch.empty(8, 8, dtype=torch.bfloat16, device="meta"),
            "host": torch.empty(3, dtype=torch.int64, device="meta")}
    got, meta = ckpt.restore_sharded_checkpoint(d, like)
    host = jax.device_get(state)
    assert meta["step"] == 5
    np.testing.assert_array_equal(got["opt"]["m"].numpy(), host["opt"]["m"])
    np.testing.assert_array_equal(got["w"], host["w"])
    assert got["wp"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["wp"].view(torch.int16).numpy(),
                                  np.asarray(host["wp"]).view(np.int16))
    np.testing.assert_array_equal(got["host"].numpy(), host["host"])
    part, _ = ckpt.restore_sharded_checkpoint(
        d, dict(like, wp=_rows(torch.zeros(8, 8, dtype=torch.bfloat16),
                               4)[1]))
    np.testing.assert_array_equal(part["wp"].view(torch.int16).numpy(),
                                  np.asarray(host["wp"])[2:4].view(np.int16))


def test_port_written_files_restore_in_jax(tmp_path):
    """The reverse: 8 port processes' files (float32 and bfloat16 rows, a
    replicated leaf written once, a host leaf) restore through JAX's
    ``restore_sharded_checkpoint`` into JAX's layout bit for bit."""
    state = jax.device_get(_jax_mesh_state())
    m = torch.from_numpy(np.array(state["opt"]["m"]))
    wp = torch.from_numpy(np.array(state["wp"]).view(np.int16)) \
        .view(torch.bfloat16)
    trees = [{"opt": {"m": a}, "wp": b,
              "w": torch.tensor(state["w"]) if p == 0 else None,
              "host": state["host"] if p == 0 else None}
             for p, (a, b) in enumerate(zip(_rows(m, 8), _rows(wp, 8)))]
    d = str(tmp_path)
    _save_by_process(d, 6, trees)
    with open(f"{d}/ckpt_6.shard3.npz", "rb") as f, np.load(f) as z:
        meta = json.loads(str(z["__meta__"]))
    assert meta["shards"]["wp!"] == {"shape": [8, 8], "dtype": "bfloat16"}
    assert meta["shards"]["wp#0"] == {"leaf": "wp", "index": [[3, 4], [0, 8]]}
    got, jmeta = jckpt.restore_sharded_checkpoint(d, state)
    assert jmeta["step"] == 6
    np.testing.assert_array_equal(got["opt"]["m"], state["opt"]["m"])
    np.testing.assert_array_equal(got["w"], state["w"])
    assert got["wp"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["wp"]).view(np.uint16),
                                  np.asarray(state["wp"]).view(np.uint16))
    np.testing.assert_array_equal(got["host"], state["host"])


# -- the ZeRO-1 LM resume on 4 gloo ranks --------------------------------------

def _jax_zero(out_dir, params, toks):
    """tests/test_optax_step.py:385's JAX run: two ZeRO-1 steps on the
    4-node tree, its sharded checkpoint, and the state pickled for the
    ranks; returns the JAX templates the port files restore into."""
    import optax
    from distlearn_tpu.models.transformer import transformer_lm
    from distlearn_tpu.train import (build_lm_zero_step,
                                     init_lm_zero_mesh_state,
                                     init_lm_zero_state)
    from jax.sharding import Mesh
    from distlearn_tpu.models.transformer import param_specs
    tree = JaxMeshTree(num_nodes=4)
    lm = transformer_lm(**LMZ)
    tx = optax.adam(1e-3)
    st = init_lm_zero_state(params, tree, tx)
    step = build_lm_zero_step(lm, tree, tx, donate=False)
    tk = jax.device_put(toks, NamedSharding(tree.mesh, P("data")))
    for _ in range(2):
        st, _ = step(st, tk)
    jckpt.save_sharded_checkpoint(f"{out_dir}/jax", 2, st._asdict(),
                                  process_index=0)
    with open(f"{out_dir}/jax_state.pkl.tmp", "wb") as f:
        pickle.dump(jax.device_get(st), f)
    os.replace(f"{out_dir}/jax_state.pkl.tmp", f"{out_dir}/jax_state.pkl")
    # the (data, seq, model) mesh state's layout, for the port's files
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 1, 2), NAMES)
    sh = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, P(*s)), param_specs(params, "model"))
    mst = init_lm_zero_mesh_state(jax.device_put(params, sh), mesh, tx)
    return {"zero": jax.device_get(init_lm_zero_state(params, tree,
                                                      tx)._asdict()),
            "zero_mesh": jax.device_get(mst._asdict())}


@pytest.fixture(scope="module")
def zero_run(tmp_path_factory):
    def compute():
        from distlearn_tpu.models.transformer import transformer_lm
        tmp = tmp_path_factory.mktemp("zero_ckpt")
        params = jax.device_get(transformer_lm(**LMZ).init(
            jax.random.PRNGKey(0))[0])
        toks = np.random.RandomState(0).randint(0, 64, (8, 16)) \
            .astype(np.int32)
        base = dict(kind="zero_ckpt", cfg=LMZ, lr=1e-3, params=params,
                    tokens=toks)
        cases = [
            dict(base, name="zero", mesh=(4,), names=("data",),
                 dir=f"{tmp}/port", jax_dir=f"{tmp}/jax",
                 jax_state_file=f"{tmp}/jax_state.pkl"),
            dict(base, name="zero_mesh", mesh=(2, 1, 2), names=NAMES,
                 dir=f"{tmp}/port_mesh",
                 tokens=np.random.RandomState(1).randint(0, 64, (8, 16))
                 .astype(np.int32))]
        ranks, tmpl = torch_mesh_worker.spawn(
            4, cases, str(tmp), meanwhile=lambda: _jax_zero(str(tmp),
                                                            params, toks))
        # JAX reads the ranks' files into its own layout
        jgot = {name: jckpt.restore_sharded_checkpoint(
            f"{tmp}/{d}", tmpl[name])[0]
            for name, d in (("zero", "port"), ("zero_mesh", "port_mesh"))}
        return ranks, jgot
    return torch_mesh_worker.once_per_session("zero_ckpt", tmp_path_factory,
                                              compute)


@pytest.mark.parametrize("name", ["zero", "zero_mesh"])
def test_lm_zero_resume_from_sharded_checkpoint(zero_run, name):
    """tests/test_optax_step.py:385: the resumed run's loss and params
    match the uninterrupted run's (JAX holds rtol 1e-6 on the loss; the
    port's restored state is its saved state bit for bit, so the resumed
    steps are the same computation)."""
    ranks, _ = zero_run
    for r in ranks:
        res = r[name]
        assert res["meta"]["step"] == 2 and res["meta"]["note"] == "zero"
        assert res["restored_equal"]
        ref, got = res["losses"]
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert got == ref and res["params_equal"]


@pytest.mark.parametrize("name", ["zero", "zero_mesh"])
def test_port_zero_files_restore_in_jax_layout(zero_run, name):
    """JAX's restore_sharded_checkpoint reads the 4 ranks' files into its
    LMZeroState layout: the master ``[n, chunk]`` (``[dp, tp, chunk]`` on
    the mesh) and Adam's rows are the ranks' rows stacked, and the params
    are the whole tree, bit for bit."""
    ranks, jgot = zero_run
    got = jgot[name]
    mine = [r[name] for r in ranks]
    lead = (4,) if name == "zero" else (2, 2)
    order = sorted(range(4), key=lambda i: mine[i]["index"])
    if name == "zero_mesh":
        # the (data, seq, model) ranks' rows at [d, t]
        order = sorted(range(4), key=lambda i: (mine[i]["index"][0],
                                                mine[i]["index"][2]))
    master = np.stack([mine[i]["saved"][0][0] for i in order]) \
        .reshape(lead + (-1,))
    np.testing.assert_array_equal(got["master"], master)
    opt = jax.tree_util.tree_leaves(got["opt_state"])
    for k, leaf in enumerate(opt):
        rows = np.stack([mine[i]["saved"][1][k][0] for i in order])
        np.testing.assert_array_equal(np.asarray(leaf),
                                      rows.reshape(lead + rows.shape[1:]))
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(mine[0]["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_zero_file_restores_in_the_port(zero_run):
    """Each rank restores its rows of the JAX package's sharded checkpoint
    of its own LMZeroState: equal bit for bit to ``lm_zero_from_jax`` of
    that state."""
    ranks, _ = zero_run
    for r in ranks:
        assert r["zero"]["from_jax_equal"] and all(r["zero"]["from_jax_equal"])
