"""The port's fused updates and flat buckets against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as the JAX suite runs
them).  On the CPU the port's wrappers take their plain PyTorch versions,
whose arithmetic the CUDA kernels repeat bit for bit on the card."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax import random  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.ops import flatten as jflat  # noqa: E402
from distlearn_tpu.ops import fused_update as jfu  # noqa: E402
from distlearn_tpu.parallel.mesh import MeshTree as JaxMeshTree  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax  # noqa: E402
from distlearn_tpu_torch.ops import flatten as tflat  # noqa: E402
from distlearn_tpu_torch.ops import fused_update as tfu  # noqa: E402
from distlearn_tpu_torch.parallel.mesh import init_mesh  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

# The JAX suite's own tolerance for these kernels (tests/test_ops.py:25-50)
# is rtol 1e-6.  XLA's CPU backend contracts p - lr*g into a fused
# multiply-add, which differs from the port's two roundings by at most one
# rounding of lr*g (< 3e-8 for these inputs): that is the atol, for results
# that cancel to near zero.
RTOL, ATOL = 1e-6, 1e-7
CIFAR_BUCKET = 4_329_472      # the full-width convnet's one f32 bucket


@pytest.fixture(scope="module")
def tree():
    # the tier-1 run shares the cores between several worker processes
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    mesh = init_mesh(store=dist.HashStore(), device="cpu")
    yield mesh
    dist.destroy_process_group()
    torch.set_num_threads(threads)


def _randn(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.mark.parametrize("n", [1024 * 7, CIFAR_BUCKET])
def test_fused_sgd_matches_jax(n):
    p, g, lr = _randn(n, 0), _randn(n, 1), 0.1
    out = tfu.fused_sgd(torch.from_numpy(p), torch.from_numpy(g), lr).numpy()
    ref = np.asarray(jfu.fused_sgd(jnp.asarray(p), jnp.asarray(g), lr))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # two separately rounded float32 ops, the arithmetic the kernel repeats
    np.testing.assert_array_equal(out, p - np.float32(lr) * g)


@pytest.mark.parametrize("n", [1024 * 7, CIFAR_BUCKET])
def test_fused_elastic_matches_jax(n):
    p, c, alpha = _randn(n, 2), _randn(n, 3), 0.2
    new_p, delta = tfu.fused_elastic(torch.from_numpy(p), torch.from_numpy(c),
                                     alpha)
    ref_p, ref_d = jfu.fused_elastic(jnp.asarray(p), jnp.asarray(c), alpha)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_d), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(new_p.numpy(), np.asarray(ref_p), rtol=RTOL,
                               atol=ATOL)
    d = (p - c) * np.float32(alpha)
    np.testing.assert_array_equal(delta.numpy(), d)
    np.testing.assert_array_equal(new_p.numpy(), p - d)


def _cifar_trees(seed=0):
    params, _ = jax_cifar().init(random.PRNGKey(seed))
    params = jax.device_get(params)
    rng = np.random.RandomState(seed)
    other = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), params)
    return params, other


def _assert_plans_equal(jspec, tspec):
    assert len(jspec.buckets) == len(tspec.buckets)
    for jb, tb in zip(jspec.buckets, tspec.buckets):
        assert (jb.idx, jb.sizes, jb.offsets, jb.padded) == \
            (tb.idx, tb.sizes, tb.offsets, tb.padded)


@pytest.mark.parametrize("max_bucket_bytes", [None, 4 << 20])
def test_sgd_update_buckets_matches_jax(max_bucket_bytes):
    params, grads = _cifar_trees()
    jspec = jflat.make_bucket_spec(grads, max_bucket_bytes)
    jout = jfu.sgd_update_buckets(jspec, params,
                                  jflat.pack_buckets(jspec, grads), 0.05)
    tparams, _ = from_jax(params, {})
    tgrads, _ = from_jax(grads, {})
    tspec = tflat.make_bucket_spec(tgrads, max_bucket_bytes)
    _assert_plans_equal(jspec, tspec)
    if max_bucket_bytes is None:
        assert [b.padded for b in tspec.buckets] == [CIFAR_BUCKET]
    tout = tfu.sgd_update_buckets(tspec, tparams,
                                  tflat.pack_buckets(tspec, tgrads), 0.05)
    expect, _ = from_jax(jax.device_get(jout), {})
    for a, b in zip(tree_leaves(tout), tree_leaves(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("max_bucket_bytes", [None, 4 << 20])
def test_elastic_round_buckets_matches_jax(tree, max_bucket_bytes):
    params, center = _cifar_trees(1)
    jtree = JaxMeshTree(num_nodes=1)
    jround = jtree.spmd(
        lambda p, c: jfu.elastic_round_buckets(p, c, 0.2, jtree.axis_name,
                                               max_bucket_bytes),
        in_specs=(P(), P()), out_specs=(P(), P()))
    jp, jc = jax.device_get(jround(params, center))
    tp, tc = tfu.elastic_round_buckets(from_jax(params, {})[0],
                                       from_jax(center, {})[0], 0.2, tree,
                                       max_bucket_bytes)
    for got, want in ((tp, jp), (tc, jc)):
        for a, b in zip(tree_leaves(got), tree_leaves(from_jax(want, {})[0])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_bucket_spec_roundtrip_mixed_dtypes():
    """Counterpart of tests/test_fused_wiring.py's mixed-dtype roundtrip."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(5, dtype=torch.float64),
            "c": torch.full((3, 3), 2.0, dtype=torch.float32),
            "d": torch.tensor(7.0, dtype=torch.float64)}
    spec = tflat.make_bucket_spec(tree)
    assert len(spec.buckets) == 2  # one per dtype, no casting
    flats = tflat.pack_buckets(spec, tree)
    for b, f in zip(spec.buckets, flats):
        assert f.dtype == b.dtype and tuple(f.shape) == (b.padded,)
        assert b.padded % tflat.TILE == 0
    back = tflat.unpack_buckets(spec, flats)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        torch.testing.assert_close(back[k], tree[k], rtol=0, atol=0)
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    _assert_plans_equal(jflat.make_bucket_spec(jtree), spec)


def test_bucket_spec_respects_max_bytes():
    """Counterpart of tests/test_fused_wiring.py's max-bytes split."""
    tree = [torch.zeros(1000) + i for i in range(10)]
    spec = tflat.make_bucket_spec(tree, max_bucket_bytes=3000 * 4)
    assert len(spec.buckets) >= 4          # <=3 leaves of 1000 f32 per bucket
    assert all(sum(b.sizes) <= 3000 for b in spec.buckets)
    flats = tflat.pack_buckets(spec, tree)
    back = tflat.unpack_buckets(spec, flats)
    for a, b in zip(back, tree):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # unpacked leaves are views into the bucket: no copy on the way out
    assert back[0].untyped_storage().data_ptr() == \
        flats[0].untyped_storage().data_ptr()
    _assert_plans_equal(
        jflat.make_bucket_spec([jnp.zeros(1000, jnp.float32)] * 10, 3000 * 4),
        spec)


def test_flat_spec_pack_unpack_roundtrip():
    params, _ = _cifar_trees()
    tparams, _ = from_jax(params, {})
    spec = tflat.make_spec(tparams)
    assert spec.padded == jflat.make_spec(params).padded == CIFAR_BUCKET
    back = tflat.unpack(spec, tflat.pack(spec, tparams))
    for a, b in zip(tree_leaves(back), tree_leaves(tparams)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_never_take_the_plain_route_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel's checks (and here, with no card, raises)."""
    before = (tfu.fused_sgd.launches, tfu.fused_elastic.launches)
    meta = torch.empty(1024, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_sgd(meta, meta, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_elastic(meta, meta, 0.1)
    # the plain route is not a launch
    tfu.fused_sgd(torch.zeros(8), torch.zeros(8), 0.1)
    assert (tfu.fused_sgd.launches, tfu.fused_elastic.launches) == before


def test_fused_enabled_priority(monkeypatch):
    monkeypatch.delenv("DISTLEARN_TPU_TORCH_FUSED", raising=False)
    assert tfu.fused_enabled(None, "cuda") is True
    assert tfu.fused_enabled(None, "cpu") is False
    assert tfu.fused_enabled(True, "cpu") is True
    monkeypatch.setenv("DISTLEARN_TPU_TORCH_FUSED", "0")
    assert tfu.fused_enabled(None, "cuda") is False
    assert tfu.fused_enabled(True, "cuda") is True
    monkeypatch.setenv("DISTLEARN_TPU_TORCH_FUSED", "1")
    assert tfu.fused_enabled(None, "cpu") is True
