"""The port's numpy data layer gives the JAX package's arrays: the same
synthetic sets for the same seed, the same partitions, the same sampler
draws.  Every parity test of the port feeds on these."""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu import data as jdata  # noqa: E402
from distlearn_tpu_torch import data as tdata  # noqa: E402


@pytest.mark.parametrize("name", ["synthetic_cifar10", "synthetic_mnist"])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_sets_are_the_same_arrays(name, seed):
    jx, jy, jc = getattr(jdata, name)(64, seed=seed)
    tx, ty, tc = getattr(tdata, name)(64, seed=seed)
    assert tx.dtype == np.float32 and ty.dtype == np.int32
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tc == jc == 10


@pytest.mark.parametrize("partition,partitions", [(0, 1), (1, 3), (2, 3)])
def test_partitions_and_batch_sizes_match(partition, partitions):
    x, y, nc = tdata.synthetic_mnist(100, seed=1)
    jd = jdata.make_dataset(x, y, nc, partition, partitions)
    td = tdata.make_dataset(x, y, nc, partition, partitions)
    np.testing.assert_array_equal(td.x, jd.x)
    np.testing.assert_array_equal(td.y, jd.y)
    assert td.batches_per_epoch(8) == jd.batches_per_epoch(8)
    from distlearn_tpu.data.dataset import per_node_batch_size
    assert tdata.per_node_batch_size(256, partitions) == \
        per_node_batch_size(256, partitions)
    with pytest.raises(ValueError):
        tdata.make_dataset(x, y, nc, partitions, partitions)


@pytest.mark.parametrize("kind", ["permutation", "label-uniform"])
def test_samplers_draw_the_same_indices(kind):
    _, y, _ = tdata.synthetic_cifar10(96, seed=2)
    js, ts = jdata.make_sampler(kind, y, seed=3), tdata.make_sampler(kind, y,
                                                                     seed=3)
    for _ in range(2):                      # two epochs
        for a, b in zip(js.epoch(16), ts.epoch(16), strict=True):
            np.testing.assert_array_equal(a, b)
