"""The port's data modules added for the examples, against the JAX
package's (``distlearn_tpu/data``), on the CPU:

* ``load_npz`` and the ``synthetic_hard*`` / ``synthetic_imagenet`` sets:
  the same arrays from the same file or seed, exactly, and the
  tests/test_data.py properties of the hard set (a linear probe at chance,
  the two factors decodable);
* ``DeviceDataset``: gathered batches equal host indexing
  (tests/test_data.py::test_device_dataset_gather_matches_host);
* ``batch_iterator`` and ``prefetch_to_device``: shapes and the processor
  (tests/test_data.py::test_batch_iterator_shapes_and_processor), and the
  prefetched batches equal the host iterator's in order and value.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu import data as jdata  # noqa: E402
from distlearn_tpu.data import dataset as jdataset  # noqa: E402
from distlearn_tpu_torch import data as tdata  # noqa: E402
from distlearn_tpu_torch import obs  # noqa: E402
from distlearn_tpu_torch.data import dataset as tdataset  # noqa: E402


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("case", [
    ("synthetic_hard", dict(n=64)),
    ("synthetic_hard", dict(n=48, shape=(16, 16, 1), num_classes=4,
                            label_noise=0.1, return_latents=True)),
    ("synthetic_hard", dict(n=32, label_noise=0.0, signal=4.0)),
    ("synthetic_hard_cifar10", dict(n=64)),
    ("synthetic_imagenet", dict(n=4, image_size=32, num_classes=10)),
    ("synthetic_imagenet", dict(n=2)),
], ids=["hard", "hard-latents", "hard-clean", "hard-cifar10", "imagenet32",
        "imagenet224"])
def test_synthetic_sets_are_the_same_arrays(case, seed):
    name, kw = case
    _equal(getattr(tdata, name)(seed=seed, **kw),
           getattr(jdata, name)(seed=seed, **kw))


@pytest.mark.parametrize("shape", [(32, 32, 3), (30, 30, 1), (224, 224, 3)])
def test_smooth_templates_and_factor_templates_match(shape):
    _equal([tdataset._smooth_templates(np.random.RandomState(3), 5, shape)],
           [jdataset._smooth_templates(np.random.RandomState(3), 5, shape)])
    # the hard set's factor templates: mode (a, 0) minus mode (0, 0) of a
    # noise-free, signal-only draw isolates ta[a] - ta[0]
    for tag in (1, 2):
        t = tdataset.make_templates(tag, 4, shape)
        assert t.shape == (4,) + shape and t.dtype == np.float32
    x, _, a, b = jdata.synthetic_hard(200, shape[:2] + (1,), 4, seed=0,
                                      label_noise=0.0, return_latents=True)
    amp = 8.0 / np.sqrt(np.prod(shape[:2]))
    ta = tdataset.make_templates(1, 4, shape[:2] + (1,))
    tb = tdataset.make_templates(2, 4, shape[:2] + (1,))
    resid = x - (ta[a] + tb[b]) * amp        # what is left is the noise
    assert abs(float(resid.std()) - 0.5) < 0.05


@pytest.mark.parametrize("num_classes", [None, 12])
def test_load_npz_matches_jax(tmp_path, num_classes):
    rng = np.random.RandomState(0)
    path = tmp_path / "set.npz"
    np.savez(path, x=rng.randn(6, 4, 4, 1).astype(np.float64),
             y=rng.randint(0, 9, 6).astype(np.int64),
             feats=rng.randn(6, 3), labels=np.arange(6))
    for keys in ({}, {"x_key": "feats", "y_key": "labels"}):
        _equal(tdata.load_npz(str(path), num_classes=num_classes, **keys),
               jdata.load_npz(str(path), num_classes=num_classes, **keys))


def test_synthetic_hard_linear_probe_at_chance():
    """tests/test_data.py's check on the port's copy: every class mixes all
    factor modes equally, so a linear model on pixels sits near chance."""
    x, y = tdata.synthetic_hard(3000, (16, 16, 1), 4, seed=0, label_noise=0.0)
    flat = np.concatenate([x.reshape(len(x), -1),
                           np.ones((len(x), 1), np.float32)], 1)
    onehot = np.eye(4, dtype=np.float32)[y]
    w, *_ = np.linalg.lstsq(flat[:2000], onehot[:2000], rcond=None)
    acc = float(((flat[2000:] @ w).argmax(1) == y[2000:]).mean())
    assert acc < 0.45, acc
    means = np.stack([x[y == c].mean(0) for c in range(4)])
    assert np.abs(means - means.mean(0)).max() < 0.15 * np.abs(x).mean()


def test_synthetic_hard_is_decodable_nonlinearly():
    C = 4
    x, y, a, b = tdata.synthetic_hard(4000, (16, 16, 1), C, seed=1,
                                      label_noise=0.1, return_latents=True)
    tr, te = slice(0, 3000), slice(3000, None)
    flat = x.reshape(len(x), -1)
    cents, labels = [], []
    for ai in range(C):
        for bi in range(C):
            m = (a[tr] == ai) & (b[tr] == bi)
            cents.append(flat[tr][m].mean(0))
            labels.append((ai + bi) % C)
    d = ((flat[te][:, None] - np.stack(cents)[None]) ** 2).sum(-1)
    acc = float((np.asarray(labels)[d.argmin(1)] == y[te]).mean())
    # the oracle decodes the factors; label noise 0.1 caps it near 0.925
    assert 0.8 < acc < 0.97, acc


def test_device_dataset_gather_matches_host():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    dds = tdata.DeviceDataset(x, y, 10, device="cpu")
    assert dds.size == 64 and dds.batches_per_epoch(16) == 4
    idx = np.array([5, 3, 60, 1, 7, 2, 9, 11], np.int64)
    bx, by = dds.gather(idx)
    np.testing.assert_array_equal(bx.numpy(), x[idx])
    np.testing.assert_array_equal(by.numpy(), y[idx])
    tx, ty = dds.take(torch.from_numpy(idx))
    assert torch.equal(tx, bx) and torch.equal(ty, by)
    sampler = tdata.PermutationSampler(64, seed=0)
    want = [i for i in tdata.PermutationSampler(64, seed=0).epoch(16)]
    got = list(dds.batches(sampler, 16))
    assert len(got) == 4
    for (gx, gy), i in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), x[i])
        np.testing.assert_array_equal(gy.numpy(), y[i])


def test_device_dataset_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DeviceDataset(np.zeros((2, 1)), np.zeros(2, np.int32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tdata.prefetch_to_device(iter([(np.zeros(1),)])))


def test_batch_iterator_shapes_and_processor():
    x, y, nc = tdata.synthetic_mnist(128)
    ds = tdata.make_dataset(x, y, nc)
    proc = lambda bx, by: (bx * 2.0, by)
    got = list(tdata.batch_iterator(ds, tdata.PermutationSampler(128, 0), 32,
                                    processor=proc))
    want = list(jdata.batch_iterator(ds, jdata.PermutationSampler(128, 0), 32,
                                     processor=proc))
    assert len(got) == 4
    assert got[0][0].shape == (32, 32, 32, 1) and got[0][1].shape == (32,)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_yields_the_host_batches_in_order(size):
    x, y, nc = tdata.synthetic_mnist(96, seed=2)
    ds = tdata.make_dataset(x, y, nc)
    host = list(tdata.batch_iterator(ds, tdata.PermutationSampler(96, 1), 16))
    got = list(tdata.prefetch_to_device(
        tdata.batch_iterator(ds, tdata.PermutationSampler(96, 1), 16),
        size=size, device="cpu"))
    assert len(got) == len(host) == 6
    for (gx, gy), (hx, hy) in zip(got, host):
        assert isinstance(gx, torch.Tensor) and gx.dtype == torch.float32
        np.testing.assert_array_equal(gx.numpy(), hx)
        np.testing.assert_array_equal(gy.numpy(), hy)
    # the depth gauge ends at 0: the queue drained
    assert obs.gauge("data_prefetch_depth").value == 0
