"""The port's packed wire codec (``distlearn_tpu_torch/comm/wire.py``)
against the JAX package's on the same inputs: the same manifests and wire
bytes for every codec over the leaf zoo of tests/test_wire.py, the same
decoded values, the same structural rejections by ``parse_manifest``, and
the same stripe plans.  Everything is compared exactly: the codec is
deterministic numpy on both sides."""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu.comm import wire as jwire  # noqa: E402
from distlearn_tpu_torch.comm import wire  # noqa: E402


def _leaf_zoo():
    """Every layout class the codec must survive: float/int/unsigned,
    0-d, empty, and non-C-contiguous leaves (tests/test_wire.py)."""
    rng = np.random.RandomState(7)
    return [
        rng.randn(5, 3).astype(np.float32),
        rng.randn(17).astype(np.float64),
        rng.randn(2, 2).astype(np.float16),
        np.arange(12, dtype=np.int64).reshape(3, 4),
        np.arange(6, dtype=np.uint8),
        np.float32(3.25).reshape(()),
        np.zeros((0, 5), np.float32),
        np.asfortranarray(rng.randn(4, 6).astype(np.float32)),
        rng.randn(8, 8).astype(np.float32)[::2, 1::3],
    ]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(np.uint8)


@pytest.mark.parametrize("codec", jwire.CODECS)
def test_encode_leaves_same_manifest_and_bytes(codec):
    port = wire.encode_leaves(_leaf_zoo(), codec)
    ref = jwire.encode_leaves(_leaf_zoo(), codec)
    assert json.dumps(port.manifest) == json.dumps(ref.manifest)
    assert (port.wire_nbytes, port.logical_nbytes) == \
        (ref.wire_nbytes, ref.logical_nbytes)
    for p, r in zip(port.bufs, ref.bufs):
        assert p.dtype == r.dtype and p.shape == r.shape
        np.testing.assert_array_equal(_bits(p), _bits(r))


@pytest.mark.parametrize("codec", jwire.CODECS)
def test_decoded_equal(codec):
    port = wire.encode_leaves(_leaf_zoo(), codec).decoded()
    ref = jwire.encode_leaves(_leaf_zoo(), codec).decoded()
    for p, r in zip(port, ref):
        assert p.dtype == r.dtype and p.shape == r.shape
        np.testing.assert_array_equal(_bits(p), _bits(r))


@pytest.mark.parametrize("enc,scale", [("int8", 0.0123), ("fp16", None)])
def test_decode_into_equal(enc, scale):
    rng = np.random.RandomState(1)
    wdt = np.int8 if enc == "int8" else np.float16
    buf = (rng.randint(-127, 128, 300) if enc == "int8"
           else rng.randn(300)).astype(wdt)
    entry = {"enc": enc, "scale": scale}
    outs = [np.empty(300, np.float32) for _ in range(2)]
    wire.decode_into(entry, buf, outs[0])
    jwire.decode_into(entry, buf, outs[1])
    np.testing.assert_array_equal(_bits(outs[0]), _bits(outs[1]))
    for mod in (wire, jwire):
        with pytest.raises(ValueError, match="decode_into on 'raw'"):
            mod.decode_into({"enc": "raw"}, buf, outs[0])


def _manifest_bytes(doc):
    return json.dumps(doc).encode()


def _leaf(**kw):
    entry = {"dtype": "float32", "shape": [4], "enc": "raw", "offset": 0,
             "nbytes": 16}
    entry.update(kw)
    return entry


# (manifest bytes, data-region bytes, expect_n) — accepted and rejected
# manifests, the cases of tests/test_wire.py
_MANIFESTS = {
    "ok": (_manifest_bytes({"codec": "raw", "leaves": [_leaf()]}), 16, None),
    "ok_int8": (_manifest_bytes({"codec": "int8", "leaves": [_leaf(
        enc="int8", nbytes=4, scale=0.5)]}), 4, 1),
    "not_json": (b"not json", 16, None),
    "not_shaped": (_manifest_bytes({"v": 1}), 16, None),
    "unknown_codec": (_manifest_bytes({"codec": "zstd", "leaves": []}), 0,
                      None),
    "negative_dim": (_manifest_bytes({"codec": "raw", "leaves": [_leaf(
        shape=[-1])]}), 16, None),
    "unknown_enc": (_manifest_bytes({"codec": "raw", "leaves": [_leaf(
        enc="gzip")]}), 16, None),
    "non_float_int8": (_manifest_bytes({"codec": "int8", "leaves": [_leaf(
        dtype="int64", enc="int8", nbytes=4, scale=1.0)]}), 4, None),
    "missing_scale": (_manifest_bytes({"codec": "int8", "leaves": [_leaf(
        enc="int8", nbytes=4)]}), 4, None),
    "nan_scale": (_manifest_bytes({"codec": "int8", "leaves": [_leaf(
        enc="int8", nbytes=4, scale=float("nan"))]}), 4, None),
    "short_payload": (_manifest_bytes({"codec": "raw", "leaves": [_leaf(
        nbytes=8)]}), 8, None),
    "offset_gap": (_manifest_bytes({"codec": "raw", "leaves": [_leaf(
        offset=4)]}), 20, None),
    "frame_size": (_manifest_bytes({"codec": "raw", "leaves": [_leaf()]}),
                   99, None),
    "huge_shape": (_manifest_bytes({"codec": "raw", "leaves": [_leaf(
        shape=[2 ** 62, 2 ** 62])]}), 16, None),
    "entry_not_object": (_manifest_bytes({"codec": "raw", "leaves": [3]}),
                         0, None),
    "leaf_count": (_manifest_bytes({"codec": "raw", "leaves": [_leaf()]}),
                   16, 3),
}


@pytest.mark.parametrize("case", sorted(_MANIFESTS))
def test_parse_manifest_same_verdict(case):
    raw, data_nbytes, expect_n = _MANIFESTS[case]
    verdicts = []
    for mod in (wire, jwire):
        try:
            verdicts.append(("ok", mod.parse_manifest(raw, data_nbytes,
                                                      expect_n)))
        except ValueError as e:
            verdicts.append(("ValueError", str(e)))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0] == ("ok" if case.startswith("ok") else "ValueError")


_CONVNET_NBYTES = [256, 256, 512, 512, 1024, 1024, 2048, 2048, 19200, 256,
                   819200, 512, 3276800, 1024, 13107200, 2048, 40, 81920]


@pytest.mark.parametrize("nbytes", [[], [16], [4, 4, 4, 4, 4],
                                    [1000, 10, 10, 10, 5000, 1],
                                    _CONVNET_NBYTES],
                         ids=["empty", "one", "even", "skewed", "convnet"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_stripe_planners_agree(nbytes, shards):
    nelems = [max(1, b // 4) for b in nbytes]
    assert wire.plan_stripes(nbytes, shards) == \
        jwire.plan_stripes(nbytes, shards)
    splits = wire.plan_splits(nbytes, nelems, shards)
    assert splits == jwire.plan_splits(nbytes, nelems, shards)
    leaves = [np.arange(n, dtype=np.float32) for n in nelems]
    views = wire.split_views(leaves, splits)
    for a, b in zip(views, jwire.split_views(leaves, splits)):
        np.testing.assert_array_equal(a, b)
    merged = wire.merge_views(views, splits, [a.shape for a in leaves])
    for a, b in zip(merged, leaves):
        np.testing.assert_array_equal(a, b)


def test_frame_buffer_reserve_views_and_host_tensor():
    fb = wire.FrameBuffer()
    fb.reserve(100)
    buf0 = fb.buf
    fb.reserve(50)                       # grow-never-shrink
    assert fb.buf is buf0
    v = fb.view(4, 8, np.dtype(np.float32), (2,))
    v[...] = [1.5, -2.0]
    host = fb.host_tensor(12)
    assert host.dtype == torch.uint8 and host.numel() == 12
    np.testing.assert_array_equal(host.numpy()[4:].view(np.float32),
                                  [1.5, -2.0])
    stage = fb.device_stage(40, torch.device("cpu"))
    assert fb.device_stage(30, torch.device("cpu")) is stage
    assert fb.device_stage(64, torch.device("cpu")).numel() == 64
