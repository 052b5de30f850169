"""The port's staging (``distlearn_tpu_torch/ops/staging.py``) against the
JAX package's ``ops/staging.py``: numpy arrays and torch CPU tensors land
in the same frame bytes, in 16-byte-aligned windows whose views alias the
frame; the return trip makes fresh tensors.  (Tensors on the card stage
through a pinned frame: ``chip_smoke.py``'s host-collective phase holds
that route against the numpy route.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.comm import wire as jax_wire  # noqa: E402
from distlearn_tpu.ops import staging as jax_staging  # noqa: E402
from distlearn_tpu_torch.comm import wire as port_wire  # noqa: E402
from distlearn_tpu_torch.ops import staging  # noqa: E402


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(7).astype(np.float32),
            (np.arange(5, dtype=np.int64) * -3),
            rng.randn(3).astype(np.float64),
            rng.randint(-9, 9, 13).astype(np.int32),
            np.zeros(0, np.float32),
            rng.randn(1).astype(np.float32)]


def _zeroed(mod, nbytes=512):
    fb = mod.FrameBuffer(nbytes)
    fb.buf[:] = 0            # padding bytes compare equal too
    return fb


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_stage_into_frame_bytes_match_jax(kind):
    arrays = _arrays()
    dtypes = [a.dtype for a in arrays]
    jfb = _zeroed(jax_wire)
    jviews = jax_staging.stage_into(jfb, arrays, dtypes)
    pfb = _zeroed(port_wire)
    src = [torch.from_numpy(a.copy()) for a in arrays] if kind == "torch" \
        else arrays
    pviews = staging.stage_into(pfb, src, dtypes)
    total = jviews[-1].ctypes.data + jviews[-1].nbytes - jfb.buf.ctypes.data
    assert bytes(pfb.buf[:total]) == bytes(jfb.buf[:total])
    for pv, jv in zip(pviews, jviews):
        assert pv.dtype == jv.dtype and pv.shape == jv.shape
        off = pv.ctypes.data - pfb.buf.ctypes.data
        assert off == jv.ctypes.data - jfb.buf.ctypes.data
        assert off % 16 == 0


def test_views_alias_the_frame_and_are_reused():
    fb = port_wire.FrameBuffer()
    a = torch.arange(7, dtype=torch.float32)
    b = torch.arange(5, dtype=torch.int64) * -3
    views = staging.stage_into(fb, [a, b], [np.float32, np.int64])
    # a is 28 bytes, so b's window starts at offset 32, not 28
    assert views[1].ctypes.data - views[0].ctypes.data == 32
    for v in views:
        assert np.shares_memory(v, fb.buf)
    views[0][2] = 99.0           # a write through a view is a frame write
    assert fb.buf[8:12].view(np.float32)[0] == 99.0
    assert a[2] == 2.0           # ... and never reaches the source
    buf = fb.buf
    views2 = staging.stage_into(fb, [a * 2, b * 2], [np.float32, np.int64])
    assert fb.buf is buf         # same size: no new allocation
    np.testing.assert_array_equal(views2[0], (a * 2).numpy())
    np.testing.assert_array_equal(views2[1], (b * 2).numpy())


def test_unstage_makes_fresh_tensors():
    fb = port_wire.FrameBuffer()
    a = torch.randn(6, dtype=torch.float64)
    views = staging.stage_into(fb, [a], [np.float64])
    out = staging.unstage(fb, [views[0].reshape(2, 3)], torch.device("cpu"))
    assert out[0].shape == (2, 3) and out[0].dtype == torch.float64
    torch.testing.assert_close(out[0].reshape(-1), a, rtol=0, atol=0)
    views[0][:] = 0              # the frame is reused by the next round
    assert torch.equal(out[0].reshape(-1), a)
    assert fb.busy is None       # no asynchronous copy on the CPU


def test_windows_and_stage_reject_bad_input():
    fb = port_wire.FrameBuffer()
    with pytest.raises(ValueError, match="flat"):
        staging.stage_into(fb, [torch.zeros(2, 2)], [np.float32])
    with pytest.raises(ValueError, match="dtypes"):
        staging.stage_into(fb, [torch.zeros(2)], [])
    with pytest.raises(TypeError):
        staging.numpy_dtype(torch.bfloat16)
    assert staging.numpy_dtype(torch.float32) == np.float32


class _Copies:
    """Stands in for the event ``unstage`` leaves on a frame on the card."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


@pytest.mark.parametrize("topology", ["tree", "ring"])
def test_close_waits_for_the_copies_back(topology):
    """``close`` waits for the last copies out of the handle's frame, so
    the frame cannot go back to the allocator while they read it."""
    from distlearn_tpu_torch.comm.ring import LocalhostRing
    from distlearn_tpu_torch.comm.tree import LocalhostTree, tree_map_spawn

    from tests.net_util import reserve_port_window
    make = LocalhostTree if topology == "tree" else LocalhostRing
    n, port = 2, reserve_port_window(1)

    def node(rank):
        h = make(rank, n, port)
        out, m = h.all_reduce([torch.full((5,), float(rank + 1))])
        copies = h._frame.busy = _Copies()
        h.close()
        return out[0], m, copies.waited, h._frame.busy

    for out, m, waited, busy in tree_map_spawn(node, n):
        assert m == n and torch.equal(out, torch.full((5,), 3.0))
        assert waited and busy is None
