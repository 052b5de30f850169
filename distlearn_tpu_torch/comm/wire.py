"""Packed tensor-list wire codec — a copy of ``distlearn_tpu/comm/wire.py``
(the numpy codec and the stripe planners), whose :class:`FrameBuffer` may
also be page-locked and carry a device-side twin for the port's tensor
route.  It is the coalesced frame format behind
``Conn.send_tensors``/``recv_tensors`` (kind ``'P'`` in comm/transport.py).

The reference syncs a model as one frame per pytree leaf; at 18 leaves per
CIFAR convnet that is 18 header round-trips of kernel/syscall overhead per
direction per sync.  A packed frame ships the whole leaf list as ONE frame:

    payload := hlen:u32le | manifest[hlen] | data bytes
    manifest = JSON {"v": 1, "codec": str, "leaves": [entry...]}
    entry    = {"dtype": str, "shape": [int...], "enc": str,
                "offset": int, "nbytes": int, ("scale": float)}

``offset``/``nbytes`` describe each leaf's slice of the data region in
WIRE bytes (post-encoding); ``dtype``/``shape`` are the logical tensor.
Per-leaf ``enc`` lets one frame mix encodings: non-float leaves ride raw
inside an fp16/int8 frame.

Codecs (QSGD, Alistarh et al. 2017; 1-bit SGD, Seide et al. 2014 — the
error-feedback residual lives in parallel/async_ea.py, client side):

* ``raw``  — pass-through; zero-copy views of the caller's arrays.
* ``fp16`` — float leaves cast to float16 (half the bytes).
* ``int8`` — float leaves scaled per leaf by ``max|x|/127`` and rounded
  to int8 (quarter the bytes of f32); ``scale`` rides in the manifest.

Everything here is transport-agnostic and side-effect free; framing,
metrics, and stream-alignment-on-error live in comm/transport.py.
"""

from __future__ import annotations

import math

import numpy as np

#: Codec ids a peer may request/advertise.  Order is preference order.
CODECS = ("raw", "fp16", "int8")

#: Manifest schema version (bumped on incompatible manifest changes).
WIRE_V = 1

_ENC_WIRE_DTYPE = {"fp16": np.dtype(np.float16), "int8": np.dtype(np.int8)}


class PackedPayload:
    """One encoded leaf list, ready for ``Conn.send_packed``.

    ``bufs[i]`` is the wire-format array for ``manifest["leaves"][i]`` —
    the original array itself for raw leaves (zero copy), a fresh
    fp16/int8 array for encoded ones.  ``frame`` is non-None when every
    wire byte lives in ONE contiguous staging region (a
    :class:`FrameBuffer`): the transport then ships a single iovec
    instead of a per-leaf gather.
    """

    __slots__ = ("manifest", "bufs", "codec", "wire_nbytes",
                 "logical_nbytes", "frame")

    def __init__(self, manifest: dict, bufs: list, codec: str,
                 wire_nbytes: int, logical_nbytes: int,
                 frame: np.ndarray | None = None):
        self.manifest = manifest
        self.bufs = bufs
        self.codec = codec
        self.wire_nbytes = wire_nbytes
        self.logical_nbytes = logical_nbytes
        self.frame = frame

    def decoded(self) -> list[np.ndarray]:
        """What the receiver will reconstruct — the error-feedback residual
        is ``sent_value - decoded()`` (raw leaves decode to themselves).
        Allocates fresh arrays per call; steady-state paths use
        :meth:`decoded_into`."""
        out = []
        for entry, buf in zip(self.manifest["leaves"], self.bufs):
            if entry["enc"] == "raw":
                out.append(buf)
            else:
                dec = np.empty(tuple(entry["shape"]),
                               np.dtype(entry["dtype"]))
                decode_into(entry, buf, dec)
                out.append(dec)
        return out

    def decoded_into(self, out: list[np.ndarray]) -> list[np.ndarray]:
        """:meth:`decoded` into preallocated logical-dtype buffers — the
        residual/apply hot paths reuse one scratch list across syncs so a
        steady-state sync allocates nothing.  Raw leaves are returned as
        the zero-copy wire buffer itself (``out[i]`` untouched) unless
        they alias it already."""
        res = []
        for entry, buf, o in zip(self.manifest["leaves"], self.bufs, out):
            if entry["enc"] == "raw":
                res.append(buf)
            else:
                decode_into(entry, buf, o)
                res.append(o)
        return res


class FrameBuffer:
    """Reusable contiguous staging for one packed frame's data region.

    One per stripe, grown to the stripe's wire size on first use and
    reused for every later sync (stripe wire sizes are fixed by the leaf
    schedule, so steady state never reallocates).  Fused codec kernels
    write their wire bytes straight into :meth:`view` windows; the
    transport ships :meth:`frame` as a single iovec — no per-leaf gather,
    no per-sync allocation.

    ``pinned=True`` backs the region with page-locked host memory (a
    ``torch.empty(..., pin_memory=True)`` seen through ``.numpy()``), so a
    copy between it and the card is one DMA that can run asynchronously;
    :attr:`host` is the torch tensor over the same bytes either way.
    :meth:`device_stage` holds the frame's twin on a device: the port's
    tensor route writes wire bytes there and moves the whole frame in one
    copy.  Every buffer belongs to the one role that owns the
    FrameBuffer."""

    __slots__ = ("buf", "host", "pinned", "stage")

    def __init__(self, nbytes: int = 0, pinned: bool = False):
        self.pinned = bool(pinned)
        self.host = None
        self.stage = None
        self.buf = self._alloc(nbytes)

    def _alloc(self, nbytes: int) -> np.ndarray:
        if not self.pinned:
            self.host = None
            return np.empty(int(nbytes), np.uint8)
        import torch
        self.host = torch.empty(int(nbytes), dtype=torch.uint8,
                                pin_memory=True)
        return self.host.numpy()

    def reserve(self, nbytes: int) -> None:
        """Grow (never shrink) the staging region to ``nbytes``."""
        if self.buf.nbytes < nbytes:
            self.buf = self._alloc(nbytes)

    def host_tensor(self, nbytes: int):
        """The first ``nbytes`` of the host region as a torch uint8 tensor
        (sharing memory with :attr:`buf`)."""
        import torch
        t = self.host if self.host is not None else torch.from_numpy(self.buf)
        return t[:nbytes]

    def device_stage(self, nbytes: int, device):
        """A device uint8 buffer of at least ``nbytes`` (grown, never
        shrunk, and reallocated if ``device`` changes)."""
        import torch
        st = self.stage
        if st is None or st.device != device or st.numel() < nbytes:
            st = self.stage = torch.empty(int(nbytes), dtype=torch.uint8,
                                          device=device)
        return st

    def view(self, offset: int, nbytes: int, dtype: np.dtype,
             shape: tuple) -> np.ndarray:
        """A zero-copy typed window ``[offset, offset+nbytes)`` of the
        staging region (kernels write wire bytes through it)."""
        return self.buf[offset:offset + nbytes].view(dtype).reshape(shape)

    def frame(self, nbytes: int) -> np.ndarray:
        """The first ``nbytes`` of the staging region — the whole packed
        data region as ONE buffer for a single-iovec send."""
        return self.buf[:nbytes]


def encoded_nbytes(dtype: np.dtype, size: int, codec: str) -> int:
    """WIRE bytes one leaf of ``dtype``/``size`` occupies under ``codec``
    — the same per-leaf encoding decision as :func:`_encode_leaf`, used
    to size a :class:`FrameBuffer` before any kernel runs."""
    if codec == "fp16" and dtype.kind == "f" and dtype.itemsize > 2:
        return 2 * size
    if codec == "int8" and dtype.kind == "f":
        return size
    return size * dtype.itemsize


def _encode_leaf(arr: np.ndarray, codec: str) -> tuple[str, np.ndarray, dict]:
    """Pick the per-leaf encoding: quantizers only apply to float leaves
    wider than the wire format; everything else rides raw."""
    if codec == "fp16" and arr.dtype.kind == "f" and arr.dtype.itemsize > 2:
        return "fp16", arr.astype(np.float16), {}
    if codec == "int8" and arr.dtype.kind == "f":
        amax = float(np.max(np.abs(arr))) if arr.size else 0.0
        if not math.isfinite(amax):
            raise ValueError(
                "int8 wire codec cannot encode non-finite values "
                "(inf/nan leaf)")
        scale = amax / 127.0
        if scale == 0.0:
            q = np.zeros(arr.shape, np.int8)
        else:
            q = np.clip(np.rint(arr / arr.dtype.type(scale)),
                        -127, 127).astype(np.int8)
        return "int8", q, {"scale": scale}
    return "raw", arr, {}


def encode_leaves(leaves, codec: str = "raw") -> PackedPayload:
    """Encode a tensor list into one packed payload.  Raw leaves are
    zero-copy views; the caller must not mutate them until the frame is
    sent (the AsyncEA overlap path hands ownership to the sender)."""
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r} "
                         f"(supported: {', '.join(CODECS)})")
    entries, bufs = [], []
    offset = logical = 0
    for x in leaves:
        arr = np.asarray(x)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        enc, buf, extra = _encode_leaf(arr, codec)
        entry = {"dtype": arr.dtype.name, "shape": list(arr.shape),
                 "enc": enc, "offset": offset, "nbytes": buf.nbytes}
        entry.update(extra)
        entries.append(entry)
        bufs.append(buf)
        offset += buf.nbytes
        logical += arr.nbytes
    manifest = {"v": WIRE_V, "codec": codec, "leaves": entries}
    return PackedPayload(manifest, bufs, codec, offset, logical)


def plan_stripes(nbytes: list[int], shards: int) -> list[tuple[int, int]]:
    """Partition a leaf list into at most ``shards`` contiguous,
    byte-balanced stripes (Dean et al. 2012 parameter-server sharding,
    applied to a pytree leaf schedule).

    Returns ``[(lo, hi), ...]`` half-open index ranges covering
    ``[0, len(nbytes))`` in order.  Greedy walk: each stripe takes leaves
    until adding the next one would move it FURTHER from the ideal
    remaining-bytes/remaining-stripes share than stopping; every stripe
    takes at least one leaf, so the effective stripe count is
    ``min(shards, len(nbytes))``.  Deterministic in the leaf schedule —
    but the AsyncEA handshake still ships the explicit ranges so a
    version skew in this planner can never desync two peers.
    """
    n = len(nbytes)
    if n == 0:
        return [(0, 0)]
    shards = max(1, min(int(shards), n))
    total = sum(nbytes)
    stripes: list[tuple[int, int]] = []
    lo, remaining = 0, total
    for s in range(shards):
        want = remaining / (shards - s)
        hi, size = lo, 0
        max_hi = n - (shards - s - 1)       # leave >=1 leaf per later stripe
        while hi < max_hi:
            nb = nbytes[hi]
            if hi > lo and abs(size + nb - want) > abs(size - want):
                break
            size += nb
            hi += 1
        stripes.append((lo, hi))
        lo, remaining = hi, remaining - size
    lo_last, _ = stripes[-1]
    stripes[-1] = (lo_last, n)              # tail always closes the range
    return stripes


def plan_splits(nbytes: list[int], nelems: list[int],
                shards: int) -> list[int]:
    """Per-leaf split counts for sub-leaf striping: any leaf bigger than
    the ideal per-stripe byte share is cut into that many equal-element
    chunks BEFORE stripe planning, so a single oversized kernel (e.g. a
    convnet's last conv holding 3/4 of the bytes) cannot Amdahl-bound
    the sharded pipeline — the reason the classic parameter servers
    split large tensors across shards (Dean et al. 2012 §4.1).

    Returns one ``parts`` count per leaf (1 = unsplit); all 1 when
    ``shards <= 1``.  Deterministic in (sizes, shards) — but like the
    stripe ranges, the AsyncEA handshake ships the split table
    explicitly so planner skew can never desync two peers."""
    n = len(nbytes)
    if int(shards) <= 1 or n == 0:
        return [1] * n
    target = sum(nbytes) / int(shards)
    if target <= 0:
        return [1] * n
    return [1 if nb <= target or ne <= 1
            else min(ne, -(-nb // max(1, int(target))))
            for nb, ne in zip(nbytes, nelems)]


def _split_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Half-open element ranges cutting ``n`` elements into ``parts``
    near-equal chunks (the first ``n % parts`` chunks take the extra
    element) — the ONE place the chunk arithmetic lives, shared by both
    peers' view builders so their layouts agree by construction."""
    base, rem = divmod(n, parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def split_views(leaves: list[np.ndarray], splits: list[int]
                ) -> list[np.ndarray]:
    """The VIRTUAL leaf list striping operates over: unsplit leaves pass
    through with their real shapes; split leaves become contiguous flat
    chunk views (zero-copy — writes through a view land in the real
    leaf).  Both AsyncEA peers derive this from the same split table, so
    per-chunk wire frames line up index-for-index."""
    out: list[np.ndarray] = []
    for t, p in zip(leaves, splits):
        if p <= 1:
            out.append(t)
        else:
            flat = t.reshape(-1)
            out.extend(flat[lo:hi] for lo, hi in _split_bounds(t.size, p))
    return out


def merge_views(vleaves: list[np.ndarray], splits: list[int],
                shapes: list[tuple]) -> list[np.ndarray]:
    """Rebuild the real leaf list from a virtual one (inverse of
    :func:`split_views`): split leaves concatenate their chunks back to
    ``shapes`` (copying only those), unsplit leaves pass through."""
    out, i = [], 0
    for shape, p in zip(shapes, splits):
        if p <= 1:
            out.append(vleaves[i])
            i += 1
        else:
            flat = np.concatenate([np.ravel(c) for c in vleaves[i:i + p]])
            out.append(flat.reshape(shape))
            i += p
    return out


def wire_dtype(entry: dict) -> np.dtype:
    """The dtype of a leaf's bytes ON THE WIRE (its logical dtype for raw
    leaves, the quantized dtype otherwise)."""
    if entry["enc"] == "raw":
        return np.dtype(entry["dtype"])
    return _ENC_WIRE_DTYPE[entry["enc"]]


def decode_into(entry: dict, wirebuf: np.ndarray, out: np.ndarray) -> None:
    """Dequantize one encoded leaf into a preallocated logical-dtype
    buffer (raw leaves never come through here — the transport reads them
    straight into the target)."""
    enc = entry["enc"]
    if enc == "fp16":
        out[...] = wirebuf
    elif enc == "int8":
        np.multiply(wirebuf, out.dtype.type(entry["scale"]), out=out)
    else:
        raise ValueError(f"decode_into on {enc!r} leaf")


def parse_manifest(raw: bytes, data_nbytes: int,
                   expect_n: int | None = None) -> tuple[str, list[dict]]:
    """Validate a received manifest against the frame's data-region size.

    Raises ``ValueError`` on ANY structural problem — wrong JSON, unknown
    codec/encoding, negative/overflowing shapes, offsets that do not tile
    the data region, leaf count mismatch.  The transport converts that to
    ``ProtocolError`` after draining the announced payload, so a corrupt
    manifest never desyncs the stream.
    """
    import json
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"undecodable packed manifest: {e}") from None
    if not isinstance(doc, dict) or not isinstance(doc.get("leaves"), list):
        raise ValueError("packed manifest is not {codec, leaves} shaped")
    codec = doc.get("codec")
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r} in manifest")
    entries = doc["leaves"]
    if expect_n is not None and len(entries) != expect_n:
        raise ValueError(
            f"packed frame carries {len(entries)} leaves, receiver "
            f"expects {expect_n} — sender and receiver disagree on the "
            "tensor schedule")
    offset = 0
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ValueError(f"leaf {i}: manifest entry is not an object")
        try:
            dtype = np.dtype(entry["dtype"])
            shape = tuple(int(s) for s in entry["shape"])
            enc = entry["enc"]
            nbytes = int(entry["nbytes"])
            off = int(entry["offset"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"leaf {i}: bad manifest entry: {e}") from None
        if any(s < 0 for s in shape):
            raise ValueError(f"leaf {i}: negative dimension in {shape}")
        if enc not in ("raw",) + tuple(_ENC_WIRE_DTYPE):
            raise ValueError(f"leaf {i}: unknown encoding {enc!r}")
        if enc != "raw" and dtype.kind != "f":
            raise ValueError(
                f"leaf {i}: {enc} encoding on non-float dtype {dtype}")
        if enc == "int8":
            try:
                scale = float(entry["scale"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"leaf {i}: int8 leaf missing scale") \
                    from None
            if not math.isfinite(scale):
                raise ValueError(f"leaf {i}: non-finite int8 scale {scale}")
        wdt = np.dtype(dtype) if enc == "raw" else _ENC_WIRE_DTYPE[enc]
        # Python-int product: immune to C-long overflow from a hostile
        # header (same hardening as recv_tensor).
        expect = math.prod(shape) * wdt.itemsize
        if nbytes != expect:
            raise ValueError(
                f"leaf {i}: wire payload {nbytes} bytes != {expect} "
                f"expected for {enc}-encoded {dtype}{shape}")
        if off != offset:
            raise ValueError(
                f"leaf {i}: offset {off} does not tile the data region "
                f"(expected {offset})")
        offset += nbytes
    if offset != data_nbytes:
        raise ValueError(
            f"manifest leaves cover {offset} bytes but the frame carries "
            f"{data_nbytes}")
    return codec, entries
