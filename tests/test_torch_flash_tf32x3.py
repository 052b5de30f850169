"""Why float32 B5a's P V and B5b and B5c may run on the tensor cores as
3xTF32.

A TF32 tensor-core product rounds each float32 operand to 11 significant
bits.  ``ops/csrc/flash_attention.cu``'s float32 kernels split
every operand instead, ``x = hi + lo`` with ``hi = tf32(x)`` and ``lo =
tf32(x - hi)`` (``cvt.rna.tf32.f32``: to nearest, ties away from zero),
and form ``a b`` as ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in float32
accumulators, 8 terms of k at a time as ``mma.sync.m16n8k8`` takes them.

Here that arithmetic is emulated in plain PyTorch as the kernels run it:
a float32 forward forms the scores S = Q K^T, o, m and l (float32 B5a);
the backward recomputes P from those very scores (the kernels' fmaf chain
is B5a's) and takes the other four products (dP = dO V^T, dV = P^T dO,
dK = dS^T Q, dQ = dS K) in 3xTF32, at D = 32, 64 and 128.  The gradients
are held against a float64 route at the float32 tolerance the card holds
the kernels to against their twins (``chip_smoke.py``'s
``FLASH_BWD_TOL['float32']['twin']``: rtol 2e-4, atol 2e-5; dK's atol
times the factor on q, as its ``check_backward`` scales it): 3xTF32 is
within it wherever plain float32 is, and one TF32 pass is not.  Why S
stays off the tensor cores: scores formed anew by another product (3xTF32
here, more accurate than the forward's) no longer match the m and l they
are normalised by, and with q x 8 that mismatch pushes dV past the
tolerance.  The forward is emulated as float32 B5a runs it: 64-key tiles
walked in halves of 32 with an online softmax, each half's P V in 3xTF32
summed from zero and added to the accumulator (at D = 128 the two halves
of every tile walked apart and merged at the end), o held within the
1e-5 that the card holds B5a to (``chip_smoke.py``'s ``FLASH_F32_TOL``)
of a float64 route from the same float32 scores; one TF32 pass misses
it.  The card's tensor cores may
sum inside an MMA in another order; the kernels themselves are held on the card (phase 11) and, run as
written, on the CPU (``tests/test_torch_flash_emulated.py``)."""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

#: ``FLASH_BWD_TOL['float32']['twin']`` of chip_smoke.py
RTOL, ATOL = 2e-4, 2e-5
#: (D, L, q multiplier): the repo's head dims; q x 8 puts scores up to
#: about +-50, where dP - di cancels against a nearly one-hot P
CASES = [(32, 512, 1.0), (64, 512, 1.0), (128, 512, 1.0), (64, 256, 8.0),
         (128, 256, 8.0)]
IDS = [f"D{d}-L{n}-q{m:g}" for d, n, m in CASES]
K_STEP = 8    # the k depth of mma.sync.m16n8k8


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero; NaN and infinity unchanged."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where((u & 0x7F800000) == 0x7F800000, u, r)
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_float32(a, b):
    return a @ b


def mm_tf32(a, b):
    """One TF32 pass: both operands rounded, float32 sums."""
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    """3xTF32 as the kernels issue it: per k step of 8, the cross terms
    a_lo b_hi and a_hi b_lo, then a_hi b_hi, into one float32 sum."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        k = slice(k0, k0 + K_STEP)
        acc = acc + al[..., k] @ bh[..., k, :]
        acc = acc + ah[..., k] @ bl[..., k, :]
        acc = acc + ah[..., k] @ bh[..., k, :]
    return acc


def mm_float64(a, b):
    return a @ b


def inputs(D, L, mult, heads=2):
    rs = np.random.RandomState(D + L)
    q, k, v, do = (rs.standard_normal((heads, L, D)) for _ in range(4))
    return [torch.from_numpy(t) for t in (q * mult, k, v, do)]


def causal_mask(L):
    return torch.ones(L, L, dtype=torch.bool).triu(1)


def forward(q, k, v):
    """The causal forward in the inputs' dtype: the unscaled scores S, o and
    the row statistics m (of the scaled scores) and l, as float32 B5a forms
    them (its scores one plain float32 product)."""
    L, D = q.shape[-2:]
    s = q @ k.transpose(-1, -2)
    ss = (s * (1.0 / math.sqrt(D))).masked_fill(causal_mask(L), -math.inf)
    m = ss.amax(-1, keepdim=True)
    p = torch.exp(ss - m)
    l = p.sum(-1, keepdim=True)
    return s, (p / l) @ v, m, l


def backward(q, k, v, do, s, o, m, l, mm):
    """dq, dk, dv from the scores ``s`` with the other four products (dP =
    dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) through ``mm``; P and dS
    elementwise in the inputs' dtype, as B5b and B5c form them."""
    L, D = q.shape[-2:]
    scale = 1.0 / math.sqrt(D)
    vt = v.transpose(-1, -2).contiguous()
    dp = mm(do, vt)
    p = torch.exp(s * scale - m) * (1.0 / l)
    p = p.masked_fill(causal_mask(L), 0.0)
    di = (o * do).sum(-1, keepdim=True)
    ds = (dp - di) * p * scale
    pt, dst = (t.transpose(-1, -2).contiguous() for t in (p, ds))
    return mm(ds, k), mm(dst, q), mm(pt, do)


def errors(D, L, mult, mm, scores_mm=None):
    """{grad: (max abs error, within the tolerance)} of a float32 route
    against the float64 route on the same inputs.  The float32 route runs
    its own forward (S, o, m, l in float32) and recomputes P from the very
    scores m and l were taken over, as the kernels do; its other four
    products go through ``mm``.  With ``scores_mm`` the backward forms S
    anew through it instead, against the forward's m and l."""
    q, k, v, do = inputs(D, L, mult)
    ref = backward(q, k, v, do, *forward(q, k, v), mm_float64)
    q, k, v, do = (t.float() for t in (q, k, v, do))
    s, o, m, l = forward(q, k, v)
    if scores_mm is not None:
        s = scores_mm(q, k.transpose(-1, -2).contiguous())
    got = backward(q, k, v, do, s, o, m, l, mm)
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        atol = ATOL * (mult if name == "dk" else 1.0)
        out[name] = (float((g.double() - r).abs().max()),
                     torch.allclose(g.double(), r, rtol=RTOL, atol=atol))
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    vals = torch.tensor([one + 2 ** -11, -(one + 2 ** -11),
                         one + 2 ** -11 - 2 ** -23, one + 3 * 2 ** -11,
                         math.inf, -math.inf, 0.0], dtype=torch.float32)
    got = tf32(vals)
    want = [one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -9,
            math.inf, -math.inf, 0.0]
    assert got.tolist() == want
    assert bool(torch.isnan(tf32(torch.tensor([math.nan]))).all())
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    bits = tf32(x).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert float(((tf32(x) - x).abs() / x.abs()).max()) <= 2 ** -11


def test_split_products_are_exact_in_float32():
    """hi + lo carries x to 2^-22 of itself, and the product of two TF32
    values is exact in float32 (11 x 11 significant bits): what lets the
    three passes sum in float32 accumulators."""
    rs = np.random.RandomState(1)
    a, b = (torch.from_numpy(rs.standard_normal(4096).astype(np.float32))
            for _ in range(2))
    (ah, al), (bh, bl) = split(a), split(b)
    assert float(((ah + al).double() - a.double()).abs().div(
        a.double().abs()).max()) <= 2 ** -22
    for x, y in ((ah, bh), (ah, bl), (al, bh)):
        assert torch.equal((x * y).double(), x.double() * y.double())


@pytest.mark.parametrize("D,L,mult", CASES, ids=IDS)
def test_3xtf32_backward_within_the_float32_tolerance(D, L, mult):
    plain, split3 = errors(D, L, mult, mm_float32), errors(D, L, mult,
                                                           mm_3xtf32)
    for name in ("dq", "dk", "dv"):
        assert plain[name][1], f"plain float32 {name}: {plain[name][0]:.3g}"
        assert split3[name][1], (
            f"3xTF32 {name}: max abs {split3[name][0]:.3g} (plain float32 "
            f"{plain[name][0]:.3g})")
        # and of plain float32's order, not merely inside the tolerance
        assert split3[name][0] <= 4 * plain[name][0] + 1e-7, (
            name, split3[name][0], plain[name][0])


@pytest.mark.parametrize("D,L,mult", CASES, ids=IDS)
def test_one_tf32_pass_misses_the_float32_tolerance(D, L, mult):
    one = errors(D, L, mult, mm_tf32)
    for name in ("dq", "dk", "dv"):
        assert not one[name][1], (
            f"one TF32 pass {name}: max abs {one[name][0]:.3g} within "
            f"rtol {RTOL}, atol {ATOL}")


#: q x 8 cases for the scores' mismatch; the last one misses the tolerance
Q8_CASES = [(64, 256), (128, 256), (64, 512), (128, 512)]


@pytest.mark.parametrize("D,L", Q8_CASES,
                         ids=[f"D{d}-L{n}-q8" for d, n in Q8_CASES])
def test_scores_formed_anew_lose_ps_match_with_m_and_l(D, L):
    """S taken again in 3xTF32 in the backward, against the float32
    forward's m and l, at least doubles dV's error at q x 8, and at D =
    128, L = 512 puts it outside the tolerance that the forward's own
    scores keep."""
    same = errors(D, L, 8.0, mm_3xtf32)
    anew = errors(D, L, 8.0, mm_3xtf32, scores_mm=mm_3xtf32)
    assert same["dv"][1], same
    assert anew["dv"][0] >= 2 * same["dv"][0], (anew["dv"], same["dv"])
    if (D, L) == Q8_CASES[-1]:
        assert not anew["dv"][1], anew["dv"]


#: ``FLASH_F32_TOL`` of chip_smoke.py: B5a's o against its twin and xla
FWD_ATOL = 1e-5
#: keys of a tile, and of the half tile that is the kernels' unit of P V
TILE, HALF = 64, 32


def scaled_scores(q, k):
    """The causal scaled scores, -inf above the diagonal, in q's dtype."""
    L, D = q.shape[-2:]
    ss = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    return ss.masked_fill(causal_mask(L), -math.inf)


def forward_online(ss, v, mm, streams=1):
    """The causal forward as float32 B5a runs it on the scaled scores
    ``ss``: the keys in halves of 32, each an online-softmax step (m, then
    alpha = exp(m_old - m_new) on l and the accumulator, P = exp(s - m))
    whose P V goes through ``mm`` from zero and is added to the
    accumulator.  A row skips the halves whose first key lies past it.
    ``streams=2`` walks the first and the second half of every tile apart,
    as two warps do at D = 128, and merges their (m, l, acc) at the end by
    the softmax rule; returns o = acc / l."""
    L = ss.shape[-1]
    rows = torch.arange(L).unsqueeze(-1)
    state = []
    for st in range(streams):
        m = torch.full(ss.shape[:-1] + (1,), -math.inf)
        l = torch.zeros(ss.shape[:-1] + (1,))
        acc = torch.zeros(v.shape)
        for k0 in range(0, L, TILE):
            for half in range(TILE // HALF):
                if half % streams != st:
                    continue
                keys = slice(k0 + half * HALF, k0 + (half + 1) * HALF)
                live = rows >= keys.start
                x = ss[..., keys]
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                m_new = torch.where(live, m_new, m)
                alpha = torch.where(live, torch.exp(m - m_new), 1.0)
                p = torch.where(live, torch.exp(x - m_new), 0.0)
                l = torch.where(live, l * alpha + p.sum(-1, keepdim=True), l)
                t = mm(p, v[..., keys, :].contiguous())
                acc = torch.where(live, acc * alpha + t, acc)
                m = m_new
        state.append((m, l, acc))
    m, l, acc = state[0]
    for m1, l1, acc1 in state[1:]:
        mm_ = torch.maximum(m, m1)
        a0, a1 = torch.exp(m - mm_), torch.exp(m1 - mm_)
        l, acc, m = l * a0 + l1 * a1, acc * a0 + acc1 * a1, mm_
    return acc / l


def forward_error(D, L, mult, mm):
    """Max abs error of o from :func:`forward_online` in float32 (P V
    through ``mm``; two streams at D = 128) against the float64 route on the
    same float32 scores.  The scores are the kernel's own fmaf chains,
    which the card holds against the twin's; with q x 8 their float32
    rounding alone moves o by about 1e-5 from a float64 route's, which is
    not what P V adds."""
    q, k, v, _ = inputs(D, L, mult)
    ss = scaled_scores(q.float(), k.float())
    ref = torch.softmax(ss.double(), -1) @ v
    got = forward_online(ss, v.float(), mm, streams=2 if D > 64 else 1)
    return float((got.double() - ref).abs().max())


@pytest.mark.parametrize("D,L,mult", CASES, ids=IDS)
def test_3xtf32_forward_within_the_float32_tolerance(D, L, mult):
    plain, split3 = (forward_error(D, L, mult, mm)
                     for mm in (mm_float32, mm_3xtf32))
    assert plain <= FWD_ATOL, f"plain float32 o: {plain:.3g}"
    assert split3 <= FWD_ATOL, (
        f"3xTF32 o: max abs {split3:.3g} (plain float32 {plain:.3g})")
    assert split3 <= 4 * plain + 1e-7, (split3, plain)


@pytest.mark.parametrize("D,L,mult", CASES, ids=IDS)
def test_one_tf32_pass_misses_the_forward_tolerance(D, L, mult):
    one = forward_error(D, L, mult, mm_tf32)
    assert one > FWD_ATOL, f"one TF32 pass o: max abs {one:.3g}"
