"""HEVC integer transforms + quantization, batched over TUs.

Counterpart of x265_tpu/ops/transforms.py: the lanes and batch forms
on the device, with a scalar QP or a (B,) per-block QP vector (dQP), and
the per-block numpy forms of the host-recon I path (dct_np, idct_np,
quant_np, dequant_np, sign_hide_np), copies of the reference's.
Integer exactness: the matrix products run in float64, where every
product and partial sum (at most 32 x 90 x 2^16 < 2^28) is an exact
integer, and are cast back to int32. The reference splits operands into
8-bit limbs for its bf16 matrix unit; float64 needs no split on a GPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .fma import fma32
from ..common.tables import (DCT_MATRICES, DST4, QUANT_SCALES,
                             INV_QUANT_SCALES, QUANT_SHIFT, scan_order,
                             transform_shift)


def _fwd_matrix(size: int, dst: bool) -> np.ndarray:
    return DST4 if dst else DCT_MATRICES[size]


@lru_cache(maxsize=None)
def _mat64(size: int, dst: bool, transpose: bool,
           device: torch.device) -> torch.Tensor:
    m = _fwd_matrix(size, dst)
    m = m.T if transpose else m
    return torch.as_tensor(np.ascontiguousarray(m), dtype=torch.float64,
                           device=device)


def _rshift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _exact_dot_axis(t: torch.Tensor, x: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Exact integer t @ x contracting x's `axis` (float64 product).
    Output dims: (t.rows,) + x dims with `axis` removed."""
    return torch.tensordot(t, x.to(torch.float64),
                           dims=([1], [axis])).to(torch.int32)


def _exact_matmul_tx(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched integer t @ x[b], exact: (n, n) x (b, n, m) -> (b, n, m)."""
    return torch.matmul(t, x.to(torch.float64)).to(torch.int32)


@lru_cache(maxsize=None)
def _scale_tables(device: torch.device):
    return (torch.as_tensor(QUANT_SCALES, dtype=torch.int32, device=device),
            torch.as_tensor(INV_QUANT_SCALES, dtype=torch.int32,
                            device=device))


def _qp_parts(qp, log2n: int, bit_depth: int, batch: bool, device):
    """(per, rem, qbits, fwd scale, inverse scale) of a python-int QP,
    or of a (B,) QP vector broadcast over the blocks: along the last
    axis of (N, N, B) lanes, the first of (B, N, N) batches."""
    if isinstance(qp, (int, np.integer)):
        qp = int(qp)
        per, rem = qp // 6, qp % 6
        return (per, rem, QUANT_SHIFT + per + transform_shift(log2n,
                                                             bit_depth),
                int(QUANT_SCALES[rem]), int(INV_QUANT_SCALES[rem]))
    qp = qp.to(device=device, dtype=torch.int32)
    qp = qp[:, None, None] if batch else qp[None, None, :]
    per, rem = qp // 6, qp % 6
    fwd, inv = _scale_tables(device)
    return (per, rem, QUANT_SHIFT + per + transform_shift(log2n, bit_depth),
            fwd[rem.long()], inv[rem.long()])


# =============================================================================
# lanes layout: blocks as (N, N, B), the batch last
# =============================================================================

def dct_lanes(resi: torch.Tensor, size: int, bit_depth: int = 8,
              dst: bool = False, lowpass: bool = False) -> torch.Tensor:
    """Forward transform of (N, N, B) blocks -> (N, N, B) coefficients
    ([row, col] = [vertical, horizontal] frequency).

    lowpass (x265 --lowpass-dct): for N >= 8 the half-size DCT of the
    2x2-summed residual >> 2 fills the low band (the rest is zero) and
    DC is the block sum scaled to the full-size DC. Encoder side only:
    the coefficients decode through the normative inverse."""
    log2n = size.bit_length() - 1
    if lowpass and size >= 8:
        r = resi.to(torch.int32)
        s2x2 = r[0::2, 0::2] + r[0::2, 1::2] + r[1::2, 0::2] + r[1::2, 1::2]
        half = dct_lanes(s2x2 >> 2, size // 2, bit_depth)
        total = r.sum((0, 1), dtype=torch.int32)
        exp = 7 - 2 * log2n - (bit_depth - 8)
        dc = total << exp if exp >= 0 else total >> -exp
        out = torch.zeros(resi.shape, dtype=torch.int32, device=resi.device)
        out[:size // 2, :size // 2] = half
        out[0, 0] = dc
        return out
    t = _mat64(size, dst, False, resi.device)
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    m1 = _rshift_round(_exact_dot_axis(t, resi, 1), s1)     # (i, r, B)
    return _rshift_round(_exact_dot_axis(t, m1, 1), s2)     # (u, i, B)


def idct_lanes(coef: torch.Tensor, size: int, bit_depth: int = 8,
               dst: bool = False) -> torch.Tensor:
    """Normative inverse transform of (N, N, B) coefficient blocks."""
    t = _mat64(size, dst, True, coef.device)
    s2 = 20 - bit_depth
    m1 = torch.clamp(_rshift_round(_exact_dot_axis(t, coef, 0), 7),
                     -32768, 32767)                         # (k, i, B)
    r = torch.clamp(_rshift_round(_exact_dot_axis(t, m1, 1), s2),
                    -32768, 32767)                          # (j, k, B)
    return r.transpose(0, 1)                                # (k, j, B)


def _quant(coef: torch.Tensor, log2n: int, qp, bit_depth: int,
           intra: bool, with_rem: bool, batch: bool = False):
    _, _, qbits, scale, _ = _qp_parts(qp, log2n, bit_depth, batch,
                                      coef.device)
    add = (171 if intra else 85) << (qbits - 9)
    a = torch.abs(coef) * scale
    level = torch.clamp((a + add) >> qbits, 0, 32767)
    out = torch.sign(coef) * level
    if not with_rem:
        return out
    # signed remainder WITHOUT the rounding offset (HM/x265 deltaU)
    return out, (a - (level << qbits)) >> (qbits - 8)


def _dequant(level: torch.Tensor, log2n: int, qp, bit_depth: int,
             batch: bool = False) -> torch.Tensor:
    per, _, _, _, inv = _qp_parts(qp, log2n, bit_depth, batch,
                                  level.device)
    shift = bit_depth + log2n - 9
    scale = inv << per
    return torch.clamp((level * scale + (1 << (shift - 1))) >> shift,
                       -32768, 32767)


def quant_lanes(coef: torch.Tensor, size: int, qp, bit_depth: int = 8,
                intra: bool = True, with_rem: bool = False):
    """Quantise (N, N, B) coefficients; qp a python int or a (B,) int32
    per-block vector."""
    return _quant(coef, size.bit_length() - 1, qp, bit_depth, intra,
                  with_rem)


def dequant_lanes(level: torch.Tensor, size: int, qp,
                  bit_depth: int = 8) -> torch.Tensor:
    return _dequant(level, size.bit_length() - 1, qp, bit_depth)


@lru_cache(maxsize=None)
def _cg_perm(scan_idx: int) -> np.ndarray:
    """Raster position (0..15) per within-CG scan position."""
    xy = scan_order(scan_idx, 2)
    return (xy[:, 1] * 4 + xy[:, 0]).astype(np.int32)


@lru_cache(maxsize=None)
def _cg_rank(scan_idx: int) -> np.ndarray:
    """Scan position (0..15) per raster position."""
    return np.argsort(_cg_perm(scan_idx)).astype(np.int32)


@lru_cache(maxsize=None)
def _ranks(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.stack([_cg_rank(s) for s in range(3)]),
                           device=device)


def _sign_hide_cg(lv: torch.Tensor, du: torch.Tensor,
                  rank: torch.Tensor) -> torch.Tensor:
    """Parity fix over CG-grouped levels: lv/du (..., 16) in raster
    order within the CG, rank broadcastable to them (scan position per
    raster position). Every 4x4 CG whose significant run spans more
    than 3 scan positions gets its hidden-sign parity enforced by the
    cheapest +-1 level change (x265 signBitHidingHDQ)."""
    nzm = lv != 0
    first = torch.where(nzm, rank, 16).amin(-1)
    last = torch.where(nzm, rank, -1).amax(-1)
    hidden = (last - first) > 3
    sumabs = torch.abs(lv).sum(-1)
    firstval = torch.where(rank == first[..., None], lv, 0).sum(-1)
    neg = (firstval < 0).to(torch.int32)
    fix = hidden & ((sumabs & 1) != neg)

    # |deltaU| < 256: (cost, lower-before-raise, scan rank) packs into
    # one lexicographic key, so ties resolve like the scan-ordered
    # oracle
    big = 1 << 24
    is_end = (rank == first[..., None]) | (rank == last[..., None])
    alv = torch.abs(lv)
    can_lower = nzm & (alv < 32768) & ((alv >= 2) | ~is_end)
    can_raise = nzm & (alv < 32767)
    key_l = torch.where(can_lower, du, big) * 64 + rank
    key_r = torch.where(can_raise, -du, big) * 64 + 32 + rank
    kmin = torch.minimum(key_l.amin(-1), key_r.amin(-1))
    sel_l = key_l == kmin[..., None]
    sel_r = key_r == kmin[..., None]
    sel = sel_l | sel_r
    tgt = torch.where(sel, lv, 0).sum(-1)
    d = torch.where(sel_l, -1, torch.where(sel_r, 1, 0)).sum(-1)
    newv = tgt + torch.where(tgt > 0, d, -d)
    return torch.where(fix[..., None] & sel, newv[..., None], lv)


def sign_hide_lanes(coefs: torch.Tensor, size: int, scan_sel: int,
                    delta_u: torch.Tensor) -> torch.Tensor:
    """Sign-bit hiding for (N, N, B) blocks under one uniform scan."""
    n = size
    b = coefs.shape[-1]
    ncgs = max(n // 4, 1)

    def to_cg(a):       # (N, N, B) -> (B, ncg*ncg, 16)
        return a.reshape(ncgs, 4, ncgs, 4, b).permute(4, 0, 2, 1, 3) \
            .reshape(b, ncgs * ncgs, 16)

    rank = _ranks(coefs.device)[scan_sel]
    lv = _sign_hide_cg(to_cg(coefs), to_cg(delta_u), rank)
    return lv.reshape(b, ncgs, ncgs, 4, 4).permute(1, 3, 2, 4, 0) \
        .reshape(n, n, b)


# =============================================================================
# batch layout: blocks as (B, N, N)
# =============================================================================

def dct_batch(resi: torch.Tensor, size: int, bit_depth: int = 8,
              dst: bool = False) -> torch.Tensor:
    """Forward transform of (B, N, N) int32 residual blocks."""
    log2n = size.bit_length() - 1
    t = _mat64(size, dst, False, resi.device)
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    m1 = _rshift_round(_exact_matmul_tx(t, resi.transpose(-1, -2)), s1)
    return _rshift_round(_exact_matmul_tx(t, m1.transpose(-1, -2)), s2)


def idct_batch(coef: torch.Tensor, size: int, bit_depth: int = 8,
               dst: bool = False) -> torch.Tensor:
    """Normative inverse transform of (B, N, N) int32 coefficient blocks."""
    t = _mat64(size, dst, True, coef.device)
    s2 = 20 - bit_depth
    m1 = torch.clamp(_rshift_round(_exact_matmul_tx(t, coef), 7),
                     -32768, 32767)
    r = torch.clamp(_rshift_round(
        _exact_matmul_tx(t, m1.transpose(-1, -2)), s2), -32768, 32767)
    return r.transpose(-1, -2)


def quant_batch(coef: torch.Tensor, size: int, qp, bit_depth: int = 8,
                intra: bool = True, with_rem: bool = False):
    """Quantize (B, N, N) int32 coefficients at one QP or a (B,) per-block
    QP vector."""
    return _quant(coef, size.bit_length() - 1, qp, bit_depth, intra,
                  with_rem, batch=True)


def dequant_batch(level: torch.Tensor, size: int, qp,
                  bit_depth: int = 8) -> torch.Tensor:
    return _dequant(level, size.bit_length() - 1, qp, bit_depth, batch=True)


def sign_hide_batch(coefs: torch.Tensor, size: int, scan_sel,
                    delta_u: torch.Tensor) -> torch.Tensor:
    """Sign-bit hiding for (B, N, N) blocks; scan_sel is a python int
    (uniform scan) or a (B,) tensor of scan indices in {0, 1, 2}."""
    b = coefs.shape[0]
    n = size
    ncgs = max(n // 4, 1)

    def to_cg(a):
        return a.reshape(b, ncgs, 4, ncgs, 4).permute(0, 1, 3, 2, 4) \
            .reshape(b, ncgs * ncgs, 16)

    ranks = _ranks(coefs.device)
    rank = ranks[scan_sel] if isinstance(scan_sel, int) \
        else ranks[scan_sel][:, None, :]
    lv = _sign_hide_cg(to_cg(coefs), to_cg(delta_u), rank)
    return lv.reshape(b, ncgs, ncgs, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(b, n, n)


# =============================================================================
# RDOQ: the reference's batched rate-distortion optimised quantisation
# (x265 rdoQuant's vectorisable core: round-half levels, the {0,
# level-1, level} choice by cost, then 4x4-group and whole-TU zeroing)
# =============================================================================
#
# Float exactness. The reference's compiled CPU program decides the bits
# of every float32 it compares, and three of its properties are copied
# here, each found by comparing bits with that program:
# - exp2(k) is lowered as exp(k * ln2) with the product rounded to
#   float32, so the quantiser step 2^qbits is not a power of two for
#   most qbits (_EXP2_F32);
# - division by a constant becomes a multiply by its float32 reciprocal
#   (scalar qp), and multiply-adds are contracted: the residual
#   e = |c|*scale - level*step rounds once (but for the round-half
#   candidate's where the step lies above its power of two), a cost
#   is fma(e*e, 1/norm, lam2*bits), the distortion gain is
#   fma(e0*e0, 1/norm, -dist(level)); with per-block QP the division
#   stays one and a cost is dist + lam2*bits;
# - float32 sums: a 4x4 group's in row-major order; a TU's as the
#   compiler vectorises it, which depends on the size and the layout
#   (_tu_sum_vec).

_LN2_F32 = np.float32(np.log(2.0))
# exp2 as the reference's compiler computes it, for integer arguments
_EXP2_F32 = np.array([np.float32(np.exp(np.float64(np.float32(k) *
                                                  _LN2_F32)))
                      for k in range(64)], np.float32)


def _bitlen(a: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int32 levels (0 for 0), read from the
    float32 exponent as the reference does: exact up to 2^24."""
    e = (a.to(torch.float32).view(torch.int32) >> 23) - 126
    return torch.where(a > 0, e, 0)


def _halves(v) -> torch.Tensor:
    """A vector register's reassociated sum: lanes i and i + n/2 first."""
    v = list(v)
    while len(v) > 1:
        h = len(v) // 2
        v = [v[i] + v[i + h] for i in range(h)]
    return v[0]


def _cg_sum_seq(x: torch.Tensor) -> torch.Tensor:
    """(g, 4, g, 4, B) -> (g, g, B): each 4x4 group's float32 sum in
    row-major order."""
    acc = x[:, 0, :, 0]
    for u in range(4):
        for v in range(4):
            if u or v:
                acc = acc + x[:, u, :, v]
    return acc


def _tu_sum_vec(x: torch.Tensor, keep, batch: bool) -> torch.Tensor:
    """(N, N, B) -> (B,): a TU's float32 sum of x where keep (a
    broadcastable bool, None for all) in the order of the reference's
    vectorised loop. N <= 16: four lanes, lane l walks rows l, l + 4,
    ... each left to right, then the lanes as halves. N = 32 walks the
    rows with one running total in lane 0 of a 4-column register: the
    lanes layout adds a row's eight 4-column vectors v0..v7 as
    ((((v0 + v4) + (v1 + v5)) + (v2 + v6)) + (v3 + v7)), the batch
    layout as two registers over 8-column strides, added; then
    halves."""
    n = x.shape[0]
    if keep is not None:
        x = torch.where(keep, x, 0.0)
    if n <= 16:
        r = x.reshape(n // 4, 4, n, -1)            # row i = 4q + lane
        acc = r[0, :, 0]
        for q in range(n // 4):
            for j in range(n):
                if q or j:
                    acc = acc + r[q, :, j]
        return _halves(acc)
    v = x.reshape(n, 8, 4, -1)                     # (row, k, lane, B)
    if batch:
        a = v[:, 0] + v[:, 2]
        a = (a + v[:, 4]) + v[:, 6]
        b = v[:, 1] + v[:, 3]
        b = (b + v[:, 5]) + v[:, 7]
        lane0 = [v[:, 2, 0], v[:, 4, 0], v[:, 6, 0]]
        rest = b[:, 0]
    else:
        p15, p26, p37 = v[:, 1] + v[:, 5], v[:, 2] + v[:, 6], \
            v[:, 3] + v[:, 7]
        a = (((v[:, 0] + v[:, 4]) + p15) + p26) + p37
        lane0 = [v[:, 4, 0], p15[:, 0], p26[:, 0], p37[:, 0]]
        rest = None
    t = b + a if batch else a
    # lanes 1-3 do not see the running total: all rows at once; lane 0
    # carries it from row to row
    t13 = t[:, 1] + t[:, 3]
    acc = None
    for i in range(n):
        t0 = v[i, 0, 0] if acc is None else acc + v[i, 0, 0]
        for term in lane0:
            t0 = t0 + term[i]
        if rest is not None:
            t0 = rest[i] + t0
        acc = (t0 + t[i, 2]) + t13[i]
    return acc


def _rdoq(tcoef: torch.Tensor, log2n: int, qp, lam2: float,
          bit_depth: int, with_rem: bool, costs: list | None,
          batch: bool = False):
    """RDOQ of (N, N, B) coefficients (a view of either layout, batch
    for the (B, N, N) one); qp a python int or a (B,) int32 tensor.
    costs, when given, receives the float32 operands of the reference's
    comparisons in its order: the three candidates' costs (3, N, N, B),
    then per pass (group, TU) the distortion gain and lam2 * (bits +
    2)."""
    dev = tcoef.device
    n = tcoef.shape[0]
    ts = transform_shift(log2n, bit_depth)
    tgain = float(_EXP2_F32[2 * ts])
    if isinstance(qp, (int, np.integer)):
        qp = int(qp)
        qbits = QUANT_SHIFT + qp // 6 + ts
        scale = int(QUANT_SCALES[qp % 6])
        step = float(_EXP2_F32[qbits])
        sc = np.float32(scale)
        inv = float(np.float32(1.0) / np.float32(sc * sc * np.float32(tgain)))
        half = 1 << (qbits - 1)
    else:
        qv = qp.to(torch.int32)[None, None, :]
        qbits = QUANT_SHIFT + torch.div(qv, 6, rounding_mode="floor") + ts
        rem = qv - torch.div(qv, 6, rounding_mode="floor") * 6
        scales, exp2 = _rdoq_tables(dev)
        scale, step = scales[rem], exp2[qbits]
        sf = scale.to(torch.float32)
        norm = sf * sf * tgain
        inv = None
        half = torch.ones_like(qbits) << (qbits - 1)
    a = torch.abs(tcoef) * scale                  # levelDouble, int32
    # round-half levels (no dead zone): the RD choice replaces the bias
    l_up = torch.clamp((a + half) >> qbits, 0, 32767)
    af64 = a.to(torch.float32).to(torch.float64)

    def resid2(lq, fused=True):
        # |c|*scale - level*step, rounded once (exact in float64), or
        # with the product rounded first
        if not fused:
            e = a.to(torch.float32) - lq.to(torch.float32) * step
        else:
            e = (af64 - lq.to(torch.float64) * step).to(torch.float32)
        return e * e

    def bits_of(lq):
        # static-context bits: sig + greater1/2 + sign + Golomb
        return torch.where(lq > 0, 2.0 + 2.0 * _bitlen(lq).to(torch.float32),
                           0.0)

    if inv is not None:
        def cost(lq, fused=True):
            return fma32(lam2 * bits_of(lq), resid2(lq, fused), inv)

        def dist(lq):
            return resid2(lq) * inv

        def gain(lq):
            return fma32(-dist(lq), resid2(torch.zeros_like(lq)), inv)
    else:
        def cost(lq, fused=True):
            return resid2(lq, fused) / norm + lam2 * bits_of(lq)

        def dist(lq):
            return resid2(lq) / norm

        def gain(lq):
            return dist(torch.zeros_like(lq)) - dist(lq)

    lm1 = torch.clamp(l_up - 1, min=0)
    # the round-half candidate's product rounds first where the step
    # lies above its power of two (as the reference's program does)
    c0, c1 = cost(torch.zeros_like(l_up)), cost(lm1)
    c2 = cost(l_up, fused=not (inv is not None and step > 2.0 ** qbits))
    if costs is not None:
        costs.append(torch.stack([c0, c1, c2]))
    # the first index wins ties
    newlv = torch.where((c1 < c0) & ~(c2 < c1), lm1,
                        torch.where(c2 < torch.minimum(c0, c1), l_up, 0))
    d_gain = gain(newlv)
    r_gain = bits_of(newlv)
    if n > 4:
        g = n // 4
        b = newlv.shape[-1]
        dd = _cg_sum_seq(d_gain.reshape(g, 4, g, 4, b))
        rr = r_gain.reshape(g, 4, g, 4, b).sum((1, 3))  # integer-valued
        rhs = lam2 * (rr + 2.0)
        if costs is not None:
            costs += [dd, rhs]
        kill = (dd <= rhs) & (rr > 0)
        keep = ~kill.repeat_interleave(4, 0).repeat_interleave(4, 1)
        newlv = torch.where(keep, newlv, 0)
        r_gain = torch.where(keep, r_gain, 0.0)
    else:
        keep = None
    dd_tu = _tu_sum_vec(d_gain, keep, batch)
    rr_tu = r_gain.sum((0, 1))
    rhs_tu = lam2 * (rr_tu + 2.0)
    if costs is not None:
        costs += [dd_tu, rhs_tu]
    kill_tu = (dd_tu <= rhs_tu) & (rr_tu > 0)
    newlv = torch.where(kill_tu, 0, newlv)
    out = torch.sign(tcoef) * newlv
    if not with_rem:
        return out
    return out, (a - (newlv << qbits)) >> (qbits - 8)


@lru_cache(maxsize=None)
def _rdoq_tables(device: torch.device):
    """QUANT_SCALES and _EXP2_F32 on the device (per-block QP)."""
    return (torch.as_tensor(QUANT_SCALES, device=device),
            torch.as_tensor(_EXP2_F32, device=device))


def rdoq_lanes(tcoef: torch.Tensor, size: int, qp, lam2: float,
               bit_depth: int = 8, with_rem: bool = False,
               costs: list | None = None):
    """RD-quantise (N, N, B) coefficients (replaces quant_lanes when RDOQ
    is on); qp a python int or a (B,) int32 tensor. with_rem also
    returns the deltaU remainders for sign-bit hiding; costs, see
    _rdoq."""
    return _rdoq(tcoef, size.bit_length() - 1, qp, lam2, bit_depth,
                 with_rem, costs)


def rdoq_batch(tcoef: torch.Tensor, size: int, qp, lam2: float,
               bit_depth: int = 8, with_rem: bool = False,
               costs: list | None = None):
    """rdoq_lanes for (B, N, N) coefficients (costs in the lanes layout)."""
    res = _rdoq(tcoef.permute(1, 2, 0), size.bit_length() - 1, qp, lam2,
                bit_depth, with_rem, costs, batch=True)
    if not with_rem:
        return res.permute(2, 0, 1)
    return res[0].permute(2, 0, 1), res[1].permute(2, 0, 1)


# =============================================================================
# host (numpy) forms, one block at a time: the host-recon I path
# =============================================================================

def dct_np(resi: np.ndarray, bit_depth: int = 8, dst: bool = False
           ) -> np.ndarray:
    """Forward transform of one NxN int residual block -> int32 coeffs."""
    n = resi.shape[-1]
    log2n = n.bit_length() - 1
    t = _fwd_matrix(n, dst).astype(np.int64)
    s1 = log2n + bit_depth - 9
    s2 = log2n + 6
    x = resi.astype(np.int64)
    m1 = _rshift_round(t @ x.T, s1)            # (T @ X^T) >> s1
    m2 = _rshift_round(t @ m1.T, s2)           # (T @ M1^T) >> s2
    return m2.astype(np.int32)


def idct_np(coef: np.ndarray, bit_depth: int = 8, dst: bool = False
            ) -> np.ndarray:
    """Normative inverse transform (clause 8.6.4) -> int residual."""
    n = coef.shape[-1]
    t = _fwd_matrix(n, dst).astype(np.int64)
    s2 = 20 - bit_depth
    c = coef.astype(np.int64)
    m1 = np.clip(_rshift_round(t.T @ c, 7), -32768, 32767)
    r = np.clip(_rshift_round(t.T @ m1.T, s2), -32768, 32767)
    return r.T.astype(np.int32)


def quant_np(coef: np.ndarray, qp: int, bit_depth: int = 8,
             intra: bool = True, with_rem: bool = False):
    """Scalar quantization of one block; with_rem also returns the
    sub-step rounding remainder deltaU (HM/x265), which sign-bit hiding
    uses to pick the cheapest parity adjustment."""
    n = coef.shape[-1]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    qbits = QUANT_SHIFT + per + transform_shift(log2n, bit_depth)
    add = (171 if intra else 85) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    a = np.abs(coef.astype(np.int64)) * scale
    level = (a + add) >> qbits
    level = np.clip(level, 0, 32767)
    out = (np.sign(coef) * level).astype(np.int32)
    if not with_rem:
        return out
    # signed remainder WITHOUT the rounding offset: > 0 means the true
    # value is above level * step (raising is good), < 0 the opposite
    delta_u = ((a - (level << qbits)) >> (qbits - 8)).astype(np.int32)
    return out, delta_u


def dequant_np(level: np.ndarray, qp: int, bit_depth: int = 8) -> np.ndarray:
    """Normative dequantization (clause 8.6.3, flat scaling list)."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    shift = bit_depth + log2n - 9
    scale = int(INV_QUANT_SCALES[rem]) << per
    v = (level.astype(np.int64) * scale + (1 << (shift - 1))) >> shift
    return np.clip(v, -32768, 32767).astype(np.int32)


def sign_hide_np(blk: np.ndarray, scan_idx: int,
                 delta_u: np.ndarray) -> np.ndarray:
    """Hidden-sign parity of one quantized NxN block: in every 4x4 CG
    where lastSigScanPos - firstSigScanPos > 3 the decoder infers the
    sign at firstSigScanPos from the parity of the level sum. Where the
    parity disagrees, one |level| moves by 1, at the position and in
    the direction of least rounding cost (x265 signBitHidingHDQ):
    lowering costs deltaU, raising -deltaU; a level of 1 at the first
    or last significant position may not be lowered."""
    n = blk.shape[-1]
    out = blk.copy()
    perm = _cg_perm(scan_idx)
    for cy in range(max(n // 4, 1)):
        for cx in range(max(n // 4, 1)):
            sl = (slice(cy * 4, cy * 4 + 4), slice(cx * 4, cx * 4 + 4))
            cg = out[sl].reshape(-1)
            lv = cg[perm].copy()
            du = delta_u[sl].reshape(-1)[perm]
            nz = np.nonzero(lv)[0]
            if len(nz) == 0 or nz[-1] - nz[0] <= 3:
                continue
            first, last = nz[0], nz[-1]
            neg = 1 if lv[first] < 0 else 0
            if (int(np.abs(lv).sum()) & 1) == neg:
                continue
            big = 1 << 30
            sig = lv != 0
            can_lower = sig & (np.abs(lv) < 32768) & \
                ((np.abs(lv) >= 2) |
                 ((np.arange(16) != first) & (np.arange(16) != last)))
            can_raise = sig & (np.abs(lv) < 32767)
            lower_cost = np.where(can_lower, du, big)
            raise_cost = np.where(can_raise, -du, big)
            costs = np.concatenate([lower_cost, raise_cost])
            k = int(np.argmin(costs))
            pos, d = (k, -1) if k < 16 else (k - 16, 1)
            lv[pos] += d if lv[pos] > 0 else -d
            cg[perm] = lv
            out[sl] = cg.reshape(4, 4)
    return out
