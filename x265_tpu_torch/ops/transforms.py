"""HEVC integer transforms + quantization, batched over TUs.

Counterpart of x265_tpu/ops/transforms.py (lanes and batch forms; the
numpy oracles stay in the reference package as the second truth).
Integer exactness: the matrix products run in float64, where every
product and partial sum (at most 32 x 90 x 2^16 < 2^28) is an exact
integer, and are cast back to int32. The reference splits operands into
8-bit limbs for its bf16 matrix unit; float64 needs no split on a GPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

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


def _qp_parts(qp: int, log2n: int, bit_depth: int):
    if not isinstance(qp, (int, np.integer)):
        raise NotImplementedError(
            "per-block QP vectors (dQP/AQ): ROADMAP queue 1 item 15")
    qp = int(qp)
    per, rem = qp // 6, qp % 6
    qbits = QUANT_SHIFT + per + transform_shift(log2n, bit_depth)
    return per, rem, qbits


# =============================================================================
# lanes layout: blocks as (N, N, B), the batch last
# =============================================================================

def dct_lanes(resi: torch.Tensor, size: int, bit_depth: int = 8,
              dst: bool = False) -> torch.Tensor:
    """Forward transform of (N, N, B) blocks -> (N, N, B) coefficients
    ([row, col] = [vertical, horizontal] frequency)."""
    log2n = size.bit_length() - 1
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


def _quant(coef: torch.Tensor, log2n: int, qp: int, bit_depth: int,
           intra: bool, with_rem: bool):
    _, rem, qbits = _qp_parts(qp, log2n, bit_depth)
    add = (171 if intra else 85) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    a = torch.abs(coef) * scale
    level = torch.clamp((a + add) >> qbits, 0, 32767)
    out = torch.sign(coef) * level
    if not with_rem:
        return out
    # signed remainder WITHOUT the rounding offset (HM/x265 deltaU)
    return out, (a - (level << qbits)) >> (qbits - 8)


def _dequant(level: torch.Tensor, log2n: int, qp: int,
             bit_depth: int) -> torch.Tensor:
    per, rem, _ = _qp_parts(qp, log2n, bit_depth)
    shift = bit_depth + log2n - 9
    scale = int(INV_QUANT_SCALES[rem]) << per
    return torch.clamp((level * scale + (1 << (shift - 1))) >> shift,
                       -32768, 32767)


def quant_lanes(coef: torch.Tensor, size: int, qp: int, bit_depth: int = 8,
                intra: bool = True, with_rem: bool = False):
    return _quant(coef, size.bit_length() - 1, qp, bit_depth, intra,
                  with_rem)


def dequant_lanes(level: torch.Tensor, size: int, qp: int,
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


def quant_batch(coef: torch.Tensor, size: int, qp: int, bit_depth: int = 8,
                intra: bool = True, with_rem: bool = False):
    """Quantize (B, N, N) int32 coefficients at one QP."""
    return _quant(coef, size.bit_length() - 1, qp, bit_depth, intra,
                  with_rem)


def dequant_batch(level: torch.Tensor, size: int, qp: int,
                  bit_depth: int = 8) -> torch.Tensor:
    return _dequant(level, size.bit_length() - 1, qp, bit_depth)


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
