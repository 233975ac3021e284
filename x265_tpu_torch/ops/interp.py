"""HEVC sub-pel interpolation (clause 8.5.4.2): 8-tap luma quarter-pel,
4-tap chroma eighth-pel.

The filter tables, the numpy oracles of the normative
fractional-sample process (luma_mc_np / chroma_mc_np and their
accumulators), which the validation decoder (decoder/) predicts with,
and the batched block MC of the host B path (mc_block_batch,
bi_average): counterparts of those of x265_tpu/ops/interp.py. The P
and device-B scans filter where the windowed motion search applies it
(ops/me_win.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# Table 8-11: luma interpolation filter coefficients per quarter position
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Table 8-13: chroma filter coefficients per eighth position
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)

LUMA_TAPS = 8
CHROMA_TAPS = 4


# =============================================================================
# numpy oracles
# =============================================================================

def _clip_fetch(plane: np.ndarray, y: int, x: int) -> int:
    h, w = plane.shape
    return int(plane[min(max(y, 0), h - 1), min(max(x, 0), w - 1)])


def luma_mc_raw_np(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int,
                   mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """14-bit intermediate luma prediction (no final rounding) — the
    predSamplesLX array of clause 8.5.4.2, needed for bi averaging."""
    out = _luma_mc_acc(ref, x0, y0, n, mv_x, mv_y, bit_depth)
    return (out >> (bit_depth - 8)).astype(np.int32) if False else out


def luma_mc_np(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int,
               mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Predict an NxN luma block at (x0, y0) displaced by quarter-pel MV.
    Out-of-frame samples use edge clamping (the padded-border rule)."""
    out = _luma_mc_acc(ref, x0, y0, n, mv_x, mv_y, bit_depth)
    # uni-pred final: >>6 to 14-bit then round >> (14-bd) == one rounded
    # shift by 12-shift1 (nested-floor identity)
    shift1 = bit_depth - 8
    total_shift = 12 - shift1
    out = (out + (1 << (total_shift - 1))) >> total_shift
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def _luma_mc_acc(ref, x0, y0, n, mv_x, mv_y, bit_depth):
    """Two-stage filter accumulator before the final shift (26-bit)."""
    fx, fy = mv_x & 3, mv_y & 3
    ix, iy = x0 + (mv_x >> 2), y0 + (mv_y >> 2)
    hf = LUMA_FILTERS[fx]
    vf = LUMA_FILTERS[fy]
    shift1 = bit_depth - 8
    tmp = np.zeros((n + 7, n), dtype=np.int64)
    for r in range(n + 7):
        for c in range(n):
            acc = 0
            for t in range(8):
                acc += hf[t] * _clip_fetch(ref, iy + r - 3, ix + c + t - 3)
            tmp[r, c] = acc >> shift1
    out = np.zeros((n, n), dtype=np.int64)
    for r in range(n):
        for c in range(n):
            acc = 0
            for t in range(8):
                acc += vf[t] * tmp[r + t, c]
            out[r, c] = acc
    return out


def bi_average_np(acc0: np.ndarray, acc1: np.ndarray,
                  bit_depth: int = 8) -> np.ndarray:
    """Default bi-prediction combine (clause 8.5.4.2.3.2): the two
    26-bit accumulators are first brought to 14-bit (>> 6), then
    averaged with shift 15 - bitDepth."""
    p0 = acc0 >> 6
    p1 = acc1 >> 6
    shift = 15 - bit_depth
    out = (p0 + p1 + (1 << (shift - 1))) >> shift
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def chroma_mc_acc_np(ref, x0, y0, n, mv_x, mv_y, bit_depth=8):
    fx, fy = mv_x & 7, mv_y & 7
    ix, iy = x0 + (mv_x >> 3), y0 + (mv_y >> 3)
    hf = CHROMA_FILTERS[fx]
    vf = CHROMA_FILTERS[fy]
    shift1 = bit_depth - 8
    tmp = np.zeros((n + 3, n), dtype=np.int64)
    for r in range(n + 3):
        for c in range(n):
            acc = 0
            for t in range(4):
                acc += hf[t] * _clip_fetch(ref, iy + r - 1, ix + c + t - 1)
            tmp[r, c] = acc >> shift1
    out = np.zeros((n, n), dtype=np.int64)
    for r in range(n):
        for c in range(n):
            acc = 0
            for t in range(4):
                acc += vf[t] * tmp[r + t, c]
            out[r, c] = acc
    return out


def chroma_mc_np(ref: np.ndarray, x0: int, y0: int, n: int, mv_x: int,
                 mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """Chroma MC: MV in luma quarter-pel units -> chroma eighth-pel."""
    out = chroma_mc_acc_np(ref, x0, y0, n, mv_x, mv_y, bit_depth)
    shift1 = bit_depth - 8
    total_shift = 12 - shift1
    out = (out + (1 << (total_shift - 1))) >> total_shift
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


# =============================================================================
# batched block MC (torch)
# =============================================================================

def _gather_patches(plane: torch.Tensor, x0s: torch.Tensor,
                    y0s: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size, size) patches at integer positions with edge clamping
    (the plane is unpadded; clamping reproduces border extension). The
    plane is read as int32: torch's CUDA build has no tensor-indexed
    read of uint16."""
    plane = plane.to(torch.int32)
    h, w = plane.shape
    ar = torch.arange(size, device=plane.device)
    ys = torch.clamp(y0s[:, None] + ar[None, :], 0, h - 1)
    xs = torch.clamp(x0s[:, None] + ar[None, :], 0, w - 1)
    return plane[ys[:, :, None], xs[:, None, :]]


@lru_cache(maxsize=None)
def _filter_bank(is_luma: bool) -> np.ndarray:
    return LUMA_FILTERS if is_luma else CHROMA_FILTERS


def mc_block_batch(ref: torch.Tensor, x0s: torch.Tensor, y0s: torch.Tensor,
                   mvx: torch.Tensor, mvy: torch.Tensor, n: int, *,
                   is_luma: bool = True, bit_depth: int = 8,
                   raw: bool = False) -> torch.Tensor:
    """Motion-compensate B same-size blocks with per-block MVs.

    ref: (H, W) plane; x0s/y0s: (B,) int block origins; mvx/mvy: (B,)
    MVs in quarter-pel (luma) units, eighth-pel of chroma. Returns (B,
    n, n) int32 predictions, or with raw the 26-bit accumulators
    (>> 6 is the 14-bit prediction). int32 arithmetic: every partial
    sum is below 2^24, the integers the reference's float32 einsums
    hold exactly, so the two agree."""
    taps = LUMA_TAPS if is_luma else CHROMA_TAPS
    half = taps // 2 - 1
    frac, sh = (3, 2) if is_luma else (7, 3)
    fx, fy = mvx & frac, mvy & frac
    ix = x0s + (mvx >> sh)
    iy = y0s + (mvy >> sh)
    bank = torch.as_tensor(_filter_bank(is_luma), device=ref.device)
    hf = bank[fx.long()]                               # (B, taps)
    vf = bank[fy.long()]
    patches = _gather_patches(ref, ix - half, iy - half, n + taps - 1)
    # horizontal: tmp[b, r, c] = sum_t hf[b, t] * patch[b, r, c + t]
    tmp = sum(hf[:, t, None, None] * patches[:, :, t:t + n]
              for t in range(taps))
    shift1 = bit_depth - 8
    if shift1:
        tmp = tmp >> shift1
    # vertical: out[b, r, c] = sum_t vf[b, t] * tmp[b, r + t, c]
    out = sum(vf[:, t, None, None] * tmp[:, t:t + n, :]
              for t in range(taps))
    if raw:
        return out
    total_shift = 12 - shift1
    out = (out + (1 << (total_shift - 1))) >> total_shift
    return torch.clamp(out, 0, (1 << bit_depth) - 1)


def bi_average(acc0: torch.Tensor, acc1: torch.Tensor,
               bit_depth: int = 8) -> torch.Tensor:
    """Default bi-prediction combine (clause 8.5.4.2.3.2): the 26-bit
    accumulators -> 14-bit intermediates -> averaged."""
    shift = 15 - bit_depth
    out = ((acc0 >> 6) + (acc1 >> 6) + (1 << (shift - 1))) >> shift
    return torch.clamp(out, 0, (1 << bit_depth) - 1)
