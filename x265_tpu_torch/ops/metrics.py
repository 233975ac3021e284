"""Quality metrics: PSNR and SSIM (x265 ssim_4x4x2_core/ssim_end_4
behavior, source/common/pixel.cpp:769-860; framefilter.cpp:654 wiring).

Counterpart of x265_tpu/ops/metrics.py: the numpy functions are copies;
ssim_plane_t is the device SSIM (the reference's ssim_plane_j) in torch
float32 on the planes' device.

x265 computes SSIM on 4x4 blocks over a half-pixel-shifted grid with
integer accumulators, then the per-block correlation terms feed the
float `ssim_end` combiner. PSNR follows the standard MSE definition
(framefilter.cpp computes it from the per-row SSD accumulators).
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(ref: np.ndarray, rec: np.ndarray, bit_depth: int = 8) -> float:
    maxv = (1 << bit_depth) - 1
    mse = np.mean((ref.astype(np.float64) - rec.astype(np.float64)) ** 2)
    if mse <= 0:
        return 99.99
    return float(10.0 * np.log10(maxv * maxv / mse))


def psnr_yuv(ref, rec, bit_depth: int = 8) -> tuple[float, float, float]:
    """(Y, Cb, Cr) PSNRs of two (y, cb, cr) plane triples."""
    return tuple(psnr(a, b, bit_depth) for a, b in zip(ref, rec))


# --- SSIM (x265 pixel.cpp ssim_4x4x2_core + ssim_end_4 behavior) -------------

def _ssim_end_1(s1, s2, ss, s12, bit_depth: int):
    """The float combiner over 4x4-block sums (pixel.cpp ssim_end_1):
    operates on sums of 2x2 neighbouring block statistics (64 px)."""
    pixel_max = (1 << bit_depth) - 1
    ssim_c1 = 0.01 * 0.01 * pixel_max * pixel_max * 64
    ssim_c2 = 0.03 * 0.03 * pixel_max * pixel_max * 64 * 63 / 64
    vars_ = ss * 64 - s1 * s1 - s2 * s2
    covar = s12 * 64 - s1 * s2
    return ((2 * s1 * s2 + ssim_c1) * (2 * covar + ssim_c2) /
            ((s1 * s1 + s2 * s2 + ssim_c1) * (vars_ + ssim_c2)))


def _quad_sums(s):
    """2x2 neighbourhood sums of a block-statistics grid (the "+1
    block" window)."""
    return s[:-1, :-1] + s[:-1, 1:] + s[1:, :-1] + s[1:, 1:]


def ssim_plane(ref: np.ndarray, rec: np.ndarray,
               bit_depth: int = 8) -> float:
    """Plane SSIM, x265 formulation: per-4x4-block integer sums on a
    half-block-shifted grid, combined 2x2 (64-px neighbourhoods); the
    frame score averages the interior blocks (framefilter.cpp:700)."""
    h, w = ref.shape
    bh, bw = h // 4, w // 4
    a = ref[:bh * 4, :bw * 4].astype(np.int64).reshape(bh, 4, bw, 4)
    b = rec[:bh * 4, :bw * 4].astype(np.int64).reshape(bh, 4, bw, 4)
    s1 = a.sum((1, 3)).astype(np.float64)
    s2 = b.sum((1, 3)).astype(np.float64)
    ss = ((a * a).sum((1, 3)) + (b * b).sum((1, 3))).astype(np.float64)
    s12 = (a * b).sum((1, 3)).astype(np.float64)
    vals = _ssim_end_1(_quad_sums(s1), _quad_sums(s2), _quad_sums(ss),
                       _quad_sums(s12), bit_depth)
    return float(vals.mean())


def ssim_plane_t(ref: torch.Tensor, rec: torch.Tensor,
                 bit_depth: int = 8) -> torch.Tensor:
    """Device SSIM: the whole plane's 4x4 statistics in one pass, in
    float32 (the sums are exact integers; the combiner rounds), on the
    planes' device. Returns a 0-dim float32 tensor."""
    h, w = ref.shape
    bh, bw = h // 4, w // 4
    a = ref[:bh * 4, :bw * 4].to(torch.float32).reshape(bh, 4, bw, 4)
    b = rec[:bh * 4, :bw * 4].to(torch.float32).reshape(bh, 4, bw, 4)
    s1 = a.sum((1, 3))
    s2 = b.sum((1, 3))
    ss = (a * a).sum((1, 3)) + (b * b).sum((1, 3))
    s12 = (a * b).sum((1, 3))
    return _ssim_end_1(_quad_sums(s1), _quad_sums(s2), _quad_sums(ss),
                       _quad_sums(s12), bit_depth).mean()


def ssim_to_db(ssim: float) -> float:
    """x265 reports SSIM in dB: -10*log10(1-ssim) (encoder.cpp)."""
    return float(-10.0 * np.log10(max(1.0 - ssim, 1e-10)))
