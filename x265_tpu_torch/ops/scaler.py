"""Polyphase video scaler (the x265 ABR-ladder scaler analog,
source/common/scaler.{h,cpp}, which feeds the lower ladder rungs,
abrEncApp.cpp:938).

Counterpart of x265_tpu/ops/scaler.py: a separable 8-tap polyphase
filter in which each tap is one row gather and an int32 multiply-add
over the whole plane, then (acc + 64) >> 7 and the clip, so the result
is exact on every device. The 16-phase cubic bank is the reference's
(a numpy copy); when downscaling, the kernel widens by the scale ratio.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device

N_PHASES = 16
N_TAPS = 8


@lru_cache(maxsize=None)
def _bank(ratio_q8: int) -> np.ndarray:
    """(N_PHASES, N_TAPS) int16 filter bank, 7-bit normalized. ratio =
    out/in size as Q8; kernels widen by 1/ratio when downscaling."""
    ratio = min(ratio_q8 / 256.0, 1.0)
    bank = np.zeros((N_PHASES, N_TAPS), np.int32)

    def cubic(x):
        x = abs(x)
        if x < 1:
            return 1.5 * x ** 3 - 2.5 * x ** 2 + 1
        if x < 2:
            return -0.5 * x ** 3 + 2.5 * x ** 2 - 4 * x + 2
        return 0.0

    for p in range(N_PHASES):
        frac = p / N_PHASES
        w = np.array([cubic((t - (N_TAPS // 2 - 1) - frac) * ratio)
                      for t in range(N_TAPS)])
        w = w / w.sum()
        q = np.round(w * 128).astype(np.int32)
        q[N_TAPS // 2 - 1] += 128 - q.sum()     # exact normalization
        bank[p] = q
    return bank


def _resample_axis(plane: torch.Tensor, out_len: int, axis: int,
                   bit_depth: int) -> torch.Tensor:
    """Polyphase resample of an int32 plane along one axis: per tap, the
    source rows (edge-replicated past the border) times the per-output
    weight, summed in int32."""
    in_len = plane.shape[axis]
    if in_len == out_len:
        return plane
    ratio_q8 = max(int(round(out_len / in_len * 256)), 1)
    bank = _bank(ratio_q8)
    # source position of each output sample (center-aligned)
    pos = (np.arange(out_len) + 0.5) * in_len / out_len - 0.5
    base = np.floor(pos).astype(np.int32)
    phase = np.round((pos - base) * N_PHASES).astype(np.int32)
    base += phase // N_PHASES
    phase %= N_PHASES
    start = base - (N_TAPS // 2 - 1)
    wts = bank[phase]                          # (out_len, N_TAPS)
    pad = N_TAPS
    src = plane.movedim(axis, 0)
    dev = src.device
    idx0 = np.clip(start + pad, 0, in_len + 2 * pad - 1)
    acc = torch.zeros((out_len,) + tuple(src.shape[1:]), dtype=torch.int32,
                      device=dev)
    for t in range(N_TAPS):
        # a row of the edge-padded plane is a clipped row of the plane
        rows = np.clip(np.clip(idx0 + t, 0, in_len + 2 * pad - 1) - pad,
                       0, in_len - 1)
        w = torch.as_tensor(wts[:, t].astype(np.int32), device=dev)
        taps = src.index_select(0, torch.as_tensor(rows.astype(np.int64),
                                                   device=dev))
        acc = acc + taps * w.reshape((-1,) + (1,) * (src.dim() - 1))
    maxv = (1 << bit_depth) - 1
    out = torch.clamp((acc + 64) >> 7, 0, maxv)
    return out.movedim(0, axis)


def scale_plane_t(plane: torch.Tensor, out_h: int, out_w: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """Resample an int32 plane on its device to (out_h, out_w)."""
    p = _resample_axis(plane, out_w, 1, bit_depth)
    return _resample_axis(p, out_h, 0, bit_depth)


def scale_plane(plane, out_h: int, out_w: int, bit_depth: int = 8,
                device=None) -> np.ndarray:
    """Resample one host plane to (out_h, out_w) on the device (the GPU
    unless device says otherwise); returns int32 host samples."""
    dev = resolve_device(device)
    p = torch.from_numpy(np.ascontiguousarray(
        np.asarray(plane).astype(np.int32))).to(dev)
    return scale_plane_t(p, out_h, out_w, bit_depth).cpu().numpy()


def scale_frame(frame, out_w: int, out_h: int, bit_depth: int = 8,
                device=None):
    """(y, cb, cr) 4:2:0 triple -> scaled triple, each plane in its
    source dtype."""
    y, cb, cr = frame
    return (scale_plane(y, out_h, out_w, bit_depth, device)
            .astype(np.asarray(y).dtype),
            scale_plane(cb, out_h // 2, out_w // 2, bit_depth, device)
            .astype(np.asarray(cb).dtype),
            scale_plane(cr, out_h // 2, out_w // 2, bit_depth, device)
            .astype(np.asarray(cr).dtype))
