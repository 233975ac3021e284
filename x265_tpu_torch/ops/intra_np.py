"""Intra prediction on the host (numpy), written from H.265 clause
8.4.4.2: the per-block predictor of the host-recon I path
(enc/intra_recon.py reconstruct_intra_frame). A copy of
x265_tpu/ops/intra_np.py, which needs no device.

Reference-sample handling uses a canonical layout R[0 .. 4N]:
    R[0]        = p[-1][2N-1]   (bottom-most left sample)
    R[2N - s]   = p[-1][s-1]    (left column, s = 1..2N)
    R[2N]       = p[-1][-1]     (corner)
    R[2N + t]   = p[t-1][-1]    (top row, t = 1..2N)
so the spec's substitution scan (8.4.4.2.2) is a forward fill over R.

Behavioral reference (for parity checking only): x265
source/common/intrapred.cpp and source/common/predict.cpp.
"""

from __future__ import annotations

import numpy as np

from ..common.tables import intra_angle, intra_inv_angle, intra_filter_flag


def canonical_refs(frame: np.ndarray, x0: int, y0: int, n: int,
                   avail: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Gather + substitute the 4N+1 reference samples for block (x0,y0).

    frame: full reconstructed plane (H, W) int
    avail: bool (4N+1,) availability per reference sample position
           (computed by the caller from decode order / picture bounds).
    """
    h, w = frame.shape
    r = np.zeros(4 * n + 1, dtype=np.int64)
    # positions
    for i in range(4 * n + 1):
        if i < 2 * n:          # left column, bottom-up: s = 2n - i
            x, y = x0 - 1, y0 + (2 * n - 1 - i)
        elif i == 2 * n:
            x, y = x0 - 1, y0 - 1
        else:                  # top row: t = i - 2n
            x, y = x0 + (i - 2 * n - 1), y0 - 1
        if avail[i]:
            r[i] = frame[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]
    if not avail.any():
        r[:] = 1 << (bit_depth - 1)
        return r
    # substitution: forward fill; R[0] takes first available if missing
    if not avail[0]:
        first = int(np.argmax(avail))
        r[0] = r[first]
    for i in range(1, 4 * n + 1):
        if not avail[i]:
            r[i] = r[i - 1]
    return r


def filter_refs(r: np.ndarray, n: int, bit_depth: int = 8,
                strong: bool = False) -> np.ndarray:
    """[1 2 1]/4 reference smoothing (8.4.4.2.3). `strong` = bilinear
    32x32 strong smoothing (requires caller to check the flatness test)."""
    if strong and n == 32:
        out = r.copy()
        corner = r[2 * n]
        bl, tr = r[0], r[4 * n]
        for s in range(1, 2 * n):      # left: R[2n-s], s=1..2n-1
            out[2 * n - s] = ((2 * n - s) * corner + s * bl + n) >> 6
        for t in range(1, 2 * n):
            out[2 * n + t] = ((2 * n - t) * corner + t * tr + n) >> 6
        return out
    out = r.copy()
    out[1:-1] = (r[:-2] + 2 * r[1:-1] + r[2:] + 2) >> 2
    return out


def strong_smoothing_condition(r: np.ndarray, n: int, bit_depth: int = 8) -> bool:
    """8.4.4.2.3 flatness test for 32x32 strong intra smoothing."""
    if n != 32:
        return False
    thr = 1 << (bit_depth - 5)
    corner, bl, tr = int(r[2 * n]), int(r[0]), int(r[4 * n])
    left_mid, top_mid = int(r[n]), int(r[3 * n])
    return (abs(corner + tr - 2 * top_mid) < thr and
            abs(corner + bl - 2 * left_mid) < thr)


def intra_pred_np(r: np.ndarray, mode: int, n: int, *, is_luma: bool = True,
                  bit_depth: int = 8, filtered: np.ndarray | None = None,
                  disable_edge_filters: bool = False) -> np.ndarray:
    """Predict an NxN block from canonical refs. `filtered` is the
    smoothed reference (required when the mode/size demands it)."""
    c = 2 * n
    maxval = (1 << bit_depth) - 1
    use_filt = is_luma and intra_filter_flag(mode, n.bit_length() - 1)
    rr = filtered if use_filt else r
    assert rr is not None
    L = rr[c - 1::-1]     # L[s] = p[-1][s], s = 0..2n-1
    T = rr[c + 1:]        # T[t] = p[t][-1]
    corner = int(rr[c])
    pred = np.zeros((n, n), dtype=np.int64)  # pred[y][x]

    if mode == 0:  # planar (8.4.4.2.4)
        tr = int(T[n])
        bl = int(L[n])
        xs = np.arange(n)
        ys = np.arange(n)
        xg, yg = np.meshgrid(xs, ys)
        log2n = n.bit_length() - 1
        pred = ((n - 1 - xg) * L[ys][:, None] + (xg + 1) * tr +
                (n - 1 - yg) * T[xs][None, :] + (yg + 1) * bl + n) >> (log2n + 1)
    elif mode == 1:  # DC (8.4.4.2.5)
        dc = (int(T[:n].sum()) + int(L[:n].sum()) + n) >> (n.bit_length())
        pred[:, :] = dc
        if is_luma and n < 32 and not disable_edge_filters:
            pred[0, :] = (T[:n] + 3 * dc + 2) >> 2
            pred[:, 0] = (L[:n] + 3 * dc + 2) >> 2
            pred[0, 0] = (int(L[0]) + 2 * dc + int(T[0]) + 2) >> 2
    else:  # angular (8.4.4.2.6)
        a = intra_angle(mode)
        if mode >= 18:  # vertical-ish: main ref = top
            ref = np.zeros(3 * n + 1, dtype=np.int64)  # ref[x], x = -n .. 2n
            off = n
            ref[off + 0] = corner
            ref[off + 1:] = T[:2 * n]
            lo = (n * a) >> 5
            if a < 0 and lo < -1:
                inv = intra_inv_angle(mode)
                for x in range(-1, lo - 1, -1):
                    ref[off + x] = L[-1 + ((x * inv + 128) >> 8)]
            for y in range(n):
                i = ((y + 1) * a) >> 5
                f = ((y + 1) * a) & 31
                for x in range(n):
                    p0 = ref[off + x + i + 1]
                    p1 = ref[off + min(x + i + 2, 2 * n)]
                    pred[y, x] = ((32 - f) * p0 + f * p1 + 16) >> 5
            if mode == 26 and is_luma and n < 32 and not disable_edge_filters:
                col = T[0] + ((L[:n] - corner) >> 1)
                pred[:, 0] = np.clip(col, 0, maxval)
        else:  # horizontal-ish: main ref = left (transpose of vertical case)
            ref = np.zeros(3 * n + 1, dtype=np.int64)
            off = n
            ref[off + 0] = corner
            ref[off + 1:] = L[:2 * n]
            lo = (n * a) >> 5
            if a < 0 and lo < -1:
                inv = intra_inv_angle(mode)
                for x in range(-1, lo - 1, -1):
                    ref[off + x] = T[-1 + ((x * inv + 128) >> 8)]
            for x in range(n):
                i = ((x + 1) * a) >> 5
                f = ((x + 1) * a) & 31
                for y in range(n):
                    p0 = ref[off + y + i + 1]
                    p1 = ref[off + min(y + i + 2, 2 * n)]
                    pred[y, x] = ((32 - f) * p0 + f * p1 + 16) >> 5
            if mode == 10 and is_luma and n < 32 and not disable_edge_filters:
                row = L[0] + ((T[:n] - corner) >> 1)
                pred[0, :] = np.clip(row, 0, maxval)
    return np.clip(pred, 0, maxval).astype(np.int32)
