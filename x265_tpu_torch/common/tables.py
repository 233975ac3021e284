"""Normative HEVC spec tables + derived constants.

All numeric data here are constants of ITU-T H.265 (transform matrices
8.6.4, scan orders 6.5.3, intra angles 8.4.4.2.6, quant scales 8.6.3,
chroma QP mapping Table 8-10). Where possible they are *generated* from
the spec's defining rules rather than transcribed. Behavioral reference
for layout/usage: x265 source/common/constants.cpp.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

# --- transform matrices ------------------------------------------------------

# 33-entry base cosine-approximation vector c[m] ~ round(64*sqrt(2)*cos(m*pi/64))
# with the normative integer tweaks (c[8]=83, c[24]=36, c[16]=c[0]=64).
_DCT_BASE = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0,
], dtype=np.int32)


def _gen_dct_matrix(n: int) -> np.ndarray:
    """T_N[i][j] = sign * c[m] from the cosine folding of cos((2j+1)*i*pi/(2N))."""
    step = 32 // n  # fold onto the 64-sample half-period grid
    t = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        for j in range(n):
            x = (i * step * (2 * j + 1)) % 128
            if x <= 32:
                s, m = 1, x
            elif x <= 64:
                s, m = -1, 64 - x
            elif x <= 96:
                s, m = -1, x - 64
            else:
                s, m = 1, 128 - x
            t[i, j] = s * int(_DCT_BASE[m])
    return t


T4 = _gen_dct_matrix(4)
T8 = _gen_dct_matrix(8)
T16 = _gen_dct_matrix(16)
T32 = _gen_dct_matrix(32)
DCT_MATRICES = {4: T4, 8: T8, 16: T16, 32: T32}

# 4x4 DST-VII used for intra luma 4x4 TBs (H.265 clause 8.6.4.2)
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int32)

# --- quantization ------------------------------------------------------------

# forward scale f[qp%6] (non-normative encoder side, x264/HM lineage) and
# normative dequant scale levelScale[qp%6] (clause 8.6.3)
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
IQUANT_SHIFT = 6


def transform_shift(log2_tr_size: int, bit_depth: int) -> int:
    return MAX_TR_DYNAMIC_RANGE - bit_depth - log2_tr_size


# --- chroma QP (4:2:0) -------------------------------------------------------

_CHROMA_QP_MAP = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
                  37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp_i: int, csp420: bool = True) -> int:
    """Table 8-10 mapping qPi -> qPc for 4:2:0 (identity for 4:2:2/4:4:4
    up to clip at 51)."""
    qp_i = max(0, qp_i)
    if not csp420:
        return min(qp_i, 51)
    if qp_i < 30:
        return qp_i
    if qp_i <= 43:
        return _CHROMA_QP_MAP[qp_i]
    return qp_i - 6


# flat LUT for traced per-block chroma QP derivation (qPi 0..57)
CHROMA_QP_LUT = np.array([chroma_qp(q) for q in range(58)], dtype=np.int32)


# --- scan orders (clause 6.5.3) ---------------------------------------------

SCAN_DIAG = 0
SCAN_HOR = 1
SCAN_VER = 2


def _diag_scan(w: int, h: int) -> np.ndarray:
    order = []
    x = y = 0
    while len(order) < w * h:
        while y >= 0:
            if x < w and y < h:
                order.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(order, dtype=np.int32)  # (N,2) of (x, y)


@lru_cache(maxsize=None)
def scan_order(scan_idx: int, log2_size: int) -> np.ndarray:
    """Coefficient scan positions (x, y), DC first, shape (N, 2)."""
    n = 1 << log2_size
    if scan_idx == SCAN_HOR:
        ys, xs = np.divmod(np.arange(n * n, dtype=np.int32), n)
        return np.stack([xs, ys], axis=1)
    if scan_idx == SCAN_VER:
        xs, ys = np.divmod(np.arange(n * n, dtype=np.int32), n)
        return np.stack([xs, ys], axis=1)
    return _diag_scan(n, n)


@lru_cache(maxsize=None)
def cg_scan_order(scan_idx: int, log2_size: int) -> np.ndarray:
    """4x4 coefficient-group scan positions (xCG, yCG), DC-group first."""
    n = 1 << max(log2_size - 2, 0)
    if scan_idx == SCAN_HOR:
        ys, xs = np.divmod(np.arange(n * n, dtype=np.int32), n)
        return np.stack([xs, ys], axis=1)
    if scan_idx == SCAN_VER:
        xs, ys = np.divmod(np.arange(n * n, dtype=np.int32), n)
        return np.stack([xs, ys], axis=1)
    return _diag_scan(n, n)


@lru_cache(maxsize=None)
def full_scan_table(scan_idx: int, log2_size: int) -> np.ndarray:
    """Raster index per scan position, CG-major like the coding order:
    scan CGs in cg_scan_order, and the 16 coefficients inside each CG
    with the same scan pattern (clause 6.5.3 note / 7.3.8.11 usage)."""
    size = 1 << log2_size
    if log2_size == 2:
        xy = scan_order(scan_idx, 2)
        return (xy[:, 1] * size + xy[:, 0]).astype(np.int32)
    cgs = cg_scan_order(scan_idx, log2_size)
    inner = scan_order(scan_idx, 2)
    out = np.zeros(size * size, dtype=np.int32)
    i = 0
    for cx, cy in cgs:
        for px, py in inner:
            x = cx * 4 + px
            y = cy * 4 + py
            out[i] = y * size + x
            i += 1
    return out


def intra_scan_idx(pred_mode: int, log2_size: int, is_luma: bool) -> int:
    """Mode-dependent coefficient scan (clause 7.4.9.11): applies to
    luma 4x4/8x8 and chroma 4x4 (4:2:0) TBs."""
    if (is_luma and log2_size <= 3) or (not is_luma and log2_size == 2):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# --- intra prediction angles (clause 8.4.4.2.6) ------------------------------

# intraPredAngle for modes 2..34
INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], dtype=np.int32)

# invAngle = round(8192 / angle) for the negative-angle modes
INTRA_INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256,
    -315, -390, -482, -630, -910, -1638, -4096,
], dtype=np.int32)  # modes 11..25


def intra_angle(mode: int) -> int:
    assert 2 <= mode <= 34
    return int(INTRA_PRED_ANGLE[mode - 2])


def intra_inv_angle(mode: int) -> int:
    assert 11 <= mode <= 25
    return int(INTRA_INV_ANGLE[mode - 11])


def intra_filter_flag(mode: int, log2_size: int) -> bool:
    """Reference-sample smoothing decision (clause 8.4.4.2.3)."""
    if log2_size == 2 or mode == 1:  # 4x4 / DC: never filtered
        return False
    if mode == 0:  # planar: filtered for sizes 8..32
        return True
    thresh = {3: 7, 4: 1, 5: 0}[log2_size]
    return min(abs(mode - 26), abs(mode - 10)) > thresh


# --- lambda / RD model (non-normative, x264/x265 lineage) -------------------

QP_MAX_SPEC = 51


def lambda2_from_qp(qp: float) -> float:
    """SSE-domain lambda (x265 rdcost lineage: lambda2 ~ 0.57*2^((qp-12)/3))."""
    return 0.57 * math.pow(2.0, (qp - 12.0) / 3.0)


def lambda_from_qp(qp: float) -> float:
    return math.sqrt(lambda2_from_qp(qp))


LAMBDA_TAB = np.array([lambda_from_qp(q) for q in range(QP_MAX_SPEC + 18)])
LAMBDA2_TAB = np.array([lambda2_from_qp(q) for q in range(QP_MAX_SPEC + 18)])


# --- block geometry helpers --------------------------------------------------

def clip3(lo, hi, v):
    return max(lo, min(hi, v))
