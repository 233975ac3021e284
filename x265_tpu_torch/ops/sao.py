"""Sample Adaptive Offset (clause 8.7.3) on the host (numpy): stats,
parameter RDO, apply. The SAO of the host-recon I path: a copy of
x265_tpu/ops/sao.py. ops/sao_gpu.py is the device counterpart of the
reference's sao_tpu.py; the two reach their float decisions through
different arithmetic, so the host frame keeps this copy.

Reference behavior: x265 source/encoder/sao.cpp (calcSaoStatsCu,
rdoSaoUnitCu, applyPixelOffsets). Encoder flow here is the batched
two-phase pipeline's natural fit: the frame is fully reconstructed and
deblocked before entropy coding, so per-CTU SAO parameters are chosen
in one vectorized pass (no second encode pass like x265's
frameencoder.cpp:1239 re-encode).

Types: 0 = not applied, 1 = band offset (BO), 2 = edge offset (EO).
EO classes 0..3 = horizontal / vertical / 135deg / 45deg.
"""

from __future__ import annotations

import numpy as np

from ..common.tables import lambda2_from_qp

EO_SHIFTS = {
    0: ((0, -1), (0, 1)),      # horizontal: left/right neighbours
    1: ((-1, 0), (1, 0)),      # vertical
    2: ((-1, -1), (1, 1)),     # 135 degrees
    3: ((-1, 1), (1, -1)),     # 45 degrees
}
NUM_EO_CAT = 5                 # categories 0 (none) + 1..4


def eo_categories(rec: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-pixel EO category (0..4). Picture-border pixels -> 0."""
    h, w = rec.shape
    (dy0, dx0), (dy1, dx1) = EO_SHIFTS[eo_class]
    cat = np.zeros((h, w), dtype=np.int8)
    ys = slice(max(dy0, dy1, 0), h + min(dy0, dy1, 0))
    xs = slice(max(dx0, dx1, 0), w + min(dx0, dx1, 0))
    c = rec[ys, xs].astype(np.int32)
    n0 = rec[ys.start + dy0:ys.stop + dy0, xs.start + dx0:xs.stop + dx0] \
        .astype(np.int32)
    n1 = rec[ys.start + dy1:ys.stop + dy1, xs.start + dx1:xs.stop + dx1] \
        .astype(np.int32)
    s0 = np.sign(c - n0)
    s1 = np.sign(c - n1)
    edge = s0 + s1
    m = np.zeros_like(c, dtype=np.int8)
    m[edge == -2] = 1
    m[edge == -1] = 2
    m[edge == 1] = 3
    m[edge == 2] = 4
    cat[ys, xs] = m
    return cat


def apply_sao_component_np(rec: np.ndarray, params: np.ndarray,
                           ctu: int, bit_depth: int = 8) -> np.ndarray:
    """Apply per-CTU SAO params to one plane.

    params: (ncty, nctx, 6) int32: [type, class_or_band, o0, o1, o2, o3].
    `ctu` is the CTU size in THIS plane's units (16 for chroma 4:2:0).
    """
    h, w = rec.shape
    maxv = (1 << bit_depth) - 1
    out = rec.astype(np.int32).copy()
    shift = bit_depth - 5
    ncty, nctx = params.shape[:2]
    # categories for all four classes once (cheap, vectorized)
    cats = {k: eo_categories(rec, k) for k in range(4)}
    for ty in range(ncty):
        for tx in range(nctx):
            t = int(params[ty, tx, 0])
            if t == 0:
                continue
            y0, x0 = ty * ctu, tx * ctu
            y1, x1 = min(y0 + ctu, h), min(x0 + ctu, w)
            blk = rec[y0:y1, x0:x1].astype(np.int32)
            offs = params[ty, tx, 2:6]
            if t == 1:   # band
                band = blk >> shift
                pos = int(params[ty, tx, 1])
                add = np.zeros_like(blk)
                for k in range(4):
                    add[band == ((pos + k) & 31)] = offs[k]
                out[y0:y1, x0:x1] = np.clip(blk + add, 0, maxv)
            else:        # edge
                cls = int(params[ty, tx, 1])
                cat = cats[cls][y0:y1, x0:x1]
                add = np.zeros_like(blk)
                for k in range(4):
                    add[cat == k + 1] = offs[k]
                out[y0:y1, x0:x1] = np.clip(blk + add, 0, maxv)
    return out


def _ctu_reduce(a: np.ndarray, ncty: int, nctx: int, ctu: int) -> np.ndarray:
    """Sum plane values per CTU -> (ncty, nctx). Pads ragged edges."""
    h, w = a.shape
    pad = np.zeros((ncty * ctu, nctx * ctu), dtype=np.int64)
    pad[:h, :w] = a
    return pad.reshape(ncty, ctu, nctx, ctu).sum(axis=(1, 3))


def sao_stats_component(orig: np.ndarray, rec: np.ndarray, ctu: int
                        ) -> dict:
    """Per-CTU sums/counts for every EO class+category and BO band."""
    h, w = orig.shape
    ncty = (h + ctu - 1) // ctu
    nctx = (w + ctu - 1) // ctu
    diff = orig.astype(np.int64) - rec.astype(np.int64)
    stats = {"eo_sum": np.zeros((4, 4, ncty, nctx), np.int64),
             "eo_cnt": np.zeros((4, 4, ncty, nctx), np.int64)}
    for cls in range(4):
        cat = eo_categories(rec, cls)
        for k in range(4):
            m = cat == k + 1
            stats["eo_sum"][cls, k] = _ctu_reduce(diff * m, ncty, nctx, ctu)
            stats["eo_cnt"][cls, k] = _ctu_reduce(m.astype(np.int64),
                                                  ncty, nctx, ctu)
    return stats


def sao_band_stats(orig: np.ndarray, rec: np.ndarray, ctu: int,
                   bit_depth: int = 8) -> tuple[np.ndarray, np.ndarray]:
    h, w = orig.shape
    ncty = (h + ctu - 1) // ctu
    nctx = (w + ctu - 1) // ctu
    diff = orig.astype(np.int64) - rec.astype(np.int64)
    band = rec.astype(np.int32) >> (bit_depth - 5)
    sums = np.zeros((32, ncty, nctx), np.int64)
    cnts = np.zeros((32, ncty, nctx), np.int64)
    for b in range(32):
        m = band == b
        sums[b] = _ctu_reduce(diff * m, ncty, nctx, ctu)
        cnts[b] = _ctu_reduce(m.astype(np.int64), ncty, nctx, ctu)
    return sums, cnts


def _best_offset(s: np.ndarray, c: np.ndarray, sign: int, max_off: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Optimal clipped offset + distortion reduction (delta-SSE, where
    dD = c*o^2 - 2*o*s; negative is better)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        o = np.where(c > 0, np.round(s / np.maximum(c, 1)), 0).astype(np.int64)
    if sign > 0:
        o = np.clip(o, 0, max_off)
    elif sign < 0:
        o = np.clip(o, -max_off, 0)
    else:
        o = np.clip(o, -max_off, max_off)
    dd = c * o * o - 2 * o * s
    return o, dd


def choose_sao_params(orig: np.ndarray, rec: np.ndarray, ctu: int, qp: int,
                      bit_depth: int = 8, is_chroma: bool = False
                      ) -> np.ndarray:
    """Per-CTU SAO decision for one plane: (ncty, nctx, 6) params."""
    h, w = orig.shape
    ncty = (h + ctu - 1) // ctu
    nctx = (w + ctu - 1) // ctu
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1
    lam = lambda2_from_qp(qp)
    st = sao_stats_component(orig, rec, ctu)
    params = np.zeros((ncty, nctx, 6), np.int32)
    best_cost = np.zeros((ncty, nctx))      # cost of OFF = 0
    # edge classes: categories 1,2 positive offsets; 3,4 negative
    for cls in range(4):
        offs = np.zeros((4, ncty, nctx), np.int64)
        dd = np.zeros((ncty, nctx))
        for k in range(4):
            sign = 1 if k < 2 else -1
            o, d = _best_offset(st["eo_sum"][cls, k], st["eo_cnt"][cls, k],
                                sign, max_off)
            offs[k] = o
            dd = dd + d
        bits = 2 + np.abs(offs).sum(axis=0) + 2   # type + offsets + class
        cost = dd + lam * bits
        better = cost < best_cost
        for ty, tx in zip(*np.nonzero(better)):
            params[ty, tx] = [2, cls, offs[0, ty, tx], offs[1, ty, tx],
                              offs[2, ty, tx], offs[3, ty, tx]]
        best_cost = np.where(better, cost, best_cost)
    # band offset: best 4-band window
    bsums, bcnts = sao_band_stats(orig, rec, ctu, bit_depth)
    bo, bdd = _best_offset(bsums, bcnts, 0, max_off)     # (32, ncty, nctx)
    for pos in range(32):
        ks = [(pos + k) & 31 for k in range(4)]
        dd = sum(bdd[k] for k in ks)
        offs = np.stack([bo[k] for k in ks])
        bits = 2 + np.abs(offs).sum(axis=0) + (offs != 0).sum(axis=0) + 5
        cost = dd + lam * bits
        better = cost < best_cost
        for ty, tx in zip(*np.nonzero(better)):
            params[ty, tx] = [1, pos, offs[0, ty, tx], offs[1, ty, tx],
                              offs[2, ty, tx], offs[3, ty, tx]]
        best_cost = np.where(better, cost, best_cost)
    return params


def choose_sao_chroma(orig_cb, rec_cb, orig_cr, rec_cr, ctu, qp,
                      bit_depth: int = 8):
    """Joint cb/cr decision: sao_type_idx_chroma and eo_class are shared
    between the chroma components (clause 7.3.8.3); offsets and band
    positions are per-component."""
    h, w = orig_cb.shape
    ncty = (h + ctu - 1) // ctu
    nctx = (w + ctu - 1) // ctu
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1
    lam = lambda2_from_qp(qp)
    st_cb = sao_stats_component(orig_cb, rec_cb, ctu)
    st_cr = sao_stats_component(orig_cr, rec_cr, ctu)
    p_cb = np.zeros((ncty, nctx, 6), np.int32)
    p_cr = np.zeros((ncty, nctx, 6), np.int32)
    best_cost = np.zeros((ncty, nctx))
    for cls in range(4):
        offs_cb = np.zeros((4, ncty, nctx), np.int64)
        offs_cr = np.zeros((4, ncty, nctx), np.int64)
        dd = np.zeros((ncty, nctx))
        for k in range(4):
            sign = 1 if k < 2 else -1
            o, d = _best_offset(st_cb["eo_sum"][cls, k],
                                st_cb["eo_cnt"][cls, k], sign, max_off)
            offs_cb[k] = o
            dd = dd + d
            o, d = _best_offset(st_cr["eo_sum"][cls, k],
                                st_cr["eo_cnt"][cls, k], sign, max_off)
            offs_cr[k] = o
            dd = dd + d
        bits = 2 + 2 + np.abs(offs_cb).sum(axis=0) + \
            np.abs(offs_cr).sum(axis=0)
        cost = dd + lam * bits
        better = cost < best_cost
        for ty, tx in zip(*np.nonzero(better)):
            p_cb[ty, tx] = [2, cls] + [int(offs_cb[k, ty, tx])
                                       for k in range(4)]
            p_cr[ty, tx] = [2, cls] + [int(offs_cr[k, ty, tx])
                                       for k in range(4)]
        best_cost = np.where(better, cost, best_cost)
    # band offset (shared type, per-component position/offsets)
    bs_cb, bc_cb = sao_band_stats(orig_cb, rec_cb, ctu, bit_depth)
    bs_cr, bc_cr = sao_band_stats(orig_cr, rec_cr, ctu, bit_depth)
    bo_cb, bd_cb = _best_offset(bs_cb, bc_cb, 0, max_off)
    bo_cr, bd_cr = _best_offset(bs_cr, bc_cr, 0, max_off)

    def best_window(bo, bdd):
        cost = np.full((ncty, nctx), np.inf)
        pos = np.zeros((ncty, nctx), np.int32)
        offs = np.zeros((4, ncty, nctx), np.int64)
        for p in range(32):
            ks = [(p + k) & 31 for k in range(4)]
            dd = sum(bdd[k] for k in ks)
            o = np.stack([bo[k] for k in ks])
            bits = np.abs(o).sum(axis=0) + (o != 0).sum(axis=0) + 5
            c = dd + lam * bits
            better = c < cost
            cost = np.where(better, c, cost)
            pos = np.where(better, p, pos)
            offs = np.where(better[None], o, offs)
        return cost, pos, offs

    c_cb, pos_cb, o_cb = best_window(bo_cb, bd_cb)
    c_cr, pos_cr, o_cr = best_window(bo_cr, bd_cr)
    cost = c_cb + c_cr + lam * 2
    better = cost < best_cost
    for ty, tx in zip(*np.nonzero(better)):
        p_cb[ty, tx] = [1, pos_cb[ty, tx]] + [int(o_cb[k, ty, tx])
                                              for k in range(4)]
        p_cr[ty, tx] = [1, pos_cr[ty, tx]] + [int(o_cr[k, ty, tx])
                                              for k in range(4)]
    return p_cb, p_cr
