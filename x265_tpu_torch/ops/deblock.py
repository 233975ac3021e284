"""HEVC deblocking filter (clause 8.7.2), batched over every edge.

Counterpart of the device deblock of the reference package
(x265_tpu/ops/deblock.py deblock_frame / _luma_filter_batch and the
data-dependent-bs forms deblock_luma_t / deblock_chroma_t of
x265_tpu/enc/pgop_tpu.py). Vertical edges are 8 px apart with a 3-px
reach, so each direction is one tensor sweep over all edges. With
per-CTU QP (dQP) each edge takes the average of its two sides' QPs
(clause 8.7.2.5.3), from a per-8x8-cell map qp8.

The host-recon I path deblocks on the host, edge by edge: the numpy
forms at the end (deblock_frame_np), copies of the reference's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..common.tables import CHROMA_QP_LUT, chroma_qp

# Table 8-12 (derivation of beta' and tc')
BETA_TABLE = np.array(
    [0] * 16 +
    [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
     30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62,
     64], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18 +
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
     6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)


def edge_masks_from_depth(depth8: torch.Tensor, ctu: int):
    """CU-boundary masks on the 8x8 grid: vmask[i, k] marks the vertical
    edge at x = 8k, rows 8i..8i+7 (k > 0); hmask likewise for y = 8i."""
    n8y, n8x = depth8.shape
    dev = depth8.device
    size = ctu >> depth8.to(torch.int32)
    xs = (torch.arange(n8x, device=dev) * 8)[None, :]
    ys = (torch.arange(n8y, device=dev) * 8)[:, None]
    vmask = (xs % size) == 0
    vmask[:, 0] = False
    hmask = (ys % size) == 0
    hmask[0, :] = False
    return vmask, hmask


def _luma_filter_batch(seg: torch.Tensor, active: torch.Tensor,
                       tc: torch.Tensor, beta, maxv: int) -> torch.Tensor:
    """seg: (..., 4, 8) segments [p3..p0|q0..q3] x 4 lines; active:
    (...,) bool; tc: (...,) int; beta int or (...,). Returns filtered
    segments."""
    tc1 = tc[..., None]
    p3, p2, p1, p0 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    q0, q1, q2, q3 = seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]
    dpr = torch.abs(p2 - 2 * p1 + p0)          # (..., 4) per line
    dqr = torch.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = dpr[..., 0], dpr[..., 3]
    dq0, dq3 = dqr[..., 0], dqr[..., 3]
    d0, d3 = dp0 + dq0, dp3 + dq3
    on = ((d0 + d3) < beta) & active
    dp, dq = dp0 + dp3, dq0 + dq3

    def dsam(r):
        return ((2 * (dpr[..., r] + dqr[..., r]) < (beta >> 2)) &
                (torch.abs(p3[..., r] - p0[..., r]) +
                 torch.abs(q0[..., r] - q3[..., r]) < (beta >> 3)) &
                (torch.abs(p0[..., r] - q0[..., r]) < ((5 * tc + 1) >> 1)))

    strong = on & dsam(0) & dsam(3)
    weak = on & ~strong
    c2 = 2 * tc1

    def cl(ref, v):
        return torch.minimum(torch.maximum(v, ref - c2), ref + c2)

    sp0 = cl(p0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = cl(p1, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = cl(p2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = cl(q0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = cl(q1, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = cl(q2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wk_on = weak[..., None] & (torch.abs(delta) < tc1 * 10)
    dcl = torch.minimum(torch.maximum(delta, -tc1), tc1)
    wp0 = torch.clamp(p0 + dcl, 0, maxv)
    wq0 = torch.clamp(q0 - dcl, 0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    pside = wk_on & (dp < side_thr)[..., None]
    qside = wk_on & (dq < side_thr)[..., None]
    th = tc1 >> 1
    dp1v = torch.minimum(torch.maximum(
        (((p2 + p0 + 1) >> 1) - p1 + dcl) >> 1, -th), th)
    dq1v = torch.minimum(torch.maximum(
        (((q2 + q0 + 1) >> 1) - q1 - dcl) >> 1, -th), th)
    wp1 = torch.clamp(p1 + dp1v, 0, maxv)
    wq1 = torch.clamp(q1 + dq1v, 0, maxv)

    st = strong[..., None]
    o_p0 = torch.where(st, sp0, torch.where(wk_on, wp0, p0))
    o_p1 = torch.where(st, sp1, torch.where(pside, wp1, p1))
    o_p2 = torch.where(st, sp2, p2)
    o_q0 = torch.where(st, sq0, torch.where(wk_on, wq0, q0))
    o_q1 = torch.where(st, sq1, torch.where(qside, wq1, q1))
    o_q2 = torch.where(st, sq2, q2)
    return torch.stack([p3, o_p2, o_p1, o_p0, o_q0, o_q1, o_q2, q3], dim=-1)


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    return tuple(torch.as_tensor(t, dtype=torch.int32, device=device)
                 for t in (BETA_TABLE, TC_TABLE, CHROMA_QP_LUT))


def deblock_luma_t(plane: torch.Tensor, vbs: torch.Tensor, hbs: torch.Tensor,
                   qp: int, bit_depth: int = 8,
                   qp8: torch.Tensor | None = None) -> torch.Tensor:
    """Luma deblock of an int32 plane with per-cell boundary strengths
    vbs/hbs (0/1/2) on the 8x8 grid, at one QP, or (qp8, dQP) with the
    per-8x8-cell QP map: each edge's tc and beta then come from the
    average of its two sides' QPs."""
    h, w = plane.shape
    shift = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    if w < 16:
        return plane
    if qp8 is None:
        beta_c = int(BETA_TABLE[min(max(qp, 0), 51)]) << shift
        if beta_c == 0:
            return plane
        tc_by_bs = torch.tensor(
            [0] + [int(TC_TABLE[min(max(qp + 2 * (b - 1), 0), 53)]) << shift
                   for b in (1, 2)], dtype=torch.int32, device=plane.device)
    else:
        beta_t, tc_t, _ = _tables(plane.device)

    def vpass(pl, bs_cells, q8):
        hh, ww = pl.shape
        ne = ww // 8 - 1
        if ne <= 0:
            return pl
        idx = torch.as_tensor(
            np.arange(1, ww // 8)[:, None] * 8 - 4 + np.arange(8)[None, :],
            device=pl.device)                                # (nE, 8)
        g = pl[:, idx]                                       # (H, nE, 8)
        seg = g.reshape(hh // 4, 4, ne, 8).permute(0, 2, 1, 3)
        bs_seg = bs_cells[:, 1:].repeat_interleave(2, 0)[:hh // 4]
        if q8 is None:
            tcs = tc_by_bs[torch.clamp(bs_seg, 0, 2).long()]
            beta = beta_c
        else:
            qe = (q8[:, :-1] + q8[:, 1:] + 1) >> 1     # per-edge avg QP
            qe = qe.repeat_interleave(2, 0)[:hh // 4]
            beta = beta_t[torch.clamp(qe, 0, 51).long()] << shift
            tcs = tc_t[torch.clamp(qe + 2 * (bs_seg - 1), 0, 53).long()] \
                << shift
            tcs = torch.where(bs_seg > 0, tcs, 0)
        out = _luma_filter_batch(seg, bs_seg > 0, tcs, beta, maxv)
        out = out.permute(0, 2, 1, 3).reshape(hh, ne, 8)
        pl = pl.clone()
        pl[:, idx] = out
        return pl

    pl = vpass(plane, vbs, qp8)
    return vpass(pl.T.contiguous(), hbs.T,
                 None if qp8 is None else qp8.T).T.contiguous()


def _chroma_edges(plane: torch.Tensor, vbs: torch.Tensor,
                  hbs: torch.Tensor, tc: int, maxv: int,
                  qp8: torch.Tensor | None = None,
                  bit_depth: int = 8) -> torch.Tensor:
    """Filter the chroma edges whose luma cell has bs == 2: vertical
    edges, then horizontal ones (the transposed pass). With qp8 (the
    luma per-8x8-cell QP map) each edge's tc comes from the chroma QP
    of its two sides' average luma QP; tc is then unused."""

    def vpass(pl, bs_cells, q8):
        hh, ww = pl.shape
        ne = ww // 8 - 1
        if ne <= 0:
            return pl
        idx = torch.as_tensor(
            np.arange(1, ww // 8)[:, None] * 8 - 2 + np.arange(4)[None, :],
            device=pl.device)
        g = pl[:, idx]                                       # (hh, ne, 4)
        p1, p0, q0, q1 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
        # active: luma cell (2y // 8, 2k) has bs == 2
        cells = bs_cells[:, 2::2][:, :ne]
        act = (cells == 2).repeat_interleave(4, 0)[:hh]
        if q8 is None:
            lo, hi = -tc, tc
        else:
            _, tc_t, lut = _tables(pl.device)
            qe = (q8[:, 1::2][:, :ne] + q8[:, 2::2][:, :ne] + 1) >> 1
            qpc = lut[torch.clamp(qe, 0, 57).long()]
            hi = (tc_t[torch.clamp(qpc + 2, 0, 53).long()]
                  << (bit_depth - 8)).repeat_interleave(4, 0)[:hh]
            lo = -hi
        delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, lo, hi)
        np0 = torch.where(act, torch.clamp(p0 + delta, 0, maxv), p0)
        nq0 = torch.where(act, torch.clamp(q0 - delta, 0, maxv), q0)
        cols = torch.arange(1, ww // 8, device=pl.device) * 8
        pl = pl.clone()
        pl[:, cols - 1] = np0
        pl[:, cols] = nq0
        return pl

    pl = vpass(plane, vbs, qp8)
    return vpass(pl.T.contiguous(), hbs.T,
                 None if qp8 is None else qp8.T).T.contiguous()


def _chroma_tc(qp: int, bit_depth: int) -> int:
    qpc = chroma_qp(min(max(qp, 0), 57))
    return int(TC_TABLE[min(max(qpc + 2, 0), 53)]) << (bit_depth - 8)


def deblock_chroma_t(plane: torch.Tensor, vbs: torch.Tensor,
                     hbs: torch.Tensor, qp: int, bit_depth: int = 8,
                     qp8: torch.Tensor | None = None) -> torch.Tensor:
    """P-frame chroma deblock: filters bs == 2 edges only (clause
    8.7.2.5.5, intra boundaries), chroma QP from the luma QP (or, with
    qp8, from each edge's average luma QP). vbs/hbs are LUMA-cell bs
    maps; chroma edges exist where the luma coordinate is a multiple of
    16."""
    h, w = plane.shape            # chroma dims
    if w < 16 or h < 16:
        return plane
    return _chroma_edges(plane, vbs, hbs, _chroma_tc(qp, bit_depth),
                         (1 << bit_depth) - 1, qp8, bit_depth)


def deblock_frame(rec_y: torch.Tensor, rec_cb: torch.Tensor,
                  rec_cr: torch.Tensor, depth8: torch.Tensor, ctu: int,
                  qp: int, bit_depth: int = 8):
    """Intra-frame deblock: bs = 2 on every CU boundary, one QP."""
    vm, hm = edge_masks_from_depth(depth8, ctu)
    vbs = vm.to(torch.int32) * 2
    hbs = hm.to(torch.int32) * 2
    tc = _chroma_tc(qp, bit_depth)
    maxv = (1 << bit_depth) - 1

    def chroma(pl):
        if tc == 0 or pl.shape[1] < 16:
            return pl
        return _chroma_edges(pl, vbs, hbs, tc, maxv)

    return (deblock_luma_t(rec_y, vbs, hbs, qp, bit_depth), chroma(rec_cb),
            chroma(rec_cr))


# =============================================================================
# host (numpy) forms: the host-recon I path
# =============================================================================

def edge_masks_np(depth8: np.ndarray, ctu: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """edge_masks_from_depth on host arrays."""
    n8y, n8x = depth8.shape
    size = (ctu >> depth8).astype(np.int32)   # CU size covering each cell
    xs = (np.arange(n8x) * 8)[None, :]
    ys = (np.arange(n8y) * 8)[:, None]
    vmask = (xs % size) == 0
    vmask[:, 0] = False
    hmask = (ys % size) == 0
    hmask[0, :] = False
    return vmask, hmask


def _luma_edge_np(get, put, tc: int, beta: int, maxv: int) -> None:
    """Filter one 4-line luma edge segment. get(side, line) returns the
    sample [p3..p0 | q0..q3] as ints; put(side, line, v) writes."""
    p = [[get(j, r) for j in range(4)] for r in range(4)]       # p[r][0]=p3
    q = [[get(4 + j, r) for j in range(4)] for r in range(4)]   # q[r][0]=q0
    dp0 = abs(p[0][1] - 2 * p[0][2] + p[0][3])
    dp3 = abs(p[3][1] - 2 * p[3][2] + p[3][3])
    dq0 = abs(q[0][2] - 2 * q[0][1] + q[0][0])
    dq3 = abs(q[3][2] - 2 * q[3][1] + q[3][0])
    d0, d3 = dp0 + dq0, dp3 + dq3
    if d0 + d3 >= beta:
        return
    dp, dq = dp0 + dp3, dq0 + dq3

    def dsam(r):
        return (2 * (abs(p[r][1] - 2 * p[r][2] + p[r][3]) +
                     abs(q[r][2] - 2 * q[r][1] + q[r][0])) < (beta >> 2) and
                abs(p[r][0] - p[r][3]) + abs(q[r][0] - q[r][3]) < (beta >> 3)
                and abs(p[r][3] - q[r][0]) < ((5 * tc + 1) >> 1))

    strong = dsam(0) and dsam(3)
    for r in range(4):
        p3, p2, p1, p0 = p[r]
        q0, q1, q2, q3 = q[r]
        if strong:
            c = 2 * tc
            put(3, r, _c3(p0 - c, p0 + c, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3))
            put(2, r, _c3(p1 - c, p1 + c, (p2 + p1 + p0 + q0 + 2) >> 2))
            put(1, r, _c3(p2 - c, p2 + c, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3))
            put(4, r, _c3(q0 - c, q0 + c, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3))
            put(5, r, _c3(q1 - c, q1 + c, (p0 + q0 + q1 + q2 + 2) >> 2))
            put(6, r, _c3(q2 - c, q2 + c, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3))
        else:
            delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = _c3(-tc, tc, delta)
            put(3, r, _c3(0, maxv, p0 + delta))
            put(4, r, _c3(0, maxv, q0 - delta))
            if dp < ((beta + (beta >> 1)) >> 3):
                dp1 = _c3(-(tc >> 1), tc >> 1,
                          (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
                put(2, r, _c3(0, maxv, p1 + dp1))
            if dq < ((beta + (beta >> 1)) >> 3):
                dq1 = _c3(-(tc >> 1), tc >> 1,
                          (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
                put(5, r, _c3(0, maxv, q1 + dq1))


def _c3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


def _qp8_of(qp, n8y: int, n8x: int) -> np.ndarray:
    """Per-8x8-cell luma QP map from a scalar or (n8y, n8x) array."""
    if np.isscalar(qp) or getattr(qp, "ndim", 0) == 0:
        return np.full((n8y, n8x), int(qp), np.int32)
    q = np.asarray(qp, np.int32)
    assert q.shape == (n8y, n8x), (q.shape, n8y, n8x)
    return q


def deblock_luma_np(plane: np.ndarray, vbs: np.ndarray, hbs: np.ndarray,
                    qp, bit_depth: int = 8) -> np.ndarray:
    """Luma deblock; vbs/hbs: per-cell boundary strength (0/1/2).
    qp: scalar or per-8x8-cell map (dQP: clause 8.7.2.5.3 takes the
    average of the two sides' CU QPs per edge). Returns a filtered
    copy."""
    h, w = plane.shape
    out = plane.astype(np.int64).copy()
    shift = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    qp8 = _qp8_of(qp, h // 8, w // 8)

    def beta_of(qpv):
        return int(BETA_TABLE[min(max(qpv, 0), 51)]) << shift

    def tc_of(qpv, bs):
        return int(TC_TABLE[min(max(qpv + 2 * (bs - 1), 0), 53)]) << shift

    # vertical edges (whole picture) first
    for k in range(1, w // 8):
        x = 8 * k
        for i in range(h // 8):
            if not vbs[i, k]:
                continue
            qpe = (int(qp8[i, k - 1]) + int(qp8[i, k]) + 1) >> 1
            beta = beta_of(qpe)
            if beta == 0:
                continue
            tc = tc_of(qpe, int(vbs[i, k]))
            for seg in range(2):
                y = 8 * i + 4 * seg
                get = lambda c, r: int(out[y + r, x - 4 + c])
                put = lambda c, r, v: out.__setitem__((y + r, x - 4 + c), v)
                _luma_edge_np(get, put, tc, beta, maxv)
    # then horizontal edges
    for i in range(1, h // 8):
        y = 8 * i
        for k in range(w // 8):
            if not hbs[i, k]:
                continue
            qpe = (int(qp8[i - 1, k]) + int(qp8[i, k]) + 1) >> 1
            beta = beta_of(qpe)
            if beta == 0:
                continue
            tc = tc_of(qpe, int(hbs[i, k]))
            for seg in range(2):
                x = 8 * k + 4 * seg
                get = lambda c, r: int(out[y - 4 + c, x + r])
                put = lambda c, r, v: out.__setitem__((y - 4 + c, x + r), v)
                _luma_edge_np(get, put, tc, beta, maxv)
    return out.astype(plane.dtype)


def deblock_chroma_np(plane: np.ndarray, vmask: np.ndarray,
                      hmask: np.ndarray, qp,
                      bit_depth: int = 8) -> np.ndarray:
    """Chroma deblock (bs=2 edges only). vmask/hmask on the LUMA 8-grid;
    chroma edges exist where the luma coordinate is a multiple of 16.
    qp: LUMA qp, scalar or per-luma-8-cell map — the per-edge chroma QP
    is chroma_qp((QpP + QpQ + 1) >> 1) (clause 8.7.2.5.5)."""
    h, w = plane.shape           # chroma dims
    out = plane.astype(np.int64).copy()
    shift = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    n8y, n8x = vmask.shape
    qp8 = _qp8_of(qp, n8y, n8x)

    def tc_of(qpl_p, qpl_q):
        qpc = chroma_qp((qpl_p + qpl_q + 1) >> 1)
        return int(TC_TABLE[min(max(qpc + 2, 0), 53)]) << shift

    def filt(tc, p1, p0, q0, q1):
        delta = _c3(-tc, tc, (((q0 - p0) << 2) + p1 - q1 + 4) >> 3)
        return _c3(0, maxv, p0 + delta), _c3(0, maxv, q0 - delta)

    for k in range(1, w // 8 + (0 if w % 8 else 0)):
        x = 8 * k                # chroma x; luma x = 16k
        if 2 * k >= vmask.shape[1]:
            continue
        for y in range(h):
            cell_y = (2 * y) // 8
            if not vmask[cell_y, 2 * k]:
                continue
            tc = tc_of(int(qp8[cell_y, 2 * k - 1]), int(qp8[cell_y, 2 * k]))
            if tc == 0:
                continue
            p0n, q0n = filt(tc, int(out[y, x - 2]), int(out[y, x - 1]),
                            int(out[y, x]), int(out[y, x + 1]))
            out[y, x - 1] = p0n
            out[y, x] = q0n
    for i in range(1, h // 8 + (0 if h % 8 else 0)):
        y = 8 * i
        if 2 * i >= hmask.shape[0]:
            continue
        for x in range(w):
            cell_x = (2 * x) // 8
            if not hmask[2 * i, cell_x]:
                continue
            tc = tc_of(int(qp8[2 * i - 1, cell_x]), int(qp8[2 * i, cell_x]))
            if tc == 0:
                continue
            p0n, q0n = filt(tc, int(out[y - 2, x]), int(out[y - 1, x]),
                            int(out[y, x]), int(out[y + 1, x]))
            out[y - 1, x] = p0n
            out[y, x] = q0n
    return out.astype(plane.dtype)


def deblock_frame_np(rec_y: np.ndarray, rec_cb: np.ndarray,
                     rec_cr: np.ndarray, depth8: np.ndarray, ctu: int,
                     qp, bit_depth: int = 8):
    """qp: scalar or per-8x8-cell luma QP map (per-CTU dQP expanded)."""
    vm, hm = edge_masks_np(depth8, ctu)
    return (deblock_luma_np(rec_y, vm * 2, hm * 2, qp, bit_depth),
            deblock_chroma_np(rec_cb, vm, hm, qp, bit_depth),
            deblock_chroma_np(rec_cr, vm, hm, qp, bit_depth))
