"""HEVC deblocking filter (clause 8.7.2), batched over every edge.

Counterpart of the device deblock of the reference package
(x265_tpu/ops/deblock.py deblock_frame / _luma_filter_batch and the
data-dependent-bs forms deblock_luma_t / deblock_chroma_t of
x265_tpu/enc/pgop_tpu.py). Vertical edges are 8 px apart with a 3-px
reach, so each direction is one tensor sweep over all edges.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import chroma_qp

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


def deblock_luma_t(plane: torch.Tensor, vbs: torch.Tensor, hbs: torch.Tensor,
                   qp: int, bit_depth: int = 8) -> torch.Tensor:
    """Luma deblock of an int32 plane with per-cell boundary strengths
    vbs/hbs (0/1/2) on the 8x8 grid, at one QP."""
    h, w = plane.shape
    shift = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    if w < 16:
        return plane
    beta = int(BETA_TABLE[min(max(qp, 0), 51)]) << shift
    if beta == 0:
        return plane
    tc_by_bs = torch.tensor(
        [0] + [int(TC_TABLE[min(max(qp + 2 * (b - 1), 0), 53)]) << shift
               for b in (1, 2)], dtype=torch.int32, device=plane.device)

    def vpass(pl, bs_cells):
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
        tcs = tc_by_bs[torch.clamp(bs_seg, 0, 2).long()]
        out = _luma_filter_batch(seg, bs_seg > 0, tcs, beta, maxv)
        out = out.permute(0, 2, 1, 3).reshape(hh, ne, 8)
        pl = pl.clone()
        pl[:, idx] = out
        return pl

    pl = vpass(plane, vbs)
    return vpass(pl.T.contiguous(), hbs.T).T.contiguous()


def _chroma_edges(plane: torch.Tensor, vbs: torch.Tensor,
                  hbs: torch.Tensor, tc: int, maxv: int) -> torch.Tensor:
    """Filter the chroma edges whose luma cell has bs == 2: vertical
    edges, then horizontal ones (the transposed pass)."""

    def vpass(pl, bs_cells):
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
        delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
        np0 = torch.where(act, torch.clamp(p0 + delta, 0, maxv), p0)
        nq0 = torch.where(act, torch.clamp(q0 - delta, 0, maxv), q0)
        cols = torch.arange(1, ww // 8, device=pl.device) * 8
        pl = pl.clone()
        pl[:, cols - 1] = np0
        pl[:, cols] = nq0
        return pl

    pl = vpass(plane, vbs)
    return vpass(pl.T.contiguous(), hbs.T).T.contiguous()


def _chroma_tc(qp: int, bit_depth: int) -> int:
    qpc = chroma_qp(min(max(qp, 0), 57))
    return int(TC_TABLE[min(max(qpc + 2, 0), 53)]) << (bit_depth - 8)


def deblock_chroma_t(plane: torch.Tensor, vbs: torch.Tensor,
                     hbs: torch.Tensor, qp: int,
                     bit_depth: int = 8) -> torch.Tensor:
    """P-frame chroma deblock: filters bs == 2 edges only (clause
    8.7.2.5.5, intra boundaries), chroma QP from the luma QP. vbs/hbs
    are LUMA-cell bs maps; chroma edges exist where the luma coordinate
    is a multiple of 16."""
    h, w = plane.shape            # chroma dims
    if w < 16 or h < 16:
        return plane
    return _chroma_edges(plane, vbs, hbs, _chroma_tc(qp, bit_depth),
                         (1 << bit_depth) - 1)


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
