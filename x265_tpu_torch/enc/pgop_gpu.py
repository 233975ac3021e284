"""P-frame device pipeline: an IPPP chunk frame after frame on the GPU.

Counterpart of x265_tpu/enc/pgop_tpu.py for the main-path options
(single reference, CTU 32, deblock, no SAO, no dQP, sign hiding, RQT
depth 1, weightp, psy-rd, intra-in-inter). The reference expresses the
chain as one lax.scan; here it is a Python loop whose body does, all
on the device: coarse quarter-res search -> windowed ME for every block
of every size (ops/me_win.py, on the window-gather kernel) -> windowed
chroma MC -> intra 8x8 estimate -> MC + transform + quant + recon at
every size with a leaf-RDO depth decision -> intra-in-inter -> in-loop
deblock on the coded crop. submit_pgop_gpu enqueues a chunk and
returns before the device finishes it; collect_pgop_gpu downloads
decision fields, coefficient planes (whole, no compaction) and, on
request, the recon.

Float exactness: RD costs are float32 in the reference's operation
order; python-float constants enter as the reference's weak-typed
float32; integer sums are taken in integers and cast once; 4-child
cost sums follow the reference's sequential order (block_sum_seq).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bitstream.syntax import FramePSyntax
from ..common.bit_calib import calib_for_qp
from ..common.params import EncoderConfig
from ..common.tables import chroma_qp, lambda_from_qp, lambda2_from_qp
from ..device import resolve_device
from ..ops.deblock import deblock_chroma_t, deblock_luma_t
from ..ops.intra import intra_pred_all_modes, intra_pred_single_mode
from ..ops.me import _downsample4, bitlen as _bitlen
from ..ops.me_win import (apply_weight_acc, apply_weight_fullpel,
                          chroma_mc_from_windows, gather_chroma_windows,
                          inverse_weight_plane, me_all_sizes, pad_ref,
                          seed_floor_off)
from ..ops.satd import sa8d_batch, sa8d_nxn_lanes
from ..ops.transforms import (dct_batch, dct_lanes, dequant_batch,
                              dequant_lanes, idct_batch, idct_lanes,
                              quant_batch, quant_lanes, sign_hide_batch,
                              sign_hide_lanes)
from .intra_analysis import _MODE_BITS, block_sum_seq, edge_pad, up as _up
from .intra_recon import DeviceRef, ReconFrame
from .intra_recon_gpu import _scan_sel, _substitute

SIZES = (8, 16, 32)
F32 = torch.float32


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar on the device (the reference's jnp.float32)."""
    return torch.tensor(x, dtype=F32, device=device)


# =============================================================================
# motion estimation seeds
# =============================================================================

def _coarse_search_rolled(cur4: torch.Tensor, ref4: torch.Tensor,
                          radius: int = 8, blk: int = 4,
                          lam_pen: int = 2):
    """Full search on 1/4-res planes, one step per dy row over all 2r+1
    dx shifts; raster (dy, dx) order with strict < (first minimum
    wins). lam_pen scales the |mv| penalty. Returns (mv (by, bx, 2)
    in quarter-res pels, cost)."""
    h, w = cur4.shape
    dev = cur4.device
    hh, ww = h // blk * blk, w // blk * blk
    cur = cur4[:hh, :ww].to(torch.int16)
    by, bx = hh // blk, ww // blk
    side = 2 * radius + 1
    yi = torch.clamp(torch.arange(-radius, h + radius, device=dev), 0,
                     h - 1)
    xi = torch.clamp(torch.arange(-radius, w + radius, device=dev), 0,
                     w - 1)
    pad = ref4.to(torch.int16)[yi[:, None], xi[None, :]]
    dxpen = torch.abs(torch.arange(side, device=dev) - radius)
    best_cost = torch.full((by, bx), 1 << 30, dtype=torch.int32, device=dev)
    best_i = torch.zeros((by, bx), dtype=torch.int32, device=dev)
    for iy in range(side):
        rows = pad[iy:iy + h]
        cands = torch.stack([rows[:, dx:dx + w][:hh, :ww]
                             for dx in range(side)])     # (side, hh, ww)
        ad = torch.abs(cur[None] - cands)
        sad = ad.reshape(side, by, blk, bx, blk).sum((2, 4),
                                                     dtype=torch.int32)
        mvpen = lam_pen * (dxpen + abs(iy - radius))
        cost = sad + mvpen[:, None, None].to(torch.int32)
        mc = torch.amin(cost, 0)
        mi = torch.argmin(cost, 0).to(torch.int32)
        better = mc < best_cost
        best_i = torch.where(better, iy * side + mi, best_i)
        best_cost = torch.where(better, mc, best_cost)
    oy = torch.div(best_i, side, rounding_mode="floor")
    mv = torch.stack([best_i - oy * side - radius, oy - radius], dim=-1)
    return mv.to(torch.int32), best_cost


def _median3_mv(mv: torch.Tensor) -> torch.Tensor:
    """3x3 per-component median of a (by, bx, 2) MV field."""
    by, bx, _ = mv.shape
    yi = torch.clamp(torch.arange(-1, by + 1, device=mv.device), 0, by - 1)
    xi = torch.clamp(torch.arange(-1, bx + 1, device=mv.device), 0, bx - 1)
    p = mv[yi[:, None], xi[None, :]]
    stk = torch.stack([p[dy:dy + by, dx:dx + bx]
                       for dy in range(3) for dx in range(3)])
    return torch.sort(stk, dim=0).values[4]


# =============================================================================
# windowed chroma predictions for every CU size
# =============================================================================

def _chroma_preds_windowed(cpad2, pc, refcb, refcr, mvs, seeds, radius,
                           h, w, bit_depth, wvec=None,
                           weight_denom: int = 6):
    """cpad2: (2, Hc+2pc, Wc+2pc) stacked padded uint8 chroma refs;
    mvs: {n: (B, 2) qpel}; seeds: {16: (sx, sy), 32: (sx, sy)} clamped
    full-pel seeds. MVs from the windowed search lie within seed +-
    radius (qpel +-3/4); zero-MV winners take the co-located blocks.
    wvec: explicit weights, cb from wvec[2:4], cr from wvec[4:6].
    Returns {n: (pred_cb, pred_cr) (B, cn, cn)}."""
    weighted = wvec is not None
    dev = refcb.device
    r = radius

    def grid(n, step):
        by, bx = h // n, w // n
        ys = torch.arange(by, dtype=torch.int32, device=dev) * step
        xs = torch.arange(bx, dtype=torch.int32, device=dev) * step
        return ys.repeat_interleave(bx), xs.repeat(by)

    by16, bx16 = h // 16, w // 16
    yc16, xc16 = grid(16, 8)
    sx16, sy16 = seeds[16]
    s0x16 = seed_floor_off(sx16, r)
    s0y16 = seed_floor_off(sy16, r)
    wc16 = r + 12
    win16 = gather_chroma_windows(cpad2, pc, yc16, xc16, s0y16, s0x16, wc16)

    def zero_blocks(plane, cn):
        cy, cx = plane.shape
        return plane.reshape(cy // cn, cn, cx // cn, cn) \
            .permute(0, 2, 1, 3).reshape(-1, cn, cn).to(torch.int32)

    out = {}
    for n, cn in ((8, 4), (16, 8), (32, 16)):
        mv = mvs[n]
        if n == 32:
            yc32, xc32 = grid(32, 16)
            sx32, sy32 = seeds[32]
            s0xe = seed_floor_off(sx32, r)
            s0ye = seed_floor_off(sy32, r)
            nshift = r + 2
            win_b = gather_chroma_windows(cpad2, pc, yc32, xc32, s0ye, s0xe,
                                          r + 20)
            rel_y = rel_x = 0
        elif n == 16:
            # rel == 0: offsets span only r+2 shifts
            win_b, nshift = win16, r + 2
            s0ye, s0xe = s0y16, s0x16
            rel_y = rel_x = 0
        else:
            # the 2x2 sub-blocks of each 16-region share its window
            by8, bx8 = h // 8, w // 8
            parent = (torch.arange(by8, device=dev) // 2)[:, None] * bx16 + \
                (torch.arange(bx8, device=dev) // 2)[None, :]
            parent = parent.reshape(-1)
            win_b, nshift = win16[parent], r + 6
            s0ye, s0xe = s0y16[parent], s0x16[parent]
            rel_y = ((torch.arange(by8, dtype=torch.int32, device=dev) % 2)
                     .repeat_interleave(bx8)) * 4
            rel_x = ((torch.arange(bx8, dtype=torch.int32, device=dev) % 2)
                     .repeat(by8)) * 4
        zero = (mv[:, 0] == 0) & (mv[:, 1] == 0)
        offy = torch.clamp(rel_y + (mv[:, 1] >> 3) - 1 - s0ye, 0, nshift - 1)
        offx = torch.clamp(rel_x + (mv[:, 0] >> 3) - 1 - s0xe, 0, nshift - 1)
        pcb, pcr = chroma_mc_from_windows(
            win_b, offy, offx, mv[:, 0] & 7, mv[:, 1] & 7, cn, nshift,
            bit_depth, raw=weighted)
        zcb = zero_blocks(refcb, cn)
        zcr = zero_blocks(refcr, cn)
        if weighted:
            pcb = apply_weight_acc(pcb, wvec[2], wvec[3], weight_denom,
                                   bit_depth)
            pcr = apply_weight_acc(pcr, wvec[4], wvec[5], weight_denom,
                                   bit_depth)
            zcb = apply_weight_fullpel(zcb, wvec[2], wvec[3], weight_denom,
                                       bit_depth)
            zcr = apply_weight_fullpel(zcr, wvec[4], wvec[5], weight_denom,
                                       bit_depth)
        zm = zero[:, None, None]
        out[n] = (torch.where(zm, zcb, pcb), torch.where(zm, zcr, pcr))
    return out


# =============================================================================
# leaf-RDO depth decision: true recon SSE + estimated bits
# =============================================================================

def _mvd_bits_est(mv_field: torch.Tensor) -> torch.Tensor:
    """Per-block MVD signalling estimate (bits), left neighbour as the
    predictor proxy. mv_field: (by, bx, 2). The reference's float32
    2*ceil(log2((a-1)/2 + 1)) + 2 equals 2*bitlen(a) for 1 < a < 2^20."""
    pred = torch.roll(mv_field, 1, dims=1)
    pred[:, 0] = 0
    d = mv_field - pred

    def comp(v):
        a = torch.abs(v)
        big = torch.where(a > 1, 2 * _bitlen(a), 0)
        return 1.0 + torch.where(a > 0, 2 + big, 0).to(F32)

    return comp(d[..., 0]) + comp(d[..., 1])


def _coeff_bits_est(cf: torch.Tensor, by: int, bx: int, k: int,
                    calib) -> torch.Tensor:
    """Coefficient-bits proxy per k x k block: per-nnz + per-bitlen +
    per-coded-block bits (common/bit_calib.py)."""
    a = torch.abs(cf[:by * k, :bx * k])
    nnz = (a > 0).reshape(by, k, bx, k).sum((1, 3)).to(F32)
    slog = _bitlen(a).reshape(by, k, bx, k).sum((1, 3)).to(F32)
    return torch.where(nnz > 0, calib[0] * nnz + calib[1] * slog + calib[2],
                       0.0)


def _rd_depth_decision(sse: dict, bits: dict, mvs: dict, lam2: float,
                       real_h: int, real_w: int, h: int, w: int,
                       hdr_bits: float, split_bits: float, alt8_cost=None):
    """Bottom-up split-vs-keep argmin over true RD costs. Returns depth8
    (n8y, n8x), mv8 (n8y, n8x, 2), intra_pref (n8y, n8x) and the 8x8
    inter leaf cost. CUs over the coded edge are forced to split.
    alt8_cost: RD cost of the 8x8 INTRA candidate per min-cell; where
    it beats the inter leaf it replaces the 8-level cost."""
    dev = sse[8].device
    big = 1e18
    cost = {}
    intra_pref = None
    for n in SIZES:
        by, bx = h // n, w // n
        c = sse[n] + lam2 * (bits[n] + hdr_bits)
        if n == 8 and alt8_cost is not None:
            intra_pref = alt8_cost < c
            c = torch.minimum(c, alt8_cost)
        ys = torch.arange(by, device=dev)[:, None]
        xs = torch.arange(bx, device=dev)[None, :]
        over = ((ys + 1) * n > real_h) | ((xs + 1) * n > real_w)
        cost[n] = torch.where(over, _f32(big, dev), c)
    split_cost = float(lam2 * split_bits)          # python double, as ref
    agg = torch.where(cost[8] >= big, 0.0, cost[8])
    ch16 = block_sum_seq(agg, h // 16, 2, w // 16) + split_cost
    keep16 = cost[16] <= ch16
    agg16 = torch.where(keep16, cost[16], ch16)
    agg16 = torch.where(agg16 >= big, 0.0, agg16)
    ch32 = block_sum_seq(agg16, h // 32, 2, w // 32) + split_cost
    keep32 = cost[32] <= ch32

    n8y, n8x = h // 8, w // 8
    k32 = _up(keep32, 4)[:n8y, :n8x]
    k16 = _up(keep16, 2)[:n8y, :n8x]
    depth8 = torch.where(k32, 0, torch.where(k16, 1, 2)).to(torch.int32)

    def up_mv(n, k):
        return _up(mvs[n].reshape(h // n, w // n, 2), k)[:n8y, :n8x]

    mv8 = torch.where(k32[..., None], up_mv(32, 4),
                      torch.where(k16[..., None], up_mv(16, 2), up_mv(8, 1)))
    if intra_pref is None:
        intra_pref = torch.zeros((n8y, n8x), dtype=torch.bool, device=dev)
    inter_c8 = sse[8] + lam2 * (bits[8] + hdr_bits)
    return depth8, mv8.to(torch.int32), intra_pref[:n8y, :n8x], inter_c8


# =============================================================================
# dense MC reconstruction
# =============================================================================

def _psy8_energy(plane: torch.Tensor) -> torch.Tensor:
    """Per-8x8 AC energy: SA8D with the DC term removed (x265
    rdcost.h:30 psy_cost_pp)."""
    h, w = plane.shape
    by, bx = h // 8, w // 8
    b = plane.reshape(by, 8, bx, 8).to(torch.int32)
    lanes = b.permute(1, 3, 0, 2).reshape(8, 8, by * bx)
    sa = sa8d_nxn_lanes(lanes, 8)
    dc = torch.abs(b.sum((1, 3), dtype=torch.int32)).reshape(-1) >> 2
    return (sa - dc).to(F32).reshape(by, bx)


def _lanes_of_plane(plane, nn):
    bby, bbx = plane.shape[0] // nn, plane.shape[1] // nn
    return plane.reshape(bby, nn, bbx, nn).permute(1, 3, 0, 2) \
        .reshape(nn, nn, -1).to(torch.int32)


def _to_plane(lanes, nn, hh, ww):
    bby, bbx = hh // nn, ww // nn
    return lanes.reshape(nn, nn, bby, bbx).permute(2, 0, 3, 1) \
        .reshape(hh, ww)


def _blk_sse(rec, orig, by, bx, k):
    """Per k x k block SSE as float32 (integer sum, cast once)."""
    d = (rec - orig)[:by * k, :bx * k].to(torch.int64)
    return (d * d).reshape(by, k, bx, k).sum((1, 3)).to(F32)


def _mc_recon_all(oy, ocb, ocr, mvs, lam2, qp, qpc, bit_depth,
                  sign_hiding, real_h, real_w, preds, cpreds,
                  psy_rd=0.0, rqt=False, alt8_cost=None):
    """MC + residual coding at EVERY CU size with that size's own MV
    field (predictions from the windowed ME), leaf-RDO depth decision
    from the true recon SSE + estimated bits, then compose by depth.
    RQT: 16/32 CUs may code four half-size TUs on the same prediction.
    Returns (rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr, depth8, mv8,
    tusplit8, intra_pref, inter_c8)."""
    dev = oy.device
    calib = calib_for_qp(qp)
    cal3 = calib[:3]
    m_scale = float(calib[5])
    h, w = oy.shape
    maxv = (1 << bit_depth) - 1

    def one_plane(orig, nn, qqp, pred):
        """Residual pipeline in lanes layout (nn, nn, B)."""
        resi = _lanes_of_plane(orig, nn) - pred
        tcoef = dct_lanes(resi, nn, bit_depth)
        if sign_hiding:
            coefs, du = quant_lanes(tcoef, nn, qqp, bit_depth, intra=False,
                                    with_rem=True)
            coefs = sign_hide_lanes(coefs, nn, 0, du)  # inter: diag scan
        else:
            coefs = quant_lanes(tcoef, nn, qqp, bit_depth, intra=False)
        cbf = (coefs != 0).any(dim=0).any(dim=0)
        r = idct_lanes(dequant_lanes(coefs, nn, qqp, bit_depth), nn,
                       bit_depth)
        rec = torch.where(cbf[None, None, :],
                          torch.clamp(pred + r, 0, maxv), pred)
        return rec, torch.where(cbf[None, None, :], coefs, 0)

    planes, sse, bits, tusplit = {}, {}, {}, {}
    for n in SIZES:
        by, bx = h // n, w // n
        grid = mvs[n].reshape(by, bx, 2)
        cn = n >> 1

        def lan(p):
            return p.permute(1, 2, 0)

        rec_y, cf_y = one_plane(oy, n, qp, lan(preds[n]))
        rec_cb, cf_cb = one_plane(ocb, cn, qpc, lan(cpreds[n][0]))
        rec_cr, cf_cr = one_plane(ocr, cn, qpc, lan(cpreds[n][1]))
        planes[n] = (_to_plane(rec_y, n, h, w), _to_plane(cf_y, n, h, w),
                     _to_plane(rec_cb, cn, h // 2, w // 2),
                     _to_plane(cf_cb, cn, h // 2, w // 2),
                     _to_plane(rec_cr, cn, h // 2, w // 2),
                     _to_plane(cf_cr, cn, h // 2, w // 2))
        pl = planes[n]
        sse[n] = _blk_sse(pl[0], oy, by, bx, n) + \
            _blk_sse(pl[2], ocb, by, bx, cn) + \
            _blk_sse(pl[4], ocr, by, bx, cn)
        mvd = m_scale * _mvd_bits_est(grid)
        bits[n] = mvd + _coeff_bits_est(pl[1], by, bx, n, cal3) + \
            _coeff_bits_est(pl[3], by, bx, cn, cal3) + \
            _coeff_bits_est(pl[5], by, bx, cn, cal3)

        # RQT: TU-split candidate (four (n/2)^2 luma TUs + four (n/4)^2
        # chroma TUs on the SAME prediction), chosen per CU by RD
        if rqt and n >= 16:
            n2, n4 = n >> 1, n >> 2
            py_pl = _to_plane(lan(preds[n]), n, h, w)
            pcb_pl = _to_plane(lan(cpreds[n][0]), cn, h // 2, w // 2)
            pcr_pl = _to_plane(lan(cpreds[n][1]), cn, h // 2, w // 2)
            ry_s, cfy_s = one_plane(oy, n2, qp, _lanes_of_plane(py_pl, n2))
            rcb_s, cfcb_s = one_plane(ocb, n4, qpc,
                                      _lanes_of_plane(pcb_pl, n4))
            rcr_s, cfcr_s = one_plane(ocr, n4, qpc,
                                      _lanes_of_plane(pcr_pl, n4))
            pl_s = (_to_plane(ry_s, n2, h, w), _to_plane(cfy_s, n2, h, w),
                    _to_plane(rcb_s, n4, h // 2, w // 2),
                    _to_plane(cfcb_s, n4, h // 2, w // 2),
                    _to_plane(rcr_s, n4, h // 2, w // 2),
                    _to_plane(cfcr_s, n4, h // 2, w // 2))
            sse_s = _blk_sse(pl_s[0], oy, by, bx, n) + \
                _blk_sse(pl_s[2], ocb, by, bx, cn) + \
                _blk_sse(pl_s[4], ocr, by, bx, cn)

            def up2(a):
                return block_sum_seq(a, by, 2, bx)

            bits_s = mvd + \
                up2(_coeff_bits_est(pl_s[1], h // n2, w // n2, n2, cal3)) + \
                up2(_coeff_bits_est(pl_s[3], h // n2, w // n2, n4, cal3)) + \
                up2(_coeff_bits_est(pl_s[5], h // n2, w // n2, n4, cal3)) + \
                3.0
            sp = (sse_s + lam2 * bits_s) < (sse[n] + lam2 * bits[n])
            tusplit[n] = sp
            sse[n] = torch.where(sp, sse_s, sse[n])
            bits[n] = torch.where(sp, bits_s, bits[n])
            my = _up(sp, n)
            mc = _up(sp, cn)
            planes[n] = tuple(
                torch.where(my if i < 2 else mc, pl_s[i], planes[n][i])
                for i in range(6))

    if psy_rd > 0:
        # psy-rd (x265 rdcost.h:30): distortion += lambda * psyRd * |dE|
        # over 8x8 cells of luma
        lam = torch.sqrt(_f32(lam2, dev))
        scale = _f32(psy_rd, dev) * lam
        e_src = _psy8_energy(oy)
        for n in SIZES:
            de = torch.abs(e_src - _psy8_energy(planes[n][0]))
            k = n // 8
            psy_n = de.reshape(h // n, k, w // n, k).sum((1, 3))
            sse[n] = sse[n] + scale * psy_n

    depth8, mv8, intra_pref, inter_c8 = _rd_depth_decision(
        sse, bits, mvs, lam2, real_h, real_w, h, w,
        hdr_bits=float(calib[3]), split_bits=float(calib[4]),
        alt8_cost=alt8_cost)

    n8y, n8x = h // 8, w // 8
    zb = torch.zeros((n8y, n8x), dtype=torch.bool, device=dev)
    ts32 = _up(tusplit[32], 4)[:n8y, :n8x] if 32 in tusplit else zb
    ts16 = _up(tusplit[16], 2)[:n8y, :n8x] if 16 in tusplit else zb
    tusplit8 = torch.where(depth8 == 0, ts32,
                           torch.where(depth8 == 1, ts16, zb))

    out = [torch.zeros_like(p) for p in planes[8]]
    for d, n in ((0, 32), (1, 16), (2, 8)):
        m8 = depth8 == d
        mpx = _up(m8, 8)
        mpx_c = _up(m8, 4)
        for i, p in enumerate(planes[n]):
            out[i] = torch.where(mpx if i < 2 else mpx_c, p, out[i])
    return out + [depth8, mv8, tusplit8, intra_pref, inter_c8]


# =============================================================================
# intra-in-inter: 8x8 intra CU candidates for P frames
# =============================================================================

def _strided_refs8(rec: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical intra refs for every aligned n x n block of the plane:
    (B, 4n+1) int32 in [L[2n-1]..L[0], corner, T[0..2n-1]] order.
    Out-of-picture entries are garbage; the availability mask covers
    them."""
    h, w = rec.shape
    by, bx = h // n, w // n
    r = torch.zeros((h + 1 + 2 * n, w + 1 + 2 * n), dtype=rec.dtype,
                    device=rec.device)
    r[1:1 + h, 1:1 + w] = rec
    tr = r[0::n, :][:by]                         # (by, w+1+2n)
    t0 = tr[:, 1:1 + w].reshape(by, bx, n)
    t1 = tr[:, 1 + n:1 + n + w].reshape(by, bx, n)
    top = torch.cat([t0, t1], dim=2)             # T[0..2n-1]
    corner = tr[:, 0::n][:, :bx]                 # (by, bx)
    lc = r[1:, 0::n][:, :bx]                     # (h+2n, bx)
    l0 = lc[:by * n].reshape(by, n, bx)
    l1 = lc[n:by * n + n].reshape(by, n, bx)
    left = torch.cat([l0, l1], dim=1)            # (by, 2n, bx) L[0..2n-1]
    left = torch.flip(left.permute(0, 2, 1), dims=[2])   # L[2n-1]..L[0]
    refs = torch.cat([left.reshape(by * bx, 2 * n),
                      corner.reshape(by * bx, 1),
                      top.reshape(by * bx, 2 * n)], dim=1)
    return refs.to(torch.int32)


def _z_of(x: np.ndarray, y: np.ndarray, log2_ctu: int,
          cell_shift: int = 3) -> np.ndarray:
    """z-scan index of the min-cell containing (x, y) within its CTU."""
    bx = (x & ((1 << log2_ctu) - 1)) >> cell_shift
    by = (y & ((1 << log2_ctu) - 1)) >> cell_shift
    z = np.zeros(np.broadcast_shapes(np.shape(bx), np.shape(by)), np.int64)
    for b in range(log2_ctu - cell_shift):
        z = z | (((bx >> b) & 1) << (2 * b))
        z = z | (((by >> b) & 1) << (2 * b + 1))
    return z


@lru_cache(maxsize=None)
def _avail_refs_np(n: int, ctu: int, by: int, bx: int, real_h: int,
                   real_w: int, cell_shift: int = 3) -> np.ndarray:
    """(B, 4n+1) decode-order availability (clause 6.4.1 z-scan) and
    picture-border mask for every aligned n-block of the plane."""
    log2_ctu = ctu.bit_length() - 1
    k = 4 * n + 1
    rx = np.zeros(k, np.int32)
    ry = np.zeros(k, np.int32)
    for i in range(k):
        if i < 2 * n:
            rx[i], ry[i] = -1, 2 * n - 1 - i
        elif i == 2 * n:
            rx[i], ry[i] = -1, -1
        else:
            rx[i], ry[i] = i - 2 * n - 1, -1
    x0 = (np.arange(bx) * n)[None, :, None]
    y0 = (np.arange(by) * n)[:, None, None]
    gx = x0 + rx[None, None, :]
    gy = y0 + ry[None, None, :]
    border = (gx >= 0) & (gy >= 0) & (gx < real_w) & (gy < real_h)
    tr = gy >> log2_ctu
    tc = np.maximum(gx, 0) >> log2_ctu
    cr = y0 >> log2_ctu
    cc = x0 >> log2_ctu
    earlier = (tr < cr) | ((tr == cr) & (tc < cc))
    same = (tr == cr) & (tc == cc)
    zref = _z_of(np.maximum(gx, 0), np.maximum(gy, 0), log2_ctu, cell_shift)
    zblk = _z_of(x0 + 0 * gx, y0 + 0 * gy, log2_ctu, cell_shift)
    zok = earlier | (same & (zref < zblk))
    return (zok & border).reshape(by * bx, k)


@lru_cache(maxsize=None)
def _avail_refs(n, ctu, by, bx, real_h, real_w, device, cell_shift=3):
    """_avail_refs_np on the device, uploaded once per geometry."""
    return torch.as_tensor(_avail_refs_np(n, ctu, by, bx, real_h, real_w,
                                          cell_shift), device=device)


def _intra_tu_batch(orig_blocks, pred, n, qp, bit_depth, sign_hiding,
                    modes):
    """Intra TU pipeline for (B, n, n) blocks (DCT; 8x8 luma and 4x4
    chroma): returns (recon, coefs)."""
    maxv = (1 << bit_depth) - 1
    tc = dct_batch(orig_blocks - pred, n, bit_depth)
    if sign_hiding:
        coefs, du = quant_batch(tc, n, qp, bit_depth, intra=True,
                                with_rem=True)
        coefs = sign_hide_batch(coefs, n, _scan_sel(modes) if n <= 8 else 0,
                                du)
    else:
        coefs = quant_batch(tc, n, qp, bit_depth, intra=True)
    cbf = (coefs != 0).any(dim=2).any(dim=1)
    r = idct_batch(dequant_batch(coefs, n, qp, bit_depth), n, bit_depth)
    rec = torch.where(cbf[:, None, None], torch.clamp(pred + r, 0, maxv),
                      pred)
    return rec, torch.where(cbf[:, None, None], coefs, 0)


def _blocks_of(plane, nn):
    hh, ww = plane.shape
    return plane.reshape(hh // nn, nn, ww // nn, nn).permute(0, 2, 1, 3) \
        .reshape(-1, nn, nn).to(torch.int32)


def _psy8_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """AC energy (SA8D minus DC) per (B, 8, 8) block."""
    sa = sa8d_batch(blocks)
    dc = torch.abs(blocks.sum((1, 2), dtype=torch.int32)) >> 2
    return (sa - dc).to(F32)


def _cbits_of(cf, calib):
    a = torch.abs(cf)
    nnz = (a > 0).sum((1, 2)).to(F32)
    slog = _bitlen(a).sum((1, 2)).to(F32)
    return torch.where(nnz > 0, calib[0] * nnz + calib[1] * slog + calib[2],
                       0.0)


def _sse_blocks(rec, orig):
    d = (rec - orig).to(torch.int64)
    return (d * d).sum((1, 2)).to(F32)


@lru_cache(maxsize=None)
def _mode_tables(device: torch.device):
    bits_f = torch.as_tensor(_MODE_BITS.astype(np.float32), device=device)
    lam_bits = torch.as_tensor(
        np.round(np.asarray(_MODE_BITS, np.float64)).astype(np.int32),
        device=device)
    return bits_f, lam_bits


def _intra8_est(oy, ocb, ocr, lam, lam2, qp, qpc, ctu, real_h, real_w,
                bit_depth, sign_hiding, calib, psy_rd: float = 0.0):
    """Orig-reference RD estimate of an 8x8 intra CU at every min-CU
    cell: SA8D over all 35 modes picks the mode, one actual TQ recon
    (luma 8x8 + chroma 4x4 at DM) prices it as SSE + lambda2 * bits.
    Returns (mode (B,) int32, cost8 (by, bx) float32)."""
    dev = oy.device
    h, w = oy.shape
    by, bx = h // 8, w // 8
    mode_bits_f, lam_bits = _mode_tables(dev)
    avail = _avail_refs(8, ctu, by, bx, real_h, real_w, dev)
    refs = _substitute(_strided_refs8(oy, 8), avail, bit_depth)
    preds = intra_pred_all_modes(refs, 8, is_luma=True,
                                 bit_depth=bit_depth)    # (B, 35, 8, 8)
    ob = _blocks_of(oy, 8)
    costs = sa8d_batch(ob[:, None] - preds) + lam * lam_bits[None, :]
    mode = torch.argmin(costs, dim=1).to(torch.int32)
    pred = torch.gather(preds, 1, mode.long()[:, None, None, None]
                        .expand(-1, 1, 8, 8))[:, 0]
    rec8, cf8 = _intra_tu_batch(ob, pred, 8, qp, bit_depth, sign_hiding,
                                mode)
    sse = _sse_blocks(rec8, ob)
    if psy_rd > 0:
        scale = _f32(psy_rd, dev) * torch.sqrt(_f32(lam2, dev))
        sse = sse + scale * torch.abs(_psy8_blocks(ob) - _psy8_blocks(rec8))
    bits = _cbits_of(cf8, calib) + mode_bits_f[mode.long()] + 4.0

    # chroma 4x4 at DM from orig refs
    cavail = _avail_refs(4, ctu // 2, by, bx, real_h // 2, real_w // 2, dev,
                         cell_shift=2)
    for opl in (ocb, ocr):
        cr = _substitute(_strided_refs8(opl, 4), cavail, bit_depth)
        cpred = intra_pred_single_mode(cr, mode, 4, is_luma=False,
                                       bit_depth=bit_depth)
        ocx = _blocks_of(opl, 4)
        crec, ccf = _intra_tu_batch(ocx, cpred, 4, qpc, bit_depth,
                                    sign_hiding, mode)
        sse = sse + _sse_blocks(crec, ocx)
        bits = bits + _cbits_of(ccf, calib)
    return mode, (sse + lam2 * bits).reshape(by, bx)


def _neighbours(a: torch.Tensor):
    """The 8 neighbour views of a bool map padded with False:
    dict (dy, dx) -> (by, bx)."""
    p = torch.zeros((a.shape[0] + 2, a.shape[1] + 2), dtype=torch.bool,
                    device=a.device)
    p[1:-1, 1:-1] = a
    by, bx = a.shape
    return {(dy, dx): p[1 + dy:1 + dy + by, 1 + dx:1 + dx + bx]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx}


def _parity_accept(a0: torch.Tensor) -> torch.Tensor:
    """Greedy 4-phase parity independent set over candidate map a0: no
    two accepted cells are 8-adjacent."""
    by, bx = a0.shape
    yy = torch.arange(by, device=a0.device)[:, None] % 2
    xx = torch.arange(bx, device=a0.device)[None, :] % 2
    acc = torch.zeros_like(a0)
    for py in (0, 1):
        for px in (0, 1):
            nb = _neighbours(acc)
            nbr = torch.zeros_like(a0)
            for v in nb.values():
                nbr = nbr | v
            acc = acc | (a0 & (yy == py) & (xx == px) & ~nbr)
    return acc


def _intra_in_inter(oy, ocb, ocr, rec_y, rec_cb, rec_cr, cf_y, cf_cb,
                    cf_cr, depth8, accept_pref, mode_est, qp, qpc, ctu,
                    real_h, real_w, bit_depth, sign_hiding, rounds=2,
                    lam2=None, inter_c8=None, calib=(1.4, 1.2, 5.0),
                    psy_rd: float = 0.0):
    """Code 8x8 intra CUs at the cells the RD depth decision chose for
    intra, in `rounds` parity-independent waves, each predicting from
    reconstruction that is final; each wave's blocks are kept only
    where their actual coded RD beats the inter content they replace.
    Returns updated planes + (intra8, mode8)."""
    dev = oy.device
    h, w = rec_y.shape
    by, bx = h // 8, w // 8
    mind = ctu.bit_length() - 4      # depth of 8x8 CUs
    cand = accept_pref & (depth8 == mind)
    avail = _avail_refs(8, ctu, by, bx, real_h, real_w, dev)
    cavail = _avail_refs(4, ctu // 2, by, bx, real_h // 2, real_w // 2,
                         dev, cell_shift=2)
    ob = _blocks_of(oy, 8)
    ocb_b = _blocks_of(ocb, 4)
    ocr_b = _blocks_of(ocr, 4)

    def compose(plane, blocks, nn, mask8):
        hh, ww = plane.shape
        bp = blocks.reshape(hh // nn, ww // nn, nn, nn).permute(0, 2, 1, 3) \
            .reshape(hh, ww)
        return torch.where(_up(mask8, nn), bp, plane)

    mode_bits_f, _ = _mode_tables(dev)
    intra8 = torch.zeros((by, bx), dtype=torch.bool, device=dev)
    for rnd in range(rounds):
        c = cand & ~intra8
        if rnd > 0:
            # a later acceptance must not sit in the reference support
            # of an already-coded intra block (its E/NE/SE/S/SW
            # neighbours)
            nb = _neighbours(intra8)
            bad = nb[(0, 1)] | nb[(-1, 1)] | nb[(1, 1)] | nb[(1, 0)] | \
                nb[(1, -1)]
            c = c & ~bad
        acc = _parity_accept(c)
        refs = _substitute(_strided_refs8(rec_y, 8), avail, bit_depth)
        pred = intra_pred_single_mode(refs, mode_est, 8, is_luma=True,
                                      bit_depth=bit_depth)
        rec8, cf8 = _intra_tu_batch(ob, pred, 8, qp, bit_depth, sign_hiding,
                                    mode_est)
        crecs, ccfs = [], []
        for opl_b, rpl in ((ocb_b, rec_cb), (ocr_b, rec_cr)):
            cr = _substitute(_strided_refs8(rpl, 4), cavail, bit_depth)
            cpred = intra_pred_single_mode(cr, mode_est, 4, is_luma=False,
                                           bit_depth=bit_depth)
            crec, ccf = _intra_tu_batch(opl_b, cpred, 4, qpc, bit_depth,
                                        sign_hiding, mode_est)
            crecs.append(crec)
            ccfs.append(ccf)
        if inter_c8 is not None:
            sse_a = _sse_blocks(rec8, ob)
            if psy_rd > 0:
                scale = _f32(psy_rd, dev) * torch.sqrt(_f32(lam2, dev))
                sse_a = sse_a + scale * torch.abs(_psy8_blocks(ob) -
                                                  _psy8_blocks(rec8))
            bits_a = mode_bits_f[mode_est.long()] + 4.0
            bits_a = bits_a + _cbits_of(cf8, calib)
            for crec_w, ccf_w, ob_w in ((crecs[0], ccfs[0], ocb_b),
                                        (crecs[1], ccfs[1], ocr_b)):
                sse_a = sse_a + _sse_blocks(crec_w, ob_w)
                bits_a = bits_a + _cbits_of(ccf_w, calib)
            cost_a = (sse_a + lam2 * bits_a).reshape(by, bx)
            acc = acc & (cost_a < inter_c8)
        rec_y = compose(rec_y, rec8, 8, acc)
        cf_y = compose(cf_y, cf8, 8, acc)
        rec_cb = compose(rec_cb, crecs[0], 4, acc)
        cf_cb = compose(cf_cb, ccfs[0], 4, acc)
        rec_cr = compose(rec_cr, crecs[1], 4, acc)
        cf_cr = compose(cf_cr, ccfs[1], 4, acc)
        intra8 = intra8 | acc

    mode8 = torch.where(intra8, mode_est.reshape(by, bx), 255) \
        .to(torch.uint8)
    return rec_y, rec_cb, rec_cr, cf_y, cf_cb, cf_cr, intra8, mode8


# =============================================================================
# in-loop deblock with data-dependent boundary strengths
# =============================================================================

def _inter_bs_maps_t(depth8, mv8, cf_y, ctu: int, intra8=None,
                     tusplit8=None):
    """Boundary-strength maps (clause 8.7.2.4): 2 where either side is
    intra, else 1 on TU boundaries where either side's TU has
    coefficients, or on CU (= PU) boundaries where the MV difference
    reaches a full pel. With RQT, TU edges of split CUs lie at CU/2."""
    n8y, n8x = depth8.shape
    dev = depth8.device
    nz8 = (cf_y[:n8y * 8, :n8x * 8].reshape(n8y, 8, n8x, 8) != 0) \
        .any(dim=3).any(dim=1)

    def orpool(a, k):
        yy = a.shape[0] // k * k
        xx = a.shape[1] // k * k
        q = a[:yy, :xx].reshape(yy // k, k, xx // k, k).any(dim=3) \
            .any(dim=1)
        out = torch.zeros_like(a)
        out[:yy, :xx] = _up(q, k)
        return out

    size = ctu >> depth8.to(torch.int32)
    if tusplit8 is None:
        tusplit8 = torch.zeros((n8y, n8x), dtype=torch.int32, device=dev)
    tsize = torch.clamp(size >> (tusplit8 > 0).to(torch.int32), 8, 32)
    cbf8 = torch.where(tsize == 32, orpool(nz8, 4),
                       torch.where(tsize == 16, orpool(nz8, 2), nz8))
    xs = (torch.arange(n8x, device=dev) * 8)[None, :]
    ys = (torch.arange(n8y, device=dev) * 8)[:, None]
    vmask = (xs % tsize) == 0
    vmask[:, 0] = False
    hmask = (ys % tsize) == 0
    hmask[0, :] = False
    vmask_cu = (xs % size) == 0
    vmask_cu[:, 0] = False
    hmask_cu = (ys % size) == 0
    hmask_cu[0, :] = False
    if intra8 is None:
        intra8 = torch.zeros((n8y, n8x), dtype=torch.bool, device=dev)

    def bs_of(mP, mQ, mvP, mvQ, iP, iQ, cu_edge):
        mvd = (torch.abs(mvP[..., 0] - mvQ[..., 0]) >= 4) | \
              (torch.abs(mvP[..., 1] - mvQ[..., 1]) >= 4)
        bs1 = (mP | mQ | (mvd & cu_edge)).to(torch.int32)
        return torch.where(iP | iQ, 2, bs1)

    vbs = torch.zeros((n8y, n8x), dtype=torch.int32, device=dev)
    vbs[:, 1:] = bs_of(cbf8[:, :-1], cbf8[:, 1:], mv8[:, :-1], mv8[:, 1:],
                       intra8[:, :-1], intra8[:, 1:], vmask_cu[:, 1:])
    vbs = vbs * vmask
    hbs = torch.zeros((n8y, n8x), dtype=torch.int32, device=dev)
    hbs[1:, :] = bs_of(cbf8[:-1, :], cbf8[1:, :], mv8[:-1, :], mv8[1:, :],
                       intra8[:-1, :], intra8[1:, :], hmask_cu[1:, :])
    return vbs, hbs * hmask


# =============================================================================
# one P frame
# =============================================================================

def _pgop_frame(ry, rcb, rcr, oy, ocb, ocr, wvec, *, qp: int, qpc: int,
                bit_depth: int, real_h: int, real_w: int, ctu: int,
                deblock: bool, sign_hiding: bool, me_range: int,
                intra_ii: bool, psy_rd: float, weight_denom: int, rqt: bool):
    """One P frame. ry/rcb/rcr: int32 reference planes and oy/ocb/ocr
    int32 source planes at the scan size (32-multiples, edge-padded);
    wvec: (6,) int32 weights or None. Returns (fields, next reference
    planes): fields = (depth8, mv8, cf_y, cf_cb, cf_cr, intra8, imode8,
    tusplit8, rec_y, rec_cb, rec_cr)."""
    dev = oy.device
    lam = float(lambda_from_qp(qp))
    lam2 = float(lambda2_from_qp(qp))
    h, w = oy.shape
    rh, rw = real_h, real_w
    calib = calib_for_qp(qp)

    # --- dense hierarchical ME: one window gather per 16-region (n=8
    # and n=16) + one per 32-block
    lam_i = int(round(lam))
    coarse_pen = max(int(round(lam)) >> 2, 1)
    pad_y = 2 * me_range + 8
    pad_c = me_range + 8
    weighted = wvec is not None
    oy_s = inverse_weight_plane(oy, wvec[0], wvec[1], weight_denom,
                                bit_depth) if weighted else oy
    cmv, _ = _coarse_search_rolled(_downsample4(oy_s), _downsample4(ry),
                                   lam_pen=coarse_pen)
    cmv16 = _median3_mv(cmv) * 4
    ry_pad = pad_ref(ry.to(torch.uint8), pad_y)
    meres, seeds = me_all_sizes(oy, ry_pad, cmv16, lam_i, radius=me_range,
                                pad=pad_y, bit_depth=bit_depth, sizes=SIZES,
                                cur_search=oy_s if weighted else None,
                                wvec=wvec, weight_denom=weight_denom)
    mvs = {n: meres[n][0] for n in SIZES}
    preds = {n: meres[n][2] for n in SIZES}

    # --- windowed chroma predictions for every size
    cpad2 = torch.stack([pad_ref(rcb.to(torch.uint8), pad_c),
                         pad_ref(rcr.to(torch.uint8), pad_c)])
    cpreds = _chroma_preds_windowed(cpad2, pad_c, rcb, rcr, mvs, seeds,
                                    me_range, h, w, bit_depth, wvec=wvec,
                                    weight_denom=weight_denom)

    # --- intra candidate estimate (orig refs) so intra competes in the
    # depth decision; a 1.25x margin for its optimism
    if intra_ii:
        imode_est, icost8 = _intra8_est(
            oy, ocb, ocr, lam_i, lam2, qp, qpc, ctu, rh, rw, bit_depth,
            sign_hiding, calib, psy_rd=psy_rd)
        icost8_m = icost8 * _f32(1.25, dev)
    else:
        icost8_m = None

    (rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr, depth8, mv8, tusplit8,
     intra_pref, inter_c8) = _mc_recon_all(
        oy, ocb, ocr, mvs, lam2, qp, qpc, bit_depth, sign_hiding, rh, rw,
        preds=preds, cpreds=cpreds, psy_rd=psy_rd, rqt=rqt,
        alt8_cost=icost8_m)

    if intra_ii:
        (rec_y, rec_cb, rec_cr, cf_y, cf_cb, cf_cr, intra8,
         imode8) = _intra_in_inter(
            oy, ocb, ocr, rec_y, rec_cb, rec_cr, cf_y, cf_cb, cf_cr,
            depth8, intra_pref, imode_est, qp, qpc, ctu, rh, rw, bit_depth,
            sign_hiding, lam2=lam2, inter_c8=inter_c8, calib=calib,
            psy_rd=psy_rd)
    else:
        intra8 = torch.zeros_like(depth8, dtype=torch.bool)
        imode8 = torch.full(depth8.shape, 255, dtype=torch.uint8,
                            device=dev)

    # --- in-loop filters on the coded-size crop
    ry_c = rec_y[:rh, :rw]
    rcb_c = rec_cb[:rh // 2, :rw // 2]
    rcr_c = rec_cr[:rh // 2, :rw // 2]
    if deblock:
        vbs, hbs = _inter_bs_maps_t(
            depth8[:rh // 8, :rw // 8], mv8[:rh // 8, :rw // 8],
            cf_y[:rh, :rw], ctu,
            intra8=intra8[:rh // 8, :rw // 8] if intra_ii else None,
            tusplit8=tusplit8[:rh // 8, :rw // 8] if rqt else None)
        ry_c = deblock_luma_t(ry_c.contiguous(), vbs, hbs, qp, bit_depth)
        if intra_ii:
            # chroma filters only bs == 2 edges (intra boundaries)
            rcb_c = deblock_chroma_t(rcb_c.contiguous(), vbs, hbs, qp,
                                     bit_depth)
            rcr_c = deblock_chroma_t(rcr_c.contiguous(), vbs, hbs, qp,
                                     bit_depth)

    # --- re-pad the filtered picture as the next reference
    nxt = (edge_pad(ry_c, h, w), edge_pad(rcb_c, h // 2, w // 2),
           edge_pad(rcr_c, h // 2, w // 2))
    fields = (depth8.to(torch.uint8), mv8, cf_y, cf_cb, cf_cr,
              intra8.to(torch.uint8), imode8, tusplit8.to(torch.uint8)) + nxt
    return fields, nxt


# =============================================================================
# submit / collect
# =============================================================================

class PgopPending:
    """Device work enqueued for one P chunk (submit/collect split)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def check_pgop_config(cfg: EncoderConfig) -> None:
    """Raise for every option the P-chunk path of this package does not
    implement (NotImplementedError naming its ROADMAP queue item)."""
    unported = [
        (cfg.num_refs > 1 or cfg.tmvp, "multi-ref / TMVP", 12),
        (cfg.sao, "SAO", 13),
        (cfg.ctu_size != 32, "CTU 16/64", 14),
        (cfg.dqp_enabled, "dQP / AQ / cuTree", 15),
        (cfg.rdoq or cfg.nr_inter or cfg.lowpass_dct,
         "RDOQ / noise reduction / lowpass DCT", 16),
        (cfg.wpp, "WPP", 17),
        (cfg.lossless, "lossless", 18),
        (cfg.bit_depth != 8, "10-bit", 19),
        (cfg.bframes > 0, "B frames", 21),
        (cfg.hash_sei, "picture-hash SEI", 24),
    ]
    for cond, what, item in unported:
        if cond:
            raise NotImplementedError(
                f"{what}: not ported yet (ROADMAP queue 1 item {item})")


def submit_pgop_gpu(orig_y: np.ndarray, orig_cb: np.ndarray,
                    orig_cr: np.ndarray, ref: ReconFrame | DeviceRef,
                    cfg: EncoderConfig, qp: int | None = None,
                    need_recon: bool = True, me_range: int = 6,
                    qp_maps: np.ndarray | None = None,
                    seeds16: np.ndarray | None = None,
                    weights: np.ndarray | None = None,
                    device=None) -> PgopPending:
    """Enqueue a P chunk on the device; returns before the device has
    finished it (no result is read back).

    orig_y: (F, H, W) uint8 planes at the coded (8-aligned) size; ref:
    the post-filter recon of the preceding frame, a host ReconFrame or
    a DeviceRef (used in place). weights: (F, 6) int32 weightp vectors.
    The final reference (PgopPending.last_ref, a DeviceRef) can chain
    the next submit at once."""
    check_pgop_config(cfg)
    if qp_maps is not None:
        raise NotImplementedError(
            "per-CTU QP maps: not ported yet (ROADMAP queue 1 item 15)")
    if seeds16 is not None:
        raise NotImplementedError(
            "analysis-reuse seeds: not ported yet (ROADMAP queue 1 item 24)")
    dev = resolve_device(device)
    if isinstance(ref, DeviceRef) and ref.y.device.type != dev.type:
        raise ValueError(f"reference on {ref.y.device}, device {dev} "
                         f"requested")
    f, h, w = orig_y.shape
    hp = (h + 31) // 32 * 32
    wp = (w + 31) // 32 * 32
    qp = cfg.qp if qp is None else qp
    qpc = chroma_qp(qp)

    def upload(planes, ph, pw):
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(planes).astype(np.uint8, copy=False))).to(dev)
        return [edge_pad(t[i], ph, pw).to(torch.int32) for i in range(f)]

    oys = upload(orig_y, hp, wp)
    ocbs = upload(orig_cb, hp // 2, wp // 2)
    ocrs = upload(orig_cr, hp // 2, wp // 2)
    if isinstance(ref, DeviceRef):
        planes = (ref.y, ref.cb, ref.cr)
    else:
        planes = tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(p)[:hh, :ww].astype(np.uint8))).to(dev)
            for p, hh, ww in ((ref.y, h, w), (ref.cb, h // 2, w // 2),
                              (ref.cr, h // 2, w // 2)))
    cur = (edge_pad(planes[0].to(torch.int32), hp, wp),
           edge_pad(planes[1].to(torch.int32), hp // 2, wp // 2),
           edge_pad(planes[2].to(torch.int32), hp // 2, wp // 2))
    if cfg.weightp:
        from .weightp import WP_DENOM
        if weights is None:
            weights = np.tile(np.asarray([1 << WP_DENOM, 0] * 3, np.int32),
                              (f, 1))
        wv = torch.as_tensor(np.asarray(weights, np.int32).reshape(f, 6),
                             device=dev)
    else:
        wv = None
    outs = []
    for i in range(f):
        fields, cur = _pgop_frame(
            *cur, oys[i], ocbs[i], ocrs[i], None if wv is None else wv[i],
            qp=int(qp), qpc=int(qpc), bit_depth=cfg.bit_depth, real_h=h,
            real_w=w, ctu=cfg.ctu_size, deblock=cfg.deblock,
            sign_hiding=cfg.sign_hiding, me_range=int(me_range),
            intra_ii=cfg.intra_in_inter, psy_rd=float(cfg.psy_rd),
            weight_denom=6, rqt=bool(cfg.rqt_inter))
        outs.append(fields)
    last_ref = DeviceRef(*(p[:hh, :ww].to(torch.uint8).contiguous()
                           for p, hh, ww in ((cur[0], h, w),
                                             (cur[1], h // 2, w // 2),
                                             (cur[2], h // 2, w // 2))))
    return PgopPending(outs=outs, f=f, h=h, w=w, need_recon=need_recon,
                       last_ref=last_ref)


def collect_pgop_gpu(p: PgopPending):
    """Download one submitted chunk: per frame a FramePSyntax (host
    arrays cropped to the coded size) and, when requested, a host
    ReconFrame. Returns (syns, recons, last_ref)."""
    h, w = p.h, p.w
    n8y, n8x = h // 8, w // 8
    syns, recons = [], []
    for fields in p.outs:
        (depth8, mv8, cf_y, cf_cb, cf_cr, intra8, imode8, tusplit8, ry, rcb,
         rcr) = fields
        small = [t[:n8y, :n8x].cpu().numpy()
                 for t in (depth8, intra8, imode8, tusplit8)]
        depth8_np, intra8_np, imode8_np, tus_np = small
        syn = FramePSyntax(
            depth8=np.ascontiguousarray(depth8_np),
            mv8=mv8[:n8y, :n8x].cpu().numpy().astype(np.int32),
            coeff_y=cf_y[:h, :w].to(torch.int16).cpu().numpy(),
            coeff_cb=cf_cb[:h // 2, :w // 2].to(torch.int16).cpu().numpy(),
            coeff_cr=cf_cr[:h // 2, :w // 2].to(torch.int16).cpu().numpy(),
            tusplit8=np.ascontiguousarray(tus_np) if tus_np.any() else None)
        if intra8_np.any():
            syn.intra8 = intra8_np != 0
            syn.mode8 = imode8_np
        syns.append(syn)
        if p.need_recon:
            recons.append(ReconFrame(
                ry[:h, :w].cpu().numpy().astype(np.int32),
                rcb[:h // 2, :w // 2].cpu().numpy().astype(np.int32),
                rcr[:h // 2, :w // 2].cpu().numpy().astype(np.int32)))
        else:
            recons.append(None)
    return syns, recons, p.last_ref
