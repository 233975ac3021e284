"""P-frame device pipeline: an IPPP chunk frame after frame on the GPU.

Counterpart of x265_tpu/enc/pgop_tpu.py for CTU 32 and 64: one or
several references (multi-reference selection from the coarse pass),
deblock, SAO, sign hiding, RQT depth 1, weightp, psy-rd,
intra-in-inter, RDOQ, noise reduction (its state carried from frame to
frame within a submit), the lowpass DCT and per-CTU QP maps (dQP:
every block quantised at its CTU's QP, the deblock at the QP a decoder
infers per CTU); at CTU 64 a depth-0 64x64 CU is built from the
32-level content where its four 32-blocks agree.
The reference expresses the chain as one lax.scan; here it is a Python
loop whose body does, all on the device: coarse quarter-res search (one
per reference) -> windowed ME for every block of every size
(ops/me_win.py, on the window-gather and integer-search kernels) ->
windowed chroma MC -> intra 8x8 estimate -> MC + transform + quant +
recon at every size with a leaf-RDO depth decision -> intra-in-inter ->
in-loop deblock and SAO on the coded
crop. With R references the carried reference is the stack of the R
most recent pictures. submit_pgop_gpu enqueues a chunk and
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
from ..common.tables import (CHROMA_QP_LUT, chroma_qp, lambda_from_qp,
                             lambda2_from_qp)
from ..device import resolve_device
from ..ops.deblock import deblock_chroma_t, deblock_luma_t
from ..ops.fma import fma32
from ..ops.intra import intra_pred_all_modes, intra_pred_single_mode
from ..ops.me import _downsample4, bitlen as _bitlen
from ..ops.me_win import (_argmin_first, apply_weight_acc,
                          apply_weight_fullpel, chroma_mc_from_windows,
                          gather_chroma_windows, inverse_weight_plane,
                          me_all_sizes, pad_ref, seed_floor_off)
from ..ops.sao_gpu import apply_sao_t, choose_sao_chroma_t, choose_sao_t
from ..ops.satd import sa8d_batch, sa8d_nxn_lanes
from ..ops.transforms import (dct_batch, dct_lanes, dequant_batch,
                              dequant_lanes, idct_batch, idct_lanes,
                              quant_batch, quant_lanes, rdoq_lanes,
                              sign_hide_batch, sign_hide_lanes)
from .intra_analysis import _MODE_BITS, block_sum_seq, edge_pad, up as _up
from .intra_recon import DeviceRef, ReconFrame, np_pixel_dtype, pixel_dtype
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
                           weight_denom: int = 6, ref16=None, ref32=None,
                           cstride: int = 0, zplanes=None, raw: bool = False):
    """cpad2: (2, Hc+2pc, Wc+2pc) stacked padded uint8 (uint16 at 10
    bits) chroma refs, or with multi-reference prediction
    (2, R*(Hc+2pc), Wc+2pc) with cstride = Hc+2pc rows per reference and
    ref16/ref32 the per-region selections; mvs: {n: (B, 2) qpel};
    seeds: {16: (sx, sy), 32: (sx, sy)} clamped full-pel seeds. MVs from
    the windowed search lie within
    seed +- radius (qpel +-3/4); zero-MV winners take the co-located
    blocks, of zplanes[{16, 32}] = (cb, cr) (the selected references'
    planes) when given, else of refcb/refcr. wvec: explicit weights, cb
    from wvec[2:4], cr from wvec[4:6], on reference 0 only when
    multi-reference (the others take the neutral weight, which rounds
    as the default path). raw (the B path, unweighted only): the
    pre-rounding accumulators, a zero-MV block's samples << (12 -
    (bit_depth - 8)). Returns {n: (pred_cb, pred_cr) (B, cn, cn)}."""
    weighted = wvec is not None
    assert not (weighted and raw), \
        "raw accumulators are the unweighted contract (B path)"
    dev = refcb.device
    r = radius

    def grid(n, step):
        by, bx = h // n, w // n
        ys = torch.arange(by, dtype=torch.int32, device=dev) * step
        xs = torch.arange(bx, dtype=torch.int32, device=dev) * step
        return ys.repeat_interleave(bx), xs.repeat(by)

    def row_off(sel):
        return 0 if sel is None else sel * cstride

    by16, bx16 = h // 16, w // 16
    yc16, xc16 = grid(16, 8)
    sx16, sy16 = seeds[16]
    s0x16 = seed_floor_off(sx16, r)
    s0y16 = seed_floor_off(sy16, r)
    wc16 = r + 12
    win16 = gather_chroma_windows(cpad2, pc, yc16, xc16, s0y16, s0x16, wc16,
                                  row_off=row_off(ref16))

    def zero_blocks(plane, cn):
        cy, cx = plane.shape
        return plane.reshape(cy // cn, cn, cx // cn, cn) \
            .permute(0, 2, 1, 3).reshape(-1, cn, cn).to(torch.int32)

    # the 2x2 sub-blocks of each 16-region share its window
    by8, bx8 = h // 8, w // 8
    parent = ((torch.arange(by8, device=dev) // 2)[:, None] * bx16 +
              (torch.arange(bx8, device=dev) // 2)[None, :]).reshape(-1)
    out = {}
    for n, cn in ((8, 4), (16, 8), (32, 16)):
        mv = mvs[n]
        refsel = ref16
        if n == 32:
            yc32, xc32 = grid(32, 16)
            sx32, sy32 = seeds[32]
            s0xe = seed_floor_off(sx32, r)
            s0ye = seed_floor_off(sy32, r)
            nshift = r + 2
            win_b = gather_chroma_windows(cpad2, pc, yc32, xc32, s0ye, s0xe,
                                          r + 20, row_off=row_off(ref32))
            rel_y = rel_x = 0
            refsel = ref32
        elif n == 16:
            # rel == 0: offsets span only r+2 shifts
            win_b, nshift = win16, r + 2
            s0ye, s0xe = s0y16, s0x16
            rel_y = rel_x = 0
        else:
            # (uint16 windows index as int16: the same 10-bit samples)
            win_b, nshift = (win16.view(torch.int16) if win16.dtype ==
                             torch.uint16 else win16)[parent], r + 6
            s0ye, s0xe = s0y16[parent], s0x16[parent]
            rel_y = ((torch.arange(by8, dtype=torch.int32, device=dev) % 2)
                     .repeat_interleave(bx8)) * 4
            rel_x = ((torch.arange(bx8, dtype=torch.int32, device=dev) % 2)
                     .repeat(by8)) * 4
            if refsel is not None:
                refsel = refsel[parent]
        zero = (mv[:, 0] == 0) & (mv[:, 1] == 0)
        offy = torch.clamp(rel_y + (mv[:, 1] >> 3) - 1 - s0ye, 0, nshift - 1)
        offx = torch.clamp(rel_x + (mv[:, 0] >> 3) - 1 - s0xe, 0, nshift - 1)
        pcb, pcr = chroma_mc_from_windows(
            win_b, offy, offx, mv[:, 0] & 7, mv[:, 1] & 7, cn, nshift,
            bit_depth, raw=raw or weighted)
        zsrc = (refcb, refcr) if zplanes is None else \
            zplanes[32 if n == 32 else 16]
        zcb = zero_blocks(zsrc[0], cn)
        zcr = zero_blocks(zsrc[1], cn)
        if weighted:
            wm = None if refsel is None else (refsel == 0)[:, None, None]

            def wsel(acc, wv_w, wv_o):
                wv = apply_weight_acc(acc, wv_w, wv_o, weight_denom,
                                      bit_depth)
                return wv if wm is None else torch.where(
                    wm, wv, apply_weight_acc(acc, 1 << weight_denom, 0,
                                             weight_denom, bit_depth))

            def wsel_fp(blk, wv_w, wv_o):
                wv = apply_weight_fullpel(blk, wv_w, wv_o, weight_denom,
                                          bit_depth)
                return wv if wm is None else torch.where(wm, wv, blk)

            pcb = wsel(pcb, wvec[2], wvec[3])
            pcr = wsel(pcr, wvec[4], wvec[5])
            zcb = wsel_fp(zcb, wvec[2], wvec[3])
            zcr = wsel_fp(zcr, wvec[4], wvec[5])
        if raw:
            zcb = zcb << (12 - (bit_depth - 8))
            zcr = zcr << (12 - (bit_depth - 8))
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
    return torch.where(nnz > 0, _calib_bits(nnz, slog, calib), 0.0)


def _calib_bits(nnz, slog, calib):
    """calib[0] * nnz + calib[1] * slog + calib[2], the second product
    fused into the add as the reference's program rounds it."""
    return fma32(calib[0] * nnz, calib[1], slog) + calib[2]


def _rd_depth_decision(sse: dict, bits: dict, mvs: dict, lam2: float,
                       real_h: int, real_w: int, h: int, w: int,
                       hdr_bits: float, split_bits: float,
                       refs: dict | None, alt8_cost=None,
                       costs: dict | None = None):
    """Bottom-up split-vs-keep argmin over true RD costs. Returns depth8
    (n8y, n8x), mv8 (n8y, n8x, k) (the k MV components of mvs: 2, or
    4 for a B frame's two lists), ref8 (n8y, n8x), intra_pref (n8y,
    n8x) and the 8x8 inter leaf cost. CUs over the coded edge are forced
    to split. refs: per-size (by, bx) L0 refIdx grids, None for all 0
    (ref8 then 0 everywhere). alt8_cost: RD
    cost of the 8x8 INTRA candidate per min-cell; where it beats the
    inter leaf it replaces the 8-level cost. With a 64 level in sse
    (CTU 64) the depths count from the 64 CU: 0 where the 64 CU is
    kept, the 32-level decision one level deeper elsewhere. costs, when
    given, receives the float32 planes each decision compares: 'intra8'
    (alt8_cost, leaf cost), 'keep16' / 'keep32' / 'keep64' (leaf cost,
    split cost)."""
    dev = sse[8].device
    big = 1e18
    has64 = 64 in sse
    cost = {}
    intra_pref = None
    for n in SIZES + ((64,) if has64 else ()):
        by, bx = h // n, w // n
        c = fma32(sse[n], lam2, bits[n] + hdr_bits)
        if n == 8:
            inter_c8 = c
        if n == 8 and alt8_cost is not None:
            intra_pref = alt8_cost < c
            if costs is not None:
                costs["intra8"] = (alt8_cost, c)
            c = torch.minimum(c, alt8_cost)
        ys = torch.arange(by, device=dev)[:, None]
        xs = torch.arange(bx, device=dev)[None, :]
        over = ((ys + 1) * n > real_h) | ((xs + 1) * n > real_w)
        cost[n] = torch.where(over, _f32(big, dev), c)
    split_cost = float(lam2 * split_bits)          # python double, as ref
    agg = torch.where(cost[8] >= big, 0.0, cost[8])
    ch16 = block_sum_seq(agg, h // 16, 2, w // 16) + split_cost
    keep16 = cost[16] <= ch16
    if costs is not None:
        costs["keep16"] = (cost[16], ch16)
    agg16 = torch.where(keep16, cost[16], ch16)
    agg16 = torch.where(agg16 >= big, 0.0, agg16)
    ch32 = block_sum_seq(agg16, h // 32, 2, w // 32) + split_cost
    keep32 = cost[32] <= ch32
    if costs is not None:
        costs["keep32"] = (cost[32], ch32)

    n8y, n8x = h // 8, w // 8
    k32 = _up(keep32, 4)[:n8y, :n8x]
    k16 = _up(keep16, 2)[:n8y, :n8x]
    depth8 = torch.where(k32, 0, torch.where(k16, 1, 2)).to(torch.int32)
    if has64:
        depth8 = depth8 + 1

    def up_mv(n, k):
        return _up(mvs[n].reshape(h // n, w // n, -1), k)[:n8y, :n8x]

    mv8 = torch.where(k32[..., None], up_mv(32, 4),
                      torch.where(k16[..., None], up_mv(16, 2), up_mv(8, 1)))

    def up_ref(n, k):
        if refs is None:
            return torch.zeros((n8y, n8x), dtype=torch.int32, device=dev)
        return _up(refs[n].reshape(h // n, w // n), k)[:n8y, :n8x]

    ref8 = torch.where(k32, up_ref(32, 4),
                       torch.where(k16, up_ref(16, 2), up_ref(8, 1)))
    if has64:
        agg32 = torch.where(keep32, cost[32], ch32)
        agg32 = torch.where(agg32 >= big, 0.0, agg32)
        ch64 = block_sum_seq(agg32, h // 64, 2, w // 64) + split_cost
        if costs is not None:
            costs["keep64"] = (cost[64], ch64)
        k64 = _up(cost[64] <= ch64, 8)[:n8y, :n8x]
        depth8 = torch.where(k64, 0, depth8)
        mv8 = torch.where(k64[..., None], up_mv(64, 8), mv8)
        ref8 = torch.where(k64, up_ref(64, 8), ref8)
    if intra_pref is None:
        intra_pref = torch.zeros((n8y, n8x), dtype=torch.bool, device=dev)
    return depth8, mv8.to(torch.int32), ref8, intra_pref[:n8y, :n8x], \
        inter_c8


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


def _cu64_candidate(sse, bits, mvs, refs, tusplit, m_scale: float,
                    nrefs: int, h: int, w: int) -> None:
    """The depth-0 64x64 candidate of CTU 64, from the 32-level content
    (x265 maxCUSize 64), added in place as sse[64], bits[64], mvs[64]
    and refs[64]. Eligible where the four 32-blocks share (mv, ref) and
    none chose a TU split (a 64 CU's TUs are exactly the four 32s,
    7.4.9.8): the 2x2 sum of the 32-level SSE, plus 1e18 elsewhere; the
    2x2 sum of the 32-level bits without their MVD and ref_idx bits,
    plus one MVD (left neighbour on the 64 grid) and one ref_idx."""
    by64, bx64 = h // 64, w // 64
    mv32 = mvs[32].reshape(h // 32, w // 32, 2)
    r32 = refs[32].reshape(h // 32, w // 32)
    mv_tl, r_tl = mv32[0::2, 0::2], r32[0::2, 0::2]
    elig = torch.ones((by64, bx64), dtype=torch.bool, device=mv32.device)
    for dy in (0, 1):
        for dx in (0, 1):
            elig &= (mv32[dy::2, dx::2] == mv_tl).all(-1) & \
                (r32[dy::2, dx::2] == r_tl)
    if 32 in tusplit:
        elig &= ~tusplit[32].reshape(by64, 2, bx64, 2).any(3).any(1)
    sse[64] = block_sum_seq(sse[32], by64, 2, bx64) + \
        torch.where(elig, 0.0, _f32(1e18, mv32.device))
    coeff32 = fma32(bits[32], -m_scale, _mvd_bits_est(mv32))
    if nrefs > 1:
        coeff32 = coeff32 - torch.clamp(r32 + 1, max=nrefs - 1).to(F32)
    bits[64] = fma32(block_sum_seq(coeff32, by64, 2, bx64), m_scale,
                     _mvd_bits_est(mv_tl))
    if nrefs > 1:
        bits[64] = bits[64] + torch.clamp(r_tl + 1, max=nrefs - 1).to(F32)
    mvs[64], refs[64] = mv_tl, r_tl


# noise-reduction categories of the P frames: (TU size, plane kind), the
# x265 frameencoder.cpp category layout over the sizes this path codes
# (inter luma 8-32, chroma 4-16)
NR_CATS = ((8, "y"), (16, "y"), (32, "y"), (4, "c"), (8, "c"), (16, "c"))


def _nr_denoise(tcoef: torch.Tensor, off_flat: torch.Tensor):
    """x265 denoiseDct: |coef| -= offset per position, clamped at 0, the
    sign restored. tcoef (n, n, B) int32; off_flat (n*n,) float32.
    Returns the denoised coefficients and the per-position sums of
    |coef| before denoising (float32, the NR accumulator's input)."""
    n = tcoef.shape[0]
    off = off_flat.reshape(n, n, 1).to(torch.int32)
    a = torch.abs(tcoef)
    return torch.sign(tcoef) * torch.clamp(a - off, min=0), \
        a.sum(2, dtype=torch.int32).reshape(-1).to(F32)


def _nr_state_init(device) -> tuple:
    """The NR state at the start of a submit: per category the sums
    (n*n,) and the count, all zero."""
    return (tuple(torch.zeros(n * n, dtype=F32, device=device)
                  for n, _ in NR_CATS),
            tuple(torch.zeros((), dtype=F32, device=device)
                  for _ in NR_CATS))


def _nr_offsets(state, nr: int) -> dict:
    """Per-position denoise offsets from the carried (sums, counts)
    (frameencoder.cpp noiseReductionUpdate: value / denominator, DC
    0); the multiply-add rounds once, as in the reference's program."""
    sums, counts = state
    offs = {}
    for ci, key in enumerate(NR_CATS):
        sm = sums[ci]
        off = fma32(sm * 0.5, float(nr), counts[ci]) / (sm + 1.0)
        off[0] = 0.0
        offs[key] = off
    return offs


def _nr_update(state, accum: dict) -> tuple:
    """Add a frame's accumulators to the state, halving a category whose
    count passes its cap (maxBlocksPerTrSize, frameencoder.cpp)."""
    sums, counts = state
    new_s, new_c = [], []
    for ci, (nn, kind) in enumerate(NR_CATS):
        acc, nb = accum[(nn, kind)]
        sm = sums[ci] + acc
        ct = counts[ci] + float(nb)
        halve = ct > float(1 << (22 - 2 * (nn.bit_length() - 1)))
        new_s.append(torch.where(halve, sm * 0.5, sm))
        new_c.append(torch.where(halve, ct * 0.5, ct))
    return tuple(new_s), tuple(new_c)


@lru_cache(maxsize=None)
def _chroma_lut(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(CHROMA_QP_LUT, device=device)


def _qp_vec_of(qp, qpc, qp_ctu, by: int, bx: int, nn: int, ctu: int):
    """Per-block (luma QP, chroma QP) of an nn-block grid of by x bx
    blocks: the scalars without a per-CTU map (qp_ctu None), else each
    block's covering CTU's QP as (by * bx,) raster vectors, the chroma
    QP through the 4:2:0 table clipped at 57."""
    if qp_ctu is None:
        return qp, qpc
    dev = qp_ctu.device
    iy = torch.arange(by, device=dev) * nn // ctu
    ix = torch.arange(bx, device=dev) * nn // ctu
    q = qp_ctu[iy[:, None], ix[None, :]].reshape(-1)
    return q, _chroma_lut(dev)[torch.clamp(q, 0, 57).long()]


def _effective_qp8(qp_ctu, cf_y, cf_cb, cf_cr, qp: int, ctu: int, rh: int,
                   rw: int):
    """The per-8x8-cell QP a decoder infers for the deblock, over the
    coded (rh, rw) crop: a CTU that codes no residual keeps the
    predictor (the last CTU before it in raster order that codes one;
    the slice QP before the first). Only the coded region's
    coefficients reach the stream, so the padded edge's do not count."""
    ncty, nctx = qp_ctu.shape
    hp, wp = cf_y.shape

    def any_ctu(cf, c, rhh, rww):
        cf = cf.clone()
        cf[rhh:] = 0
        cf[:, rww:] = 0
        return (cf.reshape(ncty, c, nctx, c) != 0).any(3).any(1)

    cbf = any_ctu(cf_y, ctu, rh, rw) |         any_ctu(cf_cb, ctu // 2, rh // 2, rw // 2) |         any_ctu(cf_cr, ctu // 2, rh // 2, rw // 2)
    flat_q = qp_ctu.reshape(-1)
    iota = torch.arange(flat_q.shape[0], dtype=torch.int64,
                        device=qp_ctu.device)
    last = torch.cummax(torch.where(cbf.reshape(-1), iota, -1), 0).values
    eff = torch.where(last >= 0, flat_q[torch.clamp(last, min=0)],
                      qp).reshape(ncty, nctx).to(torch.int32)
    return _up(eff, ctu // 8)[:rh // 8, :rw // 8]


def _mc_recon_all(oy, ocb, ocr, mvs, lam2, qp, qpc, bit_depth,
                  sign_hiding, real_h, real_w, preds, cpreds, refs_grid,
                  nrefs: int, psy_rd=0.0, rqt=False, alt8_cost=None,
                  ctu: int = 32, costs: dict | None = None,
                  rdoq: bool = False, lowpass: bool = False,
                  nr_offsets: dict | None = None, qp_ctu=None):
    """MC + residual coding at EVERY CU size with that size's own MV
    field (predictions from the windowed ME), leaf-RDO depth decision
    from the true recon SSE + estimated bits, then compose by depth.
    RQT: 16/32 CUs may code four half-size TUs on the same prediction.
    refs_grid: per-size refIdx grids among nrefs references, whose
    ref_idx bins enter the bits. At CTU 64 the depth-0 candidate is
    synthesised from the 32 level (_cu64_candidate) and its CUs reuse
    the 32-level planes. Returns (rec_y, cf_y, rec_cb, cf_cb, rec_cr,
    cf_cr, depth8, mv8, tusplit8, ref8, intra_pref, inter_c8). costs,
    when given, receives the float32 planes each decision compares:
    'split16' / 'split32' (TU-split cost, unsplit cost), 'sse' and
    'bits' (the per-size inputs of the depth decision, psy included),
    and those of _rd_depth_decision; with RDOQ 'rdoq', the list of
    each call's comparison operands (ops.transforms._rdoq) in the
    reference's order.
    rdoq replaces the dead-zone quantiser, lowpass the forward DCT of
    N >= 8 (both also in the TU-split candidate); nr_offsets (per
    NR_CATS key) denoises the coefficients of the unsplit TUs and makes
    the return a pair (outputs, NR accumulators {key: (sums, blocks)}),
    as the reference's. qp_ctu, an (ncty, nctx) int32 per-CTU QP map
    (dQP), quantises every block at its covering CTU's QP; the lambdas
    stay the slice QP's."""
    dev = oy.device
    calib = calib_for_qp(qp)
    cal3 = calib[:3]
    m_scale = float(calib[5])
    h, w = oy.shape
    maxv = (1 << bit_depth) - 1

    nr_accum = {}
    rdoq_ops = None
    if costs is not None and rdoq:
        rdoq_ops = costs["rdoq"] = []

    def one_plane(orig, nn, qqp, pred, nr_kind=None):
        """Residual pipeline in lanes layout (nn, nn, B); nr_kind ('y' /
        'c') denoises and accumulates that NR category."""
        resi = _lanes_of_plane(orig, nn) - pred
        tcoef = dct_lanes(resi, nn, bit_depth, lowpass=lowpass)
        if nr_offsets is not None and nr_kind is not None:
            tcoef, acc = _nr_denoise(tcoef, nr_offsets[(nn, nr_kind)])
            nb = tcoef.shape[2]
            prev = nr_accum.get((nn, nr_kind))
            nr_accum[(nn, nr_kind)] = (acc, nb) if prev is None \
                else (prev[0] + acc, prev[1] + nb)
        if rdoq:
            # RDOQ replaces the dead-zone quantiser
            if sign_hiding:
                coefs, du = rdoq_lanes(tcoef, nn, qqp, lam2, bit_depth,
                                       with_rem=True, costs=rdoq_ops)
                coefs = sign_hide_lanes(coefs, nn, 0, du)
            else:
                coefs = rdoq_lanes(tcoef, nn, qqp, lam2, bit_depth,
                                   costs=rdoq_ops)
        elif sign_hiding:
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
        qn, qcn = _qp_vec_of(qp, qpc, qp_ctu, by, bx, n, ctu)

        def lan(p):
            return p.permute(1, 2, 0)

        rec_y, cf_y = one_plane(oy, n, qn, lan(preds[n]), "y")
        rec_cb, cf_cb = one_plane(ocb, cn, qcn, lan(cpreds[n][0]), "c")
        rec_cr, cf_cr = one_plane(ocr, cn, qcn, lan(cpreds[n][1]), "c")
        planes[n] = (_to_plane(rec_y, n, h, w), _to_plane(cf_y, n, h, w),
                     _to_plane(rec_cb, cn, h // 2, w // 2),
                     _to_plane(cf_cb, cn, h // 2, w // 2),
                     _to_plane(rec_cr, cn, h // 2, w // 2),
                     _to_plane(cf_cr, cn, h // 2, w // 2))
        pl = planes[n]
        sse[n] = _blk_sse(pl[0], oy, by, bx, n) + \
            _blk_sse(pl[2], ocb, by, bx, cn) + \
            _blk_sse(pl[4], ocr, by, bx, cn)
        mvd = _mvd_bits_est(grid)
        bits[n] = fma32(_coeff_bits_est(pl[1], by, bx, n, cal3), m_scale,
                        mvd) + \
            _coeff_bits_est(pl[3], by, bx, cn, cal3) + \
            _coeff_bits_est(pl[5], by, bx, cn, cal3)

        # RQT: TU-split candidate (four (n/2)^2 luma TUs + four (n/4)^2
        # chroma TUs on the SAME prediction), chosen per CU by RD
        if rqt and n >= 16:
            n2, n4 = n >> 1, n >> 2
            qn2, qcn2 = _qp_vec_of(qp, qpc, qp_ctu, h // n2, w // n2, n2,
                                   ctu)
            py_pl = _to_plane(lan(preds[n]), n, h, w)
            pcb_pl = _to_plane(lan(cpreds[n][0]), cn, h // 2, w // 2)
            pcr_pl = _to_plane(lan(cpreds[n][1]), cn, h // 2, w // 2)
            ry_s, cfy_s = one_plane(oy, n2, qn2, _lanes_of_plane(py_pl, n2))
            rcb_s, cfcb_s = one_plane(ocb, n4, qcn2,
                                      _lanes_of_plane(pcb_pl, n4))
            rcr_s, cfcr_s = one_plane(ocr, n4, qcn2,
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

            bits_s = fma32(
                up2(_coeff_bits_est(pl_s[1], h // n2, w // n2, n2, cal3)),
                m_scale, mvd) + \
                up2(_coeff_bits_est(pl_s[3], h // n2, w // n2, n4, cal3)) + \
                up2(_coeff_bits_est(pl_s[5], h // n2, w // n2, n4, cal3)) + \
                3.0
            c_s = fma32(sse_s, lam2, bits_s)
            c_n = fma32(sse[n], lam2, bits[n])
            if costs is not None:
                costs[f"split{n}"] = (c_s, c_n)
            sp = c_s < c_n
            tusplit[n] = sp
            sse[n] = torch.where(sp, sse_s, sse[n])
            bits[n] = torch.where(sp, bits_s, bits[n])
            my = _up(sp, n)
            mc = _up(sp, cn)
            planes[n] = tuple(
                torch.where(my if i < 2 else mc, pl_s[i], planes[n][i])
                for i in range(6))
        if nrefs > 1:
            # ref_idx_l0 truncated-rice bins: r + 1, capped at nrefs - 1
            rg = refs_grid[n].reshape(by, bx)
            bits[n] = bits[n] + torch.clamp(rg + 1, max=nrefs - 1).to(F32)

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
            sse[n] = fma32(sse[n], scale, psy_n)

    mvs, refs_grid = dict(mvs), dict(refs_grid)
    if ctu == 64:
        _cu64_candidate(sse, bits, mvs, refs_grid, tusplit, m_scale, nrefs,
                        h, w)
    if costs is not None:
        costs["sse"], costs["bits"] = dict(sse), dict(bits)
    depth8, mv8, ref8, intra_pref, inter_c8 = _rd_depth_decision(
        sse, bits, mvs, lam2, real_h, real_w, h, w,
        hdr_bits=float(calib[3]), split_bits=float(calib[4]),
        refs=refs_grid, alt8_cost=alt8_cost, costs=costs)

    n8y, n8x = h // 8, w // 8
    dof = 1 if ctu == 64 else 0          # the depth of the 32 level
    zb = torch.zeros((n8y, n8x), dtype=torch.bool, device=dev)
    ts32 = _up(tusplit[32], 4)[:n8y, :n8x] if 32 in tusplit else zb
    ts16 = _up(tusplit[16], 2)[:n8y, :n8x] if 16 in tusplit else zb
    tusplit8 = torch.where(depth8 == dof, ts32,
                           torch.where(depth8 == dof + 1, ts16, zb))

    # depth -> content: a depth-0 64 CU codes the 32-level planes (the
    # same predictions, four 32x32 TUs)
    out = [torch.zeros_like(p) for p in planes[8]]
    for n, m8 in ((32, depth8 <= dof), (16, depth8 == dof + 1),
                  (8, depth8 == dof + 2)):
        mpx = _up(m8, 8)
        mpx_c = _up(m8, 4)
        for i, p in enumerate(planes[n]):
            out[i] = torch.where(mpx if i < 2 else mpx_c, p, out[i])
    out = out + [depth8, mv8, tusplit8, ref8, intra_pref, inter_c8]
    return out if nr_offsets is None else (out, nr_accum)


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
    return torch.where(nnz > 0, _calib_bits(nnz, slog, calib), 0.0)


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
        sse = fma32(sse, scale, torch.abs(_psy8_blocks(ob) -
                                          _psy8_blocks(rec8)))
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
    return mode, fma32(sse, lam2, bits).reshape(by, bx)


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
                    psy_rd: float = 0.0, costs: dict | None = None):
    """Code 8x8 intra CUs at the cells the RD depth decision chose for
    intra, in `rounds` parity-independent waves, each predicting from
    reconstruction that is final; each wave's blocks are kept only
    where their actual coded RD beats the inter content they replace.
    costs, when given, receives each wave's intra cost plane under
    'cost_a' (a list). Returns updated planes + (intra8, mode8)."""
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
                sse_a = fma32(sse_a, scale, torch.abs(_psy8_blocks(ob) -
                                                      _psy8_blocks(rec8)))
            bits_a = mode_bits_f[mode_est.long()] + 4.0
            bits_a = bits_a + _cbits_of(cf8, calib)
            for crec_w, ccf_w, ob_w in ((crecs[0], ccfs[0], ocb_b),
                                        (crecs[1], ccfs[1], ocr_b)):
                sse_a = sse_a + _sse_blocks(crec_w, ob_w)
                bits_a = bits_a + _cbits_of(ccf_w, calib)
            cost_a = fma32(sse_a, lam2, bits_a).reshape(by, bx)
            if costs is not None:
                costs.setdefault("cost_a", []).append(cost_a)
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

def _select_refs(oy_s, ry_s, rcb_s, rcr_s, lam_i: int, coarse_pen: int,
                 nrefs: int):
    """Multi-reference selection (x265 --ref N, search.cpp:2354 recast):
    the quarter-res coarse search against every reference, each
    16-region (32-block) takes the reference of least coarse cost plus
    an 8*lambda margin per ref_idx bin, first index on ties (so the
    duplicate slots of a young DPB, identical to slot 0, are never
    chosen). Returns (cmv16, cmv32, ref16 grid, ref32 grid, zero-MV
    planes of the selected references: luma {16, 32}, chroma {16: (cb,
    cr), 32: (cb, cr)})."""
    ds_cur = _downsample4(oy_s)
    mv_list, cost_list = [], []
    for rr in range(nrefs):
        mv_r, cost_r = _coarse_search_rolled(ds_cur, _downsample4(ry_s[rr]),
                                             lam_pen=coarse_pen)
        cost_list.append(cost_r + 8 * lam_i * min(rr + 1, nrefs - 1))
        mv_list.append(_median3_mv(mv_r))
    costs = torch.stack(cost_list)                  # (R, by16, bx16)
    mvsr = torch.stack(mv_list)                     # (R, by16, bx16, 2)
    _, ref16 = _argmin_first(costs)
    by16, bx16 = costs.shape[1:]
    c32 = costs.reshape(nrefs, by16 // 2, 2, bx16 // 2, 2) \
        .sum((2, 4), dtype=torch.int32)
    _, ref32 = _argmin_first(c32)

    def take(stack, sel):
        """stack[sel[...], ...] per cell of sel."""
        idx = sel.long()[None]
        if stack.dim() == idx.dim() + 1:
            idx = idx[..., None].expand(1, *stack.shape[1:])
        return torch.gather(stack, 0, idx)[0]

    cmv16 = take(mvsr, ref16) * 4
    cmv32 = take(mvsr[:, 1::2, 1::2], ref32).reshape(-1, 2) * 4

    def compose(planes_s, sel, blk):
        # with one reference every selection is slot 0
        return planes_s[0] if nrefs == 1 else take(planes_s, _up(sel, blk))

    zy = {16: compose(ry_s, ref16, 16), 32: compose(ry_s, ref32, 32)}
    zc = {16: (compose(rcb_s, ref16, 8), compose(rcr_s, ref16, 8)),
          32: (compose(rcb_s, ref32, 16), compose(rcr_s, ref32, 16))}
    return cmv16, cmv32, ref16, ref32, zy, zc


def _pgop_frame(refs, oy, ocb, ocr, wvec, *, qp: int, qpc: int,
                bit_depth: int, real_h: int, real_w: int, ctu: int,
                deblock: bool, sao: bool, sign_hiding: bool, me_range: int,
                intra_ii: bool, psy_rd: float, weight_denom: int, rqt: bool,
                nrefs: int, rdoq: bool = False, lowpass: bool = False,
                nr: int = 0, nr_state=None, qp_ctu=None, seed16=None):
    """One P frame. refs: (ry, rcb, rcr) (nrefs, ...) int32 stacks of
    the nrefs most recent reference pictures at the scan size
    (CTU multiples, edge-padded), slot 0 the newest; oy/ocb/ocr int32
    source planes at the scan size; wvec: (6,) int32 weights or None.
    rdoq, lowpass: the RD quantiser and the lowpass DCT; nr: the noise
    reduction strength, with nr_state the carried (sums, counts)
    (_nr_state_init); qp_ctu: the (ncty, nctx) per-CTU QP map at the
    scan size (dQP) or None; seed16: the (h // 16, w // 16, 2) int32
    full-pel seeds of analysis reuse, or None.
    Returns (fields, next references, next NR state or None): fields =
    (depth8, mv8, cf_y, cf_cb, cf_cr, intra8, imode8, tusplit8, ref8,
    sao, rec_y, rec_cb, rec_cr), sao (3, ncty, nctx, 6) int32 or
    None."""
    dev = oy.device
    lam = float(lambda_from_qp(qp))
    lam2 = float(lambda2_from_qp(qp))
    h, w = oy.shape
    rh, rw = real_h, real_w
    calib = calib_for_qp(qp)
    ry_s, rcb_s, rcr_s = refs

    # --- dense hierarchical ME: one window gather per 16-region (n=8
    # and n=16) + one per 32-block
    lam_i = int(round(lam))
    coarse_pen = max(int(round(lam)) >> 2, 1)
    pad_y = 2 * me_range + 8
    pad_c = me_range + 8
    weighted = wvec is not None
    oy_s = inverse_weight_plane(oy, wvec[0], wvec[1], weight_denom,
                                bit_depth) if weighted else oy
    if seed16 is not None:
        # analysis reuse (readAnalysisFile analog, encoder.cpp:4324): a
        # prior pass's full-pel MVs replace the coarse search, and every
        # block predicts from reference 0 (no multi-reference selection)
        nsel = 1
        cmv16, cmv32 = seed16, None
        ref16 = torch.zeros((h // 16, w // 16), dtype=torch.int32,
                            device=dev)
        ref32 = torch.zeros((h // 32, w // 32), dtype=torch.int32,
                            device=dev)
        zy = {16: ry_s[0], 32: ry_s[0]}
        zc = {16: (rcb_s[0], rcr_s[0]), 32: (rcb_s[0], rcr_s[0])}
    else:
        nsel = nrefs
        cmv16, cmv32, ref16, ref32, zy, zc = _select_refs(
            oy_s, ry_s, rcb_s, rcr_s, lam_i, coarse_pen, nrefs)
    # the references stacked vertically, one padded plane per component
    # windows in the narrow sample type (uint8, uint16 at 10 bits)
    win_dt = pixel_dtype(bit_depth)
    ry_pad = torch.cat([pad_ref(p.to(win_dt), pad_y) for p in ry_s])
    cpad2 = torch.stack([
        torch.cat([pad_ref(p.to(win_dt), pad_c) for p in planes])
        for planes in (rcb_s, rcr_s)])
    refs_grid = {8: _up(ref16, 2)[:h // 8, :w // 8], 16: ref16, 32: ref32}
    # the selections; with one reference they are all 0, which None
    # says without the weights' per-block masks
    sel = dict(ref16=ref16.reshape(-1), ref32=ref32.reshape(-1)) \
        if nsel > 1 else {}
    meres, seeds = me_all_sizes(oy, ry_pad, cmv16, lam_i, radius=me_range,
                                pad=pad_y, bit_depth=bit_depth,
                                cur_search=oy_s if weighted else None,
                                wvec=wvec, weight_denom=weight_denom,
                                ref_stride=h + 2 * pad_y, cmv32=cmv32,
                                zero_planes=zy, **sel)
    mvs = {n: meres[n][0] for n in SIZES}
    preds = {n: meres[n][2] for n in SIZES}

    # --- windowed chroma predictions for every size
    cpreds = _chroma_preds_windowed(
        cpad2, pad_c, rcb_s[0], rcr_s[0], mvs, seeds, me_range, h, w,
        bit_depth, wvec=wvec, weight_denom=weight_denom,
        cstride=h // 2 + 2 * pad_c, zplanes=zc, **sel)

    # --- intra candidate estimate (orig refs) so intra competes in the
    # depth decision; a 1.25x margin for its optimism
    # the 8x8 intra candidates quantise at their CTU's QP
    qv8, qcv8 = _qp_vec_of(qp, qpc, qp_ctu, h // 8, w // 8, 8, ctu)
    if intra_ii:
        imode_est, icost8 = _intra8_est(
            oy, ocb, ocr, lam_i, lam2, qv8, qcv8, ctu, rh, rw, bit_depth,
            sign_hiding, calib, psy_rd=psy_rd)
        icost8_m = icost8 * _f32(1.25, dev)
    else:
        icost8_m = None

    res = _mc_recon_all(
        oy, ocb, ocr, mvs, lam2, qp, qpc, bit_depth, sign_hiding, rh, rw,
        preds=preds, cpreds=cpreds, refs_grid=refs_grid, nrefs=nsel,
        psy_rd=psy_rd, rqt=rqt, alt8_cost=icost8_m, ctu=ctu, rdoq=rdoq,
        lowpass=lowpass,
        nr_offsets=_nr_offsets(nr_state, nr) if nr else None,
        qp_ctu=qp_ctu)
    if nr:
        res, accum = res
        nr_state = _nr_update(nr_state, accum)
    (rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr, depth8, mv8, tusplit8,
     ref8, intra_pref, inter_c8) = res

    if intra_ii:
        (rec_y, rec_cb, rec_cr, cf_y, cf_cb, cf_cr, intra8,
         imode8) = _intra_in_inter(
            oy, ocb, ocr, rec_y, rec_cb, rec_cr, cf_y, cf_cb, cf_cr,
            depth8, intra_pref, imode_est, qv8, qcv8, ctu, rh, rw, bit_depth,
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
        qp8 = None if qp_ctu is None else _effective_qp8(
            qp_ctu, cf_y, cf_cb, cf_cr, qp, ctu, rh, rw)
        ry_c = deblock_luma_t(ry_c.contiguous(), vbs, hbs, qp, bit_depth,
                              qp8=qp8)
        if intra_ii:
            # chroma filters only bs == 2 edges (intra boundaries)
            rcb_c = deblock_chroma_t(rcb_c.contiguous(), vbs, hbs, qp,
                                     bit_depth, qp8=qp8)
            rcr_c = deblock_chroma_t(rcr_c.contiguous(), vbs, hbs, qp,
                                     bit_depth, qp8=qp8)
    sao_p = None
    if sao:
        p_y = choose_sao_t(oy[:rh, :rw], ry_c, ctu, qp, bit_depth, lam2,
                           fused=True)
        p_cb, p_cr = choose_sao_chroma_t(
            ocb[:rh // 2, :rw // 2], rcb_c, ocr[:rh // 2, :rw // 2], rcr_c,
            ctu // 2, qp, bit_depth, lam2, fused=True)
        ry_c = apply_sao_t(ry_c, p_y, ctu, bit_depth)
        rcb_c = apply_sao_t(rcb_c, p_cb, ctu // 2, bit_depth)
        rcr_c = apply_sao_t(rcr_c, p_cr, ctu // 2, bit_depth)
        sao_p = torch.stack([p_y, p_cb, p_cr])

    # --- re-pad the filtered picture as the next reference: it enters
    # slot 0 and the oldest drops out
    rec = (edge_pad(ry_c, h, w), edge_pad(rcb_c, h // 2, w // 2),
           edge_pad(rcr_c, h // 2, w // 2))
    nxt = tuple(torch.cat([p[None], s_[:-1]]) for p, s_ in zip(rec, refs))
    fields = (depth8.to(torch.uint8), mv8, cf_y, cf_cb, cf_cr,
              intra8.to(torch.uint8), imode8, tusplit8.to(torch.uint8),
              ref8.to(torch.uint8), sao_p) + rec
    return fields, nxt, (nr_state if nr else None)


# =============================================================================
# submit / collect
# =============================================================================

class PgopPending:
    """Device work enqueued for one P chunk (submit/collect split)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


B_CTU64 = ("B frames at CTU 64: waits for a reference whose CTU-64 B "
           "streams decode (ROADMAP queue 1 item 28)")
MAIN10_SAO = ("SAO at 10 bits: waits for a reference whose 10-bit SAO "
              "streams decode (its coder writes sao_offset_abs with the "
              "8-bit cMax 7; ROADMAP queue 1 item 31); use --no-sao")


def check_main10_sao(cfg: EncoderConfig) -> None:
    """Refuse SAO at 10 bits (ROADMAP queue 1 item 31)."""
    if cfg.bit_depth != 8 and cfg.sao:
        raise NotImplementedError(MAIN10_SAO)


def ctu_grid(qp_map: np.ndarray, ry: int, rx: int) -> np.ndarray:
    """A per-CTU QP map clipped to 0..51 and fitted to an (ry, rx) CTU
    grid: the lookahead's maps come on the floor-16 grid, so a ragged
    frame (and the scan's padding) repeats the last row and column."""
    qp_map = np.clip(np.asarray(qp_map, np.int32), 0, 51)
    if qp_map.shape == (ry, rx):
        return qp_map
    full = np.empty((ry, rx), np.int32)
    sy = min(qp_map.shape[0], ry)
    sx = min(qp_map.shape[1], rx)
    full[:sy, :sx] = qp_map[:sy, :sx]
    full[sy:, :sx] = full[sy - 1:sy, :sx]
    full[:, sx:] = full[:, sx - 1:sx]
    return full


def check_pgop_config(cfg: EncoderConfig) -> None:
    """Raise for every option the P-chunk path of this package does not
    implement (NotImplementedError naming its ROADMAP queue item)."""
    check_main10_sao(cfg)
    if cfg.bframes > 0 and cfg.ctu_size == 64:
        raise NotImplementedError(B_CTU64)


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

    orig_y: (F, H, W) uint8 planes (uint16 at 10 bits) at the coded
    (8-aligned) size; ref:
    the post-filter recon of the preceding frame, a host ReconFrame or
    a DeviceRef (used in place), or the DeviceRef stack of the R =
    cfg.num_refs most recent pictures (a single picture is broadcast to
    the R slots: the duplicates are never selected). weights: (F, 6)
    int32 weightp vectors. The final reference (PgopPending.last_ref,
    the DeviceRef stack) can chain the next submit at once. qp_maps:
    (F, ncty, nctx) per-CTU QP maps (dQP), clipped to 0..51 and
    edge-extended to the scan's CTU grid; flat at qp when
    cfg.dqp_enabled and none are given. Each frame's coded map is
    syn.qp_map. seeds16: (F, by16, bx16, 2) full-pel MVs of an earlier
    pass (analysis reuse) that replace the coarse search; with them
    every block predicts from reference 0."""
    check_pgop_config(cfg)
    dev = resolve_device(device)
    if isinstance(ref, DeviceRef) and ref.y.device.type != dev.type:
        raise ValueError(f"reference on {ref.y.device}, device {dev} "
                         f"requested")
    f, h, w = orig_y.shape
    m = max(32, cfg.ctu_size)        # scan grids are CTU multiples
    hp = (h + m - 1) // m * m
    wp = (w + m - 1) // m * m
    qp = cfg.qp if qp is None else qp
    qpc = chroma_qp(qp)
    src_dt = np_pixel_dtype(cfg.bit_depth)

    def upload(planes, ph, pw):
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(planes).astype(src_dt, copy=False))).to(dev)
        return [edge_pad(t[i], ph, pw).to(torch.int32) for i in range(f)]

    oys = upload(orig_y, hp, wp)
    ocbs = upload(orig_cb, hp // 2, wp // 2)
    ocrs = upload(orig_cr, hp // 2, wp // 2)
    if isinstance(ref, DeviceRef):
        planes = (ref.y, ref.cb, ref.cr)
    else:
        planes = tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(p)[:hh, :ww].astype(src_dt))).to(dev)
            for p, hh, ww in ((ref.y, h, w), (ref.cb, h // 2, w // 2),
                              (ref.cr, h // 2, w // 2)))
    nrefs = cfg.num_refs
    if planes[0].dim() == 2:
        # a single picture starts the R-slot stack
        planes = tuple(p.expand(nrefs, *p.shape) for p in planes)
    elif planes[0].shape[0] != nrefs:
        raise ValueError(f"a stack of {planes[0].shape[0]} references, "
                         f"num_refs {nrefs}")
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
    ctu = cfg.ctu_size
    ncty_p, nctx_p = hp // ctu, wp // ctu
    if qp_maps is None and cfg.dqp_enabled:
        # the PPS signals cu_qp_delta: every slice codes (zero) deltas
        qp_maps = np.full((f, (h + ctu - 1) // ctu, (w + ctu - 1) // ctu),
                          qp, np.int32)
    qmj = None
    if qp_maps is not None:
        # maps on the lookahead's floor-16 grid, or on the coded CTU
        # grid, are edge-extended to the scan's padded CTU grid
        qmj = np.stack([ctu_grid(m, ncty_p, nctx_p) for m in qp_maps])
        qmaps_t = torch.as_tensor(qmj, device=dev)
    seeds_t = None
    if seeds16 is not None:
        # (F, by16, bx16, 2) seeds at the coded size, zero-padded to the
        # scan's 16-grid
        sj = np.zeros((f, hp // 16, wp // 16, 2), np.int32)
        sv = np.asarray(seeds16, np.int32)
        sj[:, :sv.shape[1], :sv.shape[2]] = sv[:, :hp // 16, :wp // 16]
        seeds_t = torch.as_tensor(sj, device=dev)
    outs = []
    # the NR state starts at zero on every submit, as the reference's
    # scan starts its carry
    nr = int(cfg.nr_inter)
    nr_state = _nr_state_init(dev) if nr else None
    for i in range(f):
        fields, cur, nr_state = _pgop_frame(
            cur, oys[i], ocbs[i], ocrs[i], None if wv is None else wv[i],
            qp=int(qp), qpc=int(qpc), bit_depth=cfg.bit_depth, real_h=h,
            real_w=w, ctu=cfg.ctu_size, deblock=cfg.deblock, sao=cfg.sao,
            sign_hiding=cfg.sign_hiding, me_range=int(me_range),
            intra_ii=cfg.intra_in_inter, psy_rd=float(cfg.psy_rd),
            weight_denom=6, rqt=bool(cfg.rqt_inter), nrefs=nrefs,
            rdoq=bool(cfg.rdoq), lowpass=bool(cfg.lowpass_dct), nr=nr,
            nr_state=nr_state, qp_ctu=None if qmj is None else qmaps_t[i],
            seed16=None if seeds_t is None else seeds_t[i])
        outs.append(fields)
    rdt = pixel_dtype(cfg.bit_depth)
    last_ref = DeviceRef(*(p[..., :hh, :ww].to(rdt).contiguous()
                           for p, hh, ww in ((cur[0], h, w),
                                             (cur[1], h // 2, w // 2),
                                             (cur[2], h // 2, w // 2))))
    return PgopPending(outs=outs, f=f, h=h, w=w, need_recon=need_recon,
                       last_ref=last_ref, qmj=qmj, ctu=ctu)


def collect_pgop_gpu(p: PgopPending):
    """Download one submitted chunk: per frame a FramePSyntax (host
    arrays cropped to the coded size; ref8 None where every refIdx is
    0; sao_params (p_y, p_cb, p_cr) with SAO on) and, when requested,
    a host ReconFrame. Returns (syns, recons, last_ref)."""
    h, w = p.h, p.w
    n8y, n8x = h // 8, w // 8
    syns, recons = [], []
    for i, fields in enumerate(p.outs):
        (depth8, mv8, cf_y, cf_cb, cf_cr, intra8, imode8, tusplit8, ref8,
         sao_p, ry, rcb, rcr) = fields
        small = [t[:n8y, :n8x].cpu().numpy()
                 for t in (depth8, intra8, imode8, tusplit8, ref8)]
        depth8_np, intra8_np, imode8_np, tus_np, ref8_np = small
        syn = FramePSyntax(
            depth8=np.ascontiguousarray(depth8_np),
            mv8=mv8[:n8y, :n8x].cpu().numpy().astype(np.int32),
            coeff_y=cf_y[:h, :w].to(torch.int16).cpu().numpy(),
            coeff_cb=cf_cb[:h // 2, :w // 2].to(torch.int16).cpu().numpy(),
            coeff_cr=cf_cr[:h // 2, :w // 2].to(torch.int16).cpu().numpy(),
            tusplit8=np.ascontiguousarray(tus_np) if tus_np.any() else None,
            ref8=np.ascontiguousarray(ref8_np) if ref8_np.any() else None)
        if sao_p is not None:
            syn.sao_params = tuple(sao_p.cpu().numpy())
        if p.qmj is not None:
            syn.qp_map = p.qmj[i, :(h + p.ctu - 1) // p.ctu,
                               :(w + p.ctu - 1) // p.ctu]
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
