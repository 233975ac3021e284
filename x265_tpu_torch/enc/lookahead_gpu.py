"""The device lookahead: lowres costs, AQ and cuTree -> per-CTU QP.

Counterpart of x265_tpu/enc/lookahead_tpu.py (x265 slicetype.cpp):
  - per-16x16 AC-energy adaptive quantisation, modes 1-3
    (calcAdaptiveQuantFrame, acEnergyVar);
  - half-res (lowres) planes with a per-8x8-block intra SATD estimate
    over all 35 modes (lowresIntraEstimate) and an inter SATD from a
    full search of every integer candidate within radius 12 of the
    previous frame (estimateCUCost);
  - cuTree: the propagate pool flows backward along the motion field
    with a bilinear scatter-add (estimateCUPropagate, cuTreeFinish).
The 16x16 full-res AQ grid and the 8x8 lowres cost grid coincide.

Exactness: the decisions are integers (the search's SADs and first
candidate in raster order, the intra SA8D minimum) and match the
reference bit for bit. AQ and cuTree are float32, in the reference's
order of operations: the block sums are exact integers below 2^24, a
division by a constant multiplies by its float32 reciprocal, exp2(k)
is exp(k * ln2) with the product rounded to float32, a multiply-add
that the reference's compiler contracts rounds once (fma32). So that
the card computes what the CPU does, the transcendental functions run
in float64 and round once to float32, and the frame and CTU means sum
their float32 terms in float64 (exactly, at these magnitudes) and round
once; the reference's own approximations and summation order may put
its offsets an ulp or so away, and its QP maps, np.round(base_qp +
offset), differ only where an offset lies within that of a half. The
scatter adds each target's contributions one at a time, in the order
of their sources, pass after pass, as the reference's serial scatter
does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from .intra_recon import np_pixel_dtype
from ..ops.fma import fma32
from ..ops.intra import intra_pred_all_modes
from ..ops.satd import sa8d_batch

F32 = torch.float32


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(float(np.float32(x)), dtype=F32, device=device)


def _once(fn, *xs) -> torch.Tensor:
    """fn of float32 tensors in float64, rounded once to float32."""
    return fn(*(x.to(torch.float64) for x in xs)).to(F32)


def _sum32(x: torch.Tensor, dims=None) -> torch.Tensor:
    """A float32 sum taken exactly in float64 and rounded once."""
    x = x.to(torch.float64)
    return (x.sum() if dims is None else x.sum(dims)).to(F32)


# =============================================================================
# AQ: per-16x16 AC energy -> QP offsets
# =============================================================================

def _block_var(plane: torch.Tensor, n: int, shift: int) -> torch.Tensor:
    """acEnergyVar analog: per n x n block, ssd - sum^2 >> shift in
    float32 (the sums are exact integers)."""
    h, w = plane.shape
    by, bx = h // n, w // n
    p = plane[:by * n, :bx * n].to(torch.int64).reshape(by, n, bx, n)
    s = p.sum((1, 3)).to(F32)
    ssd = (p * p).sum((1, 3)).to(F32)
    return ssd - s * s * (1.0 / (1 << shift))


def aq_offsets(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               aq_mode: int, aq_strength: float, bit_depth: int):
    """Per-16x16-block qpAqOffset and invQscaleFactor (Q8), float32.
    Modes: 1 variance, 2 auto-variance, 3 auto-variance biased to dark
    scenes (slicetype.cpp:530-600)."""
    dev = y.device
    e = _block_var(y, 16, 8) + _block_var(cb, 8, 6) + _block_var(cr, 8, 6)
    st = _f32(aq_strength, dev)
    if aq_mode == 1:
        strength = st * _f32(1.0397, dev)
        log2e = _once(torch.log, torch.clamp(e, min=1.0)) * \
            _f32(1.0 / math.log(2.0), dev)
        adj = strength * (log2e - _f32(14.427 + 2.0 * (bit_depth - 8), dev))
    else:
        corr = 1.0 / (1 << (2 * (bit_depth - 8)))
        t = _once(torch.pow, e * corr + 1.0, _f32(0.1, dev))
        inv_n = _f32(1.0 / t.numel(), dev)
        avg = _sum32(t) * inv_n
        avg2 = _sum32(t * t) * inv_n
        strength = st * avg
        avg_c = avg - 0.5 * (avg2 - 11.0) / avg
        adj = strength * (t - avg_c)
        if aq_mode == 3:
            adj = fma32(adj, st, 1.0 - 11.0 / (t * t))
    # x265_exp2fix8 analog: the Q8 QP -> qscale factor
    k = -adj * _f32(1.0 / 6.0, dev)
    invq = torch.clamp(torch.round(
        256.0 * _once(torch.exp, k * _f32(math.log(2.0), dev))), 0.0,
        65535.0)
    return adj, invq


# =============================================================================
# lowres costs: per-8x8-block intra SATD, inter SATD/MV against the
# previous frame
# =============================================================================

def lowres_plane(y: torch.Tensor) -> torch.Tensor:
    """Half-res by a 2x2 box filter (frameInitLowres analog)."""
    h, w = y.shape
    p = y[:h // 2 * 2, :w // 2 * 2].to(torch.int32)
    return (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] +
            p[1::2, 1::2] + 2) >> 2


def _lowres_blocks(lw: torch.Tensor, n: int = 8):
    h, w = lw.shape
    by, bx = h // n, w // n
    blk = lw[:by * n, :bx * n].reshape(by, n, bx, n).permute(0, 2, 1, 3) \
        .reshape(-1, n, n)
    return blk, by, bx


def _block_origins(by: int, bx: int, n: int, device):
    x0 = (torch.arange(bx, device=device) * n).repeat(by)
    y0 = (torch.arange(by, device=device) * n).repeat_interleave(bx)
    return x0, y0


def lowres_intra_cost(lw: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Per-8x8 lowres block: the least SA8D over the 35 intra modes + 5,
    predicted from clamped (edge-substituted) neighbours. (by, bx)
    float32."""
    n = 8
    dev = lw.device
    blk, by, bx = _lowres_blocks(lw, n)
    h, w = lw.shape
    x0, y0 = _block_origins(by, bx, n, dev)
    ks = torch.arange(2 * n, device=dev)
    ly = torch.clamp(y0[:, None] + (2 * n - 1 - ks)[None, :], 0, h - 1)
    lx = torch.clamp(x0[:, None] - 1, 0, w - 1).expand_as(ly)
    ty = torch.clamp(y0[:, None] - 1, 0, h - 1).expand(-1, 2 * n)
    tx = torch.clamp(x0[:, None] + ks[None, :], 0, w - 1)
    corner = lw[torch.clamp(y0 - 1, 0, h - 1), torch.clamp(x0 - 1, 0, w - 1)]
    refs = torch.cat([lw[ly, lx], corner[:, None], lw[ty, tx]], 1)
    preds = intra_pred_all_modes(refs, n, is_luma=True,
                                 bit_depth=bit_depth)   # (B, 35, 8, 8)
    costs = sa8d_batch(blk[:, None] - preds)            # (B, 35)
    best = torch.amin(costs, 1) + 5
    return best.reshape(by, bx).to(F32)


def lowres_inter_cost(lw_cur: torch.Tensor, lw_ref: torch.Tensor,
                      radius: int = 12):
    """Per-8x8 block full-pel full search on lowres planes: the SAD +
    2 (|dx| + |dy|) of every candidate within `radius` of an
    edge-padded reference, the first least in raster order (dy, then
    dx) winning; then SA8D at the winner. One dy row of candidates per
    step (a strided view of the padded reference). Returns (cost
    (by, bx) float32 = SA8D + |mv|, mv (by, bx, 2) int32 in qpel)."""
    n = 8
    dev = lw_cur.device
    h, w = lw_cur.shape
    blk, by, bx = _lowres_blocks(lw_cur, n)
    side = 2 * radius + 1
    cur = lw_cur[:by * n, :bx * n].to(torch.int32)
    ref = lw_ref.to(torch.int32)
    pad = torch.cat([ref[:1].expand(radius, -1), ref,
                     ref[-1:].expand(radius, -1)])
    pad = torch.cat([pad[:, :1].expand(-1, radius), pad,
                     pad[:, -1:].expand(-1, radius)], 1)
    dxs = torch.arange(side, device=dev) - radius
    best = best_i = None
    for r in range(side):
        band = pad[r:r + by * n, :bx * n + side - 1]
        sh = band.unfold(1, bx * n, 1)                 # (rows, side, cols)
        ad = torch.abs(cur[:, None, :] - sh)
        sad = ad.reshape(by, n, side, bx, n).sum((1, 4), dtype=torch.int32)
        cost = sad.permute(1, 0, 2) + \
            (2 * (dxs.abs() + abs(r - radius)))[:, None, None].to(torch.int32)
        c_min, c_arg = torch.amin(cost, 0), torch.argmin(cost, 0)
        if best is None:
            best, best_i = c_min, c_arg + r * side
        else:
            better = c_min < best
            best = torch.where(better, c_min, best)
            best_i = torch.where(better, c_arg + r * side, best_i)
    mv = torch.stack([best_i % side - radius, best_i // side - radius],
                     -1).to(torch.int32)                 # (by, bx, (x, y))

    # SA8D at the winning MV (clamped gather)
    x0, y0 = _block_origins(by, bx, n, dev)
    mvf = mv.reshape(-1, 2)
    ar = torch.arange(n, device=dev)
    ys = torch.clamp(y0[:, None] + mvf[:, 1:2] + ar[None, :], 0, h - 1)
    xs = torch.clamp(x0[:, None] + mvf[:, 0:1] + ar[None, :], 0, w - 1)
    patch = ref[ys[:, :, None], xs[:, None, :]]
    satd = sa8d_batch(blk - patch).reshape(by, bx).to(F32)
    mvb = (mvf[:, 0].abs() + mvf[:, 1].abs()).reshape(by, bx).to(F32)
    return satd + mvb, mv * 4     # qpel units (8px block == 32 qpel)


# =============================================================================
# cuTree: backward propagation + finish
# =============================================================================

def _add_in_order(out: torch.Tensor, idx: torch.Tensor,
                  contrib: torch.Tensor) -> torch.Tensor:
    """out[idx[j]] += contrib[j] for j = 0, 1, ... in turn: each
    target's contributions are added one at a time in the order of j
    (the reference's serial scatter), whatever the device. A source's
    rank among those with the same target sets the round it joins;
    within a round the targets are distinct. Zero contributions change
    nothing (out and the contributions are >= +0) and are left out."""
    keep = contrib != 0
    idx, contrib = idx[keep], contrib[keep]
    if idx.numel() == 0:
        return out
    order = torch.sort(idx, stable=True).indices
    sidx = idx[order]
    pos = torch.arange(sidx.numel(), device=idx.device)
    start = torch.ones_like(sidx, dtype=torch.bool)
    start[1:] = sidx[1:] != sidx[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        t = idx[sel]
        out[t] = out[t] + contrib[sel]
    return out


def _scatter_bilinear(amount: torch.Tensor, mv: torch.Tensor
                      ) -> torch.Tensor:
    """Scatter `amount` along the motion field into the reference
    frame's block grid with bilinear weights (estimateCUPropagate's
    quad). mv is qpel; one block is 32 qpel units."""
    by, bx = amount.shape
    dev = amount.device
    gx = torch.arange(bx, device=dev)[None, :].expand(by, bx)
    gy = torch.arange(by, device=dev)[:, None].expand(by, bx)
    cux = gx + (mv[..., 0] >> 5)
    cuy = gy + (mv[..., 1] >> 5)
    fx = (mv[..., 0] & 31).to(F32)
    fy = (mv[..., 1] & 31).to(F32)
    out = torch.zeros(by * bx, dtype=F32, device=dev)
    for dy in (0, 1):
        wy = fy if dy else 32.0 - fy
        for dx in (0, 1):
            wx = fx if dx else 32.0 - fx
            tx = cux + dx
            ty = cuy + dy
            valid = ((tx >= 0) & (tx < bx) & (ty >= 0) & (ty < by)).to(F32)
            contrib = amount * wy * wx * (1.0 / 1024.0) * valid
            idx = torch.clamp(ty, 0, by - 1) * bx + torch.clamp(tx, 0, bx - 1)
            out = _add_in_order(out, idx.reshape(-1), contrib.reshape(-1))
    return out.reshape(by, bx)


def cutree_propagate_ippp(intra_c: torch.Tensor, inter_c: torch.Tensor,
                          mvs: torch.Tensor) -> torch.Tensor:
    """Backward cuTree over an IPPP chain: frame f's propagate pool
    flows into frame f - 1 along its motion field. intra_c / inter_c
    (F, by, bx) float32, pre-weighted by invQscale; mvs (F, by, bx, 2)
    int32 qpel (frame f against f - 1; index 0 unused). Returns the
    propagate cost (F, by, bx) float32."""
    f = intra_c.shape[0]
    pcs = [None] * f
    pc = torch.zeros_like(intra_c[0])
    for k in range(f - 1, 0, -1):
        pcs[k] = pc
        ic = intra_c[k]
        ec = torch.minimum(ic, inter_c[k])
        amount = (pc + ic) * (ic - ec) / torch.clamp(ic, min=1.0)
        pc = _scatter_bilinear(amount, mvs[k])
    pcs[0] = pc
    return torch.stack(pcs)


def cutree_finish(intra_c: torch.Tensor, pc: torch.Tensor,
                  invq: torch.Tensor, aq_off: torch.Tensor,
                  qcomp: float) -> torch.Tensor:
    """qpCuTreeOffset = qpAqOffset - strength * log2((ic + pc) / ic),
    ic weighted by invQscaleFactor (cuTreeFinish); strength = 5 (1 -
    qcomp)."""
    dev = intra_c.device
    strength = 5.0 * (1.0 - _f32(qcomp, dev))
    ic = intra_c * invq * (1.0 / 256.0)
    inv_ln2 = _f32(1.0 / math.log(2.0), dev)
    ratio = torch.where(
        ic > 0, _once(torch.log, ic + pc) * inv_ln2 -
        _once(torch.log, torch.clamp(ic, min=1e-9)) * inv_ln2, 0.0)
    return fma32(aq_off, -strength, ratio)


# =============================================================================
# the GOP lookahead
# =============================================================================

def lookahead_gop(ys: np.ndarray, cbs: np.ndarray, crs: np.ndarray, cfg,
                  qcomp: float = 0.6, device=None):
    """(F, H, W) planes (16-aligned) -> per-CTU QP offset maps (F, ncty,
    nctx) float32 on the floor grid, the per-16x16 offsets, and the
    per-frame lowres cost totals (intra, inter), as host arrays."""
    dev = resolve_device(device)
    f, h, w = ys.shape

    def up(a):
        # the samples keep the configured bit depth (uint16 at 10 bits)
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np_pixel_dtype(cfg.bit_depth)))).to(dev) \
            .to(torch.int32)

    ys_t, cbs_t, crs_t = up(ys), up(cbs), up(crs)
    n16y, n16x = h // 16, w // 16
    aq_mode = int(cfg.aq_mode)
    if aq_mode:
        aq, invq = (torch.stack(t) for t in zip(*(
            aq_offsets(ys_t[i], cbs_t[i], crs_t[i], aq_mode,
                       cfg.aq_strength, cfg.bit_depth) for i in range(f))))
    else:
        aq = torch.zeros((f, n16y, n16x), dtype=F32, device=dev)
        invq = torch.full((f, n16y, n16x), 256.0, dtype=F32, device=dev)

    lws = [lowres_plane(ys_t[i]) for i in range(f)]
    intra_c = torch.stack([lowres_intra_cost(lw, cfg.bit_depth)
                           for lw in lws])
    inter_c, mvs = [intra_c[0]], [torch.zeros(
        intra_c.shape[1:] + (2,), dtype=torch.int32, device=dev)]
    for i in range(1, f):
        c, mv = lowres_inter_cost(lws[i], lws[i - 1])
        inter_c.append(c)
        mvs.append(mv)
    inter_c, mvs = torch.stack(inter_c), torch.stack(mvs)

    if cfg.cutree and f > 1:
        # the pools are weighted by invQscale inside the propagate
        # amount (propagateCost: propagateIntra = intra * invq / 256)
        pcs = cutree_propagate_ippp(intra_c * invq * (1.0 / 256.0),
                                    inter_c * invq * (1.0 / 256.0), mvs)
        off16 = cutree_finish(intra_c, pcs, invq, aq, qcomp)
    else:
        off16 = aq

    # per-CTU offsets: the mean of the 16x16 offsets under each CTU
    k = cfg.ctu_size // 16
    ncty, nctx = n16y // k, n16x // k
    off_ctu = _sum32(off16[:, :ncty * k, :nctx * k]
                     .reshape(f, ncty, k, nctx, k), (2, 4)) * (1.0 / (k * k))
    return (off_ctu.cpu().numpy(), off16.cpu().numpy(),
            _sum32(intra_c, (1, 2)).cpu().numpy(),
            _sum32(inter_c, (1, 2)).cpu().numpy())
