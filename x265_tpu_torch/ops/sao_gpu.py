"""Sample adaptive offset on the device: statistics, the per-CTU
parameter decision and its application, as plain torch ops.

Counterpart of x265_tpu/ops/sao_tpu.py (x265 source/encoder/sao.cpp
calcSaoStatsCu / rdoSaoUnitCu / applyPixelOffsets). SAO is an in-loop
filter: its output is the next frame's reference, so it runs on the
device between the frames of a P chunk. Statistics are whole-plane
reductions per CTU; the decision is an argmin over the 4 EO classes,
then the 32 BO positions, against OFF, with strict < in that order (the
first of equal costs wins).

Exactness: offsets divide int32 sums by int32 counts in float32 and
round half to even (torch.round, as jnp.round); costs are float32 with
the python-float lambda entering as float32; rolled neighbours wrap
around and the validity masks hide the wrapped samples.
"""

from __future__ import annotations

import torch

from .fma import fma32

EO_SHIFTS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))
F32 = torch.float32


def eo_cat_all(rec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel EO category for all 4 classes: (4, H, W) int32 in 0..4
    (0 = unclassified or border), and the validity masks (4, H, W)."""
    h, w = rec.shape
    dev = rec.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    cats, valids = [], []
    for dy0, dx0, dy1, dx1 in EO_SHIFTS:
        n0 = torch.roll(rec, (-dy0, -dx0), dims=(0, 1))
        n1 = torch.roll(rec, (-dy1, -dx1), dims=(0, 1))
        edge = torch.sign(rec - n0) + torch.sign(rec - n1)
        # edge -2, -1, 1, 2 -> categories 1, 2, 3, 4; 0 stays 0
        cat = torch.where(edge < 0, edge + 3,
                          torch.where(edge > 0, edge + 2, 0))
        valid = ((yy + dy0 >= 0) & (yy + dy0 < h) & (xx + dx0 >= 0) &
                 (xx + dx0 < w) & (yy + dy1 >= 0) & (yy + dy1 < h) &
                 (xx + dx1 >= 0) & (xx + dx1 < w))
        cats.append(torch.where(valid, cat, 0).to(torch.int32))
        valids.append(valid)
    return torch.stack(cats), torch.stack(valids)


def _pad_ctu(p: torch.Tensor, ctu: int, value: int = 0):
    """Pad the plane with `value` to CTU multiples; returns (padded,
    ncty, nctx)."""
    h, w = p.shape
    ncty, nctx = (h + ctu - 1) // ctu, (w + ctu - 1) // ctu
    out = torch.full((ncty * ctu, nctx * ctu), value, dtype=p.dtype,
                     device=p.device)
    out[:h, :w] = p
    return out, ncty, nctx


def _ctu_sum(a: torch.Tensor, ncty: int, nctx: int, ctu: int):
    return a.reshape(ncty, ctu, nctx, ctu).sum((1, 3), dtype=torch.int32)


def sao_stats_t(orig: torch.Tensor, rec: torch.Tensor, ctu: int,
                bit_depth: int):
    """Per-CTU EO sums and counts (4 classes, 4 categories, ncty, nctx)
    and BO sums and counts (32 bands, ncty, nctx) of orig - rec."""
    diff = (orig - rec).to(torch.int32)
    cats, _ = eo_cat_all(rec)
    dpad, ncty, nctx = _pad_ctu(diff, ctu)
    eo_sum, eo_cnt = [], []
    for cls in range(4):
        cpad, _, _ = _pad_ctu(cats[cls], ctu)
        for k in range(4):
            m = (cpad == k + 1).to(torch.int32)
            eo_sum.append(_ctu_sum(dpad * m, ncty, nctx, ctu))
            eo_cnt.append(_ctu_sum(m, ncty, nctx, ctu))
    eo_sum = torch.stack(eo_sum).reshape(4, 4, ncty, nctx)
    eo_cnt = torch.stack(eo_cnt).reshape(4, 4, ncty, nctx)
    # padding samples get band 32, which matches no band
    bpad, _, _ = _pad_ctu((rec >> (bit_depth - 5)).to(torch.int32), ctu, 32)
    bsum, bcnt = [], []
    for b in range(32):
        m = (bpad == b).to(torch.int32)
        bsum.append(_ctu_sum(dpad * m, ncty, nctx, ctu))
        bcnt.append(_ctu_sum(m, ncty, nctx, ctu))
    return eo_sum, eo_cnt, torch.stack(bsum), torch.stack(bcnt)


def _best_offset_t(s, c, sign: int, max_off: int):
    """Rounded mean offset per category, clipped by sign, and its
    distortion change c*o^2 - 2*o*s as float32."""
    o = torch.where(c > 0, torch.round(s / torch.clamp(c, min=1)), 0.0) \
        .to(torch.int32)
    if sign > 0:
        o = torch.clamp(o, 0, max_off)
    elif sign < 0:
        o = torch.clamp(o, -max_off, 0)
    else:
        o = torch.clamp(o, -max_off, max_off)
    return o, (c * o * o - 2 * o * s).to(F32)


def _params(typ: int, cls_or_pos, offs: torch.Tensor) -> torch.Tensor:
    """(ncty, nctx, 6) int32 [type, class_or_band, o0..o3] from offs
    (4, ncty, nctx)."""
    _, ncty, nctx = offs.shape
    head = torch.empty((2, ncty, nctx), dtype=torch.int32,
                       device=offs.device)
    head[0] = typ
    head[1] = cls_or_pos
    return torch.cat([head, offs.to(torch.int32)]).permute(1, 2, 0)


def _cost(dd: torch.Tensor, lam: float, bits: torch.Tensor,
          fused: bool) -> torch.Tensor:
    """dd + lam * bits in float32: rounded once when fused (the
    reference's jitted P and B frame bodies contract it into an FMA),
    the product first otherwise (its I frame runs the choice op by
    op)."""
    if fused:
        return fma32(dd, lam, bits.to(F32))
    return dd + lam * bits


def choose_sao_t(orig: torch.Tensor, rec: torch.Tensor, ctu: int, qp: int,
                 bit_depth: int, lam: float, fused: bool = False,
                 costs: list | None = None) -> torch.Tensor:
    """Per-CTU SAO decision for one plane -> (ncty, nctx, 6) int32
    [type, class_or_band, o0..o3]. fused: the RD costs round as in the
    reference's jitted frame bodies (_cost). costs, when given,
    receives each candidate's cost plane in the order they are tried."""
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1
    eo_sum, eo_cnt, bsum, bcnt = sao_stats_t(orig, rec, ctu, bit_depth)
    ncty, nctx = eo_sum.shape[2:]
    dev = rec.device
    best_cost = torch.zeros((ncty, nctx), dtype=F32, device=dev)  # OFF
    params = torch.zeros((ncty, nctx, 6), dtype=torch.int32, device=dev)
    for cls in range(4):
        offs = []
        dd = torch.zeros((ncty, nctx), dtype=F32, device=dev)
        for k in range(4):
            o, d = _best_offset_t(eo_sum[cls, k], eo_cnt[cls, k],
                                  1 if k < 2 else -1, max_off)
            offs.append(o)
            dd = dd + d
        offs = torch.stack(offs)
        bits = 2 + torch.abs(offs).sum(0, dtype=torch.int32) + 2
        cost = _cost(dd, lam, bits, fused)
        if costs is not None:
            costs.append(cost)
        better = cost < best_cost
        params = torch.where(better[..., None], _params(2, cls, offs), params)
        best_cost = torch.where(better, cost, best_cost)

    bo, bdd = _best_offset_t(bsum, bcnt, 0, max_off)     # (32, ...)
    for pos in range(32):
        ks = [(pos + k) & 31 for k in range(4)]
        dd = bdd[ks[0]] + bdd[ks[1]] + bdd[ks[2]] + bdd[ks[3]]
        offs = torch.stack([bo[k] for k in ks])
        bits = 2 + torch.abs(offs).sum(0, dtype=torch.int32) + \
            (offs != 0).sum(0, dtype=torch.int32) + 5
        cost = _cost(dd, lam, bits, fused)
        if costs is not None:
            costs.append(cost)
        better = cost < best_cost
        params = torch.where(better[..., None], _params(1, pos, offs), params)
        best_cost = torch.where(better, cost, best_cost)
    return params


def choose_sao_chroma_t(orig_cb, rec_cb, orig_cr, rec_cr, ctu: int, qp: int,
                        bit_depth: int, lam: float, fused: bool = False):
    """Joint cb/cr decision: a shared type and EO class, per-component
    offsets and band positions; fused as in choose_sao_t. Returns
    (p_cb, p_cr)."""
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1
    s_cb = sao_stats_t(orig_cb, rec_cb, ctu, bit_depth)
    s_cr = sao_stats_t(orig_cr, rec_cr, ctu, bit_depth)
    ncty, nctx = s_cb[0].shape[2:]
    dev = rec_cb.device
    best_cost = torch.zeros((ncty, nctx), dtype=F32, device=dev)
    p_cb = torch.zeros((ncty, nctx, 6), dtype=torch.int32, device=dev)
    p_cr = torch.zeros((ncty, nctx, 6), dtype=torch.int32, device=dev)
    for cls in range(4):
        offs_cb, offs_cr = [], []
        dd = torch.zeros((ncty, nctx), dtype=F32, device=dev)
        for k in range(4):
            sign = 1 if k < 2 else -1
            o, d = _best_offset_t(s_cb[0][cls, k], s_cb[1][cls, k], sign,
                                  max_off)
            offs_cb.append(o)
            dd = dd + d
            o, d = _best_offset_t(s_cr[0][cls, k], s_cr[1][cls, k], sign,
                                  max_off)
            offs_cr.append(o)
            dd = dd + d
        offs_cb = torch.stack(offs_cb)
        offs_cr = torch.stack(offs_cr)
        bits = 2 + 2 + torch.abs(offs_cb).sum(0, dtype=torch.int32) + \
            torch.abs(offs_cr).sum(0, dtype=torch.int32)
        cost = _cost(dd, lam, bits, fused)
        better = cost < best_cost
        p_cb = torch.where(better[..., None], _params(2, cls, offs_cb), p_cb)
        p_cr = torch.where(better[..., None], _params(2, cls, offs_cr), p_cr)
        best_cost = torch.where(better, cost, best_cost)

    def best_window(s):
        bo, bdd = _best_offset_t(s[2], s[3], 0, max_off)
        cost = torch.full((ncty, nctx), float("inf"), dtype=F32, device=dev)
        pos_b = torch.zeros((ncty, nctx), dtype=torch.int32, device=dev)
        offs_b = torch.zeros((4, ncty, nctx), dtype=torch.int32, device=dev)
        for p in range(32):
            ks = [(p + k) & 31 for k in range(4)]
            dd = bdd[ks[0]] + bdd[ks[1]] + bdd[ks[2]] + bdd[ks[3]]
            o = torch.stack([bo[k] for k in ks])
            bits = torch.abs(o).sum(0, dtype=torch.int32) + \
                (o != 0).sum(0, dtype=torch.int32) + 5
            c = _cost(dd, lam, bits, fused)
            better = c < cost
            cost = torch.where(better, c, cost)
            pos_b = torch.where(better, p, pos_b)
            offs_b = torch.where(better[None], o, offs_b)
        return cost, pos_b, offs_b

    c_cb, pos_cb, o_cb = best_window(s_cb)
    c_cr, pos_cr, o_cr = best_window(s_cr)
    better = (c_cb + c_cr + lam * 2) < best_cost
    p_cb = torch.where(better[..., None], _params(1, pos_cb, o_cb), p_cb)
    p_cr = torch.where(better[..., None], _params(1, pos_cr, o_cr), p_cr)
    return p_cb, p_cr


def apply_sao_t(rec: torch.Tensor, params: torch.Tensor, ctu: int,
                bit_depth: int) -> torch.Tensor:
    """Apply per-CTU SAO parameters (ncty, nctx, 6) to one int32
    plane."""
    h, w = rec.shape
    maxv = (1 << bit_depth) - 1

    def px(a):
        """(ncty, nctx, ...) -> per pixel, cropped to (h, w)."""
        return a.repeat_interleave(ctu, 0).repeat_interleave(ctu, 1)[:h, :w]

    typ = px(params[..., 0])
    clsband = px(params[..., 1])
    offs = px(params[..., 2:6])                      # (h, w, 4)
    cats, _ = eo_cat_all(rec)
    cat = torch.gather(cats, 0, torch.clamp(clsband, 0, 3).long()[None])[0]
    band_rel = ((rec >> (bit_depth - 5)) - clsband) & 31
    eo_add = torch.zeros((h, w), dtype=torch.int32, device=rec.device)
    bo_add = torch.zeros((h, w), dtype=torch.int32, device=rec.device)
    for k in range(4):
        eo_add = eo_add + torch.where(cat == k + 1, offs[..., k], 0)
        bo_add = bo_add + torch.where(band_rel == k, offs[..., k], 0)
    add = torch.where(typ == 2, eo_add, torch.where(typ == 1, bo_add, 0))
    return torch.clamp(rec + add, 0, maxv)
