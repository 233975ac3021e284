"""Batched intra mode + depth decision (the I-frame analysis pass).

Counterpart of x265_tpu/enc/intra_analysis.py (analyze_intra_gop,
analyze_chroma_gop): all 35 modes for all blocks of every CU size are
evaluated densely, the SATD top-3 of each block is priced at full RD
(recon SSE + lambda2 * bits), and depths are chosen bottom-up.
Decisions use original-pixel references; the conformant reconstruction
(intra_recon_gpu.py) re-predicts from decoded samples.

Float exactness: RD costs are float32 as in the reference. Sums of
integer terms (SSE, counts) are taken in int64 and cast once; the
4-child cost sums follow the reference's sequential order
(block_sum_seq).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..common.bit_calib import calib_for_qp
from ..common.tables import lambda_from_qp, lambda2_from_qp
from ..ops.intra import intra_pred_all_modes
from ..ops.me import bitlen as _bitlen_f
from ..ops.satd import sa8d_nxn_batch
from ..ops.transforms import (dct_batch, dequant_batch, idct_batch,
                              quant_batch)

# approximate signalling cost (bits) per mode: MPM-favoured modes cheap
_MODE_BITS = np.full(35, 6.0)
_MODE_BITS[[0, 1, 10, 26]] = 2.0

# SATD-preselected candidate modes carried into the full-RD stage
_RD_K = 3

# chroma candidate list (clause 8.4.3): planar/ver/hor/dc; an entry
# equal to the luma mode is replaced by angular-34
CHROMA_CAND = np.array([0, 26, 10, 1], dtype=np.int32)


def block_sum_seq(a: torch.Tensor, by: int, k: int, bx: int) -> torch.Tensor:
    """(by*k, bx*k) -> (by, bx) block sums accumulated in row-major
    order within each block — the order the reference's float32
    reductions over non-minor axes take, so non-integer costs sum to
    the same bits."""
    a4 = a[..., :by * k, :bx * k].reshape(*a.shape[:-2], by, k, bx, k)
    acc = a4[..., :, 0, :, 0]
    for u in range(k):
        for v in range(k):
            if u or v:
                acc = acc + a4[..., :, u, :, v]
    return acc


def edge_pad(p: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Edge-replicate the last axes of p to (hp, wp)."""
    h, w = p.shape[-2:]
    if (h, w) == (hp, wp):
        return p
    yi = torch.clamp(torch.arange(hp, device=p.device), max=h - 1)
    xi = torch.clamp(torch.arange(wp, device=p.device), max=w - 1)
    return p[..., yi[:, None], xi[None, :]]


def up(x: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat each cell k times along both leading axes."""
    return x.repeat_interleave(k, 0).repeat_interleave(k, 1)


def extract_blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (B, n, n) raster-ordered non-overlapping blocks."""
    h, w = plane.shape
    by, bx = h // n, w // n
    return plane.reshape(by, n, bx, n).permute(0, 2, 1, 3).reshape(-1, n, n)


@lru_cache(maxsize=None)
def _ref_index_tables(h: int, w: int, n: int):
    """Gather indices + availability for gather_refs_device."""
    by, bx = h // n, w // n
    x0 = (np.arange(bx) * n)[None, :, None]
    y0 = (np.arange(by) * n)[:, None, None]
    i = np.arange(4 * n + 1)[None, None, :]
    left = i < 2 * n
    corner = i == 2 * n
    xs = np.where(left, x0 - 1, np.where(corner, x0 - 1,
                                         x0 + (i - 2 * n - 1)))
    ys = np.where(left, y0 + (2 * n - 1 - i), np.where(corner, y0 - 1,
                                                       y0 - 1))
    avail = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
    flat = (np.clip(ys, 0, h - 1) * w + np.clip(xs, 0, w - 1))
    return (flat.reshape(by * bx, -1).astype(np.int64),
            avail.reshape(by * bx, -1))


def gather_refs_device(plane: torch.Tensor, n: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """Canonical refs R[0..4n] for every n-block from original pixels,
    availability = inside the picture, substitution = forward fill.
    (H, W) -> (B, 4n+1) int32."""
    h, w = plane.shape
    flat_np, avail_np = _ref_index_tables(h, w, n)
    dev = plane.device
    vals = plane.reshape(-1)[torch.as_tensor(flat_np, device=dev)]
    avail = torch.as_tensor(avail_np, device=dev)
    k = 4 * n + 1
    iota = torch.arange(k, device=dev).expand_as(vals)
    filled = torch.cummax(torch.where(avail, iota, -1), dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1)
    firstval = torch.gather(vals, 1, first[:, None])
    out = torch.gather(vals, 1, torch.clamp(filled, 0, k - 1))
    out = torch.where(filled >= 0, out, firstval)
    any_avail = avail.any(dim=1, keepdim=True)
    return torch.where(any_avail, out, 1 << (bit_depth - 1)) \
        .to(torch.int32)


def _rd_mode_size(plane: torch.Tensor, n: int, qp: int,
                  lam_bits: torch.Tensor, lam2: torch.Tensor,
                  abc: torch.Tensor, mode_bits: torch.Tensor,
                  bit_depth: int):
    """Full-RD intra mode decision for one CU/TU size over the frame:
    the SATD top-_RD_K modes of each block (ties: lower mode first, the
    order of jax.lax.top_k) are transformed, quantized, reconstructed
    and priced as recon SSE + lambda2 * (coefficient-bits proxy + mode
    bits). Returns (best_mode (B,), rd_cost (B,) float32)."""
    blocks = extract_blocks(plane, n)
    refs = gather_refs_device(plane, n, bit_depth)
    preds = intra_pred_all_modes(refs, n, is_luma=True,
                                 bit_depth=bit_depth)     # (B, 35, n, n)
    b = blocks.shape[0]
    satd = sa8d_nxn_batch(preds - blocks[:, None], n) + lam_bits[None, :]
    idx = torch.sort(satd, dim=1, stable=True).indices[:, :_RD_K]
    cand = torch.gather(preds.reshape(b, 35, n * n), 1,
                        idx[:, :, None].expand(b, _RD_K, n * n))
    cand = cand.reshape(b * _RD_K, n, n)
    resi = (blocks[:, None] - cand.reshape(b, _RD_K, n, n)) \
        .reshape(b * _RD_K, n, n)
    dst = n == 4                       # DST-VII for 4x4 luma intra TBs
    lv = quant_batch(dct_batch(resi, n, bit_depth, dst=dst), n, qp,
                     bit_depth, intra=True)
    cbf = (lv != 0).any(dim=2).any(dim=1)
    r = idct_batch(dequant_batch(lv, n, qp, bit_depth), n, bit_depth,
                   dst=dst)
    maxv = (1 << bit_depth) - 1
    rec = torch.where(cbf[:, None, None], torch.clamp(cand + r, 0, maxv),
                      cand)
    org = blocks[:, None].expand(b, _RD_K, n, n).reshape(b * _RD_K, n, n)
    d = (rec - org).to(torch.int64)
    sse = (d * d).sum((1, 2)).to(torch.float32)
    a = torch.abs(lv)
    nnz = (a > 0).sum((1, 2)).to(torch.float32)
    slog = _bitlen_f(a).sum((1, 2)).to(torch.float32)
    cbits = torch.where(nnz > 0, abc[0] * nnz + abc[1] * slog + abc[2],
                        0.0)
    mbits = mode_bits[idx].reshape(-1)
    if n == 4:
        # four coherent 4x4 PUs mostly hit each other's MPMs
        mbits = mbits * 0.5
    cost = (sse + lam2 * (cbits + mbits)).reshape(b, _RD_K)
    k = torch.argmin(cost, dim=1)
    best_mode = torch.gather(idx, 1, k[:, None])[:, 0]
    return best_mode.to(torch.int32), torch.amin(cost, dim=1)


def _analyze_frame(plane: torch.Tensor, qp: int, lam_bits, lam_split,
                   lam_nxn, lam2, abc, mode_bits, *, h: int, w: int,
                   bit_depth: int, intra_nxn: bool):
    """Mode + depth decision of one frame; plane (Hp, Wp) int32 padded
    to CTU multiples, (h, w) the 8-aligned coded size. Returns
    depth8/mode8/nxn8 (Hp/8, Wp/8) and mode4 (Hp/4, Wp/4)."""
    hp, wp = plane.shape
    dev = plane.device
    mode, cost = {}, {}
    for n in ((4,) if intra_nxn else ()) + (8, 16, 32):
        m, c = _rd_mode_size(plane, n, qp, lam_bits, lam2, abc, mode_bits,
                             bit_depth)
        by, bx = hp // n, wp // n
        ys = torch.arange(by, device=dev)[:, None]
        xs = torch.arange(bx, device=dev)[None, :]
        # blocks extending past the coded frame can't be chosen whole
        over = ((ys + 1) * n > h) | ((xs + 1) * n > w)
        mode[n] = m.reshape(by, bx)
        cost[n] = torch.where(over, torch.inf, c.reshape(by, bx))

    def children_sum(c):
        return block_sum_seq(c, c.shape[0] // 2, 2, c.shape[1] // 2)

    if intra_nxn:
        # PART_NxN alternative at min CU: four 4x4 PU/TUs
        cost_nxn = children_sum(cost[4]) + lam_nxn
        use_nxn = cost_nxn < cost[8]
        eff8 = torch.where(use_nxn, cost_nxn, cost[8])
    else:
        use_nxn = torch.zeros_like(cost[8], dtype=torch.bool)
        eff8 = cost[8]

    # out-of-frame children cost 0 (the tree doesn't recurse there)
    agg8 = torch.where(torch.isinf(eff8), 0.0, eff8)
    child16 = children_sum(agg8) + lam_split
    keep16 = cost[16] <= child16
    agg16 = torch.where(keep16, cost[16], child16)
    agg16 = torch.where(torch.isinf(agg16), 0.0, agg16)
    child32 = children_sum(agg16) + lam_split
    keep32 = cost[32] <= child32

    k32 = up(keep32, 4)
    k16 = up(keep16, 2)
    depth8 = torch.where(k32, 0, torch.where(k16, 1, 2)).to(torch.uint8)
    if intra_nxn:
        nxn8 = (~k32) & (~k16) & use_nxn
        # PU0's mode represents the CU (chroma DM source, clause 8.4.3)
        m8eff = torch.where(nxn8, mode[4][::2, ::2], mode[8])
    else:
        nxn8 = torch.zeros_like(depth8, dtype=torch.bool)
        m8eff = mode[8]
    mode8 = torch.where(k32, up(mode[32], 4),
                        torch.where(k16, up(mode[16], 2), m8eff))
    if intra_nxn:
        mode4 = torch.where(up(nxn8, 2), mode[4], up(mode8, 2))
    else:
        mode4 = up(mode8, 2)
    return depth8, mode8.to(torch.uint8), nxn8, mode4.to(torch.uint8)


def analyze_intra_gop(orig_y: torch.Tensor, qp: int, ctu_size: int = 32,
                      bit_depth: int = 8, intra_nxn: bool = False):
    """GOP analysis: orig_y (F, H, W) 8-aligned uint8 planes on the
    device. Returns (depth8, mode8, nxn8, mode4) tensors: depth/mode on
    the (F, H/8, W/8) grid, nxn8 bool (PART_NxN at min CU), mode4
    (F, H/4, W/4) per-PU modes."""
    nf, h, w = orig_y.shape
    dev = orig_y.device
    lam = lambda_from_qp(qp)
    lam2 = lambda2_from_qp(qp)
    hp = (h + ctu_size - 1) // ctu_size * ctu_size
    wp = (w + ctu_size - 1) // ctu_size * ctu_size
    lam_bits = torch.as_tensor(np.round(lam * _MODE_BITS).astype(np.int32),
                               device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # depth/NxN aggregation runs in the RD domain (SSE + lambda2*bits)
    lam_split = torch.tensor(lam2 * 4.0, **f32)
    lam_nxn = torch.tensor(lam2 * 8.0, **f32)
    cal = calib_for_qp(qp)
    abc = torch.tensor([float(cal[0]), float(cal[1]), float(cal[2])], **f32)
    mode_bits = torch.as_tensor(_MODE_BITS.astype(np.float32), device=dev)
    lam2_t = torch.tensor(lam2, **f32)
    outs = []
    for f in range(nf):
        pl = edge_pad(orig_y[f].to(torch.int32), hp, wp)
        outs.append(_analyze_frame(
            pl, qp, lam_bits, lam_split, lam_nxn, lam2_t, abc, mode_bits,
            h=h, w=w, bit_depth=bit_depth, intra_nxn=intra_nxn))
    d8, m8, nxn8, m4 = (torch.stack(t) for t in zip(*outs))
    return (d8[:, :h // 8, :w // 8], m8[:, :h // 8, :w // 8],
            nxn8[:, :h // 8, :w // 8], m4[:, :h // 4, :w // 4])


def _chroma_costs(cb: torch.Tensor, cr: torch.Tensor, n: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """Joint cb+cr SATD of all 35 chroma prediction modes per n-block
    (orig-pixel references). Returns (B, 35)."""
    costs = 0
    for pl in (cb, cr):
        blocks = extract_blocks(pl, n)
        refs = gather_refs_device(pl, n, bit_depth)
        preds = intra_pred_all_modes(refs, n, is_luma=False,
                                     bit_depth=bit_depth)
        costs = costs + sa8d_nxn_batch(preds - blocks[:, None], n)
    return costs


def _chroma_modes(cbp: torch.Tensor, crp: torch.Tensor,
                  depth8: torch.Tensor, mode8: torch.Tensor, lam: float,
                  bit_depth: int = 8) -> torch.Tensor:
    """Chroma mode decision of one frame (planes padded to 16-multiples):
    DM vs the 4-entry candidate list, SATD + signalling bits."""
    n8y, n8x = depth8.shape
    cost8 = []
    for n in (32, 16, 8):             # depth 0, 1, 2
        cn = n // 2
        c = _chroma_costs(cbp, crp, cn, bit_depth)
        hc, wc = cbp.shape
        c = c.reshape(hc // cn, wc // cn, 35)
        s = n // 8
        c = c.repeat_interleave(s, 0).repeat_interleave(s, 1)[:n8y, :n8x]
        cost8.append(c.to(torch.float32))
    allc = torch.stack(cost8)                        # (3, n8y, n8x, 35)
    c8 = torch.gather(allc, 0, depth8.long()[None, ..., None]
                      .expand(1, n8y, n8x, 35))[0]
    m = mode8.long()
    cand = torch.as_tensor(CHROMA_CAND, device=m.device).long() \
        .expand(n8y, n8x, 4)
    cand = torch.where(cand == m[..., None], 34, cand)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=m.device)
    dm_cost = torch.gather(c8, -1, m[..., None])[..., 0] + lam_t
    cand_cost = torch.gather(c8, -1, cand) + lam_t * 3
    bj = torch.argmin(cand_cost, -1)
    best_cc = torch.gather(cand_cost, -1, bj[..., None])[..., 0]
    best_cm = torch.gather(cand, -1, bj[..., None])[..., 0]
    return torch.where(dm_cost <= best_cc, m, best_cm).to(torch.uint8)


def analyze_chroma_gop(orig_cb: torch.Tensor, orig_cr: torch.Tensor,
                       depth8: torch.Tensor, mode8: torch.Tensor, qp: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """GOP-batched chroma mode decision: orig_cb/cr (F, H/2, W/2),
    depth8/mode8 (F, n8y, n8x). Returns cmode8 (F, n8y, n8x) uint8."""
    nf, h2, w2 = orig_cb.shape
    lam = float(np.float32(lambda_from_qp(qp)))
    hp = (h2 + 15) // 16 * 16
    wp = (w2 + 15) // 16 * 16
    return torch.stack([
        _chroma_modes(edge_pad(orig_cb[f].to(torch.int32), hp, wp),
                      edge_pad(orig_cr[f].to(torch.int32), hp, wp),
                      depth8[f], mode8[f], lam, bit_depth)
        for f in range(nf)])
