"""The host B path: one B frame between two references, two-list ME and
bi-prediction, with a dense recon (counterpart of
x265_tpu/enc/bi_frame.py).

On the device: the dense motion search of each list (ops/me.py
motion_search_frame: every block gathered at its own position, no
window gather), the SA8D of the bi prediction per size, and per size
the prediction, transform, quantisation and recon of every block with
its chosen L0 / L1 / BI prediction, composed along the depth map. On
the host, in float64 as the reference: the per-size choice among L0,
L1 and BI (SA8D + lambda * signalling bits, first index on ties) and
the 32/16/8 merge. The in-loop filters and the entropy coding are the
encoder's (enc/encoder.py encode_frame_b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.syntax import FrameBSyntax
from ..common.params import EncoderConfig
from ..common.tables import chroma_qp, lambda_from_qp
from ..device import resolve_device
from ..ops.interp import bi_average, mc_block_batch
from ..ops.me import motion_search_frame
from ..ops.satd import sa8d_nxn_batch
from ..ops.transforms import (dct_batch, dequant_batch, idct_batch,
                              quant_batch, sign_hide_batch)
from .bframe_gpu import _planes_on
from .intra_analysis import edge_pad, extract_blocks, up
from .intra_recon import ReconFrame

SIZES = (8, 16, 32)


def _origins(h: int, w: int, n: int, device):
    by, bx = h // n, w // n
    ar_x = torch.arange(bx, dtype=torch.int32, device=device) * n
    ar_y = torch.arange(by, dtype=torch.int32, device=device) * n
    return ar_x.repeat(by), ar_y.repeat_interleave(bx), by, bx


def _to_plane(blocks: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    return blocks.reshape(h // n, w // n, n, n).permute(0, 2, 1, 3) \
        .reshape(h, w)


def _bi_cost_size(orig_y, ref0_y, ref1_y, mv0grid, mv1grid, *, n: int,
                  bit_depth: int) -> torch.Tensor:
    """SA8D of the bi prediction for every n-block (both MV grids)."""
    h, w = orig_y.shape
    x0s, y0s, by, bx = _origins(h, w, n, orig_y.device)
    ob = extract_blocks(orig_y, n)
    a0 = mc_block_batch(ref0_y, x0s, y0s, mv0grid[..., 0].reshape(-1),
                        mv0grid[..., 1].reshape(-1), n, is_luma=True,
                        bit_depth=bit_depth, raw=True)
    a1 = mc_block_batch(ref1_y, x0s, y0s, mv1grid[..., 0].reshape(-1),
                        mv1grid[..., 1].reshape(-1), n, is_luma=True,
                        bit_depth=bit_depth, raw=True)
    pred = bi_average(a0, a1, bit_depth)
    return sa8d_nxn_batch(ob - pred, n).reshape(by, bx)


def _b_recon_size(orig, refs0, refs1, mv0grid, mv1grid, pfgrid, qp: int,
                  qpc: int, *, n: int, bit_depth: int,
                  sign_hiding: bool = False):
    """Dense recon of every n-block with its prediction flag (1 L0, 2
    L1, 3 bi). orig / refs0 / refs1: (y, cb, cr) int32 planes. Returns
    (rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr) planes."""
    h, w = orig[0].shape
    x0s, y0s, _, _ = _origins(h, w, n, orig[0].device)
    pf = pfgrid.reshape(-1)[:, None, None]
    maxv = (1 << bit_depth) - 1
    total_shift = 12 - (bit_depth - 8)
    m0x, m0y = mv0grid[..., 0].reshape(-1), mv0grid[..., 1].reshape(-1)
    m1x, m1y = mv1grid[..., 0].reshape(-1), mv1grid[..., 1].reshape(-1)

    def uni(acc):
        return torch.clamp((acc + (1 << (total_shift - 1))) >> total_shift,
                           0, maxv)

    def one_plane(o, r0, r1, nn, x0, y0, qqp, is_luma):
        a0 = mc_block_batch(r0, x0, y0, m0x, m0y, nn, is_luma=is_luma,
                            bit_depth=bit_depth, raw=True)
        a1 = mc_block_batch(r1, x0, y0, m1x, m1y, nn, is_luma=is_luma,
                            bit_depth=bit_depth, raw=True)
        pred = torch.where(pf == 3, bi_average(a0, a1, bit_depth),
                           torch.where(pf == 1, uni(a0), uni(a1)))
        resi = extract_blocks(o, nn) - pred
        if sign_hiding:
            coefs, du = quant_batch(dct_batch(resi, nn, bit_depth), nn, qqp,
                                    bit_depth, intra=False, with_rem=True)
            coefs = sign_hide_batch(coefs, nn, 0, du)
        else:
            coefs = quant_batch(dct_batch(resi, nn, bit_depth), nn, qqp,
                                bit_depth, intra=False)
        cbf = (coefs != 0).any(dim=2).any(dim=1)[:, None, None]
        r = idct_batch(dequant_batch(coefs, nn, qqp, bit_depth), nn,
                       bit_depth)
        rec = torch.where(cbf, torch.clamp(pred + r, 0, maxv), pred)
        coefs = torch.where(cbf, coefs, 0)
        hh, ww = o.shape
        return _to_plane(rec, nn, hh, ww), _to_plane(coefs, nn, hh, ww)

    rec_y, cf_y = one_plane(orig[0], refs0[0], refs1[0], n, x0s, y0s, qp,
                            True)
    cn = n >> 1
    rec_cb, cf_cb = one_plane(orig[1], refs0[1], refs1[1], cn, x0s // 2,
                              y0s // 2, qpc, False)
    rec_cr, cf_cr = one_plane(orig[2], refs0[2], refs1[2], cn, x0s // 2,
                              y0s // 2, qpc, False)
    return rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr


def encode_b_frame_arrays(orig_y, orig_cb, orig_cr, ref0, ref1,
                          cfg: EncoderConfig, poc: int,
                          poc_refs: tuple[int, int], qp: int | None = None,
                          device=None) -> tuple[FrameBSyntax, ReconFrame]:
    """One B frame: orig_*: host source planes at the coded size; ref0 /
    ref1: the L0 / L1 references, each a DeviceRef or a host
    ReconFrame. Returns the syntax record and the host recon (before
    the in-loop filters), cropped to the coded size."""
    dev = resolve_device(device)
    h, w = orig_y.shape
    hp = (h + 31) // 32 * 32
    wp = (w + 31) // 32 * 32

    def padp(p, ph, pw):
        p = np.asarray(p)
        p = np.pad(p, ((0, ph - p.shape[0]), (0, pw - p.shape[1])),
                   mode="edge")
        return torch.as_tensor(p.astype(np.int32), device=dev)

    orig = (padp(orig_y, hp, wp), padp(orig_cb, hp // 2, wp // 2),
            padp(orig_cr, hp // 2, wp // 2))
    # int32 references at the scan size: a DeviceRef stays on the
    # device, a host ReconFrame is uploaded
    refs0, refs1 = (tuple(edge_pad(p.to(torch.int32), ph, pw) for p, ph, pw
                          in zip(_planes_on(r, dev, h, w, cfg.bit_depth),
                                 (hp, hp // 2, hp // 2),
                                 (wp, wp // 2, wp // 2)))
                    for r in (ref0, ref1))
    real_h, real_w = h, w
    h, w = hp, wp
    qp = cfg.qp if qp is None else qp
    qpc = chroma_qp(qp)
    lam = lambda_from_qp(qp)

    f0 = motion_search_frame(orig[0], refs0[0], qp, sizes=SIZES,
                             bit_depth=cfg.bit_depth)
    f1 = motion_search_frame(orig[0], refs1[0], qp, sizes=SIZES,
                             bit_depth=cfg.bit_depth)

    # per size the prediction: L0 / L1 / BI by SA8D + signalling cost
    choice, cost = {}, {}
    for n in SIZES:
        c0 = f0[n][1].astype(np.float64)
        c1 = f1[n][1].astype(np.float64)
        cbi = _bi_cost_size(
            orig[0], refs0[0], refs1[0], torch.as_tensor(f0[n][0], device=dev),
            torch.as_tensor(f1[n][0], device=dev), n=n,
            bit_depth=cfg.bit_depth).cpu().numpy().astype(np.float64)
        c0 = c0 + lam * 2
        c1 = c1 + lam * 2
        cbi = cbi + lam * (2 + 8)     # two MVDs
        stack = np.stack([c0, c1, cbi])
        choice[n] = np.argmin(stack, axis=0).astype(np.int32)   # 0/1/2
        cost[n] = stack.min(axis=0)
        by, bx = cost[n].shape
        ys, xs = np.meshgrid(np.arange(by), np.arange(bx), indexing="ij")
        over = ((ys + 1) * n > real_h) | ((xs + 1) * n > real_w)
        cost[n] = np.where(over, np.inf, cost[n])

    agg = np.where(np.isinf(cost[8]), 0, cost[8])
    ch16 = agg.reshape(cost[16].shape[0], 2, cost[16].shape[1], 2) \
        .sum(axis=(1, 3)) + lam * 4.0
    keep16 = cost[16] <= ch16
    agg16 = np.where(keep16, cost[16], ch16)
    agg16 = np.where(np.isinf(agg16), 0, agg16)
    ch32 = agg16.reshape(cost[32].shape[0], 2, cost[32].shape[1], 2) \
        .sum(axis=(1, 3)) + lam * 4.0
    keep32 = cost[32] <= ch32

    n8y, n8x = h // 8, w // 8

    def upn(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)[:n8y, :n8x]

    k32 = upn(keep32, 4)
    k16 = upn(keep16, 2)
    depth8 = np.where(k32, 0, np.where(k16, 1, 2)).astype(np.uint8)
    ch8 = np.where(k32, upn(choice[32], 4),
                   np.where(k16, upn(choice[16], 2), choice[8][:n8y, :n8x]))
    pf8 = np.where(ch8 == 0, 1, np.where(ch8 == 1, 2, 3)).astype(np.uint8)
    mv0_8 = np.where(k32[..., None], upn(f0[32][0], 4),
                     np.where(k16[..., None], upn(f0[16][0], 2),
                              f0[8][0][:n8y, :n8x])).astype(np.int32)
    mv1_8 = np.where(k32[..., None], upn(f1[32][0], 4),
                     np.where(k16[..., None], upn(f1[16][0], 2),
                              f1[8][0][:n8y, :n8x])).astype(np.int32)
    # unused lists carry zero MVs (the canonical form for signalling)
    mv0_8 = np.where((pf8[..., None] & 1) != 0, mv0_8, 0)
    mv1_8 = np.where((pf8[..., None] & 2) != 0, mv1_8, 0)
    mv8 = np.stack([mv0_8, mv1_8], axis=2)        # (n8y, n8x, 2, 2)

    # the recon at every size, composed along the depth map (every 8x8
    # cell has one depth: the 32 planes, then the 16 and 8 cells)
    d8 = torch.as_tensor(depth8, device=dev)
    out = None
    for d, n in ((0, 32), (1, 16), (2, 8)):
        by, bx = h // n, w // n
        s = n // 8
        grid = torch.as_tensor(mv8[::s, ::s][:by, :bx], device=dev)
        gpf = torch.as_tensor(pf8[::s, ::s][:by, :bx].astype(np.int32),
                              device=dev)
        planes = _b_recon_size(orig, refs0, refs1, grid[:, :, 0],
                               grid[:, :, 1], gpf, qp, qpc, n=n,
                               bit_depth=cfg.bit_depth,
                               sign_hiding=cfg.sign_hiding)
        if out is None:
            out = planes
            continue
        m8 = d8 == d
        masks = (up(m8, 8),) * 2 + (up(m8, 4),) * 4
        out = [torch.where(m, p, o) for m, p, o in zip(masks, planes, out)]
    rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr = (
        p.to(torch.int32).cpu().numpy() for p in out)

    rh, rw = real_h, real_w
    syn = FrameBSyntax(depth8=depth8[:rh // 8, :rw // 8],
                       mv8=mv8[:rh // 8, :rw // 8],
                       pf8=pf8[:rh // 8, :rw // 8],
                       coeff_y=cf_y[:rh, :rw],
                       coeff_cb=cf_cb[:rh // 2, :rw // 2],
                       coeff_cr=cf_cr[:rh // 2, :rw // 2],
                       poc=poc, poc_refs=poc_refs)
    return syn, ReconFrame(rec_y[:rh, :rw], rec_cb[:rh // 2, :rw // 2],
                           rec_cr[:rh // 2, :rw // 2])
