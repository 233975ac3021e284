"""B-frame device pipeline: the frames of one pyramid layer, each coded
on the GPU against two already reconstructed references.

Counterpart of x265_tpu/enc/bframe_tpu.py (x265 analysis.cpp
checkBidir2Nx2N) at CTU 32, with per-CTU QP maps in the quantiser;
RDOQ as the reference's (it has no noise reduction and no lowpass
DCT). The reference runs a
layer as one lax.scan with no carry; here it is a Python loop whose
body does, all on the device, per frame: for each list, the quarter-res
coarse search and the windowed ME of every block of every size
(ops/me_win.py, on the window-gather and integer-search kernels) with
the raw 26-bit accumulators of the selected predictions, and the
windowed chroma MC (raw as well); the normative bi combine (clause
8.5.4.2.3.2) as a third candidate; per size the uni-L0 / uni-L1 / bi
choice by SA8D + lambda * bits (first index on ties); residual coding
at every size; psy-rd; the leaf-RDO depth decision; compose; the
luma deblock with B boundary strengths; SAO. The host downloads the
decision fields, the coefficient planes and the recon.

Float exactness as in pgop_gpu: float32 costs in the reference's order,
multiply-adds rounded once where the reference's program fuses them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.syntax import FrameBSyntax
from ..common.params import EncoderConfig
from ..common.tables import chroma_qp, lambda_from_qp, lambda2_from_qp
from ..device import resolve_device
from ..ops.deblock import deblock_luma_t
from ..ops.fma import fma32
from ..ops.interp import bi_average as _bi_combine
from ..ops.me import _downsample4
from ..ops.me_win import _argmin_first, me_all_sizes, pad_ref
from ..ops.sao_gpu import apply_sao_t, choose_sao_chroma_t, choose_sao_t
from ..ops.satd import sa8d_nxn_lanes
from ..ops.transforms import (dct_batch, dequant_batch, idct_batch,
                              quant_batch, rdoq_batch, sign_hide_batch)
from .intra_analysis import edge_pad, up as _up
from .intra_recon import DeviceRef, np_pixel_dtype, pixel_dtype
from .pgop_gpu import (B_CTU64, SIZES, _blk_sse, _blocks_of, _qp_vec_of,
                       _chroma_preds_windowed, _coarse_search_rolled,
                       _coeff_bits_est, _f32, _mvd_bits_est, _psy8_energy,
                       _rd_depth_decision, check_pgop_config, ctu_grid)

# the B path's bit model: the reference's default calibration, header
# and split bits (bframe_tpu.py passes none of its own)
_CALIB = (1.4, 1.2, 5.0)
_HDR_BITS, _SPLIT_BITS = 5.0, 3.0


def _bs_maps_b_t(depth8, mvb, pf8, cf_y, ctu: int):
    """B boundary strengths (clause 8.7.2.4): 1 on TU edges where either
    side has coefficients, or where the prediction flags differ or a
    list both sides use moves by a full pel or more."""
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

    cbf8 = torch.where(depth8 == 0, orpool(nz8, 4),
                       torch.where(depth8 == 1, orpool(nz8, 2), nz8))
    size = ctu >> depth8.to(torch.int32)
    xs = (torch.arange(n8x, device=dev) * 8)[None, :]
    ys = (torch.arange(n8y, device=dev) * 8)[:, None]
    vmask = (xs % size) == 0
    vmask[:, 0] = False
    hmask = (ys % size) == 0
    hmask[0, :] = False

    def bs_of(cP, cQ, pfP, pfQ, mvP, mvQ):
        mvd = torch.zeros(cP.shape, dtype=torch.bool, device=dev)
        for li in range(2):
            used = (pfP & (1 << li)) != 0
            d = (torch.abs(mvP[..., li, 0] - mvQ[..., li, 0]) >= 4) | \
                (torch.abs(mvP[..., li, 1] - mvQ[..., li, 1]) >= 4)
            mvd |= used & d
        return (cQ | cP | (pfP != pfQ) | mvd).to(torch.int32)

    vbs = torch.zeros((n8y, n8x), dtype=torch.int32, device=dev)
    vbs[:, 1:] = bs_of(cbf8[:, :-1], cbf8[:, 1:], pf8[:, :-1], pf8[:, 1:],
                       mvb[:, :-1], mvb[:, 1:])
    hbs = torch.zeros((n8y, n8x), dtype=torch.int32, device=dev)
    hbs[1:, :] = bs_of(cbf8[:-1, :], cbf8[1:, :], pf8[:-1, :], pf8[1:, :],
                       mvb[:-1, :], mvb[1:, :])
    return vbs * vmask, hbs * hmask


def _bframe(refs0, refs1, oy, ocb, ocr, *, qp: int, qpc: int,
            bit_depth: int, real_h: int, real_w: int, ctu: int,
            deblock: bool, sao: bool, sign_hiding: bool, me_range: int,
            psy_rd: float, rdoq: bool = False, qp_ctu=None):
    """One B frame. refs0/refs1: (y, cb, cr) int32 planes of the L0 and
    L1 references at the scan size (CTU multiples, edge-padded); o*
    int32 source planes at the scan size; rdoq: the RD quantiser;
    qp_ctu: the (ncty, nctx) per-CTU QP map at the scan size (dQP: the
    quantiser's QP per block; lambdas and the deblock stay at qp).
    Returns (depth8, mvb8 (n8y, n8x, 2, 2), pf8, cf_y, cf_cb, cf_cr, sao
    (3, ncty, nctx, 6) or None, rec_y, rec_cb, rec_cr), the recon
    cropped to the coded size."""
    dev = oy.device
    lam = float(lambda_from_qp(qp))
    lam2 = float(lambda2_from_qp(qp))
    h, w = oy.shape
    rh, rw = real_h, real_w
    maxv = (1 << bit_depth) - 1
    total_shift = 12 - (bit_depth - 8)
    lam_i = int(round(lam))
    pad_y = 2 * me_range + 8
    pad_c = me_range + 8
    win_dt = pixel_dtype(bit_depth)     # uint8, uint16 at 10 bits

    me, craws = {}, {}
    for li, (ry, rcb, rcr) in enumerate((refs0, refs1)):
        cmv = _coarse_search_rolled(_downsample4(oy), _downsample4(ry))[0] * 4
        res, seeds = me_all_sizes(oy, pad_ref(ry.to(win_dt), pad_y), cmv,
                                  lam_i, radius=me_range, pad=pad_y,
                                  bit_depth=bit_depth, want_raw=True)
        me[li] = res
        cpad2 = torch.stack([pad_ref(rcb.to(win_dt), pad_c),
                             pad_ref(rcr.to(win_dt), pad_c)])
        craws[li] = _chroma_preds_windowed(
            cpad2, pad_c, rcb, rcr, {n: res[n][0] for n in SIZES}, seeds,
            me_range, h, w, bit_depth, raw=True)

    def rounded(acc):
        return torch.clamp((acc + (1 << (total_shift - 1))) >> total_shift,
                           0, maxv)

    def pick(pf, a, b, c):
        m = pf[:, None, None]
        return torch.where(m == 1, a, torch.where(m == 2, b, c))

    # per size: uni-L0, uni-L1 or bi by SA8D + lambda * bits
    sel_pred, sel_cpred, pf_sz, mv_sz = {}, {}, {}, {}
    for n in SIZES:
        ob = _blocks_of(oy, n)
        mv0, c0, p0, raw0 = me[0][n]
        mv1, c1, p1, raw1 = me[1][n]
        bi = _bi_combine(raw0, raw1, bit_depth)
        cbi = sa8d_nxn_lanes((ob - bi).permute(1, 2, 0), n) + \
            lam_i * (torch.abs(mv0).sum(1) // 2 +
                     torch.abs(mv1).sum(1) // 2 + 6)
        _, best = _argmin_first(torch.stack([c0, c1, cbi]))
        pf = (best + 1).to(torch.int32)          # 1 L0, 2 L1, 3 bi
        pf_sz[n] = pf
        mv_sz[n] = torch.stack([mv0, mv1], dim=1)          # (B, 2, 2)
        sel_pred[n] = pick(pf, p0, p1, bi)
        (cr0b, cr0r), (cr1b, cr1r) = craws[0][n], craws[1][n]
        sel_cpred[n] = (
            pick(pf, rounded(cr0b), rounded(cr1b),
                 _bi_combine(cr0b, cr1b, bit_depth)),
            pick(pf, rounded(cr0r), rounded(cr1r),
                 _bi_combine(cr0r, cr1r, bit_depth)))

    def to_plane(blocks, nn, hh, ww):
        return blocks.reshape(hh // nn, ww // nn, nn, nn) \
            .permute(0, 2, 1, 3).reshape(hh, ww)

    def one_plane(orig, nn, qqp, pred):
        obk = _blocks_of(orig, nn)
        tcoef = dct_batch(obk - pred, nn, bit_depth)
        if rdoq:
            if sign_hiding:
                coefs, du = rdoq_batch(tcoef, nn, qqp, lam2, bit_depth,
                                       with_rem=True)
                coefs = sign_hide_batch(coefs, nn, 0, du)
            else:
                coefs = rdoq_batch(tcoef, nn, qqp, lam2, bit_depth)
        elif sign_hiding:
            coefs, du = quant_batch(tcoef, nn, qqp, bit_depth, intra=False,
                                    with_rem=True)
            coefs = sign_hide_batch(coefs, nn, 0, du)
        else:
            coefs = quant_batch(tcoef, nn, qqp, bit_depth, intra=False)
        cbf = (coefs != 0).any(dim=2).any(dim=1)[:, None, None]
        r = idct_batch(dequant_batch(coefs, nn, qqp, bit_depth), nn,
                       bit_depth)
        rec = torch.where(cbf, torch.clamp(pred + r, 0, maxv), pred)
        return rec, torch.where(cbf, coefs, 0)

    # residual coding at every size
    planes, sse, bits = {}, {}, {}
    for n in SIZES:
        by, bx = h // n, w // n
        cn = n >> 1
        qn, qcn = _qp_vec_of(qp, qpc, qp_ctu, by, bx, n, ctu)
        rec_y, cf_y = one_plane(oy, n, qn, sel_pred[n])
        rec_cb, cf_cb = one_plane(ocb, cn, qcn, sel_cpred[n][0])
        rec_cr, cf_cr = one_plane(ocr, cn, qcn, sel_cpred[n][1])
        pl = planes[n] = (to_plane(rec_y, n, h, w), to_plane(cf_y, n, h, w),
                          to_plane(rec_cb, cn, h // 2, w // 2),
                          to_plane(cf_cb, cn, h // 2, w // 2),
                          to_plane(rec_cr, cn, h // 2, w // 2),
                          to_plane(cf_cr, cn, h // 2, w // 2))
        sse[n] = _blk_sse(pl[0], oy, by, bx, n) + \
            _blk_sse(pl[2], ocb, by, bx, cn) + \
            _blk_sse(pl[4], ocr, by, bx, cn)
        pf = pf_sz[n].reshape(by, bx)
        mvg = mv_sz[n].reshape(by, bx, 2, 2)
        mvbits = torch.where((pf & 1) != 0, _mvd_bits_est(mvg[:, :, 0]),
                             0.0) + \
            torch.where((pf & 2) != 0, _mvd_bits_est(mvg[:, :, 1]), 0.0)
        bits[n] = mvbits + _coeff_bits_est(pl[1], by, bx, n, _CALIB) + \
            _coeff_bits_est(pl[3], by, bx, cn, _CALIB) + \
            _coeff_bits_est(pl[5], by, bx, cn, _CALIB)

    if psy_rd > 0:
        scale = _f32(psy_rd, dev) * torch.sqrt(_f32(lam2, dev))
        e_src = _psy8_energy(oy)
        for n in SIZES:
            de = torch.abs(e_src - _psy8_energy(planes[n][0]))
            k = n // 8
            psy_n = de.reshape(h // n, k, w // n, k).sum((1, 3))
            sse[n] = fma32(sse[n], scale, psy_n)

    depth8, mv8x = _rd_depth_decision(
        sse, bits, {n: mv_sz[n].reshape(-1, 4) for n in SIZES}, lam2,
        real_h, real_w, h, w, hdr_bits=_HDR_BITS, split_bits=_SPLIT_BITS,
        refs=None)[:2]
    n8y, n8x = h // 8, w // 8
    pf_up = {n: _up(pf_sz[n].reshape(h // n, w // n), n // 8)[:n8y, :n8x]
             for n in SIZES}
    pf8 = torch.where(depth8 == 0, pf_up[32],
                      torch.where(depth8 == 1, pf_up[16], pf_up[8]))
    mvb8 = mv8x.reshape(n8y, n8x, 2, 2)

    out = [torch.zeros_like(p) for p in planes[8]]
    for d, n in ((0, 32), (1, 16), (2, 8)):
        m8 = depth8 == d
        mpx, mpx_c = _up(m8, 8), _up(m8, 4)
        for i, p in enumerate(planes[n]):
            out[i] = torch.where(mpx if i < 2 else mpx_c, p, out[i])
    rec_y, cf_y, rec_cb, cf_cb, rec_cr, cf_cr = out

    ry_c = rec_y[:rh, :rw]
    rcb_c = rec_cb[:rh // 2, :rw // 2]
    rcr_c = rec_cr[:rh // 2, :rw // 2]
    if deblock:
        vbs, hbs = _bs_maps_b_t(depth8[:rh // 8, :rw // 8],
                                mvb8[:rh // 8, :rw // 8],
                                pf8[:rh // 8, :rw // 8], cf_y[:rh, :rw], ctu)
        ry_c = deblock_luma_t(ry_c.contiguous(), vbs, hbs, qp, bit_depth)
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
    return (depth8.to(torch.uint8), mvb8, pf8.to(torch.uint8), cf_y, cf_cb,
            cf_cr, sao_p, ry_c, rcb_c, rcr_c)


def _planes_on(ref, dev, h: int, w: int, bit_depth: int = 8):
    """A reference's (y, cb, cr) planes (pixel_dtype) at the coded size
    on the device: a DeviceRef in place (slot 0 of a stack; copied when
    it lies on another device), a host ReconFrame uploaded."""
    if isinstance(ref, DeviceRef):
        planes = (ref.y, ref.cb, ref.cr)
        if ref.y.dim() == 3:
            planes = tuple(p[0] for p in planes)
        return tuple(p.to(dev) for p in planes)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.asarray(p)[:hh, :ww].astype(np_pixel_dtype(bit_depth)))).to(dev)
        for p, hh, ww in ((ref.y, h, w), (ref.cb, h // 2, w // 2),
                          (ref.cr, h // 2, w // 2)))


def encode_bframes_gpu(frames, ref0s, ref1s, cfg: EncoderConfig, qp: int,
                       qp_maps=None, device=None, mesh=None):
    """Encode one layer of independent B frames on the device.

    frames: list of (y, cb, cr) source planes (coded size); ref0s /
    ref1s: per frame its L0 / L1 reference, a DeviceRef (used in place)
    or a host ReconFrame (uploaded once); qp_maps: (F, ncty, nctx)
    per-CTU QP maps (dQP), fitted to the scan's CTU grid, flat at qp
    when cfg.dqp_enabled and none are given (syn.qp_map). Returns (syns:
    FrameBSyntax list, recons: host ReconFrame list, device_refs:
    DeviceRef list of the filtered recons, for the layers that predict
    from them). mesh: an ordered list of devices (parallel/gop_sharding.py
    make_gop_mesh) over which the layer fans out in contiguous shards of
    F / n frames, shard k on mesh device k with its references moved
    there; F must be a multiple of n. The results come back in frame
    order."""
    if mesh is not None:
        mesh = list(mesh)
        if len(frames) % len(mesh):
            raise ValueError(f"{len(frames)} B frames do not tile a mesh "
                             f"of {len(mesh)}")
        fl = len(frames) // len(mesh)
        outs = ([], [], [])
        for k, dev in enumerate(mesh):
            part = slice(k * fl, (k + 1) * fl)
            for acc, got in zip(outs, encode_bframes_gpu(
                    frames[part], ref0s[part], ref1s[part], cfg, qp,
                    qp_maps=None if qp_maps is None else qp_maps[part],
                    device=dev)):
                acc.extend(got)
        return outs
    check_pgop_config(cfg)
    if cfg.ctu_size == 64:
        raise NotImplementedError(B_CTU64)
    dev = resolve_device(device)
    h, w = cfg.height_padded, cfg.width_padded
    hp, wp = (h + 31) // 32 * 32, (w + 31) // 32 * 32
    uploaded: dict[int, tuple] = {}

    def scan_planes(ref):
        """int32 planes at the scan size, one upload per distinct ref."""
        key = id(ref)
        if key not in uploaded:
            y, cb, cr = _planes_on(ref, dev, h, w, cfg.bit_depth)
            uploaded[key] = (
                edge_pad(y.to(torch.int32), hp, wp),
                edge_pad(cb.to(torch.int32), hp // 2, wp // 2),
                edge_pad(cr.to(torch.int32), hp // 2, wp // 2))
        return uploaded[key]

    def src(p, hh, ww, php, pwp):
        a = np.asarray(p)
        if a.shape != (hh, ww):
            a = np.pad(a, ((0, hh - a.shape[0]), (0, ww - a.shape[1])),
                       mode="edge")
        t = torch.from_numpy(np.ascontiguousarray(a.astype(src_dt)))
        return edge_pad(t.to(dev).to(torch.int32), php, pwp)

    qpc = chroma_qp(qp)
    src_dt, rdt = np_pixel_dtype(cfg.bit_depth), pixel_dtype(cfg.bit_depth)
    ctu = cfg.ctu_size
    qmj = None
    if cfg.dqp_enabled:
        if qp_maps is None:
            qp_maps = np.full((len(frames), hp // ctu, wp // ctu), qp,
                              np.int32)
        qmj = np.stack([ctu_grid(m, hp // ctu, wp // ctu) for m in qp_maps])
        qmaps_t = torch.as_tensor(qmj, device=dev)
    syns, recons, drefs = [], [], []
    n8y, n8x = h // 8, w // 8
    for i, (fr, r0, r1) in enumerate(zip(frames, ref0s, ref1s)):
        (depth8, mvb8, pf8, cf_y, cf_cb, cf_cr, sao_p, ry, rcb,
         rcr) = _bframe(
            scan_planes(r0), scan_planes(r1),
            src(fr[0], h, w, hp, wp), src(fr[1], h // 2, w // 2, hp // 2,
                                          wp // 2),
            src(fr[2], h // 2, w // 2, hp // 2, wp // 2),
            qp=int(qp), qpc=int(qpc), bit_depth=cfg.bit_depth, real_h=h,
            real_w=w, ctu=cfg.ctu_size, deblock=cfg.deblock, sao=cfg.sao,
            sign_hiding=cfg.sign_hiding, me_range=int(cfg.me_range),
            psy_rd=float(cfg.psy_rd), rdoq=bool(cfg.rdoq),
            qp_ctu=None if qmj is None else qmaps_t[i])
        syn = FrameBSyntax(
            depth8=depth8[:n8y, :n8x].cpu().numpy(),
            mv8=mvb8[:n8y, :n8x].cpu().numpy().astype(np.int32),
            pf8=pf8[:n8y, :n8x].cpu().numpy(),
            coeff_y=cf_y[:h, :w].cpu().numpy().astype(np.int32),
            coeff_cb=cf_cb[:h // 2, :w // 2].cpu().numpy().astype(np.int32),
            coeff_cr=cf_cr[:h // 2, :w // 2].cpu().numpy().astype(np.int32))
        if sao_p is not None:
            syn.sao_params = tuple(sao_p.cpu().numpy())
        if qmj is not None:
            syn.qp_map = qmj[i, :(h + ctu - 1) // ctu, :(w + ctu - 1) // ctu]
        syns.append(syn)
        dref = DeviceRef(*(p.to(rdt).contiguous()
                           for p in (ry, rcb, rcr)))
        drefs.append(dref)
        recons.append(dref.to_recon())
    return syns, recons, drefs
