"""GOP chains over a device mesh: independent IPPP chains (separate
keyint segments, or the jobs of an ABR ladder) share no data, so each
runs whole on one device (counterpart of
x265_tpu/parallel/gop_sharding.py).

The mesh is an ordered list of torch devices in this one process
(make_gop_mesh), the counterpart of the reference's single-controller
mesh of one host's devices. Chain c runs on mesh device c through the
P-chunk path (enc/pgop_gpu.py: the window gather and both integer
searches on that device), with the options the reference's chain scan
takes (chain_config). Every chain is enqueued before any is read back,
so chains on different cards overlap. Each chain's coded bits are
estimated on its own device with the calibrated bit model the RD
decisions use (common/bit_calib.py); the estimates are gathered to mesh
device 0 and summed in chain order (the reference's psum), the total
that feeds one shared rate-control step (shared_rc_step). The host then
entropy-codes each chain from the downloaded records, so the streams
equal each chain's single-device encode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bitstream.syntax import FramePSyntax
from ..common.bit_calib import calib_for_qp
from ..common.params import EncoderConfig
from ..device import resolve_device
from ..enc.intra_recon import DeviceRef, ReconFrame, np_pixel_dtype
from ..enc.pgop_gpu import submit_pgop_gpu
from ..ops.me import bitlen


def make_gop_mesh(n_devices: int | None = None,
                  devices=None) -> list[torch.device]:
    """The chain mesh: devices in order, cuda:0 .. cuda:n-1 by default
    (raises when fewer exist), or the given list (repeats allowed, e.g.
    ["cpu"] * 2)."""
    if devices is None:
        n = 1 if n_devices is None else n_devices
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(f"a mesh of {n} CUDA devices, {have} "
                               f"present; pass devices=[...] to choose")
        return [torch.device(f"cuda:{i}") for i in range(n)]
    mesh = [resolve_device(d) for d in devices]
    if n_devices is not None and n_devices != len(mesh):
        raise ValueError(f"{len(mesh)} devices given for a mesh of "
                         f"{n_devices}")
    return mesh


def chain_config(cfg: EncoderConfig) -> EncoderConfig:
    """The configuration a chain is coded with: the reference's chain
    scan takes one reference, no per-CTU QP, no RDOQ, no weighted
    prediction, no noise reduction, no lowpass DCT, intra-in-inter on;
    the rest (deblock, SAO, sign hiding, psy-rd, the inter TU tree, CTU,
    bit depth) is the caller's."""
    return dataclasses.replace(cfg, num_refs=1, aq_mode=0, cutree=False,
                               rdoq=False, weightp=False, nr_inter=0,
                               lowpass_dct=False, intra_in_inter=True,
                               bframes=0)


def _est_bits(cf: torch.Tensor, calib) -> torch.Tensor:
    """The calibrated coded-bits estimate of one coefficient plane,
    float32: A * nonzero count + B * their bit lengths + C * the 8x8
    blocks with a nonzero (the counts are integers, summed exactly)."""
    a_, b_, c_ = (torch.tensor(float(v), dtype=torch.float32,
                               device=cf.device) for v in calib[:3])
    a = torch.abs(cf.to(torch.int32))
    nz = a > 0
    nnz = nz.sum().to(torch.float32)
    slog = torch.where(nz, bitlen(a), 0).sum().to(torch.float32)
    h2, w2 = cf.shape
    coded = nz.reshape(h2 // 8, 8, w2 // 8, 8).any(dim=3).any(dim=1) \
        .sum().to(torch.float32)
    return a_ * nnz + b_ * slog + c_ * coded


def encode_chains_sharded(oy: np.ndarray, ocb: np.ndarray, ocr: np.ndarray,
                          ref_y: np.ndarray, ref_cb: np.ndarray,
                          ref_cr: np.ndarray, cfg: EncoderConfig, qp: int,
                          mesh, me_range: int = 6):
    """Encode C independent P chains, chain c on mesh device c.

    oy/ocb/ocr: (C, F, Hp, Wp) sample planes, edge-padded from the
    coded size to multiples of max(32, CTU); ref_*: (C, Hp, Wp) initial
    references (each chain's I recon). Returns (res, final_ref,
    total_rate, chain_rates) in the reference's layouts, host arrays:
    res = (depth8 (C, F, Hp/8, Wp/8), mv8 (.., 2) int16, cf_y (C, F*Hp,
    Wp) int16, cf_c (C, 2F*Hp/2, Wp/2) int16 [cb frames, cr frames],
    sao (C, F, 3, ncty, nctx, 6) int8 (zeros without SAO), intra8,
    imode8, tusplit8, ref8, rec_y (C, F*Hp, Wp), rec_c (C, 2F*Hp/2,
    Wp/2)); final_ref = the (C, Hp, Wp) int32 last recons; the rate
    estimates float32, per chain and their sum."""
    c, f, hp, wp = oy.shape
    mesh = list(mesh)
    if c != len(mesh):
        raise ValueError(f"{c} chains on a mesh of {len(mesh)}: one chain "
                         f"per device")
    h, w = cfg.height_padded, cfg.width_padded
    ccfg = chain_config(cfg)
    # every chain enqueued before any is read
    pend = [submit_pgop_gpu(
        oy[ci][:, :h, :w], ocb[ci][:, :h // 2, :w // 2],
        ocr[ci][:, :h // 2, :w // 2],
        ReconFrame(ref_y[ci][:h, :w], ref_cb[ci][:h // 2, :w // 2],
                   ref_cr[ci][:h // 2, :w // 2]),
        ccfg, qp, need_recon=True, me_range=me_range, device=dev)
        for ci, dev in enumerate(mesh)]
    # each chain's estimate on its device, gathered to mesh device 0 and
    # summed in chain order
    calib = calib_for_qp(int(qp))
    rates = []
    for p in pend:
        fields = p.outs
        rates.append(_est_bits(torch.cat([fl[2] for fl in fields]), calib)
                     + _est_bits(torch.cat([fl[3] for fl in fields] +
                                           [fl[4] for fl in fields]), calib))
    total = rates[0].to(mesh[0])
    for r in rates[1:]:
        total = total + r.to(mesh[0])
    chain_rates = np.array([r.item() for r in rates], np.float32)

    ctu = ccfg.ctu_size
    ncty, nctx = (h + ctu - 1) // ctu, (w + ctu - 1) // ctu
    rdt = np_pixel_dtype(cfg.bit_depth)

    def chain_arrays(fields):
        def st(k, dt):
            return np.stack([fl[k].cpu().numpy() for fl in fields]).astype(dt)

        sao = np.stack([np.zeros((3, ncty, nctx, 6), np.int8)
                        if fl[9] is None else fl[9].cpu().numpy()
                        for fl in fields]).astype(np.int8)
        return (st(0, np.uint8), st(1, np.int16),
                st(2, np.int16).reshape(f * hp, wp),
                np.concatenate([st(3, np.int16), st(4, np.int16)])
                .reshape(2 * f * (hp // 2), wp // 2),
                sao, st(5, np.uint8), st(6, np.uint8), st(7, np.uint8),
                st(8, np.uint8), st(10, rdt).reshape(f * hp, wp),
                np.concatenate([st(11, rdt), st(12, rdt)])
                .reshape(2 * f * (hp // 2), wp // 2))

    per_chain = [chain_arrays(p.outs) for p in pend]
    res = tuple(np.stack([pc[k] for pc in per_chain]) for k in range(11))
    # the last recon of each chain, edge-padded at the scan size
    final_ref = tuple(np.stack([p.outs[-1][k].cpu().numpy() for p in pend])
                      for k in (10, 11, 12))
    return res, final_ref, float(total.item()), chain_rates


def encode_chains(chains, cfg: EncoderConfig, qp: int | None = None,
                  mesh=None):
    """chains: list of (frames, ref) where frames is a list of (y, cb,
    cr) P pictures and ref the chain's I recon (a ReconFrame, or a
    DeviceRef, downloaded). Encodes every chain over the mesh (by
    default one CUDA device per chain) and returns ([(FramePSyntax
    list, ReconFrame list) per chain], the summed rate estimate)."""
    qp = cfg.qp if qp is None else qp
    c = len(chains)
    mesh = make_gop_mesh(c) if mesh is None else mesh
    f = len(chains[0][0])
    h, w = cfg.height_padded, cfg.width_padded
    m = max(32, cfg.ctu_size)
    hp = (h + m - 1) // m * m
    wp = (w + m - 1) // m * m
    src_dt = np_pixel_dtype(cfg.bit_depth)

    def padp(p, ph, pw):
        return np.pad(np.asarray(p),
                      ((0, ph - p.shape[0]), (0, pw - p.shape[1])),
                      mode="edge").astype(src_dt)

    refs = [r.to_recon() if isinstance(r, DeviceRef) else r
            for _, r in chains]
    oy = np.stack([[padp(fr[0], hp, wp) for fr in frames]
                   for frames, _ in chains])
    ocb = np.stack([[padp(fr[1], hp // 2, wp // 2) for fr in frames]
                    for frames, _ in chains])
    ocr = np.stack([[padp(fr[2], hp // 2, wp // 2) for fr in frames]
                    for frames, _ in chains])
    ry = np.stack([padp(r.y, hp, wp) for r in refs])
    rcb = np.stack([padp(r.cb, hp // 2, wp // 2) for r in refs])
    rcr = np.stack([padp(r.cr, hp // 2, wp // 2) for r in refs])

    res, _, total_rate, _ = encode_chains_sharded(
        oy, ocb, ocr, ry, rcb, rcr, cfg, qp, mesh, me_range=cfg.me_range)

    depth8 = res[0][:, :, :h // 8, :w // 8]
    mv8 = res[1].astype(np.int32)[:, :, :h // 8, :w // 8]
    cf_y = res[2].reshape(c, f, hp, wp)[:, :, :h, :w]
    cf_c = res[3].reshape(c, 2 * f, hp // 2, wp // 2)[:, :, :h // 2, :w // 2]
    sao_all = res[4].astype(np.int32)
    intra8 = res[5][:, :, :h // 8, :w // 8] != 0
    imode8 = res[6][:, :, :h // 8, :w // 8]
    tusplit8 = res[7][:, :, :h // 8, :w // 8]
    rec_y = res[9].reshape(c, f, hp, wp)[:, :, :h, :w]
    rec_c = res[10].reshape(c, 2 * f, hp // 2, wp // 2) \
        [:, :, :h // 2, :w // 2]

    out = []
    for ci in range(c):
        syns, recons = [], []
        for i in range(f):
            syn = FramePSyntax(
                depth8=depth8[ci, i].astype(np.uint8),
                mv8=mv8[ci, i],
                coeff_y=cf_y[ci, i].astype(np.int32),
                coeff_cb=cf_c[ci, i].astype(np.int32),
                coeff_cr=cf_c[ci, f + i].astype(np.int32))
            syn.sao_params = ((sao_all[ci, i, 0], sao_all[ci, i, 1],
                               sao_all[ci, i, 2]) if cfg.sao else None)
            if intra8[ci, i].any():
                syn.intra8 = intra8[ci, i]
                syn.mode8 = imode8[ci, i]
            if tusplit8[ci, i].any():
                syn.tusplit8 = tusplit8[ci, i]
            syns.append(syn)
            recons.append(ReconFrame(rec_y[ci, i].astype(np.int32),
                                     rec_c[ci, i].astype(np.int32),
                                     rec_c[ci, f + i].astype(np.int32)))
        out.append((syns, recons))
    return out, total_rate


def shared_rc_step(rc, total_rate_bits: float, n_frames: int,
                   qp: int) -> int:
    """Feed the mesh's summed bit estimate into the shared rate
    controller (enc/ratecontrol.py RateControl, ABR) and return the QP
    of the next wave of chains: one controller decision per wave."""
    per_frame = total_rate_bits / max(n_frames, 1)
    for _ in range(n_frames):
        rc.frame_done(int(per_frame), qp, 1.0, False)
    return rc.frame_qp(False, rc.short_cplx_sum /
                       max(rc.short_cplx_count, 1e-9))
