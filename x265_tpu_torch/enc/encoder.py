"""Top-level encoder orchestration for the GPU port (the x265
Encoder::encode analog).

Counterpart of the IPPP path of x265_tpu/enc/encoder.py: an I frame
through device analysis + the wavefront recon + deblock + SAO, then P
chunks through enc/pgop_gpu.py (one or several references, TMVP, SAO),
every frame entropy-coded by the native CABAC and packed into Annex-B
NAL units. The reference picture (or the stack of the R most recent
ones) stays on the device between frames (DeviceRef); the host keeps
the DPB bookkeeping (references available since the IDR, their POCs)
and the collocated picture for TMVP. Options this package does not
implement raise NotImplementedError naming their ROADMAP queue item;
nothing falls back to a reduced mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.ctx_tables import init_states
from ..bitstream.headers import (write_pps, write_slice_header, write_sps,
                                 write_vps)
from ..bitstream.nal import NalUnitType, annexb_stream
from ..bitstream.syntax import FrameIntraSyntax
from ..common.params import EncoderConfig, I_SLICE, P_SLICE
from ..common.tables import lambda2_from_qp
from ..device import resolve_device
from ..native.entropy_native import encode_slice_native
from ..ops.deblock import deblock_frame
from ..ops.sao_gpu import apply_sao_t, choose_sao_chroma_t, choose_sao_t
from .intra_analysis import analyze_chroma_gop, analyze_intra_gop
from .intra_recon import DeviceRef, ReconFrame
from .intra_recon_gpu import reconstruct_intra_gop_gpu
from .pgop_gpu import check_pgop_config, collect_pgop_gpu, submit_pgop_gpu


def pad_plane(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicate to the coded (padded) size."""
    ph, pw = h - p.shape[0], w - p.shape[1]
    if ph == 0 and pw == 0:
        return p
    return np.pad(p, ((0, ph), (0, pw)), mode="edge")


@dataclass
class FrameResult:
    bitstream: bytes            # Annex-B access unit (headers for frame 0)
    recon: ReconFrame | None
    syntax: object
    bits: int = 0
    poc: int = 0
    ftype: str = "I"
    device_ref: DeviceRef | None = None


class IntraEncoder:
    """Low-delay IPPP HEVC encoder, CQP, on one GPU (or the CPU when
    device="cpu")."""

    def __init__(self, cfg: EncoderConfig, device=None) -> None:
        cfg.validate()
        check_pgop_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.frame_count = 0
        self.ref: ReconFrame | DeviceRef | None = None
        self.last_src = None   # source planes of the last encoded frame
        #                        (weightp analysis compares sources)
        self.poc = 0
        self.ref_avail = 1     # distinct pictures in the DPB since the IDR
        self._last_p_syn = None  # the previous P frame (TMVP collocated)

    def headers(self) -> list[tuple[NalUnitType, bytes]]:
        cfg = self.cfg
        return [(NalUnitType.VPS, write_vps(cfg)),
                (NalUnitType.SPS, write_sps(cfg)),
                (NalUnitType.PPS, write_pps(cfg))]

    def _upload(self, planes: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            planes.astype(np.uint8, copy=False))).to(self.device)

    def encode_frame(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     *, use_device_recon: bool = True,
                     qp: int | None = None, need_recon: bool = True,
                     qp_map: np.ndarray | None = None) -> FrameResult:
        """Encode one IDR frame: device analysis, wavefront recon,
        deblock, SAO; the post-filter recon is kept on the device
        (FrameResult.device_ref) and downloaded only on need_recon."""
        cfg = self.cfg
        if not use_device_recon:
            raise NotImplementedError(
                "host-recon I path: not ported yet (ROADMAP queue 1 item 18)")
        if qp_map is not None:
            raise NotImplementedError(
                "per-CTU QP maps: not ported yet (ROADMAP queue 1 item 15)")
        qp = cfg.qp if qp is None else qp
        self.last_src = (y, cb, cr)
        w, h = cfg.width_padded, cfg.height_padded
        yp = self._upload(pad_plane(np.asarray(y), h, w)[None])
        cbp = self._upload(pad_plane(np.asarray(cb), h // 2, w // 2)[None])
        crp = self._upload(pad_plane(np.asarray(cr), h // 2, w // 2)[None])

        # CTU 64: intra CUs cap at 32, so the analysis runs on the 32
        # grid and its depths shift one level down the 64 tree
        depth8, mode8, nxn8, mode4 = analyze_intra_gop(
            yp, qp, min(cfg.ctu_size, 32), cfg.bit_depth,
            intra_nxn=cfg.intra_nxn)
        cmode8 = analyze_chroma_gop(cbp, crp, depth8, mode8, qp,
                                    cfg.bit_depth)
        if cfg.ctu_size == 64:
            depth8 = depth8 + 1
        d8, m8, c8, nx8, m4 = (t.cpu().numpy() for t in
                               (depth8, mode8, cmode8, nxn8, mode4))
        syns, (ry, rcb, rcr) = reconstruct_intra_gop_gpu(
            yp, cbp, crp, d8, m8, cfg, qp, cmode8=c8, nxn8=nx8, mode4=m4)
        syn: FrameIntraSyntax = syns[0]
        dy, dcb, dcr = ry[0], rcb[0], rcr[0]
        if cfg.deblock:
            dy, dcb, dcr = deblock_frame(dy, dcb, dcr, depth8[0],
                                         cfg.ctu_size, qp, cfg.bit_depth)
        sao_params = None
        if cfg.sao:
            lam2 = float(lambda2_from_qp(qp))
            oy, ocb, ocr = (p[0].to(torch.int32) for p in (yp, cbp, crp))
            p_y = choose_sao_t(oy, dy, cfg.ctu_size, qp, cfg.bit_depth, lam2)
            p_cb, p_cr = choose_sao_chroma_t(ocb, dcb, ocr, dcr,
                                             cfg.ctu_size // 2, qp,
                                             cfg.bit_depth, lam2)
            dy = apply_sao_t(dy, p_y, cfg.ctu_size, cfg.bit_depth)
            dcb = apply_sao_t(dcb, p_cb, cfg.ctu_size // 2, cfg.bit_depth)
            dcr = apply_sao_t(dcr, p_cr, cfg.ctu_size // 2, cfg.bit_depth)
            sao_params = tuple(p.cpu().numpy() for p in (p_y, p_cb, p_cr))
        device_ref = DeviceRef(*(p.to(torch.uint8).contiguous()
                                 for p in (dy, dcb, dcr)))
        recon = device_ref.to_recon() if need_recon else None

        sw = write_slice_header(cfg, I_SLICE, idr=True, slice_qp=qp)
        payload, tail_val, tail_bits = encode_slice_native(
            2, syn.depth8, syn.coeff_y, syn.coeff_cb, syn.coeff_cr,
            w, h, cfg.log2_ctu, cfg.log2_min_cu, init_states(I_SLICE, qp),
            mode8=syn.mode8, sign_hiding=cfg.sign_hiding, cmode8=syn.cmode8,
            nxn8=syn.nxn8, mode4=syn.mode4, sao_params=sao_params,
            slice_qp=qp)
        sw.write_bytes(payload)
        if tail_bits:
            sw.write(tail_val, tail_bits)
        sw.align_one()

        nals: list[tuple] = []
        if self.frame_count == 0:
            nals.extend(self.headers())
        nals.append((NalUnitType.IDR_W_RADL, sw.get_bytes(), b""))
        stream = annexb_stream(nals)
        self.frame_count += 1
        self.ref_avail = 1           # the IDR resets the DPB
        self._last_p_syn = None
        return FrameResult(bitstream=stream, recon=recon, syntax=syn,
                           bits=len(stream) * 8, poc=0, ftype="I",
                           device_ref=device_ref)

    def _pgop_weights(self, frames):
        """Per-frame weightp analysis for a P chunk (source vs source).
        Returns (WeightParams list or None, (F, 6) int32 or None)."""
        if not self.cfg.weightp:
            return None, None
        from .weightp import analyse_gop_weights
        wps = analyse_gop_weights(frames, self.last_src, self.cfg.bit_depth)
        return wps, np.stack([wp.vec() for wp in wps])

    def _emit_p_frames(self, syns, recons, qp: int, poc_step: int = 1,
                       weights_hdr=None) -> list[FrameResult]:
        """Slice headers + native CABAC + NAL packaging for a collected
        P chunk, with the DPB bookkeeping: the slice lists min(R,
        pictures since the IDR) references, its refIdx are clamped to
        them (the device's duplicate slots hold the same pixels), and
        with TMVP the previous P frame is the collocated picture."""
        cfg = self.cfg
        w, h = cfg.width_padded, cfg.height_padded
        nrefs = cfg.num_refs
        results = []
        for i, syn in enumerate(syns):
            self.poc += poc_step
            avail = max(1, min(nrefs, self.ref_avail))
            syn.num_ref = avail
            syn.poc = self.poc
            syn.ref_pocs = tuple(self.poc - poc_step * (k + 1)
                                 for k in range(avail))
            syn.max_merge = max(syn.max_merge, cfg.max_merge)
            if syn.ref8 is not None:
                syn.ref8 = np.minimum(syn.ref8, avail - 1).astype(np.uint8)
                if not syn.ref8.any():
                    syn.ref8 = None
            col = None
            if cfg.tmvp and self._last_p_syn is not None:
                prev = self._last_p_syn
                syn.col_mv = prev.mv8
                syn.col_ref = prev.ref8 if prev.ref8 is not None \
                    else np.zeros_like(prev.depth8, np.uint8)
                syn.col_inter = np.ones_like(prev.depth8, bool) \
                    if prev.intra8 is None else ~prev.intra8
                syn.col_poc = prev.poc
                syn.col_ref_pocs = prev.ref_pocs or (prev.poc - 1,)
                col = (prev.mv8, syn.col_ref, syn.col_inter.astype(np.uint8),
                       prev.poc, syn.col_ref_pocs)
            self.ref_avail = min(nrefs, avail + 1)
            sw = write_slice_header(
                cfg, P_SLICE, idr=False, poc=self.poc,
                ref_delta_poc=poc_step, max_merge=syn.max_merge,
                slice_qp=qp,
                weights=None if weights_hdr is None else weights_hdr[i],
                num_ref=syn.num_ref, tmvp=cfg.tmvp)
            payload, tail_val, tail_bits = encode_slice_native(
                1, syn.depth8, syn.coeff_y, syn.coeff_cb, syn.coeff_cr,
                w, h, cfg.log2_ctu, cfg.log2_min_cu,
                init_states(P_SLICE, qp), mv8=syn.mv8,
                max_merge=syn.max_merge, sign_hiding=cfg.sign_hiding,
                sao_params=syn.sao_params, slice_qp=qp, mode8=syn.mode8,
                intra8=syn.intra8, tusplit8=syn.tusplit8,
                rqt_inter=cfg.rqt_inter, ref8=syn.ref8,
                num_ref=syn.num_ref, ref_pocs_l0=syn.ref_pocs, poc=syn.poc,
                tmvp=cfg.tmvp, col=col)
            sw.write_bytes(payload)
            if tail_bits:
                sw.write(tail_val, tail_bits)
            sw.align_one()
            stream = annexb_stream([(NalUnitType.TRAIL_R, sw.get_bytes(),
                                     b"")])
            self.frame_count += 1
            self._last_p_syn = syn     # TMVP collocated for the next P
            results.append(FrameResult(bitstream=stream, recon=recons[i],
                                       syntax=syn, bits=len(stream) * 8,
                                       poc=self.poc, ftype="P"))
        return results

    def _stack(self, frames):
        w, h = self.cfg.width_padded, self.cfg.height_padded
        return (np.stack([pad_plane(np.asarray(f[0]), h, w)
                          for f in frames]),
                np.stack([pad_plane(np.asarray(f[1]), h // 2, w // 2)
                          for f in frames]),
                np.stack([pad_plane(np.asarray(f[2]), h // 2, w // 2)
                          for f in frames]))

    def _submit(self, frames, qp: int, need_recon: bool):
        if self.ref.y.ndim != 3:
            self.ref_avail = 1       # a single picture: 1 distinct ref
        wps, wvecs = self._pgop_weights(frames)
        pend = submit_pgop_gpu(*self._stack(frames), self.ref, self.cfg, qp,
                               need_recon=need_recon,
                               me_range=self.cfg.me_range, weights=wvecs,
                               device=self.device)
        self.ref = pend.last_ref
        self.last_src = frames[-1]
        return pend, wps

    def encode_pgop(self, frames, qp: int | None = None,
                    need_recon: bool = True,
                    poc_step: int = 1) -> list[FrameResult]:
        """One P chunk against the current reference: device pipeline,
        then per-frame native CABAC."""
        assert self.ref is not None, "no reference: encode an I frame first"
        qp = self.cfg.qp if qp is None else qp
        pend, wps = self._submit(frames, qp, need_recon)
        syns, recons, _ = collect_pgop_gpu(pend)
        return self._emit_p_frames(syns, recons, qp, poc_step,
                                   weights_hdr=wps)

    def encode_pgop_pipelined(self, frames, qp: int | None = None,
                              chunk: int = 8, need_recon: bool = False,
                              poc_step: int = 1) -> list[FrameResult]:
        """Pipelined IPPP: chunk k+1 is enqueued on the device before
        chunk k's host tail (CABAC + NAL) runs, so the host tail
        overlaps device work. The reference chain stays on the device."""
        assert self.ref is not None, "no reference: encode an I frame first"
        qp = self.cfg.qp if qp is None else qp
        results: list[FrameResult] = []
        pend_emit = None
        for s in range(0, len(frames), chunk):
            pend, wps = self._submit(frames[s:s + chunk], qp, need_recon)
            if pend_emit is not None:
                results.extend(self._emit_p_frames(
                    *pend_emit[:2], qp, poc_step, weights_hdr=pend_emit[2]))
            syns, recons, _ = collect_pgop_gpu(pend)
            pend_emit = (syns, recons, wps)
        if pend_emit is not None:
            results.extend(self._emit_p_frames(
                *pend_emit[:2], qp, poc_step, weights_hdr=pend_emit[2]))
        return results
