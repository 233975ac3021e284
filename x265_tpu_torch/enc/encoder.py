"""Top-level encoder orchestration for the GPU port (the x265
Encoder::encode analog).

Counterpart of x265_tpu/enc/encoder.py: an I frame through device
analysis + the wavefront recon + deblock + SAO (or F of them through
one batched wavefront, encode_gop), or through the host-recon I path
(a per-CTU QP map, lossless, CTU 16), P chunks through enc/pgop_gpu.py
(one or several references, TMVP, SAO, RDOQ, noise reduction, the
lowpass DCT, per-CTU QP maps), hierarchical mini-GOPs whose B layers
run through enc/bframe_gpu.py (RDOQ too; the I frame, as the
reference's, uses none of the three), B frames one at a time through
the host B path (enc/bi_frame.py: encode_frame_b, encode_bgop,
encode_minigop(device=False)), and encode_sequence, whose QP
maps come from the device lookahead (enc/lookahead_gpu.py, AQ and
cuTree); every frame entropy-coded by the native CABAC (with WPP one
substream per CTU row; an I frame by the Python slice coder,
bitstream/syntax.py SliceSyntaxEncoder, when asked) and packed into
Annex-B NAL units, followed by its decoded-picture-hash SEI when
cfg.hash_sei asks. P chunks take
analysis-reuse seeds (encode_pgop(seeds16=)). Reference pictures
stay on the device between frames (DeviceRef); the host keeps the DPB
bookkeeping (references available since the IDR, their POCs, the
mini-GOP's retention RPS), the collocated picture for TMVP and the
encode statistics. Options this package does not implement raise
NotImplementedError naming their ROADMAP queue item; nothing falls back
to a reduced mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..bitstream.ctx_tables import init_states
from ..bitstream.headers import (write_pps, write_slice_header, write_sps,
                                 write_vps)
from ..bitstream.nal import NalUnitType, annexb_stream, emulation_prevention
from ..bitstream.sei import write_picture_hash_sei
from ..bitstream.syntax import (FrameIntraSyntax, FramePSyntax,
                                SliceSyntaxEncoder)
from ..common.params import B_SLICE, EncoderConfig, I_SLICE, P_SLICE
from ..common.tables import lambda2_from_qp
from ..device import resolve_device
from ..native.entropy_native import (encode_slice_native,
                                     encode_slice_wpp_native)
from ..ops.deblock import (deblock_frame, deblock_frame_np, deblock_luma_np,
                           inter_bs_maps_b)
from ..ops.sao import (apply_sao_component_np, choose_sao_chroma,
                       choose_sao_params)
from ..ops.sao_gpu import apply_sao_t, choose_sao_chroma_t, choose_sao_t
from .intra_analysis import (analyze_chroma_gop, analyze_chroma_modes,
                             analyze_intra_frame, analyze_intra_gop)
from .intra_recon import (DeviceRef, ReconFrame, np_pixel_dtype, pixel_dtype,
                          reconstruct_intra_frame)
from .intra_recon_gpu import reconstruct_intra_gop_gpu
from .pgop_gpu import (check_pgop_config, collect_pgop_gpu, ctu_grid,
                       submit_pgop_gpu)

def pad_plane(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicate to the coded (padded) size."""
    ph, pw = h - p.shape[0], w - p.shape[1]
    if ph == 0 and pw == 0:
        return p
    return np.pad(p, ((0, ph), (0, pw)), mode="edge")


def effective_qp_map(qp_map: np.ndarray, coeff_y: np.ndarray,
                     coeff_cb: np.ndarray, coeff_cr: np.ndarray,
                     ctu: int, slice_qp: int) -> np.ndarray:
    """The per-CTU QP a decoder will infer: a CTU that codes no residual
    never signals cu_qp_delta, so its QP is the predictor (the previous
    QG in raster order; the slice QP at the start). The deblock's tc
    and beta use it (clause 8.7.2.5.3)."""
    ncty, nctx = qp_map.shape
    eff = np.empty_like(qp_map)
    prev = slice_qp
    c = ctu // 2
    for ty in range(ncty):
        y0 = ty * ctu
        for tx in range(nctx):
            x0 = tx * ctu
            any_c = (coeff_y[y0:y0 + ctu, x0:x0 + ctu].any()
                     or coeff_cb[y0 // 2:y0 // 2 + c,
                                 x0 // 2:x0 // 2 + c].any()
                     or coeff_cr[y0 // 2:y0 // 2 + c,
                                 x0 // 2:x0 // 2 + c].any())
            prev = int(qp_map[ty, tx]) if any_c else prev
            eff[ty, tx] = prev
    return eff


@dataclass
class FrameStats:
    """Per-frame statistics record (the x265_frame_stats analog): coding
    results and encode-latency telemetry."""
    poc: int = 0
    ftype: str = "I"
    qp: int = 0
    bits: int = 0
    wall_time: float = 0.0        # seconds spent producing this frame
    cu_pct_by_depth: tuple = ()   # % of picture area per CU depth
    skip_pct: float = 0.0


@dataclass
class EncoderStats:
    """Global encode statistics (the x265_stats analog)."""
    frame_count: int = 0
    total_bits: int = 0
    qp_sum: int = 0
    count_by_type: dict = field(default_factory=lambda: {"I": 0, "P": 0,
                                                         "B": 0})
    bits_by_type: dict = field(default_factory=lambda: {"I": 0, "P": 0,
                                                        "B": 0})
    total_wall: float = 0.0
    frames: list = field(default_factory=list)   # FrameStats records

    def add(self, ftype: str, bits: int, qp: int, *, poc: int = 0,
            wall_time: float = 0.0, syn=None) -> None:
        self.frame_count += 1
        self.total_bits += bits
        self.qp_sum += qp
        self.count_by_type[ftype] += 1
        self.bits_by_type[ftype] += bits
        self.total_wall += wall_time
        fs = FrameStats(poc=poc, ftype=ftype, qp=qp, bits=bits,
                        wall_time=wall_time)
        if syn is not None and getattr(syn, "depth8", None) is not None:
            d8 = np.asarray(syn.depth8)
            tot = max(d8.size, 1)
            fs.cu_pct_by_depth = tuple(
                round(float((d8 == d).sum()) * 100.0 / tot, 2)
                for d in range(3))
        self.frames.append(fs)

    def summary(self, fps: float = 25.0) -> dict:
        n = max(self.frame_count, 1)
        return {
            "frames": self.frame_count,
            "kbps": self.total_bits * fps / n / 1000.0,
            "avg_qp": self.qp_sum / n,
            "count_by_type": dict(self.count_by_type),
            "bits_by_type": dict(self.bits_by_type),
            "encode_fps": (self.frame_count / self.total_wall
                           if self.total_wall > 0 else 0.0),
        }


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
    """HEVC encoder, CQP with optional per-CTU QP (AQ, cuTree), on one
    GPU (or the CPU when device="cpu"): low-delay IPPP, or
    hierarchical-B mini-GOPs at CTU 32."""

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
        self.stats = EncoderStats()
        self.host_i_seconds = {}    # the last host-recon I frame's stages
        self.lookahead_seconds = []  # one entry per lookahead_qp_maps

    def reconfigure(self, **updates) -> int:
        """x265_encoder_reconfig analog: latch parameter changes for the
        next frame; returns 0 on success, -1 if an update is not
        reconfigurable (every reconfigurable field is ported)."""
        try:
            self.cfg.reconfigure(**updates)
        except (ValueError, NotImplementedError):
            return -1
        return 0

    def get_stats(self) -> dict:
        """Encode-session summary (x265_encoder_get_stats analog)."""
        fps = self.cfg.fps_num / max(self.cfg.fps_den, 1)
        return self.stats.summary(fps)

    def _newest_ref(self) -> DeviceRef:
        """self.ref's newest picture as a single-picture DeviceRef (slot
        0 of a stack, a host ReconFrame uploaded once), which then
        becomes self.ref: the reference's _host_ref, kept on the
        device."""
        ref = self.ref
        if isinstance(ref, DeviceRef):
            if ref.y.dim() == 3:
                ref = DeviceRef(ref.y[0], ref.cb[0], ref.cr[0])
        else:
            ref = DeviceRef(*(self._upload(np.asarray(p))
                              for p in (ref.y, ref.cb, ref.cr)))
        self.ref = ref
        return ref

    def headers(self) -> list[tuple[NalUnitType, bytes]]:
        cfg = self.cfg
        return [(NalUnitType.VPS, write_vps(cfg)),
                (NalUnitType.SPS, write_sps(cfg)),
                (NalUnitType.PPS, write_pps(cfg))]

    def _upload(self, planes: np.ndarray) -> torch.Tensor:
        # a reader's frames may be read-only views of its buffer; the
        # samples keep the configured bit depth (uint16 at 10 bits)
        return torch.from_numpy(np.require(
            planes.astype(np_pixel_dtype(self.cfg.bit_depth), copy=False),
            requirements=("C", "W"))).to(self.device)

    def encode_frame(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     *, use_device_recon: bool = True,
                     use_native_cabac: bool = True,
                     qp: int | None = None, need_recon: bool = True,
                     qp_map: np.ndarray | None = None) -> FrameResult:
        """Encode one IDR frame: device analysis, wavefront recon,
        deblock, SAO; the post-filter recon is kept on the device
        (FrameResult.device_ref) and downloaded only on need_recon.

        The host-recon I path (use_device_recon=False) reconstructs on
        the host instead, after the same analysis on the device; every
        frame with a per-CTU QP map takes it (qp_map (ncty, nctx), or a
        flat one when cfg.dqp_enabled: the PPS then signals
        cu_qp_delta), as do lossless and CTU-16 frames. A map on the
        lookahead's floor-16 grid is edge-extended to the CTU grid.
        use_native_cabac=False codes the slice with the Python coder
        (SliceSyntaxEncoder) instead of the native one: the same bytes."""
        cfg = self.cfg
        t_start = time.perf_counter()
        qp = cfg.qp if qp is None else qp
        self.last_src = (y, cb, cr)
        if cfg.lossless:
            # transquant bypass: loop filters and parity tricks are
            # meaningless on exact residuals (x265 forces these off too)
            cfg.deblock = cfg.sao = cfg.sign_hiding = cfg.rdoq = False
            use_device_recon = False
        if cfg.ctu_size == 16:
            use_device_recon = False     # the wavefront runs CTU 32/64
        if qp_map is None and cfg.dqp_enabled:
            qp_map = np.full((cfg.ctu_rows, cfg.ctu_cols), qp, np.int32)
        if qp_map is not None:
            if not cfg.dqp_enabled:
                raise ValueError("qp_map needs cfg.aq_mode or cfg.cutree on")
            qp_map = ctu_grid(qp_map, cfg.ctu_rows, cfg.ctu_cols)
            use_device_recon = False
        w, h = cfg.width_padded, cfg.height_padded
        if not use_device_recon:
            return self._encode_frame_host(y, cb, cr, qp, qp_map, t_start,
                                           use_native_cabac)
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
        rdt = pixel_dtype(cfg.bit_depth)
        device_ref = DeviceRef(*(p.to(rdt).contiguous()
                                 for p in (dy, dcb, dcr)))
        recon = device_ref.to_recon() if need_recon or cfg.hash_sei \
            else None
        return self._emit_i_frame(syn, recon, device_ref, sao_params, qp,
                                  None, t_start, use_native_cabac)

    def _encode_frame_host(self, y, cb, cr, qp: int, qp_map, t_start,
                           use_native_cabac: bool = True) -> FrameResult:
        """The host-recon I path: device analysis, then the z-scan
        reconstruction, deblock (each CTU at the QP a decoder infers
        for it) and SAO on the host, in numpy. The recon is uploaded as
        the next reference (FrameResult.device_ref). The seconds of each
        stage are kept in self.host_i_seconds."""
        cfg = self.cfg
        w, h = cfg.width_padded, cfg.height_padded
        yp = pad_plane(np.asarray(y), h, w)
        cbp = pad_plane(np.asarray(cb), h // 2, w // 2)
        crp = pad_plane(np.asarray(cr), h // 2, w // 2)
        # CTU 64: intra CUs cap at 32 (analysis on the 32 grid, depths
        # shifted one level down the 64 tree)
        dshift = 1 if cfg.ctu_size == 64 else 0
        depth8, mode8, nxn8, mode4 = analyze_intra_frame(
            self._upload(yp), qp, min(cfg.ctu_size, 32), cfg.bit_depth,
            intra_nxn=cfg.intra_nxn)
        depth8 = depth8 + dshift
        cmode8 = analyze_chroma_modes(self._upload(cbp), self._upload(crp),
                                      depth8 - dshift, mode8, qp,
                                      cfg.bit_depth)
        t_an = time.perf_counter()
        syn, recon = reconstruct_intra_frame(yp, cbp, crp, depth8, mode8,
                                             cfg, qp, cmode8=cmode8,
                                             nxn8=nxn8, mode4=mode4,
                                             qp_map=qp_map)
        t_rec = time.perf_counter()
        if cfg.deblock:
            dqp = qp
            if qp_map is not None:
                eff = effective_qp_map(qp_map, syn.coeff_y, syn.coeff_cb,
                                       syn.coeff_cr, cfg.ctu_size, qp)
                k = cfg.ctu_size // 8
                dqp = np.repeat(np.repeat(eff, k, 0), k, 1)[:h // 8, :w // 8]
            recon = ReconFrame(*deblock_frame_np(
                recon.y, recon.cb, recon.cr, depth8, cfg.ctu_size, dqp,
                cfg.bit_depth))
        sao_params = None
        if cfg.sao:
            p_y = choose_sao_params(yp, recon.y, cfg.ctu_size, qp,
                                    cfg.bit_depth)
            p_cb, p_cr = choose_sao_chroma(cbp, recon.cb, crp, recon.cr,
                                           cfg.ctu_size // 2, qp,
                                           cfg.bit_depth)
            recon = ReconFrame(
                apply_sao_component_np(recon.y, p_y, cfg.ctu_size,
                                       cfg.bit_depth),
                apply_sao_component_np(recon.cb, p_cb, cfg.ctu_size // 2,
                                       cfg.bit_depth),
                apply_sao_component_np(recon.cr, p_cr, cfg.ctu_size // 2,
                                       cfg.bit_depth))
            sao_params = (p_y, p_cb, p_cr)
        t_filt = time.perf_counter()
        device_ref = DeviceRef(*(self._upload(p)
                                 for p in (recon.y, recon.cb, recon.cr)))
        res = self._emit_i_frame(syn, recon, device_ref, sao_params, qp,
                                 qp_map, t_start, use_native_cabac)
        self.host_i_seconds = {"analysis": t_an - t_start,
                               "recon": t_rec - t_an,
                               "filters": t_filt - t_rec,
                               "cabac": time.perf_counter() - t_filt}
        return res

    def _code_slice(self, slice_type: int, syn, qp: int, header: dict,
                    coder: dict, native: bool = True) -> tuple[bytes, bytes]:
        """Slice header + CABAC slice data of one picture. Returns
        (rbsp, escaped): without WPP the rbsp holds both and escaped is
        empty; with WPP (cfg.wpp) the data is one substream per CTU row,
        already emulation-prevented, after a header that lists their
        entry points, counted in escaped bytes (clause 7.4.7.1). The
        native coder takes the coder kwargs; native=False codes the same
        bytes with the Python SliceSyntaxEncoder, which reads its options
        from cfg and the syntax record."""
        cfg = self.cfg
        if native:
            # the native coder takes the slice_type code (B 0, P 1, I 2)
            args = (slice_type, syn.depth8, syn.coeff_y, syn.coeff_cb,
                    syn.coeff_cr, cfg.width_padded, cfg.height_padded,
                    cfg.log2_ctu, cfg.log2_min_cu,
                    init_states(slice_type, qp))
        else:
            python = SliceSyntaxEncoder(cfg, syn, slice_type, qp,
                                        sao_params=coder.get("sao_params"),
                                        qp_map=coder.get("qp_map"))
        if cfg.wpp:
            subs = encode_slice_wpp_native(*args, **coder) if native \
                else python.encode_slice_data_wpp()
            escaped = [emulation_prevention(sub) for sub in subs]
            sw = write_slice_header(
                cfg, slice_type, num_entry_points=len(escaped) - 1,
                entry_point_offsets=[len(e) for e in escaped[:-1]], **header)
            return sw.get_bytes(), b"".join(escaped)
        sw = write_slice_header(cfg, slice_type, **header)
        if native:
            payload, tail_val, tail_bits = encode_slice_native(*args, **coder)
            sw.write_bytes(payload)
            if tail_bits:
                sw.write(tail_val, tail_bits)
        else:
            python.encode_slice_data().finish_into(sw)
        sw.align_one()
        return sw.get_bytes(), b""

    def _picture_nals(self, nal_type, rbsp: bytes, escaped: bytes,
                      recon) -> list[tuple]:
        """The slice NAL of one picture, then with cfg.hash_sei its
        decoded-picture-hash suffix SEI over the recon."""
        cfg = self.cfg
        nals = [(nal_type, rbsp, escaped)]
        if cfg.hash_sei:
            nals.append(write_picture_hash_sei(recon.y, recon.cb, recon.cr,
                                               cfg.bit_depth,
                                               int(cfg.hash_sei)))
        return nals

    def _emit_i_frame(self, syn, recon, device_ref, sao_params, qp: int,
                      qp_map, t_start, native: bool = True) -> FrameResult:
        """Slice header + I CABAC (native, or the Python coder) + NAL
        packaging of one IDR."""
        cfg = self.cfg
        rbsp, pre = self._code_slice(
            I_SLICE, syn, qp, dict(idr=True, slice_qp=qp),
            dict(mode8=syn.mode8, sign_hiding=cfg.sign_hiding,
                 cmode8=syn.cmode8, nxn8=syn.nxn8, mode4=syn.mode4,
                 sao_params=sao_params, qp_map=qp_map, slice_qp=qp,
                 lossless=cfg.lossless), native)
        nals: list[tuple] = []
        if self.frame_count == 0:
            nals.extend(self.headers())
        stream = annexb_stream(nals + self._picture_nals(
            NalUnitType.IDR_W_RADL, rbsp, pre, recon))
        self.frame_count += 1
        self.ref_avail = 1           # the IDR resets the DPB
        self._last_p_syn = None
        self.stats.add("I", len(stream) * 8, qp, poc=0, syn=syn,
                       wall_time=time.perf_counter() - t_start)
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
            rbsp, pre = self._code_slice(
                P_SLICE, syn, qp,
                dict(idr=False, poc=self.poc, ref_delta_poc=poc_step,
                     max_merge=syn.max_merge, slice_qp=qp,
                     weights=None if weights_hdr is None
                     else weights_hdr[i],
                     num_ref=syn.num_ref, tmvp=cfg.tmvp),
                dict(mv8=syn.mv8, max_merge=syn.max_merge,
                     sign_hiding=cfg.sign_hiding, sao_params=syn.sao_params,
                     qp_map=syn.qp_map, slice_qp=qp, mode8=syn.mode8,
                     intra8=syn.intra8, tusplit8=syn.tusplit8,
                     rqt_inter=cfg.rqt_inter, ref8=syn.ref8,
                     num_ref=syn.num_ref, ref_pocs_l0=syn.ref_pocs,
                     poc=syn.poc, tmvp=cfg.tmvp, col=col))
            stream = annexb_stream(self._picture_nals(
                NalUnitType.TRAIL_R, rbsp, pre, recons[i]))
            self.frame_count += 1
            self.stats.add("P", len(stream) * 8, qp, poc=self.poc, syn=syn)
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

    def _submit(self, frames, qp: int, need_recon: bool, qp_maps=None,
                seeds16=None):
        """Enqueue a P chunk; the recon comes back when asked for or
        when the hash SEI needs it."""
        if self.ref.y.ndim != 3:
            self.ref_avail = 1       # a single picture: 1 distinct ref
        wps, wvecs = self._pgop_weights(frames)
        need_recon = need_recon or bool(self.cfg.hash_sei)
        pend = submit_pgop_gpu(*self._stack(frames), self.ref, self.cfg, qp,
                               need_recon=need_recon,
                               me_range=self.cfg.me_range, qp_maps=qp_maps,
                               seeds16=seeds16, weights=wvecs,
                               device=self.device)
        self.ref = pend.last_ref
        self.last_src = frames[-1]
        return pend, wps

    def encode_pgop(self, frames, qp: int | None = None,
                    need_recon: bool = True, poc_step: int = 1,
                    qp_maps: np.ndarray | None = None,
                    seeds16: np.ndarray | None = None) -> list[FrameResult]:
        """One P chunk against the current reference: device pipeline,
        then per-frame native CABAC. qp_maps: (F, ncty, nctx) per-CTU
        QP maps (dQP; cfg.dqp_enabled); seeds16: (F, by16, bx16, 2)
        full-pel MVs of an earlier pass that replace the coarse search
        (analysis reuse)."""
        assert self.ref is not None, "no reference: encode an I frame first"
        qp = self.cfg.qp if qp is None else qp
        pend, wps = self._submit(frames, qp, need_recon, qp_maps, seeds16)
        syns, recons, _ = collect_pgop_gpu(pend)
        return self._emit_p_frames(syns, recons, qp, poc_step,
                                   weights_hdr=wps)

    def encode_pgop_pipelined(self, frames, qp: int | None = None,
                              chunk: int = 8, need_recon: bool = False,
                              qp_maps: np.ndarray | None = None,
                              poc_step: int = 1) -> list[FrameResult]:
        """Pipelined IPPP: chunk k+1 is enqueued on the device before
        chunk k's host tail (CABAC + NAL) runs, so the host tail
        overlaps device work. The reference chain stays on the device.
        qp_maps: one per-CTU QP map per frame (dQP)."""
        assert self.ref is not None, "no reference: encode an I frame first"
        qp = self.cfg.qp if qp is None else qp
        results: list[FrameResult] = []
        pend_emit = None
        for s in range(0, len(frames), chunk):
            pend, wps = self._submit(
                frames[s:s + chunk], qp, need_recon,
                None if qp_maps is None else qp_maps[s:s + chunk])
            if pend_emit is not None:
                results.extend(self._emit_p_frames(
                    *pend_emit[:2], qp, poc_step, weights_hdr=pend_emit[2]))
            syns, recons, _ = collect_pgop_gpu(pend)
            pend_emit = (syns, recons, wps)
        if pend_emit is not None:
            results.extend(self._emit_p_frames(
                *pend_emit[:2], qp, poc_step, weights_hdr=pend_emit[2]))
        return results

    def encode_frame_p(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       qp: int | None = None,
                       poc_step: int = 1) -> FrameResult:
        """One P frame against the current reference: a P chunk of
        one."""
        return self.encode_pgop([(y, cb, cr)], qp=qp, poc_step=poc_step)[0]

    def encode_dup_frame(self, qp: int | None = None) -> FrameResult:
        """A duplicate frame as an all-skip P picture (the CFR frame
        duplication analog): every CTU a zero-MV skip CU, so the recon
        equals the reference exactly. The duplicate restarts the
        multi-reference chain from that one picture. Host only."""
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        assert self.ref is not None, "no reference to duplicate"
        w, h = cfg.width_padded, cfg.height_padded
        n8y, n8x = h // 8, w // 8
        syn = FramePSyntax(
            depth8=np.zeros((n8y, n8x), np.uint8),
            mv8=np.zeros((n8y, n8x, 2), np.int32),
            coeff_y=np.zeros((h, w), np.int32),
            coeff_cb=np.zeros((h // 2, w // 2), np.int32),
            coeff_cr=np.zeros((h // 2, w // 2), np.int32))
        dup = self._newest_ref()
        rs = self._emit_p_frames([syn], [dup.to_recon()], qp)
        self.ref_avail = 1
        return rs[0]

    def encode_gop(self, frames, need_recon: bool = True
                   ) -> list[FrameResult]:
        """F I frames through one batched wavefront (device analysis of
        all frames, then the recon), deblocked, then per-frame native
        CABAC. As in the reference: every frame at cfg.qp, no SAO,
        headers before the first frame of the stream only; the DPB is
        left as it was."""
        cfg = self.cfg
        w, h = cfg.width_padded, cfg.height_padded
        ys = self._upload(np.stack([pad_plane(np.asarray(f[0]), h, w)
                                    for f in frames]))
        cbs = self._upload(np.stack([pad_plane(np.asarray(f[1]), h // 2,
                                               w // 2) for f in frames]))
        crs = self._upload(np.stack([pad_plane(np.asarray(f[2]), h // 2,
                                               w // 2) for f in frames]))
        depth8, mode8, nxn8, mode4 = analyze_intra_gop(
            ys, cfg.qp, cfg.ctu_size, cfg.bit_depth, intra_nxn=cfg.intra_nxn)
        cmode8 = analyze_chroma_gop(cbs, crs, depth8, mode8, cfg.qp,
                                    cfg.bit_depth)
        d8, m8, c8, nx8, m4 = (t.cpu().numpy() for t in
                               (depth8, mode8, cmode8, nxn8, mode4))
        syns, (ry, rcb, rcr) = reconstruct_intra_gop_gpu(
            ys, cbs, crs, d8, m8, cfg, cfg.qp, cmode8=c8, nxn8=nx8,
            mode4=m4)
        results = []
        for f, syn in enumerate(syns):
            planes = (ry[f], rcb[f], rcr[f])
            if cfg.deblock:
                planes = deblock_frame(*planes, depth8[f], cfg.ctu_size,
                                       cfg.qp, cfg.bit_depth)
            recon = ReconFrame(*(p.cpu().numpy().astype(np.int32)
                                 for p in planes)) if need_recon else None
            sw = write_slice_header(cfg, I_SLICE, idr=True)
            payload, tail_val, tail_bits = encode_slice_native(
                2, syn.depth8, syn.coeff_y, syn.coeff_cb, syn.coeff_cr,
                w, h, cfg.log2_ctu, cfg.log2_min_cu,
                init_states(I_SLICE, cfg.qp), mode8=syn.mode8,
                sign_hiding=cfg.sign_hiding, cmode8=syn.cmode8,
                nxn8=syn.nxn8, mode4=syn.mode4)
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
            results.append(FrameResult(bitstream=stream, recon=recon,
                                       syntax=syn, bits=len(stream) * 8))
        return results

    # ------------------------------------------------------------------
    # hierarchical-B mini-GOPs
    # ------------------------------------------------------------------

    def _emit_b_frame(self, syn, recon, qp: int, poc: int, poc_refs,
                      is_ref: bool, rps_neg, rps_pos) -> FrameResult:
        """Slice header + native B CABAC + NAL packaging for one (already
        reconstructed) B frame."""
        cfg = self.cfg
        qp_map = syn.qp_map if getattr(syn, "qp_map", None) is not None \
            else (np.full((cfg.ctu_rows, cfg.ctu_cols), qp, np.int32)
                  if cfg.dqp_enabled else None)
        mvb = syn.mv8.reshape(syn.mv8.shape[0], syn.mv8.shape[1], 4)
        rbsp, pre = self._code_slice(
            B_SLICE, syn, qp,
            dict(idr=False, poc=poc, slice_qp=qp,
                 ref_delta_poc=poc - poc_refs[0],
                 ref_delta_poc_after=poc_refs[1] - poc,
                 max_merge=syn.max_merge, rps_neg=rps_neg, rps_pos=rps_pos),
            dict(mvb=mvb, pf8=syn.pf8, poc=poc, poc_refs=poc_refs,
                 max_merge=syn.max_merge, sign_hiding=cfg.sign_hiding,
                 sao_params=syn.sao_params, qp_map=qp_map, slice_qp=qp,
                 rqt_inter=cfg.rqt_inter))
        nal_type = NalUnitType.TRAIL_R if is_ref else NalUnitType.TRAIL_N
        stream = annexb_stream(self._picture_nals(nal_type, rbsp, pre,
                                                  recon))
        self.frame_count += 1
        self.stats.add("B", len(stream) * 8, qp, poc=poc, syn=syn)
        return FrameResult(bitstream=stream, recon=recon, syntax=syn,
                           bits=len(stream) * 8, poc=poc, ftype="B")

    def encode_frame_b(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       ref0, ref1, poc: int, poc_refs: tuple[int, int],
                       qp: int | None = None, is_ref: bool = False,
                       rps_neg=None, rps_pos=None) -> FrameResult:
        """One B frame between two references (the host B path): each a
        DeviceRef, used on the device, or a host ReconFrame. Two-list ME
        and the dense recon on the device (enc/bi_frame.py), the L0 / L1
        / BI choice and the depth merge on the host; then the luma
        deblock with B boundary strengths and SAO on the host, and the
        native CABAC. is_ref marks a pyramid reference B (BREF);
        rps_neg / rps_pos give the retention RPS of hierarchical GOPs.
        Under dQP the slice codes a flat QP map at its QP."""
        from .bi_frame import encode_b_frame_arrays
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        w, h = cfg.width_padded, cfg.height_padded
        yp = pad_plane(np.asarray(y), h, w)
        cbp = pad_plane(np.asarray(cb), h // 2, w // 2)
        crp = pad_plane(np.asarray(cr), h // 2, w // 2)
        syn, recon = encode_b_frame_arrays(yp, cbp, crp, ref0, ref1, cfg,
                                           poc, poc_refs, qp,
                                           device=self.device)
        if cfg.deblock:
            vbs, hbs = inter_bs_maps_b(syn.depth8, syn.mv8, syn.pf8,
                                       syn.coeff_y, cfg.ctu_size)
            recon = ReconFrame(
                deblock_luma_np(recon.y, vbs, hbs, qp, cfg.bit_depth),
                recon.cb, recon.cr)
        if cfg.sao:
            p_y = choose_sao_params(yp, recon.y, cfg.ctu_size, qp,
                                    cfg.bit_depth)
            p_cb, p_cr = choose_sao_chroma(cbp, recon.cb, crp, recon.cr,
                                           cfg.ctu_size // 2, qp,
                                           cfg.bit_depth)
            recon = ReconFrame(
                apply_sao_component_np(recon.y, p_y, cfg.ctu_size,
                                       cfg.bit_depth),
                apply_sao_component_np(recon.cb, p_cb, cfg.ctu_size // 2,
                                       cfg.bit_depth),
                apply_sao_component_np(recon.cr, p_cr, cfg.ctu_size // 2,
                                       cfg.bit_depth))
            syn.sao_params = (p_y, p_cb, p_cr)
        return self._emit_b_frame(syn, recon, qp, poc, poc_refs, is_ref,
                                  rps_neg, rps_pos)

    def _newest_picture(self) -> DeviceRef:
        """The newest picture of self.ref, a P chunk's DeviceRef stack,
        as a single-picture DeviceRef (self.ref is left as it is)."""
        return DeviceRef(*(p[0] for p in (self.ref.y, self.ref.cb,
                                          self.ref.cr)))

    def encode_bgop(self, frames) -> list[FrameResult]:
        """IBPBP over the host B path: an IDR, then alternating forward
        P pictures (poc_step 2) and one non-reference B between each
        pair; a last unpaired frame is a P. Results are in decode order
        (I P B P B ...)."""
        if not frames:
            raise ValueError("encode_bgop needs at least one frame")
        r = self.encode_frame(*frames[0])
        self.ref = r.device_ref
        self.poc = 0
        results = [r]
        i = 1
        while i < len(frames):
            if i + 1 < len(frames):
                # the P at display i + 1 is coded first, then the B at i
                prev_ref = self._newest_ref()
                prev_poc = self.poc
                rp = self.encode_frame_p(*frames[i + 1], poc_step=2)
                rb = self.encode_frame_b(
                    *frames[i], prev_ref, self._newest_picture(),
                    prev_poc + 1, (prev_poc, prev_poc + 2))
                results.extend([rp, rb])
                i += 2
            else:
                results.append(self.encode_frame_p(*frames[i]))
                i += 1
        return results

    def encode_minigop(self, frames, qp: int | None = None,
                       device: bool = True) -> list[FrameResult]:
        """One hierarchical mini-GOP against the current reference:
        frames are the next len(frames) display pictures (self.poc + 1
        .. self.poc + L). The anchor P (the last picture, poc_step L) is
        coded first, then the recursive-bisection B frames, one device
        batch per (pyramid layer, reference-ness) run; interior Bs are
        reference BREFs. QP ladder: P qp, BREF qp + 1, B qp + 2, plus
        layer - 1 below layer 1. Returns results in decode order and
        leaves self.ref at the anchor's single picture (a run of one
        leaves the P chunk's reference stack, as the reference does).
        device=False codes the B frames one at a time through the host B
        path (encode_frame_b)."""
        from .bframe_gpu import encode_bframes_gpu
        cfg = self.cfg
        qp = cfg.qp if qp is None else qp
        L = len(frames)
        base = self.poc
        prev_ref = self._newest_ref()
        rp = self.encode_frame_p(*frames[-1], qp=qp, poc_step=L)
        results = [rp]
        if L == 1:
            return results          # self.ref: the P chunk's stack
        anchor = self._newest_picture()
        dpb = {base: prev_ref, base + L: anchor}

        sched: list[tuple[int, int, int, bool, int]] = []

        def bisect(lo: int, hi: int, layer: int) -> None:
            if hi - lo < 2:
                return
            mid = (lo + hi) // 2
            sched.append((mid, lo, hi, hi - lo > 2, layer))
            bisect(lo, mid, layer + 1)
            bisect(mid, hi, layer + 1)

        bisect(base, base + L, 1)
        # decode order = layer order (the refs of layer k are in layers < k)
        order = sorted(sched, key=lambda e: (e[4], not e[3], e[0]))

        def rps_of(idx, poc, lo, hi):
            needed_later: set[int] = set()
            for _, l2, h2, _, _ in order[idx + 1:]:
                needed_later.update((l2, h2))
            retained = (set(dpb.keys()) & needed_later) | {lo, hi}
            return (sorted([(poc - p, p == lo) for p in retained if p < poc]),
                    sorted([(p - poc, p == hi) for p in retained if p > poc]))

        def bqp_of(layer, is_ref):
            return min(qp + (1 if is_ref else 2) + max(layer - 1, 0), 51)

        if not device:
            for i, (poc, lo, hi, is_ref, layer) in enumerate(order):
                rps_neg, rps_pos = rps_of(i, poc, lo, hi)
                rb = self.encode_frame_b(
                    *frames[poc - base - 1], dpb[lo], dpb[hi], poc, (lo, hi),
                    qp=bqp_of(layer, is_ref), is_ref=is_ref,
                    rps_neg=rps_neg, rps_pos=rps_pos)
                if is_ref:
                    dpb[poc] = rb.recon
                results.append(rb)
            self.ref = anchor
            self.poc = base + L
            return results

        i = 0
        while i < len(order):
            # a run with the same (layer, is_ref) shares its QP
            layer, is_ref = order[i][4], order[i][3]
            j = i
            while j < len(order) and order[j][4] == layer and \
                    order[j][3] == is_ref:
                j += 1
            group = order[i:j]
            bqp = bqp_of(layer, is_ref)
            syns, recons, drefs = encode_bframes_gpu(
                [frames[e[0] - base - 1] for e in group],
                [dpb[e[1]] for e in group], [dpb[e[2]] for e in group],
                cfg, bqp, device=self.device)
            for k, (poc, lo, hi, iref, _) in enumerate(group):
                rps_neg, rps_pos = rps_of(i + k, poc, lo, hi)
                syn = syns[k]
                syn.poc = poc
                syn.poc_refs = (lo, hi)
                results.append(self._emit_b_frame(
                    syn, recons[k], bqp, poc, (lo, hi), iref, rps_neg,
                    rps_pos))
                if iref:
                    dpb[poc] = drefs[k]
            i = j
        self.ref = anchor
        self.poc = base + L
        return results

    def encode_hier_gop(self, frames, qp: int | None = None
                        ) -> list[FrameResult]:
        """Hierarchical-B GOP (the x265 B-pyramid / random-access
        structure): an IDR at display 0 (QP qp - 3), then one mini-GOP
        over the rest. Returns results in decode order."""
        qp = self.cfg.qp if qp is None else qp
        r0 = self.encode_frame(*frames[0], qp=max(qp - 3, 0))
        self.ref = r0.device_ref
        self.poc = 0
        results = [r0]
        if len(frames) > 1:
            results.extend(self.encode_minigop(frames[1:], qp=qp))
        return results

    # ------------------------------------------------------------------
    # per-CTU QP from the device lookahead
    # ------------------------------------------------------------------

    def encode_sequence(self, frames) -> list[FrameResult]:
        """IPPP with keyint + scene-cut frame types (the host
        Lookahead.decide): each GOP is an IDR at QP qp - 3 and its P run
        through the pipelined P chunks. With AQ or cuTree on
        (cfg.dqp_enabled) the device lookahead gives every frame of the
        GOP a per-CTU QP map; the I frame's is lowered by 3, and it
        takes the host-recon I path."""
        from .lookahead import Lookahead
        cfg = self.cfg
        la = Lookahead(cfg)
        types = [la.decide(np.asarray(f[0])) for f in frames]
        # CQP I-frame offset (x265 ipratio 1.4 ~ -3 QP): a finer
        # keyframe pays back across every frame that references it
        qp_i = max(cfg.qp - 3, 0)
        results: list[FrameResult] = []
        i = 0
        while i < len(frames):
            j = i + 1
            while j < len(frames) and types[j] == "P":
                j += 1
            gop = frames[i:j]
            qp_maps = self.lookahead_qp_maps(gop) if cfg.dqp_enabled \
                else None
            r = self.encode_frame(
                *gop[0], qp=qp_i, use_device_recon=qp_maps is None,
                qp_map=None if qp_maps is None
                else np.clip(qp_maps[0] - 3, 0, 51))
            self.ref = r.device_ref
            self.poc = 0
            results.append(r)
            if len(gop) > 1:
                results.extend(self.encode_pgop_pipelined(
                    gop[1:], need_recon=True,
                    qp_maps=None if qp_maps is None else qp_maps[1:]))
            i = j
        return results

    def lookahead_qp_maps(self, gop_frames,
                          base_qp: int | None = None) -> np.ndarray:
        """The device lookahead over one GOP: AQ energy + cuTree ->
        per-CTU QP maps (F, ncty, nctx) around base_qp, on the grid of
        the coded size floored to 16 (a ragged frame's last CTU row or
        column is filled by the encoder). Its seconds are appended to
        self.lookahead_seconds."""
        from .lookahead_gpu import lookahead_gop
        t0 = time.perf_counter()
        cfg = self.cfg
        base_qp = cfg.qp if base_qp is None else base_qp
        hp, wp = cfg.height_padded, cfg.width_padded
        h16, w16 = hp // 16 * 16, wp // 16 * 16
        ys = np.stack([pad_plane(np.asarray(g[0]), hp, wp)[:h16, :w16]
                       for g in gop_frames])
        cbs = np.stack([pad_plane(np.asarray(g[1]), hp // 2, wp // 2)
                        [:h16 // 2, :w16 // 2] for g in gop_frames])
        crs = np.stack([pad_plane(np.asarray(g[2]), hp // 2, wp // 2)
                        [:h16 // 2, :w16 // 2] for g in gop_frames])
        off_ctu = lookahead_gop(ys, cbs, crs, cfg, qcomp=cfg.qcomp,
                                device=self.device)[0]
        maps = np.clip(np.round(base_qp + off_ctu), 0, 51).astype(np.int32)
        self.lookahead_seconds.append(time.perf_counter() - t0)
        return maps
