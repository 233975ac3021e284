"""Validation HEVC decoder, written from the H.265 spec.

Role: the project has no external reference decoder, so this module is
the conformance oracle — it parses the Annex-B stream the encoder emits
(headers + CABAC slice data), reconstructs frames with the numpy spec
oracles, and tests assert the result is bit-exact against the
encoder's own reconstruction. Analog of x265's practice of decoding
golden bitstreams (source/test/regression-tests.txt:3-6).

Supports what the encoder emits today: Main/Main10, 4:2:0, one slice,
CTU 16/32; I slices (35-mode intra incl. PART_NxN/DST, lossless
transquant bypass), P slices (2Nx2N inter, merge/AMVP/skip, weighted
prediction, intra-in-inter, inter RQT depth 1), B slices (two lists,
bi-prediction, POC-scaled AMVP), deblocking (incl. TU edges), SAO,
WPP substreams, per-CTU dQP, decoded-picture-hash verification.
Unsupported syntax raises instead of mis-decoding.

A copy of x265_tpu/decoder/decoder.py on this package's own host
modules, numpy only: it runs wherever the package does, the card's
machine included, and shares no device code with the encoder it
checks. It reads what the reference's decoder reads, including where
the reference's coder departs from H.265 (sao_offset_abs with cMax 7 at
10 bits, the 10-bit QP scale without QpBdOffsetY).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitwriter import BitReader
from ..bitstream.cabac import CabacDecoder, ContextSet
from ..bitstream.ctx_tables import OFF, init_states
from ..bitstream.nal import split_annexb, NalUnitType
from ..bitstream.syntax import (GROUP_IDX, MIN_IN_GROUP, SIG_CTX_4X4,
                                COEF_REMAIN_BIN_REDUCTION, derive_mpm,
                                INTRA_DC)
from ..common.params import I_SLICE
from ..common.tables import (SCAN_DIAG, SCAN_VER, full_scan_table,
                             cg_scan_order, intra_scan_idx, chroma_qp)
from ..ops.intra_np import canonical_refs, filter_refs, intra_pred_np
from ..ops.interp import luma_mc_np, chroma_mc_np
from ..ops.transforms import idct_np, dequant_np


@dataclass
class SpsInfo:
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    log2_ctu: int = 5
    log2_min_cu: int = 3
    conf_right: int = 0
    conf_bottom: int = 0
    sao: bool = False
    poc_lsb_bits: int = 8
    max_trafo_depth_inter: int = 0
    tmvp: bool = False             # sps_temporal_mvp_enabled_flag


def _inv_tu(coeff, qp, bd, split_n):
    """Inverse transform a CU-sized coeff array; per-quadrant at
    split_n when the TU tree split one level (0 = single TU)."""
    if not split_n:
        return idct_np(dequant_np(coeff, qp, bd), bd)
    out = np.zeros_like(coeff)
    for dy in (0, split_n):
        for dx in (0, split_n):
            sub = coeff[dy:dy + split_n, dx:dx + split_n]
            if sub.any():
                out[dy:dy + split_n, dx:dx + split_n] = \
                    idct_np(dequant_np(sub, qp, bd), bd)
    return out


@dataclass
class PpsInfo:
    init_qp: int = 26
    sign_hiding: bool = False
    wpp: bool = False
    deblock_disabled: bool = True
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    cu_qp_delta: bool = False      # per-QG dQP (QG == CTU only)
    transquant_bypass: bool = False
    weighted_pred: bool = False    # P slices carry pred_weight_table


@dataclass
class DecodedFrame:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    qp: int
    # parsed decision maps, for white-box assertions in tests
    depth8: np.ndarray | None = None
    mode8: np.ndarray | None = None
    mv8: np.ndarray | None = None        # P frames: decoded MV field
    coeff_y: np.ndarray | None = None    # P frames: for bs derivation
    poc: int = 0
    ref8: np.ndarray | None = None       # P frames: per-8x8 L0 refIdx
    inter8: np.ndarray | None = None     # per-8x8 inter flag (TMVP col)
    ref_pocs: tuple = ()                 # this frame's own L0 ref POCs


def parse_sps(rbsp: bytes) -> SpsInfo:
    r = BitReader(rbsp)
    s = SpsInfo()
    r.read(4)                      # sps_video_parameter_set_id
    max_sub = r.read(3)            # sps_max_sub_layers_minus1
    r.read_flag()                  # temporal_id_nesting
    _parse_ptl(r, max_sub)
    r.read_ue()                    # sps id
    chroma = r.read_ue()
    assert chroma == 1, "only 4:2:0"
    s.width = r.read_ue()
    s.height = r.read_ue()
    if r.read_flag():              # conformance window
        r.read_ue()
        s.conf_right = r.read_ue()
        r.read_ue()
        s.conf_bottom = r.read_ue()
    s.bit_depth = r.read_ue() + 8
    r.read_ue()                    # chroma bit depth
    s.poc_lsb_bits = r.read_ue() + 4
    sub_info = r.read_flag()
    for _ in range((max_sub + 1) if sub_info else 1):
        r.read_ue(); r.read_ue(); r.read_ue()
    s.log2_min_cu = r.read_ue() + 3
    s.log2_ctu = s.log2_min_cu + r.read_ue()
    min_tb = r.read_ue() + 2
    r.read_ue()                    # max-min tb diff
    assert min_tb == 2
    s.max_trafo_depth_inter = r.read_ue()
    r.read_ue()                    # max_transform_hierarchy_depth_intra
    assert not r.read_flag(), "scaling lists unsupported"
    r.read_flag()                  # amp
    s.sao = bool(r.read_flag())
    assert not r.read_flag(), "pcm unsupported"
    nrps = r.read_ue()
    assert nrps == 0, "sps-level RPS unsupported"
    assert not r.read_flag()       # long-term ref pics
    s.tmvp = bool(r.read_flag())   # sps_temporal_mvp_enabled_flag
    assert not r.read_flag(), "strong intra smoothing unsupported"
    return s


def _parse_ptl(r: BitReader, max_sub: int) -> None:
    r.read(2); r.read_flag(); r.read(5)
    r.read(32)
    r.read(4)                      # progressive/interlaced/non-packed/frame-only
    r.read(22); r.read(22)         # reserved 44
    r.read(8)                      # level idc
    assert max_sub == 0


def parse_pps(rbsp: bytes) -> PpsInfo:
    r = BitReader(rbsp)
    p = PpsInfo()
    r.read_ue(); r.read_ue()
    assert not r.read_flag()       # dependent slices
    r.read_flag()                  # output_flag_present
    r.read(3)
    p.sign_hiding = bool(r.read_flag())
    assert not r.read_flag()       # cabac_init_present
    r.read_ue(); r.read_ue()       # default ref counts
    p.init_qp = 26 + r.read_se()
    assert not r.read_flag()       # constrained intra
    assert not r.read_flag()       # transform skip
    p.cu_qp_delta = bool(r.read_flag())
    if p.cu_qp_delta:
        assert r.read_ue() == 0, "QG must equal CTU (diff depth 0)"
    p.cb_qp_offset = r.read_se()
    p.cr_qp_offset = r.read_se()
    r.read_flag()                  # slice chroma qp offsets present
    p.weighted_pred = bool(r.read_flag())   # weighted_pred_flag
    assert not r.read_flag()       # weighted_bipred unsupported
    p.transquant_bypass = bool(r.read_flag())
    assert not r.read_flag()       # tiles
    p.wpp = bool(r.read_flag())
    r.read_flag()                  # loop filter across slices
    if r.read_flag():              # deblocking control present
        assert not r.read_flag()   # override enabled
        p.deblock_disabled = bool(r.read_flag())
        if not p.deblock_disabled:
            r.read_se(); r.read_se()
    return p


def decode_annexb(stream: bytes) -> list[DecodedFrame]:
    """Decode a stream; returns frames in DECODE order. Each frame's
    `poc` attribute gives display order within the coded video sequence."""
    sps: SpsInfo | None = None
    pps: PpsInfo | None = None
    frames: list[DecodedFrame] = []
    dpb: dict[int, DecodedFrame] = {}   # reference pictures by POC
    for nal_type, rbsp, raw in split_annexb(stream):
        if nal_type == NalUnitType.SPS:
            sps = parse_sps(rbsp)
        elif nal_type == NalUnitType.PPS:
            pps = parse_pps(rbsp)
        elif nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                          NalUnitType.CRA_NUT):
            assert sps is not None and pps is not None
            f = _decode_slice(rbsp, sps, pps, idr=True, raw=raw)
            frames.append(f)
            dpb.clear()
            dpb[0] = f
        elif nal_type in (NalUnitType.TRAIL_R, NalUnitType.TRAIL_N):
            assert sps is not None and pps is not None and dpb
            is_ref = nal_type == NalUnitType.TRAIL_R
            f = _decode_slice(rbsp, sps, pps, idr=False, dpb=dpb,
                              raw=raw)
            frames.append(f)
            if is_ref:
                dpb[f.poc] = f
        elif nal_type == NalUnitType.SUFFIX_SEI:
            from ..bitstream.sei import parse_picture_hash_sei, HASH_FNS
            parsed = parse_picture_hash_sei(rbsp)
            if parsed is not None and frames:
                htype, digests = parsed
                f = frames[-1]
                got = HASH_FNS[htype](f.y, f.cb, f.cr,
                                      sps.bit_depth if sps else 8)
                if got != digests:
                    raise ValueError(
                        "decoded-picture-hash mismatch: stream corrupt or "
                        "decoder bug")
        elif nal_type in (NalUnitType.VPS, NalUnitType.AUD,
                          NalUnitType.PREFIX_SEI):
            continue
    return frames


def _decode_slice(rbsp: bytes, sps: SpsInfo, pps: PpsInfo, *,
                  idr: bool, dpb: dict | None = None,
                  raw: bytes | None = None) -> DecodedFrame:
    r = BitReader(rbsp)
    assert r.read_flag() == 1      # first_slice_segment_in_pic_flag
    if idr:
        r.read_flag()              # no_output_of_prior_pics
    r.read_ue()                    # pps id
    slice_type = r.read_ue()
    assert slice_type in (0, 1, 2)
    max_merge = 2
    poc = 0
    delta_s0 = delta_s1 = 1
    slice_tmvp = False
    neg = []
    if slice_type != 2:
        poc = r.read(sps.poc_lsb_bits)   # slice_pic_order_cnt_lsb
        assert r.read_flag() == 0  # short_term_ref_pic_set_sps_flag
        nneg = r.read_ue()
        npos = r.read_ue()
        # general st_ref_pic_set: (delta, used) lists; the L0 list is
        # the used negative entries in delta order (default ref list
        # construction, clause 8.3.4)
        neg, pos, prev = [], [], 0
        for _ in range(nneg):
            prev += r.read_ue() + 1
            neg.append((prev, bool(r.read_flag())))
        prev = 0
        for _ in range(npos):
            prev += r.read_ue() + 1
            pos.append((prev, bool(r.read_flag())))
        delta_s0 = next((d for d, u in neg if u), neg[0][0] if neg else 1)
        delta_s1 = next((d for d, u in pos if u), pos[0][0] if pos else 1)
        if sps.tmvp:
            slice_tmvp = bool(r.read_flag())
    sao_luma = sao_chroma = False
    if sps.sao:
        sao_luma = bool(r.read_flag())
        sao_chroma = bool(r.read_flag())
    weights = None
    num_ref_l0 = 1
    if slice_type != 2:
        if r.read_flag():          # num_ref_idx_active_override_flag
            assert slice_type == 1, "override emitted for P only"
            num_ref_l0 = r.read_ue() + 1
        if slice_type == 0:
            assert r.read_flag() == 0   # mvd_l1_zero_flag
        if sps.tmvp and slice_tmvp:
            # collocated_from_l0 inferred 1 for P slices
            if slice_type == 0:
                assert r.read_flag() == 1, "B collocated must be L0"
            if num_ref_l0 > 1:
                assert r.read_ue() == 0, "collocated_ref_idx must be 0"
        if pps.weighted_pred and slice_type == 1:
            # pred_weight_table, clause 7.3.6.3 (explicit weights on
            # L0 ref 0 only; further refs inferred neutral)
            denom = r.read_ue()        # luma_log2_weight_denom
            assert r.read_se() == 0    # delta_chroma_log2_weight_denom
            one = 1 << denom
            lflags = [r.read_flag() for _ in range(num_ref_l0)]
            cflags = [r.read_flag() for _ in range(num_ref_l0)]
            assert not any(lflags[1:]) and not any(cflags[1:]), \
                "explicit weights supported on ref 0 only"
            luma_on = lflags[0]
            chroma_on = cflags[0]
            wy, oy = one, 0
            wcb, ocb, wcr, ocr = one, 0, one, 0
            if luma_on:
                wy = one + r.read_se()
                oy = r.read_se()
            if chroma_on:
                wcb = one + r.read_se()
                d = r.read_se()        # delta_chroma_offset_l0
                ocb = max(-128, min(127, d - ((128 * wcb) >> denom)
                                    + 128))
                wcr = one + r.read_se()
                d = r.read_se()
                ocr = max(-128, min(127, d - ((128 * wcr) >> denom)
                                    + 128))
            weights = (denom, wy, oy, wcb, ocb, wcr, ocr)
        max_merge = 5 - r.read_ue()  # five_minus_max_num_merge_cand
    qp = pps.init_qp + r.read_se()
    if sps.sao or not pps.deblock_disabled:
        r.read_flag()              # slice_loop_filter_across_slices_enabled
    entry_offsets: list[int] = []
    if pps.wpp:
        nep = r.read_ue()          # num_entry_point_offsets
        if nep:
            olen = r.read_ue() + 1
            entry_offsets = [r.read(olen) + 1 for _ in range(nep)]
    # byte_alignment(): one alignment bit (always present) + zero pad
    assert r.read_flag() == 1, "alignment_bit_equal_to_one"
    r.byte_align()
    data = rbsp[r.bit_position // 8:]
    substreams = None
    if pps.wpp and entry_offsets:
        # entry offsets count EMULATION-PREVENTED bytes (7.4.7.1):
        # locate the header end in the raw payload, split, un-escape
        from ..bitstream.nal import (emulation_prevention,
                                     remove_emulation_prevention)
        assert raw is not None, "WPP slices need the raw NAL payload"
        hdr_raw_len = len(emulation_prevention(rbsp[:r.bit_position // 8]))
        raw_data = raw[hdr_raw_len:]
        bounds = [0]
        for o in entry_offsets:
            bounds.append(bounds[-1] + o)
        bounds.append(len(raw_data))
        substreams = [remove_emulation_prevention(raw_data[a:b])
                      for a, b in zip(bounds[:-1], bounds[1:])]
    if slice_type == 2:
        dec = SliceDecoder(sps, pps, qp, data, sao=sps.sao)
        frame = dec.decode(substreams=substreams)
        if not pps.deblock_disabled:
            from ..ops.deblock import deblock_frame_np
            dqp = dec.qp8 if pps.cu_qp_delta else qp
            frame.y, frame.cb, frame.cr = deblock_frame_np(
                frame.y, frame.cb, frame.cr, frame.depth8,
                1 << sps.log2_ctu, dqp, sps.bit_depth)
        _apply_sao(frame, dec, sps, sao_luma, sao_chroma)
        return frame
    if slice_type == 1:
        used_neg = [d for d, u in neg if u]
        refs = [dpb[poc - d] for d in used_neg[:num_ref_l0]]
        assert len(refs) == num_ref_l0, "RPS lists fewer refs than active"
        dec = PSliceDecoder(sps, pps, qp, data, refs, max_merge,
                            sao=sps.sao, weights=weights, poc=poc,
                            tmvp=sps.tmvp and slice_tmvp)
        frame = dec.decode(substreams=substreams)
        frame.poc = poc
        if not pps.deblock_disabled:
            from ..ops.deblock import (deblock_chroma_np, deblock_luma_np,
                                       inter_bs_maps)
            vbs, hbs = inter_bs_maps(frame.depth8, frame.mv8,
                                     frame.coeff_y, 1 << sps.log2_ctu,
                                     intra8=dec.intra8,
                                     tusplit8=dec.tusplit8)
            dqp = dec.qp8 if pps.cu_qp_delta else qp
            frame.y = deblock_luma_np(frame.y, vbs, hbs, dqp,
                                      sps.bit_depth)
            if dec.intra8.any():
                # chroma filters only bs==2 (intra) edges
                frame.cb = deblock_chroma_np(frame.cb, vbs == 2,
                                             hbs == 2, dqp,
                                             sps.bit_depth)
                frame.cr = deblock_chroma_np(frame.cr, vbs == 2,
                                             hbs == 2, dqp,
                                             sps.bit_depth)
        _apply_sao(frame, dec, sps, sao_luma, sao_chroma)
        return frame
    # B slice
    ref0 = dpb[poc - delta_s0]
    ref1 = dpb[poc + delta_s1]
    dec = BSliceDecoder(sps, pps, qp, data, ref0, ref1, max_merge,
                        (poc - delta_s0, poc + delta_s1), poc,
                        sao=sps.sao)
    frame = dec.decode(substreams=substreams)
    frame.poc = poc
    if not pps.deblock_disabled:
        from ..ops.deblock import deblock_luma_np, inter_bs_maps_b
        vbs, hbs = inter_bs_maps_b(frame.depth8, dec.mvb, dec.pf8,
                                   frame.coeff_y, 1 << sps.log2_ctu)
        dqp = dec.qp8 if pps.cu_qp_delta else qp
        frame.y = deblock_luma_np(frame.y, vbs, hbs, dqp, sps.bit_depth)
    _apply_sao(frame, dec, sps, sao_luma, sao_chroma)
    return frame


def _apply_sao(frame: DecodedFrame, dec, sps: SpsInfo, sao_luma: bool,
               sao_chroma: bool) -> None:
    if not sps.sao or getattr(dec, "sao_py", None) is None:
        return
    from ..ops.sao import apply_sao_component_np
    ctu = 1 << sps.log2_ctu
    if sao_luma:
        frame.y = apply_sao_component_np(frame.y, dec.sao_py, ctu,
                                         sps.bit_depth)
    if sao_chroma:
        frame.cb = apply_sao_component_np(frame.cb, dec.sao_pcb, ctu // 2,
                                          sps.bit_depth)
        frame.cr = apply_sao_component_np(frame.cr, dec.sao_pcr, ctu // 2,
                                          sps.bit_depth)


class SliceDecoder:
    """CABAC slice-data parser + spec reconstruction (intra)."""

    def __init__(self, sps: SpsInfo, pps: PpsInfo, qp: int, data: bytes,
                 sao: bool = False) -> None:
        self.sps = sps
        self.pps = pps
        self.qp = qp
        self._init_sao(sao)
        ctx = ContextSet(0)
        ctx.states = init_states(I_SLICE, qp)
        self.cab = CabacDecoder(data, ctx)
        self.w, self.h = sps.width, sps.height
        self.cw, self.ch = self.w // 2, self.h // 2
        bd = sps.bit_depth
        self.y = np.zeros((self.h, self.w), dtype=np.int32)
        self.cb = np.zeros((self.ch, self.cw), dtype=np.int32)
        self.cr = np.zeros((self.ch, self.cw), dtype=np.int32)
        self.decoded_y = np.zeros((self.h, self.w), dtype=bool)
        self.decoded_c = np.zeros((self.ch, self.cw), dtype=bool)
        self.depth8 = np.zeros((self.h // 8, self.w // 8), dtype=np.uint8)
        self.mode8 = np.full((self.h // 8, self.w // 8), 255, dtype=np.uint8)
        # IntraPredModeY at PU (4x4) granularity: NxN CUs carry four
        self.mode4 = np.full((self.h // 4, self.w // 4), 255,
                             dtype=np.uint8)
        self.bd = bd
        self.bypass = False          # cu_transquant_bypass of current CU
        self._init_dqp()

    # -- per-QG dQP (cu_qp_delta; QG == CTU so the predictor is the
    # -- previous QG's QP in raster order, clause 8.6.1) -----------------------

    def _init_dqp(self) -> None:
        self.dqp_on = self.pps.cu_qp_delta
        self.prev_qp = self.qp       # qPY_PREV
        self.cur_qp = self.qp        # QP of the current QG
        self.dqp_pending = False
        self.qp8 = np.full((self.h // 8, self.w // 8), self.qp, np.int32)

    def _ctu_qp_start(self, x0: int, y0: int) -> None:
        if self.dqp_on:
            self.dqp_pending = True
            self.cur_qp = self.prev_qp   # prediction until delta arrives

    def _ctu_qp_end(self, x0: int, y0: int) -> None:
        if not self.dqp_on:
            return
        ctu = 1 << self.sps.log2_ctu
        s = ctu >> 3
        self.qp8[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s] = self.cur_qp
        self.prev_qp = self.cur_qp
        self.dqp_pending = False

    def _parse_dqp(self) -> None:
        """cu_qp_delta_abs/sign (9.3.3.9: TU(5) prefix + EG0 suffix)."""
        if not self.dqp_pending:
            return
        self.dqp_pending = False
        cab = self.cab
        a = cab.decode_bin(OFF["cu_qp_delta_abs"])
        if a:
            while a < 5 and cab.decode_bin(OFF["cu_qp_delta_abs"] + 1):
                a += 1
            if a == 5:
                count = 0
                value = 0
                while cab.decode_bypass():
                    value += 1 << count
                    count += 1
                a += value + (cab.decode_bypass_bins(count) if count else 0)
            if cab.decode_bypass():
                a = -a
        self.cur_qp = self.prev_qp + a

    @property
    def qp_y(self) -> int:
        return self.cur_qp if self.dqp_on else self.qp

    @property
    def qp_cb(self) -> int:
        return chroma_qp(min(max(self.qp_y + self.pps.cb_qp_offset, 0), 57))

    @property
    def qp_cr(self) -> int:
        return chroma_qp(min(max(self.qp_y + self.pps.cr_qp_offset, 0), 57))

    def _init_sao(self, sao: bool) -> None:
        self.sao_on = sao
        self.sao_py = self.sao_pcb = self.sao_pcr = None

    def _parse_sao(self, tx: int, ty: int) -> None:
        cab = self.cab
        if tx > 0 and cab.decode_bin(OFF["sao_merge_flag"]):
            for p in (self.sao_py, self.sao_pcb, self.sao_pcr):
                p[ty, tx] = p[ty, tx - 1]
            return
        if ty > 0 and cab.decode_bin(OFF["sao_merge_flag"]):
            for p in (self.sao_py, self.sao_pcb, self.sao_pcr):
                p[ty, tx] = p[ty - 1, tx]
            return
        ptab = (self.sao_py, self.sao_pcb, self.sao_pcr)
        t_chroma = 0
        for cidx, p in enumerate(ptab):
            if cidx < 2:
                t = 0
                if cab.decode_bin(OFF["sao_type_idx"]):
                    t = 2 if cab.decode_bypass() else 1
                if cidx == 1:
                    t_chroma = t
            else:
                t = t_chroma
            p[ty, tx, 0] = t
            if t == 0:
                continue
            offs = []
            for _ in range(4):
                v = 0
                while v < 7 and cab.decode_bypass():
                    v += 1
                offs.append(v)
            if t == 1:
                for i in range(4):
                    if offs[i] and cab.decode_bypass():
                        offs[i] = -offs[i]
                p[ty, tx, 1] = cab.decode_bypass_bins(5)
            else:
                offs = [offs[0], offs[1], -offs[2], -offs[3]]
                if cidx == 0:
                    p[ty, tx, 1] = cab.decode_bypass_bins(2)
                elif cidx == 1:
                    p[ty, tx, 1] = cab.decode_bypass_bins(2)
                else:
                    p[ty, tx, 1] = ptab[1][ty, tx, 1]
            p[ty, tx, 2:6] = offs

    def _decode_ctus(self, substreams=None) -> None:
        """CTU parse loop; substreams given = WPP (one per row, ctx
        forked from the saved state after CTU 1 of the row above,
        qPY_PREV reset per row — clauses 9.3.1 / 8.6.1)."""
        log2_ctu = self.sps.log2_ctu
        ctu = 1 << log2_ctu
        rows = (self.h + ctu - 1) >> log2_ctu
        cols = (self.w + ctu - 1) >> log2_ctu
        if self.sao_on:
            self.sao_py = np.zeros((rows, cols, 6), np.int32)
            self.sao_pcb = np.zeros((rows, cols, 6), np.int32)
            self.sao_pcr = np.zeros((rows, cols, 6), np.int32)
        if substreams is None:
            for addr in range(rows * cols):
                cy, cx = divmod(addr, cols)
                self._ctu_qp_start(cx * ctu, cy * ctu)
                if self.sao_on:
                    self._parse_sao(cx, cy)
                self._cu_tree(cx * ctu, cy * ctu, log2_ctu)
                self._ctu_qp_end(cx * ctu, cy * ctu)
                end = self.cab.decode_terminate()
                assert end == (1 if addr == rows * cols - 1 else 0), \
                    f"end_of_slice mismatch at CTU {addr}"
            return
        assert len(substreams) == rows, "one substream per CTU row"
        init = self.cab.ctx.states.copy()
        saved = init
        for row in range(rows):
            ctx = ContextSet(0)
            ctx.states = init.copy() if row == 0 else saved.copy()
            self.cab = CabacDecoder(substreams[row], ctx)
            if self.dqp_on:
                self.prev_qp = self.qp
            for col in range(cols):
                addr = row * cols + col
                self._ctu_qp_start(col * ctu, row * ctu)
                if self.sao_on:
                    self._parse_sao(col, row)
                self._cu_tree(col * ctu, row * ctu, log2_ctu)
                self._ctu_qp_end(col * ctu, row * ctu)
                end = self.cab.decode_terminate()
                assert end == (1 if addr == rows * cols - 1 else 0), \
                    f"end_of_slice mismatch at CTU {addr}"
                if col == 1 and rows > 1:
                    saved = ctx.states.copy()
            if row < rows - 1:
                assert self.cab.decode_terminate() == 1, \
                    "end_of_subset_one_bit"

    def decode(self, substreams=None) -> DecodedFrame:
        self._decode_ctus(substreams)
        return DecodedFrame(self.y, self.cb, self.cr, self.qp,
                            self.depth8, self.mode8)

    # -- quadtree ---------------------------------------------------------------

    def _depth_at(self, x: int, y: int) -> int:
        return int(self.depth8[y >> 3, x >> 3])

    def _cu_tree(self, x0: int, y0: int, log2_size: int) -> None:
        size = 1 << log2_size
        depth = self.sps.log2_ctu - log2_size
        inside = x0 + size <= self.w and y0 + size <= self.h
        if inside and log2_size > self.sps.log2_min_cu:
            ctx = 0
            if x0 > 0 and self.decoded_y[y0, x0 - 1] \
                    and self._depth_at(x0 - 1, y0) > depth:
                ctx += 1
            if y0 > 0 and self.decoded_y[y0 - 1, x0] \
                    and self._depth_at(x0, y0 - 1) > depth:
                ctx += 1
            split = self.cab.decode_bin(OFF["split_cu_flag"] + ctx)
        elif log2_size > self.sps.log2_min_cu:
            split = 1
        else:
            split = 0
        if split:
            half = size >> 1
            for sub in range(4):
                sx = x0 + (sub & 1) * half
                sy = y0 + (sub >> 1) * half
                if sx < self.w and sy < self.h:
                    self._cu_tree(sx, sy, log2_size - 1)
        else:
            self._cu(x0, y0, log2_size)

    # -- coding unit -------------------------------------------------------------

    def _neighbor_mode(self, x: int, y: int, *, above: bool) -> int:
        if above:
            if y == 0 or (y - 1) >> self.sps.log2_ctu != y >> self.sps.log2_ctu:
                return INTRA_DC
            return int(self.mode4[(y - 1) >> 2, x >> 2])
        if x == 0:
            return INTRA_DC
        return int(self.mode4[y >> 2, (x - 1) >> 2])

    def _parse_luma_mode(self, x: int, y: int, prev_flag: int,
                         ) -> int:
        """mpm_idx / rem_intra_luma_pred_mode for one PU (8.4.2); the
        resolved mode is written to the 4x4-granularity map so later
        PUs see it as a neighbour."""
        cab = self.cab
        mpm = derive_mpm(self._neighbor_mode(x, y, above=False),
                         self._neighbor_mode(x, y, above=True))
        if prev_flag:
            idx = cab.decode_bypass()
            if idx:
                idx += cab.decode_bypass()
            mode = mpm[idx]
        else:
            mode = cab.decode_bypass_bins(5)
            for m in sorted(mpm):
                if mode >= m:
                    mode += 1
        return mode

    def _cu(self, x0: int, y0: int, log2_size: int) -> None:
        cab = self.cab
        self.bypass = bool(self.pps.transquant_bypass and
                           cab.decode_bin(OFF["cu_transquant_bypass"]))
        size = 1 << log2_size
        nxn = False
        if log2_size == self.sps.log2_min_cu:
            nxn = cab.decode_bin(OFF["part_mode"]) == 0
        pus = [(x0, y0)] if not nxn else \
            [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]
        prev = [cab.decode_bin(OFF["prev_intra_luma_pred_flag"])
                for _ in pus]
        modes = []
        for (x, y), pf in zip(pus, prev):
            mode = self._parse_luma_mode(x, y, pf)
            k = 1 if nxn else size >> 2
            self.mode4[y >> 2:(y >> 2) + k, x >> 2:(x >> 2) + k] = mode
            modes.append(mode)
        mode = modes[0]                     # PU0: chroma DM source
        if cab.decode_bin(OFF["intra_chroma_pred_mode"]):
            cand = [34 if c == mode else c for c in (0, 26, 10, 1)]
            idx = (cab.decode_bypass() << 1) | cab.decode_bypass()
            cmode = cand[idx]
        else:
            cmode = mode                    # DM
        d = self.sps.log2_ctu - log2_size
        self.depth8[y0 >> 3:(y0 + size) >> 3, x0 >> 3:(x0 + size) >> 3] = d
        self.mode8[y0 >> 3:(y0 + size) >> 3, x0 >> 3:(x0 + size) >> 3] = mode

        if nxn:
            self._transform_nxn(x0, y0, modes, cmode)
            return
        # transform unit (TU == CU)
        cbf_cb = cab.decode_bin(OFF["cbf_chroma"])
        cbf_cr = cab.decode_bin(OFF["cbf_chroma"])
        cbf_y = cab.decode_bin(OFF["cbf_luma"] + 1)
        if cbf_y or cbf_cb or cbf_cr:
            self._parse_dqp()
        coeff_y = coeff_cb = coeff_cr = None
        if cbf_y:
            scan = intra_scan_idx(mode, log2_size, True)
            coeff_y = self._residual(log2_size, 0, scan)
        csize = size >> 1
        if csize >= 4:
            cscan = intra_scan_idx(cmode, log2_size - 1, False)
            if cbf_cb:
                coeff_cb = self._residual(log2_size - 1, 1, cscan)
            if cbf_cr:
                coeff_cr = self._residual(log2_size - 1, 2, cscan)

        self._reconstruct(x0, y0, log2_size, mode, coeff_y, coeff_cb,
                          coeff_cr, cmode)

    def _transform_nxn(self, x0: int, y0: int, modes: list[int],
                       cmode: int) -> None:
        """Implicitly-split transform tree of a PART_NxN intra CU
        (7.3.8.8): chroma cbfs at trafoDepth 0, then four 4x4 luma TUs
        (cbf ctx 0, DST-IV), chroma residual with blkIdx 3. Each sub-TU
        reconstructs immediately so the next PU predicts from it."""
        cab = self.cab
        cbf_cb = cab.decode_bin(OFF["cbf_chroma"])
        cbf_cr = cab.decode_bin(OFF["cbf_chroma"])
        for s, (x, y) in enumerate(((x0, y0), (x0 + 4, y0),
                                    (x0, y0 + 4), (x0 + 4, y0 + 4))):
            cy_ = None
            cbf = cab.decode_bin(OFF["cbf_luma"])
            if cbf or (s == 3 and (cbf_cb or cbf_cr)):
                self._parse_dqp()
            if cbf:
                scan = intra_scan_idx(modes[s], 2, True)
                cy_ = self._residual(2, 0, scan)
            self._reconstruct_luma4(x, y, modes[s], cy_)
        coeff_cb = coeff_cr = None
        cscan = intra_scan_idx(cmode, 2, False)
        if cbf_cb:
            coeff_cb = self._residual(2, 1, cscan)
        if cbf_cr:
            coeff_cr = self._residual(2, 2, cscan)
        self._reconstruct_chroma(x0 >> 1, y0 >> 1, 4, cmode, coeff_cb,
                                 coeff_cr)

    # -- reconstruction (clauses 8.4.4, 8.6) --------------------------------------

    def _avail_mask(self, mask: np.ndarray, x0: int, y0: int, n: int,
                    w: int, h: int) -> np.ndarray:
        av = np.zeros(4 * n + 1, dtype=bool)
        for i in range(4 * n + 1):
            if i < 2 * n:
                x, y = x0 - 1, y0 + (2 * n - 1 - i)
            elif i == 2 * n:
                x, y = x0 - 1, y0 - 1
            else:
                x, y = x0 + (i - 2 * n - 1), y0 - 1
            if 0 <= x < w and 0 <= y < h:
                av[i] = mask[y, x]
        return av

    def _reconstruct_luma4(self, x0: int, y0: int, mode: int,
                           cy_: np.ndarray | None) -> None:
        """One 4x4 luma TU of a PART_NxN CU (DST-IV residual)."""
        bd = self.bd
        av = self._avail_mask(self.decoded_y, x0, y0, 4, self.w, self.h)
        refs = canonical_refs(self.y, x0, y0, 4, av, bd)
        filt = filter_refs(refs, 4, bd)
        pred = intra_pred_np(refs, mode, 4, is_luma=True, bit_depth=bd,
                             filtered=filt)
        resi = 0
        if cy_ is not None:
            resi = cy_ if self.bypass else \
                idct_np(dequant_np(cy_, self.qp_y, bd), bd, dst=True)
        self.y[y0:y0 + 4, x0:x0 + 4] = np.clip(pred + resi,
                                               0, (1 << bd) - 1)
        self.decoded_y[y0:y0 + 4, x0:x0 + 4] = True

    def _reconstruct_chroma(self, cx0: int, cy0: int, cn: int,
                            cmode: int, ccb: np.ndarray | None,
                            ccr: np.ndarray | None) -> None:
        bd = self.bd
        avc = self._avail_mask(self.decoded_c, cx0, cy0, cn, self.cw,
                               self.ch)
        for plane, coeff, qp in ((self.cb, ccb, self.qp_cb),
                                 (self.cr, ccr, self.qp_cr)):
            refs_c = canonical_refs(plane, cx0, cy0, cn, avc, bd)
            pred_c = intra_pred_np(refs_c, cmode, cn, is_luma=False,
                                   bit_depth=bd)
            resi_c = 0
            if coeff is not None:
                if self.bypass:
                    resi_c = coeff
                else:
                    dq = dequant_np(coeff, qp, bd)
                    resi_c = idct_np(dq, bd, dst=False)
            plane[cy0:cy0 + cn, cx0:cx0 + cn] = np.clip(
                pred_c + resi_c, 0, (1 << bd) - 1)
        self.decoded_c[cy0:cy0 + cn, cx0:cx0 + cn] = True

    def _reconstruct(self, x0: int, y0: int, log2_size: int, mode: int,
                     cy_: np.ndarray | None, ccb: np.ndarray | None,
                     ccr: np.ndarray | None,
                     cmode: int | None = None) -> None:
        if cmode is None:
            cmode = mode
        n = 1 << log2_size
        bd = self.bd
        # luma
        av = self._avail_mask(self.decoded_y, x0, y0, n, self.w, self.h)
        refs = canonical_refs(self.y, x0, y0, n, av, bd)
        filt = filter_refs(refs, n, bd)
        pred = intra_pred_np(refs, mode, n, is_luma=True, bit_depth=bd,
                             filtered=filt)
        resi = 0
        if cy_ is not None:
            if self.bypass:
                resi = cy_
            else:
                dq = dequant_np(cy_, self.qp_y, bd)
                resi = idct_np(dq, bd, dst=(log2_size == 2))
        self.y[y0:y0 + n, x0:x0 + n] = np.clip(pred + resi, 0, (1 << bd) - 1)
        self.decoded_y[y0:y0 + n, x0:x0 + n] = True
        # chroma
        cn = n >> 1
        if cn < 4:
            return  # chroma rides the 8x8 parent (PART_NxN path)
        self._reconstruct_chroma(x0 >> 1, y0 >> 1, cn, cmode, ccb, ccr)

    # -- residual parsing (clause 7.3.8.11) ----------------------------------------

    def _residual(self, log2_size: int, c_idx: int, scan_idx: int) -> np.ndarray:
        cab = self.cab
        n = 1 << log2_size
        lx, ly = self._last_position(log2_size, c_idx)
        if scan_idx == SCAN_VER:
            lx, ly = ly, lx
        scan = full_scan_table(scan_idx, log2_size)
        inv = np.zeros(n * n, dtype=np.int32)
        # find last scan pos from raster coords
        raster_last = ly * n + lx
        last_pos = int(np.nonzero(scan == raster_last)[0][0])
        levels = np.zeros(n * n, dtype=np.int64)

        num_cg = (n * n) >> 4 if log2_size > 2 else 1
        last_cg = last_pos >> 4
        ncg = max(n >> 2, 1)
        csbf = np.zeros((ncg + 1, ncg + 1), dtype=np.int32)
        cg_scan = cg_scan_order(scan_idx, log2_size)
        csbf_base = OFF["coded_sub_block_flag"] + (2 if c_idx else 0)
        sig_base = OFF["sig_coeff_flag"] + (27 if c_idx else 0)
        gtr1_base = OFF["greater1_flag"] + (16 if c_idx else 0)
        gtr2_base = OFF["greater2_flag"] + (4 if c_idx else 0)

        c1 = 1
        for i in range(last_cg, -1, -1):
            cg_x, cg_y = int(cg_scan[i, 0]), int(cg_scan[i, 1])
            infer_sb_dc = 0
            if i == last_cg or i == 0:
                coded_sb = 1
            else:
                ctx = min(csbf[cg_y, cg_x + 1] + csbf[cg_y + 1, cg_x], 1)
                coded_sb = cab.decode_bin(csbf_base + ctx)
                infer_sb_dc = 1
            csbf[cg_y, cg_x] = coded_sb
            if not coded_sb:
                continue
            start_n = (last_pos - 1 - i * 16) if i == last_cg else 15
            sig_pos: list[int] = []
            if i == last_cg:
                sig_pos.append(last_pos)
            prev_csbf = csbf[cg_y, cg_x + 1] + 2 * csbf[cg_y + 1, cg_x]
            for nn in range(start_n, -1, -1):
                pos = i * 16 + nn
                if nn > 0 or not infer_sb_dc:
                    rp = int(scan[pos])
                    sctx = self._sig_ctx(rp % n, rp // n, log2_size, c_idx,
                                         scan_idx, prev_csbf)
                    sig = cab.decode_bin(sig_base + sctx)
                    if sig:
                        infer_sb_dc = 0
                else:
                    sig = 1
                if sig:
                    sig_pos.append(pos)
            ctx_set = (0 if (i == 0 or c_idx) else 2) + (1 if c1 == 0 else 0)
            c1 = 1
            nsig = len(sig_pos)
            gtr1_coded = min(nsig, 8)
            gtr1 = []
            first_g2 = -1
            for j in range(gtr1_coded):
                g1 = cab.decode_bin(gtr1_base + ctx_set * 4 + c1)
                gtr1.append(g1)
                if g1:
                    if first_g2 < 0:
                        first_g2 = j
                    c1 = 0
                elif 0 < c1 < 3:
                    c1 += 1
            g2 = 0
            if first_g2 >= 0:
                g2 = cab.decode_bin(gtr2_base + ctx_set)
            hidden = self.pps.sign_hiding and nsig > 0 and \
                (sig_pos[0] - sig_pos[-1] > 3)
            signs = [cab.decode_bypass()
                     for _ in range(nsig - 1 if hidden else nsig)]
            rice = 0
            abs_lv = []
            for j, pos in enumerate(sig_pos):
                if j < gtr1_coded:
                    if j == first_g2:
                        base, has_rem = 2 + g2, g2 == 1
                    else:
                        base, has_rem = 1 + gtr1[j], gtr1[j] == 1
                else:
                    base, has_rem = 1, True
                lvl = base
                if has_rem:
                    lvl = base + self._decode_remaining(rice)
                    if lvl > (3 << rice):
                        rice = min(rice + 1, 4)
                abs_lv.append(lvl)
            if hidden:
                # hidden sign = parity of the CG's sum of abs levels
                signs.append(sum(abs_lv) & 1)
            for j, pos in enumerate(sig_pos):
                levels[pos] = -abs_lv[j] if signs[j] else abs_lv[j]
        out = np.zeros(n * n, dtype=np.int32)
        out[scan] = levels[np.arange(n * n)]
        return out.reshape(n, n)

    def _last_position(self, log2_size: int, c_idx: int) -> tuple[int, int]:
        cab = self.cab
        if c_idx == 0:
            ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_off, ctx_shift = 15, log2_size - 2
        max_group = int(GROUP_IDX[(1 << log2_size) - 1])
        gx = 0
        while gx < max_group and cab.decode_bin(
                OFF["last_sig_x"] + ctx_off + (gx >> ctx_shift)):
            gx += 1
        gy = 0
        while gy < max_group and cab.decode_bin(
                OFF["last_sig_y"] + ctx_off + (gy >> ctx_shift)):
            gy += 1
        lx = int(MIN_IN_GROUP[gx])
        if gx > 3:
            lx += cab.decode_bypass_bins((gx >> 1) - 1)
        ly = int(MIN_IN_GROUP[gy])
        if gy > 3:
            ly += cab.decode_bypass_bins((gy >> 1) - 1)
        return lx, ly

    @staticmethod
    def _sig_ctx(xc: int, yc: int, log2_size: int, c_idx: int,
                 scan_idx: int, prev_csbf: int) -> int:
        from ..bitstream.syntax import SliceSyntaxEncoder
        return SliceSyntaxEncoder._sig_ctx_raw(xc, yc, log2_size, c_idx,
                                               scan_idx, prev_csbf)

    def _decode_remaining(self, rice: int) -> int:
        """Inverse of clause 9.3.3.10: truncated-Rice prefix with an
        Exp-Golomb escape after 3 leading ones."""
        cab = self.cab
        ones = 0
        while cab.decode_bypass():
            ones += 1
            if ones >= COEF_REMAIN_BIN_REDUCTION:
                break
        if ones < COEF_REMAIN_BIN_REDUCTION:
            suffix = cab.decode_bypass_bins(rice) if rice else 0
            return (ones << rice) + suffix
        length = rice
        while cab.decode_bypass():
            length += 1
        # value = 3<<rice + sum_{k=rice}^{length-1} 2^k + tail
        base = (COEF_REMAIN_BIN_REDUCTION << rice) + (1 << length) - (1 << rice)
        return base + cab.decode_bypass_bins(length)


class PSliceDecoder:
    """P-slice parser + reconstruction (inter 2Nx2N, multi-ref L0).

    Candidate derivation here is written independently of the encoder's
    common/mv_derive.py: availability uses an explicit decoded-cell mask
    updated in parse order, so a z-order bug on either side shows up as
    an encoder/decoder mismatch in tests.
    """

    def __init__(self, sps: SpsInfo, pps: PpsInfo, qp: int, data: bytes,
                 refs, max_merge: int,
                 sao: bool = False, weights=None, poc: int = 0,
                 tmvp: bool = False) -> None:
        self._init_sao(sao)
        self.sps = sps
        self.pps = pps
        self.qp = qp
        self.max_merge = max_merge
        # explicit weighted prediction (8.5.4.2.3.3): when the PPS
        # signals weighted_pred, EVERY P CU uses the weighted formula —
        # with inferred-neutral weights it equals the default rounding
        # exactly (nested-floor identity)
        self.weights = weights
        ctx = ContextSet(0)
        assert not pps.transquant_bypass, "lossless P slices unsupported"
        ctx.states = init_states(1, qp)      # P_SLICE row
        self.cab = CabacDecoder(data, ctx)
        self.w, self.h = sps.width, sps.height
        if isinstance(refs, DecodedFrame):
            refs = [refs]
        self.refs = refs
        self.ref = refs[0]
        self.num_ref = len(refs)
        self.poc = poc
        self.ref_pocs = tuple(r.poc for r in refs)
        # TMVP collocated picture = L0 ref 0 (collocated_ref_idx 0)
        self.tmvp = tmvp
        col = refs[0]
        self.col_ok = tmvp and col.inter8 is not None
        bd = sps.bit_depth
        self.bd = bd
        self.y = np.zeros((self.h, self.w), dtype=np.int32)
        self.cb = np.zeros((self.h // 2, self.w // 2), dtype=np.int32)
        self.cr = np.zeros((self.h // 2, self.w // 2), dtype=np.int32)
        n8y, n8x = self.h // 8, self.w // 8
        self.depth8 = np.zeros((n8y, n8x), dtype=np.uint8)
        self.mv8 = np.zeros((n8y, n8x, 2), dtype=np.int32)
        self.ref8 = np.zeros((n8y, n8x), dtype=np.int32)
        self.skip8 = np.zeros((n8y, n8x), dtype=bool)
        self.coded8 = np.zeros((n8y, n8x), dtype=bool)
        # intra-in-inter state: intra CUs give no MV candidates and
        # carry a luma mode for MPM derivation
        self.inter8 = np.zeros((n8y, n8x), dtype=bool)
        self.imode8 = np.full((n8y, n8x), 255, dtype=np.uint8)
        self.intra8 = np.zeros((n8y, n8x), dtype=bool)
        self.tusplit8 = np.zeros((n8y, n8x), dtype=np.int32)
        self.coeff_y = np.zeros((self.h, self.w), dtype=np.int32)
        self.qp_c = chroma_qp(qp)
        self._init_dqp()

    _decode_ctus = SliceDecoder._decode_ctus

    def decode(self, substreams=None) -> DecodedFrame:
        self._decode_ctus(substreams)
        return DecodedFrame(self.y, self.cb, self.cr, self.qp,
                            depth8=self.depth8, mv8=self.mv8,
                            coeff_y=self.coeff_y, ref8=self.ref8,
                            inter8=self.inter8,
                            ref_pocs=self.ref_pocs)

    def _tmvp_cand(self, x0, y0, nw, nh, target_ref):
        """Temporal candidate (8.5.3.2.8) from the collocated ref-0
        picture's decoded fields."""
        if not self.col_ok:
            return None
        from ..common.mv_derive import temporal_mv_p
        col = self.refs[0]
        return temporal_mv_p(col.mv8, col.ref8, col.inter8, x0, y0,
                             nw, nh, self.w, self.h, self.poc,
                             self.ref_pocs, col.poc,
                             col.ref_pocs or (col.poc - 1,),
                             target_ref, self.sps.log2_ctu)

    _init_sao = SliceDecoder._init_sao
    _parse_sao = SliceDecoder._parse_sao
    _init_dqp = SliceDecoder._init_dqp
    _ctu_qp_start = SliceDecoder._ctu_qp_start
    _ctu_qp_end = SliceDecoder._ctu_qp_end
    _parse_dqp = SliceDecoder._parse_dqp
    qp_y = SliceDecoder.qp_y

    def _depth_at(self, x, y):
        return int(self.depth8[y >> 3, x >> 3])

    def _cu_tree(self, x0, y0, log2_size):
        size = 1 << log2_size
        depth = self.sps.log2_ctu - log2_size
        inside = x0 + size <= self.w and y0 + size <= self.h
        if inside and log2_size > self.sps.log2_min_cu:
            ctx = 0
            if x0 > 0 and self.coded8[y0 >> 3, (x0 - 1) >> 3] \
                    and self._depth_at(x0 - 1, y0) > depth:
                ctx += 1
            if y0 > 0 and self.coded8[(y0 - 1) >> 3, x0 >> 3] \
                    and self._depth_at(x0, y0 - 1) > depth:
                ctx += 1
            split = self.cab.decode_bin(OFF["split_cu_flag"] + ctx)
        elif log2_size > self.sps.log2_min_cu:
            split = 1
        else:
            split = 0
        if split:
            half = size >> 1
            for sub in range(4):
                sx = x0 + (sub & 1) * half
                sy = y0 + (sub >> 1) * half
                if sx < self.w and sy < self.h:
                    self._cu_tree(sx, sy, log2_size - 1)
        else:
            self._cu(x0, y0, log2_size)

    # -- availability + candidates (decoded-mask formulation) ------------------

    def _mv_if_coded(self, nx, ny):
        """(refIdx, mv) of the decoded inter cell at (nx, ny), else
        None."""
        if nx < 0 or ny < 0 or nx >= self.w or ny >= self.h:
            return None
        if not self.coded8[ny >> 3, nx >> 3]:
            return None
        if not self.inter8[ny >> 3, nx >> 3]:
            return None            # intra neighbour: no MV candidate
        return (int(self.ref8[ny >> 3, nx >> 3]),
                (int(self.mv8[ny >> 3, nx >> 3, 0]),
                 int(self.mv8[ny >> 3, nx >> 3, 1])))

    def _merge_cands(self, x0, y0, n):
        """Merge list as (refIdx, mv): spatial, temporal (TMVP), zero
        candidates with incrementing refIdx (8.5.3.2.3-5)."""
        get = self._mv_if_coded
        a1 = get(x0 - 1, y0 + n - 1)
        b1 = get(x0 + n - 1, y0 - 1)
        b0 = get(x0 + n, y0 - 1)
        a0 = get(x0 - 1, y0 + n)
        cands = []
        if a1 is not None:
            cands.append(a1)
        if b1 is not None and b1 != a1:
            cands.append(b1)
        if b0 is not None and b0 != b1:
            cands.append(b0)
        if a0 is not None and a0 != a1:
            cands.append(a0)
        if len(cands) < 4:
            b2 = get(x0 - 1, y0 - 1)
            if b2 is not None and b2 != a1 and b2 != b1:
                cands.append(b2)
        if len(cands) < self.max_merge:
            t = self._tmvp_cand(x0, y0, n, n, 0)
            if t is not None:
                cands.append((0, t))
        cands = cands[:self.max_merge]
        zero_idx = 0
        while len(cands) < self.max_merge:
            cands.append((zero_idx if zero_idx < self.num_ref else 0,
                          (0, 0)))
            zero_idx += 1
        return cands

    def _amvp_cands(self, x0, y0, n, target_ref=0):
        """AMVP for refIdx target_ref (8.5.3.2.6-7): same-ref
        neighbours unscaled, then POC-scaled passes, then TMVP."""
        from ..common.mv_derive import _scale_mv
        get = self._mv_if_coded
        tpoc = self.ref_pocs[target_ref]

        def unscaled(c):
            ref, mv = c
            return mv if ref == target_ref else None

        def scaled(c):
            ref, mv = c
            tb = self.poc - tpoc
            td = self.poc - self.ref_pocs[ref]
            if tb == td:
                return mv
            return _scale_mv(mv, tb, td)

        a0 = get(x0 - 1, y0 + n)
        a1 = get(x0 - 1, y0 + n - 1)
        b0 = get(x0 + n, y0 - 1)
        b1 = get(x0 + n - 1, y0 - 1)
        b2 = get(x0 - 1, y0 - 1)

        mvp_a = None
        for c in (a0, a1):
            if c is not None and mvp_a is None:
                mvp_a = unscaled(c)
        is_scaled_a = a0 is not None or a1 is not None
        if mvp_a is None:
            for c in (a0, a1):
                if c is not None and mvp_a is None:
                    mvp_a = scaled(c)
        mvp_b = None
        for c in (b0, b1, b2):
            if c is not None and mvp_b is None:
                mvp_b = unscaled(c)
        if mvp_a is None:
            mvp_a = mvp_b
            mvp_b = None
        if mvp_b is None and not is_scaled_a:
            for c in (b0, b1, b2):
                if c is not None and mvp_b is None:
                    mvp_b = scaled(c)
        cands = []
        if mvp_a is not None:
            cands.append(mvp_a)
        if mvp_b is not None and mvp_b != mvp_a:
            cands.append(mvp_b)
        if len(cands) < 2:
            t = self._tmvp_cand(x0, y0, n, n, target_ref)
            if t is not None and t not in cands:
                cands.append(t)
        while len(cands) < 2:
            cands.append((0, 0))
        return cands[:2]

    def _decode_ref_idx(self):
        """ref_idx_l0 — TR cMax = num_ref-1; bins 0/1 context-coded."""
        cmax = self.num_ref - 1
        if cmax <= 0:
            return 0
        ref = 0
        while ref < cmax:
            bit = self.cab.decode_bin(OFF["ref_idx"] + ref) if ref < 2 \
                else self.cab.decode_bypass()
            if not bit:
                break
            ref += 1
        return ref

    # -- CU parse + recon ------------------------------------------------------

    def _cu(self, x0, y0, log2_size):
        cab = self.cab
        size = 1 << log2_size
        ctxs = 0
        if x0 > 0 and self.skip8[y0 >> 3, (x0 - 1) >> 3]:
            ctxs += 1
        if y0 > 0 and self.skip8[(y0 - 1) >> 3, x0 >> 3]:
            ctxs += 1
        skip = cab.decode_bin(OFF["cu_skip_flag"] + ctxs)
        s = size >> 3
        sl = np.s_[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s]
        d = self.sps.log2_ctu - log2_size
        if skip:
            idx = self._merge_idx()
            ref, mv = self._merge_cands(x0, y0, size)[idx]
            self._finish_cu(x0, y0, size, mv, None, None, None, True,
                            sl, d, ref=ref)
            return
        pred_mode = cab.decode_bin(OFF["pred_mode_flag"])
        if pred_mode:
            self._cu_intra_in_p(x0, y0, log2_size, sl, d)
            return
        part = cab.decode_bin(OFF["part_mode"])
        assert part == 1, "only 2Nx2N emitted"
        if cab.decode_bin(OFF["merge_flag"]):
            idx = self._merge_idx()
            ref, mv = self._merge_cands(x0, y0, size)[idx]
            root_cbf = 1          # inferred for 2Nx2N merge non-skip
        else:
            ref = self._decode_ref_idx()
            mvd = self._decode_mvd()
            mvp_idx = cab.decode_bin(OFF["mvp_flag"])
            mvp = self._amvp_cands(x0, y0, size, ref)[mvp_idx]
            mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
            root_cbf = cab.decode_bin(OFF["rqt_root_cbf"])
        cy_ = ccb = ccr = None
        tusplit = False
        if root_cbf:
            cy_, ccb, ccr, tusplit = \
                self._transform_tree_inter(log2_size)
        if tusplit:
            self.tusplit8[sl] = 1
        self._finish_cu(x0, y0, size, mv, cy_, ccb, ccr, False, sl, d,
                        tusplit=tusplit, ref=ref)

    def _transform_tree_inter(self, l2):
        """transform_tree for an inter 2Nx2N CU (clause 7.3.8.8),
        MaxTrafoDepth = sps.max_trafo_depth_inter (0 or 1). Returns
        CU-sized coefficient arrays (None when no coded coefficients)
        plus the split flag."""
        cab = self.cab
        size = 1 << l2
        cn = size >> 1
        split = 0
        if l2 == 6:
            split = 1   # 64 > max TB 32: split inferred (7.4.9.8)
        elif self.sps.max_trafo_depth_inter > 0 and 2 < l2 <= 5:
            split = cab.decode_bin(OFF["split_transform_flag"] + 5 - l2)
        cbf_cb = cab.decode_bin(OFF["cbf_chroma"])
        cbf_cr = cab.decode_bin(OFF["cbf_chroma"])
        if not split:
            if cbf_cb or cbf_cr:
                cbf_y = cab.decode_bin(OFF["cbf_luma"] + 1)
            else:
                cbf_y = 1           # inferred (7.4.9.8)
            if cbf_y or cbf_cb or cbf_cr:
                self._parse_dqp()
            cy_ = self._residual(l2, 0, SCAN_DIAG) if cbf_y else None
            ccb = ccr = None
            if cn >= 4:
                if cbf_cb:
                    ccb = self._residual(l2 - 1, 1, SCAN_DIAG)
                if cbf_cr:
                    ccr = self._residual(l2 - 1, 2, SCAN_DIAG)
            return cy_, ccb, ccr, False
        # split: 4 children at l2-1, trafoDepth 1 == MaxTrafoDepth
        cl2 = l2 - 1
        hs = size >> 1
        cy_full = np.zeros((size, size), np.int32)
        ccb_full = np.zeros((cn, cn), np.int32)
        ccr_full = np.zeros((cn, cn), np.int32)
        any_y = any_cb = any_cr = False
        for blk, (dy, dx) in enumerate(((0, 0), (0, hs), (hs, 0),
                                        (hs, hs))):
            if cl2 > 2:
                c_cb = cab.decode_bin(OFF["cbf_chroma"] + 1) \
                    if cbf_cb else 0
                c_cr = cab.decode_bin(OFF["cbf_chroma"] + 1) \
                    if cbf_cr else 0
            else:
                # 4x4 luma TUs: single chroma TU coded with blkIdx 3
                c_cb = cbf_cb if blk == 3 else 0
                c_cr = cbf_cr if blk == 3 else 0
            cbf_y = cab.decode_bin(OFF["cbf_luma"])   # trafoDepth 1
            if cbf_y or c_cb or c_cr:
                self._parse_dqp()
            if cbf_y:
                cy_full[dy:dy + hs, dx:dx + hs] = \
                    self._residual(cl2, 0, SCAN_DIAG)
                any_y = True
            if cl2 > 2:
                if c_cb:
                    ccb_full[dy >> 1:(dy >> 1) + (hs >> 1),
                             dx >> 1:(dx >> 1) + (hs >> 1)] = \
                        self._residual(cl2 - 1, 1, SCAN_DIAG)
                    any_cb = True
                if c_cr:
                    ccr_full[dy >> 1:(dy >> 1) + (hs >> 1),
                             dx >> 1:(dx >> 1) + (hs >> 1)] = \
                        self._residual(cl2 - 1, 2, SCAN_DIAG)
                    any_cr = True
            else:
                if c_cb:
                    ccb_full[:, :] = self._residual(2, 1, SCAN_DIAG)
                    any_cb = True
                if c_cr:
                    ccr_full[:, :] = self._residual(2, 2, SCAN_DIAG)
                    any_cr = True
        return (cy_full if any_y else None,
                ccb_full if any_cb else None,
                ccr_full if any_cr else None, True)

    def _merge_idx(self):
        if self.max_merge <= 1:
            return 0
        if not self.cab.decode_bin(OFF["merge_idx"]):
            return 0
        idx = 1
        while idx < self.max_merge - 1 and self.cab.decode_bypass():
            idx += 1
        return idx

    def _decode_mvd(self):
        cab = self.cab
        g0x = cab.decode_bin(OFF["abs_mvd_greater_flag"])
        g0y = cab.decode_bin(OFF["abs_mvd_greater_flag"])
        g1x = cab.decode_bin(OFF["abs_mvd_greater_flag"] + 1) if g0x else 0
        g1y = cab.decode_bin(OFF["abs_mvd_greater_flag"] + 1) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if not g0:
                out.append(0)
                continue
            v = 1
            if g1:
                v = 2 + self._decode_eg1()
            out.append(-v if cab.decode_bypass() else v)
        return tuple(out)

    def _decode_eg1(self):
        cab = self.cab
        count = 1
        value = 0
        while cab.decode_bypass():
            value += 1 << count
            count += 1
        return value + cab.decode_bypass_bins(count)

    def _neighbor_mode_p(self, x, y, above):
        """candIntraPredMode in a P slice: non-intra neighbours -> DC."""
        if above:
            if y == 0 or ((y - 1) >> self.sps.log2_ctu) != \
                    (y >> self.sps.log2_ctu):
                return INTRA_DC
            ny, nx = y - 1, x
        else:
            if x == 0:
                return INTRA_DC
            ny, nx = y, x - 1
        if not self.intra8[ny >> 3, nx >> 3]:
            return INTRA_DC
        return int(self.imode8[ny >> 3, nx >> 3])

    def _cu_intra_in_p(self, x0, y0, log2_size, sl, d):
        """Intra CU inside a P slice: PART_2Nx2N, DM chroma; predicts
        from the already-decoded planes (the encoder's parity
        independent-set guarantees those neighbours are inter)."""
        cab = self.cab
        n = 1 << log2_size
        bd = self.bd
        if log2_size == self.sps.log2_min_cu:
            assert cab.decode_bin(OFF["part_mode"]) == 1, \
                "only 2Nx2N intra emitted in P"
        mpm = derive_mpm(self._neighbor_mode_p(x0, y0, False),
                         self._neighbor_mode_p(x0, y0, True))
        if cab.decode_bin(OFF["prev_intra_luma_pred_flag"]):
            idx = cab.decode_bypass()
            if idx:
                idx += cab.decode_bypass()
            mode = mpm[idx]
        else:
            mode = cab.decode_bypass_bins(5)
            for m in sorted(mpm):
                if mode >= m:
                    mode += 1
        assert cab.decode_bin(OFF["intra_chroma_pred_mode"]) == 0, \
            "only DM chroma emitted in P"
        cbf_cb = cab.decode_bin(OFF["cbf_chroma"])
        cbf_cr = cab.decode_bin(OFF["cbf_chroma"])
        cbf_y = cab.decode_bin(OFF["cbf_luma"] + 1)
        if cbf_y or cbf_cb or cbf_cr:
            self._parse_dqp()
        cy_ = ccb = ccr = None
        if cbf_y:
            cy_ = self._residual(log2_size, 0,
                                 intra_scan_idx(mode, log2_size, True))
        cscan = intra_scan_idx(mode, log2_size - 1, False)
        if cbf_cb:
            ccb = self._residual(log2_size - 1, 1, cscan)
        if cbf_cr:
            ccr = self._residual(log2_size - 1, 2, cscan)

        self.depth8[sl] = d
        self.skip8[sl] = False
        self.coded8[sl] = True
        self.inter8[sl] = False
        self.intra8[sl] = True
        self.imode8[sl] = mode
        qpy = self.qp_y
        qpc = chroma_qp(qpy) if self.dqp_on else self.qp_c
        maxv = (1 << bd) - 1

        def avail_from_coded(x, y):
            if x < 0 or y < 0 or x >= self.w or y >= self.h:
                return False
            return bool(self.coded8[y >> 3, x >> 3])

        # luma
        av = np.zeros(4 * n + 1, dtype=bool)
        for i in range(4 * n + 1):
            if i < 2 * n:
                xx, yy = x0 - 1, y0 + (2 * n - 1 - i)
            elif i == 2 * n:
                xx, yy = x0 - 1, y0 - 1
            else:
                xx, yy = x0 + (i - 2 * n - 1), y0 - 1
            av[i] = avail_from_coded(xx, yy)
        refs = canonical_refs(self.y, x0, y0, n, av, bd)
        filt = filter_refs(refs, n, bd)
        pred = intra_pred_np(refs, mode, n, is_luma=True, bit_depth=bd,
                             filtered=filt)
        resi = 0
        if cy_ is not None:
            self.coeff_y[y0:y0 + n, x0:x0 + n] = cy_
            resi = idct_np(dequant_np(cy_, qpy, bd), bd)
        self.y[y0:y0 + n, x0:x0 + n] = np.clip(pred + resi, 0, maxv)
        # chroma (DM), 4:2:0
        cn = n >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        avc = np.zeros(4 * cn + 1, dtype=bool)
        for i in range(4 * cn + 1):
            if i < 2 * cn:
                xx, yy = cx0 - 1, cy0 + (2 * cn - 1 - i)
            elif i == 2 * cn:
                xx, yy = cx0 - 1, cy0 - 1
            else:
                xx, yy = cx0 + (i - 2 * cn - 1), cy0 - 1
            avc[i] = avail_from_coded(xx * 2, yy * 2)
        for plane, coeff in ((self.cb, ccb), (self.cr, ccr)):
            refs_c = canonical_refs(plane, cx0, cy0, cn, avc, bd)
            pred_c = intra_pred_np(refs_c, mode, cn, is_luma=False,
                                   bit_depth=bd)
            resi_c = 0
            if coeff is not None:
                resi_c = idct_np(dequant_np(coeff, qpc, bd), bd)
            plane[cy0:cy0 + cn, cx0:cx0 + cn] = np.clip(
                pred_c + resi_c, 0, maxv)

    def _finish_cu(self, x0, y0, size, mv, cy_, ccb, ccr, skip, sl, d,
                   tusplit=False, ref=0):
        self.depth8[sl] = d
        self.mv8[sl] = mv
        self.ref8[sl] = ref
        self.skip8[sl] = skip
        self.coded8[sl] = True
        self.inter8[sl] = True
        refpic = self.refs[ref]
        bd = self.bd

        def inv(coeff, qp, split_n):
            return _inv_tu(coeff, qp, bd, split_n)

        def weighted(acc, w, o, denom):
            # uni weighted sample prediction from the 26-bit two-stage
            # accumulator: i = acc >> 6 is the 14-bit intermediate
            log2wd = denom + 14 - bd
            v = ((w * (acc >> 6) + (1 << (log2wd - 1))) >> log2wd) \
                + (o << (bd - 8))
            return np.clip(v, 0, (1 << bd) - 1)

        use_w = self.weights is not None and ref == 0
        if use_w:
            from ..ops.interp import chroma_mc_acc_np, luma_mc_raw_np
            denom, wy, oy, wcb, ocb, wcr, ocr = self.weights
            pred = weighted(luma_mc_raw_np(refpic.y, x0, y0, size,
                                           mv[0], mv[1], bd), wy, oy,
                            denom)
            cw = {id(self.cb): (wcb, ocb), id(self.cr): (wcr, ocr)}
        else:
            pred = luma_mc_np(refpic.y, x0, y0, size, mv[0], mv[1], bd)
        qpy = self.qp_y
        qpc = chroma_qp(qpy) if self.dqp_on else self.qp_c
        resi = 0
        if cy_ is not None:
            self.coeff_y[y0:y0 + size, x0:x0 + size] = cy_
            resi = inv(cy_, qpy, (size >> 1) if tusplit else 0)
        self.y[y0:y0 + size, x0:x0 + size] = np.clip(
            pred + resi, 0, (1 << bd) - 1)
        cn = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        for plane, ref_p, coeff in ((self.cb, refpic.cb, ccb),
                                    (self.cr, refpic.cr, ccr)):
            if use_w:
                wc, oc = cw[id(plane)]
                pred_c = weighted(chroma_mc_acc_np(ref_p, cx0, cy0, cn,
                                                   mv[0], mv[1], bd),
                                  wc, oc, denom)
            else:
                pred_c = chroma_mc_np(ref_p, cx0, cy0, cn, mv[0], mv[1],
                                      bd)
            resi_c = 0
            if coeff is not None:
                csplit = (cn >> 1) if (tusplit and cn > 4) else 0
                resi_c = inv(coeff, qpc, csplit)
            plane[cy0:cy0 + cn, cx0:cx0 + cn] = np.clip(
                pred_c + resi_c, 0, (1 << bd) - 1)

    # residual parsing shared with the I-slice decoder
    _residual = SliceDecoder._residual
    _last_position = SliceDecoder._last_position
    _sig_ctx = staticmethod(SliceDecoder._sig_ctx)
    _decode_remaining = SliceDecoder._decode_remaining


class BSliceDecoder:
    """B-slice parser + reconstruction (inter 2Nx2N, L0+L1, one ref
    each). Candidate derivation reuses common/mv_derive.py's B routines
    (shared with the encoder — the uni-list P path keeps an independent
    implementation as the cross-check of the z-availability logic)."""

    def __init__(self, sps: SpsInfo, pps: PpsInfo, qp: int, data: bytes,
                 ref0: DecodedFrame, ref1: DecodedFrame, max_merge: int,
                 poc_refs: tuple[int, int], poc: int,
                 sao: bool = False) -> None:
        from ..common.mv_derive import MvFieldB
        self._init_sao(sao)
        self.sps = sps
        self.pps = pps
        self.qp = qp
        self.max_merge = max_merge
        self.poc_refs = poc_refs
        self.poc = poc
        ctx = ContextSet(0)
        assert not pps.transquant_bypass, "lossless B slices unsupported"
        ctx.states = init_states(0, qp)      # B_SLICE row
        self.cab = CabacDecoder(data, ctx)
        self.w, self.h = sps.width, sps.height
        self.refs = (ref0, ref1)
        bd = sps.bit_depth
        self.bd = bd
        self.y = np.zeros((self.h, self.w), dtype=np.int32)
        self.cb = np.zeros((self.h // 2, self.w // 2), dtype=np.int32)
        self.cr = np.zeros((self.h // 2, self.w // 2), dtype=np.int32)
        n8y, n8x = self.h // 8, self.w // 8
        self.depth8 = np.zeros((n8y, n8x), dtype=np.uint8)
        self.field = MvFieldB(n8y, n8x)
        self.mvb = self.field.mv
        self.pf8 = self.field.pf
        self.mv8 = self.field.mv     # (n8y, n8x, 2, 2); alias for decode()
        self.skip8 = np.zeros((n8y, n8x), dtype=bool)
        self.coded8 = np.zeros((n8y, n8x), dtype=bool)
        self.coeff_y = np.zeros((self.h, self.w), dtype=np.int32)
        self.qp_c = chroma_qp(qp)
        self._init_dqp()

    def decode(self, substreams=None) -> DecodedFrame:
        self._decode_ctus(substreams)
        return DecodedFrame(self.y, self.cb, self.cr, self.qp,
                            depth8=self.depth8, mv8=self.mv8,
                            coeff_y=self.coeff_y)
    _decode_ctus = SliceDecoder._decode_ctus
    _depth_at = PSliceDecoder._depth_at
    _cu_tree = PSliceDecoder._cu_tree
    _merge_idx = PSliceDecoder._merge_idx
    _decode_mvd = PSliceDecoder._decode_mvd
    _decode_eg1 = PSliceDecoder._decode_eg1
    _init_sao = SliceDecoder._init_sao
    _parse_sao = SliceDecoder._parse_sao
    _residual = SliceDecoder._residual
    _last_position = SliceDecoder._last_position
    _sig_ctx = staticmethod(SliceDecoder._sig_ctx)
    _decode_remaining = SliceDecoder._decode_remaining
    _init_dqp = SliceDecoder._init_dqp
    _ctu_qp_start = SliceDecoder._ctu_qp_start
    _ctu_qp_end = SliceDecoder._ctu_qp_end
    _parse_dqp = SliceDecoder._parse_dqp
    _transform_tree_inter = PSliceDecoder._transform_tree_inter
    qp_y = SliceDecoder.qp_y

    def _cu(self, x0, y0, log2_size):
        from ..common.mv_derive import merge_candidates_b, amvp_candidates_b
        cab = self.cab
        size = 1 << log2_size
        ctxs = 0
        if x0 > 0 and self.skip8[y0 >> 3, (x0 - 1) >> 3]:
            ctxs += 1
        if y0 > 0 and self.skip8[(y0 - 1) >> 3, x0 >> 3]:
            ctxs += 1
        skip = cab.decode_bin(OFF["cu_skip_flag"] + ctxs)
        s = size >> 3
        sl = np.s_[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s]
        d = self.sps.log2_ctu - log2_size

        def norm(c):
            return (c[0], c[1] if c[0] & 1 else (0, 0),
                    c[2] if c[0] & 2 else (0, 0))

        if skip:
            idx = self._merge_idx()
            mi = norm(merge_candidates_b(
                self.field, x0, y0, size, self.w, self.h,
                self.sps.log2_ctu, self.max_merge)[idx])
            self._finish_cu(x0, y0, size, mi, None, None, None, True,
                            sl, d)
            return
        assert cab.decode_bin(OFF["pred_mode_flag"]) == 0
        assert cab.decode_bin(OFF["part_mode"]) == 1
        if cab.decode_bin(OFF["merge_flag"]):
            idx = self._merge_idx()
            mi = norm(merge_candidates_b(
                self.field, x0, y0, size, self.w, self.h,
                self.sps.log2_ctu, self.max_merge)[idx])
            root_cbf = 1
        else:
            if cab.decode_bin(OFF["inter_pred_idc"] + d):
                pf = 3
            else:
                pf = 2 if cab.decode_bin(OFF["inter_pred_idc"] + 4) else 1
            mvs = [(0, 0), (0, 0)]
            for lx in (0, 1):
                if not (pf & (1 << lx)):
                    continue
                mvd = self._decode_mvd()
                mvp_idx = cab.decode_bin(OFF["mvp_flag"])
                mvp = amvp_candidates_b(
                    self.field, lx, x0, y0, size, self.w, self.h,
                    self.sps.log2_ctu, self.poc, self.poc_refs)[mvp_idx]
                mvs[lx] = (mvp[0] + mvd[0], mvp[1] + mvd[1])
            mi = (pf, mvs[0], mvs[1])
            root_cbf = cab.decode_bin(OFF["rqt_root_cbf"])
        cy_ = ccb = ccr = None
        tusplit = False
        if root_cbf:
            cy_, ccb, ccr, tusplit = \
                self._transform_tree_inter(log2_size)
        self._finish_cu(x0, y0, size, mi, cy_, ccb, ccr, False, sl, d,
                        tusplit=tusplit)

    def _finish_cu(self, x0, y0, size, mi, cy_, ccb, ccr, skip, sl, d,
                   tusplit=False):
        from ..ops.interp import (_luma_mc_acc, chroma_mc_acc_np,
                                  bi_average_np, luma_mc_np, chroma_mc_np)
        pf, mv0, mv1 = mi
        self.depth8[sl] = d
        self.skip8[sl] = skip
        self.coded8[sl] = True
        self.field.set_cu(x0, y0, size, pf, mv0, mv1)
        bd = self.bd

        def pred_plane(plane_sel, x, y, n, luma):
            accs = []
            for lx, mv in ((0, mv0), (1, mv1)):
                if not (pf & (1 << lx)):
                    continue
                ref = self.refs[lx]
                rp = ref.y if luma else plane_sel(ref)
                if luma:
                    accs.append(_luma_mc_acc(rp, x, y, n, mv[0], mv[1], bd))
                else:
                    accs.append(chroma_mc_acc_np(rp, x, y, n, mv[0],
                                                 mv[1], bd))
            if len(accs) == 2:
                return bi_average_np(accs[0], accs[1], bd)
            shift1 = bd - 8
            ts = 12 - shift1
            out = (accs[0] + (1 << (ts - 1))) >> ts
            return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)

        pred = pred_plane(None, x0, y0, size, True)
        qpy = self.qp_y
        qpc = chroma_qp(qpy) if self.dqp_on else self.qp_c
        resi = 0
        if cy_ is not None:
            self.coeff_y[y0:y0 + size, x0:x0 + size] = cy_
            resi = _inv_tu(cy_, qpy, bd,
                           (size >> 1) if tusplit else 0)
        self.y[y0:y0 + size, x0:x0 + size] = np.clip(
            pred + resi, 0, (1 << bd) - 1)
        cn = size >> 1
        cx0, cy0 = x0 >> 1, y0 >> 1
        for sel, plane, coeff in ((lambda r: r.cb, self.cb, ccb),
                                  (lambda r: r.cr, self.cr, ccr)):
            pred_c = pred_plane(sel, cx0, cy0, cn, False)
            resi_c = 0
            if coeff is not None:
                csplit = (cn >> 1) if (tusplit and cn > 4) else 0
                resi_c = _inv_tu(coeff, qpc, bd, csplit)
            plane[cy0:cy0 + cn, cx0:cx0 + cn] = np.clip(
                pred_c + resi_c, 0, (1 << bd) - 1)
