"""CTU / CU / TU CABAC syntax encoding (H.265 clauses 7.3.8, 9.3.4).

The frame syntax records are the dense per-frame decision arrays the
device passes produce. The encoder's slices are coded from them by the
native CABAC coder (native/entropy_native.py); SliceSyntaxEncoder is
the pure-Python slice coder of the same syntax, a copy of the one in
x265_tpu/bitstream/syntax.py. IntraEncoder.encode_frame(
use_native_cabac=False) codes the I slice through it, the tests hold
the native coder against it, and the validation decoder (decoder/)
shares its context derivations. Behavioral parity reference: x265
source/encoder/entropy.cpp:765-2250 (encodeCTU/codeCoeffNxN); all
context derivations here are written from the spec clauses cited inline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..common.params import EncoderConfig, I_SLICE
from ..common.tables import (SCAN_DIAG, SCAN_HOR, SCAN_VER, full_scan_table,
                             cg_scan_order, intra_scan_idx)
from .cabac import CabacEncoder, ContextSet
from .ctx_tables import OFF, init_states

# --- binarization tables (clause 9.3.3.1.3: last position grouping) ----------

# group index per coefficient position 0..31
GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
                     dtype=np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)

# sig_coeff_flag ctxIdxMap for 4x4 TBs (clause 9.3.4.2.5)
SIG_CTX_4X4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8],
                       dtype=np.int32)

C1FLAG_NUMBER = 8       # max greater1 flags per CG
C2FLAG_NUMBER = 1       # max greater2 flags per CG
COEF_REMAIN_BIN_REDUCTION = 3

INTRA_DC = 1
INTRA_PLANAR = 0
INTRA_VER = 26


@dataclass
class FrameIntraSyntax:
    """Dense frame decision arrays in min-CU (8x8) granularity."""
    depth8: np.ndarray     # (n8y, n8x) uint8: quadtree depth of covering CU
    mode8: np.ndarray      # (n8y, n8x) uint8: luma intra mode of covering
    #                        CU (for PART_NxN CUs: PU0's mode — the
    #                        chroma-DM source, clause 8.4.3)
    coeff_y: np.ndarray    # (H, W) int32, TUs laid out at their position
    coeff_cb: np.ndarray   # (H/2, W/2) int32
    coeff_cr: np.ndarray   # (H/2, W/2) int32
    cmode8: np.ndarray | None = None   # chroma pred mode; None = DM
    nxn8: np.ndarray | None = None     # (n8y, n8x) bool: PART_NxN CUs
    mode4: np.ndarray | None = None    # (H/4, W/4) uint8 per-PU modes


@dataclass
class FrameBSyntax:
    """B-frame decisions: inter 2Nx2N CUs, L0 + L1 (one reference
    each)."""
    depth8: np.ndarray     # (n8y, n8x) uint8
    mv8: np.ndarray        # (n8y, n8x, 2, 2) int32 qpel MV per list
    pf8: np.ndarray        # (n8y, n8x) uint8 pred flags (1 L0, 2 L1, 3 bi)
    coeff_y: np.ndarray
    coeff_cb: np.ndarray
    coeff_cr: np.ndarray
    poc: int = 0
    poc_refs: tuple = (0, 0)   # (L0 ref POC, L1 ref POC)
    max_merge: int = 2
    sao_params: tuple | None = None   # (p_y, p_cb, p_cr) per-CTU params
    qp_map: np.ndarray | None = None  # per-CTU QP (dQP), None = uniform


@dataclass
class FramePSyntax:
    """P-frame decisions: inter 2Nx2N CUs (multi-reference L0) plus
    optional 8x8 intra CUs (checkIntraInInter analog)."""
    depth8: np.ndarray     # (n8y, n8x) uint8
    mv8: np.ndarray        # (n8y, n8x, 2) int32 qpel MV of covering CU
    coeff_y: np.ndarray
    coeff_cb: np.ndarray
    coeff_cr: np.ndarray
    max_merge: int = 2
    sao_params: tuple | None = None   # (p_y, p_cb, p_cr) per-CTU params
    qp_map: np.ndarray | None = None  # per-CTU QP (dQP), None = uniform
    intra8: np.ndarray | None = None  # (n8y, n8x) bool: 8x8 intra CUs
    mode8: np.ndarray | None = None   # luma intra mode where intra8
    tusplit8: np.ndarray | None = None  # (n8y, n8x) uint8: CU's TU
    #                                     tree split one level (RQT)
    # --- multi-reference prediction (x265 --ref N, search.cpp:2354) ---
    ref8: np.ndarray | None = None    # (n8y, n8x) uint8 L0 refIdx of
    #                                   covering CU (None == all 0)
    num_ref: int = 1                  # num_ref_idx_l0_active
    ref_pocs: tuple | None = None     # POC of each L0 ref, idx order
    poc: int = 0
    # --- temporal MVP (sps_temporal_mvp, clause 8.5.3.2.8): the
    # collocated (previous-P) picture's per-8x8 motion fields ---
    col_mv: np.ndarray | None = None
    col_ref: np.ndarray | None = None
    col_inter: np.ndarray | None = None
    col_poc: int = 0
    col_ref_pocs: tuple = (0,)


def derive_mpm(cand_a: int, cand_b: int) -> list[int]:
    """Most-probable intra modes (clause 8.4.2)."""
    if cand_a == cand_b:
        if cand_a < 2:
            return [INTRA_PLANAR, INTRA_DC, INTRA_VER]
        return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 2 + 1) % 32)]
    mpm = [cand_a, cand_b]
    if INTRA_PLANAR not in mpm:
        mpm.append(INTRA_PLANAR)
    elif INTRA_DC not in mpm:
        mpm.append(INTRA_DC)
    else:
        mpm.append(INTRA_VER)
    return mpm


class SliceSyntaxEncoder:
    """Encodes one slice's CTUs into a CABAC bin stream."""

    def __init__(self, cfg: EncoderConfig, syn, slice_type: int = I_SLICE,
                 qp: int | None = None, sao_params=None,
                 qp_map=None) -> None:
        self.cfg = cfg
        self.syn = syn
        self.slice_type = slice_type
        self.qp = cfg.qp if qp is None else qp
        # per-CTU dQP (cu_qp_delta, clause 7.3.8.10): QG == CTU, so the
        # predictor is simply the previous QG's QP in raster order
        self.qp_map = qp_map            # (ncty, nctx) int or None
        self.prev_qp = self.qp
        self.dqp_pending = False
        self.dqp_target = self.qp
        ctx = ContextSet(0)
        ctx.states = init_states(slice_type, self.qp)
        self.cab = CabacEncoder(ctx)
        self.w = cfg.width_padded
        self.h = cfg.height_padded
        self.n8x = self.w // 8
        self.n8y = self.h // 8
        self.is_p = isinstance(syn, FramePSyntax)
        self.is_b = isinstance(syn, FrameBSyntax)
        self.sao_params = sao_params   # (p_y, p_cb, p_cr) or None
        if self.is_p:
            from ..common.mv_derive import MvField
            self.field = MvField(self.n8y, self.n8x)
            self.skip8 = np.zeros((self.n8y, self.n8x), dtype=bool)
        elif self.is_b:
            from ..common.mv_derive import MvFieldB
            self.fieldb = MvFieldB(self.n8y, self.n8x)
            self.skip8 = np.zeros((self.n8y, self.n8x), dtype=bool)

    # -- top level -------------------------------------------------------------

    def encode_slice_data(self) -> CabacEncoder:
        cfg = self.cfg
        n_ctu = cfg.ctu_rows * cfg.ctu_cols
        for addr in range(n_ctu):
            cy, cx = divmod(addr, cfg.ctu_cols)
            self.encode_ctu(cx * cfg.ctu_size, cy * cfg.ctu_size)
            self.cab.encode_terminate(1 if addr == n_ctu - 1 else 0)
        return self.cab

    def encode_slice_data_wpp(self) -> list[bytes]:
        """WPP (entropy_coding_sync): one byte-aligned substream per
        CTU row; row r+1's contexts fork from the state saved after
        CTU 1 of row r (frameencoder.cpp:1509-1537); qPY_PREV resets
        to the slice QP at each row (clause 8.6.1)."""
        cfg = self.cfg
        rows, cols = cfg.ctu_rows, cfg.ctu_cols
        n_ctu = rows * cols
        init = self.cab.ctx.states.copy()
        subs: list[bytes] = []
        saved = init       # cols == 1: rows re-init (no above-right CTU)
        for row in range(rows):
            ctx = ContextSet(0)
            ctx.states = init.copy() if row == 0 else saved.copy()
            self.cab = CabacEncoder(ctx)
            self.prev_qp = self.qp
            for col in range(cols):
                addr = row * cols + col
                self.encode_ctu(col * cfg.ctu_size, row * cfg.ctu_size)
                self.cab.encode_terminate(1 if addr == n_ctu - 1 else 0)
                if col == 1 and rows > 1:
                    saved = ctx.states.copy()
            if row < rows - 1:
                self.cab.encode_terminate(1)   # end_of_subset_one_bit
            subs.append(self.cab.finish_aligned())
        return subs

    def encode_ctu(self, x0: int, y0: int) -> None:
        if self.qp_map is not None:
            self.dqp_pending = True
            self.dqp_target = int(self.qp_map[y0 >> self.cfg.log2_ctu,
                                              x0 >> self.cfg.log2_ctu])
        if self.sao_params is not None:
            self._code_sao(x0 // self.cfg.ctu_size,
                           y0 // self.cfg.ctu_size)
        self._code_cu_tree(x0, y0, self.cfg.log2_ctu)

    def _maybe_code_dqp(self) -> None:
        """cu_qp_delta_abs/sign (7.3.8.10, 9.3.3.9: TU(5) prefix +
        EG0 suffix), coded once per QG at the first TU with any cbf."""
        if not self.dqp_pending:
            return
        self.dqp_pending = False
        delta = self.dqp_target - self.prev_qp
        self.prev_qp = self.dqp_target
        cab = self.cab
        a = abs(delta)
        cab.encode_bin(OFF["cu_qp_delta_abs"], int(a > 0))
        if a == 0:
            return
        for _ in range(1, min(a, 5)):
            cab.encode_bin(OFF["cu_qp_delta_abs"] + 1, 1)
        if a < 5:
            cab.encode_bin(OFF["cu_qp_delta_abs"] + 1, 0)
        else:
            self._code_eg0(a - 5)
        cab.encode_bypass(1 if delta < 0 else 0)

    def _code_eg0(self, symbol: int) -> None:
        """0th-order Exp-Golomb, bypass."""
        cab = self.cab
        count = 0
        while symbol >= (1 << count):
            cab.encode_bypass(1)
            symbol -= 1 << count
            count += 1
        cab.encode_bypass(0)
        if count:
            cab.encode_bypass_bins(symbol, count)

    # -- sao syntax (clause 7.3.8.3) --------------------------------------------

    def _code_sao(self, tx: int, ty: int) -> None:
        cab = self.cab
        py, pcb, pcr = self.sao_params

        def eq(ax, ay, bx, by):
            return all(np.array_equal(p[ay, ax], p[by, bx])
                       for p in (py, pcb, pcr))

        if tx > 0:
            merge_left = eq(tx - 1, ty, tx, ty)
            cab.encode_bin(OFF["sao_merge_flag"], int(merge_left))
            if merge_left:
                return
        if ty > 0:
            merge_up = eq(tx, ty - 1, tx, ty)
            cab.encode_bin(OFF["sao_merge_flag"], int(merge_up))
            if merge_up:
                return
        for cidx, p in enumerate((py, pcb, pcr)):
            t = int(p[ty, tx, 0])
            if cidx == 0:
                self._code_sao_type(t)
            elif cidx == 1:
                self._code_sao_type(t)
            if t == 0:
                continue
            offs = [int(v) for v in p[ty, tx, 2:6]]
            for o in offs:
                self._code_sao_offset_abs(abs(o))
            if t == 1:                       # band
                for o in offs:
                    if o != 0:
                        cab.encode_bypass(1 if o < 0 else 0)
                cab.encode_bypass_bins(int(p[ty, tx, 1]), 5)
            elif cidx == 0:
                cab.encode_bypass_bins(int(p[ty, tx, 1]), 2)
            elif cidx == 1:
                cab.encode_bypass_bins(int(p[ty, tx, 1]), 2)

    def _code_sao_type(self, t: int) -> None:
        self.cab.encode_bin(OFF["sao_type_idx"], int(t != 0))
        if t:
            self.cab.encode_bypass(int(t == 2))

    def _code_sao_offset_abs(self, v: int) -> None:
        cmax = 7
        for i in range(v):
            self.cab.encode_bypass(1)
        if v < cmax:
            self.cab.encode_bypass(0)

    # -- coding quadtree (clause 7.3.8.4) ---------------------------------------

    def _depth_at(self, x: int, y: int) -> int:
        return int(self.syn.depth8[y >> 3, x >> 3])

    def _cu_depth_of(self, log2_size: int) -> int:
        return self.cfg.log2_ctu - log2_size

    def _code_cu_tree(self, x0: int, y0: int, log2_size: int) -> None:
        size = 1 << log2_size
        cfg = self.cfg
        depth = self._cu_depth_of(log2_size)
        inside = x0 + size <= self.w and y0 + size <= self.h
        if inside and log2_size > cfg.log2_min_cu:
            split = self._depth_at(x0, y0) > depth
            # ctxInc: neighbours coded with greater depth (9.3.4.2.2)
            ctx = 0
            if x0 > 0 and self._depth_at(x0 - 1, y0) > depth:
                ctx += 1
            if y0 > 0 and self._depth_at(x0, y0 - 1) > depth:
                ctx += 1
            self.cab.encode_bin(OFF["split_cu_flag"] + ctx, int(split))
        elif log2_size > cfg.log2_min_cu:
            split = True   # forced split at picture boundary, no flag
        else:
            split = False
        if split:
            half = size >> 1
            for sub in range(4):
                sx = x0 + (sub & 1) * half
                sy = y0 + (sub >> 1) * half
                if sx < self.w and sy < self.h:
                    self._code_cu_tree(sx, sy, log2_size - 1)
        else:
            self._code_cu(x0, y0, log2_size)

    # -- B-slice coding unit ----------------------------------------------------

    def _code_cu_b(self, x0: int, y0: int, log2_size: int) -> None:
        from ..common.mv_derive import merge_candidates_b, amvp_candidates_b
        cab = self.cab
        syn = self.syn
        size = 1 << log2_size
        c8 = (y0 >> 3, x0 >> 3)
        pf = int(syn.pf8[c8])
        mv0 = (int(syn.mv8[c8][0][0]), int(syn.mv8[c8][0][1]))
        mv1 = (int(syn.mv8[c8][1][0]), int(syn.mv8[c8][1][1]))
        mi = (pf, mv0 if pf & 1 else (0, 0), mv1 if pf & 2 else (0, 0))
        cbf_y = self._cbf(syn.coeff_y, x0, y0, size)
        cbf_cb = self._cbf(syn.coeff_cb, x0 >> 1, y0 >> 1, size >> 1)
        cbf_cr = self._cbf(syn.coeff_cr, x0 >> 1, y0 >> 1, size >> 1)
        cbf_any = bool(cbf_y or cbf_cb or cbf_cr)
        mcands = merge_candidates_b(self.fieldb, x0, y0, size, self.w,
                                    self.h, self.cfg.log2_ctu,
                                    syn.max_merge)
        norm = [(c[0], c[1] if c[0] & 1 else (0, 0),
                 c[2] if c[0] & 2 else (0, 0)) for c in mcands]
        merge_idx = norm.index(mi) if mi in norm else -1
        skip = merge_idx >= 0 and not cbf_any

        ctx = 0
        if x0 > 0 and self.skip8[y0 >> 3, (x0 - 1) >> 3]:
            ctx += 1
        if y0 > 0 and self.skip8[(y0 - 1) >> 3, x0 >> 3]:
            ctx += 1
        cab.encode_bin(OFF["cu_skip_flag"] + ctx, int(skip))
        s = size >> 3
        self.skip8[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s] = skip
        self.fieldb.set_cu(x0, y0, size, pf, mi[1], mi[2])

        if skip:
            self._code_merge_idx(merge_idx)
            return
        cab.encode_bin(OFF["pred_mode_flag"], 0)
        cab.encode_bin(OFF["part_mode"], 1)
        if merge_idx >= 0:
            cab.encode_bin(OFF["merge_flag"], 1)
            self._code_merge_idx(merge_idx)
            assert cbf_any, "merge non-skip requires residual"
        else:
            cab.encode_bin(OFF["merge_flag"], 0)
            # inter_pred_idc (9.3.3.7): bin0 = BI? (ctx=CtDepth);
            # else bin1 = L1? (ctx 4)
            depth = self.cfg.log2_ctu - log2_size
            cab.encode_bin(OFF["inter_pred_idc"] + depth, int(pf == 3))
            if pf != 3:
                cab.encode_bin(OFF["inter_pred_idc"] + 4, int(pf == 2))
            for lx in (0, 1):
                if not (pf & (1 << lx)):
                    continue
                acands = amvp_candidates_b(
                    self.fieldb, lx, x0, y0, size, self.w, self.h,
                    self.cfg.log2_ctu, syn.poc, syn.poc_refs)
                mv = mi[1 + lx]
                c0 = abs(mv[0] - acands[0][0]) + abs(mv[1] - acands[0][1])
                c1 = abs(mv[0] - acands[1][0]) + abs(mv[1] - acands[1][1])
                mvp_idx = 0 if c0 <= c1 else 1
                self._code_mvd(mv[0] - acands[mvp_idx][0],
                               mv[1] - acands[mvp_idx][1])
                cab.encode_bin(OFF["mvp_flag"], mvp_idx)
            cab.encode_bin(OFF["rqt_root_cbf"], int(cbf_any))
            if not cbf_any:
                return
        self._code_transform_unit_inter(x0, y0, log2_size,
                                        cbf_y, cbf_cb, cbf_cr)

    # -- P-slice coding unit (clauses 7.3.8.5-7.3.8.9) --------------------------

    def _neighbor_mode_p(self, x: int, y: int, *, above: bool) -> int:
        """candIntraPredMode for P slices: non-intra neighbours give DC
        (clause 8.4.2)."""
        if above:
            if y == 0 or ((y - 1) >> self.cfg.log2_ctu) != \
                    (y >> self.cfg.log2_ctu):
                return INTRA_DC
            ny, nx = y - 1, x
        else:
            if x == 0:
                return INTRA_DC
            ny, nx = y, x - 1
        if self.syn.intra8 is None or not self.syn.intra8[ny >> 3, nx >> 3]:
            return INTRA_DC
        return int(self.syn.mode8[ny >> 3, nx >> 3])

    def _code_cu_p_intra(self, x0: int, y0: int, log2_size: int) -> None:
        """Intra CU inside a P slice (checkIntraInInter analog):
        cu_skip 0, pred_mode 1, PART_2Nx2N, DM chroma."""
        cab = self.cab
        syn = self.syn
        ctx = 0
        if x0 > 0 and self.skip8[y0 >> 3, (x0 - 1) >> 3]:
            ctx += 1
        if y0 > 0 and self.skip8[(y0 - 1) >> 3, x0 >> 3]:
            ctx += 1
        cab.encode_bin(OFF["cu_skip_flag"] + ctx, 0)
        s = (1 << log2_size) >> 3
        self.skip8[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s] = False
        self.field.set_cu(x0, y0, 1 << log2_size, (0, 0), inter=False)
        cab.encode_bin(OFF["pred_mode_flag"], 1)      # MODE_INTRA
        if log2_size == self.cfg.log2_min_cu:
            cab.encode_bin(OFF["part_mode"], 1)       # PART_2Nx2N
        mode = int(syn.mode8[y0 >> 3, x0 >> 3])
        mpm = derive_mpm(self._neighbor_mode_p(x0, y0, above=False),
                         self._neighbor_mode_p(x0, y0, above=True))
        cab.encode_bin(OFF["prev_intra_luma_pred_flag"],
                       int(mode in mpm))
        if mode in mpm:
            idx = mpm.index(mode)
            cab.encode_bypass(0 if idx == 0 else 1)
            if idx:
                cab.encode_bypass(idx - 1)
        else:
            rem = mode
            for m in sorted(mpm, reverse=True):
                if mode > m:
                    rem -= 1
            cab.encode_bypass_bins(rem, 5)
        cab.encode_bin(OFF["intra_chroma_pred_mode"], 0)   # DM
        self._code_transform_unit(x0, y0, log2_size, mode, mode)

    def _tmvp_fn(self, x0: int, y0: int, target_ref: int):
        """Temporal-candidate closure for (x0, y0) targeting
        `target_ref`, or None when TMVP is off / no collocated
        fields."""
        syn = self.syn
        if getattr(syn, "col_inter", None) is None:
            return None
        from ..common.mv_derive import temporal_mv_p
        return lambda nw, nh: temporal_mv_p(
            syn.col_mv, syn.col_ref, syn.col_inter, x0, y0, nw, nh,
            self.w, self.h, syn.poc, syn.ref_pocs or (syn.poc - 1,),
            syn.col_poc, syn.col_ref_pocs, target_ref,
            self.cfg.log2_ctu)

    def _code_ref_idx(self, ref: int) -> None:
        """ref_idx_l0 — TR binarization cMax = num_ref-1 (9.3.3.2);
        bins 0/1 context-coded, the rest bypass."""
        cmax = self.syn.num_ref - 1
        if cmax <= 0:
            return
        for i in range(min(ref + 1, cmax)):
            bit = 1 if i < ref else 0
            if i < 2:
                self.cab.encode_bin(OFF["ref_idx"] + i, bit)
            else:
                self.cab.encode_bypass(bit)
            if not bit:
                break

    def _code_cu_p(self, x0: int, y0: int, log2_size: int) -> None:
        from ..common.mv_derive import merge_candidates, amvp_candidates
        cab = self.cab
        syn = self.syn
        if syn.intra8 is not None and syn.intra8[y0 >> 3, x0 >> 3]:
            self._code_cu_p_intra(x0, y0, log2_size)
            return
        size = 1 << log2_size
        mv = (int(syn.mv8[y0 >> 3, x0 >> 3, 0]),
              int(syn.mv8[y0 >> 3, x0 >> 3, 1]))
        ref = int(syn.ref8[y0 >> 3, x0 >> 3]) \
            if syn.ref8 is not None else 0
        cbf_y = self._cbf(syn.coeff_y, x0, y0, size)
        cbf_cb = self._cbf(syn.coeff_cb, x0 >> 1, y0 >> 1, size >> 1)
        cbf_cr = self._cbf(syn.coeff_cr, x0 >> 1, y0 >> 1, size >> 1)
        cbf_any = bool(cbf_y or cbf_cb or cbf_cr)
        mcands = merge_candidates(self.field, x0, y0, size, self.w, self.h,
                                  self.cfg.log2_ctu, syn.max_merge,
                                  num_ref=syn.num_ref,
                                  tmvp=self._tmvp_fn(x0, y0, 0))
        mi = (ref, mv)
        merge_idx = mcands.index(mi) if mi in mcands else -1
        skip = merge_idx >= 0 and not cbf_any

        ctx = 0
        if x0 > 0 and self.skip8[y0 >> 3, (x0 - 1) >> 3]:
            ctx += 1
        if y0 > 0 and self.skip8[(y0 - 1) >> 3, x0 >> 3]:
            ctx += 1
        cab.encode_bin(OFF["cu_skip_flag"] + ctx, int(skip))
        s = size >> 3
        self.skip8[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s] = skip
        self.field.set_cu(x0, y0, size, mv, inter=True, ref=ref)

        if skip:
            self._code_merge_idx(merge_idx)
            return
        cab.encode_bin(OFF["pred_mode_flag"], 0)      # MODE_INTER
        cab.encode_bin(OFF["part_mode"], 1)           # PART_2Nx2N
        if merge_idx >= 0:
            cab.encode_bin(OFF["merge_flag"], 1)
            self._code_merge_idx(merge_idx)
            # rqt_root_cbf not coded for 2Nx2N merge: inferred 1
            assert cbf_any, "merge non-skip requires residual"
        else:
            cab.encode_bin(OFF["merge_flag"], 0)
            self._code_ref_idx(ref)
            acands = amvp_candidates(self.field, x0, y0, size, self.w,
                                     self.h, self.cfg.log2_ctu,
                                     target_ref=ref,
                                     ref_pocs=syn.ref_pocs,
                                     poc_cur=syn.poc,
                                     tmvp=self._tmvp_fn(x0, y0, ref))
            c0 = abs(mv[0] - acands[0][0]) + abs(mv[1] - acands[0][1])
            c1 = abs(mv[0] - acands[1][0]) + abs(mv[1] - acands[1][1])
            mvp_idx = 0 if c0 <= c1 else 1
            mvd = (mv[0] - acands[mvp_idx][0], mv[1] - acands[mvp_idx][1])
            self._code_mvd(mvd[0], mvd[1])
            cab.encode_bin(OFF["mvp_flag"], mvp_idx)
            cab.encode_bin(OFF["rqt_root_cbf"], int(cbf_any))
            if not cbf_any:
                return
        self._code_transform_unit_inter(x0, y0, log2_size,
                                        cbf_y, cbf_cb, cbf_cr)

    def _code_merge_idx(self, idx: int) -> None:
        mx = self.syn.max_merge
        if mx <= 1:
            return
        self.cab.encode_bin(OFF["merge_idx"], int(idx > 0))
        if idx > 0:
            for i in range(1, mx - 1):
                self.cab.encode_bypass(0 if idx == i else 1)
                if idx == i:
                    break

    def _code_mvd(self, mx: int, my: int) -> None:
        """mvd_coding (clause 7.3.8.9)."""
        cab = self.cab
        ax, ay = abs(mx), abs(my)
        cab.encode_bin(OFF["abs_mvd_greater_flag"], int(ax > 0))
        cab.encode_bin(OFF["abs_mvd_greater_flag"], int(ay > 0))
        if ax > 0:
            cab.encode_bin(OFF["abs_mvd_greater_flag"] + 1, int(ax > 1))
        if ay > 0:
            cab.encode_bin(OFF["abs_mvd_greater_flag"] + 1, int(ay > 1))
        for v, a in ((mx, ax), (my, ay)):
            if a > 0:
                if a > 1:
                    self._code_eg1(a - 2)
                cab.encode_bypass(1 if v < 0 else 0)

    def _code_eg1(self, symbol: int) -> None:
        """1st-order Exp-Golomb, bypass (abs_mvd_minus2 binarization)."""
        cab = self.cab
        count = 1
        while symbol >= (1 << count):
            cab.encode_bypass(1)
            symbol -= 1 << count
            count += 1
        cab.encode_bypass(0)
        cab.encode_bypass_bins(symbol, count)

    def _tusplit_at(self, x0: int, y0: int) -> int:
        t8 = getattr(self.syn, "tusplit8", None)
        if t8 is None:
            return 0
        return int(t8[y0 >> 3, x0 >> 3])

    def _code_transform_unit_inter(self, x0: int, y0: int, log2_size: int,
                                   cbf_y: int, cbf_cb: int,
                                   cbf_cr: int) -> None:
        """transform_tree for an inter 2Nx2N CU (clause 7.3.8.8), TU
        depth 0 or 1 (split chosen by the device RD; the
        estimateResidualQT analog, search.cpp:3178)."""
        cab = self.cab
        syn = self.syn
        size = 1 << log2_size
        cx, cy, csize = x0 >> 1, y0 >> 1, size >> 1
        split = 0
        if log2_size == 6:
            split = 1   # 64 > max TB 32: split inferred (7.4.9.8)
        elif getattr(self.cfg, "rqt_inter", False) and 2 < log2_size <= 5:
            split = self._tusplit_at(x0, y0)
            cab.encode_bin(OFF["split_transform_flag"] + 5 - log2_size,
                           split)
        cab.encode_bin(OFF["cbf_chroma"], cbf_cb)
        cab.encode_bin(OFF["cbf_chroma"], cbf_cr)
        if not split:
            if cbf_cb or cbf_cr:
                cab.encode_bin(OFF["cbf_luma"] + 1, cbf_y)
            else:
                assert cbf_y, "rqt_root_cbf implies residual"
            if cbf_y or cbf_cb or cbf_cr:
                self._maybe_code_dqp()
            if cbf_y:
                self.code_residual(
                    syn.coeff_y[y0:y0 + size, x0:x0 + size],
                    log2_size, 0, SCAN_DIAG)
            if csize >= 4:
                if cbf_cb:
                    self.code_residual(
                        syn.coeff_cb[cy:cy + csize, cx:cx + csize],
                        log2_size - 1, 1, SCAN_DIAG)
                if cbf_cr:
                    self.code_residual(
                        syn.coeff_cr[cy:cy + csize, cx:cx + csize],
                        log2_size - 1, 2, SCAN_DIAG)
            return
        # split: four TUs at log2_size-1, trafoDepth 1 == MaxTrafoDepth
        cl2 = log2_size - 1
        hs = size >> 1
        qs = hs >> 1
        for blk, (dy, dx) in enumerate(((0, 0), (0, hs), (hs, 0),
                                        (hs, hs))):
            if cl2 > 2:
                scx, scy = (x0 + dx) >> 1, (y0 + dy) >> 1
                c_cb = self._cbf(syn.coeff_cb, scx, scy, qs) \
                    if cbf_cb else 0
                c_cr = self._cbf(syn.coeff_cr, scx, scy, qs) \
                    if cbf_cr else 0
                if cbf_cb:
                    cab.encode_bin(OFF["cbf_chroma"] + 1, c_cb)
                if cbf_cr:
                    cab.encode_bin(OFF["cbf_chroma"] + 1, c_cr)
            else:
                # 4x4 luma TUs: single chroma TU coded with blkIdx 3
                c_cb = cbf_cb if blk == 3 else 0
                c_cr = cbf_cr if blk == 3 else 0
            c_y = self._cbf(syn.coeff_y, x0 + dx, y0 + dy, hs)
            cab.encode_bin(OFF["cbf_luma"], c_y)   # trafoDepth 1
            if c_y or c_cb or c_cr:
                self._maybe_code_dqp()
            if c_y:
                self.code_residual(
                    syn.coeff_y[y0 + dy:y0 + dy + hs,
                                x0 + dx:x0 + dx + hs],
                    cl2, 0, SCAN_DIAG)
            if cl2 > 2:
                scx, scy = (x0 + dx) >> 1, (y0 + dy) >> 1
                if c_cb:
                    self.code_residual(
                        syn.coeff_cb[scy:scy + qs, scx:scx + qs],
                        cl2 - 1, 1, SCAN_DIAG)
                if c_cr:
                    self.code_residual(
                        syn.coeff_cr[scy:scy + qs, scx:scx + qs],
                        cl2 - 1, 2, SCAN_DIAG)
            elif blk == 3:
                if cbf_cb:
                    self.code_residual(syn.coeff_cb[cy:cy + 4,
                                                    cx:cx + 4],
                                       2, 1, SCAN_DIAG)
                if cbf_cr:
                    self.code_residual(syn.coeff_cr[cy:cy + 4,
                                                    cx:cx + 4],
                                       2, 2, SCAN_DIAG)

    # -- coding unit (clause 7.3.8.5, intra only so far) ------------------------

    def _luma_mode_at(self, x: int, y: int) -> int:
        """IntraPredModeY at 4x4 (PU) granularity."""
        if self.syn.mode4 is not None:
            return int(self.syn.mode4[y >> 2, x >> 2])
        return int(self.syn.mode8[y >> 3, x >> 3])

    def _neighbor_mode(self, x: int, y: int, *, above: bool) -> int:
        """candIntraPredModeA/B (clause 8.4.2), PU granularity."""
        if above:
            if y == 0:
                return INTRA_DC
            ny = y - 1
            if (ny >> self.cfg.log2_ctu) != (y >> self.cfg.log2_ctu):
                return INTRA_DC   # above CTU row: treated as unavailable
            return self._luma_mode_at(x, ny)
        if x == 0:
            return INTRA_DC
        return self._luma_mode_at(x - 1, y)

    def _mpm_at(self, x: int, y: int) -> list[int]:
        return derive_mpm(self._neighbor_mode(x, y, above=False),
                          self._neighbor_mode(x, y, above=True))

    def _code_cu(self, x0: int, y0: int, log2_size: int) -> None:
        if self.cfg.lossless:
            # cu_transquant_bypass_flag: first CU syntax element when
            # the PPS enables bypass (7.3.8.5); frame-lossless codes 1
            self.cab.encode_bin(OFF["cu_transquant_bypass"], 1)
        if self.is_p:
            self._code_cu_p(x0, y0, log2_size)
            return
        if self.is_b:
            self._code_cu_b(x0, y0, log2_size)
            return
        cfg = self.cfg
        cab = self.cab
        nxn = (log2_size == cfg.log2_min_cu and
               self.syn.nxn8 is not None and
               bool(self.syn.nxn8[y0 >> 3, x0 >> 3]))
        # I-slice: no cu_skip / pred_mode flags; part_mode only at min size
        if log2_size == cfg.log2_min_cu:
            cab.encode_bin(OFF["part_mode"], 0 if nxn else 1)
        size = 1 << log2_size
        pus = [(x0, y0)] if not nxn else \
            [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]
        modes = [self._luma_mode_at(x, y) for x, y in pus]
        # loop 1: all prev_intra_luma_pred_flags (clause 7.3.8.5)
        for (x, y), m in zip(pus, modes):
            cab.encode_bin(OFF["prev_intra_luma_pred_flag"],
                           int(m in self._mpm_at(x, y)))
        # loop 2: mpm_idx / rem_intra_luma_pred_mode
        for (x, y), mode in zip(pus, modes):
            mpm = self._mpm_at(x, y)
            if mode in mpm:
                idx = mpm.index(mode)
                cab.encode_bypass(0 if idx == 0 else 1)
                if idx:
                    cab.encode_bypass(idx - 1)
            else:
                rem = mode
                for m in sorted(mpm, reverse=True):
                    if mode > m:
                        rem -= 1
                cab.encode_bypass_bins(rem, 5)
        # intra_chroma_pred_mode (clause 8.4.3 candidate list): '0' =
        # DM; '1' + 2 bypass bins = index into [planar, ver, hor, dc]
        # with the luma-mode entry substituted by angular-34. DM source
        # is PU0's luma mode (mode8 stores it for NxN CUs).
        mode = modes[0]
        cmode = mode if self.syn.cmode8 is None else \
            int(self.syn.cmode8[y0 >> 3, x0 >> 3])
        if cmode == mode:
            cab.encode_bin(OFF["intra_chroma_pred_mode"], 0)
        else:
            cand = [34 if c == mode else c for c in (0, 26, 10, 1)]
            cab.encode_bin(OFF["intra_chroma_pred_mode"], 1)
            cab.encode_bypass_bins(cand.index(cmode), 2)
        if nxn:
            # IntraSplitFlag=1: split_transform_flag inferred 1 — four
            # 4x4 luma TUs, chroma stays at the 8x8 parent (7.3.8.8)
            self._code_transform_nxn(x0, y0, modes, cmode)
        else:
            # transform tree: TU == CU
            self._code_transform_unit(x0, y0, log2_size, mode, cmode)

    def _code_transform_nxn(self, x0: int, y0: int, modes: list[int],
                            cmode: int) -> None:
        """Implicitly-split transform tree of a PART_NxN 8x8 intra CU:
        chroma cbfs at trafoDepth 0, then per 4x4 sub-TU cbf_luma
        (ctx 0: trafoDepth>0) + DST luma residual; chroma residual
        rides the blkIdx==3 transform_unit (clause 7.3.8.10)."""
        cab = self.cab
        syn = self.syn
        cx, cy = x0 >> 1, y0 >> 1
        cbf_cb = self._cbf(syn.coeff_cb, cx, cy, 4)
        cbf_cr = self._cbf(syn.coeff_cr, cx, cy, 4)
        cab.encode_bin(OFF["cbf_chroma"], cbf_cb)
        cab.encode_bin(OFF["cbf_chroma"], cbf_cr)
        for s, (x, y) in enumerate(((x0, y0), (x0 + 4, y0),
                                    (x0, y0 + 4), (x0 + 4, y0 + 4))):
            cbf = self._cbf(syn.coeff_y, x, y, 4)
            cab.encode_bin(OFF["cbf_luma"], cbf)
            # transform_unit for blkIdx s: chroma cbfs attach to s==3
            if cbf or (s == 3 and (cbf_cb or cbf_cr)):
                self._maybe_code_dqp()
            if cbf:
                scan = intra_scan_idx(modes[s], 2, True)
                self.code_residual(syn.coeff_y[y:y + 4, x:x + 4], 2, 0,
                                   scan)
        cscan = intra_scan_idx(cmode, 2, False)
        if cbf_cb:
            self.code_residual(syn.coeff_cb[cy:cy + 4, cx:cx + 4], 2, 1,
                               cscan)
        if cbf_cr:
            self.code_residual(syn.coeff_cr[cy:cy + 4, cx:cx + 4], 2, 2,
                               cscan)

    # -- transform tree / unit (clauses 7.3.8.8, 7.3.8.10) ----------------------

    def _cbf(self, coeff: np.ndarray, x: int, y: int, size: int) -> int:
        return int(np.any(coeff[y:y + size, x:x + size]))

    def _code_transform_unit(self, x0: int, y0: int, log2_size: int,
                             luma_mode: int,
                             chroma_mode: int | None = None) -> None:
        cab = self.cab
        syn = self.syn
        size = 1 << log2_size
        cx, cy, csize = x0 >> 1, y0 >> 1, size >> 1
        cbf_cb = self._cbf(syn.coeff_cb, cx, cy, csize)
        cbf_cr = self._cbf(syn.coeff_cr, cx, cy, csize)
        cbf_y = self._cbf(syn.coeff_y, x0, y0, size)
        # trafoDepth == 0: chroma cbfs first, ctx = trafoDepth (9.3.4.2.2)
        cab.encode_bin(OFF["cbf_chroma"], cbf_cb)
        cab.encode_bin(OFF["cbf_chroma"], cbf_cr)
        # cbf_luma ctx: trafoDepth == 0 ? 1 : 0
        cab.encode_bin(OFF["cbf_luma"] + 1, cbf_y)
        if cbf_y or cbf_cb or cbf_cr:
            self._maybe_code_dqp()
        if cbf_y:
            blk = syn.coeff_y[y0:y0 + size, x0:x0 + size]
            scan = intra_scan_idx(luma_mode, log2_size, True)
            self.code_residual(blk, log2_size, 0, scan)
        if csize >= 4:
            cm = luma_mode if chroma_mode is None else chroma_mode
            cscan = intra_scan_idx(cm, log2_size - 1, False)
            if cbf_cb:
                self.code_residual(syn.coeff_cb[cy:cy + csize, cx:cx + csize],
                                   log2_size - 1, 1, cscan)
            if cbf_cr:
                self.code_residual(syn.coeff_cr[cy:cy + csize, cx:cx + csize],
                                   log2_size - 1, 2, cscan)

    # -- residual coding (clause 7.3.8.11) --------------------------------------

    def code_residual(self, blk: np.ndarray, log2_size: int, c_idx: int,
                      scan_idx: int) -> None:
        cab = self.cab
        n = 1 << log2_size
        flat = blk.reshape(-1)
        scan = full_scan_table(scan_idx, log2_size)   # raster idx per scan pos
        levels = flat[scan]                           # coeffs in scan order
        nz = np.nonzero(levels)[0]
        last_pos = int(nz[-1])
        lx, ly = int(scan[last_pos] % n), int(scan[last_pos] // n)
        if scan_idx == SCAN_VER:
            lx, ly = ly, lx
        self._code_last_position(lx, ly, log2_size, c_idx)

        num_cg = 1 << (2 * max(log2_size - 2, 0))
        last_cg = last_pos >> 4
        # csbf map in CG raster coords
        ncg = max(n >> 2, 1)
        csbf = np.zeros((ncg + 1, ncg + 1), dtype=np.int32)
        cg_scan = cg_scan_order(scan_idx, log2_size)  # (numCG, 2) (x, y)
        cg_has = np.zeros(num_cg, dtype=bool)
        for i in range(last_cg + 1):
            s, e = i * 16, min(i * 16 + 16, last_pos + 1)
            cg_has[i] = bool(np.any(levels[s:e]))
        gtr1_base = OFF["greater1_flag"] + (16 if c_idx else 0)
        gtr2_base = OFF["greater2_flag"] + (4 if c_idx else 0)
        sig_base = OFF["sig_coeff_flag"] + (27 if c_idx else 0)
        csbf_base = OFF["coded_sub_block_flag"] + (2 if c_idx else 0)

        c1 = 1
        for i in range(last_cg, -1, -1):
            cg_x, cg_y = int(cg_scan[i, 0]), int(cg_scan[i, 1])
            infer_sb_dc = 0
            if i == last_cg or i == 0:
                coded_sb = 1 if (i == 0 or cg_has[i]) else 1
                # both inferred 1
                coded_sb = 1
            else:
                coded_sb = int(cg_has[i])
                ctx = min(csbf[cg_y, cg_x + 1] + csbf[cg_y + 1, cg_x], 1)
                cab.encode_bin(csbf_base + ctx, coded_sb)
                infer_sb_dc = 1
            csbf[cg_y, cg_x] = coded_sb
            if not coded_sb:
                continue

            start_n = (last_pos - 1 - i * 16) if i == last_cg else 15
            sig_pos: list[int] = []      # scan positions with sig==1, desc order
            if i == last_cg:
                sig_pos.append(last_pos)
            prev_csbf = csbf[cg_y, cg_x + 1] + 2 * csbf[cg_y + 1, cg_x]
            for nn in range(start_n, -1, -1):
                pos = i * 16 + nn
                sig = int(levels[pos] != 0)
                if nn > 0 or not infer_sb_dc:
                    ctx = self._sig_ctx(scan[pos], nn, n, log2_size, c_idx,
                                        scan_idx, prev_csbf, cg_x, cg_y)
                    cab.encode_bin(sig_base + ctx, sig)
                    if sig:
                        infer_sb_dc = 0
                if sig:
                    sig_pos.append(pos)

            # level coding for this CG
            ctx_set = (0 if (i == 0 or c_idx) else 2) + (1 if c1 == 0 else 0)
            c1 = 1
            abs_levels = [abs(int(levels[p])) for p in sig_pos]
            signs = [1 if levels[p] < 0 else 0 for p in sig_pos]
            gtr1_coded = min(len(sig_pos), C1FLAG_NUMBER)
            first_g2 = -1
            for j in range(gtr1_coded):
                g1 = int(abs_levels[j] > 1)
                cab.encode_bin(gtr1_base + ctx_set * 4 + c1, g1)
                if g1:
                    if first_g2 < 0:
                        first_g2 = j
                    c1 = 0
                elif 0 < c1 < 3:
                    c1 += 1
            if first_g2 >= 0:
                cab.encode_bin(gtr2_base + ctx_set,
                               int(abs_levels[first_g2] > 2))
            # sign bits; with sign-data-hiding the sign of the
            # coefficient at firstSigScanPos (last in coding order) is
            # inferred from sum-of-levels parity (clause 7.4.9.11) —
            # the quant stage enforced the parity upstream
            hidden = self.cfg.sign_hiding and len(sig_pos) > 0 and \
                (sig_pos[0] - sig_pos[-1] > 3)
            for s in (signs[:-1] if hidden else signs):
                cab.encode_bypass(s)
            # remaining levels
            rice = 0
            for j, lvl in enumerate(abs_levels):
                base = 1
                if j < gtr1_coded:
                    base = 3 if j == first_g2 else 2
                if lvl >= base:
                    self._code_remaining(lvl - base, rice)
                    if lvl > (3 << rice):
                        rice = min(rice + 1, 4)

    def _code_last_position(self, lx: int, ly: int, log2_size: int,
                            c_idx: int) -> None:
        """last_sig_coeff_{x,y}_{prefix,suffix} (9.3.3.1.3, 9.3.4.2.3)."""
        cab = self.cab
        if c_idx == 0:
            ctx_off = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
            ctx_shift = (log2_size + 1) >> 2
        else:
            ctx_off, ctx_shift = 15, log2_size - 2
        gx, gy = int(GROUP_IDX[lx]), int(GROUP_IDX[ly])
        max_group = int(GROUP_IDX[(1 << log2_size) - 1])
        for i in range(gx):
            cab.encode_bin(OFF["last_sig_x"] + ctx_off + (i >> ctx_shift), 1)
        if gx < max_group:
            cab.encode_bin(OFF["last_sig_x"] + ctx_off + (gx >> ctx_shift), 0)
        for i in range(gy):
            cab.encode_bin(OFF["last_sig_y"] + ctx_off + (i >> ctx_shift), 1)
        if gy < max_group:
            cab.encode_bin(OFF["last_sig_y"] + ctx_off + (gy >> ctx_shift), 0)
        if gx > 3:
            nbits = (gx >> 1) - 1
            cab.encode_bypass_bins(lx - int(MIN_IN_GROUP[gx]), nbits)
        if gy > 3:
            nbits = (gy >> 1) - 1
            cab.encode_bypass_bins(ly - int(MIN_IN_GROUP[gy]), nbits)

    @staticmethod
    def _sig_ctx_raw(xc: int, yc: int, log2_size: int, c_idx: int,
                     scan_idx: int, prev_csbf: int) -> int:
        """sigCtx (clause 9.3.4.2.5)."""
        if log2_size == 2:
            return int(SIG_CTX_4X4[(yc << 2) + xc])
        if xc + yc == 0:
            return 0
        xp, yp = xc & 3, yc & 3
        if prev_csbf == 0:
            s = xp + yp
            sig = 2 if s == 0 else (1 if s < 3 else 0)
        elif prev_csbf == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev_csbf == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (xc >> 2) + (yc >> 2) > 0:
                sig += 3
            sig += (9 if scan_idx == SCAN_DIAG else 15) if log2_size == 3 else 21
        else:
            sig += 9 if log2_size == 3 else 12
        return sig

    def _sig_ctx(self, raster_pos: int, n_in_cg: int, n: int, log2_size: int,
                 c_idx: int, scan_idx: int, prev_csbf: int,
                 cg_x: int, cg_y: int) -> int:
        xc = raster_pos % n
        yc = raster_pos // n
        return self._sig_ctx_raw(xc, yc, log2_size, c_idx, scan_idx, prev_csbf)

    def _code_remaining(self, value: int, rice: int) -> None:
        """coeff_abs_level_remaining binarization (clause 9.3.3.10)."""
        cab = self.cab
        if value < (COEF_REMAIN_BIN_REDUCTION << rice):
            length = value >> rice
            cab.encode_bypass_bins((1 << (length + 1)) - 2, length + 1)
            cab.encode_bypass_bins(value & ((1 << rice) - 1), rice)
        else:
            length = rice
            value -= COEF_REMAIN_BIN_REDUCTION << rice
            while value >= (1 << length):
                value -= 1 << length
                length += 1
            nbits = COEF_REMAIN_BIN_REDUCTION + length + 1 - rice
            cab.encode_bypass_bins((1 << nbits) - 2, nbits)
            cab.encode_bypass_bins(value, length)
