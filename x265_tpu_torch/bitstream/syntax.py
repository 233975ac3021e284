"""Frame syntax records: the dense per-frame decision arrays the
device passes produce and the native CABAC slice coder consumes
(H.265 clauses 7.3.8, 9.3.4). The pure-Python slice coder of the
reference package is not carried: this package entropy-codes through
the native coder only (native/entropy_native.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
