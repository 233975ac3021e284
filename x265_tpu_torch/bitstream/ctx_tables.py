"""CABAC context model layout + normative initialization values.

The init values are normative constants of ITU-T H.265 (clause 9.3.2.2,
Tables 9-5 .. 9-32), indexed here by slice type row [B, P, I] (matching
initType 2/1/0 with cabac_init_flag=0). Layout/grouping is our own;
behavioral parity reference: x265 source/encoder/entropy.cpp:40-222.

Each syntax-element group gets a (name, count, init[3][count]) entry;
offsets into the flat state array are computed once at import.
"""

from __future__ import annotations

import numpy as np

from .cabac import ContextSet, init_context

# (name, count, [B-row, P-row, I-row]) — 154 is the spec's "unused" value
_GROUPS: list[tuple[str, int, list[list[int]]]] = [
    ("split_cu_flag", 3, [[107, 139, 126], [107, 139, 126], [139, 141, 157]]),
    ("cu_transquant_bypass", 1, [[154], [154], [154]]),
    ("cu_skip_flag", 3, [[197, 185, 201], [197, 185, 201], [154, 154, 154]]),
    ("pred_mode_flag", 1, [[134], [149], [154]]),
    ("part_mode", 4, [[154, 139, 154, 154], [154, 139, 154, 154],
                      [184, 154, 154, 154]]),
    ("prev_intra_luma_pred_flag", 1, [[183], [154], [184]]),
    ("intra_chroma_pred_mode", 1, [[152], [152], [63]]),
    ("rqt_root_cbf", 1, [[79], [79], [154]]),
    ("merge_flag", 1, [[154], [110], [154]]),
    ("merge_idx", 1, [[137], [122], [154]]),
    ("inter_pred_idc", 5, [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31],
                           [154, 154, 154, 154, 154]]),
    ("ref_idx", 2, [[153, 153], [153, 153], [154, 154]]),
    ("abs_mvd_greater_flag", 2, [[169, 198], [140, 198], [154, 154]]),
    ("mvp_flag", 1, [[168], [168], [154]]),
    ("cu_qp_delta_abs", 3, [[154, 154, 154], [154, 154, 154], [154, 154, 154]]),
    ("split_transform_flag", 3, [[224, 167, 122], [124, 138, 94],
                                 [153, 138, 138]]),
    ("cbf_luma", 2, [[153, 111], [153, 111], [111, 141]]),
    ("cbf_chroma", 5, [[149, 92, 167, 154, 154], [149, 107, 167, 154, 154],
                       [94, 138, 182, 154, 154]]),
    ("transform_skip_flag", 2, [[139, 139], [139, 139], [139, 139]]),
    # last_sig_coeff prefix: 15 luma + 3 chroma contexts, x and y separate
    ("last_sig_x", 18, [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108],
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63]]),
    ("last_sig_y", 18, [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108],
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63]]),
    # coded_sub_block_flag: 2 luma + 2 chroma
    ("coded_sub_block_flag", 4, [[121, 140, 61, 154], [121, 140, 61, 154],
                                 [91, 171, 134, 141]]),
    # sig_coeff_flag: 27 luma + 15 chroma
    ("sig_coeff_flag", 42, [
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
         151, 183, 140],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
         151, 183, 140],
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
         153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
         125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
         136, 139, 111]]),
    # coeff_abs_level_greater1: 16 luma + 8 chroma
    ("greater1_flag", 24, [
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197]]),
    # coeff_abs_level_greater2: 4 luma + 2 chroma
    ("greater2_flag", 6, [[107, 167, 91, 107, 107, 167],
                          [107, 167, 91, 122, 107, 167],
                          [138, 153, 136, 167, 152, 152]]),
    ("sao_merge_flag", 1, [[153], [153], [153]]),
    ("sao_type_idx", 1, [[160], [185], [200]]),
]

OFF: dict[str, int] = {}
NUM: dict[str, int] = {}
_off = 0
for _name, _cnt, _vals in _GROUPS:
    OFF[_name] = _off
    NUM[_name] = _cnt
    _off += _cnt
NUM_CONTEXTS = _off

# INIT_VALUES[slice_type] -> flat (NUM_CONTEXTS,) uint8 init values
INIT_VALUES = np.zeros((3, NUM_CONTEXTS), dtype=np.uint8)
for _name, _cnt, _vals in _GROUPS:
    for _st in range(3):
        INIT_VALUES[_st, OFF[_name]:OFF[_name] + _cnt] = _vals[_st]


# Precomputed packed init states for all QPs, used to avoid per-slice loops.
_STATE_CACHE: dict[tuple[int, int], np.ndarray] = {}


def make_contexts(slice_type: int, qp: int) -> ContextSet:
    """Fresh context set for a slice (clause 9.3.2.2)."""
    ctx = ContextSet(NUM_CONTEXTS)
    ctx.init_from(qp, INIT_VALUES[slice_type])
    return ctx


def init_states(slice_type: int, qp: int) -> np.ndarray:
    key = (slice_type, qp)
    st = _STATE_CACHE.get(key)
    if st is None:
        st = np.array([init_context(qp, int(v)) for v in INIT_VALUES[slice_type]],
                      dtype=np.uint8)
        _STATE_CACHE[key] = st
    return st.copy()
