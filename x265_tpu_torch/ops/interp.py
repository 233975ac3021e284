"""HEVC sub-pel interpolation filter tables (clause 8.5.4.2): 8-tap luma
quarter-pel, 4-tap chroma eighth-pel. Counterpart of the tables of
x265_tpu/ops/interp.py; the filtering itself lives where the windowed
motion search applies it (ops/me_win.py)."""

from __future__ import annotations

import numpy as np

# Table 8-11: luma interpolation filter coefficients per quarter position
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Table 8-13: chroma filter coefficients per eighth position
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)
