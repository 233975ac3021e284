"""CABAC context initialization (H.265 clause 9.3.2.2).

The slice data are coded by the native CABAC engine
(native/entropy.cpp); Python only computes the initial context states
it is handed (bitstream/ctx_tables.py init_states).
"""

from __future__ import annotations


def init_context(qp: int, init_value: int) -> int:
    """Context initialization (H.265 clause 9.3.2.2) -> packed state."""
    qp = min(max(qp, 0), 51)
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if pre >= 64 else 0
    p_state = (pre - 64) if mps else (63 - pre)
    return (p_state << 1) | mps
