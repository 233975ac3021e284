"""Merge and AMVP candidate derivation (H.265 clauses 8.5.3.2.3-8.5.3.2.7).

Scope: 2Nx2N PUs; P slices with one or several L0 references and the
temporal candidate (temporal_mv_p, POC-scaled), B slices with one
reference per list (MvFieldB, merge_candidates_b, amvp_candidates_b).
A copy of x265_tpu/common/mv_derive.py for the Python slice coder
(bitstream/syntax.py) and the validation decoder (decoder/). Reference
behavior: x265 source/common/cudata.cpp
getInterMergeCandidates/getNeighbourMV.

The MV field is stored per 8x8 cell (mv8: (n8y, n8x, 2), qpel); a cell
is "coded" if its block precedes the current CU in z-scan decode order.
Both the encoder syntax writer and (independently re-implemented) the
validation decoder derive candidates from their own decoded MV fields,
which are identical by construction.
"""

from __future__ import annotations

import numpy as np


def z_available(nx: int, ny: int, cux: int, cuy: int, w: int, h: int,
                log2_ctu: int) -> bool:
    """Is the min-block containing pixel (nx, ny) decoded before the CU
    at (cux, cuy)? (clause 6.4.1 z-scan availability, single slice)."""
    if nx < 0 or ny < 0 or nx >= w or ny >= h:
        return False
    tnx, tny = nx >> log2_ctu, ny >> log2_ctu
    tcx, tcy = cux >> log2_ctu, cuy >> log2_ctu
    if (tny, tnx) < (tcy, tcx):
        return True
    if (tny, tnx) > (tcy, tcx):
        return False
    # same CTU: compare z indices of the 8x8 cells
    return _z8(nx, ny, log2_ctu) < _z8(cux, cuy, log2_ctu)


def _z8(x: int, y: int, log2_ctu: int) -> int:
    """z index of the 8x8 cell containing (x, y) within its CTU."""
    bx = (x & ((1 << log2_ctu) - 1)) >> 3
    by = (y & ((1 << log2_ctu) - 1)) >> 3
    z = 0
    for b in range(log2_ctu - 3):
        z |= ((bx >> b) & 1) << (2 * b)
        z |= ((by >> b) & 1) << (2 * b + 1)
    return z


class MvField:
    """Per-8x8-cell motion info for one frame (P slice, L0; per-cell
    refIdx for multi-reference prediction, x265 search.cpp:2354)."""

    def __init__(self, n8y: int, n8x: int) -> None:
        self.mv = np.zeros((n8y, n8x, 2), dtype=np.int32)
        self.is_inter = np.zeros((n8y, n8x), dtype=bool)
        self.ref = np.zeros((n8y, n8x), dtype=np.int32)

    def set_cu(self, x0: int, y0: int, size: int, mv: tuple[int, int],
               inter: bool = True, ref: int = 0,
               size_h: int | None = None) -> None:
        sh = (size if size_h is None else size_h) >> 3
        sw = size >> 3
        sl = np.s_[y0 >> 3:(y0 >> 3) + sh, x0 >> 3:(x0 >> 3) + sw]
        self.mv[sl] = mv
        self.is_inter[sl] = inter
        self.ref[sl] = ref

    def at(self, x: int, y: int) -> tuple[bool, tuple[int, int], int]:
        cy, cx = y >> 3, x >> 3
        return (bool(self.is_inter[cy, cx]),
                (int(self.mv[cy, cx, 0]), int(self.mv[cy, cx, 1])),
                int(self.ref[cy, cx]))


def temporal_mv_p(col_mv, col_ref, col_inter, x0: int, y0: int,
                  nw: int, nh: int, w: int, h: int, poc_cur: int,
                  ref_pocs, col_poc: int, col_ref_pocs,
                  target_ref: int = 0,
                  log2_ctu: int = 5) -> tuple[int, int] | None:
    """Temporal MV predictor for P slices (clause 8.5.3.2.8): the
    collocated bottom-right cell (16x16-compressed, eq. 8-205) else the
    centre cell, scaled by POC distances. col_* are the collocated
    picture's per-8x8 fields (col_ref_pocs its own L0 ref POCs);
    returns None when the col cell is intra/outside."""
    if col_mv is None:
        return None
    n8y, n8x = col_inter.shape

    def probe(px, py):
        if px >= w or py >= h or px < 0 or py < 0:
            return None
        # MV storage compression: read at 16x16 granularity (8-205)
        cx, cy = (px >> 4) << 4, (py >> 4) << 4
        c8 = (cy >> 3, cx >> 3)
        if c8[0] >= n8y or c8[1] >= n8x or not col_inter[c8]:
            return None
        mv = (int(col_mv[c8][0]), int(col_mv[c8][1]))
        cref = int(col_ref[c8])
        tb = poc_cur - ref_pocs[target_ref]
        td = col_poc - col_ref_pocs[min(cref, len(col_ref_pocs) - 1)]
        if tb == td:
            return mv
        return _scale_mv(mv, tb, td)

    # bottom-right: unavailable when it leaves the current CTU row
    # (the yColBr >> CtbLog2SizeY check of 8.5.3.2.8)
    br = None
    if (y0 + nh) >> log2_ctu == y0 >> log2_ctu:
        br = probe(x0 + nw, y0 + nh)
    if br is not None:
        return br
    return probe(x0 + (nw >> 1), y0 + (nh >> 1))


def merge_candidates(field: MvField, x0: int, y0: int, size: int, w: int,
                     h: int, log2_ctu: int, max_cands: int = 2,
                     num_ref: int = 1, tmvp=None
                     ) -> list[tuple[int, tuple[int, int]]]:
    """Merge candidate list for a 2Nx2N PU (8.5.3.2.3) as
    (refIdx, mv) pairs: spatial A1,B1,B0,A0,(B2), then the temporal
    candidate (when `tmvp` — a callable (nw, nh) -> mv|None — is
    given), then zero candidates with incrementing refIdx
    (8.5.3.2.5)."""
    n = size

    def get(nx, ny):
        if not z_available(nx, ny, x0, y0, w, h, log2_ctu):
            return None
        inter, mv, ref = field.at(nx, ny)
        return (ref, mv) if inter else None

    a1 = get(x0 - 1, y0 + n - 1)
    b1 = get(x0 + n - 1, y0 - 1)
    b0 = get(x0 + n, y0 - 1)
    a0 = get(x0 - 1, y0 + n)
    cands: list[tuple[int, tuple[int, int]]] = []
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
    if tmvp is not None and len(cands) < max_cands:
        t = tmvp(n, n)
        if t is not None:
            cands.append((0, t))    # temporal merge uses refIdx 0
    cands = cands[:max_cands]
    zero_idx = 0
    nref = max(num_ref, 1)
    while len(cands) < max_cands:
        cands.append((zero_idx if zero_idx < nref else 0, (0, 0)))
        zero_idx += 1
    return cands


def amvp_candidates(field: MvField, x0: int, y0: int, size: int, w: int,
                    h: int, log2_ctu: int, target_ref: int = 0,
                    ref_pocs=None, poc_cur: int = 0,
                    size_h: int | None = None,
                    tmvp=None) -> list[tuple[int, int]]:
    """AMVP predictor list for refIdx `target_ref` (8.5.3.2.6-7): two
    entries. First pass takes same-reference neighbours unscaled; the
    scaled passes convert other-reference MVs by POC distance (the
    multi-ref case, search.cpp:2393 analog). ref_pocs[i] = POC of L0
    ref i (None == the single-ref, no-scaling legacy). The temporal
    candidate (`tmvp` callable) fills the list when < 2 remain
    (8.5.3.2.6 with sps_temporal_mvp on). size_h: PU height when
    rectangular (2NxN/Nx2N partitions)."""
    nw = size
    nh = size if size_h is None else size_h
    scaling = ref_pocs is not None and len(ref_pocs) > 1
    tpoc = ref_pocs[target_ref] if scaling else 0

    def info(nx, ny):
        if not z_available(nx, ny, x0, y0, w, h, log2_ctu):
            return None
        inter, mv, ref = field.at(nx, ny)
        return (ref, mv) if inter else None

    def unscaled(c):
        ref, mv = c
        return mv if ref == target_ref else None

    def scaled(c):
        ref, mv = c
        if not scaling:
            return mv
        tb = poc_cur - tpoc
        td = poc_cur - ref_pocs[ref]
        if tb == td:
            return mv
        return _scale_mv(mv, tb, td)

    a0 = info(x0 - 1, y0 + nh)
    a1 = info(x0 - 1, y0 + nh - 1)
    b0 = info(x0 + nw, y0 - 1)
    b1 = info(x0 + nw - 1, y0 - 1)
    b2 = info(x0 - 1, y0 - 1)

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
        # scaled B pass only when neither A neighbour exists (8.5.3.2.7)
        for c in (b0, b1, b2):
            if c is not None and mvp_b is None:
                mvp_b = scaled(c)

    cands: list = []
    if mvp_a is not None:
        cands.append(mvp_a)
    if mvp_b is not None and mvp_b != mvp_a:
        cands.append(mvp_b)
    if tmvp is not None and len(cands) < 2:
        t = tmvp(nw, nh)
        if t is not None and t not in cands:
            cands.append(t)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]


# =============================================================================
# B slices: two reference lists (L0 = previous, L1 = following picture)
# =============================================================================

class MvFieldB:
    """Per-8x8-cell motion info for a B frame: pred flags + MV per list."""

    def __init__(self, n8y: int, n8x: int) -> None:
        self.mv = np.zeros((n8y, n8x, 2, 2), dtype=np.int32)  # [list][x,y]
        self.pf = np.zeros((n8y, n8x), dtype=np.uint8)        # bit0 L0, bit1 L1

    def set_cu(self, x0: int, y0: int, size: int, pf: int,
               mv0, mv1) -> None:
        s = size >> 3
        sl = np.s_[y0 >> 3:(y0 >> 3) + s, x0 >> 3:(x0 >> 3) + s]
        self.pf[sl] = pf
        self.mv[sl + (0,)] = mv0
        self.mv[sl + (1,)] = mv1

    def at(self, x: int, y: int):
        cy, cx = y >> 3, x >> 3
        return (int(self.pf[cy, cx]),
                (int(self.mv[cy, cx, 0, 0]), int(self.mv[cy, cx, 0, 1])),
                (int(self.mv[cy, cx, 1, 0]), int(self.mv[cy, cx, 1, 1])))


def _mi_equal(a, b) -> bool:
    """Motion-info equality (pred flags + MVs; refIdx always 0)."""
    return a == b


def merge_candidates_b(field: MvFieldB, x0: int, y0: int, size: int,
                       w: int, h: int, log2_ctu: int, max_cands: int = 2
                       ) -> list[tuple[int, tuple, tuple]]:
    """B-slice merge list (8.5.3.2.3): spatial A1,B1,B0,A0,(B2) with the
    same pruning as P, then combined bi-predictive candidates
    (8.5.3.2.4), then bi zero candidates."""
    n = size

    def get(nx, ny):
        if not z_available(nx, ny, x0, y0, w, h, log2_ctu):
            return None
        pf, m0, m1 = field.at(nx, ny)
        return (pf, m0, m1) if pf else None

    a1 = get(x0 - 1, y0 + n - 1)
    b1 = get(x0 + n - 1, y0 - 1)
    b0 = get(x0 + n, y0 - 1)
    a0 = get(x0 - 1, y0 + n)
    cands: list = []
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
    cands = cands[:max_cands]
    # combined bi-predictive candidates (8.5.3.2.4)
    comb_order = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                  (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2)]
    norig = len(cands)
    if norig > 1:
        for l0i, l1i in comb_order:
            if len(cands) >= max_cands:
                break
            if l0i >= norig or l1i >= norig:
                continue
            c0, c1 = cands[l0i], cands[l1i]
            if not (c0[0] & 1) or not (c1[0] & 2):
                continue
            # refs differ by construction (L0/L1 are different pictures)
            comb = (3, c0[1], c1[2])
            cands.append(comb)
    while len(cands) < max_cands:
        cands.append((3, (0, 0), (0, 0)))
    return cands[:max_cands]


def _scale_mv(mv: tuple[int, int], tb: int, td: int) -> tuple[int, int]:
    """POC-distance MV scaling (8.5.3.2.8 eq. 8-175..177). Divisions in
    the spec truncate toward zero."""
    td = min(max(td, -128), 127)
    tb = min(max(tb, -128), 127)
    q = 16384 + (abs(td) >> 1)
    tx = q // td if td > 0 else -(q // -td)
    dsf = min(max((tb * tx + 32) >> 6, -4096), 4095)

    def one(v):
        s = dsf * v
        return min(max((1 if s >= 0 else -1) * ((abs(s) + 127) >> 8),
                       -32768), 32767)
    return one(mv[0]), one(mv[1])


def amvp_candidates_b(field: MvFieldB, list_idx: int, x0: int, y0: int,
                      size: int, w: int, h: int, log2_ctu: int,
                      poc_cur: int, poc_refs: tuple[int, int]
                      ) -> list[tuple[int, int]]:
    """AMVP for list LX in a B slice (8.5.3.2.6/8.5.3.2.7), refIdx 0.

    Cross-list candidates match only if the other list's reference is
    the same picture (never true here: L0/L1 differ), so the unscaled
    pass reduces to same-list neighbours; the scaled pass converts the
    other list's MV by POC distances."""
    n = size
    lx = list_idx
    ly = 1 - lx
    target_poc = poc_refs[lx]

    def info(nx, ny):
        if not z_available(nx, ny, x0, y0, w, h, log2_ctu):
            return None
        pf, m0, m1 = field.at(nx, ny)
        if not pf:
            return None
        return pf, (m0, m1)

    def unscaled(c):
        pf, mvs = c
        if pf & (1 << lx):
            return mvs[lx]          # same list, same ref (idx 0)
        return None                 # other list: different POC -> no match

    def scaled(c):
        pf, mvs = c
        for li in (lx, ly):
            if pf & (1 << li):
                tb = poc_cur - target_poc
                td = poc_cur - poc_refs[li]
                if td == tb:
                    return mvs[li]
                return _scale_mv(mvs[li], tb, td)
        return None

    a0 = info(x0 - 1, y0 + n)
    a1 = info(x0 - 1, y0 + n - 1)
    b0 = info(x0 + n, y0 - 1)
    b1 = info(x0 + n - 1, y0 - 1)
    b2 = info(x0 - 1, y0 - 1)

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
        # scaled B pass only when neither A neighbour exists (8.5.3.2.7)
        for c in (b0, b1, b2):
            if c is not None and mvp_b is None:
                mvp_b = scaled(c)

    cands: list = []
    if mvp_a is not None:
        cands.append(mvp_a)
    if mvp_b is not None and mvp_b != mvp_a:
        cands.append(mvp_b)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]
