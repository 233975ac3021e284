"""Window-gathered motion estimation: one gather per size per frame.

Counterpart of x265_tpu/ops/me_win.py. Per-block random access happens
in the window gather only (a hand-written CUDA kernel on the GPU,
csrc/gather_windows.cu); every integer candidate is then a static
slice of the window and every quarter-pel candidate is evaluated with
the extended 9-tap filter bank. Reference being recast: x265
source/encoder/motion.cpp StarPatternSearch + subpelRefine.

Layouts follow the reference: "lanes" tensors keep the block batch in
the last axis, (n, n, B).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .interp import CHROMA_FILTERS, LUMA_FILTERS
from .me import _mv_bits, bitlen
from .satd import sa8d_nxn_lanes


# =============================================================================
# the window gather (the one kernel of this path)
# =============================================================================

_GATHER_DTYPES = (torch.uint8, torch.uint16)


def _start(s: torch.Tensor, dim: int, w: int) -> torch.Tensor:
    return torch.clamp(torch.where(s < 0, s + dim, s), 0, dim - w)


def gather_windows_plain(src: torch.Tensor, ys: torch.Tensor,
                         xs: torch.Tensor, w: int) -> torch.Tensor:
    """(B, w, w) windows src[ys[b]:ys[b]+w, xs[b]:xs[b]+w] with
    jax.lax.dynamic_slice's start rule (a negative start counts from the
    far end, then starts clamp to [0, H-w] x [0, W-w]) — the plain
    PyTorch version of the CUDA kernel."""
    if src.dtype == torch.uint16:
        # advanced indexing lacks uint16 kernels: gather the same bits
        return gather_windows_plain(src.view(torch.int16), ys, xs, w) \
            .view(torch.uint16)
    h, ww = src.shape
    ar = torch.arange(w, device=src.device, dtype=torch.int32)
    y0 = _start(ys, h, w)
    x0 = _start(xs, ww, w)
    yy = (y0[:, None] + ar[None, :]).long()
    xx = (x0[:, None] + ar[None, :]).long()
    return src[yy[:, :, None], xx[:, None, :]]


def gather_windows(src: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   w: int) -> torch.Tensor:
    """(B, w, w) windows of the uint8/uint16 plane `src` with top-left
    (ys, xs), starts resolved as gather_windows_plain says. A CUDA tensor goes through
    the kernel (csrc/gather_windows.cu, counted in
    gather_windows.launches); a CPU tensor through the plain version."""
    if src.dim() != 2 or src.dtype not in _GATHER_DTYPES:
        raise ValueError(f"src must be a 2-D uint8/uint16 plane, got "
                         f"{src.dtype} {tuple(src.shape)}")
    if ys.dim() != 1 or ys.shape != xs.shape or \
            ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise ValueError("ys/xs must be equal-length 1-D int32 tensors")
    if ys.device != src.device or xs.device != src.device:
        raise ValueError("src, ys and xs must be on one device")
    h, ww = src.shape
    if not 0 < w <= min(h, ww):
        raise ValueError(f"window {w} does not fit the {h}x{ww} plane")
    if src.device.type == "cpu":
        return gather_windows_plain(src, ys, xs, w)
    if src.device.type != "cuda":
        raise ValueError(f"no gather_windows for device {src.device}")
    if not (src.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("gather_windows needs contiguous tensors")
    b = ys.shape[0]
    out = torch.empty((b, w, w), dtype=src.dtype, device=src.device)
    fn = _gather_fns()[src.dtype]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = fn(src.data_ptr(), h, ww, ys.data_ptr(), xs.data_ptr(), b, w,
             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather_windows launch failed: CUDA error {err}")
    gather_windows.launches += 1
    return out


gather_windows.launches = 0


@lru_cache(maxsize=None)
def _gather_fns():
    from ..kernels import load
    lib = load("gather_windows")
    fns = {}
    for dt, name in ((torch.uint8, "gather_windows_u8"),
                     (torch.uint16, "gather_windows_u16")):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fns[dt] = fn
    return fns


def gather_windows_ds(ref_pad: torch.Tensor, pad: int, y0s: torch.Tensor,
                      x0s: torch.Tensor, w: int) -> torch.Tensor:
    """Window gather from a plane EDGE-PADDED by `pad`, (y0s, x0s) in
    unpadded coordinates (the reference's gather_windows_ds)."""
    return gather_windows(ref_pad, (y0s + pad).to(torch.int32).contiguous(),
                          (x0s + pad).to(torch.int32).contiguous(), w)


def pad_ref(ref: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-pad a reference plane for the window gathers."""
    h, w = ref.shape
    yi = torch.clamp(torch.arange(-pad, h + pad, device=ref.device), 0,
                     h - 1)
    xi = torch.clamp(torch.arange(-pad, w + pad, device=ref.device), 0,
                     w - 1)
    return ref[yi[:, None], xi[None, :]].contiguous()


# =============================================================================
# sub-pel interpolation on windows
# =============================================================================

def _ext_bank9() -> np.ndarray:
    """9-tap extended luma filter bank for quarter-pel offsets d in
    [-3, 3]: d = 4*a + p, the 8-tap phase-p filter placed at taps
    t = a-3 .. a+4 inside a fixed t in [-4, 4] support."""
    bank = np.zeros((7, 9), np.int32)
    for i, d in enumerate(range(-3, 4)):
        p = d & 3
        a = d >> 2
        for k in range(8):
            bank[i, a - 3 + k + 4] = LUMA_FILTERS[p][k]
    return bank


@lru_cache(maxsize=None)
def _bank(name: str, device: torch.device) -> torch.Tensor:
    arr = _ext_bank9() if name == "ext9" else CHROMA_FILTERS
    return torch.as_tensor(arr, dtype=torch.int32, device=device)


def _round_clip(acc: torch.Tensor, bit_depth: int) -> torch.Tensor:
    total_shift = 12 - (bit_depth - 8)
    out = (acc + (1 << (total_shift - 1))) >> total_shift
    return torch.clamp(out, 0, (1 << bit_depth) - 1)


def interp_ext_lanes(win_t: torch.Tensor, dxi: torch.Tensor,
                     dyi: torch.Tensor, n: int, bit_depth: int = 8,
                     raw: bool = False) -> torch.Tensor:
    """(n, n, B) predictions from (S, S, B) sub-pel windows; dxi/dyi
    (B,) index the 9-tap extended bank (quarter-pel offset + 3).
    raw=True returns the pre-rounding two-stage accumulator."""
    bank = _bank("ext9", win_t.device)
    hf = bank[dxi]                               # (B, 9)
    vf = bank[dyi]
    shift1 = bit_depth - 8
    s, _, b = win_t.shape
    tmp = torch.zeros((s, n, b), dtype=torch.int32, device=win_t.device)
    for t in range(9):
        tmp.addcmul_(win_t[:, t:t + n, :], hf[None, None, :, t])
    if shift1:
        tmp = tmp >> shift1
    out = torch.zeros((n, n, b), dtype=torch.int32, device=win_t.device)
    for t in range(9):
        out.addcmul_(tmp[t:t + n, :, :], vf[None, None, :, t])
    return out if raw else _round_clip(out, bit_depth)


def interp_ext_lanes_multi(win_t: torch.Tensor, dxi: torch.Tensor,
                           dyi: torch.Tensor, n: int, bit_depth: int = 8,
                           raw: bool = False) -> torch.Tensor:
    """interp_ext_lanes over a candidate axis: dxi/dyi (K, B), one
    shared (S, S, B) window. Returns (K, n, n, B)."""
    bank = _bank("ext9", win_t.device)
    hf = bank[dxi]                               # (K, B, 9)
    vf = bank[dyi]
    shift1 = bit_depth - 8
    s = win_t.shape[0]
    k, b = dxi.shape
    tmp = torch.zeros((k, s, n, b), dtype=torch.int32, device=win_t.device)
    for t in range(9):
        tmp.addcmul_(win_t[None, :, t:t + n, :], hf[:, None, None, :, t])
    if shift1:
        tmp = tmp >> shift1
    out = torch.zeros((k, n, n, b), dtype=torch.int32, device=win_t.device)
    for t in range(9):
        out.addcmul_(tmp[:, t:t + n, :, :], vf[:, None, None, :, t])
    return out if raw else _round_clip(out, bit_depth)


def apply_weight_acc(raw: torch.Tensor, w, o, denom: int,
                     bit_depth: int = 8) -> torch.Tensor:
    """Explicit weighted sample prediction, uni case (clause
    8.5.4.2.3.3), from the two-stage interpolation accumulator."""
    log2wd = denom + 14 - bit_depth
    i = raw >> 6
    v = ((w * i + (1 << (log2wd - 1))) >> log2wd) + (o << (bit_depth - 8))
    return torch.clamp(v, 0, (1 << bit_depth) - 1)


def apply_weight_fullpel(s: torch.Tensor, w, o, denom: int,
                         bit_depth: int = 8) -> torch.Tensor:
    """Weighted prediction of full-pel samples."""
    v = ((w * s + (1 << (denom - 1))) >> denom) + (o << (bit_depth - 8))
    return torch.clamp(v, 0, (1 << bit_depth) - 1)


def inverse_weight_plane(cur: torch.Tensor, w, o, denom: int,
                         bit_depth: int = 8) -> torch.Tensor:
    """Weight-compensate the current frame for the integer search:
    cur' = (cur - o) * 2^denom / w, rounded half away from zero."""
    num = (cur - (o << (bit_depth - 8))) << denom
    w_safe = torch.clamp(w, min=1)
    half = w_safe >> 1
    v = torch.div(num + torch.where(num >= 0, half, -half), w_safe,
                  rounding_mode="floor")
    return torch.clamp(v, 0, (1 << bit_depth) - 1)


def sa8d_multi(diff: torch.Tensor, n: int) -> torch.Tensor:
    """SA8D over (K, n, n, B) candidate diffs -> (K, B)."""
    k, _, _, b = diff.shape
    lanes = diff.permute(1, 2, 0, 3).reshape(n, n, k * b)
    return sa8d_nxn_lanes(lanes, n).reshape(k, b)


# =============================================================================
# integer full search
# =============================================================================

def _argmin_first(c: torch.Tensor):
    """(min, first index of the min) over axis 0."""
    return torch.amin(c, 0), torch.argmin(c, 0).to(torch.int32)


def _row_sads(win16: torch.Tensor, cur16: torch.Tensor, y0: int, x0: int,
              n: int, side: int) -> torch.Tensor:
    """SADs of the `side` integer candidates of one dy row, (side, B)
    int32: sad[dx, b] = sum_ij |cur16[i, j, b] - win16[y0+i, x0+dx+j, b]|.
    The candidates are a strided view of the window (no copy); the
    abs-diffs land in a contiguous (n, n, side, B) int16 buffer so the
    sum reduces leading axes."""
    b = win16.shape[-1]
    row = win16[y0:y0 + n, x0:x0 + side + n - 1]         # (n, side+n-1, B)
    cands = row.unfold(1, n, 1).permute(0, 3, 1, 2)      # (n, n, side, B)
    ad = torch.empty((n, n, side, b), dtype=torch.int16, device=win16.device)
    torch.sub(cur16[:, :, None, :], cands, out=ad)
    return ad.abs_().sum((0, 1), dtype=torch.int32)


def int_search_vec(win_t: torch.Tensor, cur_t: torch.Tensor,
                   penx: torch.Tensor, peny: torch.Tensor, n: int,
                   side: int, lead: int = 4):
    """Integer full search over side x side candidates in ascending
    (dy, dx) raster order, strict < (first minimum wins). win_t
    (S, S, B) window, cur_t (n, n, B) int32, penx/peny (side, B) MV-bit
    penalties. Returns (best_cost (B,), best_i (B,)), i = dy*side + dx.
    The abs-diff runs in int16 with int32 sums."""
    b = cur_t.shape[-1]
    cur16 = cur_t.to(torch.int16)
    win16 = win_t.to(torch.int16)
    best_cost = torch.full((b,), 1 << 30, dtype=torch.int32,
                           device=cur_t.device)
    best_i = torch.zeros((b,), dtype=torch.int32, device=cur_t.device)
    for dy in range(side):
        sad = _row_sads(win16, cur16, lead + dy, lead, n, side)
        mc, mi = _argmin_first(sad + penx + peny[dy:dy + 1])
        better = mc < best_cost
        best_i = torch.where(better, dy * side + mi, best_i)
        best_cost = torch.where(better, mc, best_cost)
    return best_cost, best_i


def int_search_vec_pair(win8_t: torch.Tensor, cur8_t: torch.Tensor,
                        penx8: torch.Tensor, peny8: torch.Tensor,
                        penx16: torch.Tensor, peny16: torch.Tensor,
                        by8: int, bx8: int, side: int, lead: int = 4):
    """Joint integer search for the 8-blocks AND their parent 16-blocks
    from the 8-windows alone: the 16-block SAD at an offset is the sum
    of its four 8-block SADs there (same seed, same window). Loops over
    dy like the reference, so one step holds (side, 8, 8, B8) int16.
    Returns ((cost8, i8), (cost16, i16))."""
    b8 = cur8_t.shape[-1]
    by16, bx16 = by8 // 2, bx8 // 2
    b16 = by16 * bx16
    dev = cur8_t.device
    cur16 = cur8_t.to(torch.int16)
    win16 = win8_t.to(torch.int16)
    bc8 = torch.full((b8,), 1 << 30, dtype=torch.int32, device=dev)
    bi8 = torch.zeros((b8,), dtype=torch.int32, device=dev)
    bc16 = torch.full((b16,), 1 << 30, dtype=torch.int32, device=dev)
    bi16 = torch.zeros((b16,), dtype=torch.int32, device=dev)
    for dy in range(side):
        sad8 = _row_sads(win16, cur16, lead + dy, lead, 8, side)
        mc, mi = _argmin_first(sad8 + penx8 + peny8[dy:dy + 1])
        better = mc < bc8
        bi8 = torch.where(better, dy * side + mi, bi8)
        bc8 = torch.where(better, mc, bc8)
        sad16 = sad8.reshape(side, by16, 2, bx16, 2) \
            .sum((2, 4), dtype=torch.int32).reshape(side, b16)
        mc, mi = _argmin_first(sad16 + penx16 + peny16[dy:dy + 1])
        better = mc < bc16
        bi16 = torch.where(better, dy * side + mi, bi16)
        bc16 = torch.where(better, mc, bc16)
    return (bc8, bi8), (bc16, bi16)


def select_window_lanes(win_t: torch.Tensor, offy: torch.Tensor,
                        offx: torch.Tensor, out: int,
                        nshift: int) -> torch.Tensor:
    """(out, out, B) int32 sub-windows of (S, S, B) windows at per-block
    offsets offy/offx (B,) in [0, nshift). The reference selects with
    one-hot masked sums (gathers serialize on a TPU); a GPU indexes
    directly, with the same result."""
    s, _, b = win_t.shape
    dev = win_t.device
    ar = torch.arange(out, device=dev)
    rows = (offy.long()[None, :] + ar[:, None])           # (out, B)
    cols = (offx.long()[None, :] + ar[:, None])
    bi = torch.arange(b, device=dev)
    return win_t[rows[:, None, :], cols[None, :, :], bi[None, None, :]] \
        .to(torch.int32)


def _clip(a: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """jnp.clip with tensor bounds: min(max(a, lo), hi)."""
    return torch.minimum(torch.maximum(a, lo), hi)


def _take_k(a: torch.Tensor, mi: torch.Tensor) -> torch.Tensor:
    """a[mi[b], ..., b] for a (K, ..., B) candidate stack."""
    idx = mi.long().reshape((1,) + (1,) * (a.dim() - 2) + (-1,)) \
        .expand((1,) + tuple(a.shape[1:]))
    return torch.gather(a, 0, idx)[0]


# =============================================================================
# whole-frame ME with SHARED per-16-region windows
# =============================================================================

def me_all_sizes(cur: torch.Tensor, ref_pad: torch.Tensor,
                 cmv16: torch.Tensor, lam: int, *, radius: int = 6,
                 pad: int, bit_depth: int = 8, sizes=(8, 16, 32),
                 cur_search: torch.Tensor | None = None,
                 wvec: torch.Tensor | None = None,
                 weight_denom: int = 6):
    """Dense single-reference ME for every block of every size with two
    plane gathers per frame: one window per 16x16 region at its coarse
    seed (shared by the n=16 search and the four n=8 searches inside
    it) and one window per 32x32 block.

    cur: (H, W) int32 (multiples of 32); ref_pad: uint8 reference
    edge-padded by `pad` >= 2*radius + 8; cmv16: (H//16, W//16, 2)
    full-pel coarse seeds; wvec: (6,) int32 explicit weights (weightp).
    Returns ({n: (mv_qpel (B,2), cost (B,), pred (B,n,n))},
    {16: (sx, sy), 32: (sx, sy)} clamped per-region seeds)."""
    h, w = cur.shape
    dev = cur.device
    r = radius
    side = 2 * r + 1
    weighted = wvec is not None
    if weighted and cur_search is None:
        cur_search = inverse_weight_plane(cur.to(torch.int32), wvec[0],
                                          wvec[1], weight_denom, bit_depth)
    if cur_search is None:
        cur_search = cur

    def lanes_of(plane, n):
        bby, bbx = h // n, w // n
        return plane.reshape(bby, n, bbx, n).permute(1, 3, 0, 2) \
            .reshape(n, n, bby * bbx).to(torch.int32)

    def grid(n):
        by, bx = h // n, w // n
        ys = torch.arange(by, dtype=torch.int32, device=dev) * n
        xs = torch.arange(bx, dtype=torch.int32, device=dev) * n
        return ys.repeat_interleave(bx), xs.repeat(by)

    def up2(a, by, bx):
        return a.reshape(by, bx).repeat_interleave(2, 0) \
            .repeat_interleave(2, 1).reshape(-1)

    by16, bx16 = h // 16, w // 16
    y16, x16 = grid(16)
    # clamp seeds so the padded window slice stays in range
    sx16 = _clip(cmv16[..., 0].reshape(-1), -(x16 + r + 4),
                 (w - 16) - x16 + r + 4)
    sy16 = _clip(cmv16[..., 1].reshape(-1), -(y16 + r + 4),
                 (h - 16) - y16 + r + 4)
    wlen16 = 16 + 2 * r + 8
    w16 = gather_windows_ds(ref_pad, pad, y16 + sy16 - (r + 4),
                            x16 + sx16 - (r + 4), wlen16)

    offs = torch.arange(side, dtype=torch.int32, device=dev) - r

    def pens_of(seedx, seedy):
        def comp_bits(v):
            return 2 * bitlen(torch.abs(v)) + 1
        return (lam * comp_bits((seedx[None, :] + offs[:, None]) * 4),
                lam * comp_bits((seedy[None, :] + offs[:, None]) * 4))

    if weighted:
        def wround(acc):
            return apply_weight_acc(acc, wvec[0], wvec[1], weight_denom,
                                    bit_depth)
    else:
        def wround(acc):
            return _round_clip(acc, bit_depth)

    noff = torch.tensor([(1, 0), (-1, 0), (0, 1), (0, -1),
                         (1, 1), (1, -1), (-1, 1), (-1, -1)],
                        dtype=torch.int32, device=dev)

    def run_size(win_t, cur_t, cur_st, seedx, seedy, n, int_best=None):
        """win_t: (n+2r+8, n+2r+8, B) windows at seed-(r+4); cur_st is
        the (possibly weight-compensated) search current, cur_t the
        true current. Returns (mv_qpel, cost, pred (n, n, B))."""
        b = cur_t.shape[-1]
        if int_best is None:
            penx, peny = pens_of(seedx, seedy)
            _, best_i = int_search_vec(win_t, cur_st, penx, peny, n, side,
                                       lead=4)
        else:
            _, best_i = int_best
        oy_i = torch.div(best_i, side, rounding_mode="floor")
        ox_i = best_i - oy_i * side
        mvx_i = seedx + ox_i - r
        mvy_i = seedy + oy_i - r

        # sub-pel window at the best integer position
        swin_t = select_window_lanes(win_t, oy_i, ox_i, n + 8, side)

        dx = torch.zeros((b,), dtype=torch.int32, device=dev)
        dy = torch.zeros((b,), dtype=torch.int32, device=dev)
        pred = wround(interp_ext_lanes(swin_t, dx + 3, dy + 3, n,
                                       bit_depth, raw=True))
        scost = sa8d_nxn_lanes(cur_t - pred, n) + \
            lam * _mv_bits(mvx_i * 4, mvy_i * 4)
        best_pred = pred
        for step in (2, 1):
            # one diamond round: the 8 neighbours of the current best
            cx = torch.clamp(dx[None, :] + noff[:, 0:1] * step, -3, 3)
            cy = torch.clamp(dy[None, :] + noff[:, 1:2] * step, -3, 3)
            rnd = wround(interp_ext_lanes_multi(swin_t, cx + 3, cy + 3, n,
                                                bit_depth, raw=True))
            c = sa8d_multi(cur_t[None] - rnd, n) + \
                lam * _mv_bits(mvx_i[None] * 4 + cx, mvy_i[None] * 4 + cy)
            mc, mi = _argmin_first(c)
            better = mc < scost
            scost = torch.where(better, mc, scost)
            dx = torch.where(better, _take_k(cx, mi), dx)
            dy = torch.where(better, _take_k(cy, mi), dy)
            best_pred = torch.where(better[None, None, :], _take_k(rnd, mi),
                                    best_pred)
        mvqx = mvx_i * 4 + dx
        mvqy = mvy_i * 4 + dy

        # merge-candidate pass: the left/top neighbours' refined MVs,
        # evaluated from the same window when in range, cost ~2 bits
        by, bx = h // n, w // n
        for axis in (1, 0):                    # left, top neighbours
            cqx = torch.roll(mvqx.reshape(by, bx), 1, dims=axis) \
                .reshape(-1)
            cqy = torch.roll(mvqy.reshape(by, bx), 1, dims=axis) \
                .reshape(-1)
            edge_ok = torch.ones((by, bx), dtype=torch.bool, device=dev)
            if axis == 1:
                edge_ok[:, 0] = False
            else:
                edge_ok[0, :] = False
            offx2 = (cqx >> 2) - (seedx - r)
            offy2 = (cqy >> 2) - (seedy - r)
            valid = edge_ok.reshape(-1) & \
                (offx2 >= 0) & (offx2 <= 2 * r) & \
                (offy2 >= 0) & (offy2 <= 2 * r) & \
                ~((cqx == mvqx) & (cqy == mvqy))
            swc = select_window_lanes(win_t, torch.clamp(offy2, 0, 2 * r),
                                      torch.clamp(offx2, 0, 2 * r),
                                      n + 8, side)
            p = wround(interp_ext_lanes(swc, (cqx & 3) + 3, (cqy & 3) + 3,
                                        n, bit_depth, raw=True))
            c = sa8d_nxn_lanes(cur_t - p, n) + lam * 2
            c = torch.where(valid, c, 1 << 30)
            better = c < scost
            scost = torch.where(better, c, scost)
            mvqx = torch.where(better, cqx, mvqx)
            mvqy = torch.where(better, cqy, mvqy)
            best_pred = torch.where(better[None, None, :], p, best_pred)

        # dense zero-MV candidate (SATD level, no gather)
        zero_t = lanes_of(ref_pad[pad:pad + h, pad:pad + w], n)
        if weighted:
            zero_t = apply_weight_fullpel(zero_t, wvec[0], wvec[1],
                                          weight_denom, bit_depth)
        zcost = sa8d_nxn_lanes(cur_t - zero_t, n) + lam * 2
        zwin = zcost < scost
        scost = torch.where(zwin, zcost, scost)
        mvqx = torch.where(zwin, 0, mvqx)
        mvqy = torch.where(zwin, 0, mvqy)
        best_pred = torch.where(zwin[None, None, :], zero_t, best_pred)
        return (torch.stack([mvqx, mvqy], dim=1), scost,
                best_pred.permute(2, 0, 1))

    out = {}
    int16_best = int8_best = None
    if 8 in sizes:
        by8, bx8 = h // 8, w // 8
        b8 = by8 * bx8
        # the four 8-blocks' (8+2r+8)^2 windows are static slices of the
        # parent 16-region window (same seed), assembled in raster order
        w16r = w16.reshape(by16, bx16, wlen16, wlen16)
        wlen8 = 8 + 2 * r + 8
        subs = [torch.stack([w16r[:, :, 8 * jj:8 * jj + wlen8,
                                  8 * ii:8 * ii + wlen8]
                             for ii in (0, 1)], dim=2) for jj in (0, 1)]
        w8 = torch.stack(subs, dim=1).reshape(b8, wlen8, wlen8)
        w8_t = w8.permute(1, 2, 0)
        cur8 = lanes_of(cur, 8)
        cur8s = cur8 if cur_search is cur else lanes_of(cur_search, 8)
        sx8 = up2(sx16, by16, bx16)
        sy8 = up2(sy16, by16, bx16)
        if 16 in sizes:
            # one pass over pixels serves both grids
            penx8, peny8 = pens_of(sx8, sy8)
            penx16, peny16 = pens_of(sx16, sy16)
            int8_best, int16_best = int_search_vec_pair(
                w8_t, cur8s, penx8, peny8, penx16, peny16, by8, bx8,
                side, lead=4)
        out[8] = run_size(w8_t, cur8, cur8s, sx8, sy8, 8,
                          int_best=int8_best)

    if 16 in sizes:
        cur16 = lanes_of(cur, 16)
        cur16s = cur16 if cur_search is cur else lanes_of(cur_search, 16)
        out[16] = run_size(w16.permute(1, 2, 0), cur16, cur16s, sx16,
                           sy16, 16, int_best=int16_best)

    seeds32 = None
    if 32 in sizes:
        y32, x32 = grid(32)
        # seed: the coarse MV at the 32-block centre
        s32 = cmv16.reshape(by16, bx16, 2)[1::2, 1::2].reshape(-1, 2)
        sx32 = _clip(s32[:, 0], -(x32 + r + 4), (w - 32) - x32 + r + 4)
        sy32 = _clip(s32[:, 1], -(y32 + r + 4), (h - 32) - y32 + r + 4)
        wlen32 = 32 + 2 * r + 8
        w32 = gather_windows_ds(ref_pad, pad, y32 + sy32 - (r + 4),
                                x32 + sx32 - (r + 4), wlen32)
        cur32 = lanes_of(cur, 32)
        cur32s = cur32 if cur_search is cur else lanes_of(cur_search, 32)
        out[32] = run_size(w32.permute(1, 2, 0), cur32, cur32s, sx32,
                           sy32, 32)
        seeds32 = (sx32, sy32)

    return out, {16: (sx16, sy16), 32: seeds32}


# =============================================================================
# windowed chroma MC (shared per-16-region windows)
# =============================================================================

def interp_chroma_lanes(patch_t: torch.Tensor, fx: torch.Tensor,
                        fy: torch.Tensor, cn: int, bit_depth: int = 8,
                        raw: bool = False) -> torch.Tensor:
    """4-tap chroma interpolation, lanes-last: patch_t (cn+3, cn+3, B)
    starting one sample above/left of the integer position; fx/fy (B,)
    eighth-pel fractions in [0, 8)."""
    bank = _bank("chroma", patch_t.device)
    hf = bank[fx]                                # (B, 4)
    vf = bank[fy]
    shift1 = bit_depth - 8
    s, _, b = patch_t.shape
    tmp = torch.zeros((s, cn, b), dtype=torch.int32, device=patch_t.device)
    for t in range(4):
        tmp.addcmul_(patch_t[:, t:t + cn, :], hf[None, None, :, t])
    if shift1:
        tmp = tmp >> shift1
    out = torch.zeros((cn, cn, b), dtype=torch.int32, device=patch_t.device)
    for t in range(4):
        out.addcmul_(tmp[t:t + cn, :, :], vf[None, None, :, t])
    return out if raw else _round_clip(out, bit_depth)


def seed_floor_off(seed: torch.Tensor, radius: int) -> torch.Tensor:
    """Lowest chroma patch origin (relative to the block's chroma
    position) reachable by a luma MV in [4*(seed-r)-3, 4*(seed+r)+3]
    qpel: s0 = ((4*(seed-r) - 3) >> 3) - 1 (the -1 is the 4-tap lead)."""
    return ((4 * (seed - radius) - 3) >> 3) - 1


def gather_chroma_windows(cpad2: torch.Tensor, pc: int,
                          reg_cy: torch.Tensor, reg_cx: torch.Tensor,
                          s0y: torch.Tensor, s0x: torch.Tensor,
                          wc: int) -> torch.Tensor:
    """(Breg, 2, wc, wc) stacked cb/cr windows with origin (reg + s0)
    in unpadded chroma coordinates. cpad2 (2, Hc', Wc') is viewed as
    one (2*Hc', Wc') plane of rows; the second half of the batch reads
    the cr rows. Rows are clamped per component first, as the
    reference's per-plane dynamic_slice does."""
    b = reg_cy.shape[0]
    hc = cpad2.shape[1]
    ys = _start(reg_cy + s0y + pc, hc, wc)
    xs = reg_cx + s0x + pc
    flat = cpad2.reshape(2 * hc, cpad2.shape[2])
    win = gather_windows(flat, torch.cat([ys, ys + hc]).to(torch.int32),
                         torch.cat([xs, xs]).to(torch.int32), wc)
    return torch.stack([win[:b], win[b:]], dim=1)


def chroma_mc_from_windows(win_b: torch.Tensor, offy: torch.Tensor,
                           offx: torch.Tensor, fx: torch.Tensor,
                           fy: torch.Tensor, cn: int, nshift: int,
                           bit_depth: int = 8, raw: bool = False):
    """Chroma MC from per-BLOCK windows win_b (B, 2, wc, wc); patch
    offsets offy/offx (B,) in [0, nshift); eighth-pel fractions fx/fy.
    Returns ((B, cn, cn) cb, (B, cn, cn) cr)."""
    outs = []
    for plane in range(2):
        wt = win_b[:, plane].permute(1, 2, 0)
        patch = select_window_lanes(wt, offy, offx, cn + 3, nshift)
        outs.append(interp_chroma_lanes(patch, fx, fy, cn, bit_depth,
                                        raw=raw).permute(2, 0, 1))
    return outs[0], outs[1]
