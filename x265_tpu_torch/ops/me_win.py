"""Window-gathered motion estimation: one gather per size per frame.

Counterpart of x265_tpu/ops/me_win.py. Per-block random access happens
in the window gather only (a hand-written CUDA kernel on the GPU,
csrc/gather_windows.cu); every integer candidate is then a static
slice of the window, searched on the GPU by a second hand-written
kernel (csrc/int_search.cu), and every quarter-pel candidate is
evaluated with the extended 9-tap filter bank. Reference being recast: x265
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
# the window gather (csrc/gather_windows.cu)
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
    (ys, xs), starts resolved as gather_windows_plain says. A CUDA
    tensor goes through the kernel (csrc/gather_windows.cu, counted in
    gather_windows.launches, and a uint16 plane also in
    gather_windows.launches_u16); a CPU tensor through the plain
    version."""
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
    gather_windows.launches_u16 += src.dtype == torch.uint16
    return out


# launches of either instance, and of the uint16 (10-bit) one alone
gather_windows.launches = 0
gather_windows.launches_u16 = 0


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
    if ref.dtype == torch.uint16:
        # advanced indexing lacks uint16 kernels: pad the same bits
        return pad_ref(ref.view(torch.int16), pad).view(torch.uint16)
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


def lanes_of(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n, B) int32 lanes of the n-blocks of an (H, W) plane, blocks
    in raster order."""
    h, w = plane.shape
    by, bx = h // n, w // n
    return plane.reshape(by, n, bx, n).permute(1, 3, 0, 2) \
        .reshape(n, n, by * bx).to(torch.int32)


def sub8_windows(w16: torch.Tensor, by16: int, bx16: int) -> torch.Tensor:
    """(B8, S-8, S-8) 8-block windows cut from the (B16, S, S) windows of
    their 16-regions (same seed) at (8 jj, 8 ii), in the raster order of
    the 8-grid."""
    s = w16.shape[-1]
    w16r = w16.reshape(by16, bx16, s, s)
    subs = [torch.stack([w16r[:, :, 8 * jj:8 * jj + s - 8,
                              8 * ii:8 * ii + s - 8]
                         for ii in (0, 1)], dim=2) for jj in (0, 1)]
    return torch.stack(subs, dim=1).reshape(4 * by16 * bx16, s - 8, s - 8)


def _check_search(name, win, cur_plane, n, pens, side, lead):
    """Argument checks shared by the two search wrappers; pens is a list
    of ((side, B) penalty tensor, B)."""
    if win.dtype not in _GATHER_DTYPES or win.dim() != 3 or \
            win.shape[1] != win.shape[2]:
        raise ValueError(f"{name}: windows must be (B, S, S) uint8 or "
                         f"uint16, got {win.dtype} {tuple(win.shape)}")
    if cur_plane.dtype != torch.int32 or cur_plane.dim() != 2:
        raise ValueError(f"{name}: the current plane must be 2-D int32")
    if not (0 <= lead and side >= 1 and
            lead + side + n - 1 <= win.shape[1]):
        raise ValueError(f"{name}: {side}^2 candidates of {n}-blocks at "
                         f"lead {lead} do not fit a {win.shape[1]} window")
    for p, b in pens:
        if p.dtype != torch.int32 or tuple(p.shape) != (side, b):
            raise ValueError(f"{name}: penalties must be ({side}, {b}) "
                             f"int32, got {p.dtype} {tuple(p.shape)}")
    if any(t.device != win.device for t in (cur_plane, *(p for p, _ in pens))):
        raise ValueError(f"{name}: all tensors must be on one device")
    if win.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {win.device}")
    tensors = (win, cur_plane, *(p for p, _ in pens))
    if win.device.type == "cuda" and \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel needs contiguous tensors")


def int_search_pair_windows_plain(w16, cur_plane, penx8, peny8, penx16,
                                  peny16, by16: int, bx16: int, side: int,
                                  lead: int = 4):
    """Plain PyTorch version of int_search_pair_windows: the lanes
    tensors of the 8-blocks and int_search_vec_pair."""
    w8_t = sub8_windows(w16, by16, bx16).permute(1, 2, 0)
    return int_search_vec_pair(w8_t, lanes_of(cur_plane, 8), penx8, peny8,
                               penx16, peny16, 2 * by16, 2 * bx16, side,
                               lead)


def int_search_pair_windows(w16, cur_plane, penx8, peny8, penx16, peny16,
                            by16: int, bx16: int, side: int, lead: int = 4):
    """Joint integer full search of the 16-regions and their four
    8-blocks over the (B16, S, S) uint8 (8-bit) or uint16 (10-bit)
    region windows w16 (raster order of a by16 x bx16 grid, gathered at
    seed - (radius + lead)), against the (16 by16, 16 bx16) int32
    current plane (samples of the windows' bit depth: the uint16 kernel's
    packed sums are exact for samples below 2^10).
    penx8/peny8 (side, 4 B16) and penx16/peny16 (side, B16) int32
    penalties. Returns ((cost8, i8), (cost16, i16)), int32, 8-blocks in
    the raster order of the 8-grid, i = dy*side + dx: the results of
    int_search_vec_pair. A CUDA tensor goes through the kernel
    (csrc/int_search.cu, counted in int_search_pair_windows.launches,
    uint16 windows also in .launches_u16); a CPU tensor through the
    plain version."""
    b16 = by16 * bx16
    _check_search("int_search_pair_windows", w16, cur_plane, 16,
                  [(penx8, 4 * b16), (peny8, 4 * b16), (penx16, b16),
                   (peny16, b16)], side, lead)
    if w16.shape[0] != b16 or tuple(cur_plane.shape) != (16 * by16,
                                                         16 * bx16):
        raise ValueError(f"int_search_pair_windows: {tuple(w16.shape)} "
                         f"windows and a {tuple(cur_plane.shape)} plane "
                         f"for a {by16}x{bx16} region grid")
    if w16.device.type == "cpu":
        return int_search_pair_windows_plain(w16, cur_plane, penx8, peny8,
                                             penx16, peny16, by16, bx16,
                                             side, lead)
    dev = w16.device
    c8, i8 = (torch.empty(4 * b16, dtype=torch.int32, device=dev)
              for _ in range(2))
    c16, i16 = (torch.empty(b16, dtype=torch.int32, device=dev)
                for _ in range(2))
    err = _search_fns()["pair", w16.dtype](
        w16.data_ptr(), b16, w16.shape[1], lead, side, cur_plane.data_ptr(),
        cur_plane.shape[1], bx16, penx8.data_ptr(), peny8.data_ptr(),
        penx16.data_ptr(), peny16.data_ptr(), c8.data_ptr(), i8.data_ptr(),
        c16.data_ptr(), i16.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int_search_pair_windows launch failed: CUDA "
                           f"error {err}")
    int_search_pair_windows.launches += 1
    int_search_pair_windows.launches_u16 += w16.dtype == torch.uint16
    return (c8, i8), (c16, i16)


int_search_pair_windows.launches = 0
int_search_pair_windows.launches_u16 = 0


def int_search_windows_plain(w, cur_plane, penx, peny, n: int, side: int,
                             lead: int = 4):
    """Plain PyTorch version of int_search_windows: int_search_vec on
    the lanes tensors."""
    return int_search_vec(w.permute(1, 2, 0), lanes_of(cur_plane, n), penx,
                          peny, n, side, lead)


def int_search_windows(w, cur_plane, penx, peny, n: int, side: int,
                       lead: int = 4):
    """Integer full search of the 32-blocks (n must be 32) over their
    (B, S, S) uint8 or uint16 windows w, raster order over the (H, W)
    int32 current plane (samples of the windows' bit depth: below 2^10
    for uint16 windows, as the kernel's packed sums need); penx/peny
    (side, B) int32 penalties.
    Returns (best_cost (B,), best_i (B,)), int32: the results of
    int_search_vec. A CUDA tensor goes through the kernel
    (csrc/int_search.cu, counted in int_search_windows.launches, uint16
    windows also in .launches_u16); a CPU tensor through the plain
    version."""
    if n != 32:
        raise ValueError(f"int_search_windows searches 32-blocks, got {n}")
    b = w.shape[0] if w.dim() == 3 else -1
    _check_search("int_search_windows", w, cur_plane, n,
                  [(penx, b), (peny, b)], side, lead)
    h, ww = cur_plane.shape
    if h % n or ww % n or b != (h // n) * (ww // n):
        raise ValueError(f"int_search_windows: {b} windows for a "
                         f"{h}x{ww} plane of {n}-blocks")
    if w.device.type == "cpu":
        return int_search_windows_plain(w, cur_plane, penx, peny, n, side,
                                        lead)
    dev = w.device
    cost, idx = (torch.empty(b, dtype=torch.int32, device=dev)
                 for _ in range(2))
    err = _search_fns()["single", w.dtype](
        w.data_ptr(), b, w.shape[1], lead, side, cur_plane.data_ptr(), ww,
        ww // n, penx.data_ptr(), peny.data_ptr(), cost.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int_search_windows launch failed: CUDA error "
                           f"{err}")
    int_search_windows.launches += 1
    int_search_windows.launches_u16 += w.dtype == torch.uint16
    return cost, idx


int_search_windows.launches = 0
int_search_windows.launches_u16 = 0


@lru_cache(maxsize=None)
def _search_fns():
    from ..kernels import load
    lib = load("int_search")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for dt, sfx in ((torch.uint8, "u8"), (torch.uint16, "u16")):
        pair = getattr(lib, f"int_search_pair_{sfx}")
        single = getattr(lib, f"int_search_{sfx}")
        pair.argtypes = [p, i, i, i, i, p, i, i, p, p, p, p, p, p, p, p, p]
        single.argtypes = [p, i, i, i, i, p, i, i, p, p, p, p, p]
        for fn in (pair, single):
            fn.restype = ctypes.c_int
        fns["pair", dt], fns["single", dt] = pair, single
    return fns


def select_window_lanes(win_t: torch.Tensor, offy: torch.Tensor,
                        offx: torch.Tensor, out: int,
                        nshift: int) -> torch.Tensor:
    """(out, out, B) int32 sub-windows of (S, S, B) windows at per-block
    offsets offy/offx (B,) in [0, nshift). The reference selects with
    one-hot masked sums (gathers serialize on a TPU); a GPU indexes
    directly, with the same result."""
    if win_t.dtype == torch.uint16:
        # advanced indexing lacks uint16 kernels: 10-bit samples are the
        # same numbers as int16
        win_t = win_t.view(torch.int16)
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


def search_plane(cur: torch.Tensor, cur_search: torch.Tensor, wm, k: int):
    """The current plane the integer search compares: cur_search (the
    weight-compensated current) inside the k x k blocks where wm (one
    bool per block, raster order) is set, the true current elsewhere.
    It gives the search kernels, which take one plane, the per-block
    current lanes the reference composes (jnp.where(wm, cur_s, cur)).
    wm None: cur_search everywhere."""
    if wm is None:
        return cur_search
    h, w = cur.shape
    m = wm.reshape(h // k, w // k).repeat_interleave(k, 0) \
        .repeat_interleave(k, 1)
    return torch.where(m, cur_search, cur).contiguous()


# =============================================================================
# whole-frame ME with SHARED per-16-region windows
# =============================================================================

def me_all_sizes(cur: torch.Tensor, ref_pad: torch.Tensor,
                 cmv16: torch.Tensor, lam: int, *, radius: int = 6,
                 pad: int, bit_depth: int = 8,
                 cur_search: torch.Tensor | None = None,
                 wvec: torch.Tensor | None = None,
                 weight_denom: int = 6, ref_stride: int = 0,
                 ref16: torch.Tensor | None = None,
                 ref32: torch.Tensor | None = None,
                 cmv32: torch.Tensor | None = None,
                 zero_planes: dict | None = None,
                 want_raw: bool = False):
    """Dense ME for every block of every size with two plane gathers per
    frame: one window per 16x16 region at its coarse seed (shared by the
    n=16 search and the four n=8 searches inside it) and one window per
    32x32 block.

    cur: (H, W) int32 (multiples of 32); ref_pad: uint8 (uint16 at 10
    bits) reference
    edge-padded by `pad` >= 2*radius + 8; cmv16: (H//16, W//16, 2)
    full-pel coarse seeds; wvec: (6,) int32 explicit weights (weightp).

    Multi-reference: ref_pad stacks the R padded references vertically,
    ref_stride = H + 2*pad rows apart; ref16/ref32 select each
    16-region's / 32-block's reference, cmv32 gives the 32-block seeds
    from that reference's coarse pass, and zero_planes[{16, 32}] the
    planes composed of the selected references for the zero-MV
    candidates. Weights apply to reference 0 only: elsewhere the
    predictions round as unweighted ones, and the search compares the
    true current instead of the weight-compensated one. The integer
    search takes one current plane, so that plane is composed per
    region: compensated where the region's reference is 0.

    want_raw (the B path, unweighted only): each size's tuple also
    holds the selected prediction's pre-rounding accumulator (B,n,n),
    a full-pel winner's as sample << (12 - (bit_depth - 8)).

    Returns ({n: (mv_qpel (B,2), cost (B,), pred (B,n,n)[, raw])},
    {16: (sx, sy), 32: (sx, sy)} clamped per-region seeds)."""
    h, w = cur.shape
    dev = cur.device
    r = radius
    side = 2 * r + 1
    weighted = wvec is not None
    assert not (weighted and want_raw), \
        "raw accumulators are the unweighted contract (B path)"
    if weighted and cur_search is None:
        cur_search = inverse_weight_plane(cur.to(torch.int32), wvec[0],
                                          wvec[1], weight_denom, bit_depth)
    if cur_search is None:
        cur_search = cur
    zp = zero_planes or {}

    def grid(n):
        by, bx = h // n, w // n
        ys = torch.arange(by, dtype=torch.int32, device=dev) * n
        xs = torch.arange(bx, dtype=torch.int32, device=dev) * n
        return ys.repeat_interleave(bx), xs.repeat(by)

    def up(a, by, bx, k):
        return a.reshape(by, bx).repeat_interleave(k, 0) \
            .repeat_interleave(k, 1)

    def row_off(sel):
        return 0 if sel is None else sel * ref_stride

    by16, bx16 = h // 16, w // 16
    y16, x16 = grid(16)
    # clamp seeds so the padded window slice stays in range
    sx16 = _clip(cmv16[..., 0].reshape(-1), -(x16 + r + 4),
                 (w - 16) - x16 + r + 4)
    sy16 = _clip(cmv16[..., 1].reshape(-1), -(y16 + r + 4),
                 (h - 16) - y16 + r + 4)
    wlen16 = 16 + 2 * r + 8
    w16 = gather_windows_ds(ref_pad, pad,
                            y16 + sy16 - (r + 4) + row_off(ref16),
                            x16 + sx16 - (r + 4), wlen16)

    offs = torch.arange(side, dtype=torch.int32, device=dev) - r

    def pens_of(seedx, seedy):
        def comp_bits(v):
            return 2 * bitlen(torch.abs(v)) + 1
        return (lam * comp_bits((seedx[None, :] + offs[:, None]) * 4),
                lam * comp_bits((seedy[None, :] + offs[:, None]) * 4))

    noff = torch.tensor([(1, 0), (-1, 0), (0, 1), (0, -1),
                         (1, 1), (1, -1), (-1, 1), (-1, -1)],
                        dtype=torch.int32, device=dev)

    def run_size(win_t, cur_t, seedx, seedy, n, int_best, zero_plane=None,
                 wmask=None):
        """win_t: (n+2r+8, n+2r+8, B) windows at seed-(r+4); cur_t the
        true current; int_best the integer search's (cost, index) over
        the search current; zero_plane the plane of the zero-MV
        candidates (None: the unpadded ref_pad); wmask (B,) bool, the
        weighted blocks when weights reach reference 0 only. Returns
        (mv_qpel, cost, pred (n, n, B))."""
        b = cur_t.shape[-1]
        _, best_i = int_best
        oy_i = torch.div(best_i, side, rounding_mode="floor")
        ox_i = best_i - oy_i * side
        mvx_i = seedx + ox_i - r
        mvy_i = seedy + oy_i - r

        def wround(acc):
            if not weighted:
                return _round_clip(acc, bit_depth)
            wv = apply_weight_acc(acc, wvec[0], wvec[1], weight_denom,
                                  bit_depth)
            return wv if wmask is None else torch.where(
                wmask[None, None, :], wv, _round_clip(acc, bit_depth))

        # sub-pel window at the best integer position
        swin_t = select_window_lanes(win_t, oy_i, ox_i, n + 8, side)

        dx = torch.zeros((b,), dtype=torch.int32, device=dev)
        dy = torch.zeros((b,), dtype=torch.int32, device=dev)
        best_raw = interp_ext_lanes(swin_t, dx + 3, dy + 3, n, bit_depth,
                                    raw=True)
        pred = wround(best_raw)
        scost = sa8d_nxn_lanes(cur_t - pred, n) + \
            lam * _mv_bits(mvx_i * 4, mvy_i * 4)
        best_pred = pred
        for step in (2, 1):
            # one diamond round: the 8 neighbours of the current best
            cx = torch.clamp(dx[None, :] + noff[:, 0:1] * step, -3, 3)
            cy = torch.clamp(dy[None, :] + noff[:, 1:2] * step, -3, 3)
            praw = interp_ext_lanes_multi(swin_t, cx + 3, cy + 3, n,
                                          bit_depth, raw=True)
            rnd = wround(praw)
            c = sa8d_multi(cur_t[None] - rnd, n) + \
                lam * _mv_bits(mvx_i[None] * 4 + cx, mvy_i[None] * 4 + cy)
            mc, mi = _argmin_first(c)
            better = mc < scost
            scost = torch.where(better, mc, scost)
            dx = torch.where(better, _take_k(cx, mi), dx)
            dy = torch.where(better, _take_k(cy, mi), dy)
            best_pred = torch.where(better[None, None, :], _take_k(rnd, mi),
                                    best_pred)
            if want_raw:
                best_raw = torch.where(better[None, None, :],
                                       _take_k(praw, mi), best_raw)
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
            praw = interp_ext_lanes(swc, (cqx & 3) + 3, (cqy & 3) + 3, n,
                                    bit_depth, raw=True)
            p = wround(praw)
            c = sa8d_nxn_lanes(cur_t - p, n) + lam * 2
            c = torch.where(valid, c, 1 << 30)
            better = c < scost
            scost = torch.where(better, c, scost)
            mvqx = torch.where(better, cqx, mvqx)
            mvqy = torch.where(better, cqy, mvqy)
            best_pred = torch.where(better[None, None, :], p, best_pred)
            if want_raw:
                best_raw = torch.where(better[None, None, :], praw, best_raw)

        # dense zero-MV candidate (SATD level, no gather)
        if zero_plane is None:
            zero_plane = ref_pad[pad:pad + h, pad:pad + w]
        zero_t = lanes_of(zero_plane, n)
        if weighted:
            zw = apply_weight_fullpel(zero_t, wvec[0], wvec[1],
                                      weight_denom, bit_depth)
            zero_t = zw if wmask is None else \
                torch.where(wmask[None, None, :], zw, zero_t)
        zcost = sa8d_nxn_lanes(cur_t - zero_t, n) + lam * 2
        zwin = zcost < scost
        scost = torch.where(zwin, zcost, scost)
        mvqx = torch.where(zwin, 0, mvqx)
        mvqy = torch.where(zwin, 0, mvqy)
        best_pred = torch.where(zwin[None, None, :], zero_t, best_pred)
        res = (torch.stack([mvqx, mvqy], dim=1), scost,
               best_pred.permute(2, 0, 1))
        if want_raw:
            # full-pel accumulator scale: sample << total_shift
            best_raw = torch.where(zwin[None, None, :],
                                   zero_t << (12 - (bit_depth - 8)), best_raw)
            res += (best_raw.permute(2, 0, 1),)
        return res

    # weights reach reference 0 only (multi-reference)
    wm16 = (ref16 == 0) if weighted and ref16 is not None else None
    wm32 = (ref32 == 0) if weighted and ref32 is not None else None
    wm8 = None if wm16 is None else up(wm16, by16, bx16, 2).reshape(-1)

    # the four 8-blocks' (8+2r+8)^2 windows are static slices of the
    # parent 16-region window (same seed), assembled in raster order
    w8 = sub8_windows(w16, by16, bx16)
    sx8 = up(sx16, by16, bx16, 2).reshape(-1)
    sy8 = up(sy16, by16, bx16, 2).reshape(-1)
    penx8, peny8 = pens_of(sx8, sy8)
    penx16, peny16 = pens_of(sx16, sy16)
    # one pass over pixels serves both grids
    int8_best, int16_best = int_search_pair_windows(
        w16, search_plane(cur, cur_search, wm16, 16), penx8, peny8, penx16,
        peny16, by16, bx16, side, lead=4)
    out = {8: run_size(w8.permute(1, 2, 0), lanes_of(cur, 8), sx8, sy8, 8,
                       int8_best, zp.get(16), wm8),
           16: run_size(w16.permute(1, 2, 0), lanes_of(cur, 16), sx16, sy16,
                        16, int16_best, zp.get(16), wm16)}

    y32, x32 = grid(32)
    # seed: the selected reference's coarse MV (multi-reference) or the
    # coarse MV at the 32-block centre
    s32 = cmv32.reshape(-1, 2) if cmv32 is not None else \
        cmv16.reshape(by16, bx16, 2)[1::2, 1::2].reshape(-1, 2)
    sx32 = _clip(s32[:, 0], -(x32 + r + 4), (w - 32) - x32 + r + 4)
    sy32 = _clip(s32[:, 1], -(y32 + r + 4), (h - 32) - y32 + r + 4)
    wlen32 = 32 + 2 * r + 8
    w32 = gather_windows_ds(ref_pad, pad,
                            y32 + sy32 - (r + 4) + row_off(ref32),
                            x32 + sx32 - (r + 4), wlen32)
    penx32, peny32 = pens_of(sx32, sy32)
    int32_best = int_search_windows(w32, search_plane(cur, cur_search, wm32,
                                                      32),
                                    penx32, peny32, 32, side, lead=4)
    out[32] = run_size(w32.permute(1, 2, 0), lanes_of(cur, 32), sx32, sy32,
                       32, int32_best, zp.get(32), wm32)
    return out, {16: (sx16, sy16), 32: (sx32, sy32)}


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
                          wc: int, row_off=0) -> torch.Tensor:
    """(Breg, 2, wc, wc) stacked cb/cr windows with origin (reg + s0)
    in unpadded chroma coordinates. cpad2 (2, Hc', Wc') is viewed as
    one (2*Hc', Wc') plane of rows; the second half of the batch reads
    the cr rows. row_off: per-region extra rows inside each component
    (multi-reference: ref * segment rows, when Hc' stacks R padded
    references). Rows are clamped over the whole component first, as
    the reference's per-plane dynamic_slice does."""
    b = reg_cy.shape[0]
    hc = cpad2.shape[1]
    ys = _start(reg_cy + s0y + pc + row_off, hc, wc)
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
