"""Build + ctypes binding for the native CABAC slice encoder (a copy of
the reference package's coder, entropy.cpp, carried with its binding).

The context layout header (ctx_offsets.h) is GENERATED from
ctx_tables.py at build time, so Python remains the single source of
truth; a checksum handshake asserts the loaded .so matches the current
layout. Built with g++ -O3 on first use into the package's build
directory (listed in .gitignore), named by a hash of the source and
header so parallel processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..bitstream.ctx_tables import OFF, NUM_CONTEXTS
from ..kernels import BUILD_DIR, PKG_DIR

_SRC = PKG_DIR / "native" / "entropy.cpp"

# groups the C++ code addresses by name
_CPP_GROUPS = [
    "split_cu_flag", "part_mode", "prev_intra_luma_pred_flag",
    "intra_chroma_pred_mode", "cbf_luma", "cbf_chroma", "last_sig_x",
    "last_sig_y", "coded_sub_block_flag", "sig_coeff_flag",
    "greater1_flag", "greater2_flag", "cu_skip_flag", "pred_mode_flag",
    "merge_flag", "merge_idx", "mvp_flag", "abs_mvd_greater_flag",
    "rqt_root_cbf", "sao_merge_flag", "sao_type_idx", "cu_qp_delta_abs",
    "inter_pred_idc", "cu_transquant_bypass", "split_transform_flag",
    "ref_idx",
]


def _layout_checksum() -> int:
    s = ",".join(f"{g}={OFF[g]}" for g in _CPP_GROUPS) + f";n={NUM_CONTEXTS}"
    return int(hashlib.sha256(s.encode()).hexdigest()[:7], 16)


def _gen_header() -> str:
    lines = ["// GENERATED by entropy_native.py from ctx_tables.py — do not edit"]
    for g in _CPP_GROUPS:
        lines.append(f"#define OFF_{g.upper()} {OFF[g]}")
    lines.append(f"#define CTX_LAYOUT_CHECKSUM {_layout_checksum()}")
    return "\n".join(lines) + "\n"


def _so_path():
    want = _gen_header()
    stamp = hashlib.sha256(_SRC.read_bytes() + want.encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"_entropy-{stamp}.so", BUILD_DIR / f"gen-{stamp}", \
        want


def _build():
    so, gen, want = _so_path()
    if so.exists():
        return so
    gen.mkdir(parents=True, exist_ok=True)
    hdr = gen / "ctx_offsets.h"
    tmp_h = gen / f"ctx_offsets.h.{os.getpid()}.tmp"
    tmp_h.write_text(want)
    os.replace(tmp_h, hdr)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-I", str(gen),
         "-o", str(tmp), str(_SRC)],
        check=True, capture_output=True)
    os.replace(tmp, so)
    return so


_lib = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        lib.encode_slice.restype = ctypes.c_int
        lib.encode_slice.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int)]
        lib.encode_slice_wpp.restype = ctypes.c_int
        lib.encode_slice_wpp.argtypes = lib.encode_slice.argtypes[:-2] + \
            [ctypes.c_void_p, ctypes.c_int]
        lib.encode_intra_slice.restype = ctypes.c_int
        lib.encode_intra_slice.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int)]
        lib.expand_cgs.restype = None
        lib.expand_cgs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ctx_layout_checksum.restype = ctypes.c_int
        assert lib.ctx_layout_checksum() == _layout_checksum(), \
            "native context layout out of sync — rebuild failed?"
        _lib = lib
    return _lib


def expand_cgs_native(vals: np.ndarray, idx: np.ndarray, in_ncx: int,
                      out_h: int, out_w: int) -> np.ndarray:
    """Scatter (t, 16) int16 coefficient-group rows at raster indices
    idx of a grid in_ncx CGs wide into a dense (out_h, out_w) int16
    plane; CGs outside it are dropped."""
    lib = get_lib()
    v = np.ascontiguousarray(vals, dtype=np.int16)
    ix = np.ascontiguousarray(idx, dtype=np.int32)
    out = np.empty((out_h, out_w), np.int16)
    lib.expand_cgs(v.ctypes.data, ix.ctypes.data, len(ix), in_ncx, out_h,
                   out_w, out.ctypes.data)
    return out


def encode_intra_slice_native(depth8: np.ndarray, mode8: np.ndarray,
                              coeff_y: np.ndarray, coeff_cb: np.ndarray,
                              coeff_cr: np.ndarray, w: int, h: int,
                              log2_ctu: int, log2_min_cu: int,
                              init_states: np.ndarray
                              ) -> tuple[bytes, int, int]:
    """The I slice data of 2Nx2N CUs with their luma and chroma modes
    (mode8 for both) through the native coder. Returns (payload bytes,
    CABAC tail value, tail bits)."""
    lib = get_lib()
    arrs = [np.ascontiguousarray(a, dtype=dt) for a, dt in (
        (depth8, np.uint8), (mode8, np.uint8), (coeff_y, np.int16),
        (coeff_cb, np.int16), (coeff_cr, np.int16))]
    st = np.ascontiguousarray(init_states, dtype=np.uint8)
    cap = w * h * 4 + 4096
    out = np.empty(cap, dtype=np.uint8)
    tail_val = ctypes.c_uint32(0)
    tail_bits = ctypes.c_int(0)
    n = lib.encode_intra_slice(*(a.ctypes.data for a in arrs), w, h,
                               log2_ctu, log2_min_cu, st.ctypes.data,
                               len(st), out.ctypes.data, cap,
                               ctypes.byref(tail_val), ctypes.byref(tail_bits))
    if n < 0:
        raise RuntimeError("native slice encoder overflowed output buffer")
    return out[:n].tobytes(), int(tail_val.value), int(tail_bits.value)


class _PExtC(ctypes.Structure):
    """Mirrors struct PExtC in entropy.cpp field for field (the
    multi-reference + TMVP block): a wrong order is not refused by the
    call, it silently corrupts the stream."""
    _fields_ = [
        ("ref8", ctypes.c_void_p), ("num_ref", ctypes.c_int32),
        ("tmvp", ctypes.c_int32), ("ref_pocs", ctypes.c_void_p),
        ("col_mv", ctypes.c_void_p), ("col_ref8", ctypes.c_void_p),
        ("col_inter8", ctypes.c_void_p), ("col_poc", ctypes.c_int32),
        ("col_ref_pocs", ctypes.c_void_p),
        ("n_col_refs", ctypes.c_int32),
        ("cu_bits_out", ctypes.c_void_p)]


def _make_pext(ref8, num_ref, tmvp, ref_pocs, col):
    """(pointer to a PExtC, keepalive list), or (None, []) when the
    slice uses one reference and no TMVP. col = (col_mv, col_ref8,
    col_inter8, col_poc, col_ref_pocs) of the collocated picture."""
    if ref8 is None and num_ref <= 1 and not tmvp:
        return None, []
    keep = []

    def arr(a, dt):
        if a is None:
            return None
        c = np.ascontiguousarray(a, dtype=dt)
        keep.append(c)
        return c.ctypes.data

    px = _PExtC()
    px.ref8 = arr(ref8, np.uint8)
    px.num_ref = int(num_ref)
    px.tmvp = 1 if tmvp else 0
    px.ref_pocs = arr(None if ref_pocs is None
                      else np.asarray(ref_pocs, np.int32), np.int32)
    if col is not None and col[2] is not None:
        col_mv, col_ref8, col_inter8, col_poc, col_ref_pocs = col
        px.col_mv = arr(col_mv, np.int32)
        px.col_ref8 = arr(col_ref8, np.uint8)
        px.col_inter8 = arr(col_inter8, np.uint8)
        px.col_poc = int(col_poc)
        px.col_ref_pocs = arr(np.asarray(col_ref_pocs, np.int32), np.int32)
        px.n_col_refs = len(col_ref_pocs)
    else:
        px.tmvp = 0
    keep.append(px)
    return ctypes.byref(px), keep


def _slice_args(slice_type, depth8, coeff_y, coeff_cb, coeff_cr, w, h,
                log2_ctu, log2_min_cu, init_states, *, mode8=None, mv8=None,
                max_merge=2, sign_hiding=False, cmode8=None, sao_params=None,
                nxn8=None, mode4=None, qp_map=None, slice_qp=26, intra8=None,
                mvb=None, pf8=None, poc=0, poc_refs=(0, 0), lossless=False,
                tusplit8=None, rqt_inter=False, ref8=None, num_ref=1,
                ref_pocs_l0=None, tmvp=False, col=None):
    """The arguments encode_slice and encode_slice_wpp share, up to the
    PExtC pointer, and the arrays they point into (kept alive by the
    caller until the call returns)."""
    keep = []

    def ptr(a, dt):
        if a is None:
            return None
        c = np.ascontiguousarray(a, dtype=dt)
        keep.append(c)
        return c.ctypes.data

    st = np.ascontiguousarray(init_states, dtype=np.uint8)
    keep.append(st)
    saos = [None] * 3 if sao_params is None else sao_params
    pext, pkeep = _make_pext(ref8, num_ref, tmvp and slice_type == 1,
                             ref_pocs_l0, col)
    keep.extend(pkeep)
    args = [
        slice_type, ptr(depth8, np.uint8), ptr(mode8, np.uint8),
        ptr(mv8, np.int32), ptr(mvb, np.int32), ptr(pf8, np.uint8),
        poc, poc_refs[0], poc_refs[1], max_merge,
        1 if sign_hiding else 0, 1 if lossless else 0, ptr(cmode8, np.uint8),
        ptr(coeff_y, np.int16), ptr(coeff_cb, np.int16),
        ptr(coeff_cr, np.int16), *(ptr(p, np.int32) for p in saos),
        ptr(nxn8, np.uint8), ptr(mode4, np.uint8), ptr(intra8, np.uint8),
        ptr(tusplit8, np.uint8), 1 if rqt_inter else 0,
        ptr(qp_map, np.int32), slice_qp,
        w, h, log2_ctu, log2_min_cu, st.ctypes.data, len(st), pext]
    return args, keep


def encode_slice_native(slice_type: int, depth8: np.ndarray,
                        coeff_y: np.ndarray, coeff_cb: np.ndarray,
                        coeff_cr: np.ndarray, w: int, h: int,
                        log2_ctu: int, log2_min_cu: int,
                        init_states: np.ndarray, **kw
                        ) -> tuple[bytes, int, int]:
    """Native slice encoder for I (mode8, NxN via nxn8/mode4), P
    (mv8, intra8, tusplit8) and B slices (mvb (n8y, n8x, 4) the L0 and
    L1 MVs, pf8 the prediction flags, poc and poc_refs = (L0 POC, L1
    POC) for the AMVP scaling). dQP: qp_map, the per-CTU QP (ncty,
    nctx), whose deltas against slice_qp are coded per CTU; lossless:
    cu_transquant_bypass on every CU. SAO: sao_params = (p_y, p_cb,
    p_cr) per-CTU parameters. Multi-reference P: ref8,
    num_ref, ref_pocs_l0; TMVP: tmvp and col = (col_mv, col_ref8,
    col_inter8, col_poc, col_ref_pocs). The keywords are
    _slice_args's. Returns (payload_bytes, tail_value, tail_nbits)."""
    lib = get_lib()
    args, _keep = _slice_args(slice_type, depth8, coeff_y, coeff_cb,
                              coeff_cr, w, h, log2_ctu, log2_min_cu,
                              init_states, **kw)
    cap = w * h * 4 + 4096
    out = np.empty(cap, dtype=np.uint8)
    tail_val = ctypes.c_uint32(0)
    tail_bits = ctypes.c_int(0)
    n = lib.encode_slice(*args, out.ctypes.data, cap, ctypes.byref(tail_val),
                         ctypes.byref(tail_bits))
    if n < 0:
        raise RuntimeError("native slice encoder overflowed output buffer")
    return out[:n].tobytes(), int(tail_val.value), int(tail_bits.value)


def encode_slice_wpp_native(slice_type: int, depth8: np.ndarray,
                            coeff_y: np.ndarray, coeff_cb: np.ndarray,
                            coeff_cr: np.ndarray, w: int, h: int,
                            log2_ctu: int, log2_min_cu: int,
                            init_states: np.ndarray, **kw) -> list[bytes]:
    """WPP slice data: one byte-aligned substream per CTU row
    (entropy_coding_sync; frameencoder.cpp:1509 context rule), each
    ended by its own CABAC flush. The keywords are encode_slice_native's."""
    lib = get_lib()
    args, _keep = _slice_args(slice_type, depth8, coeff_y, coeff_cb,
                              coeff_cr, w, h, log2_ctu, log2_min_cu,
                              init_states, **kw)
    rows = (h + (1 << log2_ctu) - 1) >> log2_ctu
    cap = w * h * 4 + 4096 + rows * 8
    out = np.empty(cap, dtype=np.uint8)
    sub_lens = np.zeros(rows, dtype=np.int32)
    n = lib.encode_slice_wpp(*args, out.ctypes.data, cap,
                             sub_lens.ctypes.data, rows)
    if n < 0:
        raise RuntimeError("native WPP slice encoder overflowed its output "
                           "buffer")
    ends = np.cumsum(sub_lens)
    assert ends[-1] == n
    return [out[e - ln:e].tobytes() for e, ln in zip(ends, sub_lens)]
