"""Reconstructed-picture records, and the host-recon I frame.

ReconFrame holds host (numpy) planes; DeviceRef keeps the reference
picture (or the stack of reference pictures) on the device as narrow
torch planes at the coded size (uint8 at 8 bits, uint16 at 10), so an
I -> P chain never round-trips through the host.

reconstruct_intra_frame is the host-recon I path (a copy of
x265_tpu/enc/intra_recon.py): given the analysis decisions it
re-predicts every CU from decoded neighbour samples in z-scan order,
transforms, quantises and reconstructs it, as a decoder will, one block
at a time in numpy. It carries what the device wavefront
(intra_recon_gpu.py) does not: a per-CTU QP map (dQP), lossless
(cu_transquant_bypass) and CTU 16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.syntax import FrameIntraSyntax
from ..common.params import EncoderConfig
from ..common.tables import chroma_qp, intra_scan_idx
from ..ops.intra_np import canonical_refs, filter_refs, intra_pred_np
from ..ops.transforms import (dct_np, dequant_np, idct_np, quant_np,
                              sign_hide_np)


def pixel_dtype(bit_depth: int):
    """The torch storage type of bit_depth-bit samples (the DeviceRef
    and window type): uint8 at 8 bits, uint16 at 10."""
    return torch.uint8 if bit_depth == 8 else torch.uint16


def np_pixel_dtype(bit_depth: int):
    """The numpy counterpart of pixel_dtype."""
    return np.uint8 if bit_depth == 8 else np.uint16


@dataclass
class ReconFrame:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray


@dataclass
class DeviceRef:
    """Reference picture kept on the device (torch uint8 or uint16
    planes, pixel_dtype, at the CODED size): one picture, or the
    (R, ...) stack of the R most recent pictures that the P path
    carries, slot 0 the newest."""
    y: object            # torch (h, w) or (R, h, w)
    cb: object           # torch (h/2, w/2) or (R, h/2, w/2)
    cr: object           # torch (h/2, w/2) or (R, h/2, w/2)

    def to_recon(self) -> ReconFrame:
        """The newest picture as a host ReconFrame (slot 0 of a
        stack)."""
        planes = (self.y, self.cb, self.cr)
        if self.y.dim() == 3:
            planes = tuple(p[0] for p in planes)
        return ReconFrame(*(p.cpu().numpy().astype(np.int32)
                            for p in planes))


def _avail_mask(mask: np.ndarray, x0: int, y0: int, n: int) -> np.ndarray:
    h, w = mask.shape
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


def reconstruct_intra_frame(orig_y: np.ndarray, orig_cb: np.ndarray,
                            orig_cr: np.ndarray, depth8: np.ndarray,
                            mode8: np.ndarray, cfg: EncoderConfig,
                            qp: int | None = None,
                            cmode8: np.ndarray | None = None,
                            nxn8: np.ndarray | None = None,
                            mode4: np.ndarray | None = None,
                            qp_map: np.ndarray | None = None
                            ) -> tuple[FrameIntraSyntax, ReconFrame]:
    """qp_map: optional per-CTU QP (ncty, nctx) from AQ/cuTree; the
    per-CU quant QP is the covering CTU's entry (QG == CTU)."""
    h, w = orig_y.shape
    bd = cfg.bit_depth
    qp = cfg.qp if qp is None else qp
    qpc = chroma_qp(qp)
    maxv = (1 << bd) - 1
    rec_y = np.zeros((h, w), dtype=np.int32)
    rec_cb = np.zeros((h // 2, w // 2), dtype=np.int32)
    rec_cr = np.zeros((h // 2, w // 2), dtype=np.int32)
    dec_y = np.zeros((h, w), dtype=bool)
    dec_c = np.zeros((h // 2, w // 2), dtype=bool)
    coeff_y = np.zeros((h, w), dtype=np.int32)
    coeff_cb = np.zeros((h // 2, w // 2), dtype=np.int32)
    coeff_cr = np.zeros((h // 2, w // 2), dtype=np.int32)

    ctu = cfg.ctu_size
    log2_ctu = cfg.log2_ctu

    def qp_at(x0: int, y0: int) -> int:
        if qp_map is None:
            return qp
        return int(qp_map[y0 >> log2_ctu, x0 >> log2_ctu])

    def luma_tu(x0: int, y0: int, n: int, mode: int) -> None:
        log2n = n.bit_length() - 1
        qq = qp_at(x0, y0)
        av = _avail_mask(dec_y, x0, y0, n)
        refs = canonical_refs(rec_y, x0, y0, n, av, bd)
        filt = filter_refs(refs, n, bd)
        pred = intra_pred_np(refs, mode, n, is_luma=True, bit_depth=bd,
                             filtered=filt)
        resi = orig_y[y0:y0 + n, x0:x0 + n].astype(np.int32) - pred
        if cfg.lossless:
            # cu_transquant_bypass (8.6.1): the residual IS the
            # coefficient array; recon == source exactly
            coeff_y[y0:y0 + n, x0:x0 + n] = resi
            rec_y[y0:y0 + n, x0:x0 + n] = pred + resi
            dec_y[y0:y0 + n, x0:x0 + n] = True
            return
        if cfg.sign_hiding:
            coefs, du = quant_np(dct_np(resi, bd, dst=(log2n == 2)),
                                 qq, bd, intra=True, with_rem=True)
            coefs = sign_hide_np(coefs, intra_scan_idx(mode, log2n,
                                                       True), du)
        else:
            coefs = quant_np(dct_np(resi, bd, dst=(log2n == 2)), qq,
                             bd, intra=True)
        if np.any(coefs):
            coeff_y[y0:y0 + n, x0:x0 + n] = coefs
            r = idct_np(dequant_np(coefs, qq, bd), bd, dst=(log2n == 2))
            rec_y[y0:y0 + n, x0:x0 + n] = np.clip(pred + r, 0, maxv)
        else:
            rec_y[y0:y0 + n, x0:x0 + n] = pred
        dec_y[y0:y0 + n, x0:x0 + n] = True

    def do_cu(x0: int, y0: int, log2_size: int) -> None:
        n = 1 << log2_size
        mode = int(mode8[y0 >> 3, x0 >> 3])
        cmode = mode if cmode8 is None else int(cmode8[y0 >> 3, x0 >> 3])
        nxn = (log2_size == cfg.log2_min_cu and nxn8 is not None
               and bool(nxn8[y0 >> 3, x0 >> 3]))
        if nxn:
            # PART_NxN: four 4x4 PUs == TUs in z order, each predicted
            # from the previous sub-TUs' reconstruction (8.4.4.2.1)
            for sx, sy in ((0, 0), (4, 0), (0, 4), (4, 4)):
                luma_tu(x0 + sx, y0 + sy, 4,
                        int(mode4[(y0 + sy) >> 2, (x0 + sx) >> 2]))
        else:
            luma_tu(x0, y0, n, mode)
        # chroma (DM mode), 4:2:0
        cn = n >> 1
        if cn < 4:
            return
        qqc = chroma_qp(qp_at(x0, y0)) if qp_map is not None else qpc
        cx0, cy0 = x0 >> 1, y0 >> 1
        avc = _avail_mask(dec_c, cx0, cy0, cn)
        for op, rp, cp in ((orig_cb, rec_cb, coeff_cb),
                           (orig_cr, rec_cr, coeff_cr)):
            refs_c = canonical_refs(rp, cx0, cy0, cn, avc, bd)
            pred_c = intra_pred_np(refs_c, cmode, cn, is_luma=False,
                                   bit_depth=bd)
            resi_c = op[cy0:cy0 + cn, cx0:cx0 + cn].astype(np.int32) - pred_c
            if cfg.lossless:
                cp[cy0:cy0 + cn, cx0:cx0 + cn] = resi_c
                rp[cy0:cy0 + cn, cx0:cx0 + cn] = pred_c + resi_c
                continue
            if cfg.sign_hiding:
                coefs_c, du_c = quant_np(dct_np(resi_c, bd), qqc, bd,
                                         intra=True, with_rem=True)
                coefs_c = sign_hide_np(
                    coefs_c, intra_scan_idx(cmode, log2_size - 1, False),
                    du_c)
            else:
                coefs_c = quant_np(dct_np(resi_c, bd), qqc, bd,
                                   intra=True)
            if np.any(coefs_c):
                cp[cy0:cy0 + cn, cx0:cx0 + cn] = coefs_c
                r = idct_np(dequant_np(coefs_c, qqc, bd), bd)
                rp[cy0:cy0 + cn, cx0:cx0 + cn] = np.clip(pred_c + r, 0, maxv)
            else:
                rp[cy0:cy0 + cn, cx0:cx0 + cn] = pred_c
        dec_c[cy0:cy0 + cn, cx0:cx0 + cn] = True

    def walk(x0: int, y0: int, log2_size: int) -> None:
        size = 1 << log2_size
        depth = log2_ctu - log2_size
        inside = x0 + size <= w and y0 + size <= h
        if inside and int(depth8[y0 >> 3, x0 >> 3]) <= depth:
            do_cu(x0, y0, log2_size)
            return
        if log2_size > cfg.log2_min_cu:
            half = size >> 1
            for sub in range(4):
                sx = x0 + (sub & 1) * half
                sy = y0 + (sub >> 1) * half
                if sx < w and sy < h:
                    walk(sx, sy, log2_size - 1)
        else:
            do_cu(x0, y0, log2_size)

    for cy in range((h + ctu - 1) // ctu):
        for cx in range((w + ctu - 1) // ctu):
            walk(cx * ctu, cy * ctu, log2_ctu)

    syn = FrameIntraSyntax(depth8=depth8, mode8=mode8, coeff_y=coeff_y,
                           coeff_cb=coeff_cb, coeff_cr=coeff_cr,
                           cmode8=cmode8, nxn8=nxn8, mode4=mode4)
    return syn, ReconFrame(rec_y, rec_cb, rec_cr)
