"""Batched intra prediction (clause 8.4.4.2).

Counterpart of x265_tpu/ops/intra.py: all 35 modes are one sparse
linear map from the canonical reference array R[4N+1] to the NxN
prediction, pred[m] = (W[m] @ R + rnd[m]) >> shift[m], followed by the
spec's DC/horizontal/vertical boundary fixups on luma < 32. The matrix
products run in float32 and are exact: weights <= 32, references <
2^10 and every accumulation < 2^24, with TF32 off (device.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..common.tables import intra_angle, intra_inv_angle, intra_filter_flag


@lru_cache(maxsize=None)
def build_intra_tables(n: int):
    """Per-mode weight tensors for size n: w (35, n*n, 4n+1) int32,
    use_filt (35,) bool (mode reads the [1 2 1]-filtered reference,
    luma only), rnd (35,) and shift (35,) int32."""
    c = 2 * n
    nref = 4 * n + 1
    log2n = n.bit_length() - 1
    w = np.zeros((35, n * n, nref), dtype=np.int32)
    rnd = np.zeros(35, dtype=np.int32)
    shift = np.zeros(35, dtype=np.int32)
    use_filt = np.array([intra_filter_flag(m, log2n) for m in range(35)])

    def lidx(s):  # L[s] = p[-1][s]
        return c - 1 - s

    def tidx(t):  # T[t] = p[t][-1]
        return c + 1 + t

    # planar
    rnd[0], shift[0] = n, log2n + 1
    for y in range(n):
        for x in range(n):
            p = y * n + x
            w[0, p, lidx(y)] += n - 1 - x
            w[0, p, tidx(n)] += x + 1
            w[0, p, tidx(x)] += n - 1 - y
            w[0, p, lidx(n)] += y + 1

    # DC (interior value everywhere; boundary fixup applied separately)
    rnd[1], shift[1] = n, log2n + 1
    for t in range(n):
        w[1, :, tidx(t)] = 1
        w[1, :, lidx(t)] = 1

    # angular
    for mode in range(2, 35):
        a = intra_angle(mode)
        rnd[mode], shift[mode] = 16, 5
        vertical = mode >= 18

        def refcan(xp):  # canonical index of ref[xp]
            if xp >= 0:
                xp = min(xp, 2 * n)
                return c + xp if vertical else c - xp
            inv = intra_inv_angle(mode)
            d = (xp * inv + 128) >> 8
            return c - d if vertical else c + d

        for y in range(n):
            for x in range(n):
                p = y * n + x
                u, v = (y, x) if vertical else (x, y)
                i = ((u + 1) * a) >> 5
                f = ((u + 1) * a) & 31
                w[mode, p, refcan(v + i + 1)] += 32 - f
                if f:
                    w[mode, p, refcan(v + i + 2)] += f

    return {"w": w, "use_filt": use_filt, "rnd": rnd, "shift": shift}


@lru_cache(maxsize=None)
def _tables(n: int, device: torch.device):
    t = build_intra_tables(n)
    return (torch.as_tensor(t["w"], dtype=torch.float32, device=device),
            torch.as_tensor(t["use_filt"], device=device),
            torch.as_tensor(t["rnd"], device=device),
            torch.as_tensor(t["shift"], device=device))


def filter_refs_batch(r: torch.Tensor) -> torch.Tensor:
    """[1 2 1]/4 smoothing over (B, 4N+1) canonical refs (8.4.4.2.3)."""
    mid = (r[:, :-2] + 2 * r[:, 1:-1] + r[:, 2:] + 2) >> 2
    return torch.cat([r[:, :1], mid, r[:, -1:]], dim=1)


def _exact_w_matmul(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(M, P, K) weights x (B, K) refs -> (B, M, P) int32, exact in
    float32 (see the module docstring)."""
    m, p, k = w.shape
    out = r.to(torch.float32) @ w.reshape(m * p, k).T
    return out.reshape(r.shape[0], m, p).to(torch.int32)


def _boundary_parts(refs: torch.Tensor, n: int):
    c = 2 * n
    l_col = torch.flip(refs[:, c - n:c], dims=[1])     # L[0..n-1]
    t_row = refs[:, c + 1:c + 1 + n]                    # T[0..n-1]
    return l_col, t_row, refs[:, c]


def intra_pred_all_modes(refs: torch.Tensor, n: int, *, is_luma: bool = True,
                         bit_depth: int = 8) -> torch.Tensor:
    """All 35 intra predictions: refs (B, 4N+1) int32 canonical
    (substituted) references -> (B, 35, N, N) int32."""
    w, use_filt, rnd, shift = _tables(n, refs.device)
    if is_luma:
        acc_u = _exact_w_matmul(w, refs)
        acc_f = _exact_w_matmul(w, filter_refs_batch(refs))
        acc = torch.where(use_filt[None, :, None], acc_f, acc_u)
    else:
        acc = _exact_w_matmul(w, refs)
    pred = (acc + rnd[None, :, None]) >> shift[None, :, None]
    b = refs.shape[0]
    pred = pred.reshape(b, 35, n, n)
    maxval = (1 << bit_depth) - 1

    if is_luma and n < 32:
        l_col, t_row, corner = _boundary_parts(refs, n)
        # DC boundary filter (8.4.4.2.5)
        dc = pred[:, 1, n - 1, n - 1]
        dcp = pred[:, 1].clone()
        dcp[:, 0, :] = (t_row + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (l_col + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (l_col[:, 0] + 2 * dc + t_row[:, 0] + 2) >> 2
        pred[:, 1] = dcp
        # mode 10 (horizontal): first row; mode 26 (vertical): first col
        pred[:, 10, 0, :] = torch.clamp(
            l_col[:, :1] + ((t_row - corner[:, None]) >> 1), 0, maxval)
        pred[:, 26, :, 0] = torch.clamp(
            t_row[:, :1] + ((l_col - corner[:, None]) >> 1), 0, maxval)
    return torch.clamp(pred, 0, maxval)


def intra_pred_single_mode(refs: torch.Tensor, modes: torch.Tensor, n: int,
                           *, is_luma: bool = True,
                           bit_depth: int = 8) -> torch.Tensor:
    """One chosen mode per block: refs (B, 4N+1), modes (B,) ->
    (B, N, N) int32."""
    w_all, use_filt_all, rnd_all, shift_all = _tables(n, refs.device)
    modes = modes.long()
    src = refs
    if is_luma:
        src = torch.where(use_filt_all[modes][:, None],
                          filter_refs_batch(refs), refs)
    acc = torch.bmm(w_all[modes], src.to(torch.float32)[:, :, None])[..., 0] \
        .to(torch.int32)
    pred = (acc + rnd_all[modes][:, None]) >> shift_all[modes][:, None]
    b = refs.shape[0]
    pred = pred.reshape(b, n, n)
    maxval = (1 << bit_depth) - 1

    if is_luma and n < 32:
        l_col, t_row, corner = _boundary_parts(refs, n)
        is_dc = (modes == 1)[:, None]
        dc = pred[:, n - 1, n - 1]
        row0 = torch.where(is_dc, (t_row + 3 * dc[:, None] + 2) >> 2,
                           pred[:, 0, :])
        col0 = torch.where(is_dc, (l_col + 3 * dc[:, None] + 2) >> 2,
                           pred[:, :, 0])
        p00 = torch.where(modes == 1,
                          (l_col[:, 0] + 2 * dc + t_row[:, 0] + 2) >> 2,
                          pred[:, 0, 0])
        ish = (modes == 10)[:, None]
        isv = (modes == 26)[:, None]
        h_row = torch.clamp(l_col[:, :1] + ((t_row - corner[:, None]) >> 1),
                            0, maxval)
        v_col = torch.clamp(t_row[:, :1] + ((l_col - corner[:, None]) >> 1),
                            0, maxval)
        row0 = torch.where(ish, h_row, row0)
        col0 = torch.where(isv, v_col, col0)
        pred = pred.clone()
        pred[:, 0, :] = row0
        pred[:, :, 0] = col0
        pred[:, 0, 0] = torch.where(ish[:, 0], h_row[:, 0],
                                    torch.where(isv[:, 0], v_col[:, 0], p00))
    return torch.clamp(pred, 0, maxval)
