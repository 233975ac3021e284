"""SATD / SA8D cost kernels (Hadamard-transformed SAD).

Counterpart of x265_tpu/ops/satd.py with x265's normalizations:
sa8d_8x8 = (sum |H8 D H8| + 2) >> 2, satd_4x4 = (sum |H4 D H4| + 1) >> 1,
an NxN SA8D being the sum over its 8x8 sub-blocks. The 2-D Hadamard
of every block runs as one float32 matrix product against the
Kronecker matrix; it is exact (entries +-1, inputs <= 2^10, 64-term
sums <= 2^17, abs-sums <= 2^23) as long as TF32 stays off (device.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def hadamard(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[1]], dtype=np.int32)
    h = hadamard(n // 2)
    return np.block([[h, h], [h, -h]]).astype(np.int32)


@lru_cache(maxsize=None)
def _kron(n: int, device: torch.device) -> torch.Tensor:
    """(n*n, n*n) 2-D Hadamard over raster-flattened n x n blocks."""
    h = hadamard(n)
    return torch.as_tensor(np.kron(h, h), dtype=torch.float32,
                           device=device)


def _abs_sums(flat: torch.Tensor, n: int) -> torch.Tensor:
    """flat (n*n, M) raster blocks -> (M,) int32 sum |H D H|."""
    t = _kron(n, flat.device) @ flat.to(torch.float32)
    return torch.abs(t).sum(0).to(torch.int32)


def _sub8_lanes(diff: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n, B) -> (64, m*m*B) raster 8x8 sub-blocks, m = n // 8."""
    m = n // 8
    b = diff.shape[-1]
    return diff.reshape(m, 8, m, 8, b).permute(1, 3, 0, 2, 4) \
        .reshape(64, m * m * b)


def satd4_batch(diff: torch.Tensor) -> torch.Tensor:
    """diff: (..., 4, 4) int32 -> (...,) int32 SATD (x265 norm)."""
    lead = diff.shape[:-2]
    s = _abs_sums(diff.reshape(-1, 16).T, 4)
    return ((s + 1) >> 1).reshape(lead)


def sa8d_batch(diff: torch.Tensor) -> torch.Tensor:
    """diff: (..., 8, 8) int32 -> (...,) int32 SA8D (x265 norm)."""
    lead = diff.shape[:-2]
    s = _abs_sums(diff.reshape(-1, 64).T, 8)
    return ((s + 2) >> 2).reshape(lead)


def sa8d_nxn_batch(diff: torch.Tensor, n: int) -> torch.Tensor:
    """diff: (..., N, N) -> (...,) sum of 8x8 SA8Ds (SATD at N=4)."""
    if n == 4:
        return satd4_batch(diff)
    if n == 8:
        return sa8d_batch(diff)
    m = n // 8
    lead = diff.shape[:-2]
    d = diff.reshape(*lead, m, 8, m, 8).transpose(-3, -2)
    return sa8d_batch(d).sum((-2, -1), dtype=torch.int32)


def sa8d_nxn_lanes(diff: torch.Tensor, n: int) -> torch.Tensor:
    """diff: (N, N, B) int32 -> (B,) SA8D/SATD, blocks in the last axis."""
    b = diff.shape[-1]
    if n == 4:
        return (_abs_sums(diff.reshape(16, b), 4) + 1) >> 1
    m2 = (n // 8) ** 2
    s = (_abs_sums(_sub8_lanes(diff, n), 8) + 2) >> 2      # (m2*B,)
    if m2 == 1:
        return s
    return s.reshape(m2, b).sum(0, dtype=torch.int32)
