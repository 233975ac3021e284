"""Motion-estimation helpers shared by the windowed search: the 4x4
mean pool of the coarse pass and the MV bit-cost proxy. Counterpart of
x265_tpu/ops/me.py:_downsample4/_mv_bits."""

from __future__ import annotations

import torch


def _downsample4(plane: torch.Tensor) -> torch.Tensor:
    """4x4 mean pool (integer: sum >> 4 == truncated float mean for
    non-negative pixels)."""
    h, w = plane.shape
    p = plane[:h // 4 * 4, :w // 4 * 4].to(torch.int32)
    p = p[0::2, :] + p[1::2, :]
    p = p[0::2, :] + p[1::2, :]
    p = p[:, 0::2] + p[:, 1::2]
    p = p[:, 0::2] + p[:, 1::2]
    return p >> 4


def bitlen(a: torch.Tensor) -> torch.Tensor:
    """Integer bit length of a >= 0 (== ceil(log2(a + 1))) read from the
    float32 exponent field; exact for a < 2^24."""
    e = (a.to(torch.float32).view(torch.int32) >> 23) - 126
    return torch.where(a > 0, e, 0)


def _mv_bits(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Approximate Exp-Golomb signalling cost of an MVD, in bits:
    2 * ceil(log2(|v| + 1)) + 1 per component. The reference evaluates
    the logarithm in float32; the integer bit length is the same value
    for |v| < 2^21, far beyond any MV the search reaches."""
    return 2 * bitlen(torch.abs(dx)) + 1 + 2 * bitlen(torch.abs(dy)) + 1
