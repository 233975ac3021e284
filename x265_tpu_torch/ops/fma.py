"""Float32 multiply-add rounded once, as a fused multiply-add rounds.

The reference's jitted float32 RD costs contract `a + b * c` into one
FMA wherever the multiply and the add land in one fused loop (the
compiler allows FP contraction); torch rounds the product first. fma32
gives the single rounding on any device with float64 arithmetic:

- the product b*c of two float32 values is exact in float64 (48 bits);
- the float64 sum s = a + b*c is rounded, and its error term e (TwoSum)
  is exact; where e != 0 and s has an even last bit, s moves one ulp
  toward e, which is the sum rounded to odd in float64;
- a round-to-odd value with at least two more bits than float32
  rounds to float32 as the exact sum does, ties included.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64


def _f64(x):
    """A float32 tensor as float64; a python float rounded to float32
    (the reference's weak-typed constants) and kept a scalar, so no
    tensor is made for it."""
    if isinstance(x, torch.Tensor):
        return x.to(F32).to(F64)
    return float(np.float32(x))


def fma32(a, b, c) -> torch.Tensor:
    """float32(a + b * c) rounded once. a, b, c: float32 tensors or
    python floats; at least one is a tensor."""
    a64, p = _f64(a), _f64(b) * _f64(c)
    s = a64 + p
    bb = s - a64
    err = (a64 - (s - bb)) + (p - bb)
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(bump, torch.nextafter(s, err * float("inf")), s)
    return s.to(F32)
