"""Compact coefficient transfer: most quantized coefficients are zero,
so an encode downloads the rows of its nonzero 4x4 coefficient groups
(CGs) instead of dense coefficient planes. Counterpart of
x265_tpu/ops/compact.py."""

from __future__ import annotations

import numpy as np
import torch


def fetch_rows(cg: torch.Tensor, idx_np: np.ndarray) -> np.ndarray:
    """The CG rows idx_np of cg (T, 16) on the device, as one
    index_select and one download."""
    idx = torch.as_tensor(np.asarray(idx_np, np.int64), device=cg.device)
    return torch.index_select(cg, 0, idx).cpu().numpy()
