"""Reconstructed-picture records.

ReconFrame holds host (numpy) planes; DeviceRef keeps a reference
picture on the device as narrow uint8 torch planes at the coded size,
so an I -> P chain never round-trips through the host."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ReconFrame:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray


@dataclass
class DeviceRef:
    """Reference picture kept on the device (torch uint8 planes at the
    CODED size)."""
    y: object            # torch (h, w)
    cb: object           # torch (h/2, w/2)
    cr: object           # torch (h/2, w/2)

    def to_recon(self) -> ReconFrame:
        return ReconFrame(*(p.cpu().numpy().astype(np.int32)
                            for p in (self.y, self.cb, self.cr)))
