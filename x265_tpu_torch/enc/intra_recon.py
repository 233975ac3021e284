"""Reconstructed-picture records.

ReconFrame holds host (numpy) planes; DeviceRef keeps the reference
picture (or the stack of reference pictures) on the device as narrow
uint8 torch planes at the coded size, so an I -> P chain never
round-trips through the host."""

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
    CODED size): one picture, or the (R, ...) stack of the R most
    recent pictures that the P path carries, slot 0 the newest."""
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
