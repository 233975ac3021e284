"""State carried in from outside the package: a configuration given as
a plain dict, and reference planes given as numpy arrays (for example
the recon of an I frame coded elsewhere)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common.params import EncoderConfig
from .device import resolve_device
from .enc.intra_recon import DeviceRef, np_pixel_dtype


def config_from_dict(d: dict) -> EncoderConfig:
    """EncoderConfig from dataclasses.asdict of an equal-layout config.
    Unknown keys raise (a field this package does not know is a
    setting it would silently ignore)."""
    names = {f.name for f in dataclasses.fields(EncoderConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown EncoderConfig fields: {sorted(extra)}")
    return EncoderConfig(**d)


def device_ref_from_numpy(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                          device=None, bit_depth: int = 8) -> DeviceRef:
    """DeviceRef (narrow planes at the coded size: uint8 at 8 bits,
    uint16 at 10) from numpy recon planes."""
    if bit_depth not in (8, 10):
        raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
    dev = resolve_device(device)
    dt = np_pixel_dtype(bit_depth)

    def up(p):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(p).astype(dt))).to(dev)

    return DeviceRef(up(y), up(cb), up(cr))
