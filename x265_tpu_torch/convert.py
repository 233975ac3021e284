"""State carried in from outside the package: a configuration given as
a plain dict, and reference planes given as numpy arrays (for example
the recon of an I frame coded elsewhere)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common.params import EncoderConfig
from .device import resolve_device
from .enc.intra_recon import DeviceRef


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
    """DeviceRef (narrow uint planes at the coded size) from numpy recon
    planes."""
    if bit_depth != 8:
        raise NotImplementedError(
            "10-bit: ROADMAP queue 1 item 19")
    dev = resolve_device(device)

    def up(p):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(p).astype(np.uint8))).to(dev)

    return DeviceRef(up(y), up(cb), up(cr))
