"""Device resolution and the numeric settings exactness depends on.

The encoder is integer from end to end; its matrix products run as
float matmuls whose operands and partial sums are exact integers. A
TF32 or reduced-precision reduction would round them, so every such
mode is switched off when the package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another. Raises when CUDA is wanted and absent — there is no
    silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "encoder on the CPU")
    return dev
