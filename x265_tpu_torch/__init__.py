"""x265_tpu_torch: the HEVC encoder of x265_tpu in PyTorch for one
NVIDIA H100 (Hopper, sm_90a).

Plain device code is PyTorch; the per-block reference-window gather of
the motion search and the integer full search over those windows are
CUDA kernels written by hand (csrc/gather_windows.cu,
csrc/int_search.cu). The package imports neither JAX nor
x265_tpu: the host layers it needs (bitstream, tables, native CABAC)
are its own copies. Entry points run on the GPU unless the caller
passes device="cpu".
"""

from .device import resolve_device  # noqa: F401
