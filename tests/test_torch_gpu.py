"""The port's hand-written kernels against their plain PyTorch versions
on a CUDA card. This file imports neither JAX nor the reference package,
so it runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a GPU every test here skips. Tolerance: exact equality (the
kernels move integers)."""

import numpy as np
import pytest
import torch

from x265_tpu_torch.ops import me_win as port

# the main path's four window sizes at me_range 10: luma 16-region and
# 32-block windows, chroma 16-region and 32-block windows
WINDOWS = (44, 60, 22, 30)


def _offsets(h, w, win, seed):
    """Window starts covering both edges of the plane, the interior,
    starts past the far edges and negative starts."""
    rng = np.random.default_rng(seed)
    ys = np.concatenate([[0, h - win, 0, h - win, h - win + 5, 3, -3,
                          -2 * h],
                         rng.integers(0, h - win + 1, 10)])
    xs = np.concatenate([[0, 0, w - win, w - win, 2, w, -win - 1, 7],
                         rng.integers(0, w - win + 1, 10)])
    return ys.astype(np.int32), xs.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.uint8, torch.uint16))
def test_gather_kernel_matches_plain_on_gpu(dtype):
    """The CUDA kernel against its plain version on the card, all four
    main-path window sizes, edges included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    hi = 256 if dtype == torch.uint8 else 1024
    plane = torch.from_numpy(rng.integers(0, hi, (1136, 1976))
                             .astype(np.int16)).cuda().to(torch.int32)
    plane = plane.to(torch.uint8) if dtype == torch.uint8 else \
        plane.to(torch.int16).view(torch.uint16)
    for win in WINDOWS:
        ys, xs = _offsets(1136, 1976, win, seed=win)
        ys_t = torch.from_numpy(ys).cuda()
        xs_t = torch.from_numpy(xs).cuda()
        before = port.gather_windows.launches
        got = port.gather_windows(plane, ys_t, xs_t, win)
        assert port.gather_windows.launches == before + 1
        want = port.gather_windows_plain(plane, ys_t, xs_t, win)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16) if dtype == torch.uint16
                           else got,
                           want.view(torch.int16) if dtype == torch.uint16
                           else want)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes through the plain version and counts no kernel
    launch; only a CUDA tensor launches the kernel."""
    src = (torch.arange(60 * 70, dtype=torch.int32).reshape(60, 70) % 251) \
        .to(torch.uint8)
    ys = torch.tensor([0, 3, 38, 50], dtype=torch.int32)
    xs = torch.tensor([0, 48, 7, -5], dtype=torch.int32)
    before = port.gather_windows.launches
    got = port.gather_windows(src, ys, xs, 22)
    assert port.gather_windows.launches == before
    assert torch.equal(got, port.gather_windows_plain(src, ys, xs, 22))
    assert torch.equal(got[1], src[3:25, 48:70])
