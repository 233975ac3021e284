"""The port's hand-written kernels (the window gather and the integer
search) against their plain PyTorch versions on a CUDA card, and the
card's stream against the CPU's at an odd me_range. This file imports
neither JAX nor the reference package, so it runs on a machine with a
GPU and no JAX:

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.uint8, torch.uint16))
def test_gather_kernel_odd_windows_and_unaligned_plane_on_gpu(dtype):
    """Windows of an odd byte count take the kernel's byte loop; a plane
    that starts one element past an aligned address takes the realigned
    word reads. Both against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    rng = np.random.default_rng(2)
    h, w = 97, 133
    flat = torch.from_numpy(rng.integers(0, 256, h * w + 1)
                            .astype(np.int16)).cuda()
    flat = flat.to(torch.uint8) if dtype == torch.uint8 else \
        flat.view(torch.uint16)
    plane = flat[1:].view(h, w)
    for win in (1, 5, 7, 21, 22, 38, 44, 54):
        ys, xs = _offsets(h, w, win, seed=win)
        ys_t = torch.from_numpy(ys).cuda()
        xs_t = torch.from_numpy(xs).cuda()
        got = port.gather_windows(plane, ys_t, xs_t, win)
        want = port.gather_windows_plain(plane, ys_t, xs_t, win)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16) if dtype == torch.uint16
                           else got,
                           want.view(torch.int16) if dtype == torch.uint16
                           else want), win


def _search_inputs(case, h, w, n, side, seed):
    """Windows for the n-blocks of an h x w plane (n = 16: the 16-region
    windows of the pair search), the int32 current plane and penalties.
    Cases: random samples; near-flat samples in {0, 1} with penalties in
    {0, 1, 2} (ties at many indices); flat (every candidate ties); and
    the extremes, current 255 against window 0 and current 0 against
    window 255, with the largest SADs."""
    rng = np.random.default_rng(seed)
    s = n + side - 1 + 8
    nb = (h // n) * (w // n)
    if case == "random":
        win = rng.integers(0, 256, (nb, s, s))
        cur = rng.integers(0, 256, (h, w))
        pen = rng.integers(0, 400, (side, nb))
    elif case == "near_flat":
        win = rng.integers(0, 2, (nb, s, s))
        cur = rng.integers(0, 2, (h, w))
        pen = rng.integers(0, 3, (side, nb))
    else:
        wv, cv = {"flat": (3, 200), "cur255": (0, 255),
                  "cur0": (255, 0)}[case]
        win = np.full((nb, s, s), wv)
        cur = np.full((h, w), cv)
        pen = np.full((side, nb), 5)
    return (torch.from_numpy(win.astype(np.uint8)).cuda(),
            torch.from_numpy(cur.astype(np.int32)).cuda(),
            torch.from_numpy(pen.astype(np.int32)).cuda())


def _pens(pen, nb, rng_seed):
    """(penx, peny) of nb blocks from one (side, nb') base."""
    rng = np.random.default_rng(rng_seed)
    cols = torch.from_numpy(rng.integers(0, pen.shape[1], nb)).cuda()
    return pen[:, cols].contiguous(), pen.flip(0)[:, cols].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("random", "near_flat", "flat", "cur255",
                                  "cur0"))
@pytest.mark.parametrize("me_range", (10, 7))
def test_int_search_kernels_match_plain_on_gpu(case, me_range):
    """Both entry points of the search kernel against their plain
    versions: the pair search (16-regions and their 8-blocks) and the
    32-block search on a 128 x 192 plane, at me_range 10 (side 21,
    windows 44 and 60) and at the odd me_range 7 (side 15, windows 38
    and 54, rows not 4-byte aligned). Each launch moves its counter by
    one; ties pick the lowest index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    h, w = 128, 192
    side = 2 * me_range + 1
    w16, cur, pen = _search_inputs(case, h, w, 16, side, seed=5)
    by16, bx16 = h // 16, w // 16
    penx8, peny8 = _pens(pen, 4 * by16 * bx16, 6)
    penx16, peny16 = _pens(pen, by16 * bx16, 7)
    args = (w16, cur, penx8, peny8, penx16, peny16, by16, bx16, side)
    before = port.int_search_pair_windows.launches
    got = port.int_search_pair_windows(*args)
    assert port.int_search_pair_windows.launches == before + 1
    want = port.int_search_pair_windows_plain(*args)
    torch.cuda.synchronize()
    for g, wt in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(g, wt)
    if case != "random" and case != "near_flat":
        assert int(got[0][1].abs().max()) == 0
        assert int(got[1][1].abs().max()) == 0
    win, cur, pen = _search_inputs(case, h, w, 32, side, seed=32)
    penx, peny = _pens(pen, pen.shape[1], 33)
    before = port.int_search_windows.launches
    got = port.int_search_windows(win, cur, penx, peny, 32, side)
    assert port.int_search_windows.launches == before + 1
    want = port.int_search_windows_plain(win, cur, penx, peny, 32, side)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case in ("flat", "cur255", "cur0"):
        assert int(got[1].abs().max()) == 0


def _encode_ippp(frames, device, me_range):
    """I frame at QP 29 on the device recon, then pipelined P frames at
    CQP 32, through the encoder's entry points."""
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc import IntraEncoder
    h, w = frames[0][0].shape
    cfg = EncoderConfig(width=w, height=h, qp=32, deblock=True, sao=False,
                        me_range=me_range)
    enc = IntraEncoder(cfg, device=device)
    r0 = enc.encode_frame(*frames[0], qp=29, use_device_recon=True,
                          need_recon=False)
    enc.ref = r0.device_ref
    enc.poc = 0
    return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=8)


@pytest.mark.gpu
def test_card_stream_equals_cpu_at_odd_me_range():
    """A 64x96 I + 3 P clip at me_range 7 (search windows 38 and 54)
    gives the same bytes on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:96]
    base = np.clip(((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256)
                   + rng.integers(-8, 8, (64, 96)), 0, 255).astype(np.uint8)
    cb = np.full((32, 48), 120, np.uint8)
    cr = np.full((32, 48), 132, np.uint8)
    frames = [(np.roll(base, 2 * i, axis=1), cb, cr) for i in range(4)]
    before = port.int_search_pair_windows.launches
    card = _encode_ippp(frames, "cuda", 7)
    assert port.int_search_pair_windows.launches == before + 3
    cpu = _encode_ippp(frames, "cpu", 7)
    assert [r.bitstream for r in card] == [r.bitstream for r in cpu]


def test_search_cpu_tensors_take_the_plain_version():
    """The search wrappers take the plain version for CPU tensors and
    count no kernel launch."""
    side, h, w = 5, 32, 48
    rng = np.random.default_rng(3)
    cur = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32))
    w16 = torch.from_numpy(rng.integers(0, 256, (6, 28, 28))
                           .astype(np.uint8))
    p8 = torch.from_numpy(rng.integers(0, 50, (side, 24)).astype(np.int32))
    p16 = torch.from_numpy(rng.integers(0, 50, (side, 6)).astype(np.int32))
    w32 = torch.from_numpy(rng.integers(0, 256, (1, 44, 44))
                           .astype(np.uint8))
    p32 = p16[:, :1].contiguous()
    before = (port.int_search_pair_windows.launches,
              port.int_search_windows.launches)
    got = port.int_search_pair_windows(w16, cur, p8, p8, p16, p16, 2, 3,
                                       side)
    want = port.int_search_pair_windows_plain(w16, cur, p8, p8, p16, p16,
                                              2, 3, side)
    for g, wt in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(g, wt)
    got = port.int_search_windows(w32, cur[:32, :32].contiguous(), p32, p32,
                                  32, side)
    want = port.int_search_windows_plain(w32, cur[:32, :32], p32, p32, 32,
                                         side)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (port.int_search_pair_windows.launches,
            port.int_search_windows.launches) == before


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
