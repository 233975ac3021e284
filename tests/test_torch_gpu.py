"""The port's hand-written kernels (the window gather and the integer
search) against their plain PyTorch versions on a CUDA card, at the
bench path's shapes and at the fast/zerolatency and medium/zerolatency
paths' (stacked references, sides 11 and 21, a composed search
current) and the B path's (one reference per plane), RDOQ and the
lowpass DCT on the card against the CPU, and the card's stream against
the CPU's at an odd me_range, in the fast/zerolatency,
medium/zerolatency and placebo/zerolatency configurations, with noise
reduction and with B frames (--preset fast); the device lookahead on
the card against the CPU, and the per-CTU-QP streams (encode_sequence
with AQ 2 + cuTree, a B mini-GOP with AQ 2, the lossless and CTU-16 I
frames of the host-recon path), the CLI's 64x96 legs, the scaler and
the device SSIM on the card against the CPU.
This file imports neither JAX nor the reference package, so it runs on
a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a GPU every test here skips. Tolerance: exact equality (the
kernels move integers)."""

import numpy as np
import pytest
import torch

from chip_smoke import b_clip, encode_random_access, fast_b_config, \
    medium_clip
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


def _search_inputs(case, h, w, n, side, seed, bits=8, lead=4):
    """Windows for the n-blocks of an h x w plane (n = 16: the 16-region
    windows of the pair search), side + n - 1 + 2 lead wide, the int32
    current plane and penalties, at `bits` bits a sample (windows uint8,
    or uint16 at 10). Cases:
    random samples; near-flat samples in {0, 1} with penalties in
    {0, 1, 2} (ties at many indices); flat (every candidate ties); and
    the extremes, current 255 (curmax: 2^bits - 1) against window 0 and
    current 0 against window 255 (cur0 at 10 bits: 1023), with the
    largest SADs."""
    rng = np.random.default_rng(seed)
    s = n + side - 1 + 2 * lead
    nb = (h // n) * (w // n)
    top = (1 << bits) - 1
    if case == "random":
        win = rng.integers(0, top + 1, (nb, s, s))
        cur = rng.integers(0, top + 1, (h, w))
        pen = rng.integers(0, 400, (side, nb))
    elif case == "near_flat":
        win = rng.integers(0, 2, (nb, s, s))
        cur = rng.integers(0, 2, (h, w))
        pen = rng.integers(0, 3, (side, nb))
    else:
        wv, cv = {"flat": (3, 200), "cur255": (0, 255), "curmax": (0, top),
                  "cur0": (top, 0)}[case]
        win = np.full((nb, s, s), wv)
        cur = np.full((h, w), cv)
        pen = np.full((side, nb), 5)
    if bits > 8:
        return (torch.from_numpy(win.astype(np.int16)).cuda()
                .view(torch.uint16),
                torch.from_numpy(cur.astype(np.int32)).cuda(),
                torch.from_numpy(pen.astype(np.int32)).cuda())
    return (torch.from_numpy(win.astype(np.uint8)).cuda(),
            torch.from_numpy(cur.astype(np.int32)).cuda(),
            torch.from_numpy(pen.astype(np.int32)).cuda())


def _pens(pen, nb, rng_seed):
    """(penx, peny) of nb blocks from one (side, nb') base."""
    rng = np.random.default_rng(rng_seed)
    cols = torch.from_numpy(rng.integers(0, pen.shape[1], nb)).cuda()
    return pen[:, cols].contiguous(), pen.flip(0)[:, cols].contiguous()


# planes of the search test: (pair plane, 32-block plane). The second
# pair gives 2610 regions and the 32-blocks 667 blocks: counts that no
# units-per-block the kernel picks (4 or 5 regions, 1-2 32-blocks, ...)
# divides, and more block groups than an H100 holds at once, so the
# grid strides and its last group is ragged.
SEARCH_PLANES = {"small": ((128, 192), (128, 192)),
                 "strided": ((720, 928), (736, 928))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("random", "near_flat", "flat", "cur255",
                                  "cur0"))
@pytest.mark.parametrize("me_range", (10, 7, 2, 5, 12))
@pytest.mark.parametrize("plane", ("small", "strided"))
def test_int_search_kernels_match_plain_on_gpu(case, me_range, plane):
    """Both entry points of the search kernel against their plain
    versions: the pair search (16-regions and their 8-blocks) and the
    32-block search, at every side the presets use: me_range 10 (side
    21, windows 44 and 60), the odd me_range 7 and 5 (sides 15 and 11,
    windows 38/54 and 34/50, rows not 4-byte aligned), and the extremes
    me_range 2 and 12 (sides 5 and 25); on a small plane and on one whose
    unit counts divide no units-per-block and make the grid stride. Each
    launch moves its counter by one; ties pick the lowest index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    (h, w), (h32, w32) = SEARCH_PLANES[plane]
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
    win, cur, pen = _search_inputs(case, h32, w32, 32, side, seed=32)
    penx, peny = _pens(pen, pen.shape[1], 33)
    before = port.int_search_windows.launches
    got = port.int_search_windows(win, cur, penx, peny, 32, side)
    assert port.int_search_windows.launches == before + 1
    want = port.int_search_windows_plain(win, cur, penx, peny, 32, side)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case in ("flat", "cur255", "cur0"):
        assert int(got[1].abs().max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("random", "near_flat", "flat", "curmax",
                                  "cur0"))
@pytest.mark.parametrize("me_range", (10, 7, 2, 5, 12))
@pytest.mark.parametrize("plane", ("small", "strided"))
def test_int_search_u16_kernels_match_plain_on_gpu(case, me_range, plane):
    """The Main10 instances (uint16 windows, 10-bit current) of both
    entry points against their plain versions, exactly, at every side
    the presets use, on both planes: int_search_pair_u16 and
    int_search_u16. Each launch moves the wrapper's count and its
    uint16 count by one; ties pick the lowest index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    (h, w), (h32, w32) = SEARCH_PLANES[plane]
    side = 2 * me_range + 1
    w16, cur, pen = _search_inputs(case, h, w, 16, side, seed=15, bits=10)
    by16, bx16 = h // 16, w // 16
    penx8, peny8 = _pens(pen, 4 * by16 * bx16, 16)
    penx16, peny16 = _pens(pen, by16 * bx16, 17)
    args = (w16, cur, penx8, peny8, penx16, peny16, by16, bx16, side)
    fn = port.int_search_pair_windows
    before = (fn.launches, fn.launches_u16)
    got = fn(*args)
    assert (fn.launches, fn.launches_u16) == (before[0] + 1, before[1] + 1)
    want = port.int_search_pair_windows_plain(*args)
    torch.cuda.synchronize()
    for g, wt in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(g, wt)
    if case != "random" and case != "near_flat":
        assert int(got[0][1].abs().max()) == 0
        assert int(got[1][1].abs().max()) == 0
    win, cur, pen = _search_inputs(case, h32, w32, 32, side, seed=42,
                                   bits=10)
    penx, peny = _pens(pen, pen.shape[1], 43)
    fn = port.int_search_windows
    before = (fn.launches, fn.launches_u16)
    got = fn(win, cur, penx, peny, 32, side)
    assert (fn.launches, fn.launches_u16) == (before[0] + 1, before[1] + 1)
    want = port.int_search_windows_plain(win, cur, penx, peny, 32, side)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case in ("flat", "curmax", "cur0"):
        assert int(got[1].abs().max()) == 0


# planes of the 8- and 16-block search beyond SEARCH_PLANES' (per n):
# odd block counts (165 8-blocks, 35 16-blocks), so the last warp task
# is partial whenever a task holds more than one unit (2 at side 13),
# and a single block
SMALL_PLANES = {"ragged": {8: (88, 120), 16: (80, 112)},
                "single": {8: (8, 8), 16: (16, 16)}}


def _shifted(win, shift):
    """win copied to a storage that starts `shift` elements past an
    aligned address (shift 0: win itself)."""
    if not shift:
        return win
    big = torch.zeros(win.numel() + shift, dtype=win.dtype,
                      device=win.device)
    v = big[shift:].view(win.shape)
    v.copy_(win)
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("random", "near_flat", "flat", "curmax",
                                  "cur0"))
@pytest.mark.parametrize("bits", (8, 10))
@pytest.mark.parametrize("n", (8, 16))
def test_int_search_8_and_16_blocks_match_plain_on_gpu(case, bits, n):
    """The single search's 8- and 16-block instances (int_search_u8 and
    int_search_u16 at n = 8 and 16, me_size_windowed's) against the plain
    version, exactly, at sides 5-25 (13: me_size_windowed's default
    radius 6) and leads 0 (its windows) and 4, on both SEARCH_PLANES
    (the larger one strides the grid), on a plane whose last task is
    partial, on a single block, and with the small plane's windows one
    element past an aligned address. Each launch moves the wrapper's
    count, its uint16 count and its count for n by one; ties pick the
    lowest index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    fn = port.int_search_windows
    planes = [(p, SEARCH_PLANES[p][1], 0) for p in ("small", "strided")] + \
        [(p, SMALL_PLANES[p][n], 0) for p in ("ragged", "single")] + \
        [("small_unaligned", SEARCH_PLANES["small"][1], 1)]
    for plane, (h, w), shift in planes:
        for side in (5, 11, 13, 15, 21, 25):
            for lead in (0, 4):
                win, cur, pen = _search_inputs(case, h, w, n, side,
                                               seed=side + lead, bits=bits,
                                               lead=lead)
                win = _shifted(win, shift)
                penx, peny = _pens(pen, pen.shape[1], side)
                before = (fn.launches, fn.launches_u16, fn.launches_n[n],
                          fn.launches_n_u16[n])
                got = fn(win, cur, penx, peny, n, side, lead)
                u16 = int(bits > 8)
                assert (fn.launches, fn.launches_u16, fn.launches_n[n],
                        fn.launches_n_u16[n]) == (
                    before[0] + 1, before[1] + u16, before[2] + 1,
                    before[3] + u16)
                want = port.int_search_windows_plain(win, cur, penx, peny,
                                                     n, side, lead)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1]), (plane, side, lead)
                if case in ("flat", "curmax", "cur0"):
                    assert int(got[1].abs().max()) == 0


@pytest.mark.gpu
def test_int_search_unaligned_windows_on_gpu():
    """Windows the kernel cannot copy 4 bytes at a time: an odd side
    (45 and 61, one unused row and column past the searched ones) and
    windows that start one element past an aligned address. Both entry
    points, at 8 and at 10 bits, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    for bits in (8, 10):
        _check_unaligned_search(bits)


def _check_unaligned_search(bits):
    h, w, side = 128, 192, 21
    w16, cur, pen = _search_inputs("random", h, w, 16, side, seed=8,
                                   bits=bits)
    by16, bx16 = h // 16, w // 16
    penx8, peny8 = _pens(pen, 4 * by16 * bx16, 9)
    penx16, peny16 = _pens(pen, by16 * bx16, 10)
    win32, cur32, pen32 = _search_inputs("random", h, w, 32, side, seed=11,
                                         bits=bits)
    penx, peny = _pens(pen32, pen32.shape[1], 12)
    for shift in (0, 1):
        for odd in (True, False):
            if not odd and not shift:
                continue
            ws = []
            for t in (w16, win32):
                s = t.shape[1] + odd
                big = torch.zeros(t.shape[0] * s * s + shift,
                                  dtype=t.dtype, device="cuda")
                v = big[shift:].view(t.shape[0], s, s)
                v[:, :t.shape[1], :t.shape[1]] = t
                ws.append(v)
            args = (ws[0], cur, penx8, peny8, penx16, peny16, by16, bx16,
                    side)
            got = port.int_search_pair_windows(*args)
            want = port.int_search_pair_windows_plain(*args)
            torch.cuda.synchronize()
            for g, wt in zip((*got[0], *got[1]), (*want[0], *want[1])):
                assert torch.equal(g, wt), (shift, odd)
            got = port.int_search_windows(ws[1], cur32, penx, peny, 32, side)
            want = port.int_search_windows_plain(ws[1], cur32, penx, peny,
                                                 32, side)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (shift, odd)
            assert torch.equal(got[1], want[1]), (shift, odd)


def _check_stacked_gather(me_range, seed, nr=3):
    """The gather on an nr-reference stacked uint8 plane at a path's
    1080p shapes at me_range r (luma references (nr x (1088 + 2r + 8),
    1920 + 2r + 8), windows 16 + 2r + 8 and 32 + 2r + 8; chroma cb/cr
    rows 2 x nr x (544 + r + 8) of 960 + r + 8, windows r + 12 and
    r + 20): luma
    windows starting in every reference's segment, and the chroma
    windows through gather_chroma_windows with per-region reference rows
    (its starts clamp over the whole stacked component), against the
    plain version (the same call on CPU tensors)."""
    rng = np.random.default_rng(seed)
    h, w, pad = 1088, 1920, 2 * me_range + 8
    seg = h + 2 * pad
    plane = torch.from_numpy(rng.integers(0, 256, (nr * seg, w + 2 * pad))
                             .astype(np.uint8)).cuda()
    for n in (16, 32):
        win = n + 2 * me_range + 8
        nb = (h // n) * (w // n)
        ref = rng.integers(0, nr, nb)
        ys = (ref * seg + rng.integers(0, seg - win + 1, nb)).astype(np.int32)
        xs = rng.integers(0, w + 2 * pad - win + 1, nb).astype(np.int32)
        ys[:3] = (0, seg - win, nr * seg - win)
        ys_t, xs_t = torch.from_numpy(ys).cuda(), torch.from_numpy(xs).cuda()
        got = port.gather_windows(plane, ys_t, xs_t, win)
        want = port.gather_windows_plain(plane, ys_t, xs_t, win)
        torch.cuda.synchronize()
        assert torch.equal(got, want), win
    hc, wc_, pc = h // 2, w // 2, me_range + 8
    cseg = hc + 2 * pc
    cpad2 = torch.from_numpy(rng.integers(0, 256, (2, nr * cseg, wc_ + 2 * pc))
                             .astype(np.uint8)).cuda()
    for wc, n in ((me_range + 12, 8), (me_range + 20, 16)):
        by, bx = hc // n, wc_ // n
        reg_cy = torch.arange(by, dtype=torch.int32).repeat_interleave(bx) * n
        reg_cx = torch.arange(bx, dtype=torch.int32).repeat(by) * n
        nb = by * bx
        s0y = torch.from_numpy(rng.integers(-pc, pc, nb).astype(np.int32))
        s0x = torch.from_numpy(rng.integers(-pc, pc, nb).astype(np.int32))
        s0y[0] = hc + 40                # past its segment and the plane
        roff = torch.from_numpy(rng.integers(0, nr, nb).astype(np.int32)) \
            * cseg
        args = (pc, reg_cy, reg_cx, s0y, s0x, wc)
        before = port.gather_windows.launches
        got = port.gather_chroma_windows(
            cpad2, *(a.cuda() if torch.is_tensor(a) else a for a in args),
            row_off=roff.cuda())
        assert port.gather_windows.launches == before + 1
        want = port.gather_chroma_windows(cpad2.cpu(), *args, row_off=roff)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), wc


@pytest.mark.gpu
def test_gather_kernel_on_stacked_references_on_gpu():
    """The stacked gather at the fast/zerolatency path's shapes (me_range
    5: luma windows 34 and 50, chroma 17 and 25)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    _check_stacked_gather(5, seed=4)


@pytest.mark.gpu
def test_gather_and_search_at_the_b_paths_shapes_on_gpu():
    """The B path's shapes (--preset fast: me_range 5, one reference per
    list in its own plane): the gather of luma windows 34 and 50 and
    chroma 17 and 25, and the search at side 11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    _check_stacked_gather(5, seed=6, nr=1)
    _check_composed_search(11, seed=33)


@pytest.mark.gpu
def test_gather_kernel_on_stacked_references_at_me_range_10_on_gpu():
    """The stacked gather at the medium/zerolatency path's shapes
    (me_range 10: luma windows 44 and 60, chroma 22 and 30)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    _check_stacked_gather(10, seed=5)


def _check_composed_search(side, seed):
    """The search on a current plane composed per region, the
    weight-compensated current where the region predicts from reference
    0 and the true current elsewhere (as me_all_sizes builds it with
    weights and several references): both entry points against their
    plain versions."""
    h, w = 720, 928
    rng = np.random.default_rng(seed)
    w16, cur, pen = _search_inputs("random", h, w, 16, side, seed=seed + 1)
    cur_s = torch.clamp(cur * 3 // 4 + 20, 0, 255)
    by16, bx16 = h // 16, w // 16
    wm16 = torch.from_numpy(rng.integers(0, 2, by16 * bx16).astype(bool))
    plane = port.search_plane(cur, cur_s, wm16.cuda(), 16)
    assert not torch.equal(plane, cur) and not torch.equal(plane, cur_s)
    penx8, peny8 = _pens(pen, 4 * by16 * bx16, seed + 2)
    penx16, peny16 = _pens(pen, by16 * bx16, seed + 3)
    args = (w16, plane, penx8, peny8, penx16, peny16, by16, bx16, side)
    got = port.int_search_pair_windows(*args)
    want = port.int_search_pair_windows_plain(*args)
    torch.cuda.synchronize()
    for g, wt in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(g, wt)
    h32, w32 = 736, 928
    win, cur, pen = _search_inputs("random", h32, w32, 32, side,
                                   seed=seed + 4)
    cur_s = torch.clamp(cur * 3 // 4 + 20, 0, 255)
    wm32 = torch.from_numpy(rng.integers(0, 2, (h32 // 32) * (w32 // 32))
                            .astype(bool)).cuda()
    plane = port.search_plane(cur, cur_s, wm32, 32)
    penx, peny = _pens(pen, pen.shape[1], seed + 5)
    got = port.int_search_windows(win, plane, penx, peny, 32, side)
    want = port.int_search_windows_plain(win, plane, penx, peny, 32, side)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_int_search_composed_current_on_gpu():
    """The composed-current search at side 11 (me_range 5, the
    fast/zerolatency path: windows 34 and 50)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    _check_composed_search(11, seed=13)


@pytest.mark.gpu
def test_int_search_composed_current_at_me_range_10_on_gpu():
    """The composed-current search at side 21 (me_range 10, the
    medium/zerolatency path: windows 44 and 60)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    _check_composed_search(21, seed=23)


def _encode_ippp(frames, device, me_range=10, preset=None, chunk=8):
    """I frame at QP 29 on the device recon, then pipelined P frames at
    CQP 32, through the encoder's entry points; with preset, that preset
    under --tune zerolatency instead of the bench configuration."""
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc import IntraEncoder
    h, w = frames[0][0].shape
    if preset is None:
        cfg = EncoderConfig(width=w, height=h, qp=32, deblock=True,
                            sao=False, me_range=me_range)
    else:
        cfg = EncoderConfig(width=w, height=h, qp=32)
        cfg.apply_preset(preset)
        cfg.apply_tune("zerolatency")
    enc = IntraEncoder(cfg, device=device)
    r0 = enc.encode_frame(*frames[0], qp=29, use_device_recon=True,
                          need_recon=False)
    enc.ref = r0.device_ref
    enc.poc = 0
    return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=chunk)


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


@pytest.mark.gpu
def test_card_stream_equals_cpu_fast_zerolatency():
    """--preset fast --tune zerolatency (3 references, TMVP, SAO) on a
    64x96 strobe clip, 1 I + 6 P in chunks of 2: the same bytes on the
    card as on the CPU, some blocks predicted from reference 1 or
    later, and some CTU with SAO on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    tex = [rng.integers(0, 255, (64, 96)).astype(np.uint8) for _ in range(2)]
    ch = [rng.integers(100, 160, (32, 48)).astype(np.uint8) for _ in range(2)]
    frames = [(tex[k % 2], ch[k % 2], ch[k % 2]) for k in range(7)]
    card = _encode_ippp(frames, "cuda", preset="fast", chunk=2)
    cpu = _encode_ippp(frames, "cpu", preset="fast", chunk=2)
    assert [r.bitstream for r in card] == [r.bitstream for r in cpu]
    assert any(r.syntax.ref8 is not None for r in card[1:])
    assert any(p[..., 0].any() for r in card[1:] for p in r.syntax.sao_params)


@pytest.mark.gpu
def test_card_stream_equals_cpu_medium_zerolatency():
    """--preset medium --tune zerolatency (CTU 64: the z-quadrant I-frame
    wavefront replayed as a CUDA graph, depth-0 64x64 CUs; 3 references,
    me_range 10, TMVP, SAO) on the 72x128 clip of
    tests/test_torch_ctu64.py, 1 I + 6 P in chunks of 2: the same bytes
    on the card as on the CPU, some 64x64 CU and some block predicted
    from reference 1 or later."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    frames = medium_clip(7)
    card = _encode_ippp(frames, "cuda", preset="medium", chunk=2)
    cpu = _encode_ippp(frames, "cpu", preset="medium", chunk=2)
    assert [r.bitstream for r in card] == [r.bitstream for r in cpu]
    assert any((r.syntax.depth8 == 0).any() for r in card[1:])
    assert any(r.syntax.ref8 is not None for r in card[1:])


@pytest.mark.gpu
def test_card_stream_equals_cpu_fast_b_frames():
    """--preset fast with B frames (CTU 32, 3 B frames with b-adapt, 3
    references, SAO) on the 64x96 B clip of tests/test_torch_bframes.py,
    1 I + 8 frames through the CLI's mini-GOP loop: the same bytes and
    mini-GOPs on the card as on the CPU, with L1-only and bi-predicted
    cells."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    frames = b_clip(9)
    cfg = fast_b_config(64, 96)
    before = port.int_search_pair_windows.launches
    card, lengths = encode_random_access(frames, "cuda", cfg)
    n_p = sum(r.ftype == "P" for r in card)
    n_b = sum(r.ftype == "B" for r in card)
    assert port.int_search_pair_windows.launches == before + n_p + 2 * n_b
    cpu, lengths_cpu = encode_random_access(frames, "cpu", cfg)
    assert lengths == lengths_cpu and n_b > 0
    assert [r.bitstream for r in card] == [r.bitstream for r in cpu]
    pf = np.concatenate([r.syntax.pf8.ravel() for r in card
                         if r.ftype == "B"])
    assert (pf == 2).any() and (pf == 3).any()


@pytest.mark.gpu
@pytest.mark.parametrize("qp", (32, "vector"))
def test_rdoq_and_lowpass_on_card_equal_cpu(qp):
    """rdoq_lanes and rdoq_batch at every TU size, at one QP and with a
    per-block QP vector, and the lowpass DCT: the card's levels, deltaU
    and every float32 comparison operand (the level candidates' costs,
    the group and TU gains) equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from x265_tpu_torch.ops import transforms as tr
    rng = np.random.default_rng(7)
    for n in (4, 8, 16, 32):
        tc = (rng.standard_normal((n, n, 300)) *
              rng.choice([3, 30, 300, 3000], (1, 1, 300))).astype(np.int32)
        q = 32 if qp == 32 else rng.integers(0, 52, 300).astype(np.int32)
        for fn, x in ((tr.rdoq_lanes, tc),
                      (tr.rdoq_batch, np.ascontiguousarray(
                          tc.transpose(2, 0, 1)))):
            outs = []
            for dev in ("cpu", "cuda"):
                ops = []
                qq = q if qp == 32 else torch.from_numpy(q).to(dev)
                lv, du = fn(torch.from_numpy(x).to(dev), n, qq, 57.0,
                            with_rem=True, costs=ops)
                outs.append([lv.cpu(), du.cpu()] + [o.cpu() for o in ops])
            for a, b in zip(*outs):
                assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a, b.view(torch.int32)
                                   if b.is_floating_point() else b)
        if n >= 8:
            r = torch.from_numpy(rng.integers(-255, 256, (n, n, 50))
                                 .astype(np.int32))
            assert torch.equal(tr.dct_lanes(r.cuda(), n, lowpass=True).cpu(),
                               tr.dct_lanes(r, n, lowpass=True))


@pytest.mark.gpu
def test_card_stream_equals_cpu_placebo_and_noise_reduction():
    """--preset placebo --tune zerolatency (RDOQ, 5 references, merge 5,
    me_range 12) on the 72x128 clip, 1 I + 5 P in one chunk, and the
    bench configuration with noise reduction 600 and the lowpass DCT on
    a 64x96 clip in chunks of 2: the same bytes on the card as on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from chip_smoke import (encode_ippp, nr_lowpass_config, placebo_config,
                            small_clip)
    for frames, make_cfg, chunk in ((medium_clip(6), placebo_config, 5),
                                    (small_clip(5), nr_lowpass_config, 2)):
        h, w = frames[0][0].shape
        card = encode_ippp(frames, "cuda", make_cfg(h, w), chunk=chunk)
        cpu = encode_ippp(frames, "cpu", make_cfg(h, w), chunk=chunk)
        assert [r.bitstream for r in card] == [r.bitstream for r in cpu]


@pytest.mark.gpu
def test_lookahead_on_card_equals_cpu():
    """The device lookahead (AQ modes 1-3, the lowres search, cuTree's
    ordered scatter) on four 64x96 frames: the card's offsets equal the
    CPU's bit for bit (float64 transcendentals rounded once, exact
    means, the scatter's fixed order), so the QP maps do too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc.lookahead_gpu import lookahead_gop
    frames = b_clip(4)
    ys, cbs, crs = (np.stack([f[k] for f in frames]) for k in range(3))
    for aq_mode in (1, 2, 3):
        cfg = EncoderConfig(width=96, height=64, qp=32, aq_mode=aq_mode,
                            cutree=True)
        card = lookahead_gop(ys, cbs, crs, cfg, device="cuda")
        cpu = lookahead_gop(ys, cbs, crs, cfg, device="cpu")
        for a, b in zip(card, cpu):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_card_stream_equals_cpu_aq_cutree_and_host_i_path():
    """encode_sequence under --preset medium --tune zerolatency with
    AQ 2 + cuTree on the 72x128 clip (1 I + 5 P), a --preset fast B
    mini-GOP with AQ 2 (flat maps), a lossless I frame and a CTU-16 I
    frame: the same bytes and QP maps on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from chip_smoke import aq_cutree_config, encode_seq, small_clip
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc import IntraEncoder
    frames = medium_clip(6)
    card, cmaps = encode_seq(frames, "cuda", aq_cutree_config(72, 128))
    cpu, pmaps = encode_seq(frames, "cpu", aq_cutree_config(72, 128))
    assert [r.bitstream for r in card] == [r.bitstream for r in cpu]
    for (a, _), (b, _) in zip(cmaps, pmaps):
        np.testing.assert_array_equal(a, b)
    cfg = fast_b_config(64, 96)
    cfg.aq_mode = 2
    card, _ = encode_random_access(b_clip(5), "cuda", cfg)
    cfg = fast_b_config(64, 96)
    cfg.aq_mode = 2
    cpu, _ = encode_random_access(b_clip(5), "cpu", cfg)
    assert [r.bitstream for r in card] == [r.bitstream for r in cpu]
    fr = small_clip(1)[0]
    for kw in (dict(lossless=True),
               dict(ctu_size=16, keyint=1, bframes=0, deblock=True)):
        out = [IntraEncoder(EncoderConfig(width=96, height=64, qp=32, **kw),
                            device=d).encode_frame(*fr).bitstream
               for d in ("cuda", "cpu")]
        assert out[0] == out[1]


@pytest.mark.gpu
@pytest.mark.parametrize("leg", range(6))
def test_cli_legs_on_card_equal_cpu(leg, tmp_path):
    """The 64x96 CLI legs of chip_smoke.py (fast CRF with B frames,
    ABR + VBV with the hash, AUD and length-prefixed units, a two-pass
    pair, analysis save then load, WPP, a two-rung ABR ladder) through
    cli.main on the card and on the CPU: the same output bytes, csv
    rows (but wall_s) and stats files."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from chip_smoke import CLI_LEGS, cli_leg_outputs
    tag = CLI_LEGS[leg][0]
    card = cli_leg_outputs(tag, "cuda", tmp_path / "card")
    cpu = cli_leg_outputs(tag, "cpu", tmp_path / "cpu")
    assert card.keys() == cpu.keys()
    for k in card:
        assert card[k] == cpu[k], f"{tag}: {k}"


@pytest.mark.gpu
def test_scale_frame_and_ssim_on_card_equal_cpu():
    """scale_frame (1080p -> 1280x720 and a 64x96 downscale) and the
    device SSIM, card against CPU: the scaler exact (int32 taps), the
    SSIM's float32 within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from chip_smoke import small_clip, synth_1080p
    from x265_tpu_torch.ops.metrics import ssim_plane_t
    from x265_tpu_torch.ops.scaler import scale_frame
    for frame, (w, h) in ((synth_1080p(1), (1280, 720)),
                          (small_clip(1)[0], (48, 32))):
        card = scale_frame(frame, w, h, device="cuda")
        cpu = scale_frame(frame, w, h, device="cpu")
        for a, b in zip(card, cpu):
            assert a.shape == b.shape and np.array_equal(a, b)
    a, b = synth_1080p(0)[0], synth_1080p(1)[0]
    sc = float(ssim_plane_t(torch.from_numpy(a).cuda(),
                            torch.from_numpy(b).cuda()))
    sp = float(ssim_plane_t(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(sc - sp) <= 1e-6


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
