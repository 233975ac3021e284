"""Port parity: the window gather and the windowed motion search of
x265_tpu_torch.ops.me_win against x265_tpu.ops.me_win (and the windowed
chroma MC of the P pipeline) on the same numpy inputs. The reference
runs as its own CPU tests run it: gather_windows_ds takes its
vmap(dynamic_slice) branch. The port runs on the CPU, where the gather
is its plain version. Tolerance: exact equality (integer search and
integer predictions)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu.ops import me_win as ref
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from x265_tpu_torch.ops import me_win as port

torch.set_num_threads(2)

# the main path's four window sizes at me_range 10: luma 16-region and
# 32-block windows, chroma 16-region and 32-block windows
WINDOWS = (44, 60, 22, 30)


def _offsets(h, w, win, seed):
    """Window starts covering both edges of the plane, the interior,
    starts past the far edges and negative starts (dynamic_slice counts
    those from the far end, then clamps)."""
    rng = np.random.default_rng(seed)
    ys = np.concatenate([[0, h - win, 0, h - win, h - win + 5, 3, -3,
                          -2 * h],
                         rng.integers(0, h - win + 1, 10)])
    xs = np.concatenate([[0, 0, w - win, w - win, 2, w, -win - 1, 7],
                         rng.integers(0, w - win + 1, 10)])
    return ys.astype(np.int32), xs.astype(np.int32)


@pytest.mark.parametrize("dtype", (np.uint8, np.uint16))
@pytest.mark.parametrize("win", WINDOWS)
def test_gather_windows_plain_matches_reference(dtype, win):
    rng = np.random.default_rng(win)
    hi = 256 if dtype == np.uint8 else 1024
    plane = rng.integers(0, hi, (96, 130)).astype(dtype)
    ys, xs = _offsets(96, 130, win, seed=win + 1)
    # gather_windows_ds takes unpadded coordinates: pad = 0 here
    want = np.asarray(ref.gather_windows_ds(jnp.asarray(plane), 0,
                                            jnp.asarray(ys),
                                            jnp.asarray(xs), win))
    got = port.gather_windows(torch.from_numpy(plane), torch.from_numpy(ys),
                              torch.from_numpy(xs), win)
    assert got.dtype == (torch.uint8 if dtype == np.uint8 else torch.uint16)
    np.testing.assert_array_equal(want, got.view(
        torch.int16 if dtype == np.uint16 else torch.uint8).numpy()
        .view(dtype))


@pytest.mark.parametrize("wc", (22, 30))
def test_gather_chroma_windows_matches_reference(wc):
    rng = np.random.default_rng(wc)
    pc = 18
    cpad2 = rng.integers(0, 256, (2, 32 + 2 * pc, 48 + 2 * pc)) \
        .astype(np.uint8)
    n = 6
    reg_cy = (np.arange(n) % 2 * 16).astype(np.int32)
    reg_cx = (np.arange(n) // 2 * 16).astype(np.int32)
    s0y = rng.integers(-pc, pc, n).astype(np.int32)
    s0x = rng.integers(-pc, pc, n).astype(np.int32)
    s0y[0] = 40                    # past the bottom: clamped per plane
    s0y[1], s0x[1] = -pc, -pc      # the top-left edge of the padding
    s0y[2] = -60                   # negative start: from the far end
    want = ref.gather_chroma_windows(jnp.asarray(cpad2), pc,
                                     jnp.asarray(reg_cy), jnp.asarray(reg_cx),
                                     jnp.asarray(s0y), jnp.asarray(s0x), wc)
    got = port.gather_chroma_windows(
        torch.from_numpy(cpad2), pc, torch.from_numpy(reg_cy),
        torch.from_numpy(reg_cx), torch.from_numpy(s0y),
        torch.from_numpy(s0x), wc)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _planes(h=64, w=96, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    cur = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255)
    ref_y = np.clip(np.roll(base, -3, axis=1) + rng.integers(-6, 6, (h, w)),
                    0, 255)
    cb = np.clip(120 + (xx[::2, ::2] >> 3) + rng.integers(-3, 3,
                                                          (h // 2, w // 2)),
                 0, 255)
    cr = np.clip(132 - (yy[::2, ::2] >> 3), 0, 255)
    return (cur.astype(np.int32), ref_y.astype(np.int32),
            cb.astype(np.int32), cr.astype(np.int32))


@pytest.mark.parametrize("weighted", (False, True))
def test_me_all_sizes_and_chroma_preds(weighted):
    """MVs, costs and predictions of every block size, then the windowed
    chroma predictions at those MVs, at 64x96 with me_range 10."""
    cur, ref_y, rcb, rcr = _planes()
    h, w = cur.shape
    r, pad_y, pad_c = 10, 28, 18
    rng = np.random.default_rng(9)
    cmv16 = rng.integers(-12, 13, (h // 16, w // 16, 2)).astype(np.int32)
    lam = 37
    wvec = np.array([70, -3, 60, 2, 66, 1], np.int32) if weighted else None
    ref_pad = np.pad(ref_y.astype(np.uint8), pad_y, mode="edge")

    jres, jseeds = ref.me_all_sizes(
        jnp.asarray(cur), jnp.asarray(ref_pad), jnp.asarray(cmv16),
        jnp.int32(lam), radius=r, pad=pad_y, bit_depth=8,
        wvec=None if wvec is None else jnp.asarray(wvec))
    tres, tseeds = port.me_all_sizes(
        torch.from_numpy(cur), torch.from_numpy(ref_pad),
        torch.from_numpy(cmv16), lam, radius=r, pad=pad_y, bit_depth=8,
        wvec=None if wvec is None else torch.from_numpy(wvec))
    for n in (8, 16, 32):
        for k in range(3):
            np.testing.assert_array_equal(np.asarray(jres[n][k]),
                                          tres[n][k].numpy(),
                                          err_msg=f"n={n} field {k}")
    for n in (16, 32):
        for k in range(2):
            np.testing.assert_array_equal(np.asarray(jseeds[n][k]),
                                          tseeds[n][k].numpy())

    cpad2 = np.stack([np.pad(p.astype(np.uint8), pad_c, mode="edge")
                      for p in (rcb, rcr)])
    jc = ref_pgop._chroma_preds_windowed(
        jnp.asarray(cpad2), pad_c, jnp.asarray(rcb), jnp.asarray(rcr),
        {n: jres[n][0] for n in (8, 16, 32)}, jseeds, r, h, w, 8,
        wvec=None if wvec is None else jnp.asarray(wvec))
    tc = port_pgop._chroma_preds_windowed(
        torch.from_numpy(cpad2), pad_c, torch.from_numpy(rcb),
        torch.from_numpy(rcr), {n: tres[n][0] for n in (8, 16, 32)},
        tseeds, r, h, w, 8,
        wvec=None if wvec is None else torch.from_numpy(wvec))
    for n in (8, 16, 32):
        for k in range(2):
            np.testing.assert_array_equal(np.asarray(jc[n][k]),
                                          tc[n][k].numpy(),
                                          err_msg=f"chroma n={n} plane {k}")


def test_int_search_tie_keeps_first_candidate():
    """A flat window makes every candidate tie on SAD: with flat
    penalties the raster-first candidate (index 0) must win, as the
    reference's strict < does."""
    side, n = 5, 8
    win = torch.full((n + 4 + side, n + 4 + side, 3), 7, dtype=torch.uint8)
    cur = torch.full((n, n, 3), 9, dtype=torch.int32)
    pen = torch.zeros((side, 3), dtype=torch.int32)
    cost, idx = port.int_search_vec(win, cur, pen, pen, n, side)
    assert idx.tolist() == [0, 0, 0]
    assert cost.tolist() == [2 * n * n] * 3


def test_gather_windows_rejects_bad_inputs():
    src = torch.zeros((40, 40), dtype=torch.uint8)
    ys = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        port.gather_windows(src.to(torch.int32), ys, ys, 8)
    with pytest.raises(ValueError):
        port.gather_windows(src, ys.long(), ys.long(), 8)
    with pytest.raises(ValueError):
        port.gather_windows(src, ys, ys, 41)
