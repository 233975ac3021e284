"""Port parity: the window gather and the windowed motion search of
x265_tpu_torch.ops.me_win against x265_tpu.ops.me_win (and the windowed
chroma MC of the P pipeline) on the same numpy inputs. The reference
runs as its own CPU tests run it: gather_windows_ds takes its
vmap(dynamic_slice) branch. The port runs on the CPU, where the gather
is its plain version. Tolerance: exact equality (integer search and
integer predictions)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_main10 import _tensor_indexed
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

    # the reference as one jitted program (one compile, kept by the
    # persistent cache, instead of hundreds of eager ones; integer
    # arithmetic, so jitted and eager give the same values)
    jres, jseeds = jax.jit(functools.partial(
        ref.me_all_sizes, radius=r, pad=pad_y, bit_depth=8))(
        jnp.asarray(cur), jnp.asarray(ref_pad), jnp.asarray(cmv16),
        jnp.int32(lam), wvec=None if wvec is None else jnp.asarray(wvec))
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
    jc = jax.jit(functools.partial(
        ref_pgop._chroma_preds_windowed, pc=pad_c, radius=r, h=h, w=w,
        bit_depth=8))(
        jnp.asarray(cpad2), refcb=jnp.asarray(rcb), refcr=jnp.asarray(rcr),
        mvs={n: jres[n][0] for n in (8, 16, 32)}, seeds=jseeds,
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


def _me_plane(h, w, seed, bits):
    """The reference's test_me_win.py content (a diagonal ramp with
    noise), lifted to 10 bits with 2 more low bits of noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    p = ((xx * 7 + yy * 3 + (xx * yy >> 6)) % 256).astype(np.int32)
    p = np.clip(p + rng.integers(-20, 20, (h, w)), 0, 255)
    return p if bits == 8 else p * 4 + rng.integers(0, 4, (h, w))


@pytest.fixture
def refuse_uint16_reads(monkeypatch):
    """A tensor-indexed read of a uint16 tensor raises, as on the card:
    tests/test_torch_main10.py's refuse_uint16_tensor_reads for one
    test."""
    real = torch.Tensor.__getitem__

    def getitem(self, idx):
        if self.dtype == torch.uint16 and _tensor_indexed(idx):
            raise RuntimeError("tensor-indexed read of a uint16 tensor")
        return real(self, idx)

    monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)


@pytest.mark.parametrize("n", (8, 16, 32))
@pytest.mark.parametrize("bits", (8, 10))
def test_me_size_windowed_matches_reference(bits, n, refuse_uint16_reads):
    """me_size_windowed at the reference's test shape (64x96, pad 20,
    lam 20, radius 6): MVs, costs and predictions equal the reference's,
    exactly, at 8 and 10 bits, on seeds that reach the clamps; pred is
    the port's mc_block_batch at the returned MV; the int search's kernel
    arguments are the 8/16/32-block ones (lead 0, side 13). Integers
    throughout."""
    from x265_tpu_torch.ops.interp import mc_block_batch
    h, w, pad, lam = 64, 96, 20, 20
    cur = np.roll(_me_plane(h, w, 2, bits), 3, axis=1).astype(np.int32)
    ref_y = _me_plane(h, w, 2, bits)
    dt = np.uint8 if bits == 8 else np.uint16
    b = (h // n) * (w // n)
    seeds = np.random.default_rng(n + bits).integers(-8, 9, (b, 2))
    seeds[:3] = [[-60, 0], [0, 70], [40, -40]]          # clamped
    seeds = seeds.astype(np.int32)
    ref_pad = np.pad(ref_y.astype(dt), pad, mode="edge")
    want = jax.jit(ref.me_size_windowed,
                   static_argnames=("n", "radius", "bit_depth", "pad"))(
        jnp.asarray(cur), jnp.asarray(ref_pad), jnp.asarray(seeds),
        jnp.int32(lam), n=n, pad=pad, bit_depth=bits)
    tpad = torch.from_numpy(ref_pad.astype(np.int16) if bits == 10
                            else ref_pad)
    tpad = tpad.view(torch.uint16) if bits == 10 else tpad
    got = port.me_size_windowed(torch.from_numpy(cur), tpad,
                                torch.from_numpy(seeds), lam, n, pad=pad,
                                bit_depth=bits)
    for k, (wt, g) in enumerate(zip(want, got)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(wt), g.numpy(),
                                      err_msg=f"output {k}")
    y0s = torch.arange(h // n, dtype=torch.int32).repeat_interleave(
        w // n) * n
    x0s = torch.arange(w // n, dtype=torch.int32).repeat(h // n) * n
    plane = tpad[pad:pad + h, pad:pad + w]
    mc = mc_block_batch(plane, x0s, y0s, got[0][:, 0], got[0][:, 1], n,
                        bit_depth=bits)
    assert torch.equal(mc, got[2])


def test_me_size_windowed_penalty_is_the_float_form():
    """The integer bit length me_size_windowed's penalties use equals the
    reference's float32 2 ceil(log2(|v| + 1)) + 1 for every quarter-pel
    |v| its padded planes admit up to a 4096-wide frame, powers of two
    and their neighbours included."""
    from x265_tpu_torch.ops.me import bitlen
    v = np.arange(0, 4 * (4096 + 2 * 32 + 8) + 1, dtype=np.int32)
    want = np.asarray(
        2 * jnp.ceil(jnp.log2(jnp.asarray(v).astype(jnp.float32) + 1.0)) + 1)
    got = 2 * bitlen(torch.from_numpy(v)) + 1
    np.testing.assert_array_equal(want.astype(np.int32), got.numpy())


@pytest.mark.parametrize("bits", (8, 10))
def test_interp_ext_and_gather_zero_match_reference(bits,
                                                    refuse_uint16_reads):
    """interp_ext on block-major sub-pel windows (per-block quarter-pel
    offsets in [-3, 3]) and gather_zero equal the reference's, and
    interp_ext equals the port's mc_block_batch at mv = 4 mvi + d (the
    contract both state)."""
    from x265_tpu_torch.ops.interp import mc_block_batch
    h, w, n = 32, 64, 16
    plane = _me_plane(h, w, 5, bits)
    dt = np.uint8 if bits == 8 else np.uint16
    by, bx = h // n, w // n
    b = by * bx
    rng = np.random.default_rng(9)
    mvi = rng.integers(-3, 3, (b, 2)).astype(np.int32)
    dq = rng.integers(-3, 4, (b, 2)).astype(np.int32)
    y0 = (np.repeat(np.arange(by) * n, bx)).astype(np.int32)
    x0 = (np.tile(np.arange(bx) * n, by)).astype(np.int32)
    swin = np.asarray(ref.gather_windows(
        jnp.asarray(plane), jnp.asarray(y0 + mvi[:, 1] - 4),
        jnp.asarray(x0 + mvi[:, 0] - 4), n + 8)).astype(dt)
    want = jax.jit(ref.interp_ext, static_argnames=("n", "bit_depth"))(
        jnp.asarray(swin.astype(np.int32)), jnp.asarray(dq[:, 0] + 3),
        jnp.asarray(dq[:, 1] + 3), n=n, bit_depth=bits)
    tw = torch.from_numpy(swin.astype(np.int16) if bits == 10 else swin)
    tw = tw.view(torch.uint16) if bits == 10 else tw
    got = port.interp_ext(tw, torch.from_numpy(dq[:, 0] + 3),
                          torch.from_numpy(dq[:, 1] + 3), n, bits)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    tplane = torch.from_numpy(plane.astype(np.int16 if bits == 10 else dt))
    tplane = tplane.view(torch.uint16) if bits == 10 else tplane
    mc = mc_block_batch(tplane, torch.from_numpy(x0), torch.from_numpy(y0),
                        torch.from_numpy(mvi[:, 0] * 4 + dq[:, 0]),
                        torch.from_numpy(mvi[:, 1] * 4 + dq[:, 1]), n,
                        bit_depth=bits)
    assert torch.equal(mc, got)
    wz = ref.gather_zero(jnp.asarray(plane), jnp.asarray(y0),
                         jnp.asarray(x0), n)
    gz = port.gather_zero(tplane, torch.from_numpy(y0), torch.from_numpy(x0),
                          n)
    np.testing.assert_array_equal(np.asarray(wz), gz.numpy())


@pytest.mark.parametrize("bits", (8, 10))
@pytest.mark.parametrize("is_luma,n", [(True, 8), (True, 16), (False, 4),
                                       (False, 8)])
def test_mc_block_batch_ds_matches_reference(is_luma, n, bits,
                                             refuse_uint16_reads):
    """mc_block_batch_ds (the patches through the window gather) equals
    the reference's and the port's mc_block_batch, luma and chroma, at 8
    and 10 bits, on MVs up to 5 samples with every fractional phase."""
    from x265_tpu_torch.ops.interp import mc_block_batch
    h, w, pad = 48, 64, 16
    plane = _me_plane(h, w, 4, bits)
    dt = np.uint8 if bits == 8 else np.uint16
    by, bx = h // n, w // n
    b = by * bx
    rng = np.random.default_rng(11 + n)
    unit = 4 if is_luma else 8
    mvx = rng.integers(-5 * unit, 5 * unit, b).astype(np.int32)
    mvy = rng.integers(-5 * unit, 5 * unit, b).astype(np.int32)
    y0 = (np.repeat(np.arange(by) * n, bx)).astype(np.int32)
    x0 = (np.tile(np.arange(bx) * n, by)).astype(np.int32)
    ref_pad = np.pad(plane.astype(dt), pad, mode="edge")
    want = jax.jit(ref.mc_block_batch_ds,
                   static_argnames=("pad", "n", "is_luma", "bit_depth"))(
        jnp.asarray(ref_pad), pad, jnp.asarray(x0), jnp.asarray(y0),
        jnp.asarray(mvx), jnp.asarray(mvy), n, is_luma=is_luma,
        bit_depth=bits)
    tpad = torch.from_numpy(ref_pad.astype(np.int16) if bits == 10
                            else ref_pad)
    tpad = tpad.view(torch.uint16) if bits == 10 else tpad
    args = (torch.from_numpy(x0), torch.from_numpy(y0),
            torch.from_numpy(mvx), torch.from_numpy(mvy), n)
    got = port.mc_block_batch_ds(tpad, pad, *args, is_luma=is_luma,
                                 bit_depth=bits)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    mc = mc_block_batch(tpad[pad:pad + h, pad:pad + w], *args,
                        is_luma=is_luma, bit_depth=bits)
    assert torch.equal(mc, got)


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


@functools.lru_cache(maxsize=None)
def _search_inputs(weighted, seed=3):
    """The reference's own search inputs at 64x96, me_range 10 (made
    once per module for each (weighted, seed), read only): its
    16-region windows (gather_windows_ds at clamped random seeds), the
    8-block windows cut from them as its me_all_sizes cuts them, the
    32-block windows, and the search plane (weight-compensated by the
    reference's inverse_weight_plane under weightp). Penalties are
    random, small enough that cost ties occur."""
    cur, ref_y, _, _ = _planes(seed=seed)
    h, w = cur.shape
    r, pad = 10, 28
    side = 2 * r + 1
    rng = np.random.default_rng(seed)
    ref_pad = jnp.asarray(np.pad(ref_y.astype(np.uint8), pad, mode="edge"))
    plane = cur
    if weighted:
        plane = np.asarray(ref.inverse_weight_plane(
            jnp.asarray(cur), jnp.int32(70), jnp.int32(-3), 6, 8))
    wins = {}
    for n in (16, 32):
        by, bx = h // n, w // n
        y0 = np.repeat(np.arange(by) * n, bx)
        x0 = np.tile(np.arange(bx) * n, by)
        sy = np.clip(rng.integers(-14, 15, by * bx), -(y0 + r + 4),
                     h - n - y0 + r + 4)
        sx = np.clip(rng.integers(-14, 15, by * bx), -(x0 + r + 4),
                     w - n - x0 + r + 4)
        wins[n] = np.asarray(ref.gather_windows_ds(
            ref_pad, pad, jnp.asarray((y0 + sy - r - 4).astype(np.int32)),
            jnp.asarray((x0 + sx - r - 4).astype(np.int32)),
            n + 2 * r + 8))
    by16, bx16 = h // 16, w // 16
    s = wins[16].shape[-1]
    w16r = wins[16].reshape(by16, bx16, s, s)
    wins[8] = np.stack([np.stack([w16r[:, :, 8 * jj:8 * jj + s - 8,
                                       8 * ii:8 * ii + s - 8]
                                  for ii in (0, 1)], axis=2)
                        for jj in (0, 1)], axis=1).reshape(-1, s - 8, s - 8)
    pens = {n: rng.integers(0, 40, (2, side, (h // n) * (w // n)))
            .astype(np.int32) for n in (8, 16, 32)}
    return plane.astype(np.int32), wins, pens, side


def _lanes_np(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(1, 3, 0, 2) \
        .reshape(n, n, -1).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("weighted", (False, True))
def test_int_search_pair_windows_matches_reference(weighted):
    """The joint 8/16 search over the region windows equals the
    reference's int_search_vec_pair on its own 8-block windows and
    lanes, exactly."""
    plane, wins, pens, side = _search_inputs(weighted)
    h, w = plane.shape
    (px8, py8), (px16, py16) = pens[8], pens[16]
    (jc8, ji8), (jc16, ji16) = ref.int_search_vec_pair(
        jnp.asarray(wins[8].transpose(1, 2, 0)),
        jnp.asarray(_lanes_np(plane, 8)), *map(jnp.asarray,
                                               (px8, py8, px16, py16)),
        h // 8, w // 8, side, lead=4)
    (tc8, ti8), (tc16, ti16) = port.int_search_pair_windows(
        *_t(wins[16], plane, px8, py8, px16, py16), h // 16, w // 16, side,
        lead=4)
    for want, got in ((jc8, tc8), (ji8, ti8), (jc16, tc16), (ji16, ti16)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("lead", (0, 4))
@pytest.mark.parametrize("n", (8, 16, 32))
@pytest.mark.parametrize("weighted", (False, True))
def test_int_search_windows_matches_reference(weighted, n, lead):
    """The single search over its windows (int_search_windows, on the
    CPU its plain version int_search_windows_plain) equals the
    reference's int_search_vec on its lanes, exactly, for 8-, 16- and
    32-blocks at lead 4 (me_all_sizes' windows) and lead 0
    (me_size_windowed's): the 8-block windows cut from the 16-region
    ones, the 16-region windows, the 32-block windows."""
    plane, wins, pens, side = _search_inputs(weighted, seed=4)
    px, py = pens[n]
    jc, ji = ref.int_search_vec(
        jnp.asarray(wins[n].transpose(1, 2, 0)),
        jnp.asarray(_lanes_np(plane, n)), jnp.asarray(px), jnp.asarray(py),
        n, side, lead=lead)
    tc, ti = port.int_search_windows(*_t(wins[n], plane, px, py), n, side,
                                     lead=lead)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_int_search_wrappers_tie_on_index_0():
    """A flat window and flat penalties tie every candidate: the 8-,
    16- and 32-blocks all return index 0 and the flat SAD."""
    side, h, w = 21, 64, 96
    plane = torch.full((h, w), 200, dtype=torch.int32)
    pen = {n: torch.full((side, (h // n) * (w // n)), 5, dtype=torch.int32)
           for n in (8, 16, 32)}
    w16 = torch.full(((h // 16) * (w // 16), 44, 44), 3, dtype=torch.uint8)
    (c8, i8), (c16, i16) = port.int_search_pair_windows(
        w16, plane, pen[8], pen[8], pen[16], pen[16], h // 16, w // 16, side)
    w32 = torch.full(((h // 32) * (w // 32), 60, 60), 3, dtype=torch.uint8)
    c32, i32 = port.int_search_windows(w32, plane, pen[32], pen[32], 32, side)
    for n, c, i in ((8, c8, i8), (16, c16, i16), (32, c32, i32)):
        assert set(i.tolist()) == {0}
        assert set(c.tolist()) == {197 * n * n + 10}


def test_int_search_wrappers_reject_bad_inputs():
    side, h, w = 21, 64, 96
    plane = torch.zeros((h, w), dtype=torch.int32)
    p8 = torch.zeros((side, 96), dtype=torch.int32)
    p16 = torch.zeros((side, 24), dtype=torch.int32)
    p32 = torch.zeros((side, 6), dtype=torch.int32)
    w16 = torch.zeros((24, 44, 44), dtype=torch.uint8)
    w32 = torch.zeros((6, 60, 60), dtype=torch.uint8)

    def pair(**kw):
        a = dict(w16=w16, cur_plane=plane, penx8=p8, peny8=p8, penx16=p16,
                 peny16=p16, by16=4, bx16=6, side=side)
        a.update(kw)
        return port.int_search_pair_windows(**a)

    def single(**kw):
        a = dict(w=w32, cur_plane=plane, penx=p32, peny=p32, n=32,
                 side=side)
        a.update(kw)
        return port.int_search_windows(**a)

    pair()
    single()
    # uint16 windows (10-bit) search, and equal the plain versions
    rng = np.random.default_rng(19)
    w16u, w32u = (torch.from_numpy(rng.integers(0, 1024, shp)
                                   .astype(np.int16)).view(torch.uint16)
                  for shp in ((24, 44, 44), (6, 60, 60)))
    cur10 = torch.from_numpy(rng.integers(0, 1024, (h, w)).astype(np.int32))
    got = pair(w16=w16u, cur_plane=cur10)
    want = port.int_search_pair_windows_plain(w16u, cur10, p8, p8, p16, p16,
                                              4, 6, side)
    for g, wt in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(g, wt)
    got = single(w=w32u, cur_plane=cur10)
    want = port.int_search_windows_plain(w32u, cur10, p32, p32, 32, side)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="one device"):
        pair(cur_plane=plane.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        single(penx=p32.to("meta"))
    bad_shapes = [
        lambda: pair(w16=w16[:23]),                  # not the region grid
        lambda: pair(cur_plane=plane[:48]),
        lambda: pair(penx8=p16),                     # 8-block penalties
        lambda: pair(w16=w16[:, :36, :36]),          # window too small
        lambda: pair(cur_plane=plane.long()),
        lambda: pair(w16=w16.to(torch.int16)),       # not a sample type
        lambda: single(w=w32[:5]),
        lambda: single(n=24, cur_plane=torch.zeros((48, 96), dtype=torch.int32)),
        lambda: single(n=16),                        # 24 16-blocks, not 6
        lambda: single(peny=p32[:20]),
        lambda: single(w=w32.reshape(6, 3600)),
    ]
    for call in bad_shapes:
        with pytest.raises(ValueError):
            call()


def test_gather_windows_rejects_bad_inputs():
    src = torch.zeros((40, 40), dtype=torch.uint8)
    ys = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        port.gather_windows(src.to(torch.int32), ys, ys, 8)
    with pytest.raises(ValueError):
        port.gather_windows(src, ys.long(), ys.long(), 8)
    with pytest.raises(ValueError):
        port.gather_windows(src, ys, ys, 41)


def test_sass_check_holds_the_main_path_instances(monkeypatch):
    """chip_smoke.check_main_path_sass on a stand-in for the kernels
    module (a real listing needs nvcc and cuobjdump): it hashes
    the pair and 32-block instances only (not the 8- and 16-block
    kernel, nor another function), passes when every hash equals
    PARENT_SASS, and fails naming an instance whose opcodes, or whose
    modifiers alone, changed, one that is missing and one that is
    new."""
    import chip_smoke as cs

    committed = cs.PARENT_SASS
    base = {
        "void (anonymous namespace)::int_search_kernel<16, true, 5, 1>"
        "(unsigned char const*)": ["LDS.128", "VABSDIFF4.U8.ACC", "EXIT"],
        "void (anonymous namespace)::int_search_kernel<32, false, 13, 2>"
        "(unsigned char const*)": ["VIMNMX.U16x2", "IMAD", "EXIT"],
        "void (anonymous namespace)::int_search_small_kernel<8, 13, 1>"
        "(unsigned char const*)": ["VABSDIFF4.U8.ACC", "EXIT"],
        "void gather_windows_kernel<1>(unsigned char const*)": ["EXIT"]}

    class Kernels:
        def __init__(self, listing):
            self.listing = listing

        def sass_opcodes(self, name, full=False, so=None):
            assert name == "int_search"
            return {f: ops if full else [o.split(".")[0] for o in ops]
                    for f, ops in self.listing.items()}

    want = cs.sass_hashes(Kernels(base))
    assert sorted(want) == ["int_search_kernel<16, true, 5, 1>",
                            "int_search_kernel<32, false, 13, 2>"]
    monkeypatch.setattr(cs, "PARENT_SASS", want)
    assert cs.check_main_path_sass(Kernels(base)) == want
    pair = next(f for f in base if "16, true" in f)
    for listing, bad in (
            ({**base, pair: ["LDS.128", "IADD3", "EXIT"]}, "16, true"),
            ({**base, pair: ["LDS.64", "VABSDIFF4.U8.ACC", "EXIT"]},
             "16, true"),
            ({f: o for f, o in base.items() if f != pair}, "16, true"),
            ({**base, pair.replace("5, 1", "6, 1"): ["EXIT"]}, "6, 1")):
        with pytest.raises(AssertionError, match=bad):
            cs.check_main_path_sass(Kernels(listing))
    # the committed record: every pair and 32-block instance the search
    # compiles (R of PairR, SingleR1 and SingleR2), both hashes each
    assert sorted(committed) == sorted(
        [f"int_search_kernel<16, true, {r}, {kb}>" for r in (1, 5, 6, 7)
         for kb in (1, 2)] +
        [f"int_search_kernel<32, false, {r}, 1>" for r in (1, 5, 7, 13)] +
        [f"int_search_kernel<32, false, {r}, 2>" for r in (1, 5, 6, 7)])
    assert all(sorted(v) == ["full", "ops"] for v in committed.values())


def test_walk_issue_counts_the_walks_alu_instructions():
    """chip_smoke.walk_pipes sorts a walk's opcodes by pipe, and
    walk_issue gives the time an 8- or 16-block call's walks take at a
    measured ALU rate: tasks x walks a lane x the walk's ALU
    instructions, over every SM."""
    from collections import Counter

    import chip_smoke as cs

    pipes = cs.walk_pipes(Counter({"VABSDIFF4": 10, "SHF": 4, "IMAD": 3,
                                   "LDS": 5, "REDUX": 1, "BRA": 1}))
    assert pipes == {"alu": 14, "fma": 3, "mem": 6, "other": 1}
    walks = {"int_search_small_kernel<8, 13, 1>": pipes,
             "int_search_small_kernel<16, 13, 2>": pipes,
             "int_search_small_kernel<8, 5, 1>": pipes}
    # side 13 at R 13: 13 items on 13 lanes, one walk a lane; 100 tasks
    # at 2 warp instructions a clock (64 lanes) on 2 SMs at 1 GHz
    geo = {"R": 13, "lanes_a_unit": 13, "tasks": 100}
    got = cs.walk_issue(geo, 8, 13, 1, walks, 64.0, 2, 1e9, 0.001)
    assert got["instance"] == "int_search_small_kernel<8, 13, 1>"
    assert got["alu_warp_instructions"] == 1400
    assert got["alu_ms"] == pytest.approx(1400 / 4e9 * 1e3)
    assert got["alu_share"] == pytest.approx(0.35)
    # 2 lanes a candidate at 10 bits and n = 16: 26 lanes, one walk each
    geo16 = {"R": 13, "lanes_a_unit": 26, "tasks": 100}
    assert cs.walk_issue(geo16, 16, 13, 2, walks, 64.0, 2, 1e9,
                         1.0)["walk_alu_per_task"] == 14
    # side 25 at R 5: 125 items on 25 lanes, 5 walks a lane
    geo5 = {"R": 5, "lanes_a_unit": 25, "tasks": 10}
    assert cs.walk_issue(geo5, 8, 25, 1, walks, 64.0, 2, 1e9,
                         1.0)["walk_alu_per_task"] == 70
    assert cs.walk_issue(geo, 8, 13, 1, {}, 64.0, 2, 1e9, 1.0) is None
