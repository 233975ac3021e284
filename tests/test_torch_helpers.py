"""Port parity for the reference functions that only its own tests and
tools call: the intra analysis above CTU 32 (analyze_intra_frame's SATD
branch with gather_refs_orig, _mode_costs and analyze_size_device),
the single-frame device intra recon (reconstruct_intra_frame_gpu), the
numpy SATD helpers, the compact CG-row download (fetch_rows), the
native coder's expand_cgs and intra-slice entry points, and
make_contexts. Same seeded numpy inputs through both packages; every
output is an integer (or a float64 cost built from integer SATDs) and
is held exactly. The reference runs on the CPU as its own tests run
it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_intra_e2e import synth_frame
from x265_tpu.enc import intra_analysis as ref_ia

torch.set_num_threads(2)

# (w, h) of the analysis planes; 72x40 is ragged against every CU size
# above 8
ANALYSIS_SHAPES = ((96, 64), (40, 72))


def _analysis_plane(w, h, bits):
    """test_intra_e2e's synthetic luma (gradients, an edge, noise) with a
    flat area, so that some 32x32 CU stays whole; at 10 bits lifted
    with 2 low bits of noise."""
    y, _, _ = synth_frame(w, h, seed=w + h)
    y = y.astype(np.int32)
    y[24:64, 24:72] = 100
    if bits == 10:
        rng = np.random.default_rng(w)
        y = y * 4 + rng.integers(0, 4, y.shape)
    return y


def _port_plane(y, bits):
    if bits == 8:
        return torch.from_numpy(y.astype(np.uint8))
    return torch.from_numpy(y.astype(np.int16)).view(torch.uint16)


@pytest.mark.parametrize("nxn", (False, True))
@pytest.mark.parametrize("bits", (8, 10))
@pytest.mark.parametrize("shape", ANALYSIS_SHAPES)
def test_analyze_intra_frame_above_ctu32_matches_reference(shape, bits, nxn):
    """analyze_intra_frame with ctu_size > 32 takes the reference's SATD
    branch in both packages. At ctu_size 64 the reference raises
    KeyError at its 64 size (intra_filter_flag has no 64x64 row: H.265
    has no 64x64 intra TU), after the 4-32 sizes; the port raises the
    same, where it used to return the CTU-32 analysis. At ctu_size 48
    the branch runs to its end over the sizes 8-32 (4 with NxN): the
    depth choice and the maps equal the reference's exactly."""
    from x265_tpu_torch.enc import intra_analysis as port_ia
    w, h = shape
    y = _analysis_plane(w, h, bits)
    qp = 30
    for pkg, arg in ((ref_ia, y), (port_ia, _port_plane(y, bits))):
        with pytest.raises(KeyError):
            pkg.analyze_intra_frame(arg, qp, 64, bits, intra_nxn=nxn)
    want = ref_ia.analyze_intra_frame(y, qp, 48, bits, intra_nxn=nxn)
    got = port_ia.analyze_intra_frame(_port_plane(y, bits), qp, 48, bits,
                                      intra_nxn=nxn)
    for name, wt, g in zip(("depth8", "mode8", "nxn8", "mode4"), want, got):
        assert g.dtype == wt.dtype, name
        np.testing.assert_array_equal(wt, g, err_msg=name)
    assert 2 in got[0] and (0 in got[0] or w < 64)   # 32x32 and 8x8 CUs
    assert got[2].any() == nxn


@pytest.mark.parametrize("bits", (8, 10))
def test_analyze_size_device_and_its_pieces_match_reference(bits):
    """analyze_size_device (the reference's __graft_entry__ flagship) at
    n = 4, 8, 16 and 32 on a 64x96 plane: modes and integer costs equal,
    as are gather_refs_orig and _mode_costs under it; at n = 64 both
    raise KeyError (no 64x64 intra prediction)."""
    from x265_tpu_torch.enc import intra_analysis as port_ia
    y = _analysis_plane(96, 64, bits)
    lam_bits = np.round(30.0 * ref_ia._MODE_BITS).astype(np.int32)
    tplane = torch.from_numpy(y.astype(np.int32))
    tlam = torch.from_numpy(lam_bits)
    for n in (4, 8, 16, 32):
        wm, wc = ref_ia.analyze_size_device(jnp.asarray(y), n,
                                            jnp.asarray(lam_bits), bits)
        gm, gc = port_ia.analyze_size_device(tplane, n, tlam, bits)
        np.testing.assert_array_equal(np.asarray(wm), gm.numpy())
        np.testing.assert_array_equal(np.asarray(wc), gc.numpy())
        refs = ref_ia.gather_refs_orig(y, n)
        np.testing.assert_array_equal(refs, port_ia.gather_refs_orig(y, n))
        blocks = ref_ia.extract_blocks(jnp.asarray(y), n)
        wm2, wc2 = ref_ia._mode_costs(blocks, jnp.asarray(refs), n,
                                      jnp.asarray(lam_bits), bits)
        gm2, gc2 = port_ia._mode_costs(
            torch.from_numpy(np.array(blocks)), torch.from_numpy(refs), n,
            tlam, bits)
        np.testing.assert_array_equal(np.asarray(wm2), gm2.numpy())
        np.testing.assert_array_equal(np.asarray(wc2), gc2.numpy())
    # a corner plane whose refs need substitution from the far side
    for n in (8, 16):
        edge = y[:n, :n]
        np.testing.assert_array_equal(ref_ia.gather_refs_orig(edge, n),
                                      port_ia.gather_refs_orig(edge, n))
    y64 = np.pad(y, ((0, 0), (0, 32)), mode="edge")    # 64x128
    for call in (lambda: ref_ia.analyze_size_device(
                     jnp.asarray(y64), 64, jnp.asarray(lam_bits), bits),
                 lambda: port_ia.analyze_size_device(
                     torch.from_numpy(y64), 64, tlam, bits)):
        with pytest.raises(KeyError):
            call()


@pytest.mark.parametrize("w,h,qp", [(64, 64, 32), (96, 64, 26),
                                    (72, 40, 37)])
def test_reconstruct_intra_frame_gpu_matches_reference(w, h, qp):
    """reconstruct_intra_frame_gpu at tests/test_intra_recon_tpu.py's
    shapes, QPs and frames, on the port's analysis of them (the analysis
    is held against the reference's in tests/test_torch_intra.py): every
    coefficient and recon sample equal to the reference's host oracle
    reconstruct_intra_frame, which that test holds equal to
    reconstruct_intra_frame_tpu (whose wavefront program takes 15-50 s a
    shape to load or compile); a (FrameIntraSyntax, ReconFrame) pair.
    Then the I slice through both packages' encode_intra_slice_native
    and expand_cgs_native on those coefficients."""
    from x265_tpu.common.params import EncoderConfig as RefConfig
    from x265_tpu.enc.encoder import pad_plane
    from x265_tpu.enc.intra_recon import reconstruct_intra_frame
    from x265_tpu.native import entropy_native as ref_native
    from x265_tpu.bitstream.ctx_tables import init_states as ref_states
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc.intra_analysis import analyze_intra_frame
    from x265_tpu_torch.enc.intra_recon import ReconFrame
    from x265_tpu_torch.enc.intra_recon_gpu import reconstruct_intra_frame_gpu
    from x265_tpu_torch.native import entropy_native as port_native
    from x265_tpu_torch.bitstream.ctx_tables import init_states
    from x265_tpu_torch.bitstream.syntax import FrameIntraSyntax
    rcfg = RefConfig(width=w, height=h, qp=qp)
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    y, cb, cr = synth_frame(w, h, seed=w + qp)
    hp, wp = cfg.height_padded, cfg.width_padded
    planes = (pad_plane(y, hp, wp), pad_plane(cb, hp // 2, wp // 2),
              pad_plane(cr, hp // 2, wp // 2))
    tplanes = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
    depth8, mode8, _, _ = analyze_intra_frame(tplanes[0], qp, 32, 8)
    syn, rec = reconstruct_intra_frame_gpu(*tplanes, depth8, mode8, cfg)
    assert isinstance(syn, FrameIntraSyntax) and isinstance(rec, ReconFrame)
    syn_r, rec_r = reconstruct_intra_frame(*planes, depth8, mode8, rcfg)
    for k in ("coeff_y", "coeff_cb", "coeff_cr", "depth8", "mode8"):
        np.testing.assert_array_equal(getattr(syn_r, k), getattr(syn, k),
                                      err_msg=k)
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(rec_r, k), getattr(rec, k),
                                      err_msg=k)
    args = (syn.depth8, syn.mode8, syn.coeff_y, syn.coeff_cb, syn.coeff_cr,
            wp, hp, 5, 3)
    want = ref_native.encode_intra_slice_native(*args, ref_states(2, qp))
    got = port_native.encode_intra_slice_native(*args, init_states(2, qp))
    assert want == got and len(got[0]) > 0
    # the coefficient planes as nonzero 4x4 CG rows, scattered back
    ncx = wp // 4
    cgs = syn.coeff_y.reshape(hp // 4, 4, ncx, 4).transpose(0, 2, 1, 3) \
        .reshape(-1, 16)
    idx = np.flatnonzero(np.any(cgs != 0, axis=1)).astype(np.int32)
    for oh, ow in ((hp, wp), (hp - 8, wp - 4)):
        wt = ref_native.expand_cgs_native(cgs[idx], idx, ncx, oh, ow)
        g = port_native.expand_cgs_native(cgs[idx], idx, ncx, oh, ow)
        np.testing.assert_array_equal(wt, g)
    np.testing.assert_array_equal(
        port_native.expand_cgs_native(cgs[idx], idx, ncx, hp, wp),
        syn.coeff_y)


def test_satd_numpy_helpers_match_reference():
    """satd4_np, sa8d_np, sa8d_block_np (n = 8, 16, 32) and
    _sa8d_kron_np (n = 4-32) equal the reference's, on random 10-bit
    blocks and on the extremes (0 against 1023)."""
    from x265_tpu.ops import satd as ref_satd
    from x265_tpu_torch.ops import satd as port_satd
    rng = np.random.default_rng(17)
    for trial in range(6):
        hi = 1024 if trial % 2 else 256
        for n in (4, 8, 16, 32):
            if trial == 5:
                a, b = np.zeros((n, n), np.int64), np.full((n, n), 1023)
            else:
                a, b = rng.integers(0, hi, (2, n, n))
            if n == 4:
                assert ref_satd.satd4_np(a, b) == port_satd.satd4_np(a, b)
            if n == 8:
                assert ref_satd.sa8d_np(a, b) == port_satd.sa8d_np(a, b)
            if n >= 8:
                assert ref_satd.sa8d_block_np(a, b) == \
                    port_satd.sa8d_block_np(a, b)
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(ref_satd._sa8d_kron_np(n),
                                      port_satd._sa8d_kron_np(n))
        assert port_satd._sa8d_kron_np(n).dtype == np.float32
    # and the numpy forms agree with the port's batched SA8D
    a = rng.integers(0, 1024, (3, 16, 16))
    b = rng.integers(0, 1024, (3, 16, 16))
    batch = port_satd.sa8d_nxn_batch(torch.from_numpy(a - b).to(torch.int32),
                                     16)
    assert batch.tolist() == [port_satd.sa8d_block_np(x, z)
                              for x, z in zip(a, b)]


@pytest.mark.parametrize("t", (0, 1, 2, 3, 5, 17, 64, 65))
def test_fetch_rows_matches_reference(t):
    """fetch_rows downloads exactly the requested CG rows (any count,
    padded to the reference's power-of-two buckets), as the reference's
    does."""
    from x265_tpu.ops.compact import fetch_rows as ref_fetch
    from x265_tpu_torch.ops.compact import fetch_rows
    rng = np.random.default_rng(t)
    cg = rng.integers(-300, 300, (200, 16)).astype(np.int16)
    idx = rng.choice(200, t, replace=False).astype(np.int32)
    want = ref_fetch(jnp.asarray(cg), idx)
    got = fetch_rows(torch.from_numpy(cg), idx)
    assert got.dtype == want.dtype and got.shape == want.shape == (t, 16)
    np.testing.assert_array_equal(want, got)


def test_make_contexts_matches_reference():
    """make_contexts: the fresh context states of every slice type at
    every QP equal the reference's and init_states'."""
    from x265_tpu.bitstream.ctx_tables import make_contexts as ref_make
    from x265_tpu_torch.bitstream.cabac import ContextSet
    from x265_tpu_torch.bitstream.ctx_tables import init_states, \
        make_contexts
    for st in range(3):
        for qp in range(0, 52, 3):
            got = make_contexts(st, qp)
            assert isinstance(got, ContextSet)
            np.testing.assert_array_equal(ref_make(st, qp).states,
                                          got.states)
            np.testing.assert_array_equal(init_states(st, qp), got.states)
