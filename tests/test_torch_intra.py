"""Port parity: the I-frame path of x265_tpu_torch (luma + chroma intra
analysis, the wavefront reconstruction, the intra deblock) against
x265_tpu at 64x96 on the same numpy frame. Tolerance: exact equality of
every decision field, coefficient plane and recon sample."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.enc import intra_analysis as ref_an
from x265_tpu.enc.intra_recon_tpu import reconstruct_intra_gop_tpu
from x265_tpu.ops.deblock import deblock_frame as ref_deblock
from x265_tpu_torch.common.params import EncoderConfig
from x265_tpu_torch.enc import intra_analysis as port_an
from x265_tpu_torch.enc.intra_recon_gpu import reconstruct_intra_gop_gpu
from x265_tpu_torch.ops.deblock import deblock_frame as port_deblock

torch.set_num_threads(2)

QP = 29          # the main path's I-frame QP offset (qp - 3) at CQP 32


def _frame(h=64, w=96, seed=11):
    """The first frame of tests/test_pipelined.py, with textured chroma
    so the chroma mode decision has something to choose."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    y = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255).astype(np.uint8)
    cb = np.clip(120 + ((xx[::2, ::2] * yy[::2, ::2]) >> 5) % 40, 0, 255) \
        .astype(np.uint8)
    cr = np.clip(132 - (yy[::2, ::2] >> 1) + (xx[::2, ::2] % 7), 0, 255) \
        .astype(np.uint8)
    return y, cb, cr


def test_intra_frame_matches_reference():
    y, cb, cr = _frame()
    h, w = y.shape
    d8, m8, nx8, m4 = ref_an.analyze_intra_gop(y[None], QP, 32, 8,
                                               intra_nxn=True)
    td8, tm8, tnx8, tm4 = port_an.analyze_intra_gop(
        torch.from_numpy(y)[None], QP, 32, 8, intra_nxn=True)
    for a, b in ((d8, td8), (m8, tm8), (nx8, tnx8), (m4, tm4)):
        np.testing.assert_array_equal(a, b.numpy())
    assert nx8.any() and (d8 < 2).any()       # NxN and 16/32 CUs occur

    c8 = ref_an.analyze_chroma_gop(cb[None], cr[None], d8, m8, QP, 8)
    tc8 = port_an.analyze_chroma_gop(torch.from_numpy(cb)[None],
                                     torch.from_numpy(cr)[None], td8, tm8,
                                     QP, 8)
    np.testing.assert_array_equal(c8, tc8.numpy())
    assert (c8 != m8).any()                   # non-DM chroma modes occur

    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    cfg = EncoderConfig(width=w, height=h, qp=32, deblock=True)
    syns, recons = reconstruct_intra_gop_tpu(
        y[None], cb[None], cr[None], d8, m8, rcfg, QP, cmode8=c8, nxn8=nx8,
        mode4=m4)
    tsyns, (ry, rcb, rcr) = reconstruct_intra_gop_gpu(
        torch.from_numpy(y)[None], torch.from_numpy(cb)[None],
        torch.from_numpy(cr)[None], d8, m8, cfg, QP, cmode8=c8, nxn8=nx8,
        mode4=m4)
    for k in ("coeff_y", "coeff_cb", "coeff_cr"):
        np.testing.assert_array_equal(getattr(syns[0], k),
                                      getattr(tsyns[0], k), err_msg=k)
    for a, b in ((recons[0].y, ry[0]), (recons[0].cb, rcb[0]),
                 (recons[0].cr, rcr[0])):
        np.testing.assert_array_equal(a, b.numpy())
    # the GPU's fixed launch sequence (padded lanes, no skipped steps),
    # run eagerly here, gives the same frame
    fsyns, fplanes = reconstruct_intra_gop_gpu(
        torch.from_numpy(y)[None], torch.from_numpy(cb)[None],
        torch.from_numpy(cr)[None], d8, m8, cfg, QP, cmode8=c8, nxn8=nx8,
        mode4=m4, fixed_steps=True)
    for k in ("coeff_y", "coeff_cb", "coeff_cr"):
        np.testing.assert_array_equal(getattr(syns[0], k),
                                      getattr(fsyns[0], k), err_msg=k)
    for a, b in zip((ry, rcb, rcr), fplanes):
        assert torch.equal(a, b)

    want = ref_deblock(jnp.asarray(recons[0].y), jnp.asarray(recons[0].cb),
                       jnp.asarray(recons[0].cr), d8[0], 32, QP, 8)
    got = port_deblock(ry[0], rcb[0], rcr[0], td8[0], 32, QP, 8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_substitution_and_single_mode_prediction():
    """Reference substitution and single-mode prediction on random refs
    with random availability (every mode, luma and chroma sizes)."""
    from x265_tpu.enc.intra_recon_tpu import _substitute as ref_sub
    from x265_tpu.ops.intra import intra_pred_single_mode as ref_pred
    from x265_tpu_torch.enc.intra_recon_gpu import _substitute as port_sub
    from x265_tpu_torch.ops.intra import intra_pred_single_mode as port_pred
    rng = np.random.default_rng(4)
    for n, luma in ((4, True), (8, True), (16, True), (32, True), (4, False),
                    (16, False)):
        b = 70
        refs = rng.integers(0, 256, (b, 4 * n + 1)).astype(np.int32)
        avail = rng.random((b, 4 * n + 1)) < 0.6
        avail[0] = False
        modes = (np.arange(b) % 35).astype(np.int32)
        # the reference jitted: one compile per size instead of hundreds
        # of eager ones (integer arithmetic: the same values)
        sj = jax.jit(ref_sub, static_argnums=2)(jnp.asarray(refs),
                                                jnp.asarray(avail), 8)
        st = port_sub(torch.from_numpy(refs), torch.from_numpy(avail), 8)
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        pj = jax.jit(functools.partial(ref_pred, n=n, is_luma=luma))(
            sj, jnp.asarray(modes))
        pt = port_pred(st, torch.from_numpy(modes), n, is_luma=luma)
        np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
