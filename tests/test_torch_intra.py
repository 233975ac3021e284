"""Port parity: the I-frame path of x265_tpu_torch (luma + chroma intra
analysis, the wavefront reconstruction of a batch of two frames, the
intra deblock, encode_gop) against x265_tpu at 64x96 on the same numpy
frames. Tolerance: exact equality of
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
from test_torch_fma import assert_same_bits, float_comparison_operands
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


def _frames():
    """Two frames (a batch of two through the wavefront, as encode_gop
    runs it): the test frame and one from another seed."""
    return [_frame(), _frame(seed=12)]


def test_intra_frame_matches_reference():
    """A batch of two frames: the analysis, the wavefront recon and the
    coefficient planes of both, the intra deblock of the first."""
    frames = _frames()
    y, cb, cr = (np.stack([f[k] for f in frames]) for k in range(3))
    h, w = y.shape[1:]
    d8, m8, nx8, m4 = ref_an.analyze_intra_gop(y, QP, 32, 8, intra_nxn=True)
    td8, tm8, tnx8, tm4 = port_an.analyze_intra_gop(
        torch.from_numpy(y), QP, 32, 8, intra_nxn=True)
    for a, b in ((d8, td8), (m8, tm8), (nx8, tnx8), (m4, tm4)):
        np.testing.assert_array_equal(a, b.numpy())
    assert nx8.any() and (d8 < 2).any()       # NxN and 16/32 CUs occur

    c8 = ref_an.analyze_chroma_gop(cb, cr, d8, m8, QP, 8)
    tc8 = port_an.analyze_chroma_gop(torch.from_numpy(cb),
                                     torch.from_numpy(cr), td8, tm8, QP, 8)
    np.testing.assert_array_equal(c8, tc8.numpy())
    assert (c8 != m8).any()                   # non-DM chroma modes occur

    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    cfg = EncoderConfig(width=w, height=h, qp=32, deblock=True)
    syns, recons = reconstruct_intra_gop_tpu(
        y, cb, cr, d8, m8, rcfg, QP, cmode8=c8, nxn8=nx8, mode4=m4)
    t = torch.from_numpy
    tsyns, (ry, rcb, rcr) = reconstruct_intra_gop_gpu(
        t(y), t(cb), t(cr), d8, m8, cfg, QP, cmode8=c8, nxn8=nx8, mode4=m4)
    for f in range(2):
        for k in ("coeff_y", "coeff_cb", "coeff_cr"):
            np.testing.assert_array_equal(getattr(syns[f], k),
                                          getattr(tsyns[f], k),
                                          err_msg=f"frame {f} {k}")
        for a, b in ((recons[f].y, ry[f]), (recons[f].cb, rcb[f]),
                     (recons[f].cr, rcr[f])):
            np.testing.assert_array_equal(a, b.numpy())
    # the GPU's fixed launch sequence (padded lanes, no skipped steps),
    # run eagerly here, gives the same frames
    fsyns, fplanes = reconstruct_intra_gop_gpu(
        t(y), t(cb), t(cr), d8, m8, cfg, QP, cmode8=c8, nxn8=nx8, mode4=m4,
        fixed_steps=True)
    for f in range(2):
        for k in ("coeff_y", "coeff_cb", "coeff_cr"):
            np.testing.assert_array_equal(getattr(syns[f], k),
                                          getattr(fsyns[f], k), err_msg=k)
    for a, b in zip((ry, rcb, rcr), fplanes):
        assert torch.equal(a, b)

    want = ref_deblock(jnp.asarray(recons[0].y), jnp.asarray(recons[0].cb),
                       jnp.asarray(recons[0].cr), d8[0], 32, QP, 8)
    got = port_deblock(ry[0], rcb[0], rcr[0], td8[0], 32, QP, 8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_encode_gop_matches_reference():
    """encode_gop: the two frames through one batched wavefront at
    cfg.qp (the reference's program of the test above: same batch,
    geometry and QP), deblocked, without SAO, headers before the first
    frame only; the streams and recons equal the reference's."""
    from x265_tpu.enc import IntraEncoder as RefEncoder
    from x265_tpu_torch.enc import IntraEncoder
    frames = _frames()
    h, w = frames[0][0].shape
    kw = dict(width=w, height=h, qp=QP, deblock=True)
    want = RefEncoder(RefConfig(**kw)).encode_gop(frames)
    got = IntraEncoder(EncoderConfig(**kw), device="cpu").encode_gop(frames)
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        assert a.bitstream == b.bitstream
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a.recon, k),
                                          getattr(b.recon, k))
    assert len(got[1].bitstream) < len(got[0].bitstream) - 40


def test_intra_analysis_costs_match_reference():
    """The I-frame analysis's float32 costs bit for bit: both operands of
    each depth comparison (NxN against 8x8, keep against split at 16 and
    32), read from the reference's jitted program, whose multiply-adds
    (the coefficient-bit proxy, SSE + lambda2 * bits) round once; on
    the test frame at QP 29 and on a noisier one at QP 37."""
    from x265_tpu_torch.common.bit_calib import calib_for_qp
    from x265_tpu_torch.common.tables import lambda_from_qp, lambda2_from_qp
    y0 = _frame()[0]
    rng = np.random.default_rng(37)
    noisy = np.clip(y0.astype(np.int32) + rng.integers(-20, 21, y0.shape) *
                    (rng.random(y0.shape) < 0.3), 0, 255).astype(np.uint8)
    for y, qp in ((y0, QP), (noisy, 37)):
        h, w = y.shape
        lam, lam2 = lambda_from_qp(qp), lambda2_from_qp(qp)
        cal = calib_for_qp(qp)
        bits = np.round(lam * ref_an._MODE_BITS).astype(np.int32)
        abc = np.asarray([float(c) for c in cal[:3]], np.float32)
        mb = ref_an._MODE_BITS.astype(np.float32)
        f32 = np.float32
        args = (y[None], bits, f32(lam2 * 4.0), f32(lam2 * 8.0), np.int32(qp),
                f32(lam2), abc, mb)
        fn = functools.partial(ref_an._analyze_gop_jit.__wrapped__, h=h, w=w,
                               ctu=32, bit_depth=8, intra_nxn=True)
        want, cmp = float_comparison_operands(
            fn, *(jnp.asarray(a) for a in args))
        costs = {}
        t = torch.from_numpy
        got = port_an._analyze_frame(
            t(y.astype(np.int32)), qp, t(bits), torch.tensor(args[2]),
            torch.tensor(args[3]), torch.tensor(args[5]), t(abc), t(mb), h=h,
            w=w, bit_depth=8, intra_nxn=True, costs=costs)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a)[0], b.numpy())
        assert len(cmp) == 6
        for k, name in enumerate(("nxn", "keep16", "keep32")):
            for side in (0, 1):
                assert_same_bits(cmp[2 * k + side][0],
                                 costs[name][side].numpy(),
                                 f"QP {qp} {name}[{side}]")


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
