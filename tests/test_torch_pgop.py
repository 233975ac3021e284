"""Port parity: one 2-frame P chunk of x265_tpu_torch.enc.pgop_gpu
against x265_tpu.enc.pgop_tpu, both predicting from the SAME reference
picture — the reference package's own I-frame reconstruction, carried
into the port by x265_tpu_torch.convert. Tolerance: exact equality of
every FramePSyntax field and recon sample."""

import dataclasses

import numpy as np
import torch

from x265_tpu.common import bit_calib as ref_calib
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu.enc.pgop_tpu import encode_pgop_tpu
from x265_tpu.enc.weightp import analyse_gop_weights
from x265_tpu_torch.common import bit_calib as port_calib
from x265_tpu_torch.convert import config_from_dict, device_ref_from_numpy
from x265_tpu_torch.common.tables import (chroma_qp, lambda_from_qp,
                                          lambda2_from_qp)
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from x265_tpu_torch.enc.pgop_gpu import collect_pgop_gpu, submit_pgop_gpu
from test_torch_fma import assert_same_bits, float_comparison_operands

torch.set_num_threads(2)

FIELDS = ("depth8", "mv8", "coeff_y", "coeff_cb", "coeff_cr", "intra8",
          "mode8", "tusplit8", "ref8", "sao_params", "qp_map", "max_merge")


def _clip(nf, h=64, w=96, seed=21):
    """A pan with a textured object entering from the right edge (new
    content, so intra competes in the P frames) and a luma fade (so the
    weightp weights are not neutral)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 5 + yy * 3) % 200 + 20).astype(np.int32)
    tex = rng.integers(0, 256, (h, w))
    frames = []
    for i in range(nf):
        y = np.roll(base, 3 * i, axis=1) + rng.integers(-5, 5, (h, w))
        edge = w - 10 * i
        y[16:48, edge:] = tex[16:48, edge:]
        y = np.clip(y * (1.0 - 0.06 * i), 0, 255).astype(np.uint8)
        cb = np.clip(110 + (xx[::2, ::2] >> 3) + 2 * i, 0, 255) \
            .astype(np.uint8)
        cr = np.clip(140 - (yy[::2, ::2] >> 2), 0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def test_p_chunk_matches_reference():
    frames = _clip(3)
    h, w = frames[0][0].shape
    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    enc = RefEncoder(rcfg)
    r0 = enc.encode_frame(*frames[0], qp=29, use_device_recon=True)
    wps = analyse_gop_weights(frames[1:], frames[0])
    wvecs = np.stack([wp.vec() for wp in wps])
    assert any(wp.luma_on for wp in wps)

    def stack(k):
        return np.stack([f[k] for f in frames[1:]])

    syns, recons, _ = encode_pgop_tpu(stack(0), stack(1), stack(2),
                                      r0.device_ref, rcfg, 32,
                                      need_recon=True, me_range=rcfg.me_range,
                                      weights=wvecs)
    ref = device_ref_from_numpy(r0.recon.y, r0.recon.cb, r0.recon.cr,
                                device="cpu")
    pend = submit_pgop_gpu(stack(0), stack(1), stack(2), ref, cfg, 32,
                           need_recon=True, me_range=cfg.me_range,
                           weights=wvecs, device="cpu")
    tsyns, trecons, last = collect_pgop_gpu(pend)
    assert len(tsyns) == 2
    for i in range(2):
        for k in FIELDS:
            a, b = getattr(syns[i], k), getattr(tsyns[i], k)
            assert (a is None) == (b is None), (i, k)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"frame {i} {k}")
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(recons[i], k),
                                          getattr(trecons[i], k),
                                          err_msg=f"frame {i} recon {k}")
    # the carried reference stack holds the last recon in slot 0
    assert last.y.shape == (1, h, w)
    np.testing.assert_array_equal(last.to_recon().y, trecons[-1].y)
    # the content exercises intra-in-inter and the RQT split
    assert any(s.intra8 is not None for s in syns)
    assert any(s.tusplit8 is not None for s in syns)


def test_bit_calibration_tables_match_reference():
    """The encoder's only fitted constants are copied, not imported."""
    assert port_calib.BIT_CALIB == ref_calib.BIT_CALIB
    assert port_calib._FALLBACK == ref_calib._FALLBACK
    for qp in range(0, 52):
        assert port_calib.calib_for_qp(qp) == ref_calib.calib_for_qp(qp)


def test_intra_candidate_costs_match_reference():
    """The P scan's intra 8x8 costs bit for bit: _intra8_est's cost per
    cell (psy-rd on) and, in both waves of _intra_in_inter, the coded
    intra cost cost_a that each accepted cell must beat the inter cost
    with, read from the reference's program as the operand of that
    comparison. Both round their multiply-adds once, as the reference's
    jitted program does. Sources: the clip's third frame; the previous
    frame stands in for the inter recon."""
    import jax.numpy as jnp
    frames = _clip(3)
    qp, ctu, h, w = 32, 32, 64, 96
    oy, ocb, ocr = (frames[2][k].astype(np.int32) for k in range(3))
    ry, rcb, rcr = (frames[1][k].astype(np.int32) for k in range(3))
    lam = int(round(float(lambda_from_qp(qp))))
    lam2 = float(lambda2_from_qp(qp))
    qpc = chroma_qp(qp)
    calib = port_calib.calib_for_qp(qp)
    j, t = jnp.asarray, torch.from_numpy
    (m_r, c_r), _ = float_comparison_operands(
        lambda a, b, c: ref_pgop._intra8_est(
            a, b, c, lam, lam2, qp, qpc, None, ctu, h, w, 8, True, calib,
            psy_rd=2.0), j(oy), j(ocb), j(ocr))
    m_p, c_p = port_pgop._intra8_est(t(oy), t(ocb), t(ocr), lam, lam2, qp,
                                     qpc, ctu, h, w, 8, True, calib,
                                     psy_rd=2.0)
    np.testing.assert_array_equal(np.asarray(m_r), m_p.numpy())
    assert_same_bits(c_r, c_p.numpy(), "intra8_est cost")

    rng = np.random.default_rng(8)
    depth8 = np.full((h // 8, w // 8), 2, np.int32)
    pref = rng.random(depth8.shape) < 0.5
    inter_c8 = (np.asarray(c_r) * rng.uniform(0.7, 1.3, depth8.shape)) \
        .astype(np.float32)
    cf = np.zeros((h, w), np.int32)
    cfc = np.zeros((h // 2, w // 2), np.int32)
    want, cmp = float_comparison_operands(
        lambda *a: ref_pgop._intra_in_inter(
            *a, qp, qpc, None, ctu, h, w, 8, True, lam2=lam2,
            inter_c8=j(inter_c8), calib=calib, psy_rd=2.0),
        j(oy), j(ocb), j(ocr), j(ry), j(rcb), j(rcr), j(cf), j(cfc), j(cfc),
        j(depth8), j(pref), m_r)
    costs = {}
    got = port_pgop._intra_in_inter(
        t(oy), t(ocb), t(ocr), t(ry), t(rcb), t(rcr), t(cf), t(cfc), t(cfc),
        t(depth8), t(pref), m_p, qp, qpc, ctu, h, w, 8, True, lam2=lam2,
        inter_c8=t(inter_c8), calib=calib, psy_rd=2.0, costs=costs)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert len(cmp) == 2 * len(costs["cost_a"]) == 4
    for k, ca in enumerate(costs["cost_a"]):
        assert_same_bits(cmp[2 * k], ca.numpy(), f"cost_a, wave {k}")
    assert got[6].any() and not got[6].all()
