"""Port parity of the P scan's pieces: the bit-calibration tables and
the intra 8x8 candidate costs of x265_tpu_torch.enc.pgop_gpu against
x265_tpu.enc.pgop_tpu, bit for bit. (The 2-frame P chunk against the
reference's lives in tests/test_torch_encoder.py, beside the stream
whose reference programs it shares.)"""

import numpy as np
import torch

from x265_tpu.common import bit_calib as ref_calib
from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu_torch.common import bit_calib as port_calib
from x265_tpu_torch.common.tables import (chroma_qp, lambda_from_qp,
                                          lambda2_from_qp)
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from test_torch_encoder import _clip
from test_torch_fma import assert_same_bits, float_comparison_operands

torch.set_num_threads(2)


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
