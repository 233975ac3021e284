"""Port parity for RDOQ, noise reduction and the lowpass DCT: the
functions of x265_tpu_torch.ops.transforms and enc.pgop_gpu against
x265_tpu's on the same inputs, the P frame's residual stage with all
three at CTU 64 with 4 references, the B body with RDOQ, and two P
chunks with noise reduction and the lowpass DCT through the submit /
collect entry points.

Inputs are made from seeds with numpy; the reference's functions run
jitted. Tolerance: exact equality everywhere (integer outputs; the
float32 operands of every comparison the reference's program makes, bit
for bit)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.enc import bframe_tpu as ref_b
from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu.enc.intra_recon import ReconFrame as RefRecon
from x265_tpu.ops import transforms as ref_tr
from x265_tpu_torch.common.tables import chroma_qp, lambda2_from_qp
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import bframe_gpu as port_b
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from x265_tpu_torch.enc.intra_recon import ReconFrame
from x265_tpu_torch.ops import transforms as port_tr
from chip_smoke import b_clip, small_clip
from test_torch_ctu64 import _recon_inputs
from test_torch_fma import _bits, assert_same_bits, float_comparison_operands

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# RDOQ
# ---------------------------------------------------------------------------

def _coefs(n, rng):
    """(B, n, n) int32 coefficients in four blocks of TUs: dense at mixed
    scales (the TU sums depend on their order), sparse with a few large
    levels, a sweep of small magnitudes, and all-zero TUs."""
    b = 96
    dense = rng.standard_normal((b, n, n)) * \
        rng.choice([3, 30, 300, 3000], (b, 1, 1))
    sparse = np.zeros((b, n * n))
    for _ in range(3):
        pos = rng.integers(0, n * n, b)
        sparse[np.arange(b), pos] = rng.integers(300, 30000, b) * \
            rng.choice([-1, 1], b)
    sweep = np.arange(1, 32 * n * n + 1) * rng.choice([-1, 1], 32 * n * n)
    sweep = sweep.reshape(32, n, n)
    zero = np.zeros((4, n, n))
    return np.concatenate([dense, sparse.reshape(b, n, n), sweep,
                           zero]).astype(np.int32)


def _check_rdoq(layout, n, qp, lam2, with_rem, seed, tc=None):
    """One RDOQ call of each package on the same coefficients: levels
    (and deltaU) equal, and every float32 operand the reference compares
    (the three candidates' costs its argmin takes, then per pass the
    distortion gain and lam2 * (bits + 2)) bit for bit. Returns the
    port's operands and the coefficients (lanes layout)."""
    rng = np.random.default_rng(seed)
    tc = _coefs(n, rng) if tc is None else tc
    bsz = tc.shape[0]
    qv = qp if isinstance(qp, int) else rng.integers(0, 52, bsz) \
        .astype(np.int32)
    if layout == "lanes":
        x = np.ascontiguousarray(tc.transpose(1, 2, 0))
        ref_fn, port_fn = ref_tr.rdoq_lanes, port_tr.rdoq_lanes
    else:
        x = tc
        ref_fn, port_fn = ref_tr.rdoq_batch, port_tr.rdoq_batch
    # a scalar QP is static in the reference's programs, as here
    args = (jnp.asarray(x),) if isinstance(qv, int) else \
        (jnp.asarray(x), jnp.asarray(qv))
    want, cmp = float_comparison_operands(
        lambda t, q=qv: ref_fn(t, n, q, lam2, 8, with_rem=with_rem), *args,
        argmin=True)
    ops = []
    got = port_fn(torch.from_numpy(x),
                  n, qv if isinstance(qv, int) else torch.from_numpy(qv),
                  lam2, 8, with_rem=with_rem, costs=ops)
    outs = zip(want, got) if with_rem else ((want, got),)
    for a, b in outs:
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert len(cmp) == len(ops) == (3 if n == 4 else 5)
    if layout == "batch":      # the port's operands are lanes-major
        cmp = [np.moveaxis(c, 1, -1) if k == 0 else
               (np.moveaxis(c, 0, -1) if c.ndim > 1 else c)
               for k, c in enumerate(cmp)]
    names = ("costs", "group gain", "group bits", "TU gain", "TU bits")
    names = names if n > 4 else names[:1] + names[3:]
    for name, c, o in zip(names, cmp, ops):
        assert_same_bits(c, o.numpy(), f"{layout} {n} {name}")
    return ops, x


def _row_major_sum(x, keep, batch):
    if keep is not None:
        x = torch.where(keep, x, 0.0)
    acc = x[0, 0]
    for i in range(x.shape[0]):
        for j in range(x.shape[1]):
            if i or j:
                acc = acc + x[i, j]
    return acc


@pytest.mark.parametrize("layout", ("lanes", "batch"))
@pytest.mark.parametrize("n", (4, 8, 16, 32))
def test_rdoq_matches_reference(layout, n, monkeypatch):
    """rdoq_lanes / rdoq_batch at one QP (with deltaU for sign hiding)
    and with a per-block QP vector (without), against the reference.
    The inputs hold TUs whose float32 gain sums depend on their order:
    with a row-major TU sum the port's would differ."""
    lam2 = float(lambda2_from_qp(32))
    ops, x = _check_rdoq(layout, n, 32, lam2, True, 100 + n)
    _check_rdoq(layout, n, "vector", float(lambda2_from_qp(27)), False,
                200 + n)
    monkeypatch.setattr(port_tr, "_tu_sum_vec", _row_major_sum)
    seq = []
    port_tr.rdoq_lanes(torch.from_numpy(x if layout == "lanes" else
                                        np.ascontiguousarray(
                                            x.transpose(1, 2, 0))),
                       n, 32, lam2, 8, costs=seq)
    assert (_bits(seq[-2].numpy()) != _bits(ops[-2].numpy())).any()


@pytest.mark.parametrize("lam2", (1e30, 1e-30))
def test_rdoq_lambda_limits_match_reference(lam2):
    """A huge lambda zeroes every level, a tiny one keeps the round-half
    levels; both as the reference at a scalar QP and a QP vector."""
    for layout, n in (("lanes", 32), ("batch", 8)):
        ops, _ = _check_rdoq(layout, n, 37, lam2, True, 300 + n)
        _check_rdoq(layout, n, "vector", lam2, True, 400 + n)


def test_rdoq_cost_ties_take_the_first_index():
    """Every coefficient magnitude up to 32767 at QP 22 (16x16 TUs):
    at large levels the costs of level - 1 and level round to the same
    float32, and the lower level (the first index) wins, as in the
    reference."""
    mags = np.arange(1, 32768, dtype=np.int32)
    k = len(mags) // 256
    tc = np.ascontiguousarray(mags[:k * 256].reshape(16, 16, k)
                              .transpose(2, 0, 1))
    ops, _ = _check_rdoq("lanes", 16, 22, float(lambda2_from_qp(32)), False,
                         0, tc=tc)
    c = ops[0].numpy()
    assert ((c[1] == c[2]) & (c[0] > c[1])).sum() > 100


# ---------------------------------------------------------------------------
# the lowpass DCT and noise reduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (8, 16, 32))
def test_lowpass_dct_matches_reference(n):
    """dct_lanes(lowpass=True): the half-size DCT of the 2x2-summed
    residual >> 2 in the low band and DC from the block sum, on random
    residuals and on blocks at the extremes (+-255 everywhere, and a
    +-255 checkerboard)."""
    rng = np.random.default_rng(n)
    rnd = rng.integers(-255, 256, (n, n, 40))
    ext = np.stack([np.full((n, n), 255), np.full((n, n), -255),
                    255 * (1 - 2 * ((np.arange(n)[:, None] +
                                     np.arange(n)[None]) % 2))], -1)
    resi = np.concatenate([rnd, ext], -1).astype(np.int32)
    want = jax.jit(functools.partial(ref_tr.dct_lanes, size=n,
                                     lowpass=True))(jnp.asarray(resi))
    got = port_tr.dct_lanes(torch.from_numpy(resi), n, lowpass=True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy()[n // 2:] == 0).all()


def test_nr_denoise_matches_reference():
    """_nr_denoise at every NR category's size: |coef| less the
    truncated float32 offset, clamped at 0, the sign restored, and the
    per-position sums of |coef| before denoising."""
    rng = np.random.default_rng(5)
    for n, _ in port_pgop.NR_CATS:
        tc = (rng.standard_normal((n, n, 50)) * 40).astype(np.int32)
        off = (rng.random(n * n) * 30).astype(np.float32)
        off[0] = 0.0
        want = jax.jit(ref_pgop._nr_denoise)(jnp.asarray(tc),
                                            jnp.asarray(off))
        got = port_pgop._nr_denoise(torch.from_numpy(tc),
                                    torch.from_numpy(off))
        np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
        assert_same_bits(want[1], got[1].numpy(), f"NR sums {n}")


# ---------------------------------------------------------------------------
# the P frame's residual stage with RDOQ, NR and the lowpass DCT
# ---------------------------------------------------------------------------

def test_mc_recon_all_with_rdoq_nr_lowpass_matches_reference():
    """_mc_recon_all at CTU 64 with 4 references, RQT, psy-rd and the
    intra 8x8 candidate, with RDOQ (and sign hiding on its deltaU), the
    lowpass DCT and NR offsets: every plane and decision, the NR
    accumulators (float32 sums bit for bit, block counts), and every
    float32 operand the reference's program compares, in its order:
    per residual call the RDOQ candidates' costs and its group and TU
    tests, the TU-split tests, the intra test, the keep-vs-split
    tests."""
    nrefs = 4
    oy, oc, preds, cpreds, mvs, refs, alt8 = _recon_inputs(nrefs, 44)
    qp = 32
    rng = np.random.default_rng(45)
    offs = {}
    for n, kind in port_pgop.NR_CATS:
        o = (rng.random(n * n) * 12).astype(np.float32)
        o[0] = 0.0
        offs[(n, kind)] = o
    kw = dict(lam2=float(lambda2_from_qp(qp)), qp=qp, qpc=chroma_qp(qp),
              bit_depth=8, sign_hiding=True, real_h=72, real_w=128, ctu=64,
              psy_rd=2.0, rqt=True, nrefs=nrefs, rdoq=True, lowpass=True)
    j = jnp.asarray

    def ref_fn(oy, ocb, ocr, mvs, preds, cpreds, refs, alt8, offs):
        out, acc = ref_pgop._mc_recon_all(
            oy, ocb, ocr, mvs, preds=preds, cpreds=cpreds, refs_grid=refs,
            alt8_cost=alt8, nr_offsets=offs, **kw)
        return out, {k: a for k, (a, _) in acc.items()}

    (want, w_acc), cmp = float_comparison_operands(
        ref_fn, j(oy), j(oc[0]), j(oc[1]), {n: j(v) for n, v in mvs.items()},
        {n: j(v) for n, v in preds.items()},
        {n: (j(a), j(b)) for n, (a, b) in cpreds.items()},
        {n: j(v) for n, v in refs.items()}, j(alt8),
        {k: j(v) for k, v in offs.items()}, argmin=True)
    t = torch.from_numpy
    costs = {}
    got, acc = port_pgop._mc_recon_all(
        t(oy), t(oc[0]), t(oc[1]), {n: t(v) for n, v in mvs.items()},
        preds={n: t(v) for n, v in preds.items()},
        cpreds={n: (t(a), t(b)) for n, (a, b) in cpreds.items()},
        refs_grid={n: t(v) for n, v in refs.items()}, alt8_cost=t(alt8),
        costs=costs, nr_offsets={k: t(v) for k, v in offs.items()}, **kw)
    names = ("rec_y", "cf_y", "rec_cb", "cf_cb", "rec_cr", "cf_cr", "depth8",
             "mv8", "tusplit8", "ref8", "intra_pref")
    for name, a, b in zip(names, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert_same_bits(want[-1], got[-1].numpy(), "inter_c8")
    assert set(acc) == set(w_acc) == set(port_pgop.NR_CATS)
    for k, (a, nb) in acc.items():
        assert_same_bits(w_acc[k], a.numpy(), f"NR sums {k}")
        n = k[0]
        per = (128 // n) ** 2 if k[1] == "y" else 2 * (64 // n) ** 2
        assert nb == per, k
    # the reference's comparisons in trace order
    rd = iter(costs["rdoq"])
    order = []
    for n in (8, 16, 32):
        calls = [n, n // 2, n // 2]
        if n >= 16:
            calls += [n // 2, n // 4, n // 4]
        for m in calls:
            order += [(f"rdoq {n}/{m} {i}", next(rd))
                      for i in range(3 if m == 4 else 5)]
        if n >= 16:
            order += [(f"split{n} {s}", costs[f"split{n}"][s])
                      for s in (0, 1)]
    for name in ("intra8", "keep16", "keep32", "keep64"):
        order += [(f"{name} {s}", costs[name][s]) for s in (0, 1)]
    assert len(cmp) == len(order)
    for c, (name, o) in zip(cmp, order):
        assert_same_bits(c, o.numpy(), name)
    depth8 = got[6].numpy()
    assert (depth8[:8] == 0).any() and (got[9].numpy() == 3).any()


# ---------------------------------------------------------------------------
# the B body with RDOQ
# ---------------------------------------------------------------------------

def test_b_body_with_rdoq_matches_reference():
    """One B frame of the b_clip under --preset fast with RDOQ on (the
    reference's B body quantises with rdoq_batch and hides signs on its
    deltaU; it has no NR and no lowpass DCT): every FrameBSyntax field
    and the recon, against the reference's _bframe_batch."""
    frames = b_clip(3)
    rcfg = RefConfig(width=96, height=64, qp=32)
    rcfg.apply_preset("fast")
    rcfg.rdoq = True
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    refs = [f for f in (frames[0], frames[2])]
    rsyns, rrecs = ref_b.encode_bframes_tpu(
        [frames[1]], [RefRecon(*refs[0])], [RefRecon(*refs[1])], rcfg, 33)
    psyns, precs, _ = port_b.encode_bframes_gpu(
        [frames[1]], [ReconFrame(*refs[0])], [ReconFrame(*refs[1])], cfg, 33,
        device="cpu")
    for k in ("depth8", "mv8", "pf8", "coeff_y", "coeff_cb", "coeff_cr",
              "sao_params"):
        a, b = getattr(rsyns[0], k), getattr(psyns[0], k)
        assert (a is None) == (b is None), k
        if a is not None:
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=k)
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(np.asarray(getattr(rrecs[0], k)),
                                      getattr(precs[0], k), err_msg=k)
    assert set(np.unique(psyns[0].pf8)) >= {1, 2}


# ---------------------------------------------------------------------------
# noise reduction and the lowpass DCT over P chunks
# ---------------------------------------------------------------------------

def test_nr_lowpass_chunks_match_reference():
    """Four P frames of small_clip with nr_inter 600 and the lowpass DCT,
    as two submits of two through submit_pgop_gpu / collect_pgop_gpu and
    the reference's submit_pgop_tpu / collect_pgop_tpu, each submit
    predicting from the same host ReconFrame (no I frame, no CABAC):
    every FramePSyntax field and recon plane. The NR state carries from
    frame to frame inside a submit and restarts at zero at the second."""
    frames = small_clip(5)
    rcfg = RefConfig(width=96, height=64, qp=32, nr_inter=600,
                     lowpass_dct=True)
    cfg = config_from_dict(dataclasses.asdict(rcfg))

    def stack(fr, k):
        return np.stack([f[k] for f in fr])

    rref = RefRecon(*(f.astype(np.int32) for f in frames[0]))
    pref = ReconFrame(*(f.astype(np.int32) for f in frames[0]))
    for s in (1, 3):
        chunk = frames[s:s + 2]
        args = (stack(chunk, 0), stack(chunk, 1), stack(chunk, 2))
        rsyns, rrecs, _ = ref_pgop.collect_pgop_tpu(ref_pgop.submit_pgop_tpu(
            *args, rref, rcfg, 32, need_recon=True, me_range=rcfg.me_range))
        psyns, precs, _ = port_pgop.collect_pgop_gpu(
            port_pgop.submit_pgop_gpu(*args, pref, cfg, 32, need_recon=True,
                                      me_range=cfg.me_range, device="cpu"))
        for i in range(2):
            for k in ("depth8", "mv8", "coeff_y", "coeff_cb", "coeff_cr",
                      "intra8", "mode8", "tusplit8", "ref8", "sao_params"):
                a, b = getattr(rsyns[i], k), getattr(psyns[i], k)
                assert (a is None) == (b is None), (s, i, k)
                if a is not None:
                    np.testing.assert_array_equal(
                        np.asarray(a), np.asarray(b), err_msg=f"{s} {i} {k}")
            for k in ("y", "cb", "cr"):
                np.testing.assert_array_equal(
                    getattr(rrecs[i], k), getattr(precs[i], k),
                    err_msg=f"{s} {i} {k}")
        # the next submit predicts from this one's last recon
        rref = RefRecon(*(np.asarray(getattr(rrecs[1], k))
                          for k in ("y", "cb", "cr")))
        pref = ReconFrame(*(getattr(precs[1], k) for k in ("y", "cb", "cr")))
