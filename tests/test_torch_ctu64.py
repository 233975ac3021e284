"""Port parity for CTU 64, x265's default CTU (`--preset medium`): the
z-quadrant I-frame wavefront's schedule and per-lane tables, the P
scan's depth-0 64x64 candidate and 64-level RD decision, the boundary
strengths, deblock and SAO at CTU 64, and one whole stream against
x265_tpu's:

  --preset medium --tune zerolatency (CTU 64, 3 references, me_range
  10, TMVP, merge 3, SAO) on a 72x128 clip, 1 I + 4 P in chunks of 2.
  The clip (chip_smoke.medium_clip, which the card's checks encode too)
  holds two whole 64-CTUs above a ragged 8-row strip (the bottom edge
  forces splits). Its left 96 columns are smooth content that pans, so
  that a 64x64 CU can win; its right 32 columns strobe between two
  textures, so that reference 1 wins there.

The stream is byte-identical to the reference's and x265_tpu.decoder
decodes it to the port's recon. One reference encode and one port
encode are shared by the module-scoped fixture.

A second stream runs the slowest preset under the same tune,
--preset placebo --tune zerolatency (CTU 64, RDOQ, 5 references,
merge 5, me_range 12), on the same clip: 1 I + 5 P in one chunk, so the
last P frame has five distinct references. Both streams' I frames go
through the port's device wavefront and the reference's host recon
(tests/test_torch_encoder.py reference_i_frame), whose bytes are its
wavefront's. Inputs are made from
seeds with numpy. Tolerance: exact equality everywhere (integer
outputs; the float32 RD costs bit for bit)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc import intra_recon_tpu as ref_ir
from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu.ops import deblock as ref_db
from x265_tpu.ops import sao_tpu as ref_sao
from x265_tpu_torch.common.tables import chroma_qp, lambda2_from_qp
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import intra_recon_gpu as port_ir
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from x265_tpu_torch.ops import deblock as port_db
from x265_tpu_torch.ops import sao_gpu as port_sao
from chip_smoke import medium_clip
from test_torch_encoder import reference_i_frame
from test_torch_fma import assert_same_bits, float_comparison_operands

torch.set_num_threads(2)

H, W = 72, 128


# ---------------------------------------------------------------------------
# the I-frame wavefront's schedule and lane tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,ctu", ((1088, 1920, 64), (H, W, 64),
                                     (1088, 1920, 32)))
def test_wavefront_schedule_and_lanes_match_reference(h, w, ctu):
    """The wavefront steps (CTU 64: the longest-path levels of the
    z-quadrant graph, 216 steps of at most 17 tiles at 1080p) and every
    per-lane table of a 2-frame batch padded to the widest step (tile
    ids, origins, and at CTU 64 tr_ok, bl_ok and the below-left tiles)
    against the reference's _wavefront_schedule and _gop_schedule."""
    ncx, ncy, nf = (w + 31) // 32, (h + 31) // 32, 2
    ctu_cfg = 64 if ctu == 64 else None
    steps = port_ir._wavefront_schedule(ncx, ncy, ctu)
    _, bmax, cells = ref_ir._wavefront_schedule(ncx, ncy, 32, ctu_cfg)
    assert steps == cells
    if (h, ctu) == (1088, 64):
        assert (len(steps), bmax) == (216, 17)
    idxs, dsel, _ = ref_ir._gop_schedule(ncx, ncy, 32, nf, 4, ctu_cfg=ctu_cfg)
    lanes = [port_ir._lane_indices(c, nf, ncx, ncy, bmax, ctu) for c in steps]
    assert set(lanes[0]) - {"real"} == set(idxs)
    for k, want in idxs.items():
        got = np.stack([ix[k] for ix in lanes]).astype(np.int64)
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=k)
    np.testing.assert_array_equal(np.stack([ix["self_o"] for ix in lanes]),
                                  dsel)
    if ctu == 64:
        tr = np.stack([ix["tr_ok"] for ix in lanes])
        bl = np.stack([ix["bl_ok"] for ix in lanes])
        assert not tr.all() and bl.any()


# ---------------------------------------------------------------------------
# the P scan's 64 level
# ---------------------------------------------------------------------------

def _blocks(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3) \
        .reshape(-1, n, n)


def _recon_inputs(nrefs, seed):
    """Source planes at the scan size of the 72x128 clip (128x128), and
    per CU size predictions near the source with a per-block noise
    amplitude (none at the 32 level of the top two 64s), MVs and refIdx
    grids. The four 32-blocks of the top-left 64 share their MV and
    reference; those of the top-right 64 share their reference but not
    their MV with one reference, their MV but not their reference with
    several; an intra 8x8 candidate beats the inter leaf at a few cells
    of the right half."""
    rng = np.random.default_rng(seed)
    h, w = 128, 128
    yy, xx = np.mgrid[0:h, 0:w]
    oy = np.clip(120 + ((xx * 3 + yy * 2) % 50) +
                 rng.integers(-6, 7, (h, w)), 0, 255).astype(np.int32)
    oc = [np.clip(128 + ((xx[::2, ::2] + k * yy[::2, ::2]) % 20) +
                  rng.integers(-3, 4, (h // 2, w // 2)), 0, 255)
          .astype(np.int32) for k in (1, 2)]

    def near(plane, n):
        b = _blocks(plane, n)
        amp = rng.choice((0, 1, 4), len(b))[:, None, None]
        noise = rng.integers(-4, 5, b.shape) * amp // 4
        return np.clip(b + noise, 0, 255).astype(np.int32)

    preds = {n: near(oy, n) for n in (8, 16, 32)}
    cpreds = {n: (near(oc[0], n // 2), near(oc[1], n // 2))
              for n in (8, 16, 32)}
    # the top two 64s predicted exactly at the 32 level: no residual,
    # so no TU split, and a 64 CU that costs one MVD
    top = [0, 1, 2, 3, 4, 5, 6, 7]
    preds[32][top] = _blocks(oy, 32)[top]
    for k in (0, 1):
        cpreds[32][k][top] = _blocks(oc[k], 16)[top]
    mvs = {n: rng.integers(-24, 25, ((h // n) * (w // n), 2))
           .astype(np.int32) for n in (8, 16, 32)}
    mv32 = mvs[32].reshape(4, 4, 2)
    mv32[0:2, 0:2] = (6, -3)
    mv32[0:2, 2:4] = (-5, 8)
    refs = {n: (rng.integers(0, nrefs, (h // n, w // n)) if nrefs > 1 else
                np.zeros((h // n, w // n), np.int64)).astype(np.int32)
            for n in (8, 16, 32)}
    if nrefs > 1:
        refs[32][0:2, 0:2] = 1
        refs[32][0:2, 2:4] = ((0, 1), (2, 2))
    else:
        mv32[1, 3] = (-5, 9)
    alt8 = np.where((rng.random((h // 8, w // 8)) < 0.08) & (xx[::8, ::8]
                                                            >= 64),
                    np.float32(10.0), np.float32(1e9)).astype(np.float32)
    return oy, oc, preds, cpreds, mvs, refs, alt8


@pytest.mark.parametrize("nrefs", (1, 3))
def test_cu64_candidate_and_depth_decision_match_reference(nrefs,
                                                           monkeypatch):
    """_mc_recon_all at CTU 64 (RQT, psy-rd, the intra 8x8 candidate):
    the depth-0 synthesis (sse[64] / bits[64] from the 32 level, the
    1e18 mask of ineligible CUs, one MVD and one ref_idx), the 64-level
    RD decision, tusplit8 one level deeper and the depth-to-plane map,
    every output against the reference's on the same inputs, with 1
    and 3 references. The float32 cost planes bit for bit: the
    psy-adjusted SSE and the bits each size enters the decision with,
    the 8x8 inter leaf cost, and both operands of every comparison the
    reference's program makes (the TU-split tests at 16 and 32, the
    intra-vs-inter test, the keep-vs-split tests at 16, 32 and 64),
    which need its multiply-adds rounded once (tests/test_torch_fma.py)."""
    oy, oc, preds, cpreds, mvs, refs, alt8 = _recon_inputs(nrefs, 30 + nrefs)
    qp = 32
    kw = dict(lam2=float(lambda2_from_qp(qp)), qp=qp, qpc=chroma_qp(qp),
              bit_depth=8, sign_hiding=True, real_h=H, real_w=W, ctu=64,
              psy_rd=2.0, rqt=True, nrefs=nrefs)
    j = jnp.asarray
    rd_decision = ref_pgop._rd_depth_decision

    def ref_fn(oy, ocb, ocr, mvs, preds, cpreds, refs, alt8):
        seen = {}

        def spy(sse, bits, *a, **k):
            seen.update(sse=dict(sse), bits=dict(bits))
            return rd_decision(sse, bits, *a, **k)

        monkeypatch.setattr(ref_pgop, "_rd_depth_decision", spy)
        out = ref_pgop._mc_recon_all(oy, ocb, ocr, mvs, preds=preds,
                                     cpreds=cpreds, refs_grid=refs,
                                     alt8_cost=alt8, **kw)[0]
        monkeypatch.setattr(ref_pgop, "_rd_depth_decision", rd_decision)
        return out, seen["sse"], seen["bits"]

    (want, w_sse, w_bits), cmp = float_comparison_operands(
        ref_fn, j(oy), j(oc[0]), j(oc[1]), {n: j(v) for n, v in mvs.items()},
        {n: j(v) for n, v in preds.items()},
        {n: (j(a), j(b)) for n, (a, b) in cpreds.items()},
        {n: j(v) for n, v in refs.items()}, j(alt8))
    t = torch.from_numpy
    costs = {}
    got = port_pgop._mc_recon_all(
        t(oy), t(oc[0]), t(oc[1]), {n: t(v) for n, v in mvs.items()},
        preds={n: t(v) for n, v in preds.items()},
        cpreds={n: (t(a), t(b)) for n, (a, b) in cpreds.items()},
        refs_grid={n: t(v) for n, v in refs.items()}, alt8_cost=t(alt8),
        costs=costs, **kw)
    names = ("rec_y", "cf_y", "rec_cb", "cf_cb", "rec_cr", "cf_cr", "depth8",
             "mv8", "tusplit8", "ref8", "intra_pref")
    for name, a, b in zip(names, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert_same_bits(want[-1], got[-1].numpy(), "inter_c8")
    for n in (8, 16, 32, 64):
        assert_same_bits(w_sse[n], costs["sse"][n].numpy(), f"sse[{n}]")
        assert_same_bits(w_bits[n], costs["bits"][n].numpy(), f"bits[{n}]")
    order = ("split16", "split32", "intra8", "keep16", "keep32", "keep64")
    assert len(cmp) == 2 * len(order)
    for k, name in enumerate(order):
        for side in (0, 1):
            assert_same_bits(cmp[2 * k + side],
                             costs[name][side].numpy(), f"{name}[{side}]")
    depth8 = got[6].numpy()
    assert (depth8[:8] == 0).any(), "no 64x64 CU kept"
    assert (depth8[:8] > 0).any() and (depth8[8:] > 1).all()


def _cu_tree(rng, n8y, n8x):
    """A random CTU-64 quadtree on the 8x8 grid: SPS depths 0-3."""
    d = np.zeros((n8y, n8x), np.int32)
    for y in range(0, n8y, 8):
        for x in range(0, n8x, 8):
            if rng.random() < 0.4:
                continue
            for y2 in range(y, y + 8, 4):
                for x2 in range(x, x + 8, 4):
                    d[y2:y2 + 4, x2:x2 + 4] = 1
                    if rng.random() < 0.5:
                        for y3 in range(y2, y2 + 4, 2):
                            for x3 in range(x2, x2 + 4, 2):
                                d[y3:y3 + 2, x3:x3 + 2] = \
                                    2 + (rng.random() < 0.4)
    return d


def test_inter_boundary_strengths_at_ctu64():
    """_inter_bs_maps_t with CTU 64 trees (64x64 CUs, whose internal
    32-pixel edges are transform edges), per-CU MVs, sparse
    coefficients, intra 8x8 cells and TU splits, against the
    reference's."""
    rng = np.random.default_rng(64)
    n8y, n8x = H // 8, W // 8
    depth8 = _cu_tree(rng, 16, n8x)[:n8y]
    size8 = 8 >> depth8
    cu_id = (np.arange(n8y)[:, None] // size8) * 100 + \
        (np.arange(n8x)[None, :] // size8)
    mvs = rng.integers(-12, 13, (10000, 2)).astype(np.int32)
    mv8 = mvs[cu_id % 10000]
    cf_y = np.where(rng.random((H, W)) < 0.02,
                    rng.integers(-3, 4, (H, W)), 0).astype(np.int32)
    intra8 = (depth8 == 3) & (rng.random((n8y, n8x)) < 0.3)
    tus8 = ((depth8 == 1) | (depth8 == 2)) & (cu_id % 3 == 0)
    assert (depth8 == 0).any() and intra8.any() and tus8.any()
    want = jax.jit(functools.partial(ref_pgop._inter_bs_maps_t, ctu=64))(
        jnp.asarray(depth8), jnp.asarray(mv8), jnp.asarray(cf_y),
        intra8=jnp.asarray(intra8), tusplit8=jnp.asarray(tus8))
    got = port_pgop._inter_bs_maps_t(
        torch.from_numpy(depth8), torch.from_numpy(mv8),
        torch.from_numpy(cf_y), 64, intra8=torch.from_numpy(intra8),
        tusplit8=torch.from_numpy(tus8))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_deblock_and_sao_at_ctu64_on_a_ragged_size():
    """The intra deblock on a CTU-64 depth map and SAO's luma decision
    at CTU 64 and joint chroma decision at 32, with their apply, on the
    ragged 72x128 size (a partial CTU row), against the reference."""
    rng = np.random.default_rng(65)
    yy, xx = np.mgrid[0:H, 0:W]
    orig = np.clip(((xx * 5 + yy * 3) % 180) + 40 +
                   rng.integers(-4, 5, (H, W)), 0, 255).astype(np.int32)
    rec = np.clip(orig + np.where(xx % 2 == 0, 3, -3) +
                  rng.integers(-6, 7, (H, W)), 0, 255).astype(np.int32)
    oc = [np.clip(128 + (xx[::2, ::2] + k * yy[::2, ::2]) % 30, 0, 255)
          .astype(np.int32) for k in (1, 3)]
    rc = [np.clip(o + rng.integers(-5, 6, o.shape) - 2, 0, 255)
          .astype(np.int32) for o in oc]
    depth8 = np.maximum(_cu_tree(rng, 16, W // 8)[:H // 8], 1)
    qp = 29
    j, t = jnp.asarray, torch.from_numpy
    # jitted: one compile instead of many eager ones (integer filters)
    want = jax.jit(functools.partial(ref_db.deblock_frame, depth8=depth8,
                                     ctu=64, qp=qp, bit_depth=8))(
        j(rec), j(rc[0]), j(rc[1]))
    got = port_db.deblock_frame(t(rec), t(rc[0]), t(rc[1]), t(depth8), 64,
                                qp, 8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    dy, dcb, dcr = (np.array(a) for a in want)
    lam = float(lambda2_from_qp(qp))
    p_y = np.asarray(ref_sao.choose_sao_t(j(orig), j(dy), 64, qp, 8, lam))
    got_y = port_sao.choose_sao_t(t(orig), t(dy), 64, qp, 8, lam)
    np.testing.assert_array_equal(p_y, got_y.numpy())
    assert p_y.shape[:2] == (2, 2) and p_y[..., 0].any()
    np.testing.assert_array_equal(
        np.asarray(ref_sao.apply_sao_t(j(dy), j(p_y), 64, 8)),
        port_sao.apply_sao_t(t(dy), got_y, 64, 8).numpy())
    pc = ref_sao.choose_sao_chroma_t(j(oc[0]), j(dcb), j(oc[1]), j(dcr), 32,
                                     qp, 8, lam)
    got_c = port_sao.choose_sao_chroma_t(t(oc[0]), t(dcb), t(oc[1]),
                                         t(dcr), 32, qp, 8, lam)
    for wp, gp, r in zip(pc, got_c, (dcb, dcr)):
        np.testing.assert_array_equal(np.asarray(wp), gp.numpy())
        np.testing.assert_array_equal(
            np.asarray(ref_sao.apply_sao_t(j(r), wp, 32, 8)),
            port_sao.apply_sao_t(t(r), gp, 32, 8).numpy())


@pytest.mark.parametrize("ctu", (32, 64))
def test_sao_costs_in_frame_bodies_match_reference(ctu):
    """SAO's luma decision as the P and B frame bodies run it: the
    reference's jitted choice prices every EO class and BO position as
    dd + lambda * bits rounded once (fused=True in the port; the I frame,
    which the reference runs op by op, keeps fused=False). Every
    candidate's cost plane bit for bit, and the decisions."""
    rng = np.random.default_rng(66 + ctu)
    h, w = 128, 256
    yy, xx = np.mgrid[0:h, 0:w]
    orig = np.clip(((xx * 5 + yy * 3) % 180) + 40 +
                   rng.integers(-8, 9, (h, w)), 0, 255).astype(np.int32)
    rec = np.clip(orig + rng.integers(-6, 7, (h, w)) +
                  np.where(xx % 3 == 0, 2, -1), 0, 255).astype(np.int32)
    qp = 33
    lam = float(lambda2_from_qp(qp))
    want, cmp = float_comparison_operands(
        lambda o, r: ref_sao.choose_sao_t(o, r, ctu, qp, 8, lam),
        jnp.asarray(orig), jnp.asarray(rec))
    costs = []
    got = port_sao.choose_sao_t(torch.from_numpy(orig), torch.from_numpy(rec),
                                ctu, qp, 8, lam, fused=True, costs=costs)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert len(cmp) == 2 * len(costs) == 2 * 36
    for k, c in enumerate(costs):
        assert_same_bits(cmp[2 * k], c.numpy(), f"candidate {k}")


# ---------------------------------------------------------------------------
# the whole stream
# ---------------------------------------------------------------------------

def medium_config(h=H, w=W):
    cfg = RefConfig(width=w, height=h, qp=32)
    cfg.apply_preset("medium")
    cfg.apply_tune("zerolatency")
    return cfg


def _i_frame(enc, frame):
    """The I frame at QP - 3, made the reference of what follows: the
    port's through its device wavefront, the reference's through its
    host recon, whose bytes, syntax and recon are its wavefront's, as a
    reference stack (tests/test_torch_encoder.py reference_i_frame: the
    reference traces no CTU-64 wavefront and one P-chunk program less
    here; tests/test_torch_main10.py holds the port's wavefront to the
    reference's at CTU 64)."""
    if isinstance(enc, RefEncoder):
        return reference_i_frame(enc, frame, enc.cfg.qp - 3)
    r0 = enc.encode_frame(*frame, qp=enc.cfg.qp - 3, use_device_recon=True)
    enc.ref = r0.device_ref
    enc.poc = 0
    return r0


def _encode(enc, frames):
    """The I frame (_i_frame), then pipelined P chunks of 2 (need_recon
    for the decode check)."""
    r0 = _i_frame(enc, frames[0])
    return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=2,
                                            need_recon=True)


@pytest.fixture(scope="module")
def streams():
    rcfg = medium_config()
    assert (rcfg.ctu_size, rcfg.num_refs, rcfg.me_range, rcfg.bframes) == \
        (64, 3, 10, 0)
    frames = medium_clip(5)
    ref = _encode(RefEncoder(rcfg), frames)
    port = _encode(IntraEncoder(config_from_dict(dataclasses.asdict(rcfg)),
                                device="cpu"), frames)
    return ref, port


def test_medium_stream_matches_reference(streams):
    ref, port = streams
    assert len(port) == len(ref) == 5
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a.bitstream == b.bitstream, f"frame {i}"


def test_medium_stream_decodes_to_port_recon(streams):
    _, port = streams
    dec = decode_annexb(b"".join(r.bitstream for r in port))
    assert len(dec) == len(port)
    for i, (d, r) in enumerate(zip(dec, port)):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k), getattr(r.recon, k),
                                          err_msg=f"frame {i} {k}")


I_FIELDS = ("depth8", "mode8", "coeff_y", "coeff_cb", "coeff_cr", "cmode8",
            "nxn8", "mode4")
P_FIELDS = ("depth8", "mv8", "ref8", "tusplit8", "intra8", "mode8",
            "coeff_y", "coeff_cb", "coeff_cr", "num_ref", "ref_pocs",
            "col_poc", "sao_params")


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_medium_syntax_fields_match_reference(streams):
    """The I frame's FrameIntraSyntax (SPS depths, one level below the
    32-grid analysis) and every FramePSyntax field, SAO included."""
    ref, port = streams
    for k in I_FIELDS:
        a, b = getattr(ref[0].syntax, k), getattr(port[0].syntax, k)
        assert (a is None) == (b is None) and (a is None or _same(a, b)), k
    assert port[0].syntax.depth8.min() >= 1
    for i, (r, p) in enumerate(zip(ref[1:], port[1:])):
        for k in P_FIELDS:
            a, b = getattr(r.syntax, k), getattr(p.syntax, k)
            assert (a is None) == (b is None), (i, k)
            assert a is None or _same(a, b), (i, k)


def test_medium_stream_uses_64x64_cus_and_older_references(streams):
    """The clip drives what CTU 64 adds and what the preset turns on:
    some depth-0 64x64 CU, some 8x8 cell predicted from reference 1 or
    later, an intra 8x8 cell in a P frame, a TU split, and SAO on."""
    _, port = streams
    ps = [r.syntax for r in port[1:]]
    assert any((s.depth8 == 0).any() for s in ps)
    assert any(s.ref8 is not None and (s.ref8 > 0).any() for s in ps)
    assert any(s.intra8 is not None for s in ps)
    assert any(s.tusplit8 is not None for s in ps)
    assert any(any(p[..., 0].any() for p in s.sao_params) for s in ps)


# ---------------------------------------------------------------------------
# --preset placebo --tune zerolatency: RDOQ, 5 references, merge 5,
# me_range 12
# ---------------------------------------------------------------------------

def placebo_config(h=H, w=W):
    cfg = RefConfig(width=w, height=h, qp=32)
    cfg.apply_preset("placebo")
    cfg.apply_tune("zerolatency")
    return cfg


@pytest.fixture(scope="module")
def placebo_streams():
    rcfg = placebo_config()
    assert (rcfg.ctu_size, rcfg.num_refs, rcfg.max_merge, rcfg.me_range,
            rcfg.rdoq, rcfg.bframes) == (64, 5, 5, 12, True, 0)
    frames = medium_clip(6)

    def encode(enc):
        r0 = _i_frame(enc, frames[0])
        return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=5,
                                                need_recon=True)

    port = encode(IntraEncoder(config_from_dict(dataclasses.asdict(rcfg)),
                               device="cpu"))
    return encode(RefEncoder(rcfg)), port


def test_placebo_stream_matches_reference(placebo_streams):
    """Byte-identical, every syntax field equal, decoder-exact; the last
    P frame lists five distinct references and predicts from reference
    1 or later somewhere."""
    ref, port = placebo_streams
    assert len(port) == len(ref) == 6
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a.bitstream == b.bitstream, f"frame {i}"
        keys = I_FIELDS if i == 0 else P_FIELDS
        for k in keys:
            x, y = getattr(a.syntax, k), getattr(b.syntax, k)
            assert (x is None) == (y is None), (i, k)
            assert x is None or _same(x, y), (i, k)
    dec = decode_annexb(b"".join(r.bitstream for r in port))
    for i, (d, r) in enumerate(zip(dec, port)):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k), getattr(r.recon, k),
                                          err_msg=f"frame {i} {k}")
    last = port[-1].syntax
    assert last.num_ref == 5 and len(set(last.ref_pocs)) == 5
    assert any(s.syntax.ref8 is not None and (s.syntax.ref8 > 0).any()
               for s in port[1:])
