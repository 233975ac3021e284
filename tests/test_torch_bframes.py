"""Port parity for B frames (the device mini-GOP path, CTU 32) and the
single-stream entry points: x265_tpu_torch against x265_tpu on the same
inputs, made from seeds with numpy.

The stream: `--preset fast` (3 references, me_range 5, 3 B frames,
b-adapt, TMVP, SAO) on a 64x96 clip, encode_hier_gop over 1 I + 4
frames (the anchor P at POC 4, the BREF at 2, the non-reference Bs 1
and 3 batched as one layer), encode_minigop over 4 more (the same
programs) and over 1 (a lone anchor P), then a duplicate frame. One reference encode and one port
encode are shared by the module-scoped fixture. Tolerance: exact
equality everywhere (bytes, every syntax field, recon samples)."""

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
from x265_tpu.enc import bframe_tpu as ref_b
from x265_tpu.enc import lookahead as ref_la
from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu.native.entropy_native import encode_slice_native as ref_native
from x265_tpu.ops import me_win as ref_me
from x265_tpu_torch.bitstream.ctx_tables import init_states
from x265_tpu_torch.common.params import B_SLICE
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import bframe_gpu as port_b
from x265_tpu_torch.enc import lookahead as port_la
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from x265_tpu_torch.native.entropy_native import encode_slice_native
from x265_tpu_torch.ops import me_win as port_me
from chip_smoke import b_clip

torch.set_num_threads(2)

H, W = 64, 96


def fast_config(h=H, w=W):
    cfg = RefConfig(width=w, height=h, qp=32)
    cfg.apply_preset("fast")
    return cfg


# ---------------------------------------------------------------------------
# the B pieces
# ---------------------------------------------------------------------------

def test_bi_combine_and_b_boundary_strengths_match_reference():
    rng = np.random.default_rng(3)
    raw0 = rng.integers(-(1 << 14), 255 << 12, (40, 8, 8)).astype(np.int32)
    raw1 = rng.integers(-(1 << 14), 255 << 12, (40, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(ref_b._bi_combine(jnp.asarray(raw0), jnp.asarray(raw1), 8)),
        port_b._bi_combine(torch.from_numpy(raw0), torch.from_numpy(raw1),
                           8).numpy())
    n8y, n8x = H // 8, W // 8
    depth8 = np.repeat(np.repeat(rng.integers(0, 3, (n8y // 4, n8x // 4)), 4,
                                 0), 4, 1).astype(np.int32)
    depth8[4:, 4:8] = rng.integers(1, 3, (4, 4))
    mvb = rng.integers(-9, 10, (n8y, n8x, 2, 2)).astype(np.int32)
    pf8 = rng.integers(1, 4, (n8y, n8x)).astype(np.int32)
    cf_y = np.where(rng.random((H, W)) < 0.02,
                    rng.integers(-3, 4, (H, W)), 0).astype(np.int32)
    want = jax.jit(functools.partial(ref_b._bs_maps_b_t, ctu=32))(
        jnp.asarray(depth8), jnp.asarray(mvb), jnp.asarray(pf8),
        jnp.asarray(cf_y))
    t = torch.from_numpy
    got = port_b._bs_maps_b_t(t(depth8), t(mvb), t(pf8), t(cf_y), 32)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).any()


def test_raw_me_and_chroma_accumulators_match_reference():
    """me_all_sizes(want_raw=True) and _chroma_preds_windowed(raw=True)
    at the B path's one-reference fast shapes (me_range 5): every MV,
    cost, prediction and raw accumulator, zero-MV winners included."""
    fr = b_clip(2)
    r = 5
    pad_y, pad_c = 2 * r + 8, r + 8
    cur = fr[1][0].astype(np.int32)
    ref = fr[0][0].astype(np.int32)
    cur[:32, 64:] = ref[:32, 64:]               # static: zero-MV winners
    rcb, rcr = (fr[0][k].astype(np.int32) for k in (1, 2))
    rng = np.random.default_rng(5)
    cmv = (rng.integers(-2, 3, (H // 16, W // 16, 2)) * 4).astype(np.int32)
    j, t = jnp.asarray, torch.from_numpy

    @jax.jit
    def ref_fn(cur, ref, cmv, rcb, rcr):
        res, seeds = ref_me.me_all_sizes(cur, ref_me.pad_ref(ref, pad_y), cmv,
                                         jnp.int32(20), radius=r, pad=pad_y,
                                         want_raw=True)
        cpad2 = jnp.stack([ref_me.pad_ref(rcb, pad_c),
                           ref_me.pad_ref(rcr, pad_c)])
        craw = ref_pgop._chroma_preds_windowed(
            cpad2, pad_c, rcb, rcr, {n: res[n][0] for n in (8, 16, 32)},
            seeds, r, H, W, 8, raw=True)
        return res, craw

    want, wc = ref_fn(j(cur), j(ref), j(cmv), j(rcb), j(rcr))
    got, seeds = port_me.me_all_sizes(
        t(cur), port_me.pad_ref(t(ref).to(torch.uint8), pad_y), t(cmv), 20,
        radius=r, pad=pad_y, want_raw=True)
    cpad2 = torch.stack([port_me.pad_ref(t(p).to(torch.uint8), pad_c)
                         for p in (rcb, rcr)])
    gc = port_pgop._chroma_preds_windowed(
        cpad2, pad_c, t(rcb), t(rcr), {n: got[n][0] for n in (8, 16, 32)},
        seeds, r, H, W, 8, raw=True)
    for n in (8, 16, 32):
        for k, (a, b) in enumerate(zip(want[n], got[n])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"n={n} field {k}")
        for a, b in zip(wc[n], gc[n]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        zero = (got[n][0] == 0).all(1)
        assert zero.any() and not zero.all()


def _pan(n, h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 5)) % 256).astype(np.int32)
    return [np.clip(np.roll(base, 2 * i, axis=1), 0, 255).astype(np.uint8)
            for i in range(n)]


def _fade(n, h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 5)) % 256).astype(np.int32)
    return [np.clip(base * (1.0 - 0.18 * i), 0, 255).astype(np.uint8)
            for i in range(n)]


def test_lookahead_matches_reference():
    """plan_minigop (the B-run length), decide (keyint and scene cut) and
    hist_scenecut on the pan and fade clips of tests/test_badapt.py and
    on their concatenation (a cut)."""
    cfg = RefConfig(width=128, height=96, qp=32, bframes=3, keyint=6)
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    plans = []
    for ys in (_pan(5), _fade(5), _pan(2) + _fade(3)):
        want = ref_la.Lookahead(cfg).plan_minigop(ys[0], ys[1:])
        assert port_la.Lookahead(pcfg).plan_minigop(ys[0], ys[1:]) == want
        plans.append(want)
    assert plans[0] == 3 and plans[1] <= 1
    ys = _pan(4) + _fade(4)[2:] + _pan(4)
    la_r, la_p = ref_la.Lookahead(cfg), port_la.Lookahead(pcfg)
    types = [la_r.decide(y) for y in ys]
    assert [la_p.decide(y) for y in ys] == types
    assert types.count("I") >= 2
    for a, b in zip(ys[:-1], ys[1:]):
        assert port_la.hist_scenecut(a, b) == ref_la.hist_scenecut(a, b)


# ---------------------------------------------------------------------------
# the whole stream
# ---------------------------------------------------------------------------

def _encode(enc, frames):
    rs = enc.encode_hier_gop(frames[:5])
    rs += enc.encode_minigop(frames[5:9])
    rs += enc.encode_minigop(frames[9:10])
    rs.append(enc.encode_dup_frame())
    return rs


@pytest.fixture(scope="module")
def streams():
    rcfg = fast_config()
    assert (rcfg.ctu_size, rcfg.num_refs, rcfg.me_range, rcfg.bframes,
            rcfg.sao, rcfg.tmvp) == (32, 3, 5, 3, True, True)
    frames = b_clip(10)
    renc = RefEncoder(rcfg)
    penc = IntraEncoder(config_from_dict(dataclasses.asdict(rcfg)),
                        device="cpu")
    return _encode(renc, frames), _encode(penc, frames), renc, penc


def test_b_stream_matches_reference(streams):
    ref, port, _, _ = streams
    assert [(r.ftype, r.poc) for r in port] == \
        [(r.ftype, r.poc) for r in ref] == \
        [("I", 0), ("P", 4), ("B", 2), ("B", 1), ("B", 3), ("P", 8),
         ("B", 6), ("B", 5), ("B", 7), ("P", 9), ("P", 10)]
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a.bitstream == b.bitstream, f"frame {i} (POC {a.poc})"


B_FIELDS = ("depth8", "mv8", "pf8", "coeff_y", "coeff_cb", "coeff_cr",
            "poc", "poc_refs", "max_merge", "sao_params")
P_FIELDS = ("depth8", "mv8", "ref8", "tusplit8", "intra8", "mode8",
            "coeff_y", "coeff_cb", "coeff_cr", "num_ref", "ref_pocs",
            "col_poc", "sao_params")


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_b_stream_fields_recon_and_decode(streams):
    """Every FrameBSyntax / FramePSyntax field and recon sample equal to
    the reference's; x265_tpu.decoder decodes the port's stream to its
    recon; the B frames hold L0-only, L1-only and bi cells, the
    non-reference layer is coded as TRAIL_N."""
    ref, port, _, _ = streams
    for r, p in zip(ref[1:], port[1:]):
        for k in (B_FIELDS if p.ftype == "B" else P_FIELDS):
            a, b = getattr(r.syntax, k), getattr(p.syntax, k)
            assert (a is None) == (b is None), (p.poc, k)
            assert a is None or _same(a, b), (p.poc, k)
    for r, p in zip(ref, port):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(r.recon, k),
                                          getattr(p.recon, k),
                                          err_msg=f"POC {p.poc} {k}")
    # the duplicate frame stays out: the reference codes it without SAO
    # parameters under a slice header that signals SAO, which its
    # decoder refuses whenever SAO is on (ROADMAP queue 3)
    dec = decode_annexb(b"".join(r.bitstream for r in port[:-1]))
    assert len(dec) == len(port) - 1
    by_poc = {r.poc: r for r in port}
    for d in dec:
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k),
                                          getattr(by_poc[d.poc].recon, k),
                                          err_msg=f"POC {d.poc} {k}")
    pf = np.concatenate([r.syntax.pf8.ravel() for r in port
                         if r.ftype == "B"])
    assert {1, 2, 3} <= set(pf.tolist())
    assert [r.bitstream[4] >> 1 for r in port if r.ftype == "B"] == \
        [1, 0, 0, 1, 0, 0]            # TRAIL_R (BREF), TRAIL_N
    dup, anchor = port[-1], port[-2]
    assert not dup.syntax.coeff_y.any() and not dup.syntax.depth8.any()
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(dup.recon, k),
                                      getattr(anchor.recon, k))


def test_native_b_coder_stats_and_reconfigure(streams):
    """The native B slice coder on the reference's first FrameBSyntax,
    byte-equal; get_stats after the stream; reconfigure's accepted and
    refused updates (noise reduction, ported, is accepted)."""
    ref, _, renc, penc = streams
    syn = next(r.syntax for r in ref if r.ftype == "B")
    mvb = syn.mv8.reshape(H // 8, W // 8, 4)
    args = (0, syn.depth8, syn.coeff_y, syn.coeff_cb, syn.coeff_cr, W, H,
            5, 3)
    kw = dict(mvb=mvb, pf8=syn.pf8, poc=syn.poc, poc_refs=syn.poc_refs,
              max_merge=syn.max_merge, sign_hiding=True,
              sao_params=syn.sao_params, slice_qp=33, rqt_inter=True)
    # the coder adapts the context states in place: fresh ones per call
    got = encode_slice_native(*args, init_states(B_SLICE, 33), **kw)
    assert got == ref_native(*args, init_states(B_SLICE, 33), **kw)
    assert len(got[0]) > 20
    want, got = renc.get_stats(), penc.get_stats()
    want.pop("encode_fps")
    assert got.pop("encode_fps") > 0
    assert got == want and want["count_by_type"] == {"I": 1, "P": 4, "B": 6}
    assert [(f.ftype, f.poc, f.qp, f.bits, f.cu_pct_by_depth)
            for f in penc.stats.frames] == \
        [(f.ftype, f.poc, f.qp, f.bits, f.cu_pct_by_depth)
         for f in renc.stats.frames]
    for upd, code in (({"qp": 30, "psy_rd": 1.0}, 0), ({"ctu_size": 16}, -1)):
        assert penc.reconfigure(**upd) == renc.reconfigure(**upd) == code
    assert penc.cfg.qp == 30 and penc.cfg.psy_rd == 1.0
    assert penc.reconfigure(nr_inter=100) == renc.reconfigure(nr_inter=100) \
        == 0
    assert penc.cfg.nr_inter == 100
