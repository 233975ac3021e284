"""Port parity for per-CTU QP end to end: x265_tpu_torch against
x265_tpu on the same inputs, made from seeds with numpy, on the CPU.

- The device lookahead (enc/lookahead_gpu.py): aq_offsets in modes 1-3,
  the lowres planes and costs, the cuTree scatter, propagation and
  finish, and lookahead_gop on 64x96 frames. Integers (the lowres
  costs, motion vectors, invQscale factors, the QP maps) are equal; the
  float32 offsets are held to OFF_TOL, their largest difference printed.
- The host-recon I path: a per-CTU QP map at CTU 32 (64x96, deblock)
  and at CTU 64 on a ragged 72x128 (one map row for two CTU rows,
  deblock and SAO), a lossless I frame and a CTU-16 keyint-1 I frame.
- dQP in the P body (encode_pgop(qp_maps=...) at CTU 32 with RDOQ),
  encode_sequence under --preset medium --tune zerolatency with AQ 2
  and cuTree (72x128, 1 I + 5 P; then reconfigure(aq_strength=...) and
  a second GOP), and a --preset fast B mini-GOP with AQ 2 (1 I + an
  anchor P and one B: flat maps through the P and B bodies).
Every stream is byte-identical to the reference's, with every syntax
field (qp_map included) and every recon plane equal, and decodes
exactly with x265_tpu.decoder."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc import lookahead_tpu as ref_la
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import lookahead_gpu as port_la
from chip_smoke import b_clip, medium_clip

torch.set_num_threads(2)

H, W = 64, 96
# the float32 offsets: the reference's transcendental approximations
# and summation order against the port's (queue 3 of ROADMAP.md)
OFF_TOL = 1e-4
# test_dqp.py's large-delta map: |delta| >= 5 takes the EG0 suffix
LARGE_DELTA = np.array([[26, 40, 22], [45, 30, 51]], np.int32)
FIELDS = ("depth8", "mode8", "cmode8", "nxn8", "mode4", "mv8", "pf8",
          "ref8", "intra8", "tusplit8", "coeff_y", "coeff_cb", "coeff_cr",
          "qp_map", "sao_params")


def _frame(h=H, w=W, seed=3):
    """tests/test_dqp.py's frame: a gradient with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.uint8)
    y = np.clip(y.astype(np.int32) + rng.integers(-8, 8, (h, w)),
                0, 255).astype(np.uint8)
    cb = np.clip(128 + (xx[::2, ::2] >> 3), 0, 255).astype(np.uint8)
    cr = np.clip(128 - (yy[::2, ::2] >> 3), 0, 255).astype(np.uint8)
    return y, cb, cr


def _pan_clip(n, h=H, w=W, seed=3):
    """A panning gradient with noise and a band of fresh noise on the
    left, so the lowres search, the intra costs and cuTree all vary."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    out = []
    for i in range(n):
        y = np.clip(np.roll(base, 3 * i, axis=1) +
                    rng.integers(-20, 20, (h, w)), 0, 255).astype(np.uint8)
        y[:, :20] = rng.integers(0, 255, (h, 20))
        cb = np.clip(128 + (xx[::2, ::2] >> 3) +
                     rng.integers(-5, 5, (h // 2, w // 2)), 0, 255) \
            .astype(np.uint8)
        cr = np.clip(128 - (yy[::2, ::2] >> 3), 0, 255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def _both(rcfg):
    """A reference encoder and a port encoder (CPU) of one config."""
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    return RefEncoder(rcfg), IntraEncoder(cfg, device="cpu")


def _assert_same(refs, ports, before=()):
    """Bytes, every syntax field, every recon plane; the port's stream
    (after the results `before` it, which carry the headers) decodes
    exactly to its recon."""
    assert len(refs) == len(ports)
    for i, (a, b) in enumerate(zip(refs, ports)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes"
        assert a.ftype == b.ftype
        for k in FIELDS:
            x, y = getattr(a.syntax, k, None), getattr(b.syntax, k, None)
            assert (x is None) == (y is None), f"frame {i} {k}"
            if x is None:
                continue
            if k == "sao_params":
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v, f"frame {i} {k}")
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              f"frame {i} {k}")
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a.recon, k),
                                          getattr(b.recon, k),
                                          f"frame {i} recon {k}")
    dec = decode_annexb(b"".join(r.bitstream
                                 for r in list(before) + list(ports)))
    assert len(dec) == len(before) + len(ports)
    by_poc = {r.poc: r for r in ports}
    for d in dec[len(before):]:
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k),
                                          getattr(by_poc[d.poc].recon, k),
                                          f"decoded POC {d.poc} {k}")


# ---------------------------------------------------------------------------
# the lookahead's pieces
# ---------------------------------------------------------------------------

def _planes():
    fr = _pan_clip(1)[0]
    return ([jnp.asarray(p.astype(np.int32)) for p in fr],
            [torch.from_numpy(p.astype(np.int32)) for p in fr])


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_aq_offsets_match_reference(mode):
    rj, pt = _planes()
    adj_r, invq_r = ref_la.aq_offsets(*rj, mode, 1.0, 8)
    adj_p, invq_p = port_la.aq_offsets(*pt, mode, 1.0, 8)
    diff = float(np.abs(np.asarray(adj_r) - adj_p.numpy()).max())
    print(f"aq mode {mode}: largest offset difference {diff:.3g}")
    assert diff <= OFF_TOL
    np.testing.assert_array_equal(np.asarray(invq_r), invq_p.numpy())


def test_lowres_costs_match_reference():
    """The half-res planes, the 35-mode intra SA8D minimum, and the
    radius-12 full search's winning MVs and SA8D costs: exact."""
    clip = _pan_clip(2)
    lr = [ref_la.lowres_plane(jnp.asarray(f[0].astype(np.int32)))
          for f in clip]
    lp = [port_la.lowres_plane(torch.from_numpy(f[0].astype(np.int32)))
          for f in clip]
    for a, b in zip(lr, lp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(ref_la.lowres_intra_cost(lr[1])),
                                  port_la.lowres_intra_cost(lp[1]).numpy())
    # jitted, so the search's program comes from the persistent cache
    cr, mr = jax.jit(ref_la.lowres_inter_cost)(lr[1], lr[0])
    cp, mp = port_la.lowres_inter_cost(lp[1], lp[0])
    np.testing.assert_array_equal(np.asarray(mr), mp.numpy())
    np.testing.assert_array_equal(np.asarray(cr), cp.numpy())
    assert np.abs(mp.numpy()).max() > 0       # the pan moves something


def test_cutree_matches_reference():
    """The bilinear scatter (bit for bit: each target sums in source
    order), the backward propagation over four frames and the finish."""
    rng = np.random.default_rng(0)
    f, by, bx = 4, 4, 6
    intra = rng.integers(50, 900, (f, by, bx)).astype(np.float32)
    inter = (intra * rng.uniform(0.2, 1.2, (f, by, bx))).astype(np.float32)
    mvs = rng.integers(-80, 80, (f, by, bx, 2)).astype(np.int32)
    invq = rng.integers(120, 400, (f, by, bx)).astype(np.float32)
    aq = rng.uniform(-3, 3, (f, by, bx)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(ref_la._scatter_bilinear(jnp.asarray(intra[1]),
                                            jnp.asarray(mvs[1]))),
        port_la._scatter_bilinear(torch.from_numpy(intra[1]),
                                  torch.from_numpy(mvs[1])).numpy())
    pr = np.asarray(ref_la.cutree_propagate_ippp(
        jnp.asarray(intra), jnp.asarray(inter), jnp.asarray(mvs)))
    pp = port_la.cutree_propagate_ippp(torch.from_numpy(intra),
                                       torch.from_numpy(inter),
                                       torch.from_numpy(mvs)).numpy()
    np.testing.assert_array_equal(pr, pp)
    assert pp[:-1].any()
    fr = np.asarray(ref_la.cutree_finish(jnp.asarray(intra), jnp.asarray(pr),
                                         jnp.asarray(invq), jnp.asarray(aq),
                                         0.6))
    fp = port_la.cutree_finish(torch.from_numpy(intra), torch.from_numpy(pp),
                               torch.from_numpy(invq), torch.from_numpy(aq),
                               0.6).numpy()
    diff = float(np.abs(fr - fp).max())
    print(f"cutree_finish: largest offset difference {diff:.3g}")
    assert diff <= OFF_TOL


@pytest.mark.parametrize("aq_mode,cutree", [(2, True), (1, True), (3, False)])
def test_lookahead_gop_maps_match_reference(aq_mode, cutree):
    clip = _pan_clip(4)
    ys, cbs, crs = (np.stack([f[k] for f in clip]) for k in range(3))
    rcfg = RefConfig(width=W, height=H, qp=32, aq_mode=aq_mode,
                     cutree=cutree)
    ref = ref_la.lookahead_gop(ys, cbs, crs, rcfg, qcomp=rcfg.qcomp)
    port = port_la.lookahead_gop(ys, cbs, crs,
                                 config_from_dict(dataclasses.asdict(rcfg)),
                                 qcomp=rcfg.qcomp, device="cpu")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(ref, port))
    print(f"lookahead_gop aq {aq_mode} cutree {cutree}: largest "
          f"difference {diff:.3g}")
    assert diff <= OFF_TOL
    for base in (22, 32, 40):
        np.testing.assert_array_equal(np.round(base + ref[0]),
                                      np.round(base + port[0]))


def test_lookahead_qp_maps_single_frame():
    """The CLI's per-frame call: F = 1, no inter search, no cuTree."""
    rcfg = RefConfig(width=W, height=H, qp=30, aq_mode=2, cutree=True)
    renc, penc = _both(rcfg)
    fr = _pan_clip(1, seed=9)
    a = renc.lookahead_qp_maps(fr, base_qp=27)
    b = penc.lookahead_qp_maps(fr, base_qp=27)
    assert a.shape == b.shape == (1, 2, 3)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the host-recon I path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctu,h,w,qmap", [
    (32, 64, 96, LARGE_DELTA),
    (64, 72, 128, LARGE_DELTA[:1, :2])])
def test_qp_map_i_frame_matches_reference(ctu, h, w, qmap):
    """At CTU 64 the 72x128 frame has two CTU rows and the map one: the
    encoder edge-extends it, and the deblock and SAO run too."""
    rcfg = RefConfig(width=w, height=h, qp=32, aq_mode=2, deblock=True,
                     sao=ctu == 64, ctu_size=ctu)
    renc, penc = _both(rcfg)
    fr = _frame(h, w, seed=5)
    a = renc.encode_frame(*fr, qp_map=qmap)
    b = penc.encode_frame(*fr, qp_map=qmap)
    _assert_same([a], [b])
    assert penc.host_i_seconds["recon"] > 0


def test_lossless_i_frame_matches_reference():
    rng = np.random.default_rng(5)
    y = np.clip(_frame()[0].astype(np.int32) +
                rng.integers(-20, 20, (H, W)), 0, 255).astype(np.uint8)
    cb = rng.integers(100, 140, (H // 2, W // 2)).astype(np.uint8)
    cr = rng.integers(120, 150, (H // 2, W // 2)).astype(np.uint8)
    renc, penc = _both(RefConfig(width=W, height=H, qp=32, lossless=True,
                                 deblock=True, sao=True))
    a = renc.encode_frame(y, cb, cr)
    b = penc.encode_frame(y, cb, cr)
    _assert_same([a], [b])
    assert not (penc.cfg.deblock or penc.cfg.sao or penc.cfg.sign_hiding)
    np.testing.assert_array_equal(b.recon.y, y.astype(np.int32))


def test_ctu16_i_frame_matches_reference():
    renc, penc = _both(RefConfig(width=W, height=H, qp=32, ctu_size=16,
                                 keyint=1, bframes=0, deblock=True))
    fr = _frame(seed=4)
    _assert_same([renc.encode_frame(*fr)], [penc.encode_frame(*fr)])


# ---------------------------------------------------------------------------
# dQP in the P and B bodies, and encode_sequence
# ---------------------------------------------------------------------------

def test_dqp_p_chunk_with_rdoq_matches_reference():
    """tests/test_dqp.py's P chunk (maps that change per frame and per
    CTU, deblock with the effective QP) with RDOQ on."""
    rcfg = RefConfig(width=W, height=H, qp=32, aq_mode=2, deblock=True,
                     rdoq=True)
    f0 = _frame(seed=7)
    pf = [(np.roll(f0[0], 2 * i, axis=1), f0[1], f0[2]) for i in range(1, 4)]
    qmaps = np.stack([np.array([[30, 34, 28], [36, 32, 26]]) + i
                      for i in range(3)]).astype(np.int32)
    out = []
    for enc in _both(rcfg):
        r0 = enc.encode_frame(*f0, qp_map=np.full((2, 3), 32, np.int32))
        enc.ref = r0.recon if isinstance(enc, RefEncoder) else r0.device_ref
        enc.poc = 0
        out.append([r0] + enc.encode_pgop(pf, qp_maps=qmaps))
    _assert_same(*out)
    for i, r in enumerate(out[1][1:]):
        np.testing.assert_array_equal(r.syntax.qp_map, qmaps[i])


def _medium_aq(h=72, w=128):
    rcfg = RefConfig(width=w, height=h, qp=32)
    rcfg.apply_preset("medium")
    rcfg.apply_tune("zerolatency")
    rcfg.aq_mode, rcfg.cutree = 2, True
    return rcfg


@pytest.fixture(scope="module")
def sequence_streams():
    """encode_sequence, medium/zerolatency + AQ 2 + cuTree on the CTU-64
    clip (1 I + 5 P, the P run in one chunk); then aq_strength 0.5 and
    a second GOP of 1 I + 5 P (the same programs)."""
    frames = medium_clip(12)
    out = []
    for enc in _both(_medium_aq()):
        first = enc.encode_sequence(frames[:6])
        assert enc.reconfigure(aq_strength=0.5) == 0
        out.append((first, enc.encode_sequence(frames[6:]), enc))
    return out


def test_encode_sequence_aq_cutree_matches_reference(sequence_streams):
    (ref, _, _), (port, _, penc) = sequence_streams
    assert [r.ftype for r in port] == ["I"] + ["P"] * 5
    _assert_same(ref, port)
    maps = np.stack([r.syntax.qp_map for r in port[1:]])
    assert maps.shape == (5, 2, 2)
    assert len(set(maps.ravel().tolist())) > 1     # dQP really varies
    assert len(penc.lookahead_seconds) == 2


def test_reconfigure_aq_strength_mid_stream(sequence_streams):
    (ref1, ref2, _), (port1, port2, _) = sequence_streams
    _assert_same(ref2, port2, before=port1)
    a = np.stack([r.syntax.qp_map for r in port1[1:]])
    b = np.stack([r.syntax.qp_map for r in port2[1:]])
    assert not np.array_equal(a, b)


def test_fast_aq_b_minigop_matches_reference():
    """--preset fast with AQ 2: the hierarchical GOP's I frame takes the
    host-recon path with a flat map, the anchor P and the B layers code
    flat maps (cu_qp_delta signalled, zero deltas)."""
    rcfg = RefConfig(width=W, height=H, qp=32)
    rcfg.apply_preset("fast")
    rcfg.aq_mode = 2
    frames = b_clip(3)
    ref, port = (enc.encode_hier_gop(frames) for enc in _both(rcfg))
    assert [r.ftype for r in port] == ["I", "P", "B"]
    _assert_same(ref, port)
    for r in port[1:]:
        q = r.syntax.qp_map
        assert q.shape == (2, 3) and (q == q[0, 0]).all()
    assert port[1].syntax.qp_map[0, 0] == 32
