"""The port's main path as a whole: bench-shaped low-delay IPPP (CQP 32,
deblock, I frame at QP 29 through the device recon, then pipelined P
chunks of 2) encoded by x265_tpu_torch on the CPU must give streams
byte-identical to x265_tpu's, which x265_tpu.decoder decodes to the
port's recon (the reference codes its I frame on its host recon and
hands it on as a reference stack: reference_i_frame). Frames and config
follow tests/test_pipelined.py, so the reference's compiled programs can
come from the persistent cache.
Beside it, one 2-frame P chunk of x265_tpu_torch.enc.pgop_gpu against
x265_tpu.enc.pgop_tpu, both predicting from the reference package's own
I-frame recon: every FramePSyntax field and recon sample (the same
reference programs as the 64x96 stream, loaded once per process).
Also: the package imports neither JAX nor x265_tpu, its entry points
want a GPU unless the CPU is asked for, and options it does not port
raise."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc.intra_recon import DeviceRef as RefDeviceRef
from x265_tpu.enc.pgop_tpu import encode_pgop_tpu
from x265_tpu.enc.weightp import analyse_gop_weights
from x265_tpu_torch.common.params import EncoderConfig
from x265_tpu_torch.convert import config_from_dict, device_ref_from_numpy
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc.pgop_gpu import collect_pgop_gpu, submit_pgop_gpu

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, h=64, w=96, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    base = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255) \
        .astype(np.uint8)
    cb = np.full((h // 2, w // 2), 120, np.uint8)
    cr = np.full((h // 2, w // 2), 132, np.uint8)
    return [(np.roll(base, 2 * i, axis=1), cb, cr) for i in range(n)]


def reference_stack(recon, rcfg):
    """The reference's I-frame recon as the (R, h, w) reference stack
    (R = num_refs, every slot the I frame, narrow dtype) that its P-chunk
    program carries from chunk to chunk. The program makes that very
    stack of a single plane (pgop_tpu's stack_init duplicates it; ties
    go to the lowest refIdx, so no duplicate slot is chosen), so a chunk
    codes the same from either, and a stream's first chunk runs the
    program of its later ones: one P-chunk program a configuration is
    traced and compiled, not two."""
    dt = jnp.uint8 if rcfg.bit_depth == 8 else jnp.uint16
    r = max(int(rcfg.num_refs), 1)
    return RefDeviceRef(*(jnp.broadcast_to(jnp.asarray(np.asarray(p), dt),
                                           (r,) + np.shape(p))
                          for p in (recon.y, recon.cb, recon.cr)))


def reference_i_frame(enc, frame, qp):
    """The reference encoder's I frame at qp on its host recon
    (use_device_recon=False), made the reference of its next P chunk as
    reference_stack. The host recon's bytes and recon are those of the
    reference's device wavefront (its tests/test_intra_recon_tpu.py holds
    the two equal, and its encode_hier_gop relies on it), so a stream
    test holds the port's wavefront to the reference's bytes without
    the reference tracing and compiling a wavefront program per geometry
    (about 200 s each from an empty JAX cache);
    tests/test_torch_intra.py holds it to the reference's wavefront
    itself, tests/test_torch_main10.py at CTU 64 and 10 bits. The I
    frame has set one distinct reference (ref_avail), which a stacked
    reference keeps, as it keeps the plane's."""
    r0 = enc.encode_frame(*frame, qp=qp, use_device_recon=False)
    enc.ref = reference_stack(r0.recon, enc.cfg)
    enc.poc = 0
    return r0


@pytest.mark.parametrize("h,w", [(64, 96), (72, 96)])
def test_ippp_stream_matches_reference(h, w):
    frames = _frames(7, h, w)
    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    enc = RefEncoder(rcfg)
    # the reference's I frame on its host recon, the port's on its
    # device wavefront
    r0 = reference_i_frame(enc, frames[0], rcfg.qp - 3)
    # with its recon: the reference's P-chunk program is then the one
    # test_p_chunk_matches_reference runs at 64x96
    rs = enc.encode_pgop_pipelined(frames[1:], chunk=2, need_recon=True)

    cfg = config_from_dict(dataclasses.asdict(rcfg))
    penc = IntraEncoder(cfg, device="cpu")
    p0 = penc.encode_frame(*frames[0], qp=cfg.qp - 3, use_device_recon=True)
    penc.ref = p0.device_ref
    penc.poc = 0
    ps = penc.encode_pgop_pipelined(frames[1:], chunk=2, need_recon=True)

    assert p0.bitstream == r0.bitstream
    assert len(ps) == len(rs) == 6
    for i, (a, b) in enumerate(zip(rs, ps)):
        assert a.bitstream == b.bitstream, f"P frame {i + 1}"

    for a, b in zip(rs, ps):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(a.recon, k),
                                          getattr(b.recon, k))
    stream = p0.bitstream + b"".join(r.bitstream for r in ps)
    dec = decode_annexb(stream)
    assert len(dec) == 7
    for i, d in enumerate(dec):
        rec = p0.recon if i == 0 else ps[i - 1].recon
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k), getattr(rec, k),
                                          err_msg=f"frame {i} {k}")


@pytest.mark.parametrize("tune", [None, "grain", "fastdecode"],
                         ids=["superfast", "superfast_grain",
                              "superfast_fastdecode"])
def test_preset_and_tune_streams_match_reference(tune):
    """The options no other test holds (ROADMAP item 26): the superfast
    row (me_range 3, TMVP with one reference, merge 2, no SAO), alone
    and under the grain tune (psy-rd 4.0, no sign hiding, no AQ) and
    the fastdecode tune (no deblock, no SAO, no sign hiding), each with
    zerolatency, as x265's --preset superfast --tune ... sets them: 1 I
    (QP 29) + 2 P in one chunk at 64x96, byte-identical to the reference
    and decoded by the port's decoder to the port's recon. The I frame
    takes the host-recon path (its bytes are the device path's: the
    reference's encode_hier_gop relies on it), so the three cases share
    the reference's one analysis program instead of tracing three
    wavefronts."""
    from x265_tpu_torch.decoder import decode_annexb as port_decode
    frames = _clip(3)
    h, w = frames[0][0].shape
    rcfg = RefConfig(width=w, height=h, qp=32)
    rcfg.apply_preset("superfast")
    for t in ((tune,) if tune else ()) + ("zerolatency",):
        rcfg.apply_tune(t)
    assert (rcfg.me_range, rcfg.tmvp, rcfg.num_refs) == (3, True, 1)
    res = []
    for enc in (RefEncoder(rcfg),
                IntraEncoder(config_from_dict(dataclasses.asdict(rcfg)),
                             device="cpu")):
        r0 = enc.encode_frame(*frames[0], qp=29, use_device_recon=False)
        enc.ref = r0.recon if isinstance(enc, RefEncoder) else \
            r0.device_ref
        enc.poc = 0
        res.append([r0] + enc.encode_pgop_pipelined(frames[1:], chunk=2,
                                                    need_recon=True))
    want, got = res
    assert [r.bitstream for r in got] == [r.bitstream for r in want]
    dec = port_decode(b"".join(r.bitstream for r in got))
    assert len(dec) == len(got) == 3
    for i, (d, r) in enumerate(zip(dec, got)):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k), getattr(r.recon, k),
                                          err_msg=f"frame {i} {k}")


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
    r0 = enc.encode_frame(*frames[0], qp=29, use_device_recon=False)
    wps = analyse_gop_weights(frames[1:], frames[0])
    wvecs = np.stack([wp.vec() for wp in wps])
    assert any(wp.luma_on for wp in wps)

    def stack(k):
        return np.stack([f[k] for f in frames[1:]])

    syns, recons, _ = encode_pgop_tpu(stack(0), stack(1), stack(2),
                                      reference_stack(r0.recon, rcfg), rcfg,
                                      32, need_recon=True,
                                      me_range=rcfg.me_range, weights=wvecs)
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


def test_package_imports_neither_jax_nor_reference():
    """Every module of x265_tpu_torch (the B path's enc/bframe_gpu.py and
    enc/lookahead.py, the host B path's enc/bi_frame.py, ops/me.py and
    ops/interp.py, the chain mesh's parallel/gop_sharding.py, ops/fma.py,
    the device lookahead enc/lookahead_gpu.py, the host I path's
    ops/sao.py and
    ops/intra_np.py, and the CLI's cli.py, abr.py, enc/ratecontrol.py,
    io/, bitstream/sei.py, bitstream/hdr10plus.py, ops/metrics.py,
    ops/scaler.py and version.py among them, and the validation decoder
    decoder/, the Python slice coder's bitstream/syntax.py, cabac.py and
    common/mv_derive.py, and the compact CG-row download ops/compact.py),
    and chip_smoke.py, import without pulling JAX or the reference
    package into the process."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import x265_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "x265_tpu_torch.__path__, 'x265_tpu_torch.')]\n"
        "for n in ('enc.bframe_gpu', 'enc.lookahead', 'ops.fma',\n"
        "          'enc.lookahead_gpu', 'ops.sao', 'ops.intra_np', 'cli',\n"
        "          'abr', 'enc.ratecontrol', 'io', 'io.y4m', 'io.yuv',\n"
        "          'bitstream.sei', 'bitstream.hdr10plus', 'ops.metrics',\n"
        "          'ops.scaler', 'version', 'decoder', 'decoder.decoder',\n"
        "          'bitstream.syntax', 'bitstream.cabac',\n"
        "          'bitstream.bitreader', 'common.mv_derive',\n"
        "          'enc.bi_frame', 'ops.me', 'ops.interp', 'parallel',\n"
        "          'parallel.gop_sharding', 'ops.compact'):\n"
        "    assert 'x265_tpu_torch.' + n in names, n\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'x265_tpu' or m.startswith('x265_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_entry_points_want_a_gpu():
    """device=None means the GPU: without one the entry points raise
    instead of running on the CPU."""
    from x265_tpu_torch.enc.intra_recon import ReconFrame
    from x265_tpu_torch.enc.pgop_gpu import submit_pgop_gpu
    cfg = EncoderConfig(width=64, height=64, qp=32)
    if torch.cuda.is_available():
        assert IntraEncoder(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IntraEncoder(cfg)
    z = np.zeros((64, 64), np.uint8)
    zc = np.zeros((32, 32), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        submit_pgop_gpu(z[None], zc[None], zc[None], ReconFrame(z, zc, zc),
                        cfg, 32)


@pytest.mark.parametrize("field,value", [
    ("num_refs", 2), ("tmvp", True), ("sao", True), ("ctu_size", 64),
    ("bframes", 3), ("rdoq", True), ("nr_inter", 100),
    ("lowpass_dct", True), ("aq_mode", 2), ("lossless", True),
    ("wpp", True), ("hash_sei", 1)])
def test_ported_options_construct(field, value):
    """Multi-reference prediction, TMVP, SAO, CTU 64, B frames (at CTU
    32), RDOQ, noise reduction, the lowpass DCT, AQ (per-CTU QP),
    lossless, WPP and the picture-hash SEI are ported: the encoder and
    the P-chunk path take them."""
    from x265_tpu_torch.enc.pgop_gpu import check_pgop_config
    cfg = EncoderConfig(width=64, height=64, qp=32)
    setattr(cfg, field, value)
    assert getattr(IntraEncoder(cfg, device="cpu").cfg, field) == value
    check_pgop_config(cfg)


def test_tune_ssim_constructs():
    """--tune ssim sets aq-mode 2 (per-CTU QP from the lookahead's AQ),
    which the encoder and the P-chunk path take."""
    from x265_tpu_torch.enc.pgop_gpu import check_pgop_config
    cfg = EncoderConfig(width=64, height=64, qp=32)
    cfg.apply_tune("ssim")
    assert cfg.aq_mode == 2 and cfg.dqp_enabled
    IntraEncoder(cfg, device="cpu")
    check_pgop_config(cfg)


@pytest.mark.parametrize("field,value,item", [("bit_depth", 10, 31)])
def test_unported_options_raise(field, value, item):
    """Main10 is ported, but not with SAO: the reference's coder writes
    sao_offset_abs with the 8-bit cMax (ROADMAP item 31)."""
    cfg = EncoderConfig(width=64, height=64, qp=32, sao=True)
    setattr(cfg, field, value)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}"):
        IntraEncoder(cfg, device="cpu")


def test_ctu16_raises_naming_the_host_recon_i_path():
    """CTU 16 is all-intra only: with keyint 1 the encoder constructs
    and codes its I frames through the host-recon I path (the device
    wavefront, which encode_gop batches frames through, runs CTU 32
    and 64 and says so, naming that path); with another keyint the
    config's validate refuses it, as the reference's does."""
    from x265_tpu_torch.enc.intra_recon_gpu import reconstruct_intra_gop_gpu
    cfg = EncoderConfig(width=64, height=64, qp=32, ctu_size=16, keyint=1,
                        bframes=0)
    enc = IntraEncoder(cfg, device="cpu")
    fr = _frames(1, 64, 64)[0]
    res = enc.encode_frame(*fr)
    assert set(enc.host_i_seconds) == {"analysis", "recon", "filters",
                                       "cabac"}
    dec = decode_annexb(res.bitstream)[0]
    np.testing.assert_array_equal(dec.y, res.recon.y)
    with pytest.raises(NotImplementedError, match="host-recon I path"):
        reconstruct_intra_gop_gpu(None, None, None, None, None, cfg)
    with pytest.raises(NotImplementedError, match="all-intra only"):
        IntraEncoder(EncoderConfig(width=64, height=64, qp=32, ctu_size=16),
                     device="cpu")


def test_b_frames_at_ctu64_raise():
    """B frames at CTU 64 (--preset medium without a tune) wait for a
    reference whose CTU-64 B streams decode: the encoder and the device
    B path raise naming ROADMAP item 28."""
    from x265_tpu_torch.enc.bframe_gpu import encode_bframes_gpu
    cfg = EncoderConfig(width=64, height=64, qp=32)
    cfg.apply_preset("medium")
    assert (cfg.ctu_size, cfg.bframes) == (64, 4)
    with pytest.raises(NotImplementedError,
                       match="B frames at CTU 64.*ROADMAP queue 1 item 28"):
        IntraEncoder(cfg, device="cpu")
    cfg.bframes = 0
    with pytest.raises(NotImplementedError, match="item 28"):
        encode_bframes_gpu([], [], [], cfg, 33, device="cpu")


def test_host_recon_i_path_raises():
    """The host-recon I path (use_device_recon=False) runs: without a
    QP map its I frame equals the device wavefront's, bytes and recon,
    as the reference's two paths agree; a QP map on a configuration
    without AQ or cuTree (no cu_qp_delta in the PPS) raises."""
    cfg = EncoderConfig(width=96, height=64, qp=30, deblock=True, sao=True)
    fr = _frames(1)[0]
    dev = IntraEncoder(cfg, device="cpu").encode_frame(*fr)
    host_enc = IntraEncoder(cfg, device="cpu")
    host = host_enc.encode_frame(*fr, use_device_recon=False)
    assert host_enc.host_i_seconds["recon"] > 0
    assert host.bitstream == dev.bitstream
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(host.recon, k),
                                      getattr(dev.recon, k))
    with pytest.raises(ValueError, match="aq_mode"):
        host_enc.encode_frame(*fr, qp_map=np.full((2, 3), 30, np.int32))


def test_config_from_dict_round_trips_and_rejects_unknown_fields():
    rcfg = RefConfig(width=96, height=72, qp=27, deblock=True, me_range=7)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    with pytest.raises(ValueError):
        config_from_dict({**dataclasses.asdict(rcfg), "no_such_field": 1})
