"""Port parity at 10 bits (Main10): x265_tpu_torch against x265_tpu on
the same inputs, made from seeds with numpy, on the CPU.

The I frame at CTU 32 is tests/test_main10.py's (`synth10` 64x64,
seed 21, its config), so the reference's program is the one that file
compiles; the B mini-GOP codes that file's 96x64 hierarchical-B clip;
the other streams code chip_smoke.synth10_clip.
- The integer search's plain versions on uint16 windows against the
  reference's int_search_vec_pair / int_search_vec.
- The I frame on the device wavefront at CTU 32 (test_main10's frame)
  and at CTU 64 (the first frame of the slow stream).
- --preset slow --tune zerolatency --no-sao: CTU 64, 4 references,
  RDOQ, weightp (the clip fades, so the weights are not neutral),
  merge 3, me_range 10; 1 I + 3 P in one chunk.
- --preset fast --no-sao: a hierarchical-B mini-GOP (1 I + 4) through
  encode_hier_gop (the raw bi combine is 26 bits wide at 10 bits).
- encode_sequence with aq-mode 2 + cuTree: the device lookahead on
  10-bit planes, the host-recon I frame and dQP P frames.
- The CLI on a 420p10 y4m with the HDR10 flags and --hash 1, against
  the reference's CLI: bytes, csv and recon.
- encode_gop, encode_frame_p and encode_dup_frame at 10 bits, decoded.
- SAO at 10 bits is refused in every entry point (ROADMAP item 31:
  the reference's coder writes sao_offset_abs with the 8-bit cMax).
Every stream is byte-identical to the reference's, with every syntax
field and recon plane equal, and decodes exactly with
x265_tpu.decoder. Tolerance: exact equality; the lookahead's float
offsets keep test_torch_dqp.py's OFF_TOL."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import sps_fields, synth10_clip
from test_main10 import synth10
from test_torch_cli import _csv
from test_torch_dqp import OFF_TOL, _assert_same
from x265_tpu.cli import main as ref_cli_main
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc import lookahead_tpu as ref_la
from x265_tpu.ops import me_win as ref_me
from x265_tpu_torch.bitstream.nal import split_annexb
from x265_tpu_torch.bitstream.sei import parse_picture_hash_sei, picture_md5
from x265_tpu_torch.cli import main as cli_main
from x265_tpu_torch.common.params import EncoderConfig
from x265_tpu_torch.convert import config_from_dict, device_ref_from_numpy
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import lookahead_gpu as port_la
from x265_tpu_torch.enc.bframe_gpu import encode_bframes_gpu
from x265_tpu_torch.enc.pgop_gpu import submit_pgop_gpu
from x265_tpu_torch.enc.weightp import analyse_gop_weights
from x265_tpu_torch.io import Y4MReader, Y4MWriter
from x265_tpu_torch.ops import me_win as port_me

torch.set_num_threads(2)

MASTER = ("G(13250,34500)B(7500,3000)R(34000,16000)WP(15635,16450)"
          "L(10000000,1)")


def _both(rcfg):
    """A reference encoder and a port encoder (CPU) of one config."""
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    return RefEncoder(rcfg), IntraEncoder(cfg, device="cpu")


def _preset(preset, tune=None, **kw):
    """A reference config at 10 bits with a preset (and tune), SAO off
    (ROADMAP item 31), then the keyword overrides."""
    cfg = RefConfig(bit_depth=10, **kw)
    cfg.apply_preset(preset)
    if tune:
        cfg.apply_tune(tune)
    cfg.sao = False
    return cfg


def _lanes_np(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(1, 3, 0, 2) \
        .reshape(n, n, -1).astype(np.int32)


def test_int_search_plain_on_uint16_windows_matches_reference():
    """The pair search (16-regions and their 8-blocks) and the 32-block
    search on uint16 windows of 10-bit samples, near the top of the
    range where a 32-block SAD passes 2^16, against the reference's
    int_search_vec_pair / int_search_vec on the same windows and lanes,
    exactly; the wrappers take the plain versions on the CPU."""
    rng = np.random.default_rng(10)
    h, w, side, lead = 32, 64, 11, 4
    plane = rng.integers(0, 1024, (h, w)).astype(np.int32)
    plane[:, :32] = 1023 - (plane[:, :32] & 7)
    s16, s32 = 16 + side - 1 + 2 * lead, 32 + side - 1 + 2 * lead
    w16 = rng.integers(0, 1024, ((h // 16) * (w // 16), s16, s16))
    w32 = rng.integers(0, 1024, ((h // 32) * (w // 32), s32, s32))
    w32[0] &= 7                      # against the 1023s: SADs past 2^16
    w16, w32 = w16.astype(np.uint16), w32.astype(np.uint16)
    by16, bx16 = h // 16, w // 16
    s = s16
    w16r = w16.reshape(by16, bx16, s, s)
    w8 = np.stack([np.stack([w16r[:, :, 8 * jj:8 * jj + s - 8,
                                  8 * ii:8 * ii + s - 8]
                             for ii in (0, 1)], axis=2)
                   for jj in (0, 1)], axis=1).reshape(-1, s - 8, s - 8)
    pen = {n: rng.integers(0, 60, (2, side, (h // n) * (w // n)))
           .astype(np.int32) for n in (8, 16, 32)}
    (px8, py8), (px16, py16), (px32, py32) = pen[8], pen[16], pen[32]
    want = ref_me.int_search_vec_pair(
        jnp.asarray(w8.transpose(1, 2, 0)), jnp.asarray(_lanes_np(plane, 8)),
        *map(jnp.asarray, (px8, py8, px16, py16)), h // 8, w // 8, side,
        lead=lead)
    t = [torch.from_numpy(np.array(a))
         for a in (plane, px8, py8, px16, py16, px32, py32)]
    w16_t = torch.from_numpy(w16.view(np.int16)).view(torch.uint16)
    got = port_me.int_search_pair_windows(w16_t, *t[:5], by16, bx16, side,
                                          lead)
    for a, b in zip((*want[0], *want[1]), (*got[0], *got[1])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = ref_me.int_search_vec(
        jnp.asarray(w32.transpose(1, 2, 0)),
        jnp.asarray(_lanes_np(plane, 32)), jnp.asarray(px32),
        jnp.asarray(py32), 32, side, lead=lead)
    w32_t = torch.from_numpy(w32.view(np.int16)).view(torch.uint16)
    got = port_me.int_search_windows(w32_t, t[0], t[5], t[6], 32, side, lead)
    assert int(got[0].max()) > 1 << 16
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_i_frame_ctu32_matches_reference():
    """test_main10.py's I frame (64x64, QP 30) on the device wavefront."""
    ref, port = _both(RefConfig(width=64, height=64, qp=30, bit_depth=10))
    frame = synth10(64, 64, 21)
    a, b = ref.encode_frame(*frame), port.encode_frame(*frame)
    assert b.device_ref.y.dtype == torch.uint16
    assert int(b.recon.y.max()) > 255
    _assert_same([a], [b])


def _fade(frames):
    """The frames darkening from the second on (frame i at (10 - i) /
    10 of its luma), so weightp finds weights."""
    return frames[:1] + [
        ((y.astype(np.int32) * (10 - i) // 10).astype(np.uint16), cb, cr)
        for i, (y, cb, cr) in enumerate(frames[1:], 1)]


def _weighted(frames):
    """Whether weightp's analysis finds a weight other than neutral."""
    wps = analyse_gop_weights(frames[1:], frames[0], 10)
    return any(np.any(wp.vec() != np.array([64, 0] * 3)) for wp in wps)


@pytest.fixture(scope="module")
def slow_stream():
    """--preset slow --tune zerolatency --no-sao at 64x64: 1 I + 3 P in
    one chunk, fading (weightp on, as the preset has it)."""
    frames = _fade(synth10_clip(4, 64, 64))
    assert _weighted(frames)
    ref, port = _both(_preset("slow", "zerolatency", width=64, height=64,
                              qp=30))
    assert port.cfg.ctu_size == 64 and port.cfg.num_refs == 4
    assert port.cfg.rdoq
    out = []
    for enc in (ref, port):
        r0 = enc.encode_frame(*frames[0], qp=enc.cfg.qp - 3,
                              use_device_recon=True)
        enc.ref = r0.device_ref
        out.append([r0] + enc.encode_pgop(frames[1:]))
    return out


def test_i_frame_ctu64_matches_reference(slow_stream):
    """The CTU-64 I frame (the z-quadrant wavefront) at 10 bits."""
    a, b = slow_stream
    _assert_same(a[:1], b[:1])


def test_multiref_ctu64_rdoq_chunk_matches_reference(slow_stream):
    """Three P frames in one chunk (IPPP) at CTU 64 with 4 references,
    RDOQ and weightp: every field (ref8 included) and recon plane
    equal."""
    a, b = slow_stream
    _assert_same(a[1:], b[1:], before=b[:1])


def test_fast_b_minigop_matches_reference():
    """test_main10.py's hierarchical-B clip (96x64) under --preset fast
    --no-sao through encode_hier_gop: I, P4, B2, B1, B3."""
    yy, xx = np.mgrid[0:64, 0:96]
    y = ((xx * 9 + yy * 7) % 1024).astype(np.uint16)
    c = np.full((32, 48), 512, np.uint16)
    frames = [(np.roll(y, 3 * i, 1), c, c) for i in range(5)]
    ref, port = _both(_preset("fast", width=96, height=64, qp=30))
    assert port.cfg.bframes > 0
    a, b = ref.encode_hier_gop(frames), port.encode_hier_gop(frames)
    assert [r.ftype for r in b].count("B") == 3
    _assert_same(a, b)


def test_aq_cutree_sequence_matches_reference():
    """encode_sequence with aq-mode 2 + cuTree at 10 bits: the device
    lookahead's maps (its AQ scaled by the bit depth), the host-recon I
    frame with its QP map and two dQP P frames."""
    frames = synth10_clip(3, 64, 64, seed=5)
    ref, port = _both(RefConfig(width=64, height=64, qp=32, bit_depth=10,
                                aq_mode=2, cutree=True, deblock=True))
    a, b = ref.encode_sequence(frames), port.encode_sequence(frames)
    assert port.host_i_seconds                  # the host-recon I frame
    assert all(r.syntax.qp_map is not None for r in b[1:])
    _assert_same(a, b)


def test_single_stream_entry_points_at_10_bits():
    """encode_gop (two I frames through one wavefront batch), then
    encode_frame_p, encode_dup_frame and encode_frame_p after an I
    frame, at 10 bits with the MD5 SEI: each stream decodes with
    x265_tpu.decoder (which checks every hash) to the port's recon."""
    frames = synth10_clip(3, 64, 64)

    def enc():
        return IntraEncoder(EncoderConfig(width=64, height=64, qp=30,
                                          bit_depth=10, deblock=True,
                                          hash_sei=1), device="cpu")
    gop = enc().encode_gop(frames[:2])
    e = enc()
    seq = [e.encode_frame(*frames[0])]
    e.ref = seq[0].device_ref
    seq += [e.encode_frame_p(*frames[1]), e.encode_dup_frame(),
            e.encode_frame_p(*frames[2])]
    for res in (gop, seq):
        dec = decode_annexb(b"".join(r.bitstream for r in res))
        assert len(dec) == len(res)
        for d, r in zip(dec, res):
            np.testing.assert_array_equal(d.y, r.recon.y)
            np.testing.assert_array_equal(d.cr, r.recon.cr)


def test_lookahead_offsets_at_10_bits_match_reference():
    """lookahead_gop on 10-bit planes in AQ modes 1-3 with cuTree: the
    QP-offset maps, the 16x16 offsets and the lowres cost totals within
    OFF_TOL (test_torch_dqp.py's), the rounded QP maps equal."""
    frames = synth10_clip(3, 64, 64, seed=5)
    ys, cbs, crs = (np.stack([f[k] for f in frames]) for k in range(3))
    for aq_mode in (1, 2, 3):
        rcfg = RefConfig(width=64, height=64, qp=32, bit_depth=10,
                         aq_mode=aq_mode, cutree=True)
        cfg = config_from_dict(dataclasses.asdict(rcfg))
        want = ref_la.lookahead_gop(ys, cbs, crs, rcfg, qcomp=rcfg.qcomp)
        got = port_la.lookahead_gop(ys, cbs, crs, cfg, qcomp=rcfg.qcomp,
                                    device="cpu")
        diff = max(float(np.abs(a - b).max()) for a, b in zip(want, got))
        print(f"10-bit lookahead_gop aq {aq_mode}: largest difference "
              f"{diff:.3g}")
        assert diff <= OFF_TOL
        for base in (22, 32, 40):
            np.testing.assert_array_equal(np.round(base + want[0]),
                                          np.round(base + got[0]))


def test_lookahead_upload_keeps_10_bit_samples():
    """The device lookahead keeps samples above 255 (the upload once
    narrowed them to uint8, which wrapped a 10-bit plane): a plane and
    the same plane wrapped to 8 bits give different AQ maps."""
    frames = synth10_clip(2, 64, 64, seed=6)
    ys, cbs, crs = (np.stack([f[k] for f in frames]) for k in range(3))
    assert ys.max() > 255
    cfg = EncoderConfig(width=64, height=64, bit_depth=10, aq_mode=2,
                        cutree=False)
    got = port_la.lookahead_gop(ys, cbs, crs, cfg, device="cpu")
    wrapped = port_la.lookahead_gop(ys & 255, cbs & 255, crs & 255, cfg,
                                    device="cpu")
    assert not np.array_equal(got[0], wrapped[0])
    ref = ref_la.lookahead_gop(ys, cbs, crs, RefConfig(
        width=64, height=64, bit_depth=10, aq_mode=2, cutree=False))
    np.testing.assert_allclose(np.asarray(ref[0]), got[0], atol=OFF_TOL,
                               rtol=0)


def test_encoder_upload_keeps_10_bit_samples():
    """IntraEncoder._upload keeps 10-bit samples (it once narrowed them
    to uint8) and device_ref_from_numpy stores uint16 planes."""
    enc = IntraEncoder(EncoderConfig(width=64, height=64, bit_depth=10),
                       device="cpu")
    y = synth10(64, 64, 21)[0]
    t = enc._upload(y)
    assert t.dtype == torch.uint16
    np.testing.assert_array_equal(t.to(torch.int32).numpy(), y)
    ref = device_ref_from_numpy(y, y[::2, ::2], y[::2, ::2], device="cpu",
                                bit_depth=10)
    assert ref.y.dtype == torch.uint16
    np.testing.assert_array_equal(ref.to_recon().y, y)


def _write_y4m10(path, frames):
    h, w = frames[0][0].shape
    wr = Y4MWriter(str(path), w, h, bit_depth=10)
    for f in frames:
        wr.write_frame(*f)
    wr.close()
    return str(path)


def test_cli_main10_hdr10_stream_matches_reference_cli(tmp_path):
    """A 420p10 y4m (1 I + 2 P) through both CLIs with the HDR10 flags
    and --hash 1: identical bytes, csv rows (but wall_s) and 10-bit
    recon; the SPS says Main10 and bit depth 10; every MD5 SEI checks
    against the recon, and the decoder reads the recon back."""
    src = _write_y4m10(tmp_path / "in.y4m", _fade(synth10_clip(3, 64, 64)))
    common = [src, "--preset", "ultrafast", "--tune", "zerolatency",
              "--qp", "30", "--hash", "1", "--colorprim", "bt2020",
              "--transfer", "smpte2084", "--colormatrix", "bt2020nc",
              "--master-display", MASTER, "--max-cll", "1000,400",
              "--no-progress"]
    out = {}
    for tag, run in (("ref", ref_cli_main),
                     ("port", lambda a: cli_main(a, device="cpu"))):
        d = tmp_path / tag
        d.mkdir()
        assert run(common + ["-o", str(d / "out.hevc"), "--csv",
                             str(d / "s.csv"), "--recon",
                             str(d / "rec.y4m")]) == 0
        out[tag] = d
    port, ref = out["port"], out["ref"]
    stream = (port / "out.hevc").read_bytes()
    assert stream == (ref / "out.hevc").read_bytes()
    assert _csv(port / "s.csv") == _csv(ref / "s.csv")
    assert (port / "rec.y4m").read_bytes() == (ref / "rec.y4m").read_bytes()
    rec_r = Y4MReader(str(port / "rec.y4m"))
    assert rec_r.bit_depth == 10
    rec = list(rec_r)
    dec = decode_annexb(stream)              # checks every MD5 SEI
    assert len(dec) == len(rec) == 3
    for d, r in zip(dec, rec):
        for k, p in zip(("y", "cb", "cr"), r):
            np.testing.assert_array_equal(getattr(d, k), p)
    hashes = [parse_picture_hash_sei(rb) for t, rb, _ in split_annexb(stream)
              if int(t) == 40]
    assert [h for h in hashes] == [(1, picture_md5(*r, bit_depth=10))
                                   for r in rec]
    assert sps_fields(stream) == {"profile_idc": 2, "bit_depth_luma": 10,
                                  "bit_depth_chroma": 10}     # Main10
    seis = [rb[0] for t, rb, _ in split_annexb(stream) if int(t) == 39]
    assert {137, 144} <= set(seis)           # mastering display, CLL


def _sao10():
    return EncoderConfig(width=64, height=64, bit_depth=10, sao=True,
                         deblock=True)


def test_main10_sao_refused_in_every_entry_point(tmp_path):
    """bit_depth 10 with SAO raises NotImplementedError naming ROADMAP
    item 31 in IntraEncoder, submit_pgop_gpu, encode_bframes_gpu and the
    CLI (before any output is written); no path writes a 10-bit SAO
    stream."""
    with pytest.raises(NotImplementedError, match="item 31"):
        IntraEncoder(_sao10(), device="cpu")
    frames = synth10_clip(2, 64, 64)
    ys = np.stack([f[0] for f in frames])
    cs = np.stack([f[1] for f in frames])
    ref = device_ref_from_numpy(*frames[0], device="cpu", bit_depth=10)
    with pytest.raises(NotImplementedError, match="item 31"):
        submit_pgop_gpu(ys, cs, cs, ref, _sao10(), device="cpu")
    cfg = _sao10()
    cfg.bframes = 2
    with pytest.raises(NotImplementedError, match="item 31"):
        encode_bframes_gpu(frames[:1], [ref], [ref], cfg, 30, device="cpu")
    src = _write_y4m10(tmp_path / "in.y4m", frames)
    out = tmp_path / "out.hevc"
    with pytest.raises(NotImplementedError, match="item 31"):
        cli_main([src, "-o", str(out), "--preset", "fast", "--tune",
                  "zerolatency"], device="cpu")
    assert not out.exists()
