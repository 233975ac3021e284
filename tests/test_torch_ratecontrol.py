"""The port's host layers of rate control and the CLI against the
reference's, on the CPU: RateControl (CQP, CRF, ABR, each with and
without VBV) on scripted 30-frame runs, the two-pass log and its
controller, the SEI writers and picture hashes, HDR10+ payloads, the
length-prefixed NAL form, y4m/yuv I/O, PSNR/SSIM and the scaler.
Tolerance: exact equality (floats bit for bit), except the device SSIM,
float32 in both packages and held to 1e-6."""

import json

import numpy as np
import pytest
import torch

from x265_tpu.bitstream import hdr10plus as ref_hdr
from x265_tpu.bitstream import nal as ref_nal
from x265_tpu.bitstream import sei as ref_sei
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.enc import ratecontrol as ref_rc
from x265_tpu.io import Y4MReader as RefY4MReader
from x265_tpu.io import Y4MWriter as RefY4MWriter
from x265_tpu.ops import metrics as ref_metrics
from x265_tpu.ops import scaler as ref_scaler
from x265_tpu_torch.bitstream import hdr10plus, nal, sei
from x265_tpu_torch.common.params import EncoderConfig
from x265_tpu_torch.enc import ratecontrol as rc
from x265_tpu_torch.io import Y4MReader, Y4MWriter, YUVReader
from x265_tpu_torch.ops import metrics, scaler

torch.set_num_threads(2)


def _rc_config(cls, mode: str, vbv: bool):
    cfg = cls(width=96, height=64, qp=32)
    if mode == "abr":
        cfg.rc_mode, cfg.bitrate = "abr", 200
    elif mode == "crf":
        cfg.rc_mode, cfg.crf = "crf", 28.0
    if vbv:
        cfg.vbv_bufsize, cfg.vbv_maxrate = 60, 200
    return cfg


def _script(n=30, seed=5):
    """(is_intra, complexity, bits) per frame: IDRs at 0 and 17, a
    complexity jump at 9 and bits with spikes that drain the VBV."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        intra = i in (0, 17)
        cplx = float(rng.uniform(2e4, 9e4) * (3.0 if 9 <= i < 14 else 1.0)
                     * (4.0 if intra else 1.0))
        bits = int(rng.integers(2000, 9000) * (6 if intra else 1)
                   * (5 if i in (10, 11, 12) else 1))
        out.append((intra, cplx, bits))
    return out


def _rc_trace(mod, cfg):
    ctl = mod.RateControl(cfg)
    trace = []
    for intra, cplx, bits in _script():
        qp = ctl.frame_qp(intra, cplx)
        ctl.frame_done(bits, qp, cplx, intra)
        trace.append((qp, ctl.vbv_fill, ctl.vbv_underflows, ctl.cplxr_sum,
                      ctl.bits_per_qscale))
    return trace


@pytest.mark.parametrize("vbv", [False, True])
@pytest.mark.parametrize("mode", ["cqp", "crf", "abr"])
def test_rate_control_matches_reference(mode, vbv):
    """Every QP, the VBV fill and underflow count, the ABR complexity
    sum and the VBV bits predictor, frame by frame, bit for bit."""
    want = _rc_trace(ref_rc, _rc_config(RefConfig, mode, vbv))
    got = _rc_trace(rc, _rc_config(EncoderConfig, mode, vbv))
    assert got == want
    qps = [t[0] for t in got]
    if mode == "cqp":
        assert set(qps) == {32}
    else:
        assert len(set(qps)) > 3, qps       # the controller moves the QP
    if vbv:
        assert got[-1][2] > 0                # the spikes underflowed
        if mode != "cqp":
            free = [t[0] for t in _rc_trace(
                rc, _rc_config(EncoderConfig, mode, False))]
            assert qps != free               # the VBV clamp acted


def test_two_pass_log_and_controller_match_reference(tmp_path):
    """Both packages write the same stats text for the same records,
    read it back alike, and solve the same pass-2 QPs."""
    recs = [("I" if intra else "P", 30 + i % 5, bits, max(cplx, 1.0))
            for i, (intra, cplx, bits) in enumerate(_script())]
    recs[3] = ("P", 31, 4100, 0.25)          # a complexity below 1
    paths = {}
    for tag, mod in (("ref", ref_rc), ("port", rc)):
        log = mod.TwoPassLog(str(tmp_path / f"{tag}.log"))
        for r in recs:
            log.record(*r)
        log.write()
        paths[tag] = tmp_path / f"{tag}.log"
    assert paths["port"].read_text() == paths["ref"].read_text()
    qps = {}
    for tag, mod, cls in (("ref", ref_rc, RefConfig),
                          ("port", rc, EncoderConfig)):
        log = mod.TwoPassLog.read(str(paths["ref"]))
        ctl = mod.TwoPassRateControl(_rc_config(cls, "abr", False), log)
        qps[tag] = ([ctl.frame_qp() for _ in recs], ctl.rate_factor)
    assert qps["port"] == qps["ref"]
    assert [t for t, _ in qps["port"][0]] == [r[0] for r in recs]
    assert rc.qp_to_qscale(27.5) == ref_rc.qp_to_qscale(27.5)
    assert rc.qscale_to_qp(0.9) == ref_rc.qscale_to_qp(0.9)


def _planes(bit_depth, h=36, w=52, seed=3):
    rng = np.random.default_rng(seed)
    hi = 1 << bit_depth
    dt = np.uint8 if bit_depth == 8 else np.uint16
    return (rng.integers(0, hi, (h, w)).astype(dt),
            rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
            rng.integers(0, hi, (h // 2, w // 2)).astype(dt))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_picture_hashes_and_sei_writers_match_reference(bit_depth):
    """MD5, CRC and checksum of every plane, the hash SEI and its
    parse, and the bytes of every other SEI writer and the AUD."""
    y, cb, cr = _planes(bit_depth)
    for ht in (1, 2, 3):
        assert sei.HASH_FNS[ht](y, cb, cr, bit_depth) == \
            ref_sei.HASH_FNS[ht](y, cb, cr, bit_depth)
        nal_p = sei.write_picture_hash_sei(y, cb, cr, bit_depth, ht)
        assert nal_p == ref_sei.write_picture_hash_sei(y, cb, cr,
                                                       bit_depth, ht)
        assert sei.parse_picture_hash_sei(nal_p[1]) == \
            (ht, sei.HASH_FNS[ht](y, cb, cr, bit_depth))
    cfg = RefConfig(width=96, height=64, qp=32, vbv_bufsize=400,
                    vbv_maxrate=200)
    for fill in (0.0, 123456.75, 4e5):
        assert sei.write_buffering_period_sei(cfg, fill) == \
            ref_sei.write_buffering_period_sei(cfg, fill)
    for k in range(4):
        assert sei.write_pic_timing_sei(cfg, k) == \
            ref_sei.write_pic_timing_sei(cfg, k)
    for k in range(3):
        assert sei.write_aud(k) == ref_sei.write_aud(k)
    md = ("G(13250,34500)B(7500,3000)R(34000,16000)WP(15635,16450)"
          "L(10000000,1)")
    pairs = [(sei.write_recovery_point_sei(-2),
              ref_sei.write_recovery_point_sei(-2)),
             (sei.write_user_data_sei(b"x265t" * 60),
              ref_sei.write_user_data_sei(b"x265t" * 60)),
             (sei.write_mastering_display_sei(md),
              ref_sei.write_mastering_display_sei(md)),
             (sei.write_content_light_level_sei("1000,400"),
              ref_sei.write_content_light_level_sei("1000,400"))]
    for a, b in pairs:
        assert a == b
    with pytest.raises(ValueError):
        sei.parse_master_display("G(1,2)")


LLC = {"SceneInfo": [{
    "LuminanceParameters": {
        "AverageRGB": 1200, "MaxScl": [40000, 35000, 130000],
        "LuminanceDistributions": {
            "DistributionIndex": [1, 5, 10, 25, 50, 75, 90, 95, 99],
            "DistributionValues": [10, 200, 1000, 5000, 10000, 20000,
                                   30000, 40000, 65600]}},
    "BezierCurveData": {"KneePointX": 100, "KneePointY": 200,
                        "Anchors": [102, 205, 307, 410, 512, 614, 717]},
    "TargetedSystemDisplayMaximumLuminance": 400},
    {"LuminanceParameters": {"AverageRGB": 90, "MaxScl": [1, 2, 3]},
     "TargetedSystemDisplayMaximumLuminance": 1000}]}

LEGACY = [{
    "NumberOfWindows": 2,
    "LuminanceParameters": {
        "AverageRGB": 700, "MaxScl0": 40000, "MaxScl1": 35000,
        "MaxScl2": 30000,
        "PercentileLuminance": {
            "NumberOfPercentiles": 3, "PercentilePercentage0": 1,
            "PercentileLuminance0": 10, "PercentilePercentage1": 50,
            "PercentileLuminance1": 9000, "PercentilePercentage2": 99,
            "PercentileLuminance2": 70000}},
    "BezierCurveData": {"KneePointX": 7, "KneePointY": 9,
                        "NumberOfAnchors": 2, "Anchor0": 300,
                        "Anchor1": 600},
    "LocalParameters": [{
        "WindowData": {"WindowUpperLeftCornerX": 1,
                       "WindowUpperLeftCornerY": 2,
                       "WindowLowerRightCornerX": 90,
                       "WindowLowerRightCornerY": 60},
        "EllipseData": {"CenterOfEllipseX": 45, "CenterOfEllipseY": 30,
                        "RotationAngle": 200,
                        "SemimajorAxisInternalEllipse": 10,
                        "SemimajorAxisExternalEllipse": 20,
                        "SemiminorAxisExternalEllipse": 15,
                        "OverlapProcessOption": 1},
        "BezierCurveData": {"KneePointX": 3, "KneePointY": 4,
                            "NumberOfAnchors": 1, "Anchor0": 512}}],
    "TargetedSystemDisplayMaximumLuminance": 4000}]


@pytest.mark.parametrize("doc", [LLC, LEGACY], ids=["llc", "legacy"])
def test_hdr10plus_payloads_match_reference(doc, tmp_path):
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(doc))
    got = hdr10plus.load_payloads(str(path))
    assert got == ref_hdr.load_payloads(str(path))
    assert len(got) == (2 if doc is LLC else 1)
    for p in got:
        nal_p = hdr10plus.write_t35_sei(p)
        assert nal_p == ref_hdr.write_t35_sei(p)
        assert hdr10plus.parse_t35_seis(nal_p[1]) == [p]


def test_length_prefixed_nal_round_trip():
    """Units with emulation-prone payloads (zero runs, a trailing 03)
    through both NAL forms: the port's bytes and parses equal the
    reference's."""
    rng = np.random.default_rng(9)
    units = []
    for t in (nal.NalUnitType.VPS, nal.NalUnitType.PREFIX_SEI,
              nal.NalUnitType.IDR_W_RADL, nal.NalUnitType.TRAIL_R):
        body = rng.integers(0, 4, 300).astype(np.uint8)
        body[50:60] = 0
        units.append((t, bytes(body) + b"\x80"))
    units.append((nal.NalUnitType.TRAIL_R, b"\x01\x00\x00",
                  b"\x00\x00\x03\x01"))
    annexb = nal.annexb_stream(units)
    assert annexb == ref_nal.annexb_stream(units)
    lp = nal.length_prefixed_stream(units)
    assert lp == ref_nal.length_prefixed_stream(units)
    assert nal.annexb_to_length_prefixed(annexb) == \
        ref_nal.annexb_to_length_prefixed(annexb)
    assert nal.split_annexb(annexb) == ref_nal.split_annexb(annexb)
    assert nal.split_length_prefixed(lp) == ref_nal.split_length_prefixed(lp)
    back = nal.split_length_prefixed(nal.annexb_to_length_prefixed(annexb))
    assert [(t, r) for t, r, _ in back] == \
        [(int(t), r) for t, r, _ in nal.split_annexb(annexb)]
    for t, rbsp in units[:4]:
        esc = nal.emulation_prevention(rbsp)
        assert nal.remove_emulation_prevention(esc) == rbsp
        assert nal.remove_emulation_prevention(esc + b"\x00\x00\x03") == \
            ref_nal.remove_emulation_prevention(esc + b"\x00\x00\x03")


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_y4m_and_yuv_io_match_reference(bit_depth, tmp_path):
    frames = [_planes(bit_depth, 32, 48, seed=s) for s in range(3)]
    paths = {}
    for tag, cls in (("ref", RefY4MWriter), ("port", Y4MWriter)):
        paths[tag] = tmp_path / f"{tag}.y4m"
        wr = cls(str(paths[tag]), 48, 32, 30000, 1001, bit_depth)
        for f in frames:
            wr.write_frame(*f)
        wr.close()
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    rd, rr = Y4MReader(str(paths["ref"])), RefY4MReader(str(paths["ref"]))
    assert (rd.width, rd.height, rd.fps_num, rd.fps_den, rd.bit_depth) == \
        (rr.width, rr.height, rr.fps_num, rr.fps_den, rr.bit_depth) == \
        (48, 32, 30000, 1001, bit_depth)
    got = list(rd)
    assert len(got) == 3
    for a, b, c in zip(got, rr, frames):
        for pa, pb, pc in zip(a, b, c):
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(pa, pc)
    raw = tmp_path / "raw.yuv"
    raw.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    yr = YUVReader(str(raw), 48, 32, bit_depth)
    assert yr.frame_count == 3
    for a, c in zip(yr, frames):
        for pa, pc in zip(a, c):
            np.testing.assert_array_equal(pa, pc)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_psnr_and_ssim_match_reference(bit_depth):
    """psnr, psnr_yuv and the numpy SSIM exact; the torch SSIM against
    the reference's device SSIM within 1e-6 (both float32)."""
    import jax.numpy as jnp
    a = _planes(bit_depth, 64, 96, seed=4)
    rng = np.random.default_rng(6)
    b = tuple(np.clip(p.astype(np.int32) + rng.integers(-9, 9, p.shape), 0,
                      (1 << bit_depth) - 1).astype(p.dtype) for p in a)
    assert metrics.psnr(a[0], b[0], bit_depth) == \
        ref_metrics.psnr(a[0], b[0], bit_depth)
    assert metrics.psnr(a[0], a[0], bit_depth) == 99.99
    assert metrics.psnr_yuv(a, b, bit_depth) == \
        ref_metrics.psnr_yuv(a, b, bit_depth)
    s_np = metrics.ssim_plane(a[0], b[0], bit_depth)
    assert s_np == ref_metrics.ssim_plane(a[0], b[0], bit_depth)
    assert metrics.ssim_to_db(s_np) == ref_metrics.ssim_to_db(s_np)
    s_t = float(metrics.ssim_plane_t(torch.from_numpy(a[0].astype(np.int32)),
                                     torch.from_numpy(b[0].astype(np.int32)),
                                     bit_depth))
    s_j = float(ref_metrics.ssim_plane_j(jnp.asarray(a[0]),
                                         jnp.asarray(b[0]), bit_depth))
    print(f"ssim_plane_t - ssim_plane_j at {bit_depth} bits: "
          f"{abs(s_t - s_j):.3e} (numpy {abs(s_t - s_np):.3e})")
    assert abs(s_t - s_j) <= 1e-6


@pytest.mark.parametrize("out_w,out_h", [(48, 32), (72, 48), (128, 80)])
def test_scale_frame_matches_reference(out_w, out_h):
    """The polyphase scaler, down (the ladder's 2x and 1.33x steps) and
    up, exact sample for sample, in the source dtype."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:64, 0:96]
    y = np.clip((xx * 3 + yy * 2) % 256 + rng.integers(-20, 20, (64, 96)),
                0, 255).astype(np.uint8)
    c = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    frame = (y, c, c[::-1].copy())
    got = scaler.scale_frame(frame, out_w, out_h, device="cpu")
    want = ref_scaler.scale_frame(frame, out_w, out_h)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype == np.uint8
        np.testing.assert_array_equal(g, w_)
    assert got[0].shape == (out_h, out_w)
    assert np.array_equal(scaler._bank(128), ref_scaler._bank(128))
