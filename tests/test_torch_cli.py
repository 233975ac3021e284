"""The port's CLI, ABR ladder, WPP and analysis reuse on the CPU.

One stream through both packages' CLIs (CQP, --preset ultrafast --tune
zerolatency with psy-rd 0, the hash, AUD, VBV, VUI and HDR10 SEIs,
length-prefixed NAL units): the same bytes, csv rows and recon. The
rate-controlled streams (CRF, ABR + VBV, a two-pass pair) run through
the port alone, and their per-frame types and QPs are held against the
reference's Lookahead and RateControl replayed on the same frames with
the port's bits. Every stream decodes with x265_tpu.decoder, which
verifies each picture's MD5 SEI, to the port's recon. The WPP
substreams and the seeded P chunk are held against the reference's
functions on the same inputs. Tolerance: exact equality."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from x265_tpu.cli import main as ref_cli_main
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc.intra_recon import ReconFrame as RefReconFrame
from x265_tpu.enc.lookahead import Lookahead as RefLookahead
from x265_tpu.enc.pgop_tpu import collect_pgop_tpu, submit_pgop_tpu
from x265_tpu.enc.ratecontrol import (RateControl as RefRateControl,
                                      TwoPassLog as RefTwoPassLog,
                                      TwoPassRateControl as RefTwoPassRC)
from x265_tpu.native import entropy_native as ref_native
from x265_tpu.ops.scaler import scale_frame as ref_scale_frame
from x265_tpu_torch import abr
from x265_tpu_torch.bitstream.ctx_tables import init_states
from x265_tpu_torch.bitstream.nal import nal_header, split_length_prefixed
from x265_tpu_torch.bitstream.sei import parse_picture_hash_sei, picture_md5
from x265_tpu_torch.cli import main as cli_main
from x265_tpu_torch.common.params import EncoderConfig, I_SLICE, P_SLICE
from x265_tpu_torch.convert import config_from_dict, device_ref_from_numpy
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc.pgop_gpu import collect_pgop_gpu, submit_pgop_gpu
from x265_tpu_torch.io import Y4MReader, Y4MWriter
from x265_tpu_torch.native import entropy_native

torch.set_num_threads(2)

MASTER = ("G(13250,34500)B(7500,3000)R(34000,16000)WP(15635,16450)"
          "L(10000000,1)")
FAST = ["--preset", "ultrafast", "--tune", "zerolatency"]


def _clip(n, h=64, w=96, cut=None, seed=11):
    """A textured pan with moving chroma; from frame `cut` on, a smooth
    dark scene (a scene cut)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    base = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255) \
        .astype(np.uint8)
    other = (40 + ((xx + yy) >> 3) + rng.integers(0, 3, (h, w))) \
        .astype(np.uint8)
    cb = np.clip(110 + (xx[::2, ::2] >> 3), 0, 255).astype(np.uint8)
    cr = np.clip(140 - (yy[::2, ::2] >> 2), 0, 255).astype(np.uint8)
    return [(np.roll(other if cut is not None and i >= cut else base,
                     2 * i, axis=1), cb, np.roll(cr, i, axis=0))
            for i in range(n)]


def _write_y4m(path, frames):
    h, w = frames[0][0].shape
    wr = Y4MWriter(str(path), w, h)
    for f in frames:
        wr.write_frame(*f)
    wr.close()
    return str(path)


def _annexb(stream: bytes) -> bytes:
    """A length-prefixed (--no-annexb) stream as Annex-B units."""
    return b"".join(b"\x00\x00\x00\x01" + nal_header(t) + raw
                    for t, _, raw in split_length_prefixed(stream))


def _csv(path):
    """The csv rows with the wall_s column dropped."""
    rows = [r.split(",") for r in open(path).read().splitlines()]
    drop = rows[0].index("wall_s") if "wall_s" in rows[0] else None
    return [[c for k, c in enumerate(r) if k != drop] for r in rows]


def _assert_decodes_to_recon(stream: bytes, recon_path: str):
    """x265_tpu.decoder decodes the stream (checking every MD5 SEI) to
    the planes of the --recon y4m; the port's own SEI parser agrees."""
    dec = decode_annexb(stream)
    rec = list(Y4MReader(recon_path))
    assert len(dec) == len(rec) > 0
    # IPPP streams: decode order is display order
    for i, (d, r) in enumerate(zip(dec, rec)):
        for k, p in zip(("y", "cb", "cr"), r):
            np.testing.assert_array_equal(getattr(d, k), p,
                                          err_msg=f"frame {i} {k}")
    from x265_tpu_torch.bitstream.nal import split_annexb
    hashes = [parse_picture_hash_sei(rb) for t, rb, _ in split_annexb(stream)
              if int(t) == 40]
    assert len(hashes) == len(rec)
    for (ht, digests), r in zip(hashes, rec):
        assert ht == 1 and digests == picture_md5(*r)
    return dec


def test_cli_stream_matches_reference_cli(tmp_path):
    """1 I + 3 P through both CLIs: identical bytes, csv rows (but
    wall_s) and recon; decoder-exact. The ultrafast/zerolatency row
    with psy-rd 0 has intra NxN, weightp and sign hiding off, me_range
    2, TMVP off and merge 2 (ROADMAP item 26). The port's recon also
    goes to --recon-y4m-exec, a `cat` into a file."""
    src = _write_y4m(tmp_path / "in.y4m", _clip(6))
    common = [src, *FAST, "--param", "psy_rd=0", "--hash", "1", "--aud",
              "--vbv-bufsize", "200", "--vbv-maxrate", "100", "--sar", "1:1",
              "--range", "full", "--colorprim", "bt709", "--master-display",
              MASTER, "--max-cll", "1000,400", "--csv-log-level", "2",
              "--no-annexb", "-f", "4", "--no-progress"]
    out = {}
    for tag in ("ref", "port"):
        d = tmp_path / tag
        d.mkdir()
        argv = common + ["-o", str(d / "out.hevc"), "--csv",
                         str(d / "s.csv"), "--recon", str(d / "rec.y4m")]
        if tag == "ref":
            assert ref_cli_main(argv) == 0
        else:
            argv += ["--recon-y4m-exec", f"sh -c 'cat > {d / 'play.y4m'}'"]
            assert cli_main(argv, device="cpu") == 0
        out[tag] = d
    port, ref = out["port"], out["ref"]
    stream = (port / "out.hevc").read_bytes()
    assert stream == (ref / "out.hevc").read_bytes()
    assert _csv(port / "s.csv") == _csv(ref / "s.csv")
    assert len(_csv(port / "s.csv")) == 5
    assert (port / "rec.y4m").read_bytes() == (ref / "rec.y4m").read_bytes()
    assert (port / "play.y4m").read_bytes() == \
        (port / "rec.y4m").read_bytes()
    annexb = _annexb(stream)
    _assert_decodes_to_recon(annexb, str(port / "rec.y4m"))
    from x265_tpu_torch.bitstream.nal import split_annexb
    types = [int(t) for t, _, _ in split_annexb(annexb)]
    assert types.count(35) == 4              # one AUD per access unit
    seis = [rb[0] for t, rb, _ in split_annexb(annexb) if int(t) == 39]
    assert {0, 1, 137, 144} <= set(seis)     # HRD and HDR10 SEIs


def _replay(frames, rows, mode_args, stats=None):
    """The reference's frame types and QPs for the port's csv rows:
    Lookahead.decide + RateControl (or, in pass 2, TwoPassRateControl)
    on the source frames, fed the port's bits."""
    h, w = frames[0][0].shape
    cfg = RefConfig(width=w, height=h, fps_num=25, fps_den=1, qp=32,
                    keyint=250)
    if "bitrate" in mode_args:
        cfg.rc_mode, cfg.bitrate = "abr", mode_args["bitrate"]
    if "crf" in mode_args:
        cfg.rc_mode, cfg.crf = "crf", mode_args["crf"]
    cfg.vbv_bufsize = mode_args.get("vbv_bufsize", 0)
    cfg.vbv_maxrate = mode_args.get("vbv_maxrate", 0)
    assert not cfg.enforce_level()      # no level clamp moved a setting
    if stats is not None:
        rc2 = RefTwoPassRC(cfg, RefTwoPassLog.read(stats))
        return [rc2.frame_qp() for _ in frames]
    la, rc = RefLookahead(cfg), RefRateControl(cfg)
    want, prev = [], None
    for (y, _, _), row in zip(frames, rows):
        intra = la.decide(y) == "I"
        cplx = rc.frame_complexity(y, None if intra else prev)
        qp = rc.frame_qp(intra, cplx)
        want.append(("I" if intra else "P", qp))
        rc.frame_done(int(row[3]), qp, cplx, intra)
        prev = y
    return want


@pytest.mark.parametrize("mode", ["crf", "abr_vbv", "two_pass"])
def test_cli_rate_control_streams(mode, tmp_path):
    """The port's CLI in CRF 28, in ABR + VBV and as a two-pass pair,
    8 frames with a scene cut at frame 5: each frame's (type, qp)
    equals the reference's rate control replayed with the port's bits,
    and each stream is decoder-exact with verified hash SEIs."""
    frames = _clip(8, cut=5)
    src = _write_y4m(tmp_path / "in.y4m", frames)
    args = {"crf": {"crf": 28.0},
            "abr_vbv": {"bitrate": 100, "vbv_bufsize": 50,
                        "vbv_maxrate": 100},
            "two_pass": {"bitrate": 100}}[mode]
    flags = [x for k, v in args.items()
             for x in (f"--{k.replace('_', '-')}", str(v))]
    stats = str(tmp_path / "2pass.log")

    def run(extra):
        argv = [src, "-o", str(tmp_path / "out.hevc"), *FAST, *flags,
                "--hash", "1", "--csv", str(tmp_path / "s.csv"), "--recon",
                str(tmp_path / "rec.y4m"), "--no-progress", *extra]
        assert cli_main(argv, device="cpu") == 0
        return [r for r in _csv(tmp_path / "s.csv")[1:]]

    if mode == "two_pass":
        rows1 = run(["--pass", "1", "--stats", stats])
        assert [(r[1], int(r[2])) for r in rows1] == \
            _replay(frames, rows1, args)
        log = RefTwoPassLog.read(stats)
        assert [(f["type"], f["qp"], f["bits"]) for f in log.frames] == \
            [(r[1], int(r[2]), int(r[3])) for r in rows1]
        rows = run(["--pass", "2", "--stats", stats])
        want = _replay(frames, rows, args, stats=stats)
    else:
        rows = run([])
        want = _replay(frames, rows, args)
    got = [(r[1], int(r[2])) for r in rows]
    assert got == want
    assert [t for t, _ in got] == list("IPPPPIPP")
    assert len({q for _, q in got}) > 1      # the QP moves
    dec = _assert_decodes_to_recon((tmp_path / "out.hevc").read_bytes(),
                                   str(tmp_path / "rec.y4m"))
    # the scene cut's IDR restarts the POCs, as the reference's CLI does
    assert [d.poc for d in dec] == [0, 1, 2, 3, 4, 0, 1, 2]


def test_wpp_substreams_match_reference(tmp_path):
    """encode_slice_wpp_native gives the reference's substreams for the
    same I and P syntax records (two references with TMVP and SAO in
    the P frames); a --param wpp=1 CLI stream is decoder-exact."""
    frames = _clip(3)
    cfg = EncoderConfig(width=96, height=64, qp=30, num_refs=2, tmvp=True,
                        sao=True)
    enc = IntraEncoder(cfg, device="cpu")
    r0 = enc.encode_frame(*frames[0], qp=27)
    enc.ref, enc.poc = r0.device_ref, 0
    ps = enc.encode_pgop(frames[1:], qp=30)
    geo = (96, 64, cfg.log2_ctu, cfg.log2_min_cu)
    s = r0.syntax
    i_args = (2, s.depth8, s.coeff_y, s.coeff_cb, s.coeff_cr, *geo)
    i_kw = dict(mode8=s.mode8, cmode8=s.cmode8, nxn8=s.nxn8, mode4=s.mode4,
                sign_hiding=True, slice_qp=27)
    calls = [(i_args, 27, i_kw)]
    for k, r in enumerate(ps):
        s = r.syntax
        col = None
        if k:
            prev = ps[k - 1].syntax
            col = (prev.mv8, s.col_ref, s.col_inter.astype(np.uint8),
                   prev.poc, s.col_ref_pocs)
        calls.append(((1, s.depth8, s.coeff_y, s.coeff_cb, s.coeff_cr, *geo),
                      30, dict(mv8=s.mv8, max_merge=s.max_merge,
                               sign_hiding=True, sao_params=s.sao_params,
                               slice_qp=30, mode8=s.mode8, intra8=s.intra8,
                               tusplit8=s.tusplit8, rqt_inter=cfg.rqt_inter,
                               ref8=s.ref8, num_ref=s.num_ref,
                               ref_pocs_l0=s.ref_pocs, poc=s.poc, tmvp=True,
                               col=col)))
    assert ps[-1].syntax.num_ref == 2
    for args, qp, kw in calls:
        # the native slice codes are the slice types (I 2, P 1); the
        # coder adapts its context states in place, so each call gets
        # fresh ones
        st = I_SLICE if args[0] == 2 else P_SLICE
        got = entropy_native.encode_slice_wpp_native(
            *args, init_states(st, qp), **kw)
        want = ref_native.encode_slice_wpp_native(
            *args, init_states(st, qp), **kw)
        assert got == want
        assert len(got) == 2 and all(got)     # one substream per CTU row
    src = _write_y4m(tmp_path / "in.y4m", _clip(4))
    out, rec = tmp_path / "wpp.hevc", tmp_path / "rec.y4m"
    assert cli_main([src, "-o", str(out), *FAST, "--param", "wpp=1",
                     "--hash", "1", "--recon", str(rec), "--no-progress"],
                    device="cpu") == 0
    _assert_decodes_to_recon(out.read_bytes(), str(rec))


def test_seeded_p_chunk_matches_reference(tmp_path):
    """submit_pgop_gpu(seeds16=) against the reference's
    submit_pgop_tpu(seeds16=) in the bench configuration, 2 frames
    predicted from the same host picture: every syntax field and the
    recon. Then a port --analysis-save / --analysis-load pair, both
    streams decoder-exact."""
    frames = _clip(3)
    h, w = frames[0][0].shape
    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    rng = np.random.default_rng(4)
    seeds = np.stack([np.stack([np.full((h // 16, w // 16), -2 * (i + 1)),
                                rng.integers(-2, 3, (h // 16, w // 16))], -1)
                      for i in range(2)]).astype(np.int32)

    def stack(k):
        return np.stack([f[k] for f in frames[1:]])

    ref_pic = RefReconFrame(*(p.astype(np.int32) for p in frames[0]))
    syns, recons, _ = collect_pgop_tpu(submit_pgop_tpu(
        stack(0), stack(1), stack(2), ref_pic, rcfg, 32, need_recon=True,
        me_range=rcfg.me_range, seeds16=seeds))
    tsyns, trecons, _ = collect_pgop_gpu(submit_pgop_gpu(
        stack(0), stack(1), stack(2),
        device_ref_from_numpy(*frames[0], device="cpu"), cfg, 32,
        need_recon=True, me_range=cfg.me_range, seeds16=seeds,
        device="cpu"))
    for i in range(2):
        for k in ("depth8", "mv8", "coeff_y", "coeff_cb", "coeff_cr",
                  "intra8", "mode8", "tusplit8", "ref8", "sao_params",
                  "max_merge"):
            a, b = getattr(syns[i], k), getattr(tsyns[i], k)
            assert (a is None) == (b is None), (i, k)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"frame {i} {k}")
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(recons[i], k),
                                          getattr(trecons[i], k))
    assert any((s.mv8 != 0).any() for s in tsyns)

    src = _write_y4m(tmp_path / "in.y4m", _clip(4))
    npz = str(tmp_path / "analysis.npz")
    streams = {}
    for tag, flag in (("save", "--analysis-save"), ("load",
                                                    "--analysis-load")):
        out, rec = tmp_path / f"{tag}.hevc", tmp_path / f"{tag}.y4m"
        assert cli_main([src, "-o", str(out), *FAST, "--hash", "1", flag,
                         npz, "--recon", str(rec), "--no-progress"],
                        device="cpu") == 0
        _assert_decodes_to_recon(out.read_bytes(), str(rec))
        streams[tag] = out.read_bytes()
    stored = np.load(npz, allow_pickle=True)["frames"]
    assert [f["type"] for f in stored] == list("IPPP")


def test_abr_ladder_two_rungs(monkeypatch):
    """A two-rung AbrEncoder (96x64 at ABR 150 kb/s, 48x32 CQP): each
    rung's stream is decoder-exact (every MD5 SEI verified), and the
    lower rung codes the reference's scale_frame of each source
    frame."""
    import io
    frames = _clip(4)
    scaled = []
    real = abr.scale_frame

    def spy(frame, *a, **k):
        scaled.append((frame, real(frame, *a, **k)))
        return scaled[-1][1]

    monkeypatch.setattr(abr, "scale_frame", spy)
    base = EncoderConfig(width=96, height=64, qp=32, hash_sei=1)
    base.apply_preset("ultrafast")
    base.bframes = 0
    outs = [io.BytesIO(), io.BytesIO()]
    ladder = abr.AbrEncoder([abr.Rung(96, 64, 150), abr.Rung(48, 32, 0)],
                            base, outs, device="cpu")
    for f in frames:
        ladder.push_frame(f)
    assert ladder.frames == 4 and len(scaled) == 4
    for src, got in scaled:
        for g, w_ in zip(got, ref_scale_frame(src, 48, 32)):
            np.testing.assert_array_equal(g, w_)
    for k, (o, (rw, rh)) in enumerate(zip(outs, ((96, 64), (48, 32)))):
        dec = decode_annexb(o.getvalue())
        assert len(dec) == 4 and dec[0].y.shape == (rh, rw)
    assert ladder.rcs[0].mode == "abr" and ladder.rcs[1].mode == "cqp"


def test_cli_qpfile_zones_chunks_and_hdr10plus(tmp_path):
    """The port's CLI with a qpfile (an IDR forced at frame 2 with its
    QP), a zone, --chunk-start/--chunk-end, HDR10+ metadata with
    --dhdr10-opt and --ssim: the csv follows the overrides, the T.35
    SEIs are the reference's payloads where the payload changes or the
    frame is an IDR, and the stream is decoder-exact."""
    from x265_tpu.bitstream.hdr10plus import load_payloads, parse_t35_seis
    from x265_tpu_torch.bitstream.nal import split_annexb
    src = _write_y4m(tmp_path / "in.y4m", _clip(7))
    qpf = tmp_path / "qp.txt"
    qpf.write_text("0 I 30\n2 I 36\n")
    meta = tmp_path / "hdr10plus.json"
    scene = {"LuminanceParameters": {"AverageRGB": 7, "MaxScl": [1, 2, 3]},
             "TargetedSystemDisplayMaximumLuminance": 1000}
    meta.write_text(json.dumps({"SceneInfo": [
        scene, scene, {**scene, "TargetedSystemDisplayMaximumLuminance": 400},
        scene, scene, scene, scene]}))
    out, rec, csvp = (tmp_path / "out.hevc", tmp_path / "rec.y4m",
                      tmp_path / "s.csv")
    assert cli_main([src, "-o", str(out), *FAST, "--qpfile", str(qpf),
                     "--zones", "3,3,qp=45", "--chunk-start", "2",
                     "--chunk-end", "6", "--dhdr10-info", str(meta),
                     "--dhdr10-opt", "--ssim", "--hash", "1", "--csv",
                     str(csvp), "--recon", str(rec), "--no-progress"],
                    device="cpu") == 0
    rows = _csv(csvp)[1:]
    assert [(r[1], r[2]) for r in rows] == \
        [("I", "30"), ("P", "32"), ("I", "36"), ("P", "45"), ("P", "32")]
    stream = out.read_bytes()
    _assert_decodes_to_recon(stream, str(rec))
    payloads = load_payloads(str(meta))
    t35 = [p for t, rb, _ in split_annexb(stream) if int(t) == 39
           for p in parse_t35_seis(rb)]
    # source frames 1..5 (chunk 2..6): the IDRs at 1 and 3 and the
    # change at 2 carry theirs; 4 and 5 repeat 3's
    assert t35 == [payloads[1], payloads[2], payloads[3]]


def _dup_clip():
    """_clip(4) with frame 2 repeated: a duplicate for --frame-dup."""
    frames = _clip(4)
    return frames[:3] + [frames[2]] + frames[3:]


# the CLI flags no other test holds against the reference (ROADMAP item
# 24): (extra argv, frames, coded frames at least one of which must be
# the case's kind, or None)
CLI_FLAGS = {
    "hist_scenecut": (["--hist-scenecut"], lambda: _clip(5, cut=3), "I"),
    "all_intra": (["--all-intra"], lambda: _clip(3), "I"),
    "lossless": (["--lossless"], lambda: _clip(2), "I"),
    "aq_mode": (["--aq-mode", "2"], lambda: _clip(4), None),
    # SAO off: the duplicate codes no SAO under an SAO slice header
    # (ROADMAP queue 3)
    "frame_dup": (["--frame-dup", "--no-sao"], _dup_clip, None),
}


@pytest.mark.parametrize("case", sorted(CLI_FLAGS))
def test_cli_flags_match_reference_cli(case, tmp_path):
    """--hist-scenecut (a scene cut at frame 3), --all-intra, --lossless,
    --aq-mode 2 and --frame-dup through both CLIs under --preset
    ultrafast --tune zerolatency with the hash (ROADMAP item 24):
    byte-identical streams,
    csv rows (but wall_s) and recon, and the port's decoder decodes the
    stream to the recon. psy-rd 0 as in
    test_cli_stream_matches_reference_cli, whose reference programs the
    cases then share."""
    from x265_tpu_torch.decoder import decode_annexb as port_decode
    extra, clip, kind = CLI_FLAGS[case]
    frames = clip()
    src = _write_y4m(tmp_path / "in.y4m", frames)
    out = {}
    for tag in ("ref", "port"):
        d = tmp_path / tag
        d.mkdir()
        argv = [src, *FAST, "--param", "psy_rd=0", "--hash", "1", *extra,
                "--no-progress", "-o",
                str(d / "out.hevc"), "--csv", str(d / "s.csv"), "--recon",
                str(d / "rec.y4m")]
        assert (ref_cli_main(argv) if tag == "ref"
                else cli_main(argv, device="cpu")) == 0
        out[tag] = d
    port, ref = out["port"], out["ref"]
    stream = (port / "out.hevc").read_bytes()
    assert stream == (ref / "out.hevc").read_bytes()
    rows = _csv(port / "s.csv")
    assert rows == _csv(ref / "s.csv")
    assert (port / "rec.y4m").read_bytes() == (ref / "rec.y4m").read_bytes()
    rec = list(Y4MReader(str(port / "rec.y4m")))
    dec = port_decode(stream)
    assert len(dec) == len(rec) == len(rows) - 1 == len(frames)
    # zerolatency: decode order is display order
    for i, (dd, r) in enumerate(zip(dec, rec)):
        for k, p in zip(("y", "cb", "cr"), r):
            np.testing.assert_array_equal(getattr(dd, k), p,
                                          err_msg=f"frame {i} {k}")
    types = [r[rows[0].index("type")] for r in rows[1:]]
    if kind:
        assert kind in types[1:], types
    if case == "frame_dup":
        # frame 3 repeats frame 2: an all-skip copy of its recon
        head = rows[0]
        f2, f3 = rows[3], rows[4]
        assert f3[head.index("psnr_y")] == f2[head.index("psnr_y")]
        assert 2 * int(f3[head.index("bits")]) < int(f2[head.index("bits")])
    if case == "lossless":
        for r, f in zip(rec, frames):
            for a, b in zip(r, f):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv,item", [
    ([], 28),
    (["--input-res", "96x64", "--input-depth", "10", "--preset",
      "fast"], 31)], ids=["medium_b_ctu64", "input_depth_10"])
def test_cli_refuses_unported_configurations(argv, item, tmp_path):
    """The default --preset medium (4 B frames at CTU 64) and 10-bit
    input with SAO (--preset fast sets it; the reference codes 10-bit
    SAO offsets with the 8-bit cMax) raise naming their ROADMAP item,
    before any output file is written."""
    if item == 31:
        src = tmp_path / "in.yuv"
        src.write_bytes(np.zeros(96 * 64 * 3, np.uint16).tobytes())
    else:
        src = tmp_path / "in.y4m"
        _write_y4m(src, _clip(2))
    out = tmp_path / "out.hevc"
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}"):
        cli_main([str(src), "-o", str(out), "--csv",
                  str(tmp_path / "s.csv"), *argv], device="cpu")
    assert not out.exists() and not (tmp_path / "s.csv").exists()
