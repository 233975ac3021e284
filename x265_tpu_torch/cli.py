"""Command-line encoder (the x265 CLI analog) of the GPU port.

Usage:
    python -m x265_tpu_torch.cli in.y4m -o out.hevc --preset fast \
        --tune zerolatency --bitrate 3000 --vbv-maxrate 3000 \
        --vbv-bufsize 6000 --hash 1
    python -m x265_tpu_torch.cli in.yuv --input-res 1920x1080 --fps 25 \
        -o out.hevc --crf 28 --preset fast

Counterpart of x265_tpu/cli.py, flag for flag, writing the same bytes:
rate control (CQP, CRF, ABR, VBV, two-pass), the SEIs and HDR10
metadata, the picture hash, WPP, analysis reuse, qpfile and zones. It
encodes on the GPU; main(argv, device="cpu") runs it on the CPU. A 10-bit
y4m (420p10), or raw input with --input-depth 10, encodes Main10.
Options the package does not port (B frames at CTU 64, which the default
--preset medium sets; SAO at 10 bits, which every preset from veryfast
up sets: add --no-sao) raise NotImplementedError naming their ROADMAP
item before any output file is opened.

Reference surface: x265 source/x265cli.cpp (option names follow it
where the underlying tool exists).
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
import time

import numpy as np

from .bitstream.hdr10plus import load_payloads, write_t35_sei
from .bitstream.nal import annexb_stream, annexb_to_length_prefixed
from .bitstream.sei import (write_aud, write_buffering_period_sei,
                            write_content_light_level_sei,
                            write_mastering_display_sei,
                            write_pic_timing_sei)
from .common.params import EncoderConfig, PRESETS
from .enc import IntraEncoder
from .enc.lookahead import Lookahead, hist_scenecut
from .enc.ratecontrol import RateControl, TwoPassLog, TwoPassRateControl
from .io import Y4MReader, YUVReader, Y4MWriter
from .ops.metrics import ssim_plane, ssim_to_db


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="x265t-torch", description=__doc__)
    p.add_argument("input", help="input video (.y4m or raw .yuv)")
    p.add_argument("-o", "--output", required=True, help="output .hevc")
    p.add_argument("--input-res", help="WxH (raw yuv only)")
    p.add_argument("--fps", type=float, default=25.0, help="raw yuv fps")
    p.add_argument("--input-depth", type=int, default=8)
    p.add_argument("-q", "--qp", type=int, default=32)
    p.add_argument("--bitrate", type=int, default=0,
                   help="target kbps (ABR mode)")
    p.add_argument("--crf", type=float, default=0.0,
                   help="constant rate factor mode")
    p.add_argument("--preset", default="medium", choices=sorted(PRESETS))
    p.add_argument("--tune", default=None,
                   help="psnr/ssim/grain/fastdecode/zerolatency")
    p.add_argument("-I", "--keyint", type=int, default=250)
    p.add_argument("-b", "--bframes", type=int, default=None,
                   help="B frames per mini-GOP (0 = IPPP; >0 = "
                        "hierarchical B pyramid)")
    p.add_argument("--param", action="append", default=[],
                   metavar="K=V", help="set any encoder parameter by "
                   "name (x265_param_parse analog)")
    p.add_argument("--no-sao", dest="no_sao", action="store_true")
    p.add_argument("--no-signhide", action="store_true")
    p.add_argument("--weightp", "-w", dest="weightp", default=None,
                   action="store_true",
                   help="enable weighted prediction in P slices")
    p.add_argument("--no-weightp", dest="weightp", action="store_false")
    p.add_argument("--lossless", action="store_true",
                   help="transquant-bypass lossless coding (all-intra;"
                   " recon == source exactly)")
    p.add_argument("--rdoq-level", type=int, default=None, choices=[0, 1, 2],
                   help="rate-distortion optimized quantization "
                   "(0=off, 1/2=on; batched RDOQ-lite)")
    p.add_argument("-f", "--frames", type=int, default=0,
                   help="max frames to encode (0 = all)")
    p.add_argument("--no-deblock", action="store_true")
    p.add_argument("--sao", action="store_true",
                   help="enable sample adaptive offset")
    p.add_argument("--hash", dest="hash_sei", type=int, nargs="?",
                   const=1, default=0, choices=[0, 1, 2, 3],
                   help="decoded-picture-hash SEI: 1=MD5 2=CRC "
                        "3=checksum")
    p.add_argument("--recon", help="write reconstructed video (.y4m)")
    p.add_argument("--csv", help="per-frame stats CSV")
    p.add_argument("--all-intra", action="store_true",
                   help="force every frame intra (keyint 1)")
    p.add_argument("--pass", dest="rc_pass", type=int, default=0,
                   choices=(0, 1, 2), help="two-pass rate control pass")
    p.add_argument("--stats", default="x265t_2pass.log",
                   help="two-pass stats file")
    p.add_argument("--analysis-save", help="save analysis decisions (.npz)")
    p.add_argument("--analysis-load", help="reuse analysis decisions (.npz)")
    p.add_argument("--aq-mode", type=int, default=None, choices=(0, 1, 2, 3),
                   help="adaptive quantization (per-CTU dQP)")
    p.add_argument("--aq-strength", type=float, default=None)
    p.add_argument("--ssim", action="store_true",
                   help="report SSIM per frame and globally")
    p.add_argument("--vbv-bufsize", type=int, default=0,
                   help="VBV buffer size (kbits)")
    p.add_argument("--vbv-maxrate", type=int, default=0,
                   help="VBV max rate (kbps)")
    p.add_argument("--aud", action="store_true",
                   help="emit access unit delimiters")
    p.add_argument("--sar", default=None,
                   help="pixel aspect ratio W:H (VUI)")
    p.add_argument("--range", dest="vid_range", default=None,
                   choices=["limited", "full"])
    p.add_argument("--colorprim", default=None,
                   help="colour primaries (name or code, e.g. bt2020)")
    p.add_argument("--transfer", default=None,
                   help="transfer characteristics (e.g. smpte2084)")
    p.add_argument("--colormatrix", default=None,
                   help="matrix coefficients (e.g. bt2020nc)")
    p.add_argument("--chromaloc", type=int, default=None,
                   choices=range(6))
    p.add_argument("--master-display", default=None, metavar="MD",
                   help='HDR10 mastering display "G(x,y)B(x,y)R(x,y)'
                   'WP(x,y)L(max,min)"')
    p.add_argument("--max-cll", default=None, metavar="CLL,FALL",
                   help="HDR10 content light level")
    p.add_argument("--dhdr10-info", default=None, metavar="JSON",
                   help="HDR10+ dynamic metadata JSON; per-frame "
                        "ST 2094-40 T.35 SEIs")
    p.add_argument("--dhdr10-opt", action="store_true",
                   help="emit HDR10+ SEI only on IDR frames or when "
                        "the payload changes")
    p.add_argument("--chunk-start", type=int, default=0,
                   help="first frame of this encode chunk (1-based, "
                        "inclusive, x265 numbering). NOTE: unlike "
                        "x265, pre-chunk frames are skipped entirely "
                        "rather than encoded with suppressed output, "
                        "so chunk boundaries start without lookahead "
                        "context")
    p.add_argument("--chunk-end", type=int, default=0,
                   help="last frame of this chunk (1-based, INCLUSIVE, "
                        "x265 numbering; 0 = to the end)")
    p.add_argument("--qpfile",
                   help="per-frame overrides file: '<frame> <I|P|B> "
                        "<qp>' per line (x265 --qpfile)")
    p.add_argument("--zones",
                   help="zone QP overrides: 'start,end,qp=N[/...]' "
                        "(x265 --zones q= form)")
    p.add_argument("--csv-log-level", type=int, default=0,
                   choices=(0, 1, 2), help="1 adds CU distribution + "
                   "frame latency columns; 2 adds intra/merge stats "
                   "and average QP (x265 csv-log-level analog)")
    p.add_argument("--no-annexb", dest="annexb", action="store_false",
                   default=True,
                   help="length-prefixed NAL units instead of Annex-B "
                        "start codes (mp4-track form)")
    p.add_argument("--recon-y4m-exec", metavar="CMD", default=None,
                   help="pipe the reconstruction as Y4M into CMD's "
                        "stdin during the encode (x265 reconplay, "
                        "output/reconplay.cpp)")
    p.add_argument("--frame-dup", action="store_true",
                   help="detect duplicate source frames and code them "
                        "as all-skip pictures (encoder.cpp:172 CFR "
                        "duplication analog)")
    p.add_argument("--dup-threshold", type=float, default=55.0,
                   help="PSNR above which a frame counts as a "
                        "duplicate (x265 --dup-threshold)")
    p.add_argument("--hist-scenecut", action="store_true",
                   help="luma-histogram SAD scene-cut detection "
                        "(encoder.cpp:1361 computeHistograms analog)")
    p.add_argument("--no-progress", dest="progress",
                   action="store_false", default=True,
                   help="disable the console progress meter")
    p.add_argument("--verbose", action="store_true",
                   help="per-frame log lines instead of the meter")
    return p.parse_args(argv)


def open_input(args):
    if args.input.endswith(".y4m"):
        r = Y4MReader(args.input)
        return r, r.width, r.height, r.fps_num, r.fps_den, r.bit_depth
    if not args.input_res:
        sys.exit("raw yuv input requires --input-res WxH")
    w, h = (int(v) for v in args.input_res.lower().split("x"))
    fps_num = int(round(args.fps * 1000))
    r = YUVReader(args.input, w, h, args.input_depth)
    return r, w, h, fps_num, 1000, args.input_depth


def psnr(a: np.ndarray, b: np.ndarray, maxv: int) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(maxv * maxv / max(mse, 1e-12))


def main(argv=None, device=None) -> int:
    """Encode as the arguments say, on device (the GPU by default)."""
    args = parse_args(argv)
    reader, w, h, fps_num, fps_den, depth = open_input(args)
    cfg = EncoderConfig(width=w, height=h, fps_num=fps_num, fps_den=fps_den,
                        bit_depth=depth, qp=args.qp, keyint=args.keyint)
    if args.bitrate:
        cfg.rc_mode = "abr"
        cfg.bitrate = args.bitrate
    elif args.crf:
        cfg.rc_mode = "crf"
        cfg.crf = args.crf
    cfg.apply_preset(args.preset)
    if args.tune:
        cfg.apply_tune(args.tune)
    if args.no_deblock:
        cfg.deblock = False
    if args.sao:
        cfg.sao = True
    if args.no_sao:
        cfg.sao = False
    if args.no_signhide:
        cfg.sign_hiding = False
    if args.weightp is not None:
        cfg.weightp = args.weightp
    if args.rdoq_level is not None:
        cfg.rdoq = args.rdoq_level > 0
    if args.hash_sei:
        cfg.hash_sei = args.hash_sei
    if args.bframes is not None:
        cfg.bframes = args.bframes
    if cfg.bframes:
        cfg.num_refs = 2
    if args.vbv_bufsize:
        cfg.vbv_bufsize = args.vbv_bufsize
    if args.vbv_maxrate:
        cfg.vbv_maxrate = args.vbv_maxrate
    if args.aud:
        cfg.aud = True
    if args.sar:
        sw, sh = args.sar.replace(":", "x").split("x")
        cfg.sar = (int(sw), int(sh))
    if args.vid_range:
        cfg.video_full_range = args.vid_range == "full"
    # H.273 code points by name (x265 strtable analogs, x265cli.h)
    _CSP_NAMES = {"bt709": 1, "unknown": 2, "bt470m": 4, "bt470bg": 5,
                  "smpte170m": 6, "smpte240m": 7, "film": 8,
                  "bt2020": 9, "smpte428": 10, "smpte431": 11,
                  "smpte432": 12}
    _XFER_NAMES = {"bt709": 1, "unknown": 2, "bt470m": 4, "bt470bg": 5,
                   "smpte170m": 6, "smpte240m": 7, "linear": 8,
                   "log100": 9, "log316": 10, "iec61966-2-4": 11,
                   "bt1361e": 12, "iec61966-2-1": 13, "bt2020-10": 14,
                   "bt2020-12": 15, "smpte2084": 16, "smpte428": 17,
                   "arib-std-b67": 18}
    _MTX_NAMES = {"gbr": 0, "bt709": 1, "unknown": 2, "fcc": 4,
                  "bt470bg": 5, "smpte170m": 6, "smpte240m": 7,
                  "ycgco": 8, "bt2020nc": 9, "bt2020c": 10,
                  "smpte2085": 11, "chroma-derived-nc": 12,
                  "chroma-derived-c": 13, "ictcp": 14}

    def _code(v, table):
        return int(v) if v.isdigit() else table[v.lower()]

    if args.colorprim:
        cfg.colorprim = _code(args.colorprim, _CSP_NAMES)
    if args.transfer:
        cfg.transfer = _code(args.transfer, _XFER_NAMES)
    if args.colormatrix:
        cfg.colormatrix = _code(args.colormatrix, _MTX_NAMES)
    if args.chromaloc is not None:
        cfg.chromaloc = args.chromaloc
    if args.master_display:
        cfg.master_display = args.master_display
    if args.max_cll:
        cfg.max_cll = args.max_cll
    if args.dhdr10_info:
        cfg.dhdr10_info = args.dhdr10_info
        cfg.dhdr10_opt = args.dhdr10_opt
    if args.aq_mode is not None:
        cfg.aq_mode = args.aq_mode
    if args.aq_strength is not None:
        cfg.aq_strength = args.aq_strength
    for kv in args.param:
        k, _, v = kv.partition("=")
        cfg.param_parse(k, v)
    if args.lossless:
        cfg.lossless = True
        cfg.deblock = cfg.sao = cfg.sign_hiding = cfg.rdoq = False
        cfg.aq_mode = 0
        cfg.cutree = False
        args.all_intra = True        # inter bypass lands later
    if args.all_intra:
        cfg.bframes = 0
    for note in cfg.enforce_level():
        print(f"x265t [level]: {note}", file=sys.stderr)
    enc = IntraEncoder(cfg, device=device)
    rc = RateControl(cfg)
    la = Lookahead(cfg)
    pass1_log = TwoPassLog(args.stats) if args.rc_pass == 1 else None
    rc2 = None
    if args.rc_pass == 2:
        rc2 = TwoPassRateControl(cfg, TwoPassLog.read(args.stats))
    analysis_store = [] if args.analysis_save else None
    analysis_src = None
    if args.analysis_load:
        analysis_src = np.load(args.analysis_load, allow_pickle=True)
    if args.all_intra:
        la.keyint = 1
    # qpfile: {frame: (type, qp)} (x265cli qpfile parser analog)
    qpfile_map = {}
    if args.qpfile:
        with open(args.qpfile) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    qpfile_map[int(parts[0])] = (parts[1].upper(),
                                                 int(parts[2]))
    # zones: list of (start, end, qp)
    zones = []
    if args.zones:
        for z in args.zones.split("/"):
            se, _, q = z.partition("qp=")
            s, e = (int(v) for v in se.rstrip(",").split(",")[:2])
            zones.append((s, e, int(q)))
    prev_y = None
    maxv = (1 << depth) - 1

    out = open(args.output, "wb")
    recon_w = None
    if args.recon:
        recon_w = Y4MWriter(args.recon, w, h, fps_num, fps_den, depth)
    recon_play = None
    if args.recon_y4m_exec:
        # reconplay: feed the recon into a player's stdin as Y4M
        # (x265 output/reconplay.cpp pipes into e.g. ffplay)
        recon_play = subprocess.Popen(
            shlex.split(args.recon_y4m_exec), stdin=subprocess.PIPE)
        c = "420mpeg2" if depth == 8 else f"420p{depth}"
        recon_play.stdin.write(
            f"YUV4MPEG2 W{w} H{h} F{fps_num}:{fps_den} Ip A0:0 "
            f"C{c}\n".encode("ascii"))
    csv = open(args.csv, "w") if args.csv else None
    if csv:
        cols = "poc,type,qp,bits,psnr_y"
        if args.csv_log_level >= 1:
            cols += ",cu_pct_d0,cu_pct_d1,cu_pct_d2,wall_s"
        if args.csv_log_level >= 2:
            cols += ",intra_pct,merge_zero_pct,avg_qp"
        csv.write(cols + "\n")

    total_bits = 0
    n = 0
    t0 = time.perf_counter()
    psnr_acc = 0.0
    gop_buf: list = []          # pending display frames for a mini-GOP
    gop_base = 0                # display index of the current anchor
    last_anchor_y = None        # source luma of the last coded anchor
    #                             (B-adapt lowres costs reference it)

    ssim_acc = 0.0
    au_since_bp = 0
    dhdr10_payloads = None
    dhdr10_last = None
    if cfg.dhdr10_info:
        dhdr10_payloads = load_payloads(cfg.dhdr10_info)
    # source frames skipped before this chunk (1-based inclusive
    # numbering, matching x265 --chunk-start)
    chunk_skip = (args.chunk_start - 1) if args.chunk_start else 0

    def emit(res, orig, ftype, fqp, disp=None):
        nonlocal total_bits, psnr_acc, ssim_acc, n, au_since_bp, \
            dhdr10_last
        if disp is None:
            disp = n                 # display == decode order
        # AU prefix: delimiter + HRD timing SEIs (frameencoder.cpp
        # :468-792 AUD/SEI emission analog)
        pre = []
        if cfg.aud:
            pic_type = 0 if cfg.keyint == 1 else (2 if cfg.bframes else 1)
            pre.append(write_aud(pic_type))
        if cfg.vbv_enabled:
            if ftype == "I":
                pre.append(write_buffering_period_sei(cfg, rc.vbv_fill))
                au_since_bp = 0
            pre.append(write_pic_timing_sei(cfg, au_since_bp))
            au_since_bp += 1
        if ftype == "I":
            # HDR10 static metadata rides every keyframe (x265
            # frameencoder.cpp SEIMasteringDisplay/ContentLightLevel)
            if cfg.master_display:
                pre.append(write_mastering_display_sei(cfg.master_display))
            if cfg.max_cll:
                pre.append(write_content_light_level_sei(cfg.max_cll))
        if dhdr10_payloads:
            # HDR10+ dynamic metadata (ST 2094-40), one T.35 prefix
            # SEI per source frame (frameencoder.cpp:1105 analog),
            # indexed by the frame's SOURCE index (display order plus
            # any skipped chunk prefix — the reference indexes
            # m_cim[POC], i.e. source order). --dhdr10-opt emits on
            # IDR OR whenever the payload changes (writeToneMapInfo's
            # payloadChange || isIDR). The last JSON entry repeats
            # for any trailing frames, matching the reference's
            # scene-persistent semantics.
            src = chunk_skip + disp
            payload = dhdr10_payloads[min(src, len(dhdr10_payloads) - 1)]
            if not cfg.dhdr10_opt or ftype == "I" or \
                    payload != dhdr10_last:
                pre.append(write_t35_sei(payload))
                dhdr10_last = payload
        if pre:
            au_pre = annexb_stream(pre)
        else:
            au_pre = b""
        if args.annexb:
            out.write(au_pre + res.bitstream)
        else:
            out.write(annexb_to_length_prefixed(au_pre + res.bitstream))
        total_bits += res.bits
        py = psnr(res.recon.y[:h, :w], np.asarray(orig[0]), maxv)
        psnr_acc += py
        ssim_txt = ""
        if args.ssim:
            sv = ssim_plane(np.asarray(orig[0]),
                            np.asarray(res.recon.y[:h, :w]), depth)
            ssim_acc += sv
            ssim_txt = f" SSIM {sv:.5f}"
        if recon_w:
            recon_w.write_frame(res.recon.y[:h, :w],
                                res.recon.cb[:h // 2, :w // 2],
                                res.recon.cr[:h // 2, :w // 2])
        if recon_play is not None and recon_play.poll() is None:
            try:
                recon_play.stdin.write(b"FRAME\n")
                for pl in (res.recon.y[:h, :w],
                           res.recon.cb[:h // 2, :w // 2],
                           res.recon.cr[:h // 2, :w // 2]):
                    dt8 = np.uint8 if depth == 8 else np.uint16
                    recon_play.stdin.write(
                        np.asarray(pl).astype(dt8).tobytes())
            except BrokenPipeError:
                pass
        if csv:
            row = f"{n},{ftype},{fqp},{res.bits},{py:.4f}"
            if args.csv_log_level >= 1 and enc.stats.frames:
                fs = enc.stats.frames[-1]
                d = fs.cu_pct_by_depth or (0, 0, 0)
                row += f",{d[0]},{d[1]},{d[2]},{fs.wall_time:.3f}"
            if args.csv_log_level >= 2:
                syn = res.syntax
                i8 = getattr(syn, "intra8", None)
                ipct = float(i8.mean()) * 100 if i8 is not None else \
                    (100.0 if ftype == "I" else 0.0)
                mv = getattr(syn, "mv8", None)
                zpct = float((np.asarray(mv) == 0).all(-1).mean()) \
                    * 100 if mv is not None and ftype != "I" else 0.0
                row += f",{ipct:.2f},{zpct:.2f},{fqp}"
            csv.write(row + "\n")
        if args.verbose:
            print(f"frame {n:5d} {ftype} qp {fqp} bits {res.bits:8d} "
                  f"Y-PSNR {py:6.3f}{ssim_txt}", file=sys.stderr)
        elif args.progress and (n % 5 == 4 or n == 0):
            # console progress meter (x265cli.cpp printStatus analog)
            el = max(time.perf_counter() - t0, 1e-6)
            fps_now = (n + 1) / el
            kbps_now = total_bits * (fps_num / fps_den) \
                / max(n + 1, 1) / 1000
            end = "\r" if sys.stderr.isatty() else "\n"
            print(f"[{n + 1} frames, {fps_now:.2f} fps, "
                  f"{kbps_now:.1f} kb/s]", file=sys.stderr, end=end)
        n += 1

    def flush_minigop(fqp, count=None):
        nonlocal gop_buf, gop_base, last_anchor_y
        if not gop_buf:
            return
        cnt = len(gop_buf) if count is None else min(count, len(gop_buf))
        chunk = gop_buf[:cnt]
        results = enc.encode_minigop(chunk, qp=fqp)
        n0 = n                       # display index of chunk[0]
        for res in results:
            i = res.poc - gop_base - 1
            emit(res, chunk[i], res.ftype, fqp, disp=n0 + i)
            rc.frame_done(res.bits, fqp, 1.0, False)
        gop_base += cnt
        last_anchor_y = chunk[-1][0]
        gop_buf = gop_buf[cnt:]

    src_idx = -1                # source frame index (pre-chunk)
    for frame in reader:
        src_idx += 1
        # chunk bounds: x265 numbering (--chunk-start/--chunk-end are
        # 1-based and BOTH inclusive, encoder.cpp chunkStart
        # (m_outputCount+1) >= chunkStart). Divergence from x265: the
        # reference still runs pre-chunk frames through the encoder
        # for lookahead context and only suppresses their output; here
        # pre-chunk frames are skipped entirely (see --chunk-start
        # help text).
        if args.chunk_start and src_idx + 1 < args.chunk_start:
            continue
        if args.chunk_end and src_idx + 1 > args.chunk_end:
            break
        if args.frames and n + len(gop_buf) >= args.frames:
            break
        y, cb, cr = frame
        if rc2 is not None:
            ftype2, fqp = rc2.frame_qp()
            is_intra = ftype2 == "I"
            cplx = 0.0
        else:
            is_intra = la.decide(y) == "I"
            if args.hist_scenecut and prev_y is not None \
                    and not is_intra:
                is_intra = hist_scenecut(prev_y, y)
            cplx = rc.frame_complexity(np.asarray(y),
                                       None if is_intra else prev_y)
            fqp = rc.frame_qp(is_intra, cplx)
        if args.frame_dup and prev_y is not None and not is_intra \
                and cfg.bframes == 0 and enc.ref is not None:
            dpy = psnr(np.asarray(y), prev_y, maxv)
            if dpy >= args.dup_threshold:
                # duplicate source frame: all-skip picture copies the
                # reference exactly (encoder.cpp:172 CFR dup analog)
                res = enc.encode_dup_frame(qp=fqp)
                rc.frame_done(res.bits, fqp, 0.0, False)
                emit(res, (y, cb, cr), "P", fqp)
                prev_y = np.asarray(y)
                continue
        fidx = n + len(gop_buf)
        if fidx in qpfile_map:          # qpfile overrides type + QP
            ft_o, qp_o = qpfile_map[fidx]
            is_intra = ft_o == "I"
            if qp_o >= 0:
                fqp = qp_o
        for zs, ze, zqp in zones:       # zone QP overrides
            if zs <= fidx <= ze:
                fqp = zqp
        aq_map = None
        if cfg.dqp_enabled:
            # per-frame AQ map around the RC-chosen frame QP (cuTree
            # needs the GOP-batched encode_sequence path)
            aq_map = enc.lookahead_qp_maps([(y, cb, cr)],
                                           base_qp=fqp)[0]
        if is_intra:
            flush_minigop(fqp)
            qp_i = max(fqp - 3, 0) if cfg.keyint > 1 else fqp
            res = enc.encode_frame(y, cb, cr, qp=qp_i,
                                   qp_map=None if aq_map is None
                                   else np.clip(aq_map - (fqp - qp_i),
                                                0, 51))
            enc.ref = res.device_ref     # the recon, kept on the device
            enc.poc = 0
            gop_base = 0
            last_anchor_y = y
            rc.frame_done(res.bits, fqp, cplx, True)
            if pass1_log is not None:
                pass1_log.record("I", fqp, res.bits, max(cplx, 1.0))
            if analysis_store is not None:
                analysis_store.append(dict(type="I",
                                           depth8=res.syntax.depth8))
            emit(res, (y, cb, cr), "I", fqp)
        elif cfg.bframes > 0:
            gop_buf.append((y, cb, cr))
            if len(gop_buf) >= cfg.bframes + 1:
                if cfg.b_adapt and last_anchor_y is not None:
                    # adaptive B placement (slicetypePath analog):
                    # flush only the chosen B-run + its P anchor; the
                    # rest stays queued for the next decision
                    nb = la.plan_minigop(last_anchor_y,
                                         [f[0] for f in gop_buf])
                    flush_minigop(fqp, count=nb + 1)
                else:
                    flush_minigop(fqp)
        else:
            seeds16 = None
            if analysis_src is not None:
                # analysis reuse: prior-pass MVs seed the windowed
                # search (readAnalysisFile analog, encoder.cpp:4324)
                stored = analysis_src["frames"]
                if n < len(stored) and stored[n].get("type") == "P":
                    mv8 = np.asarray(stored[n]["mv8"], np.int32)
                    by16 = mv8.shape[0] // 2
                    bx16 = mv8.shape[1] // 2
                    s = mv8[:by16 * 2, :bx16 * 2] \
                        .reshape(by16, 2, bx16, 2, 2).mean((1, 3))
                    seeds16 = np.round(s / 4.0).astype(np.int32)[None]
            res = enc.encode_pgop([(y, cb, cr)], qp=fqp,
                                  qp_maps=None if aq_map is None
                                  else aq_map[None],
                                  seeds16=seeds16)[0]
            rc.frame_done(res.bits, fqp, cplx, False)
            if pass1_log is not None:
                pass1_log.record("P", fqp, res.bits, max(cplx, 1.0))
            if analysis_store is not None:
                analysis_store.append(dict(type="P",
                                           depth8=res.syntax.depth8,
                                           mv8=res.syntax.mv8))
            emit(res, (y, cb, cr), "P", fqp)
        prev_y = np.asarray(y)
    flush_minigop(cfg.qp)
    dt = time.perf_counter() - t0
    out.close()
    if recon_w:
        recon_w.close()
    if recon_play is not None:
        try:
            recon_play.stdin.close()
        except Exception:
            pass
        recon_play.wait()
    if csv:
        csv.close()
    if pass1_log is not None:
        pass1_log.write()
    if analysis_store is not None:
        np.savez_compressed(args.analysis_save,
                            frames=np.array(analysis_store, dtype=object))
    fps = n / dt if dt > 0 else 0
    kbps = total_bits * (fps_num / fps_den) / max(n, 1) / 1000
    extra = ""
    if args.ssim and n:
        mean_ssim = ssim_acc / n
        extra = f", SSIM {mean_ssim:.5f} ({ssim_to_db(mean_ssim):.3f} dB)"
    print(f"encoded {n} frames in {dt:.2f}s ({fps:.2f} fps), "
          f"{kbps:.1f} kb/s, avg Y-PSNR {psnr_acc / max(n, 1):.3f} dB"
          f"{extra}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
