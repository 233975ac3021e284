"""ABR-ladder multi-encode runner (the abrEncApp analog,
source/abrEncApp.{h,cpp}: a Reader feeds the frames, a Scaler produces
each lower rung's input, one PassEncoder per rung).

Counterpart of x265_tpu/abr.py. Rungs are independent encode chains
that run one after another on one device (the GPU unless device says
otherwise), through the same entry points as the CLI; the scaler runs
on that device too (ops/scaler.py).

Usage:
    python -m x265_tpu_torch.abr in.y4m --rung 1920x1080:3000 \
        --rung 1280x720:1500 --rung 640x360:600 -o out_%dx%d.hevc
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import numpy as np

from .common.params import EncoderConfig, PRESETS
from .enc import IntraEncoder
from .enc.lookahead import Lookahead
from .enc.ratecontrol import RateControl
from .io import Y4MReader, YUVReader
from .ops.scaler import scale_frame


@dataclass
class Rung:
    width: int
    height: int
    bitrate: int          # kbps (0 = CQP at the shared qp)

    @classmethod
    def parse(cls, s: str) -> "Rung":
        res, _, rate = s.partition(":")
        w, h = (int(v) for v in res.lower().split("x"))
        return cls(w, h, int(rate) if rate else 0)


class AbrEncoder:
    """N concurrent encoder instances over one input (AbrEncoder
    analog, abrEncApp.h:41)."""

    def __init__(self, rungs: list[Rung], base_cfg: EncoderConfig,
                 outputs: list, device=None) -> None:
        self.rungs = rungs
        self.device = device
        self.encoders = []
        self.rcs = []
        self.lookaheads = []
        self.outputs = outputs
        for r in rungs:
            cfg = EncoderConfig(**{**base_cfg.__dict__,
                                   "width": r.width, "height": r.height})
            if r.bitrate:
                cfg.rc_mode = "abr"
                cfg.bitrate = r.bitrate
            self.encoders.append(IntraEncoder(cfg, device=device))
            self.rcs.append(RateControl(cfg))
            self.lookaheads.append(Lookahead(cfg))
        self.prev_y = [None] * len(rungs)
        self.frames = 0

    def push_frame(self, frame) -> None:
        """Feed one source frame: scale per rung (Scaler analog) and
        encode (PassEncoder analog)."""
        src_w = np.asarray(frame[0]).shape[1]
        src_h = np.asarray(frame[0]).shape[0]
        for i, rung in enumerate(self.rungs):
            enc = self.encoders[i]
            rc = self.rcs[i]
            la = self.lookaheads[i]
            f = frame if (rung.width, rung.height) == (src_w, src_h) \
                else scale_frame(frame, rung.width, rung.height,
                                 enc.cfg.bit_depth, device=self.device)
            is_intra = la.decide(f[0]) == "I"
            cplx = rc.frame_complexity(
                np.asarray(f[0]),
                None if is_intra else self.prev_y[i])
            fqp = rc.frame_qp(is_intra, cplx)
            if is_intra:
                res = enc.encode_frame(*f, qp=max(fqp - 3, 0))
                enc.ref = res.device_ref
                enc.poc = 0
            else:
                res = enc.encode_pgop([f], qp=fqp)[0]
            rc.frame_done(res.bits, fqp, cplx, is_intra)
            self.prev_y[i] = np.asarray(f[0])
            self.outputs[i].write(res.bitstream)
        self.frames += 1


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="x265t-torch-abr", description=__doc__)
    p.add_argument("input")
    p.add_argument("--input-res", help="WxH (raw yuv)")
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--rung", action="append", required=True,
                   metavar="WxH[:kbps]")
    p.add_argument("-o", "--output", default="abr_%dx%d.hevc",
                   help="output pattern with %%dx%%d")
    p.add_argument("-q", "--qp", type=int, default=32)
    p.add_argument("--preset", default="medium", choices=sorted(PRESETS))
    p.add_argument("-f", "--frames", type=int, default=0)
    args = p.parse_args(argv)

    if args.input.endswith(".y4m"):
        reader = Y4MReader(args.input)
        w, h = reader.width, reader.height
        fps_num, fps_den = reader.fps_num, reader.fps_den
        depth = reader.bit_depth
    else:
        w, h = (int(v) for v in args.input_res.lower().split("x"))
        reader = YUVReader(args.input, w, h, 8)
        fps_num, fps_den, depth = int(args.fps * 1000), 1000, 8

    rungs = [Rung.parse(s) for s in args.rung]
    base = EncoderConfig(width=w, height=h, qp=args.qp, fps_num=fps_num,
                         fps_den=fps_den, bit_depth=depth)
    base.apply_preset(args.preset)
    base.bframes = 0      # ladder rungs run the fused IPPP pipeline
    outs = [open(args.output % (r.width, r.height), "wb")
            for r in rungs]
    abr = AbrEncoder(rungs, base, outs, device=device)
    for frame in reader:
        if args.frames and abr.frames >= args.frames:
            break
        abr.push_frame(frame)
    for o in outs:
        o.close()
    print(f"encoded {abr.frames} frames x {len(rungs)} rungs",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
