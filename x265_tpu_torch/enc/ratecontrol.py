"""Frame-level rate control on the host: CQP / CRF / ABR, the
frame-level VBV clamp and the two-pass log. A copy of
x265_tpu/enc/ratecontrol.py (float64 host arithmetic, the same
operation order, so every QP, the VBV fill and the two-pass text equal
the reference's).

The model is the x264-lineage controller x265 uses (reference:
source/encoder/ratecontrol.cpp rateEstimateQscale:1746, updateVbv,
qScale2qp): blurred SATD complexity drives qscale through qcompress,
ABR applies a wanted-bits feedback window, I frames get the ip-factor
discount. Row-level VBV re-encode (frameencoder.cpp:1632) is not
implemented: a predictive per-frame clamp takes its place.
"""

from __future__ import annotations

import math

import numpy as np

from ..common.params import EncoderConfig


def qp_to_qscale(qp: float) -> float:
    return 0.85 * math.pow(2.0, (qp - 12.0) / 6.0)


def qscale_to_qp(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(qscale / 0.85)


class RateControl:
    QCOMPRESS = 0.6
    IP_FACTOR = 1.4
    RATE_TOLERANCE = 1.0

    def __init__(self, cfg: EncoderConfig) -> None:
        self.cfg = cfg
        self.mode = cfg.rc_mode
        self.fps = cfg.fps_num / max(cfg.fps_den, 1)
        self.bitrate = cfg.bitrate * 1000.0
        self.frame_count = 0
        self.total_bits = 0.0
        self.wanted_bits = 0.0
        self.short_cplx_sum = 0.0
        self.short_cplx_count = 0.0
        self.cplx_window_n = 0.0
        self.cplxr_sum = 0.01
        self.last_qp = float(cfg.qp)
        # frame-level VBV (ratecontrol.cpp:2750 updateVbv; the row
        # re-encode machinery is replaced by a predictive per-frame
        # clamp within x265's own 1-5% VBV test tolerance)
        self.vbv = cfg.vbv_enabled
        self.vbv_size = cfg.vbv_bufsize * 1000.0
        self.vbv_rate = cfg.vbv_maxrate * 1000.0
        self.vbv_fill = self.vbv_size * cfg.vbv_init
        self.vbv_underflows = 0
        self.bits_per_qscale = 0.0    # running bits*qscale predictor
        ncu = ((cfg.width_padded + 15) // 16) * ((cfg.height_padded + 15) // 16)
        base_cplx = ncu * 80.0
        self.rate_factor_crf = math.pow(base_cplx, 1 - self.QCOMPRESS) / \
            qp_to_qscale(cfg.crf)
        if self.mode == "abr":
            # x264-lineage ABR init: plausible starting complexity and a
            # one-frame wanted-bits window. Both accumulators decay at
            # the SAME rate (frame_done), so their ratio is an unbiased
            # bits-per-complexity estimate — decaying only one of them
            # biased the model ~8-11% high on short encodes
            # (ratecontrol.cpp:1746 rateEstimateQscale discipline).
            self.cplxr_sum = 0.01 * math.pow(7e5, self.QCOMPRESS) * \
                math.pow(ncu, 0.5)
            self.wanted_bits_window = self.bitrate / max(self.fps, 1e-9)

    def frame_complexity(self, y: np.ndarray,
                         prev_y: np.ndarray | None) -> float:
        """Half-res complexity proxy (the lookahead satdCost analog)."""
        d = y[::2, ::2].astype(np.int32)
        if prev_y is None:
            gx = np.abs(np.diff(d, axis=1)).sum()
            gy = np.abs(np.diff(d, axis=0)).sum()
            return float(gx + gy)
        p = prev_y[::2, ::2].astype(np.int32)
        return float(np.abs(d - p).sum())

    def frame_qp(self, is_intra: bool, complexity: float) -> int:
        if self.mode == "cqp":
            return self.cfg.qp
        self.short_cplx_sum = self.short_cplx_sum * 0.5 + complexity
        self.short_cplx_count = self.short_cplx_count * 0.5 + 1.0
        blur = max(self.short_cplx_sum / self.short_cplx_count, 1.0)
        if self.mode == "crf":
            qscale = math.pow(blur, 1 - self.QCOMPRESS) / self.rate_factor_crf
        else:   # abr
            w_frame = self.bitrate / max(self.fps, 1e-9)
            if self.cplx_window_n > 0:
                # direct budget solve: the running bits*qscale/rceq
                # average predicts this frame's bits at any qscale, so
                # set qscale to hit the per-frame budget plus half the
                # accumulated error (an x264 rateEstimateQscale recast:
                # the pure cplxr model's B*Q product is scale-invariant
                # and only regulates rate through a slow clamp)
                err = self.total_bits - w_frame * self.frame_count
                desired = w_frame - 0.5 * err
                desired = min(max(desired, 0.33 * w_frame),
                              3.0 * w_frame)
                avg_bqr = self.cplxr_sum / self.cplx_window_n
                qscale = math.pow(blur, 1 - self.QCOMPRESS) * avg_bqr \
                    / max(desired, 1e-9)
            else:
                # no data yet: blind-seeded model for the first frame
                rate_factor = self.wanted_bits_window / self.cplxr_sum
                qscale = math.pow(blur, 1 - self.QCOMPRESS) / \
                    max(rate_factor, 1e-9)
        if is_intra:
            qscale /= self.IP_FACTOR
        qp = qscale_to_qp(max(qscale, 1e-6))
        if self.frame_count > 0:
            qp = min(max(qp, self.last_qp - 4), self.last_qp + 4)
        # VBV overrides the smoothing clamp (emergency raises must not
        # be smoothed away — the clipQscale-after-step-limit order)
        qscale = self._clip_vbv(qp_to_qscale(qp), is_intra)
        qp = qscale_to_qp(max(qscale, 1e-6))
        qp = int(round(min(max(qp, 0), 51)))
        self.last_qp = float(qp)
        return qp

    def _clip_vbv(self, qscale: float, is_intra: bool) -> float:
        """Predictive per-frame VBV clamp (clipQscale analog,
        ratecontrol.cpp:2100): raise qscale until the predicted frame
        bits fit the buffer; emergency-raise toward qp 51 when nearly
        empty."""
        if not self.vbv or self.bits_per_qscale <= 0:
            return qscale
        budget = self.vbv_fill + self.vbv_rate / self.fps
        # keep a safety floor of 10% buffer after this frame
        allowed = max(budget - 0.1 * self.vbv_size, 0.05 * self.vbv_size)
        pred = self.bits_per_qscale / max(qscale, 1e-9)
        if is_intra:
            pred *= self.IP_FACTOR
        for _ in range(16):
            if pred <= allowed:
                break
            qscale *= 1.3
            pred = self.bits_per_qscale / qscale
        return qscale

    def frame_done(self, bits: int, qp: int, complexity: float,
                   is_intra: bool) -> None:
        self.frame_count += 1
        self.total_bits += bits
        if self.vbv:
            self.vbv_fill -= bits
            if self.vbv_fill < 0:
                self.vbv_underflows += 1
                self.vbv_fill = 0.0
            self.vbv_fill = min(self.vbv_fill + self.vbv_rate / self.fps,
                                self.vbv_size)
            qsc = qp_to_qscale(qp)
            self.bits_per_qscale = 0.6 * self.bits_per_qscale + \
                0.4 * bits * qsc if self.bits_per_qscale else bits * qsc
        if self.mode == "abr":
            blur = max(self.short_cplx_sum / max(self.short_cplx_count,
                                                 1e-9), 1.0)
            rceq = max(math.pow(blur, 1 - self.QCOMPRESS), 1e-9)
            qscale = qp_to_qscale(qp) * (self.IP_FACTOR if is_intra else 1.0)
            contrib = bits * qscale / rceq
            decay = 0.5 ** (1.0 / 20.0)        # cplxblur 20 frames
            if self.frame_count == 1:
                # first real data point replaces the blind seed
                self.cplxr_sum = contrib
                self.cplx_window_n = 1.0
            else:
                self.cplxr_sum = decay * self.cplxr_sum + contrib
                self.cplx_window_n = decay * self.cplx_window_n + 1.0
            self.wanted_bits_window = 0.5 * self.wanted_bits_window + \
                self.bitrate / self.fps


class TwoPassLog:
    """Pass-1 stats file + pass-2 target solving (the x265_2pass.log
    analog, reference: ratecontrol.cpp writeRateControlFrameStats:2973 /
    initPass2:997)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.frames: list[dict] = []

    def record(self, ftype: str, qp: int, bits: int,
               complexity: float) -> None:
        self.frames.append(dict(type=ftype, qp=qp, bits=bits,
                                cplx=complexity))

    def write(self) -> None:
        with open(self.path, "w") as f:
            f.write("# x265t 2-pass stats v1\n")
            for fr in self.frames:
                f.write(f"{fr['type']} {fr['qp']} {fr['bits']} "
                        f"{fr['cplx']:.1f}\n")

    @classmethod
    def read(cls, path: str) -> "TwoPassLog":
        log = cls(path)
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                t, qp, bits, cplx = line.split()
                log.frames.append(dict(type=t, qp=int(qp), bits=int(bits),
                                       cplx=float(cplx)))
        return log


class TwoPassRateControl:
    """Pass-2 controller: solves a global rate factor over the recorded
    complexities so the sequence hits the bit target, then applies the
    same qcompress/ip-factor shaping per frame."""

    QCOMPRESS = RateControl.QCOMPRESS
    IP_FACTOR = RateControl.IP_FACTOR

    def __init__(self, cfg: EncoderConfig, log: TwoPassLog) -> None:
        self.cfg = cfg
        self.log = log
        fps = cfg.fps_num / max(cfg.fps_den, 1)
        target_bits = cfg.bitrate * 1000.0 / fps * len(log.frames)
        # bits scale roughly linearly in 1/qscale at fixed content:
        # estimate per-frame bits(qscale) = k_i / qscale from pass 1
        ks = []
        for fr in log.frames:
            qs = qp_to_qscale(fr["qp"])
            ks.append(fr["bits"] * qs)
        self.ks = ks
        lo, hi = 1e-3, 1e5
        for _ in range(60):        # bisection on the shared rate factor
            mid = (lo + hi) / 2
            est = sum(k / self._qscale_of(i, mid)
                      for i, k in enumerate(ks))
            if est > target_bits:
                lo = mid
            else:
                hi = mid
        self.rate_factor = (lo + hi) / 2
        self.idx = 0

    def _qscale_of(self, i: int, rate_factor: float) -> float:
        fr = self.log.frames[i]
        qs = math.pow(max(fr["cplx"], 1.0), 1 - self.QCOMPRESS) * rate_factor
        if fr["type"] == "I":
            qs /= self.IP_FACTOR
        return max(qs, 1e-6)

    def frame_qp(self) -> tuple[str, int]:
        fr = self.log.frames[self.idx]
        qs = self._qscale_of(self.idx, self.rate_factor)
        self.idx += 1
        qp = int(round(min(max(qscale_to_qp(qs), 0), 51)))
        return fr["type"], qp
