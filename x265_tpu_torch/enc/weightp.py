"""Weighted-prediction analysis for P slices.

The reference analyses explicit weights per frame on the lookahead's
lowres source planes (weightAnalyse, weightPrediction.cpp:222): guess a
scale/offset from plane statistics, then keep the weights only when the
weighted SAD beats the unweighted SAD. This module is the batched
recast: a least-squares fit of cur ~ w*ref + o over subsampled SOURCE
planes (weights never depend on recon, so analysis runs host-side with
no device dependency), gated by the same SAD-improvement test.

The normative application (clause 8.5.4.2.3.3) happens on-device in the
fused P pipeline (ops/me_win.apply_weight_acc) and in the validation
decoder.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WP_DENOM = 6                 # luma_log2_weight_denom (chroma delta 0)
NEUTRAL = (1 << WP_DENOM, 0)


@dataclass
class WeightParams:
    """One P slice's explicit L0 weights (8-bit offset scale; the
    weighting formula shifts offsets by bitDepth-8 at use, matching
    the spec's default-precision offset range)."""
    denom: int = WP_DENOM
    wy: int = 1 << WP_DENOM
    oy: int = 0
    wcb: int = 1 << WP_DENOM
    ocb: int = 0
    wcr: int = 1 << WP_DENOM
    ocr: int = 0

    @property
    def luma_on(self) -> bool:
        return (self.wy, self.oy) != (1 << self.denom, 0)

    @property
    def chroma_on(self) -> bool:
        d = 1 << self.denom
        return (self.wcb, self.ocb, self.wcr, self.ocr) != (d, 0, d, 0)

    def vec(self) -> np.ndarray:
        return np.array([self.wy, self.oy, self.wcb, self.ocb,
                         self.wcr, self.ocr], np.int32)


def _fit_plane(cur: np.ndarray, ref: np.ndarray, bit_depth: int,
               denom: int) -> tuple[int, int]:
    """Moment-matched (w, o): w = sqrt(var_cur/var_ref), o from the
    means (the guessScaleFactor discipline of weightAnalyse,
    weightPrediction.cpp:106). A regression slope is WRONG here: on
    moving texture the co-located planes decorrelate, the slope
    collapses toward zero and the "weighted" predictor degenerates to
    a flat plane that beats the co-located SAD gate while destroying
    the motion-compensated prediction. Variance ratios are invariant
    to motion. Clamped to the syntax ranges of clause 7.4.7.3."""
    c = cur[::2, ::2].astype(np.float64)
    r = ref[::2, ::2].astype(np.float64)
    mc, mr = c.mean(), r.mean()
    vr = ((r - mr) ** 2).mean()
    vc = ((c - mc) ** 2).mean()
    one = 1 << denom
    w = 1.0 if vr < 1.0 else float(np.sqrt(vc / vr))
    wi = int(round(w * one))
    # delta_luma_weight in [-128, 127]
    wi = max(one - 128, min(one + 127, max(wi, 1)))
    o = (mc - wi * mr / one) / (1 << (bit_depth - 8))
    oi = max(-128, min(127, int(round(o))))
    return wi, oi


def _weighted_sad_gain(cur: np.ndarray, ref: np.ndarray, wi: int,
                       oi: int, bit_depth: int, denom: int) -> bool:
    """True when the weighted co-located SAD improves on the plain SAD
    by >1% (the keep/discard gate of weightAnalyse)."""
    c = cur[::2, ::2].astype(np.int64)
    r = ref[::2, ::2].astype(np.int64)
    maxv = (1 << bit_depth) - 1
    wr = np.clip(((wi * r + (1 << (denom - 1))) >> denom)
                 + (oi << (bit_depth - 8)), 0, maxv)
    sad_u = np.abs(c - r).sum()
    sad_w = np.abs(c - wr).sum()
    return sad_w < sad_u * 0.99


def analyse_weights(cur, ref, bit_depth: int = 8,
                    denom: int = WP_DENOM) -> WeightParams:
    """cur/ref: (y, cb, cr) SOURCE plane tuples. Returns WeightParams —
    neutral when no plane benefits (the all-but-fades case)."""
    wp = WeightParams(denom=denom)
    wy, oy = _fit_plane(np.asarray(cur[0]), np.asarray(ref[0]),
                        bit_depth, denom)
    if (wy, oy) != (1 << denom, 0) and _weighted_sad_gain(
            np.asarray(cur[0]), np.asarray(ref[0]), wy, oy, bit_depth,
            denom):
        wp.wy, wp.oy = wy, oy
        # chroma follows only when luma has a real fade (the reference
        # analyses chroma only after luma weights are kept)
        for i, (attr_w, attr_o) in ((1, ("wcb", "ocb")),
                                    (2, ("wcr", "ocr"))):
            wc, oc = _fit_plane(np.asarray(cur[i]), np.asarray(ref[i]),
                                bit_depth, denom)
            if _weighted_sad_gain(np.asarray(cur[i]),
                                  np.asarray(ref[i]), wc, oc,
                                  bit_depth, denom):
                setattr(wp, attr_w, wc)
                setattr(wp, attr_o, oc)
    return wp


def analyse_gop_weights(frames, ref_src, bit_depth: int = 8
                        ) -> list[WeightParams]:
    """Per-frame weights for a P chunk: frame k is predicted from the
    recon of frame k-1, whose SOURCE is frames[k-1] (ref_src for k=0).
    Returns a list of WeightParams, one per frame."""
    out = []
    prev = ref_src
    for f in frames:
        if prev is None:
            out.append(WeightParams())
        else:
            out.append(analyse_weights(f, prev, bit_depth))
        prev = f
    return out
