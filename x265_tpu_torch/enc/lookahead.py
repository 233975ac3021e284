"""Frame-type decisions on the host (numpy): keyint + scene-cut
detection, the adaptive B-run length of a mini-GOP, and the histogram
scene cut. A copy of x265_tpu/enc/lookahead.py, which needs no device.

Reference behavior: x265 source/encoder/slicetype.cpp scenecut
detection (:2229) compares the inter cost of a frame against its intra
cost; a frame whose best inter prediction is nearly as expensive as
coding it intra marks a scene change and forces an IDR. plan_minigop is
the greedy form of the B-adapt trellis (slicetypePath, :2378).
"""

from __future__ import annotations

import numpy as np

from ..common.params import EncoderConfig


class Lookahead:
    # cut when inter cost exceeds (1 - scenecut/100) * intra cost;
    # x265 default --scenecut 40 -> factor 0.6 (slicetype.cpp:2229)
    SCENECUT_BIAS = 0.6

    def __init__(self, cfg: EncoderConfig) -> None:
        self.cfg = cfg
        self.keyint = max(cfg.keyint, 1)
        self.since_idr = 0
        self.prev_half: np.ndarray | None = None

    @staticmethod
    def _half(y: np.ndarray) -> np.ndarray:
        f = 4 if min(y.shape) >= 480 else 2
        return y[::f, ::f].astype(np.int32)

    @staticmethod
    def _intra_energy(h: np.ndarray) -> float:
        """Lowres gradient energy: the lowres intra-cost proxy."""
        gx = np.abs(np.diff(h, axis=1)).sum()
        gy = np.abs(np.diff(h, axis=0)).sum()
        return float(gx + gy) + 1.0

    @staticmethod
    def _inter_cost(h: np.ndarray, prev: np.ndarray) -> float:
        """Global-motion-compensated lowres SAD (the lookahead inter-cost
        proxy; x265 uses per-block lowres ME, slicetype.cpp:3216)."""
        best = np.inf
        hh, ww = h.shape
        for dy in (-4, -2, -1, 0, 1, 2, 4):
            for dx in (-4, -2, -1, 0, 1, 2, 4):
                c = h[max(dy, 0):hh + min(dy, 0), max(dx, 0):ww + min(dx, 0)]
                p = prev[max(-dy, 0):hh + min(-dy, 0),
                         max(-dx, 0):ww + min(-dx, 0)]
                sad = float(np.abs(c - p).mean())
                if sad < best:
                    best = sad
        return best * h.size

    # -- B-adapt (the slicetypePath analog, slicetype.cpp:2378) ------------

    _SHIFTS = [(dy, dx)
               for dy in (-8, -6, -4, -3, -2, -1, 0, 1, 2, 3, 4, 6, 8)
               for dx in (-8, -6, -4, -3, -2, -1, 0, 1, 2, 3, 4, 6, 8)]

    @classmethod
    def _block_cost(cls, cur: np.ndarray, ref: np.ndarray) -> np.ndarray:
        """Per-8x8-block lowres motion-compensated SAD: min over a
        small shift set (the lowres-ME cost proxy of estimateCUCost,
        slicetype.cpp:3216)."""
        hh, ww = cur.shape
        by, bx = hh // 8, ww // 8
        best = None
        for dy, dx in cls._SHIFTS:
            p = np.roll(np.roll(ref, dy, axis=0), dx, axis=1)
            d = np.abs(cur - p)[:by * 8, :bx * 8]
            blk = d.reshape(by, 8, bx, 8).sum((1, 3))
            best = blk if best is None else np.minimum(best, blk)
        return best

    @classmethod
    def _best_shift(cls, cur: np.ndarray, ref: np.ndarray):
        best, arg = np.inf, (0, 0)
        for dy, dx in cls._SHIFTS:
            p = np.roll(np.roll(ref, dy, axis=0), dx, axis=1)
            s = float(np.abs(cur - p).sum())
            if s < best:
                best, arg = s, (dy, dx)
        return arg

    @classmethod
    def _bi_cost(cls, cur: np.ndarray, p0: np.ndarray,
                 p1: np.ndarray) -> float:
        """Lowres B-frame cost: per-block min of uni-L0, uni-L1 and a
        bidir average at the globally best shifts (x264's lowres
        bidir try)."""
        u0 = cls._block_cost(cur, p0)
        u1 = cls._block_cost(cur, p1)
        d0, x0 = cls._best_shift(cur, p0)
        d1, x1 = cls._best_shift(cur, p1)
        m0 = np.roll(np.roll(p0, d0, axis=0), x0, axis=1)
        m1 = np.roll(np.roll(p1, d1, axis=0), x1, axis=1)
        bi = (m0 + m1 + 1) >> 1
        hh, ww = cur.shape
        by, bx = hh // 8, ww // 8
        bb = np.abs(cur - bi)[:by * 8, :bx * 8] \
            .reshape(by, 8, bx, 8).sum((1, 3))
        return float(np.minimum(np.minimum(u0, u1), bb).sum())

    def plan_minigop(self, anchor_y: np.ndarray, ys: list,
                     max_b: int | None = None) -> int:
        """Adaptive B count (the slicetypePath trellis, greedy form):
        given the last coded anchor's SOURCE and the next queued
        sources, choose how many leading frames to code as B before
        the next P anchor. Minimizes the average lowres cost per
        consumed frame over paths B^L P, L in [0, min(max_b,
        len(ys)-1)] — fades and erratic motion (where bi-prediction
        from mismatched anchors is poor) fall back to P runs."""
        max_b = self.cfg.bframes if max_b is None else max_b
        a0 = self._half(np.asarray(anchor_y))
        hs = [self._half(np.asarray(y)) for y in ys]
        n = len(hs)
        avgs = []
        for L in range(0, min(max_b, n - 1) + 1):
            anchor = hs[L]
            total = float(self._block_cost(anchor, a0).sum())
            for k in range(L):
                total += self._bi_cost(hs[k], a0, anchor)
            avgs.append(total / (L + 1))
        # near-ties go to the LONGER B run (B frames cost fewer bits
        # at equal lowres distortion — the B-bias of slicetypePath)
        best = min(avgs)
        best_l = 0
        for L, a in enumerate(avgs):
            if a <= best * 1.05 + 1e-6:
                best_l = L
        return best_l

    def decide(self, y: np.ndarray) -> str:
        """Returns 'I' or 'P' for the next frame, updating state."""
        h = self._half(np.asarray(y))
        prev = self.prev_half
        self.prev_half = h
        if prev is None or self.since_idr >= self.keyint - 1:
            self.since_idr = 0
            return "I"
        inter = self._inter_cost(h, prev)
        intra = self._intra_energy(h)
        if inter > self.SCENECUT_BIAS * intra:
            self.since_idr = 0
            return "I"
        self.since_idr += 1
        return "P"


def hist_scenecut(prev_y: np.ndarray, y: np.ndarray,
                  threshold: float = 0.12) -> bool:
    """Luma-histogram SAD scene-cut (the encoder.cpp:1361
    computeHistograms / x265 --hist-scenecut analog): normalized SAD
    of 64-bin luma histograms plus a Sobel edge-density delta; either
    signal past its threshold marks a cut."""
    a = np.asarray(prev_y).astype(np.int32)
    b = np.asarray(y).astype(np.int32)
    ha = np.bincount((a >> 2).reshape(-1), minlength=64)[:64]
    hb = np.bincount((b >> 2).reshape(-1), minlength=64)[:64]
    n = max(a.size, 1)
    sad = float(np.abs(ha - hb).sum()) / (2.0 * n)

    def edges(p):
        gx = np.abs(p[1:-1, 2:] - p[1:-1, :-2])
        gy = np.abs(p[2:, 1:-1] - p[:-2, 1:-1])
        return float(((gx + gy) > 48).mean())

    return sad > threshold or abs(edges(a) - edges(b)) > 0.08
