#!/usr/bin/env python3
"""Smoke run of the GPU port on one NVIDIA card: python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. setup: require CUDA, print the card's name and power limit, build
     every CUDA kernel (one nvcc per source, all started together) and
     the native CABAC coder; print each kernel instance's registers,
     spill bytes and shared memory as ptxas reported them, and the
     search instances' SASS (VABSDIFF4 per current-row word, and per
     window row of the unrolled walk its SADs, funnel shifts and shared
     loads), and check that the pair and 32-block search instances'
     SASS equals the parent's build (PARENT_SASS: the 8- and 16-block
     instances have a kernel of their own, and these must not change);
     measure the issue rate per SM clock of VABSDIFF4, SHF and
     IMAD, with FFMA as the yardstick, and of the two 16-bit SADs (the
     packed vabsdiff2 and the scalar half-word vabsdiff the Main10
     search uses; ptxas expands both into integer instructions)
     (csrc/probes/int_rates.cu);
  2. kernel vs plain: the window-gather kernel against its plain PyTorch
     version at the four bench-path window shapes, uint8 and uint16, and
     at the four fast/zerolatency-path shapes (three references stacked
     in one plane; uint8) and the four medium/zerolatency-path shapes
     (three references stacked, me_range 10), the four shapes of the
     fast path with B frames (one reference per plane, me_range 5) and
     the four slow/zerolatency-path shapes (four references stacked,
     me_range 10), exact equality, timed
     beside a one-call PyTorch indexing yardstick and its memory bound,
     and untimed at the placebo/zerolatency shapes (five references,
     me_range 12); the integer-search
     kernel against its plain version at the two bench-path shapes
     (8160 16-regions with their 8-blocks, 2040 32-blocks; side 21, the
     medium/zerolatency path's too: its stacked references change the
     windows' source, not the search's inputs) on
     random, near-flat (ties at many indices) and flat windows (every
     candidate ties, index 0 wins), timed at side 21 and at the
     fast/zerolatency path's side 11 (me_range 5, windows 34 and 50),
     untimed at the odd me_range 7 (side 15, windows 38 and 54, rows not
     4-byte aligned) and at the presets' extremes, me_range 2 and 12
     (sides 5 and 25), exact equality, timed beside its bound; the
     Main10 instances: the uint16 gather at the medium/zerolatency
     shapes (the Main10 CLI cell's) and the uint16 searches at sides
     21, 11, 15, 5 and 25 on random, near-flat and flat 10-bit windows,
     exact, timed at side 21 beside their bounds (the half-word
     vabsdiff's measured rate); every kernel timing taken 3 times in
     turns, with its spread;
  2b. me_size_windowed (the reference's windowed ME of one block size):
     the single search's 8- and 16-block instances (uint8 and uint16,
     lead 0) against their plain version over the 1088x1920 scan at
     sides 5-25 (13: radius 6) on random, near-flat and flat windows
     and at 10 bits the curmax and cur0 extremes; then me_size_windowed
     at n = 8, 16 and 32 (radius 6, pad 20) on the bench clip's frame 1
     against frame 0 and on the 10-bit bench clip's, with
     mc_block_batch_ds at its MVs (luma, cb, cr): 5 gathers and one
     single search at n per size, every output equal to the same path
     with the plain gather and search on the card, pred and the MC equal
     to mc_block_batch at the MVs; each kernel call of the path timed
     alone on its own arguments beside its bound, the 8- and 16-block
     calls with their launch geometry (threads a block, units a warp
     task, lanes a unit, R, resident blocks per SM, registers);
  3. card == CPU: the same clips encoded on the card and on the CPU give
     byte-identical streams (the CPU halves run in a spawned process
     from the start of the run, beside the build, phases 1-2, the card
     halves and phases 3a-3b) (bench configuration: 64x96 1 I + 6 P at
     me_range 10 and at me_range 7, then I + 1 P at the size in
     CARD_CPU_SIZE; fast/zerolatency: a 64x96 strobe clip, 1 I + 6 P in
     chunks of 2, where some blocks must predict from reference 1 or
     later and some CTU must have SAO on, then 1080p I + 1 P;
     medium/zerolatency: a 72x128 clip, 1 I + 6 P in chunks of 2, where
     some CU must be a depth-0 64x64 CU and some block must predict
     from reference 1 or later, then 1080p I + 1 P; placebo/zerolatency
     (RDOQ, 5 references, merge 5, me_range 12): the 72x128 clip, 1 I +
     5 P in one chunk, whose last P frame must list five references;
     noise reduction 600 and the lowpass DCT: a 64x96 clip, 1 I + 4 P
     in chunks of 2; slow/zerolatency (CTU 64, RDOQ, 4 references):
     1080p I + 1 P);
  3a. the host B path (encode_frame_b, encode_bgop,
     encode_minigop(device=False)): card == CPU at 64x96, at 8 bits
     with deblock, SAO and the MD5 SEI (encode_bgop over 1 I + 4, and
     encode_minigop(device=False) over 4 frames after an IDR) and at 10
     bits without SAO; then encode_bgop over the bench clip's first 3
     frames at 1080p (I, P, B) with each frame type's seconds and
     bytes: its P frame must launch the gather 4 times and the searches
     2, its B frame none (its stream decodes from the end of phase 3);
  3b. GOP chains and the B-layer fan-out: encode_chains and
     encode_chains_sharded at 64x96 (bench configuration, two chains
     of 2 P frames) on the mesh ["cuda:0"] * 2 equal to ["cpu"] * 2
     (every result array, the per-chain rate estimates, the streams);
     two chains of the 1080p bench clip (2 P frames each, from the bench
     leg's I recon) on ["cuda:0"] * 2, with the gather launched 16
     times and the searches 8, each chain's bytes equal to its own
     single-device encode on the card, and the chain call's seconds
     beside those two encodes'; encode_bframes_gpu(mesh=["cuda:0"] * 2)
     on a 64x96 layer of four B frames equal to the single-device batch
     (8 gathers and 4 searches per B frame);
  4. the bench path at full size: 1080p, 1 I (QP 29) + 24 P (CQP 32),
     pipelined chunks of 8, one warm-up pass over its first chunk (1 I
     + 8 P), one timed pass; in the timed pass the gather must have
     launched 4 times per P frame and the search 2 times (all uint8);
  5. one torch.profiler trace of a bench-path P chunk of PROFILE_P
     frames: the device busy time per P frame, the ten device ops that
     take the most time, then the ops the integer search used to launch
     (aten::sub, abs, sum) and the two kernels;
  6. the fast/zerolatency path at full size (--preset fast --tune
     zerolatency: 3 references, TMVP, SAO, me_range 5): the same clip,
     passes and launch checks as phase 4, with the share of 8x8 cells
     predicted from reference 1 or later and of CTUs with SAO on, then
     one profile of its P chunk as in phase 5;
  7. the medium/zerolatency path at full size (--preset medium --tune
     zerolatency, x265's default preset for live encoding: CTU 64, 3
     references, me_range 10, TMVP, merge 3, SAO): the same clip,
     passes, launch checks and shares as phase 6, with the share of
     P-frame area coded as 64x64 CUs, then one profile of its P chunk;
  8. the slow/zerolatency path at full size (--preset slow --tune
     zerolatency: CTU 64, RDOQ, 4 references, me_range 10, TMVP, merge
     3, SAO): the same clip, passes, launch checks and shares (the
     share of 8x8 cells per refIdx too) as phase 7, one profile of its
     P chunk, then RDOQ's cost in one P frame: its calls replayed alone
     under the profiler (device ops launched, device ms, wall ms);
  9. the fast path with B frames at full size (--preset fast, no tune:
     3 B frames, b-adapt, 3 references, TMVP, SAO, me_range 5), driven
     as the CLI drives it (encode_random_access): card == CPU on a 64x96
     clip, 1 I + 8 frames in mini-GOPs, where some B cells must be
     bi-predicted and some L1-only, on the 64x96 clip's first mini-GOP
     with RDOQ on, and on 1080p I + one mini-GOP; then
     the bench clip, one timed pass (the 1080p leg warms it up), whose
     first frames must reproduce the 1080p leg; in the timed pass the gather
     must have launched 4 times per anchor P and 8 per B frame, the
     search 2 and 4; then one profile of a mini-GOP (device rows and
     the ten ops with the most host time);
  10. per-CTU QP: card == CPU, streams and QP maps, on encode_sequence
     with aq-mode 2 + cuTree under --preset medium --tune zerolatency
     at 1080p (1 I + 1 P: the device lookahead, a host-recon I frame,
     dQP P chunks; some CTU must code a QP other than its slice's), a
     64x96 --preset fast B loop with aq-mode 2, a 64x96 lossless I
     frame and a CTU-16 I frame; then that aq_cutree path at full size
     (the bench clip through encode_sequence, one timed pass, the
     1080p leg its warm-up: fps, the I frame's seconds with its
     host-recon split, the lookahead's seconds per GOP, seconds per P
     frame, bytes, the QP maps' min, max, mean and share off the slice
     QP; the gather
     must have launched 4 times per P frame and the search 2), one
     profile of its P chunk with its maps, and the device's busy and
     idle shares of its P-frame wall;
  11. the CLI (python -m x265_tpu_torch.cli, through cli.main): card ==
     CPU on 64x96 legs (--preset fast --crf 28 with B frames; ultrafast
     /zerolatency ABR + VBV with the hash, AUD and length-prefixed
     units; a two-pass pair; --analysis-save then --analysis-load;
     --param wpp=1; a two-rung AbrEncoder), each its output bytes, csv
     rows (but wall_s) and stats files; a 1080p leg of 1 I + 1 P under
     the timed pass's flags (bytes and QPs); then the bench clip as a
     25-frame y4m through one timed pass of --preset medium --tune
     zerolatency --bitrate 3000 --vbv-maxrate 3000 --vbv-bufsize 6000
     --hash 1 (fps, kb/s against 3000, the QP range per frame type, VBV
     underflows, seconds per I and P frame, every MD5 SEI checked
     against the recon; the gather must have launched 4 times per P
     frame and the search 2); scale_frame 1080p -> 1280x720 card == CPU
     with its device time;
  12. Main10 (run before phase 11, so that its stream decodes while
     phase 11 runs): card == CPU on the 10-bit legs (synth10_clip: the I
     frame at CTU 32; an IPPP weightp sequence with the hash;
     --preset slow --tune zerolatency --no-sao 1 I + 3 P at 72x128,
     CTU 64 with 4 references and RDOQ; a --preset fast --no-sao
     hierarchical-B mini-GOP; encode_sequence with aq-mode 2 + cuTree;
     the CLI on a 420p10 y4m with the HDR10 flags and --hash 1); then
     the bench clip lifted to 10 bits (synth10_1080p) as a 25-frame
     420p10 y4m through one timed pass of CLI_MAIN10 (--preset medium
     --tune zerolatency --no-sao, ABR 3000 + VBV, --hash 1, HDR10):
     fps, kb/s within 5% of 3000, QP range, no VBV underflow, I and P
     seconds, the SPS's Main10 profile and bit depth 10, every MD5 SEI
     checked against the 10-bit recon, the uint16 gather 4 times and
     the uint16 searches 2 times per P frame and no uint8 instance;
     the CPU's 1 I + 1 P under the same flags against the pass's;
  13. decode: the port's validation decoder (x265_tpu_torch.decoder,
     numpy on the host) on the card's own streams, in DECODE_JOBS
     spawned processes, each against the card's recon (and its MD5
     SEIs): the bench configuration's 1080p I + 1 P leg and the host B
     path's 1080p I + P + B, started once phase 3's CPU halves are done
     (before any timed pass), the Main10 CLI pass's 1080p I frame and
     up to DECODE_MAIN10_P P frames after it, started right after that
     pass (fewer P frames when the run is late, never none of the I
     frame), and at the end every small-size card stream the legs write
     (IPPP, SAO, CTU 64, placebo, NR, B, host B, dQP, lossless, CTU 16,
     WPP, 10-bit); one line per stream with its frames, bytes and
     decode seconds per frame;
  14. the kernels line (one JSON object, one entry per kernel instance:
     the gather's uint8 and uint16, the pair and 32-block searches'
     uint8 and uint16; launches summed over the timed passes of the
     paths that run each (the 1080p chain call among them), and per
     path; times and bounds per P frame at the bench path's shapes for
     uint8 and the Main10 path's for uint16, as its ms_of says), the
     card line, and the last line
     {"ok": true, "device": {...}}.
Card == reference: every stream that tools/ref_digests_1080p.json
names (RefDigests: the reference's frames of the same calls on the same
frames, written by tools/port_vs_ref.py on the CPU) is held, frame by
frame, to the reference's type, POC, byte count and sha256 where phases
4-10 code it, one card_equals_reference line per leg; a differing frame
or a leg no phase checked fails the run.
Imports neither JAX nor the x265_tpu reference package.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

GOP = 25                     # 1 I + 24 P, the bench clip
CHUNK = 8
PROFILE_P = 1                # P frames in each profiled chunk
QP = 32
CARD_CPU_SIZE = (1080, 1920)  # (h, w) of the I + 1 P card-vs-CPU leg
BENCH_LEG = f"{CARD_CPU_SIZE[0]}x{CARD_CPU_SIZE[1]} 1I+1P"
CPU_LEGS_SPARE = 1           # host cores left to the card's process while
#                              phase 3's CPU halves run beside it
BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak
INT32_LANES_PER_SM = 64      # Hopper: INT32 lanes per SM per clock
REPEATS = 3                  # each kernel timing, taken in turns

# the four gathers of one P frame at 1080p (coded 1080, scan 1088) and
# me_range 10: (name, plane rows, plane cols, window, windows per frame)
SHAPES = (
    ("luma_16region_44", 1088 + 56, 1920 + 56, 44, 8160),
    ("luma_32block_60", 1088 + 56, 1920 + 56, 60, 2040),
    ("chroma_16region_22", 2 * (544 + 36), 960 + 36, 22, 2 * 8160),
    ("chroma_32block_30", 2 * (544 + 36), 960 + 36, 30, 2 * 2040),
)

# the two integer searches of one P frame at 1080p (scan 1088 x 1920),
# me_range 10: (name, block size, units per frame); side 21, lead 4
SEARCH_SHAPES = (
    ("pair_16region_8block", 16, 8160),
    ("single_32block", 32, 2040),
)
SCAN = (1088, 1920)
SIDE, LEAD = 21, 4
# the fast/zerolatency path at 1080p: me_range 5 (side 11) and three
# references stacked in one plane per component (luma rows 3 x (1088 +
# 36), cb/cr rows 2 x 3 x (544 + 26)), windows 34/50 and 17/25
FAST_SIDE = 11
FAST_SHAPES = (
    ("luma_16region_34_3refs", 3 * (1088 + 36), 1920 + 36, 34, 8160),
    ("luma_32block_50_3refs", 3 * (1088 + 36), 1920 + 36, 50, 2040),
    ("chroma_16region_17_3refs", 2 * 3 * (544 + 26), 960 + 26, 17,
     2 * 8160),
    ("chroma_32block_25_3refs", 2 * 3 * (544 + 26), 960 + 26, 25,
     2 * 2040),
)
# the medium/zerolatency path at 1080p: me_range 10 (side 21, the bench
# search shapes) and three references stacked: luma rows 3 x (1088 + 56),
# cb/cr rows 2 x 3 x (544 + 36), windows 44/60 and 22/30
MEDIUM_SHAPES = (
    ("luma_16region_44_3refs", 3 * (1088 + 56), 1920 + 56, 44, 8160),
    ("luma_32block_60_3refs", 3 * (1088 + 56), 1920 + 56, 60, 2040),
    ("chroma_16region_22_3refs", 2 * 3 * (544 + 36), 960 + 36, 22,
     2 * 8160),
    ("chroma_32block_30_3refs", 2 * 3 * (544 + 36), 960 + 36, 30,
     2 * 2040),
)
# the fast path with B frames at 1080p: me_range 5 (side 11, the fast
# search shapes) and one reference per list in its own plane: luma
# 1088 + 36 rows, cb/cr rows 2 x (544 + 26), windows 34/50 and 17/25
FAST_B_SHAPES = (
    ("luma_16region_34", 1088 + 36, 1920 + 36, 34, 8160),
    ("luma_32block_50", 1088 + 36, 1920 + 36, 50, 2040),
    ("chroma_16region_17", 2 * (544 + 26), 960 + 26, 17, 2 * 8160),
    ("chroma_32block_25", 2 * (544 + 26), 960 + 26, 25, 2 * 2040),
)
# the slow/zerolatency path at 1080p: me_range 10 (side 21, the bench
# search shapes) and four references stacked: luma rows 4 x (1088 + 56),
# cb/cr rows 2 x 4 x (544 + 36), windows 44/60 and 22/30
SLOW_SHAPES = (
    ("luma_16region_44_4refs", 4 * (1088 + 56), 1920 + 56, 44, 8160),
    ("luma_32block_60_4refs", 4 * (1088 + 56), 1920 + 56, 60, 2040),
    ("chroma_16region_22_4refs", 2 * 4 * (544 + 36), 960 + 36, 22,
     2 * 8160),
    ("chroma_32block_30_4refs", 2 * 4 * (544 + 36), 960 + 36, 30,
     2 * 2040),
)
# untimed: the placebo/zerolatency shapes (veryslow's too): me_range 12
# (windows 48/64 and 24/32) and five references stacked
PLACEBO_SHAPES = (
    ("luma_16region_48_5refs", 5 * (1088 + 64), 1920 + 64, 48, 8160),
    ("luma_32block_64_5refs", 5 * (1088 + 64), 1920 + 64, 64, 2040),
    ("chroma_16region_24_5refs", 2 * 5 * (544 + 40), 960 + 40, 24,
     2 * 8160),
    ("chroma_32block_32_5refs", 2 * 5 * (544 + 40), 960 + 40, 32,
     2 * 2040),
)
# untimed exactness rows at other me_ranges: (case, side)
OTHER_SIDES = (("random_me_range_7", 15),    # windows 38/54, odd rows
               ("random_me_range_2", 5),     # windows 28/44
               ("random_me_range_12", 25))   # windows 48/64


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def synth_1080p(seed: int, shift: int = 0):
    """The bench clip's frame generator (gradient + noise, panning)."""
    rng = np.random.default_rng(seed)
    h, w = 1080, 1920
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2 + (xx * yy >> 9)) % 256).astype(np.int32)
    y = np.clip(y + rng.integers(-10, 10, (h, w)), 0, 255).astype(np.uint8)
    if shift:
        y = np.roll(y, shift, axis=1)
    cb = np.clip(128 + (xx[::2, ::2] >> 4), 0, 255).astype(np.uint8)
    cr = np.clip(128 - (yy[::2, ::2] >> 4), 0, 255).astype(np.uint8)
    return y, cb, cr


def small_clip(n, h=64, w=96, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    base = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255) \
        .astype(np.uint8)
    cb = np.full((h // 2, w // 2), 120, np.uint8)
    cr = np.full((h // 2, w // 2), 132, np.uint8)
    return [(np.roll(base, 2 * i, axis=1), cb, cr) for i in range(n)]


def strobe_clip(n, h=64, w=96, seed=0):
    """Two alternating random textures (tests/test_multiref.py's flicker
    clip): frame k matches frame k - 2 exactly, so reference 1 wins
    where the texture flips."""
    rng = np.random.default_rng(seed)
    tex = [rng.integers(0, 255, (h, w)).astype(np.uint8) for _ in range(2)]
    ch = [rng.integers(100, 160, (h // 2, w // 2)).astype(np.uint8)
          for _ in range(2)]
    return [(tex[k % 2], ch[k % 2], ch[k % 2]) for k in range(n)]


def _blur(a, k):
    """A (2k)-wide box blur along both axes, edges replicated."""
    for ax in (0, 1):
        pad = [(k, k) if i == ax else (0, 0) for i in range(2)]
        c = np.cumsum(np.pad(a, pad, mode="edge"), axis=ax)
        n = c.shape[ax]
        a = (np.take(c, range(2 * k, n), axis=ax) -
             np.take(c, range(0, n - 2 * k), axis=ax)) / (2 * k)
    return a


def medium_clip(n, h=72, w=128, pan=2, seed=7, split=96):
    """The CTU-64 test clip (tests/test_torch_ctu64.py and
    tests/test_torch_gpu.py encode it too): left of column `split`
    blurred noise panning 2 pixels a frame (smooth, and unique under
    shifts, so one MV fits a whole 64x64 CU); right of it two random
    textures that alternate, so frame k matches frame k - 2. Chroma
    likewise."""
    rng = np.random.default_rng(seed)
    wide = w + pan * n
    sm = _blur(rng.integers(0, 256, (h, wide)).astype(np.float64), 3)
    y_s = 128 + (sm - sm.mean()) * 3.0
    c_s = [_blur(rng.integers(0, 256, (h // 2, wide // 2))
                 .astype(np.float64), 3) for _ in range(2)]
    c_s = [128 + (c - c.mean()) * 1.5 for c in c_s]
    tex = [rng.integers(0, 255, (h, w)) for _ in range(2)]
    ctex = [rng.integers(100, 160, (h // 2, w // 2)) for _ in range(2)]
    left = np.arange(w)[None, :] < split
    out = []
    for k in range(n):
        y = np.where(left, y_s[:, pan * k:pan * k + w], tex[k % 2])
        c = [np.where(left[:, ::2], cs[:, pan * k // 2:pan * k // 2 + w // 2],
                      ctex[k % 2]) for cs in c_s]
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, *c)))
    return out


@lru_cache(maxsize=None)
def _low_bits(seed, shapes):
    """Two-bit smooth fields of the given plane shapes: seeded noise,
    blurred, then ranked into four equal shares."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        f = _blur(rng.integers(0, 256, shape).astype(np.float64), 2)
        rank = np.empty(f.size, np.int64)
        rank[f.ravel().argsort(kind="stable")] = np.arange(f.size)
        out.append((rank * 4 // f.size).reshape(shape).astype(np.uint16))
    return tuple(out)


def to_10bit(frame, seed, shift=0):
    """A 10-bit version of an 8-bit (y, cb, cr) frame: each sample
    shifted up two bits, its two low bits from a seeded smooth field
    (rolled `shift` luma columns with the picture), so all ten bits
    carry content."""
    lows = _low_bits(seed, tuple(p.shape for p in frame))
    return tuple((p.astype(np.uint16) << 2) |
                 np.roll(low, shift if k == 0 else shift // 2, axis=1)
                 for k, (p, low) in enumerate(zip(frame, lows)))


def synth10_clip(n, h=64, w=64, seed=7):
    """The Main10 test clip (tests/test_torch_main10.py and the card ==
    CPU legs encode it): medium_clip at h x w (a panning smooth part
    and, right of three quarters of the width, two alternating
    textures) lifted to 10 bits by to_10bit."""
    frames = medium_clip(n, h, w, seed=seed, split=w * 3 // 4 // 8 * 8)
    return [to_10bit(f, seed + 1, shift=2 * k) for k, f in enumerate(frames)]


def synth10_1080p(i: int):
    """Frame i of the 10-bit bench clip: synth_1080p's frame lifted by
    to_10bit, its low bits panning with the picture."""
    return to_10bit(synth_1080p(i % 3, shift=2 * i), i % 3, shift=2 * i)


def sps_fields(stream: bytes) -> dict:
    """general_profile_idc and the luma and chroma bit depths of the
    first SPS of an Annex-B stream (one temporal layer)."""
    from x265_tpu_torch.bitstream.nal import split_annexb
    rbsp = next(rb for t, rb, _ in split_annexb(stream) if int(t) == 33)
    bits = "".join(f"{b:08b}" for b in rbsp)
    pos = 8 + 96                     # vps id .. temporal nesting; the PTL

    def ue():
        nonlocal pos
        z = 0
        while bits[pos] == "0":
            z += 1
            pos += 1
        v = int(bits[pos:pos + z + 1], 2) - 1
        pos += z + 1
        return v
    ue()                             # sps id
    if ue() == 3:                    # chroma_format_idc
        pos += 1
    ue(), ue()                       # width, height
    pos += 1
    if bits[pos - 1] == "1":         # conformance window
        for _ in range(4):
            ue()
    luma = ue() + 8
    return {"profile_idc": rbsp[1] & 31, "bit_depth_luma": luma,
            "bit_depth_chroma": ue() + 8}


def b_clip(nf, h=64, w=96, seed=7):
    """The B test clip (tests/test_torch_bframes.py and
    tests/test_torch_gpu.py encode it too): a pan with a band on the
    left whose texture scrolls down, so the B frames code uni-L0,
    uni-L1 and bi cells."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 5 + yy * 3) % 200 + 20).astype(np.int32)
    tex = rng.integers(0, 256, (h, w))
    frames = []
    for i in range(nf):
        y = np.roll(base, 2 * i, axis=1) + rng.integers(-4, 5, (h, w))
        y[:, :24] = np.roll(tex, 3 * i, axis=0)[:, :24]
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.clip(110 + (xx[::2, ::2] >> 3) + i, 0, 255).astype(np.uint8)
        cr = np.clip(140 - (yy[::2, ::2] >> 2), 0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def bench_config(h, w, me_range=10):
    """The bench path's configuration: CQP 32, deblock, no SAO, one
    reference."""
    from x265_tpu_torch.common.params import EncoderConfig
    return EncoderConfig(width=w, height=h, qp=QP, deblock=True, sao=False,
                         me_range=me_range)


def fast_config(h, w):
    """--preset fast --tune zerolatency at CQP 32: 3 references, TMVP,
    SAO, me_range 5, CTU 32, no B frames."""
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=QP)
    cfg.apply_preset("fast")
    cfg.apply_tune("zerolatency")
    return cfg


def medium_config(h, w):
    """--preset medium --tune zerolatency at CQP 32: CTU 64, 3
    references, me_range 10, TMVP, merge 3, SAO, no B frames."""
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=QP)
    cfg.apply_preset("medium")
    cfg.apply_tune("zerolatency")
    return cfg


def slow_config(h, w):
    """--preset slow --tune zerolatency at CQP 32: CTU 64, RDOQ, 4
    references, me_range 10, TMVP, merge 3, SAO, no B frames."""
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=QP)
    cfg.apply_preset("slow")
    cfg.apply_tune("zerolatency")
    assert (cfg.ctu_size, cfg.num_refs, cfg.me_range, cfg.rdoq,
            cfg.bframes) == (64, 4, 10, True, 0), "the slow preset moved"
    return cfg


def placebo_config(h, w):
    """--preset placebo --tune zerolatency at CQP 32: CTU 64, RDOQ, 5
    references, merge 5, me_range 12, TMVP, SAO, no B frames."""
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=QP)
    cfg.apply_preset("placebo")
    cfg.apply_tune("zerolatency")
    assert (cfg.num_refs, cfg.max_merge, cfg.me_range, cfg.rdoq) == \
        (5, 5, 12, True), "the placebo preset moved"
    return cfg


def nr_lowpass_config(h, w):
    """The bench configuration with inter noise reduction (strength 600)
    and the lowpass DCT."""
    cfg = bench_config(h, w)
    cfg.nr_inter = 600
    cfg.lowpass_dct = True
    return cfg


def fast_b_rdoq_config(h, w):
    """--preset fast (B frames) with RDOQ on: the B body's quantiser."""
    cfg = fast_b_config(h, w)
    cfg.rdoq = True
    return cfg


def fast_b_config(h, w):
    """--preset fast at CQP 32, no tune: 3 B frames with b-adapt, 3
    references, TMVP, SAO, me_range 5, CTU 32."""
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=QP)
    cfg.apply_preset("fast")
    return cfg


def aq_cutree_config(h, w):
    """--preset medium --tune zerolatency with aq-mode 2 and cuTree at
    CQP 32: the medium configuration with every frame's per-CTU QP from
    the device lookahead."""
    cfg = medium_config(h, w)
    cfg.aq_mode, cfg.cutree = 2, True
    return cfg


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


REF_DIGESTS = Path(__file__).resolve().parent / "tools" / \
    "ref_digests_1080p.json"
DIGEST_KEYS = ("type", "poc", "bytes", "sha256")


def frame_digest(r) -> dict:
    """One coded frame as the digest file records it."""
    return {"type": r.ftype, "poc": int(r.poc), "bytes": len(r.bitstream),
            "sha256": hashlib.sha256(r.bitstream).hexdigest()}


class RefDigests:
    """The reference's (x265_tpu's) frames of the card's 1080p streams,
    from tools/ref_digests_1080p.json: per leg, the stream it holds (the
    timed pass of phase_path:<path>, phase_b_path or phase_aq_cutree),
    the configuration, the clip, and per frame in coded order its type,
    POC, byte count and sha256. tools/port_vs_ref.py --write-digests
    wrote them where every frame of the port equalled the reference's
    on the CPU. check() holds a stream's frames to its legs' and prints
    one card_equals_reference line per leg; finish() raises if a leg
    was never checked."""

    def __init__(self, path=REF_DIGESTS, doc=None):
        doc = doc if doc is not None else json.loads(Path(path).read_text())
        self.legs = doc["legs"]
        self.checked = set()
        for leg, e in self.legs.items():
            frames = e["frames"]
            if not (isinstance(e.get("stream"), str) and
                    e.get("size") == "1080x1920" and e.get("bits") == 8 and
                    isinstance(e.get("config"), dict) and frames and
                    e.get("clip", {}).get("frames") == len(frames) and
                    all(tuple(sorted(f)) == tuple(sorted(DIGEST_KEYS))
                        for f in frames) and
                    e.get("bytes") == sum(f["bytes"] for f in frames)):
                raise ValueError(f"reference digests: leg {leg} is "
                                 f"malformed")

    def check(self, stream: str, cfg, results) -> None:
        """Hold results (a card stream's frames in coded order, coded in
        the configuration cfg) to every leg recorded for stream: its
        first n frames, or all of them for a stream whose frames depend
        on its length (not a phase_path pass)."""
        import dataclasses
        for leg, e in self.legs.items():
            if e["stream"] != stream:
                continue
            want = e["frames"]
            n = len(want)
            whole = not stream.startswith("phase_path:")
            if len(results) < n or (whole and len(results) != n):
                raise AssertionError(
                    f"card != reference at {leg}: {len(results)} frames "
                    f"coded, {n} recorded")
            if json.loads(json.dumps(dataclasses.asdict(cfg))) != \
                    e["config"]:
                raise AssertionError(f"card != reference at {leg}: the "
                                     f"configuration differs")
            for i, (w, r) in enumerate(zip(want, results)):
                got = frame_digest(r)
                if got != w:
                    raise AssertionError(
                        f"card != reference at {leg}: frame {i} (coded "
                        f"order) is {got}, the reference's {w}")
            self.checked.add(leg)
            print(json.dumps({"card_equals_reference": leg,
                              "stream": stream, "frames": n,
                              "bytes": e["bytes"]}), flush=True)

    def finish(self) -> None:
        missing = sorted(set(self.legs) - self.checked)
        if missing:
            raise AssertionError(f"card == reference: legs {missing} were "
                                 f"never checked")


def encode_ippp(frames, device, cfg, timing=None, chunk=CHUNK,
                need_recon=False):
    """A path through its user entry points, in the configuration cfg:
    I frame at QP-3 on the device recon, then pipelined P chunks.
    Returns the results (with their recon planes on need_recon);
    `timing`, when a dict, receives the I frame's and the P frames' wall
    seconds (the device is synchronized between them)."""
    from x265_tpu_torch.enc import IntraEncoder
    enc = IntraEncoder(cfg, device=device)
    t0 = time.perf_counter()
    r0 = enc.encode_frame(*frames[0], qp=cfg.qp - 3, use_device_recon=True,
                          need_recon=need_recon)
    if timing is not None:
        torch.cuda.synchronize()
        timing["i_frame_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc.ref = r0.device_ref
    enc.poc = 0
    rs = enc.encode_pgop_pipelined(frames[1:], chunk=chunk,
                                   need_recon=need_recon)
    if timing is not None:
        torch.cuda.synchronize()
        timing["p_frames_s"] = time.perf_counter() - t0
    return [r0] + rs


def encode_random_access(frames, device, cfg, timing=None):
    """The CLI's B loop (x265_tpu/cli.py:472-486, 562-572) through the
    port's user entry points: frame 0 the only I frame (QP - 3); later
    frames queue, and once bframes + 1 are queued Lookahead.plan_minigop
    picks the B-run and encode_minigop codes it with its anchor P; the
    rest is flushed at the end. Returns (results in decode order, the
    mini-GOP lengths). `timing`, when a dict, receives the I frame's
    seconds, the anchor P frames' (the device is synchronized around
    each anchor), the lookahead's (plan_minigop, numpy on the host),
    the B frames' native CABAC and packaging (b_emit_s) and the B
    frames' whole (b_frames_s: the rest, b_emit_s included)."""
    from x265_tpu_torch.enc import IntraEncoder
    from x265_tpu_torch.enc.lookahead import Lookahead
    enc = IntraEncoder(cfg, device=device)
    la = Lookahead(cfg)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    secs = Counter()

    def timed(name, fn, synced):
        def run(*a, **k):
            if synced:
                sync()
            t = time.perf_counter()
            r = fn(*a, **k)
            if synced:
                sync()
            secs[name] += time.perf_counter() - t
            return r
        return run

    enc.encode_frame_p = timed("anchor_p_s", enc.encode_frame_p, True)
    enc._emit_b_frame = timed("b_emit_s", enc._emit_b_frame, False)
    plan_minigop = timed("lookahead_s", la.plan_minigop, False)
    t0 = time.perf_counter()
    r0 = enc.encode_frame(*frames[0], qp=cfg.qp - 3)
    sync()
    i_s = time.perf_counter() - t0
    enc.ref = r0.device_ref
    enc.poc = 0
    results, lengths, buf = [r0], [], []
    anchor_y = frames[0][0]
    t0 = time.perf_counter()

    def flush(count):
        nonlocal buf, anchor_y
        chunk = buf[:count]
        results.extend(enc.encode_minigop(chunk, qp=cfg.qp))
        lengths.append(len(chunk))
        anchor_y = chunk[-1][0]
        buf = buf[count:]

    for fr in frames[1:]:
        buf.append(fr)
        if len(buf) >= cfg.bframes + 1:
            nb = plan_minigop(anchor_y, [f[0] for f in buf]) \
                if cfg.b_adapt else len(buf) - 1
            flush(nb + 1)
    if buf:
        flush(len(buf))
    sync()
    if timing is not None:
        rest = time.perf_counter() - t0
        timing.update(i_frame_s=i_s, **secs, b_frames_s=rest -
                      secs["anchor_p_s"] - secs["lookahead_s"])
    return results, lengths


def encode_seq(frames, device, cfg, timing=None):
    """encode_sequence (keyint and scene-cut frame types, the device
    lookahead's QP maps, a host-recon I frame per GOP, pipelined P
    chunks) through the port's user entry point. Returns (results, the
    QP maps as coded, one (map, slice QP) per frame: the lookahead's,
    the I frame's lowered by 3). `timing`, when a dict, receives the I
    frames' seconds with their host-recon split (analysis on the
    device, then the host's recon, filters and CABAC), the lookahead's
    seconds per GOP and the P frames' seconds (the device synchronized
    around each)."""
    from x265_tpu_torch.enc import IntraEncoder
    enc = IntraEncoder(cfg, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    secs, split, maps = Counter(), Counter(), []
    real_la, real_i, real_p = (enc.lookahead_qp_maps, enc.encode_frame,
                               enc.encode_pgop_pipelined)

    def lookahead(*a, **k):
        maps.append(real_la(*a, **k))
        return maps[-1]

    def timed(name, fn):
        def run(*a, **k):
            sync()
            t = time.perf_counter()
            r = fn(*a, **k)
            sync()
            secs[name] += time.perf_counter() - t
            if fn is real_i:
                split.update(enc.host_i_seconds)
            return r
        return run

    enc.lookahead_qp_maps = lookahead
    enc.encode_frame = timed("i_frame_s", real_i)
    enc.encode_pgop_pipelined = timed("p_frames_s", real_p)
    res = enc.encode_sequence(frames)
    coded = coded_qp_maps(maps, cfg.qp)
    if timing is not None:
        timing.update(**secs, host_i_split_s=dict(split),
                      lookahead_s=list(enc.lookahead_seconds))
    return res, coded


def coded_qp_maps(maps, qp) -> list:
    """The lookahead's QP maps of each GOP (encode_sequence's calls of
    lookahead_qp_maps) as the frames code them: (map, slice QP) per
    frame, the I frame's map and QP lowered by 3."""
    coded = []
    for m in maps:
        coded.append((np.clip(m[0] - 3, 0, 51), max(qp - 3, 0)))
        coded.extend((x, qp) for x in m[1:])
    return coded


def qp_map_stats(coded) -> dict:
    """Over the QP maps of one encode: min, max and mean entry, and the
    share of CTU entries that differ from their slice QP."""
    allq = np.concatenate([m.ravel() for m, _ in coded])
    ne = sum(int((m != q).sum()) for m, q in coded)
    return {"qp_map_min": int(allq.min()), "qp_map_max": int(allq.max()),
            "qp_map_mean": float(allq.mean()),
            "qp_ne_slice_share": ne / allq.size}


def b_stats(res) -> dict:
    """Over the B frames of one encode: the shares of 8x8 cells
    predicted from L0 only, L1 only and both."""
    pf = np.concatenate([r.syntax.pf8.ravel() for r in res
                         if r.ftype == "B"])
    return {"pf8_share": {k: float((pf == v).mean())
                          for k, v in (("l0", 1), ("l1", 2), ("bi", 3))}}


def cuda_time(fn, iters=30) -> float:
    """Mean device milliseconds per call: `iters` calls captured in one
    CUDA graph and replayed between two CUDA events, so the host's
    per-call cost (Python, ctypes, argument checks) is not in the
    number, only the device's."""
    fn()                                   # warm-up: builds, caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timed(fns) -> dict:
    """REPEATS rounds of cuda_time over the named callables, taken in
    turns; returns {name: (median, min, max)} in ms."""
    t = {k: [] for k in fns}
    for _ in range(REPEATS):
        for k, fn in fns.items():
            t[k].append(cuda_time(fn))
    return {k: (sorted(v)[len(v) // 2], min(v), max(v))
            for k, v in t.items()}


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def touched_pixels(hh, ww, ys_t, xs_t, win) -> int:
    """Pixels of an (hh, ww) plane that at least one win x win window
    at (ys, xs) covers: a 2-D difference array of the windows' corners,
    summed over both axes."""
    d = torch.zeros((hh + 1, ww + 1), dtype=torch.int32, device=ys_t.device)
    y, x = ys_t.long(), xs_t.long()
    one = torch.ones_like(ys_t, dtype=torch.int32)
    for yy, xx, sign in ((y, x, 1), (y, x + win, -1), (y + win, x, -1),
                         (y + win, x + win, 1)):
        d.index_put_((yy, xx), sign * one, accumulate=True)
    return int((d.cumsum(0).cumsum(1)[:hh, :ww] > 0).sum())


def phase_gather(shapes, dtypes=(torch.uint8, torch.uint16), timing=True,
                 agg_dtype=torch.uint8):
    """Gather kernel vs plain at one path's shapes; returns the per-frame
    aggregate numbers of the path's dtype (agg_dtype: uint8, or uint16
    on the Main10 path) for the kernels line. timing=False: exactness
    only."""
    from x265_tpu_torch.ops.me_win import gather_windows, \
        gather_windows_plain
    rng = np.random.default_rng(2024)
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0}
    for name, hh, ww, win, nb in shapes:
        for dt in dtypes:
            hi = 256 if dt == torch.uint8 else 1024
            base = torch.from_numpy(rng.integers(0, hi, (hh, ww))
                                    .astype(np.int16)).cuda()
            src = base.to(torch.uint8) if dt == torch.uint8 \
                else base.view(torch.uint16)
            ys = rng.integers(0, hh - win + 1, nb).astype(np.int32)
            xs = rng.integers(0, ww - win + 1, nb).astype(np.int32)
            ys[:4] = [0, hh - win, 0, hh - win]
            xs[:4] = [0, 0, ww - win, ww - win]
            ys_t = torch.from_numpy(ys).cuda()
            xs_t = torch.from_numpy(xs).cuda()
            got = gather_windows(src, ys_t, xs_t, win)
            want = gather_windows_plain(src, ys_t, xs_t, win)
            torch.cuda.synchronize()
            iv = (lambda t: t.view(torch.int16).to(torch.int32)) \
                if dt == torch.uint16 else (lambda t: t.to(torch.int32))
            err = int((iv(got) - iv(want)).abs().max())
            if err != 0:
                raise AssertionError(f"gather kernel != plain at {name} "
                                     f"{dt}: max abs err {err}")
            if not timing:
                print(json.dumps({"shape": name, "windows": nb, "win": win,
                                  "max_abs_err": err, "timed": False}),
                      flush=True)
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                continue
            # one PyTorch indexing call on precomputed index grids
            ar = torch.arange(win, device="cuda")
            yy = (ys_t.long()[:, None] + ar)[:, :, None]
            xx = (xs_t.long()[:, None] + ar)[:, None, :]
            src_i = src.view(torch.int16) if dt == torch.uint16 else src
            t = timed({
                "kernel": lambda: gather_windows(src, ys_t, xs_t, win),
                "plain": lambda: gather_windows_plain(src, ys_t, xs_t, win),
                "library": lambda: src_i[yy, xx]})
            ms, plain_ms, lib_ms = (t[k][0] for k in
                                    ("kernel", "plain", "library"))
            # bytes: the source pixels the windows cover, the starts,
            # the windows written
            touched = touched_pixels(hh, ww, ys_t, xs_t, win)
            nbytes = touched * src.element_size() + 8 * nb + \
                got.numel() * got.element_size()
            bound_ms = nbytes / BYTES_PER_S * 1e3
            rec = {"shape": name, "dtype": str(dt).replace("torch.", ""),
                   "windows": nb, "win": win,
                   "touched_share": touched / (hh * ww), "kernel_ms": ms,
                   "kernel_ms_spread": t["kernel"][1:],
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_ms_spread": t["library"][1:],
                   "bound_ms": bound_ms, "bytes": nbytes,
                   "bound_share": bound_ms / ms,
                   "beats_library": ms < lib_ms,
                   "max_abs_err": err, "launches_per_p_frame": 1}
            print(json.dumps(rec), flush=True)
            if dt == agg_dtype:        # the path's dtype
                agg["ms"] += ms
                agg["plain_ms"] += plain_ms
                agg["library_ms"] += lib_ms
                agg["bound_ms"] += bound_ms
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
    return agg


def _search_case(gen, case, n, nb, side, bits=8, lead=LEAD, pair=None):
    """Windows, current plane and penalties of one search row at `bits`
    bits a sample (uint8 windows, uint16 at 10), made on the card from
    the generator gen: random samples; near-flat samples in {0, 1} with
    penalties in {0, 1, 2}, where many candidates tie at different
    indices; flat samples and penalties, where every candidate ties; or
    the extremes, current 2^bits - 1 against windows of 0 (curmax) and
    current 0 against windows of 2^bits - 1 (cur0), flat penalties:
    every candidate ties at the largest SAD, which at 10 bits fills each
    packed 16-bit half of the uint16 searches' sums. Windows are
    n + side - 1 + 2 lead wide; pair (default: n == 16) gives the pair
    search's four penalty tables."""
    s = n + side - 1 + 2 * lead
    pair = n == 16 if pair is None else pair
    pen_bs = (4 * nb, 4 * nb, nb, nb) if pair else (nb, nb)
    top = (1 << bits) - 1
    i16 = dict(dtype=torch.int16, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    if case in ("flat", "curmax", "cur0"):
        wv, cv = {"flat": (3, 200), "curmax": (0, top),
                  "cur0": (top, 0)}[case]
        win = torch.full((nb, s, s), wv, **i16)
        cur = torch.full(SCAN, cv, **i32)
        pens = [torch.full((side, b), 5, **i32) for b in pen_bs]
    else:
        hi, phi = (1 << bits, 400) if case == "random" else (2, 3)
        win = torch.randint(0, hi, (nb, s, s), generator=gen, **i16)
        cur = torch.randint(0, hi, SCAN, generator=gen, **i32)
        pens = [torch.randint(0, phi, (side, b), generator=gen, **i32)
                for b in pen_bs]
    win = win.view(torch.uint16) if bits > 8 else win.to(torch.uint8)
    return [win, cur, *pens]


def phase_search(bits=8, sad_lanes_per_sm=INT32_LANES_PER_SM,
                 samples_per_step=4, sad="vabsdiff4"):
    """Search kernel vs plain at the main-path shapes; returns per path
    ("bench", "medium" and "slow": side 21, "fast": side 11; at 10 bits
    "main10": side 21, the uint16 instances) the per-frame aggregate
    numbers, and each instance's ("by"), for the kernels line. The
    medium and slow paths' rows are the bench path's random case again,
    each timed in its own turn; at 10 bits the curmax and cur0 extremes
    run untimed at every side. sad_lanes_per_sm: the rate of the SAD's
    instruction sequence (`sad`: VABSDIFF4 at 8 bits, 4 samples an
    instruction; at 10 the probe's sad16_max_imad, two VIMNMX and two
    IMAD for 4 samples), steps per SM clock, each step samples_per_step
    samples."""
    from x265_tpu_torch.ops.me_win import int_search_pair_windows, \
        int_search_pair_windows_plain, int_search_windows, \
        int_search_windows_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2025 + bits)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_clock_hz()
    lane_ops_per_s = sms * sad_lanes_per_sm * clock_hz
    bps = 1 if bits == 8 else 2                # bytes a sample
    # (row, case, side, the path whose time it is, or None: untimed)
    if bits == 8:
        rows = (("random", "random", SIDE, "bench"),
                ("near_flat", "near_flat", SIDE, None),
                ("flat", "flat", SIDE, None),
                ("random_me_range_5", "random", FAST_SIDE, "fast"),
                ("random_medium", "random", SIDE, "medium"),
                ("random_slow", "random", SIDE, "slow"),
                *((row, "random", side, None) for row, side in OTHER_SIDES))
    else:
        rows = (("random", "random", SIDE, "main10"),
                ("near_flat", "near_flat", SIDE, None),
                ("flat", "flat", SIDE, None),
                ("random_me_range_5", "random", FAST_SIDE, None),
                ("near_flat_me_range_5", "near_flat", FAST_SIDE, None),
                *((row, "random", side, None) for row, side in OTHER_SIDES),
                *((f"{case}_side_{side}", case, side, None)
                  for case in ("curmax", "cur0")
                  for side in (5, FAST_SIDE, 15, SIDE, 25)))
    aggs = {path: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "ops_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0,
                   "by": {}}
            for path in {r[3] for r in rows if r[3]}}
    for name, n, nb in SEARCH_SHAPES:
        by, bx = SCAN[0] // n, SCAN[1] // n
        for row, case, side, path in rows:
            args = _search_case(gen, case, n, nb, side, bits)
            if n == 16:
                def kern(a=args, sd=side):
                    return int_search_pair_windows(*a, by, bx, sd, LEAD)

                def plain(a=args, sd=side):
                    return int_search_pair_windows_plain(*a, by, bx, sd,
                                                         LEAD)
                flat_out = lambda r: [*r[0], *r[1]]     # noqa: E731
            else:
                def kern(a=args, sd=side):
                    return int_search_windows(*a, n, sd, LEAD)

                def plain(a=args, sd=side):
                    return int_search_windows_plain(*a, n, sd, LEAD)
                flat_out = list
            got, want = flat_out(kern()), flat_out(plain())
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            if err != 0:
                raise AssertionError(f"search kernel != plain at {name} "
                                     f"{row}: max abs err {err}")
            if case in ("flat", "curmax", "cur0") and any(
                    int(i.abs().max()) != 0 for i in got[1::2]):
                raise AssertionError(f"{row} {name}: a tie did not pick "
                                     f"index 0")
            for agg in aggs.values():
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
            rec = {"search": name, "bits": bits, "case": row, "units": nb,
                   "n": n, "side": side, "max_abs_err": err}
            if path is not None:
                agg = aggs[path]
                t = timed({"kernel": kern, "plain": plain})
                # bytes: windows, current plane (its low byte, or its
                # low 16 bits at 10 bits: all the search compares),
                # penalties read once, results written once;
                # operations: one step of the SAD's sequence per
                # samples_per_step pixels per candidate (VABSDIFF4 at 8
                # bits; at 10 two VIMNMX and two IMAD), at its measured
                # rate
                win_t, cur_t, *pens_t = args
                nbytes = (win_t.numel() + cur_t.numel()) * bps + \
                    sum(a.numel() * a.element_size() for a in pens_t) + \
                    sum(g.numel() * 4 for g in got)
                px_cand = nb * n * n * side * side
                bytes_ms = nbytes / BYTES_PER_S * 1e3
                ops_ms = px_cand / samples_per_step / lane_ops_per_s * 1e3
                per_px_ms = 2 * px_cand / lane_ops_per_s * 1e3
                rec.update({
                    "kernel_ms": t["kernel"][0],
                    "kernel_ms_spread": t["kernel"][1:],
                    "plain_ms": t["plain"][0],
                    "plain_ms_spread": t["plain"][1:],
                    "bytes": nbytes, "bytes_ms": bytes_ms,
                    "pixel_candidates": px_cand, "ops_ms": ops_ms,
                    "per_pixel_int32_ms": per_px_ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_share": max(bytes_ms, ops_ms) / t["kernel"][0],
                    "sad": sad, "sad_steps_per_clock_per_sm":
                    sad_lanes_per_sm, "sad_samples_per_step":
                    samples_per_step, "sm_clock_hz": clock_hz,
                    "launches_per_p_frame": 1})
                agg["ms"] += t["kernel"][0]
                agg["plain_ms"] += t["plain"][0]
                agg["bound_ms"] += max(bytes_ms, ops_ms)
                agg["ops_ms"] += ops_ms
                agg["bytes_ms"] += bytes_ms
                agg["by"][name] = {
                    "ms": t["kernel"][0], "plain_ms": t["plain"][0],
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes"}
            for agg in aggs.values():
                mx = agg["by"].setdefault(f"{name}_max_abs_err", 0)
                agg["by"][f"{name}_max_abs_err"] = max(mx, err)
            print(json.dumps(rec), flush=True)
    for agg in aggs.values():
        agg["bound_by"] = "operations" \
            if agg["ops_ms"] >= agg["bytes_ms"] else "bytes"
    return aggs


# The SASS of the main-path search instances (the 16-region pair search
# and the 32-block single search, int_search_kernel<N, pair, R, kB>) as
# the parent of the 8- and 16-block redesign built them (ff78177, with
# kernels.NVCC_FLAGS, on an NVIDIA H100 80GB HBM3): sha256 of the opcode
# sequence without modifiers ("ops", kernels.sass_opcodes) and with them
# ("full"), one line per instruction. The redesign gave the small
# instances a kernel of their own and must leave these unchanged. A
# change of toolchain changes the SASS too: PARENT_SASS_NVCC is the last
# line of `nvcc --version` on the machine that recorded the hashes. A
# later change to int_search_kernel, or a new nvcc, records them anew
# with sass_hashes.
PARENT_SASS_NVCC = "Build cuda_12.9.r12.9/compiler.36037853_0"
PARENT_SASS = {
    "int_search_kernel<16, true, 1, 1>": {
        "ops": "09f8362087b3fa40ec9c780f9fc8c4eee9ec52c7dd5d450e06c48713454b0c83",
        "full": "ac5455a96d6513f11921e220dabc9f8d9ae4e50d4d245ab6e82795d893a46791"},
    "int_search_kernel<16, true, 1, 2>": {
        "ops": "1eb7d36ee763e1ff7417177fe555b37de5e63c30f5da3ffaeebe5594cde8a2a5",
        "full": "1e8799dd3c9d51e43e5bd757c3e7b0b57d88e1fb6dabfee4bc97ba740656b20e"},
    "int_search_kernel<16, true, 5, 1>": {
        "ops": "767b4e15786d3fcc6fbea500f786699d7255c8d74cf56ea0bc52806a9bc1ff6a",
        "full": "d934fde964d6e9e9f707642b221180da3b59d29b9acc855715049ce54430d77f"},
    "int_search_kernel<16, true, 5, 2>": {
        "ops": "0f4d2c85de766e727a6900edaaa005201a0f8d944804f3c278f7b9004a223969",
        "full": "d2685d90ae84419df82deb90d41c24c7cb0d9f27a938a503469cac0f6cff44bb"},
    "int_search_kernel<16, true, 6, 1>": {
        "ops": "48e9602b256ce69a30d909b735dac5fd862b93c4d8522a211f0aee6916764260",
        "full": "12f2acfb53e9124f3b4bbf1ff08fcbc9c582f655cb4f08d8b3cb2d214db1cdd0"},
    "int_search_kernel<16, true, 6, 2>": {
        "ops": "2f5a3d6e2ed11b2088048ba3798c3b7e8cd618c617417d978bcd0a204e1e7439",
        "full": "a117245f0d227cc4e9fd4d9a60bbe652ebb16a39e924327457f413b4a14e0a2a"},
    "int_search_kernel<16, true, 7, 1>": {
        "ops": "a69aca3dd709113a1e98664d01b33883e4f39676c02da83c4b05cf5f14545ac6",
        "full": "a2f772496c85564a3e56d97f844ac85d129b733ca965293f47cdbcfd20f47c73"},
    "int_search_kernel<16, true, 7, 2>": {
        "ops": "99a17a79e32f2e63f70e566efa27034be6006145fb1c6516e0d6934cca9d83fe",
        "full": "e0e27659e39527ae4b88d45c7fa366761bc46ea76cf8dc8f599f9a9861c49795"},
    "int_search_kernel<32, false, 1, 1>": {
        "ops": "b1c7fa1bece1bf3785e42eab2d3b01f25765c3fcf672d6728f15b1d32b2d5889",
        "full": "142095b876c7f2b08a4e3d0adcaaf91cee12e81fd4c063ae39ae1c25e9b223a7"},
    "int_search_kernel<32, false, 1, 2>": {
        "ops": "f404d677c9052b4d631329dabe90be2bd93b2c11a7ff0da7b744c633a9b5581d",
        "full": "fa504573ffc14d9705ea9eac01e4e9c660369d1b87e1a8d1da9e737914ac5d8a"},
    "int_search_kernel<32, false, 13, 1>": {
        "ops": "0f3e756f5f30f85aaabce53037df0085cc6a3741c3ebd32a5db245d9dce931da",
        "full": "9f2441db07503ba2c18321ce2d39a582ffcf5062696f1d551b15261d97504d00"},
    "int_search_kernel<32, false, 5, 1>": {
        "ops": "1b5edbda104048b683cc1d4ac5a70251a24e282b06fd4950cf6de9b55c64578d",
        "full": "ab696a0fbc500201e8bc544b9b052c7f2c5a5a224f715566bca5b13ccfef6b2b"},
    "int_search_kernel<32, false, 5, 2>": {
        "ops": "9f5b0efaa0af32f81a91bb20d8d2a4af96cf185cd2fc20de1be618a7584e26d9",
        "full": "4d35e9da8816eac918f6cdc0d6723c1afc6d2deb99fe8e9282889a577c6fa2dc"},
    "int_search_kernel<32, false, 6, 2>": {
        "ops": "9715707a4bda9b1887daf3a657d1486eeb1203e65849a610469ece3dfb6dac4a",
        "full": "6d6459e4572c6d3b72a89e92d4711a3f46660fd51ab1566c98082e73bf9be0cd"},
    "int_search_kernel<32, false, 7, 1>": {
        "ops": "a9e2d3d1c954e631e2b0a7d1170677d75945faee8683c6edd0c18b4768f0e4e9",
        "full": "71fa7cd684bdf91647db24fc44f0c72d1627605ac588fc0de5cc63989024b75d"},
    "int_search_kernel<32, false, 7, 2>": {
        "ops": "86c83a3440f8d163fef87218667599af816cd17d639f8ce31b20320b27bdc719",
        "full": "2b59aefd3ada6c9df17a3dc9f7f766f8158e434586da9ccd5f8dca0366eb487b"}}
SASS_KERNEL = re.compile(r"int_search_kernel<(\d+), (true|false), (\d+), "
                         r"(\d+)>")


def sass_hashes(kernels, so=None) -> dict:
    """sha256 of the pair and 32-block search instances' SASS opcode
    sequences (without and with modifiers) in the built int_search.cu
    (or the library so)."""
    out = {}
    for full in (False, True):
        for fn, ops in kernels.sass_opcodes("int_search", full=full,
                                            so=so).items():
            m = SASS_KERNEL.search(fn)
            if m and (m.group(2) == "true" or m.group(1) == "32"):
                out.setdefault(m.group(0), {})["full" if full else "ops"] = \
                    hashlib.sha256("\n".join(ops).encode()).hexdigest()
    return out


def nvcc_version() -> str:
    """The last line of `nvcc --version` (its build), or why there is
    none."""
    from x265_tpu_torch.kernels import _cuda_tool
    try:
        out = subprocess.run([_cuda_tool("nvcc"), "--version"],
                             capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"no nvcc: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else f"nvcc --version gave rc {out.returncode}"


def check_main_path_sass(kernels) -> dict:
    """Fails when a pair or 32-block search instance's SASS differs from
    its parent's build (PARENT_SASS), or an instance is missing or new,
    naming the nvcc of the record and this one."""
    got = sass_hashes(kernels)
    bad = sorted(k for k in set(got) | set(PARENT_SASS)
                 if got.get(k) != PARENT_SASS.get(k))
    nvcc = nvcc_version()
    print(json.dumps({"sass_check": "pair and 32-block search instances",
                      "instances": len(got), "differ": bad, "nvcc": nvcc,
                      "recorded_with": PARENT_SASS_NVCC}), flush=True)
    if bad:
        raise AssertionError(
            f"the SASS of {bad} differs from the parent's build "
            f"(PARENT_SASS, recorded with nvcc {PARENT_SASS_NVCC!r}; this "
            f"nvcc: {nvcc!r})")
    return got


SMALL_KERNEL = re.compile(r"int_search_small_kernel<(\d+), (\d+), (\d+)>")


def print_build_report(kernels) -> None:
    """ptxas's figures for every kernel instance, then the SASS of each
    search instance: its SAD instructions (VABSDIFF4 at 1 byte a sample;
    VIMNMX, the packed 16-bit max, at 2) against the current words of
    its R candidates (per lane: n rows x 4 words x R, 2 words for an
    8-block at 1 byte a sample), and the unrolled
    walk over the window rows (from the first SAD to the last) counted
    per window row: SADs, IMADs, IADD3s, funnel shifts, shared loads
    and all instructions (the 8- and 16-block kernel,
    int_search_small_kernel<N, R, kB>, alike). Returns, per small
    kernel instance, its walk's instructions by pipe (walk_pipes)."""
    walks = {}
    for name in kernels.sources():
        for row in kernels.resource_usage(name):
            print(json.dumps({"ptxas": name, **row}), flush=True)
    for fn, ops in kernels.sass_opcodes("int_search", full=True).items():
        m = SASS_KERNEL.search(fn) or SMALL_KERNEL.search(fn)
        if not m:
            continue
        name = m.group(0)
        n, r, kb = (int(m.group(i)) for i in (1, m.lastindex - 1,
                                              m.lastindex))
        # the SAD's opcode with its modifiers: VIMNMX without .U16x2 is
        # a scalar min or max of the index and fold arithmetic
        sad = "VABSDIFF4" if kb == 1 else "VIMNMX.U16x2"
        base = [op.split(".")[0] for op in ops]
        cnt = Counter(base)
        sads = [i for i, op in enumerate(ops)
                if op == sad or op.startswith(sad + ".")]
        if not sads:
            raise AssertionError(f"{fn}: no {sad} in its SASS")
        walk = Counter(base[sads[0]:sads[-1] + 1])
        rows = r + n - 1
        words = n * min(4, n * kb // 4) * r
        print(json.dumps({
            "sass": name, "sad": sad, "sads": len(sads),
            "current_words": words,
            "sads_per_word": len(sads) / words,
            "instructions": len(ops), "walk_rows": rows,
            "walk_per_row": {"instructions": sum(walk.values()) / rows,
                             "sads": len(sads) / rows,
                             "imad": walk["IMAD"] / rows,
                             "iadd3": walk["IADD3"] / rows,
                             "shf": walk["SHF"] / rows,
                             "lds": walk["LDS"] / rows},
            "walk_top": walk.most_common(10),
            "top": cnt.most_common(10),
            "walk_pipes": walk_pipes(walk)}), flush=True)
        if m.re is SMALL_KERNEL:
            walks[name] = walk_pipes(walk)
    return walks


# opcodes of an unrolled walk that do not issue to the integer ALU pipe:
# IMAD runs on the FMA pipe, the rest on the memory and control units
NOT_ALU = {"IMAD": "fma", "LDS": "mem", "STS": "mem", "LDG": "mem",
           "SHFL": "mem", "REDUX": "mem", "MATCH": "mem", "BRA": "other",
           "NOP": "other", "BAR": "other"}


def walk_pipes(walk: Counter) -> dict:
    """A walk's instruction count by pipe: alu (VABSDIFF4, VIMNMX, SHF,
    IADD3, LOP3, ...), fma (IMAD), mem (shared loads, shuffles,
    reductions) and other."""
    out = Counter()
    for op, k in walk.items():
        out[NOT_ALU.get(op, "alu")] += k
    return {p: out[p] for p in ("alu", "fma", "mem", "other")}


RATE_OPS = ("vabsdiff4", "shf", "imad", "vabsdiff4_and_shf", "ffma",
            "vabsdiff2", "vabsdiff_h", "vimnmx_u16x2", "iadd3",
            "sad16_maxmin", "sad16_max", "vimnmx_and_imad",
            "sad16_max_imad")
# the SASS each chain must be made of; None: no instruction of its own
# (vabsdiff2 and the half-word vabsdiff are expanded by ptxas: their
# top opcodes are printed)
RATE_SASS = {"vabsdiff4": ("VABSDIFF4",), "shf": ("SHF",),
             "imad": ("IMAD",), "vabsdiff4_and_shf": ("VABSDIFF4", "SHF"),
             "ffma": ("FFMA",), "vabsdiff2": None, "vabsdiff_h": None,
             "vimnmx_u16x2": ("VIMNMX",), "iadd3": ("IADD3",),
             "sad16_maxmin": ("VIMNMX", "IADD3"),
             "sad16_max": ("VIMNMX", "IADD3"),
             "vimnmx_and_imad": ("VIMNMX", "IMAD"),
             "sad16_max_imad": ("VIMNMX", "IMAD")}
# instructions of one step of a chain where it is more than one: a max
# and a min; a max and an IMAD; the exact 16-bit SADs' max, min and
# IADD3 for a word, two max and an IADD3 for two words, and two max and
# two IMAD for two words
RATE_INSTRS = {"vimnmx_u16x2": 2, "sad16_maxmin": 3, "sad16_max": 3,
               "vimnmx_and_imad": 2, "sad16_max_imad": 4}
# samples of one step of each SAD chain: VABSDIFF4 4 bytes; vabsdiff2
# a word of 2 half-words, the half-word vabsdiff 1; sad16_maxmin a
# word, sad16_max and sad16_max_imad two
RATE_SAMPLES = {"vabsdiff4": 4, "vabsdiff2": 2, "vabsdiff_h": 1,
                "sad16_maxmin": 2, "sad16_max": 4, "sad16_max_imad": 4}


def phase_int_rates() -> dict:
    """Issue rate of the search's instructions on one SM, from the probe
    csrc/probes/int_rates.cu: one grid of 256-thread blocks at full
    occupancy, each thread 8 dependency chains of one step (VABSDIFF4
    with its accumulator, SHF, IMAD, VABSDIFF4 and SHF interleaved,
    FFMA, whose published rate is 128 lanes per clock, as the
    yardstick, the two 16-bit SADs that ptxas expands, the packed
    vabsdiff2 and the scalar half-word vabsdiff, and the pieces and
    whole steps of the exact packed 16-bit SADs: max.u16x2 and
    min.u16x2, IADD3, max - min, 2 max - w - c with its sums by IADD3,
    max.u16x2 beside IMAD (two pipes), and 2 max - w - c with its sums
    by IMAD, the uint16 searches' sequence; RATE_INSTRS and RATE_SAMPLES
    give a step's instructions and samples). Each block reads the SM
    clock count (clock64) and the global nanosecond timer at its start
    and end; the rate is the grid's steps (lanes) over its whole span,
    in the SM clocks the blocks counted. Checks in the SASS that each
    chain is made of its instructions, where it has them. Returns the
    steps per clock per SM of each."""
    import ctypes
    from x265_tpu_torch import kernels
    iters, chains, threads = 4096, 8, 256
    lib = kernels.load("probes/int_rates")
    lib.int_rates_run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    sass = {f: Counter(o)
            for f, o in kernels.sass_opcodes("probes/int_rates").items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for op, name in enumerate(RATE_OPS):
        chain = next(c for f, c in sass.items() if f"chains<{op}>" in f)
        want = {k: chain[k] for k in RATE_SASS[name] or ()}
        if any(v < chains // len(want) for v in want.values()):
            raise AssertionError(f"int_rates {name}: SASS {want}")
        per_sm = lib.int_rates_blocks_per_sm(op)
        grid = per_sm * sms
        sink = torch.empty(grid * threads, dtype=torch.int32, device="cuda")
        cycles = torch.empty(grid, dtype=torch.int64, device="cuda")
        ns = torch.empty((grid, 2), dtype=torch.int64, device="cuda")
        for _ in range(2):                     # the first run warms up
            err = lib.int_rates_run(op, iters, grid, sink.data_ptr(),
                                    cycles.data_ptr(), ns.data_ptr())
            if err:
                raise RuntimeError(f"int_rates {name}: CUDA error {err}")
            torch.cuda.synchronize()
        clock_hz = float((cycles.double() /
                          (ns[:, 1] - ns[:, 0]).double()).mean()) * 1e9
        span_s = float(ns[:, 1].max() - ns[:, 0].min()) * 1e-9
        lanes = per_sm * threads * iters * chains / (span_s * clock_hz)
        rates[name] = lanes
        print(json.dumps({"int_rate": name, "blocks_per_sm": per_sm,
                          "lanes_per_clock_per_sm": lanes,
                          "instructions_per_step":
                          RATE_INSTRS.get(name, 1),
                          "samples_per_clock_per_sm":
                          lanes * RATE_SAMPLES[name]
                          if name in RATE_SAMPLES else None,
                          "warp_instructions_per_clock_per_sm": lanes / 32,
                          "sm_clock_hz": clock_hz, "span_s": span_s,
                          "sass": want or dict(chain.most_common(6))}),
              flush=True)
    return rates


def full_size_clip(n, size=(1080, 1920)):
    """The first n frames of the bench clip, cropped to size (h, w)."""
    return [tuple(p[:size[0] // (1 if k == 0 else 2),
                    :size[1] // (1 if k == 0 else 2)]
                  for k, p in enumerate(synth_1080p(i % 3, shift=2 * i)))
            for i in range(n)]


def path_stats(res, ctu=32) -> dict:
    """Over the P frames of one encode: the share of 8x8 cells that
    predict from reference 1 or later, per component the share of CTUs
    whose SAO is on (None without SAO) and, at CTU 64, the share of the
    area coded as 64x64 CUs."""
    ps = [r.syntax for r in res[1:]]
    cells = sum(s.depth8.size for s in ps)
    older = sum(int((s.ref8 > 0).sum()) for s in ps if s.ref8 is not None)
    cu64 = sum(int((s.depth8 == 0).sum()) for s in ps) / cells \
        if ctu == 64 else None
    sao = None
    if ps[0].sao_params is not None:
        ctus = sum(s.sao_params[0][..., 0].size for s in ps)
        sao = {c: sum(int((s.sao_params[k][..., 0] != 0).sum())
                      for s in ps) / ctus
               for k, c in enumerate(("y", "cb", "cr"))}
    nref = max(int(s.ref8.max()) for s in ps if s.ref8 is not None) + 1 \
        if any(s.ref8 is not None for s in ps) else 1
    by_ref = [sum(int((s.ref8 == r).sum()) if s.ref8 is not None else
                  (s.depth8.size if r == 0 else 0) for s in ps) / cells
              for r in range(nref)]
    return {"ref8_gt0_share": older / cells, "ref8_shares": by_ref,
            "sao_on_share": sao, "cu64_share": cu64}


def card_cpu_legs():
    """Phase 3's legs: (tag, clip, configuration, chunk)."""
    return (
        ("64x96 1I+6P", small_clip(7), bench_config, CHUNK),
        ("64x96 1I+6P me_range 7", small_clip(7),
         lambda h, w: bench_config(h, w, me_range=7), CHUNK),
        (BENCH_LEG, full_size_clip(2, CARD_CPU_SIZE), bench_config, CHUNK),
        ("fast/zerolatency 64x96 strobe 1I+6P chunk 2", strobe_clip(7),
         fast_config, 2),
        ("fast/zerolatency 1080x1920 1I+1P", full_size_clip(2),
         fast_config, CHUNK),
        ("medium/zerolatency 72x128 1I+6P chunk 2", medium_clip(7),
         medium_config, 2),
        ("medium/zerolatency 1080x1920 1I+1P", full_size_clip(2),
         medium_config, CHUNK),
        ("placebo/zerolatency 72x128 1I+5P chunk 5", medium_clip(6),
         placebo_config, 5),
        ("NR 600 + lowpass 64x96 1I+4P chunk 2", small_clip(5),
         nr_lowpass_config, 2),
        ("slow/zerolatency 1080x1920 1I+1P", full_size_clip(2),
         slow_config, CHUNK))


def cpu_leg_streams() -> dict:
    """The CPU half of every phase-3 leg, in a spawned process (it uses
    all but CPU_LEGS_SPARE of the host's cores): tag -> (the streams of
    its frames, seconds)."""
    import os
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - CPU_LEGS_SPARE))
    out = {}
    for tag, frames, make_cfg, chunk in card_cpu_legs():
        h, w = frames[0][0].shape
        t0 = time.perf_counter()
        res = encode_ippp(frames, "cpu", make_cfg(h, w), chunk=chunk)
        out[tag] = ([r.bitstream for r in res], time.perf_counter() - t0)
    return out


class CpuLegs:
    """Phase 3's CPU halves, started in a spawned process at the start of
    the run, beside the build, the kernel phases and the card halves (at
    1080p the CPU's I frames take most of the phase)."""

    def __init__(self) -> None:
        import multiprocessing
        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.result = self.pool.apply_async(cpu_leg_streams)

    def get(self) -> dict:
        try:
            return self.result.get()
        finally:
            self.pool.close()
            self.pool.join()


def phase_card_halves() -> list:
    """Phase 3's legs encoded on the card, each (tag, configuration,
    results, seconds); the bench leg's stream is kept to be decoded
    early, the small legs' for the decode phase."""
    cards = []
    for tag, frames, make_cfg, chunk in card_cpu_legs():
        h, w = frames[0][0].shape
        t0 = time.perf_counter()
        gpu = encode_ippp(frames, "cuda", make_cfg(h, w), chunk=chunk,
                          need_recon=True)
        cards.append((tag, make_cfg(h, w), gpu, time.perf_counter() - t0))
        if h * w <= SMALL_AREA or tag == BENCH_LEG:
            keep_for_decode(tag, gpu, early=tag == BENCH_LEG)
    return cards


def phase_card_equals_cpu(cards: list, cpu_legs: CpuLegs) -> dict:
    """Each leg's card results (phase_card_halves) held byte for byte to
    its CPU half (cpu_legs); returns the card's results per leg."""
    cpu_streams = cpu_legs.get()
    out = {}
    for tag, cfg, gpu, card_s in cards:
        cpu, cpu_s = cpu_streams[tag]
        if [r.bitstream for r in gpu] != cpu:
            raise AssertionError(f"card != CPU at {tag}")
        rec = {"card_equals_cpu": tag, "frames": len(gpu),
               "bytes": sum(len(r.bitstream) for r in gpu),
               "card_s": card_s, "cpu_s": cpu_s}
        if "placebo" in tag:
            last = gpu[-1].syntax
            if last.num_ref != 5 or len(set(last.ref_pocs)) != 5:
                raise AssertionError(f"{tag}: the last P frame has "
                                     f"{last.num_ref} references")
        if "strobe" in tag or "72x128" in tag:
            rec.update(path_stats(gpu, cfg.ctu_size))
            if rec["ref8_gt0_share"] == 0:
                raise AssertionError(f"{tag}: no block predicted from "
                                     f"reference 1 or later")
            if not any(rec["sao_on_share"].values()):
                raise AssertionError(f"{tag}: no CTU with SAO on")
            if rec["cu64_share"] == 0:
                raise AssertionError(f"{tag}: no 64x64 CU")
        print(json.dumps(rec), flush=True)
        out[tag] = gpu
    return out


def phase_b_card_equals_cpu():
    """The B path's card == CPU legs; returns the 1080p leg's card
    results up to its first mini-GOP."""
    out = None
    for tag, frames, make_cfg in (
            ("fast 64x96 1I+8 B loop", b_clip(9), fast_b_config),
            ("fast + RDOQ 64x96 1I+4 one mini-GOP", b_clip(5),
             fast_b_rdoq_config),
            ("fast 1080x1920 I+minigop", full_size_clip(5), fast_b_config)):
        h, w = frames[0][0].shape
        t0 = time.perf_counter()
        gpu, lengths = encode_random_access(frames, "cuda", make_cfg(h, w))
        t1 = time.perf_counter()
        cpu, lengths_cpu = encode_random_access(frames, "cpu",
                                                make_cfg(h, w))
        t2 = time.perf_counter()
        if lengths != lengths_cpu or len(gpu) != len(cpu) or any(
                a.bitstream != b.bitstream for a, b in zip(gpu, cpu)):
            raise AssertionError(f"card != CPU at {tag}")
        if h * w <= SMALL_AREA:
            keep_for_decode(tag, gpu)
        rec = {"card_equals_cpu": tag, "frames": len(gpu),
               "minigop_lengths": lengths,
               "bytes": sum(len(r.bitstream) for r in gpu),
               "card_s": t1 - t0, "cpu_s": t2 - t1, **b_stats(gpu)}
        print(json.dumps(rec), flush=True)
        if "RDOQ" in tag:
            if not any(r.ftype == "B" for r in gpu):
                raise AssertionError(f"{tag}: no B frame")
        elif "64x96" in tag:
            if len(lengths) < 2 or not all(rec["pf8_share"][k] > 0
                                           for k in ("l1", "bi")):
                raise AssertionError(f"{tag}: want two mini-GOPs with "
                                     f"L1-only and bi-predicted cells, got "
                                     f"{lengths} {rec['pf8_share']}")
        else:
            out = gpu[:1 + lengths[0]]
    return out


def phase_b_path(first_frames, digests=None):
    """The fast path with B frames at full size: the bench clip, a timed
    pass with every launch count set to 0 just before it and read just
    after (its warm-up is the 1080p card-vs-CPU leg of the same
    configuration, which ran on the card just before). Returns the
    launches."""
    frames = [synth_1080p(i % 3, shift=2 * i) for i in range(GOP)]
    cfg = fast_b_config(1080, 1920)
    reset_launches()
    split = {}
    t0 = time.perf_counter()
    res, lengths = encode_random_access(frames, "cuda", cfg, timing=split)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_p = sum(r.ftype == "P" for r in res)
    n_b = sum(r.ftype == "B" for r in res)
    want = {"gather_windows": 4 * n_p + 8 * n_b,
            "int_search": 2 * n_p + 4 * n_b,
            "int_search_pair": n_p + 2 * n_b}
    if not _want(launches, want) or any(launches["u16"].values()):
        raise AssertionError(f"fast_b: launches {launches}, want {want} "
                             f"({n_p} anchor P, {n_b} B)")
    if len(res) != GOP or n_b == 0 or any(len(r.bitstream) == 0
                                          for r in res):
        raise AssertionError("fast_b produced missing frames or no B frame")
    if [r.bitstream for r in res[:len(first_frames)]] != \
            [r.bitstream for r in first_frames]:
        raise AssertionError("fast_b: the clip's first frames differ from "
                             "its card-vs-CPU leg")
    if digests is not None:
        digests.check("phase_b_path", cfg, res)
    print(json.dumps({
        "path": "fast_b", "clip": "1080p random access CQP32 1I+24 "
        "(CLI B loop, b-adapt)", "frames": len(res),
        "bytes": sum(len(r.bitstream) for r in res),
        "i_frame_bytes": len(res[0].bitstream), "minigop_lengths": lengths,
        "anchor_p": n_p, "b_frames": n_b, "wall_s": wall,
        "fps": GOP / wall, **split,
        "anchor_p_frame_s": split["anchor_p_s"] / n_p,
        "b_frame_s": split["b_frames_s"] / n_b,
        "b_emit_frame_s": split["b_emit_s"] / n_b, "launches": launches,
        **b_stats(res)}), flush=True)
    return launches, frames


def phase_b_profile(frames):
    """torch.profiler over one mini-GOP of 4 (anchor P + 3 B) after the
    I frame, as phase_profile does for a P chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from x265_tpu_torch.enc import IntraEncoder
    enc = IntraEncoder(fast_b_config(1080, 1920), device="cuda")
    r0 = enc.encode_frame(*frames[0], qp=QP - 3, need_recon=False)
    enc.ref = r0.device_ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.encode_minigop(frames[1:5])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def self_dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    ev = prof.key_averages()
    kernels = sorted((e for e in ev if self_dev_us(e) > 0),
                     key=self_dev_us, reverse=True)
    busy_ms = sum(self_dev_us(e) for e in kernels
                  if e.device_type == DeviceType.CUDA) / 1e3
    print(json.dumps({"profile": "one fast_b mini-GOP (P + 3 B) at 1080p",
                      "wall_ms_profiled": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / wall_ms}), flush=True)
    for e in kernels[:10]:
        print(json.dumps({"path": "fast_b", "top_device_op": e.key[:120],
                          "self_device_ms": self_dev_us(e) / 1e3,
                          "calls": e.count}), flush=True)
    for e in ev:
        if "gather_windows_kernel" in e.key or "int_search_kernel" in e.key:
            print(json.dumps({"path": "fast_b", "watched_device_op":
                              e.key[:120],
                              "self_device_ms": self_dev_us(e) / 1e3,
                              "calls": e.count}), flush=True)
    # the host side: the ten ops that take the most host time themselves
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(json.dumps({"path": "fast_b", "top_host_op": e.key[:120],
                          "self_host_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count}), flush=True)


def host_b_config(h, w, bit_depth=8, bframes=1):
    """The host B path's configuration (tests/test_bframes.py's SAO
    leg): CQP 32, deblock, SAO and the MD5 SEI at 8 bits (no SAO at 10:
    ROADMAP item 31), two references for the P frames."""
    from x265_tpu_torch.common.params import EncoderConfig
    return EncoderConfig(width=w, height=h, qp=QP, deblock=True,
                         sao=bit_depth == 8, hash_sei=1, bframes=bframes,
                         num_refs=2, bit_depth=bit_depth)


def encode_host_b(frames, device, cfg, minigop=False, timing=None):
    """The host B path through its user entry points: encode_bgop (I,
    then P and one B per pair), or with minigop an IDR and
    encode_minigop(device=False) over the rest. `timing`, when a dict,
    receives the I, P and B frames' seconds (the device synchronized
    around each)."""
    from x265_tpu_torch.enc import IntraEncoder
    enc = IntraEncoder(cfg, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    secs = Counter()

    def timed(name, fn):
        def run(*a, **k):
            sync()
            t = time.perf_counter()
            r = fn(*a, **k)
            sync()
            secs[name] += time.perf_counter() - t
            return r
        return run

    enc.encode_frame = timed("i_frame_s", enc.encode_frame)
    enc.encode_frame_p = timed("p_frames_s", enc.encode_frame_p)
    enc.encode_frame_b = timed("b_frames_s", enc.encode_frame_b)
    if minigop:
        r0 = enc.encode_frame(*frames[0])
        enc.ref = r0.device_ref
        res = [r0] + enc.encode_minigop(frames[1:], device=False)
    else:
        res = enc.encode_bgop(frames)
    if timing is not None:
        timing.update(secs)
    return res


def phase_host_b_card_equals_cpu():
    """The host B path, card against CPU at 64x96: encode_bgop with
    deblock, SAO and the MD5 SEI and encode_minigop(device=False) over
    4 frames at 8 bits, encode_bgop without SAO at 10 bits;
    byte-identical streams, every frame's recon equal."""
    legs = (("host B encode_bgop 64x96 1I+2P+2B", b_clip(5), 8, False),
            ("host B encode_minigop(device=False) 64x96 1I+P+3B",
             b_clip(5), 8, True),
            ("host B Main10 encode_bgop --no-sao 64x96 1I+P+B",
             synth10_clip(3, 64, 96), 10, False))
    for tag, frames, bd, minigop in legs:
        cfg = host_b_config(64, 96, bd, bframes=3 if minigop else 1)
        t0 = time.perf_counter()
        gpu = encode_host_b(frames, "cuda", cfg, minigop)
        t1 = time.perf_counter()
        cpu = encode_host_b(frames, "cpu", cfg, minigop)
        t2 = time.perf_counter()
        if [r.bitstream for r in gpu] != [r.bitstream for r in cpu] or any(
                not np.array_equal(getattr(a.recon, k), getattr(b.recon, k))
                for a, b in zip(gpu, cpu) for k in ("y", "cb", "cr")):
            raise AssertionError(f"card != CPU at {tag}")
        if sum(r.ftype == "B" for r in gpu) != (3 if minigop else
                                                (len(frames) - 1) // 2):
            raise AssertionError(f"{tag}: frame types "
                                 f"{''.join(r.ftype for r in gpu)}")
        keep_for_decode(tag, gpu)
        print(json.dumps({"card_equals_cpu": tag, "frames": len(gpu),
                          "frame_types": "".join(r.ftype for r in gpu),
                          "bytes": sum(len(r.bitstream) for r in gpu),
                          "card_s": t1 - t0, "cpu_s": t2 - t1,
                          **b_stats(gpu)}), flush=True)


def phase_host_b_1080p():
    """The host B path at full size: encode_bgop over the bench clip's
    first 3 frames (I, P, B) on the card, with every launch count set to
    0 just before it and read just after: the P frame launches the
    gather 4 times and the searches 2 times, the B frame none (its
    search gathers each block at its own position). The stream is kept
    to be decoded early (DECODES.start), held to the card's recon."""
    frames = full_size_clip(3)
    cfg = host_b_config(1080, 1920)
    split = {}
    reset_launches()
    t0 = time.perf_counter()
    res = encode_host_b(frames, "cuda", cfg, timing=split)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"gather_windows": 4, "int_search": 2, "int_search_pair": 1}
    if not _want(launches, want) or any(launches["u16"].values()):
        raise AssertionError(f"host B 1080p: launches {launches}, want "
                             f"{want} (one P frame, the B frame none)")
    if [r.ftype for r in res] != ["I", "P", "B"]:
        raise AssertionError("host B 1080p: want I, P, B")
    keep_for_decode("host B encode_bgop 1080p I+P+B", res, early=True)
    print(json.dumps({
        "path": "host_b", "clip": "1080p encode_bgop CQP32 deblock + SAO "
        "+ MD5, I P B", "frames": len(res), "wall_s": wall, **split,
        "bytes": [len(r.bitstream) for r in res], "launches": launches,
        **b_stats(res)}), flush=True)


def chain_streams(syns, recons, cfg, qp=None) -> list:
    """A chain's P records (encode_chains) CABAC-coded and packed as the
    chain's own single-device encode codes them: the chain
    configuration's encoder right after its IDR (host only)."""
    from x265_tpu_torch.enc import IntraEncoder
    from x265_tpu_torch.parallel.gop_sharding import chain_config
    enc = IntraEncoder(chain_config(cfg), device="cpu")
    return [r.bitstream for r in enc._emit_p_frames(
        syns, recons, cfg.qp if qp is None else qp)]


def _chain_inputs(chains, cfg):
    """encode_chains_sharded's padded (C, F, Hp, Wp) planes and (C, Hp,
    Wp) references of (frames, ReconFrame) chains."""
    m = max(32, cfg.ctu_size)
    hp = (cfg.height_padded + m - 1) // m * m
    wp = (cfg.width_padded + m - 1) // m * m

    def padp(p, ph, pw):
        return np.pad(np.asarray(p), ((0, ph - p.shape[0]),
                                      (0, pw - p.shape[1])), mode="edge")

    sizes = ((hp, wp), (hp // 2, wp // 2), (hp // 2, wp // 2))
    planes = [np.stack([[padp(fr[k], *sizes[k]) for fr in frames]
                        for frames, _ in chains]) for k in range(3)]
    refs = [np.stack([padp(getattr(r, k), *sizes[i]) for _, r in chains])
            for i, k in enumerate(("y", "cb", "cr"))]
    return planes + refs


def phase_chains_card_equals_cpu():
    """encode_chains and encode_chains_sharded at 64x96 (bench
    configuration, two chains of 2 P frames after their own IDR) on the
    mesh ["cuda:0"] * 2 against ["cpu"] * 2: every result array, the
    final references, the per-chain rate estimates and their total
    equal, and each chain's stream equal."""
    from x265_tpu_torch.enc import IntraEncoder
    from x265_tpu_torch.parallel.gop_sharding import (
        encode_chains, encode_chains_sharded, make_gop_mesh)
    cfg = bench_config(64, 96)
    chains = []
    for c in range(2):
        frames = small_clip(3, seed=11 + c)
        r0 = IntraEncoder(cfg, device="cpu").encode_frame(*frames[0])
        chains.append((frames[1:], r0.recon))
    outs = {}
    for dev in ("cuda:0", "cpu"):
        mesh = make_gop_mesh(devices=[dev] * 2)
        t0 = time.perf_counter()
        sharded = encode_chains_sharded(*_chain_inputs(chains, cfg), cfg,
                                        cfg.qp, mesh, me_range=cfg.me_range)
        out, total = encode_chains(chains, cfg, mesh=mesh)
        outs[dev] = (sharded, total, [chain_streams(s, r, cfg)
                                      for s, r in out],
                     time.perf_counter() - t0)
    (g, gt, gs, g_s), (c, ct, cs, c_s) = outs["cuda:0"], outs["cpu"]
    arrays = list(g[0]) + list(g[1]), list(c[0]) + list(c[1])
    if any(not np.array_equal(a, b) or a.dtype != b.dtype
           for a, b in zip(*arrays)) or gs != cs or gt != ct or \
            not np.array_equal(g[3], c[3]) or g[2] != c[2]:
        raise AssertionError("chains: card != CPU")
    print(json.dumps({"card_equals_cpu": "encode_chains 64x96 2 chains x "
                      "2 P on cuda:0 x 2", "chain_rates": g[3].tolist(),
                      "total_rate": gt, "bytes": [sum(map(len, s))
                                                  for s in gs],
                      "card_s": g_s, "cpu_s": c_s}), flush=True)


def phase_chains_1080p(i_ref=None):
    """Two 1080p chains of the bench clip through encode_chains on
    ["cuda:0"] * 2, both from the bench clip's I recon (i_ref: phase 3's
    bench leg's; coded here when None): chain c codes frames 1 + 2c and
    2 + 2c. The launch counts are set to 0 just
    before the chain call and read just after (4 gathers and 2 searches
    per P frame on the mesh). Each chain's bytes must equal its own
    single-device encode on the card. Returns the launches."""
    from x265_tpu_torch.enc import IntraEncoder
    from x265_tpu_torch.parallel.gop_sharding import (
        chain_config, encode_chains, make_gop_mesh)
    cfg = bench_config(1080, 1920)
    frames = [synth_1080p(i % 3, shift=2 * i) for i in range(5)]
    if i_ref is None:
        i_ref = IntraEncoder(cfg, device="cuda").encode_frame(
            *frames[0], qp=cfg.qp - 3, need_recon=False).device_ref
    chains = [(frames[1 + 2 * c:3 + 2 * c], i_ref) for c in range(2)]
    mesh = make_gop_mesh(devices=["cuda:0"] * 2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, total = encode_chains(chains, cfg, mesh=mesh)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    launches = read_launches()
    want = {"gather_windows": 16, "int_search": 8, "int_search_pair": 4}
    if not _want(launches, want) or any(launches["u16"].values()):
        raise AssertionError(f"chains 1080p: launches {launches}, want "
                             f"{want}")
    streams = [chain_streams(s, r, cfg) for s, r in out]
    t0 = time.perf_counter()
    single = []
    for chain_frames, ref in chains:
        enc = IntraEncoder(chain_config(cfg), device="cuda")
        enc.ref = ref
        single.append([r.bitstream for r in enc.encode_pgop(chain_frames)])
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    if streams != single:
        raise AssertionError("chains 1080p: a chain's stream differs from "
                             "its single-device encode")
    print(json.dumps({
        "path": "chains", "clip": "1080p bench configuration, 2 chains x "
        "2 P from one I recon, mesh cuda:0 x 2", "chain_call_s": chain_s,
        "single_device_encodes_s": single_s, "total_rate": total,
        "bytes": [sum(map(len, s)) for s in streams],
        "launches": launches}), flush=True)
    return launches


def phase_b_fan_out():
    """encode_bframes_gpu(mesh=["cuda:0"] * 2) on a 64x96 layer of four B
    frames (--preset fast) equal to the single-device batch: every
    syntax field and recon; the launch counts (set to 0 just before the
    fanned-out call, read just after) 8 gathers and 4 searches per B
    frame."""
    from x265_tpu_torch.enc import IntraEncoder
    from x265_tpu_torch.enc.bframe_gpu import encode_bframes_gpu
    cfg = fast_b_config(64, 96)
    frames = b_clip(6)
    enc = IntraEncoder(cfg, device="cuda")
    r0 = enc.encode_frame(*frames[0])
    enc.ref = r0.device_ref
    r5 = enc.encode_pgop([frames[5]])[0]
    args = (frames[1:5], [r0.device_ref] * 4, [r5.recon] * 4, cfg, QP + 2)
    one = encode_bframes_gpu(*args, device="cuda")
    reset_launches()
    fan = encode_bframes_gpu(*args, mesh=["cuda:0"] * 2)
    launches = read_launches()
    want = {"gather_windows": 32, "int_search": 16}
    if not _want(launches, want):
        raise AssertionError(f"B fan-out: launches {launches}, want {want}")
    fields = ("depth8", "mv8", "pf8", "coeff_y", "coeff_cb", "coeff_cr")
    if len(fan[0]) != 4 or any(
            not np.array_equal(getattr(a, f), getattr(b, f))
            for a, b in zip(one[0], fan[0]) for f in fields) or any(
            not np.array_equal(getattr(a, k), getattr(b, k))
            for a, b in zip(one[1], fan[1]) for k in ("y", "cb", "cr")):
        raise AssertionError("B fan-out != the single-device batch")
    pf = np.concatenate([s.pf8.ravel() for s in fan[0]])
    print(json.dumps({"b_fan_out": "64x96 fast, 4 B frames on cuda:0 x 2",
                      "equals_single_device": True, "launches": launches,
                      "bi_share": float((pf == 3).mean())}), flush=True)


def phase_dqp_card_equals_cpu():
    """The per-CTU-QP legs, card against CPU: byte-identical streams and
    equal QP maps. encode_sequence with AQ 2 + cuTree at 1080p (1 I + 2
    P), a 64x96 --preset fast B mini-GOP with AQ 2 (flat maps through
    the P and B bodies), a 64x96 lossless I frame and a CTU-16 keyint-1
    I frame (both on the host-recon I path)."""
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc import IntraEncoder

    def fast_b_aq(h, w):
        cfg = fast_b_config(h, w)
        cfg.aq_mode = 2
        return cfg

    def i_frame(make_cfg):
        def run(frames, device):
            return [IntraEncoder(make_cfg(), device=device)
                    .encode_frame(*frames[0])], []
        return run

    frame = small_clip(1)
    legs = (
        ("aq2 + cutree medium/zerolatency 1080x1920 1I+1P encode_sequence",
         full_size_clip(2), lambda fr, d: encode_seq(
             fr, d, aq_cutree_config(*fr[0][0].shape))),
        ("fast + aq2 64x96 1I+4 B loop", b_clip(5),
         lambda fr, d: (encode_random_access(fr, d, fast_b_aq(64, 96))[0],
                        [])),
        ("lossless 64x96 I", frame, i_frame(lambda: EncoderConfig(
            width=96, height=64, qp=QP, lossless=True))),
        ("ctu16 keyint 1 64x96 I", frame, i_frame(lambda: EncoderConfig(
            width=96, height=64, qp=QP, ctu_size=16, keyint=1, bframes=0,
            deblock=True))))
    out = None
    for tag, frames, run in legs:
        t0 = time.perf_counter()
        gpu, gmaps = run(frames, "cuda")
        t1 = time.perf_counter()
        cpu, cmaps = run(frames, "cpu")
        t2 = time.perf_counter()
        if len(gpu) != len(cpu) or any(
                a.bitstream != b.bitstream for a, b in zip(gpu, cpu)):
            raise AssertionError(f"card != CPU at {tag}")
        maps_g, maps_c = ([m for m, _ in coded] +
                          [r.syntax.qp_map for r in res
                           if getattr(r.syntax, "qp_map", None) is not None]
                          for coded, res in ((gmaps, gpu), (cmaps, cpu)))
        if len(maps_g) != len(maps_c) or any(
                not np.array_equal(a, b) for a, b in zip(maps_g, maps_c)):
            raise AssertionError(f"card != CPU QP maps at {tag}")
        if "1080" not in tag:
            keep_for_decode(tag, gpu)
        rec = {"card_equals_cpu": tag, "frames": len(gpu),
               "bytes": sum(len(r.bitstream) for r in gpu),
               "card_s": t1 - t0, "cpu_s": t2 - t1}
        if gmaps:
            rec.update(qp_map_stats(gmaps))
        print(json.dumps(rec), flush=True)
        if "encode_sequence" in tag:
            out = gpu
            if rec["qp_ne_slice_share"] == 0:
                raise AssertionError(f"{tag}: every CTU at its slice QP")
        if "B loop" in tag and not any(r.ftype == "B" for r in gpu):
            raise AssertionError(f"{tag}: no B frame")
    return out


def phase_aq_cutree(first_frames, digests=None):
    """The medium/zerolatency path with AQ 2 + cuTree at full size,
    through encode_sequence: the bench clip, a timed pass with every
    launch count set to 0 just before it and read just after (its
    warm-up is the 1080p card-vs-CPU leg of the same configuration,
    which ran on the card just before; the lookahead sees the whole
    25-frame GOP, so the maps differ from that 2-frame leg's; digests,
    a RefDigests, holds it to the reference's frames). Then one
    profile of its P chunk with its maps after its I frame, and the
    device's busy and idle shares of the timed pass's P-frame wall.
    Returns the launches."""
    frames = [synth_1080p(i % 3, shift=2 * i) for i in range(GOP)]
    cfg = aq_cutree_config(1080, 1920)
    reset_launches()
    split = {}
    t0 = time.perf_counter()
    res, coded = encode_seq(frames, "cuda", cfg, timing=split)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_p = sum(r.ftype == "P" for r in res)
    n_i = len(res) - n_p
    want = {"gather_windows": 4 * n_p, "int_search": 2 * n_p,
            "int_search_pair": n_p}
    if not _want(launches, want) or any(launches["u16"].values()):
        raise AssertionError(f"aq_cutree: launches {launches}, want {want}")
    if len(res) != GOP or n_p == 0 or any(len(r.bitstream) == 0
                                          for r in res):
        raise AssertionError("aq_cutree produced missing frames")
    if first_frames is None or len(first_frames) != 2:
        raise AssertionError("aq_cutree: no card-vs-CPU leg ran")
    if digests is not None:
        digests.check("phase_aq_cutree", cfg, res)
    stats = qp_map_stats(coded)
    if stats["qp_ne_slice_share"] == 0:
        raise AssertionError("aq_cutree: every CTU at its slice QP")
    nbytes = sum(len(r.bitstream) for r in res)
    print(json.dumps({
        "path": "aq_cutree", "clip": "1080p encode_sequence CQP32 aq-mode "
        "2 + cuTree, 25 frames", "frames": len(res),
        "frame_types": "".join(r.ftype for r in res), "bytes": nbytes,
        "medium_path_bytes": 732471, "i_frame_bytes": len(res[0].bitstream),
        "wall_s": wall, "fps": GOP / wall, **split,
        "i_frame_s_each": split["i_frame_s"] / n_i,
        "lookahead_s_per_gop": split["lookahead_s"],
        "p_frame_s": split["p_frames_s"] / n_p, "launches": launches,
        **stats, **path_stats(res, cfg.ctu_size)}), flush=True)
    busy_ms = phase_profile(frames, cfg, "aq_cutree", coded,
                            res[0].device_ref)
    p_s = split["p_frames_s"] / n_p
    print(json.dumps({"path": "aq_cutree", "device_busy_ms_per_p_frame":
                      busy_ms, "p_frame_s": p_s,
                      "device_busy_share": busy_ms / 1e3 / p_s,
                      "device_idle_share": 1 - busy_ms / 1e3 / p_s}),
          flush=True)
    return launches


ME_WINDOWED_RADIUS = 6
ME_WINDOWED_SIDES = (5, 11, 13, 15, 21, 25)   # 13: radius 6


class _Recorder:
    """Stands in for a kernel wrapper of ops.me_win: records each call's
    arguments and passes it on. Other attributes (the launch counts,
    which the wrapper moves through its module name) are the wrapper's."""

    def __init__(self, name):
        from x265_tpu_torch.ops import me_win
        object.__setattr__(self, "fn", getattr(me_win, name))
        object.__setattr__(self, "calls", [])

    def __getattr__(self, key):
        return getattr(self.fn, key)

    def __setattr__(self, key, value):
        setattr(self.fn, key, value)

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


SMALL_GEOMETRY = ("threads_a_block", "units_a_task", "lanes_a_unit", "R",
                  "blocks_per_sm", "registers", "smem_bytes", "grid",
                  "tasks")


def small_geometry(win, cur_p, n, side, lead) -> dict:
    """The launch geometry the 8- and 16-block search gives these
    arguments (csrc/int_search.cu int_search_small_geometry): threads a
    block, units a task (a warp's group), lanes a unit, R, resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers a thread, shared memory a block, grid blocks, tasks; and
    the resident warps per SM that follow."""
    import ctypes
    from x265_tpu_torch import kernels
    fn = kernels.load("int_search").int_search_small_geometry
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    info = (ctypes.c_int * len(SMALL_GEOMETRY))()
    w = cur_p.shape[1]
    err = fn(win.element_size(), n, win.shape[0], win.shape[1], lead, side,
             w, w // n, info)
    if err:
        raise RuntimeError(f"int_search_small_geometry: CUDA error {err}")
    geo = dict(zip(SMALL_GEOMETRY, info))
    geo["warps_per_sm"] = geo["blocks_per_sm"] * geo["threads_a_block"] // 32
    return geo


def walk_issue(geo, n, side, kb, walks, alu_lanes, sms, clock_hz,
               ms) -> dict | None:
    """The time an 8- or 16-block search's walks take at the integer
    ALU's measured issue rate: each of the call's tasks (one warp's
    units) runs ceil(items kL / lanes a unit) walks a lane, where items
    = side ceil(side / R) and kL lanes make a candidate (2 at 10 bits
    and n = 16), each of the SASS walk's ALU instructions (walks, from
    print_build_report) once; over every SM at alu_lanes / 32 warp
    instructions a clock. Beside it the measured ms and their ratio: a
    ratio near 1 is an issue limit, far under it latency or the work
    around the walk."""
    name = f"int_search_small_kernel<{n}, {geo['R']}, {kb}>"
    if not walks or name not in walks:
        return None
    kl = max(1, n * kb // 16)
    items = side * -(-side // geo["R"])
    loops = -(-items * kl // geo["lanes_a_unit"])
    alu = walks[name]["alu"] * loops * geo["tasks"]
    alu_ms = alu / (sms * alu_lanes / 32 * clock_hz) * 1e3
    return {"instance": name, "walk_alu_per_task": walks[name]["alu"] * loops,
            "walk_fma_per_task": walks[name]["fma"] * loops,
            "alu_warp_instructions": alu, "alu_ms": alu_ms,
            "alu_share": alu_ms / ms}


def phase_me_windowed(rates, walks=None) -> dict:
    """me_size_windowed (the reference's windowed ME of one block size,
    x265_tpu/ops/me_win.py:402) at 1080p, its kernels and its MC.

    First the 8- and 16-block single-search instances (int_search_u8 and
    int_search_u16 at n = 8 and 16, lead 0) against their plain version
    over the 1088x1920 scan at sides 5-25 on random, near-flat and flat
    windows, and at 10 bits on the curmax and cur0 extremes, exactly.
    Then, at 8 bits on the bench clip's frame 1 against frame 0 and at
    10 bits on synth10_1080p's, coded 1088x1920, radius 6, pad 2r + 8:
    me_size_windowed for n = 8, 16 and 32 and mc_block_batch_ds at its
    MVs (luma at n, cb and cr at n / 2), with every count set to 0 just
    before and read just after: 5 gathers and one single search at n per
    size, no pair search. Each output must equal the same path with the
    plain gather and search (on the card), and pred and the luma
    mc_block_batch_ds must equal mc_block_batch at the returned MVs.
    Each kernel call of the path is then timed alone on its own
    arguments (device ms, kernel and plain, per call and per frame of
    the three sizes) beside its bound; an 8- or 16-block call also
    beside its walk's issue time (walk_issue: the unrolled walk's ALU
    instructions from the SASS (walks, print_build_report) for every
    item of every task, at the VABSDIFF4 chain's measured warp
    instructions a clock per SM, on every SM; the staging, packing and
    selection around the walk left out). Returns, per bit depth, the
    launches and the per-instance numbers for the kernels line."""
    from x265_tpu_torch.enc.encoder import pad_plane
    from x265_tpu_torch.ops import me_win
    from x265_tpu_torch.ops.interp import mc_block_batch
    r = ME_WINDOWED_RADIUS
    pad = 2 * r + 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_clock_hz()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2027)
    # 1. the new instances against the plain version, every side and case
    for bits in (8, 10):
        cases = ("random", "near_flat", "flat") + \
            (("curmax", "cur0") if bits == 10 else ())
        for n in (8, 16):
            for side in ME_WINDOWED_SIDES:
                for case in cases:
                    args = _search_case(
                        gen, case, n, (SCAN[0] // n) * (SCAN[1] // n), side,
                        bits, lead=0, pair=False)
                    got = me_win.int_search_windows(*args, n, side, 0)
                    want = me_win.int_search_windows_plain(*args, n, side, 0)
                    torch.cuda.synchronize()
                    err = max(int((g.long() - w.long()).abs().max())
                              for g, w in zip(got, want))
                    if err or (case in ("flat", "curmax", "cur0") and
                               int(got[1].abs().max())):
                        raise AssertionError(
                            f"int_search n={n} {bits}-bit side {side} "
                            f"{case}: kernel != plain (max abs err {err}) "
                            f"or a tie did not pick index 0")
        print(json.dumps({"me_windowed_search_check": bits, "n": [8, 16],
                          "sides": ME_WINDOWED_SIDES, "cases": cases,
                          "max_abs_err": 0}), flush=True)

    out = {}
    h, w = SCAN
    for bits in (8, 10):
        f0, f1 = (synth_1080p(i % 3, shift=2 * i) if bits == 8
                  else synth10_1080p(i) for i in (0, 1))
        dt = np.uint8 if bits == 8 else np.int16

        def dev_plane(p, hh, ww):
            t = torch.from_numpy(pad_plane(p, hh, ww).astype(dt)).cuda()
            return t.view(torch.uint16) if bits == 10 else t
        ref_y = dev_plane(f0[0], h, w)
        ref_c = [dev_plane(c, h // 2, w // 2) for c in f0[1:]]
        cur = torch.from_numpy(pad_plane(f1[0], h, w).astype(np.int32)) \
            .cuda()
        ref_pad = me_win.pad_ref(ref_y, pad)
        cpads = [me_win.pad_ref(c, pad) for c in ref_c]

        def run():
            res = {}
            for n in (8, 16, 32):
                b = (h // n) * (w // n)
                seeds = torch.zeros((b, 2), dtype=torch.int32, device="cuda")
                mvq, cost, pred = me_win.me_size_windowed(
                    cur, ref_pad, seeds, 20, n, radius=r, bit_depth=bits,
                    pad=pad)
                ys = (torch.arange(h // n, dtype=torch.int32,
                                   device="cuda") * n).repeat_interleave(
                    w // n)
                xs = (torch.arange(w // n, dtype=torch.int32,
                                   device="cuda") * n).repeat(h // n)
                mcs = [me_win.mc_block_batch_ds(
                    ref_pad, pad, xs, ys, mvq[:, 0], mvq[:, 1], n,
                    bit_depth=bits)] + [me_win.mc_block_batch_ds(
                        cp, pad, xs // 2, ys // 2, mvq[:, 0], mvq[:, 1],
                        n // 2, is_luma=False, bit_depth=bits)
                        for cp in cpads]
                res[n] = (mvq, cost, pred, *mcs, xs, ys)
            return res

        rec = {k: _Recorder(k) for k in ("gather_windows",
                                         "int_search_windows")}
        torch.cuda.synchronize()
        reset_launches()
        for k, v in rec.items():
            setattr(me_win, k, v)
        t0 = time.perf_counter()
        try:
            res = run()
            torch.cuda.synchronize()
        finally:
            for k, v in rec.items():
                setattr(me_win, k, v.fn)
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        sfx = "u8" if bits == 8 else "u16"
        want_u16 = 0 if bits == 8 else 1
        if launches["gather_windows"] != 15 or \
                launches["u16"]["gather_windows"] != 15 * want_u16 or \
                launches["int_search_pair"] != 0 or \
                launches["int_search_single_n"] != {8: 1, 16: 1, 32: 1} or \
                launches["int_search_single_n_u16"] != \
                {n: want_u16 for n in (8, 16, 32)}:
            raise AssertionError(f"me_windowed {bits}-bit: launches "
                                 f"{launches}, want 15 gathers and one "
                                 f"single search per size")
        # the same path with the plain gather and search, on the card
        me_win.gather_windows = me_win.gather_windows_plain
        me_win.int_search_windows = me_win.int_search_windows_plain
        try:
            plain = run()
            torch.cuda.synchronize()
        finally:
            me_win.gather_windows = rec["gather_windows"].fn
            me_win.int_search_windows = rec["int_search_windows"].fn
        err = 0
        stats = {}
        for n in (8, 16, 32):
            mvq, cost, pred, mcy, mcb, mcr, xs, ys = res[n]
            for a, b in zip(res[n], plain[n]):
                err = max(err, int((a.long() - b.long()).abs().max()))
            mc = mc_block_batch(ref_y, xs, ys, mvq[:, 0], mvq[:, 1], n,
                                bit_depth=bits)
            if not (torch.equal(mc, pred) and torch.equal(mc, mcy)):
                raise AssertionError(f"me_windowed {bits}-bit n={n}: pred "
                                     f"or mc_block_batch_ds != "
                                     f"mc_block_batch at the MVs")
            for cp, got_c in zip(ref_c, (mcb, mcr)):
                if not torch.equal(got_c, mc_block_batch(
                        cp, xs // 2, ys // 2, mvq[:, 0], mvq[:, 1], n // 2,
                        is_luma=False, bit_depth=bits)):
                    raise AssertionError(f"me_windowed {bits}-bit n={n}: "
                                         f"chroma MC != mc_block_batch")
            mv = mvq.cpu().numpy()
            stats[n] = {"blocks": int(mv.shape[0]),
                        "mean_mvx_qpel": float(mv[:, 0].mean()),
                        "share_mvx_-8": float((mv[:, 0] == -8).mean()),
                        "mean_cost": float(cost.double().mean())}
        if err:
            raise AssertionError(f"me_windowed {bits}-bit: kernel path != "
                                 f"plain path, max abs err {err}")

        # each kernel call alone, on the arguments the path gave it
        rate = INT32_LANES_PER_SM if bits == 8 else rates["sad16_max_imad"]
        spp = 4 if bits == 8 else RATE_SAMPLES["sad16_max_imad"]
        lane_ops_per_s = sms * rate * clock_hz
        calls = []
        for args, kw in rec["gather_windows"].calls:
            src, ys_t, xs_t, win = args
            ar = torch.arange(win, device="cuda")
            yy = (me_win._start(ys_t, src.shape[0], win).long()[:, None]
                  + ar)[:, :, None]
            xx = (me_win._start(xs_t, src.shape[1], win).long()[:, None]
                  + ar)[:, None, :]
            src_i = src.view(torch.int16) if bits == 10 else src
            t = timed({
                "kernel": lambda a=args: rec["gather_windows"].fn(*a),
                "plain": lambda a=args: me_win.gather_windows_plain(*a),
                "library": lambda s_=src_i, y_=yy, x_=xx: s_[y_, x_]})
            touched = touched_pixels(src.shape[0], src.shape[1], ys_t, xs_t,
                                     win)
            nb = ys_t.shape[0]
            nbytes = touched * src.element_size() + 8 * nb + \
                nb * win * win * src.element_size()
            calls.append({"kernel": f"gather_windows_{sfx}", "win": win,
                          "windows": nb, "ms": t["kernel"][0],
                          "ms_spread": t["kernel"][1:],
                          "plain_ms": t["plain"][0],
                          "library_ms": t["library"][0],
                          "bound_ms": nbytes / BYTES_PER_S * 1e3,
                          "bound_by": "bytes", "bytes": nbytes})
        for args, kw in rec["int_search_windows"].calls:
            win, cur_p, penx, peny, n, side = args[:6]
            lead = args[6] if len(args) > 6 else kw.get("lead", 4)
            t = timed({
                "kernel": lambda a=args, k_=kw:
                    rec["int_search_windows"].fn(*a, **k_),
                "plain": lambda a=args, k_=kw:
                    me_win.int_search_windows_plain(*a, **k_)})
            nb = win.shape[0]
            # windows and the current plane at the sample width (all
            # the search compares), penalties, results
            nbytes = (win.numel() + cur_p.numel()) * win.element_size() + \
                (penx.numel() + peny.numel()) * 4 + 8 * nb
            px_cand = nb * n * n * side * side
            ops_ms = px_cand / spp / lane_ops_per_s * 1e3
            bytes_ms = nbytes / BYTES_PER_S * 1e3
            geo = small_geometry(win, cur_p, n, side, lead) \
                if n in (8, 16) else None
            issue = walk_issue(geo, n, side, win.element_size(), walks,
                               rates["vabsdiff4"], sms, clock_hz,
                               t["kernel"][0]) if geo else None
            calls.append({"kernel": f"int_search_{sfx}", "n": n,
                          "side": side, "lead": lead, "units": nb,
                          "geometry": geo, "walk_issue": issue,
                          "bound_share": max(ops_ms, bytes_ms) /
                          t["kernel"][0],
                          "ms": t["kernel"][0], "ms_spread": t["kernel"][1:],
                          "plain_ms": t["plain"][0], "library_ms": None,
                          "bound_ms": max(ops_ms, bytes_ms),
                          "bound_by": "operations" if ops_ms >= bytes_ms
                          else "bytes", "ops_ms": ops_ms,
                          "bytes_ms": bytes_ms, "bytes": nbytes,
                          "pixel_candidates": px_cand})
        for c in calls:
            print(json.dumps({"me_windowed_call": bits, **c}), flush=True)
        print(json.dumps({"me_windowed": bits, "coded": [h, w],
                          "radius": r, "pad": pad, "wall_s": wall_s,
                          "launches": launches, "max_abs_err": err,
                          "pred_equals_mc_block_batch": True,
                          "kernel_path_equals_plain_path": True,
                          "sizes": stats}), flush=True)
        out[bits] = {"launches": launches, "calls": calls,
                     "max_abs_err": err}
    return out


COUNTED = ("gather_windows", "int_search_pair_windows", "int_search_windows")


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts (both instances, the
    uint16 one alone, and the single search's per block size) to 0."""
    from x265_tpu_torch.ops import me_win
    for name in COUNTED:
        fn = getattr(me_win, name)
        fn.launches = fn.launches_u16 = 0
    s = me_win.int_search_windows
    for n in s.launches_n:
        s.launches_n[n] = s.launches_n_u16[n] = 0


def read_launches() -> dict:
    """The wrappers' launch counts: the gather and the two searches
    together (as the per-frame checks count them), the pair search
    alone, the single search per block size (both instances, and the
    uint16 one), and each wrapper's uint16 (Main10) instance alone."""
    from x265_tpu_torch.ops import me_win
    g, p, s = (getattr(me_win, name) for name in COUNTED)
    return {"gather_windows": g.launches,
            "int_search": p.launches + s.launches,
            "int_search_pair": p.launches,
            "int_search_single_n": dict(s.launches_n),
            "int_search_single_n_u16": dict(s.launches_n_u16),
            "u16": {"gather_windows": g.launches_u16,
                    "int_search_pair": p.launches_u16,
                    "int_search_single": s.launches_u16}}


def _want(launches: dict, want: dict) -> bool:
    """Whether the counts named in want are as wanted."""
    return all(launches[k] == v for k, v in want.items())


def phase_path(path: str, make_cfg, first_frames, digests=None):
    """One path at full size: the bench clip, 1 I + 24 P in chunks of 8,
    a warm-up pass over its first chunk (1 I + 8 P), then a timed pass
    with every launch count set to 0 just before it and read just
    after. first_frames: the card's frames of a card-vs-CPU leg of this
    configuration on the same clip, which the timed pass must
    reproduce; digests (RefDigests) holds the timed pass to the
    reference's frames. Returns the launches, the clip and the timed
    pass's I frame (its DeviceRef), from which the path's profile
    predicts."""
    frames = [synth_1080p(i % 3, shift=2 * i) for i in range(GOP)]
    t0 = time.perf_counter()
    warm = encode_ippp(frames[:1 + CHUNK], "cuda", make_cfg(1080, 1920))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    split = {}
    t0 = time.perf_counter()
    res = encode_ippp(frames, "cuda", make_cfg(1080, 1920), timing=split)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for name, per_frame in (("gather_windows", 4), ("int_search", 2)):
        if launches[name] != per_frame * (GOP - 1):
            raise AssertionError(
                f"{path}: {name} launched {launches[name]} times in the "
                f"timed pass, want {per_frame * (GOP - 1)}")
    if launches["int_search_pair"] != GOP - 1 or any(
            launches["u16"].values()):
        raise AssertionError(f"{path}: the pair search did not run once "
                             f"per P frame, or a uint16 instance ran")
    if len(res) != GOP or any(len(r.bitstream) == 0 for r in res):
        raise AssertionError(f"{path} produced missing frames")
    if any(a.bitstream != b.bitstream for a, b in zip(res, warm)):
        raise AssertionError(f"{path}: two passes over one chunk differ")
    if [r.bitstream for r in res[:len(first_frames)]] != \
            [r.bitstream for r in first_frames]:
        raise AssertionError(f"{path}: the clip's first frames differ from "
                             f"its card-vs-CPU leg")
    if digests is not None:
        digests.check(f"phase_path:{path}", make_cfg(1080, 1920), res)
    nbytes = sum(len(r.bitstream) for r in res)
    print(json.dumps({"path": path,
                      "clip": "1080p IPPP CQP32 1I+24P chunk 8",
                      "frames": len(res), "bytes": nbytes,
                      "i_frame_bytes": len(res[0].bitstream),
                      "warmup_s": warm_s, "wall_s": wall,
                      "fps": GOP / wall, **split,
                      "p_frame_s": split["p_frames_s"] / (GOP - 1),
                      "launches": launches,
                      **path_stats(res, make_cfg(1080, 1920).ctu_size)}),
          flush=True)
    return launches, frames, res[0].device_ref


def phase_rdoq(frames, i_ref):
    """RDOQ's cost in one slow/zerolatency P frame at 1080p: every
    rdoq_lanes call of the frame recorded (its inputs kept), then
    replayed alone, once to warm up and once under torch.profiler: the
    calls, the device ops they launch and those ops' device time, and
    the replay's wall time. i_ref: the slow path's I frame (DeviceRef)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from x265_tpu_torch.enc import IntraEncoder, pgop_gpu
    calls = []
    real = pgop_gpu.rdoq_lanes

    def record(tcoef, *a, **k):
        calls.append((tcoef.clone(), a, k))
        return real(tcoef, *a, **k)

    enc = IntraEncoder(slow_config(1080, 1920), device="cuda")
    enc.ref = i_ref
    pgop_gpu.rdoq_lanes = record
    try:
        enc.encode_pgop(frames[1:2], need_recon=False)
    finally:
        pgop_gpu.rdoq_lanes = real

    def replay():
        for t, a, k in calls:
            real(t, *a, **k)
        torch.cuda.synchronize()

    replay()
    t0 = time.perf_counter()
    replay()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]

    def self_dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    rec = {"rdoq_per_p_frame": "slow/zerolatency 1080p",
           "calls": len(calls),
           "sizes": dict(Counter(f"{a[0]}" for _, a, _ in calls)),
           "device_ops": sum(e.count for e in dev),
           "device_ms": sum(self_dev_us(e) for e in dev) / 1e3,
           "replay_wall_ms": wall_ms}
    print(json.dumps(rec), flush=True)
    return rec


def phase_profile(frames, cfg, path="bench", coded=None, i_ref=None):
    """torch.profiler over one P chunk of PROFILE_P frames of the path in
    configuration cfg (the trace's processing, not the frames, takes
    most of a profile's time): the device busy time per P frame, the
    ten device ops that take the most time, a few watched ops, and the
    chunk's device-busy share of the profiled wall. coded: the (map,
    slice QP) per frame of a dQP path, whose maps the chunk codes;
    i_ref: the I frame's DeviceRef, when one is already encoded.
    Returns the device busy ms per P frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from x265_tpu_torch.enc import IntraEncoder
    enc = IntraEncoder(cfg, device="cuda")
    if i_ref is None:
        i_ref = enc.encode_frame(*frames[0], qp=QP - 3,
                                 need_recon=False).device_ref
    enc.ref = i_ref
    maps = None if coded is None else \
        np.stack([m for m, _ in coded[1:1 + PROFILE_P]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.encode_pgop(frames[1:1 + PROFILE_P], need_recon=False,
                        qp_maps=maps)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def self_dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    ev = prof.key_averages()

    kernels = sorted((e for e in ev if self_dev_us(e) > 0),
                     key=self_dev_us, reverse=True)
    # device-side rows only: an operator row repeats its kernels' time
    busy_ms = sum(self_dev_us(e) for e in kernels
                  if e.device_type == DeviceType.CUDA) / 1e3
    print(json.dumps({"profile": f"one {path} P chunk of {PROFILE_P} at "
                      "1080p", "wall_ms_profiled": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_busy_ms_per_p_frame": busy_ms / PROFILE_P,
                      "device_busy_share": busy_ms / wall_ms}), flush=True)
    for e in kernels[:10]:
        print(json.dumps({"path": path, "top_device_op": e.key[:120],
                          "self_device_ms": self_dev_us(e) / 1e3,
                          "calls": e.count}), flush=True)
    # the ops the integer search used to launch, and the port's kernels
    for e in ev:
        if e.key in ("aten::sub", "aten::abs", "aten::sum") or \
                "gather_windows_kernel" in e.key or \
                "int_search_kernel" in e.key:
            print(json.dumps({"path": path, "watched_device_op": e.key[:120],
                              "self_device_ms": self_dev_us(e) / 1e3,
                              "calls": e.count}), flush=True)
    return busy_ms / PROFILE_P


# --- the CLI (python -m x265_tpu_torch.cli) ---------------------------------

CLI_RATE = ["--bitrate", "3000", "--vbv-maxrate", "3000", "--vbv-bufsize",
            "6000", "--hash", "1"]
CLI_1080P = ["--preset", "medium", "--tune", "zerolatency", *CLI_RATE]
ZL_FAST = ["--preset", "ultrafast", "--tune", "zerolatency"]
MASTER_DISPLAY = ("G(13250,34500)B(7500,3000)R(34000,16000)"
                  "WP(15635,16450)L(10000000,1)")
HDR10 = ["--colorprim", "bt2020", "--transfer", "smpte2084",
         "--colormatrix", "bt2020nc", "--master-display", MASTER_DISPLAY,
         "--max-cll", "1000,400"]
# the Main10 CLI cell: CLI_1080P at 10 bits with SAO off (ROADMAP item
# 31), with the HDR10 signalling live HDR encoders send
CLI_MAIN10 = ["--preset", "medium", "--tune", "zerolatency", "--no-sao",
              *CLI_RATE, *HDR10]
# the 64x96 card == CPU legs: (tag, clip, passes); each pass is the
# flags of one cli.main call ({d}: the leg's directory)
CLI_LEGS = (
    ("fast crf 28 (B frames, b-adapt) 10 frames", lambda: b_clip(10),
     [["--preset", "fast", "--crf", "28", "--csv-log-level", "1"]]),
    ("ultrafast/zerolatency ABR + VBV, hash, AUD, no-annexb 8 frames",
     lambda: small_clip(8),
     [[*ZL_FAST, "--bitrate", "200", "--vbv-maxrate", "200",
       "--vbv-bufsize", "400", "--hash", "1", "--aud", "--no-annexb"]]),
    ("two-pass ABR 150 8 frames", lambda: small_clip(8),
     [[*ZL_FAST, "--bitrate", "150", "--pass", "1", "--stats",
       "{d}/2pass.log"],
      [*ZL_FAST, "--bitrate", "150", "--pass", "2", "--stats",
       "{d}/2pass.log"]]),
    ("analysis save then load 8 frames", lambda: small_clip(8),
     [[*ZL_FAST, "--analysis-save", "{d}/analysis.npz"],
      [*ZL_FAST, "--analysis-load", "{d}/analysis.npz"]]),
    ("fast/zerolatency wpp=1 8 frames", lambda: small_clip(8),
     [["--preset", "fast", "--tune", "zerolatency", "--param", "wpp=1",
       "--hash", "1", "--recon", "{d}/rec.y4m"]]),
    ("AbrEncoder 96x64 ABR 200 + 48x32 CQP, 6 frames", lambda: small_clip(6),
     None))


def write_y4m(path, frames, bit_depth=8) -> str:
    from x265_tpu_torch.io import Y4MWriter
    h, w = frames[0][0].shape
    wr = Y4MWriter(str(path), w, h, bit_depth=bit_depth)
    for f in frames:
        wr.write_frame(*f)
    wr.close()
    return str(path)


def csv_rows(path) -> list:
    """The rows of a --csv file, the wall_s column dropped."""
    rows = [r.split(",") for r in open(path).read().splitlines()]
    drop = rows[0].index("wall_s") if "wall_s" in rows[0] else None
    return [[c for k, c in enumerate(r) if k != drop] for r in rows]


def cli_leg_outputs(tag, device, workdir) -> dict:
    """One CLI leg's passes through cli.main on device (or, for the
    ladder, AbrEncoder), in workdir. Returns {file: content}: output
    bytes, csv rows without wall_s, the two-pass stats text and the
    analysis file's arrays."""
    import io
    import pathlib
    from x265_tpu_torch import abr
    from x265_tpu_torch.cli import main as cli_main
    from x265_tpu_torch.common.params import EncoderConfig
    _, clip, passes = next(leg for leg in CLI_LEGS if leg[0] == tag)
    d = pathlib.Path(workdir)
    d.mkdir(parents=True, exist_ok=True)
    frames = clip()
    if passes is None:
        base = EncoderConfig(width=96, height=64, qp=32, hash_sei=1)
        base.apply_preset("ultrafast")
        base.bframes = 0
        outs = [io.BytesIO(), io.BytesIO()]
        ladder = abr.AbrEncoder([abr.Rung(96, 64, 200), abr.Rung(48, 32, 0)],
                                base, outs, device=device)
        for f in frames:
            ladder.push_frame(f)
        return {f"rung{k}": o.getvalue() for k, o in enumerate(outs)}
    src = write_y4m(d / "in.y4m", frames)
    for k, flags in enumerate(passes):
        argv = [src, "-o", str(d / f"out{k}.hevc"), "--csv",
                str(d / f"s{k}.csv"), "--no-progress",
                *(f.format(d=d) for f in flags)]
        if cli_main(argv, device=device) != 0:
            raise AssertionError(f"{tag}: cli.main failed on {device}")
    out = {}
    for p in sorted(d.iterdir()):
        if p.suffix == ".hevc":
            out[p.name] = p.read_bytes()
        elif p.suffix == ".csv":
            out[p.name] = csv_rows(p)
        elif p.suffix == ".log":
            out[p.name] = p.read_text()
        elif p.suffix == ".npz":
            out[p.name] = [{k: np.asarray(v).tolist() for k, v in fr.items()}
                           for fr in np.load(p, allow_pickle=True)["frames"]]
    return out


class EncoderTimer:
    """Wall seconds of IntraEncoder.encode_frame and encode_pgop calls
    made inside cli.main (the class methods wrapped while the context
    is open; the device is synchronized around each call)."""

    def __enter__(self):
        from x265_tpu_torch.enc.encoder import IntraEncoder
        self.cls, self.secs = IntraEncoder, {"I": [], "P": []}
        self.real = {n: getattr(IntraEncoder, n)
                     for n in ("encode_frame", "encode_pgop")}

        def wrap(name, kind):
            fn = self.real[name]

            def run(enc, *a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(enc, *a, **k)
                torch.cuda.synchronize()
                self.secs[kind].append(time.perf_counter() - t)
                return r
            return run

        IntraEncoder.encode_frame = wrap("encode_frame", "I")
        IntraEncoder.encode_pgop = wrap("encode_pgop", "P")
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.cls, n, fn)


def phase_cli_card_equals_cpu(workdir):
    """Every 64x96 CLI leg on the card and on the CPU: the same output
    bytes, csv rows (but wall_s) and stats files."""
    import pathlib
    for tag, _, _ in CLI_LEGS:
        t0 = time.perf_counter()
        card_dir = pathlib.Path(f"{workdir}/{len(tag)}card")
        card = cli_leg_outputs(tag, "cuda", card_dir)
        t1 = time.perf_counter()
        cpu = cli_leg_outputs(tag, "cpu", f"{workdir}/{len(tag)}cpu")
        t2 = time.perf_counter()
        if card != cpu:
            bad = sorted(k for k in set(card) | set(cpu)
                         if card.get(k) != cpu.get(k))
            raise AssertionError(f"CLI card != CPU at {tag}: {bad}")
        streams = [v for k, v in card.items() if isinstance(v, bytes)]
        if (card_dir / "rec.y4m").exists():
            keep_cli_for_decode(f"CLI {tag}", card["out0.hevc"],
                                card_dir / "rec.y4m")
        print(json.dumps({"cli_card_equals_cpu": tag, "files": sorted(card),
                          "bytes": sum(len(v) for v in streams),
                          "card_s": t1 - t0, "cpu_s": t2 - t1}), flush=True)


def verify_hash_seis(stream: bytes, recon_y4m: str, bit_depth=8) -> int:
    """Every picture's MD5 SEI against its recon (IPPP: decode order is
    display order; 16-bit samples above 8 bits), with the port's parser
    and hash. Returns the count."""
    from x265_tpu_torch.bitstream.nal import split_annexb
    from x265_tpu_torch.bitstream.sei import (parse_picture_hash_sei,
                                              picture_md5)
    from x265_tpu_torch.io import Y4MReader
    seis = [parse_picture_hash_sei(rb) for t, rb, _ in split_annexb(stream)
            if int(t) == 40]
    recs = list(Y4MReader(recon_y4m))
    if len(seis) != len(recs):
        raise AssertionError(f"{len(seis)} hash SEIs for {len(recs)} "
                             f"frames")
    for k, (sei, rec) in enumerate(zip(seis, recs)):
        if sei is None or sei[0] != 1 or \
                sei[1] != picture_md5(*rec, bit_depth=bit_depth):
            raise AssertionError(f"frame {k}: MD5 SEI does not match the "
                                 f"recon")
    return len(seis)


def cli_pass(src, out, flags, bit_depth, path="cli") -> dict:
    """One timed 25-frame pass of python -m x265_tpu_torch.cli on the
    card (launch counts set to 0 just before it and read just after:
    the gather 4 times per P frame and the searches 2, all of the bit
    depth's instance), every MD5 SEI verified against the recon, then
    the CPU's first 2 frames under the same flags against the pass's
    (bytes and QPs). Prints fps, kb/s against the 3000 target, the QP
    range per frame type, VBV underflows, seconds per I and P frame and
    the SPS's profile and bit depths. Returns the record."""
    from x265_tpu_torch.cli import main as cli_main
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc.ratecontrol import RateControl
    reset_launches()
    with EncoderTimer() as timer:
        t0 = time.perf_counter()
        rc = cli_main([src, "-o", out + ".hevc", "--csv", out + ".csv",
                       "--recon", out + ".y4m", "--no-progress", *flags],
                      device="cuda")
        wall = time.perf_counter() - t0
    launches = read_launches()
    rows = csv_rows(out + ".csv")[1:]
    if rc != 0 or len(rows) != GOP:
        raise AssertionError(f"the 1080p {path} pass coded {len(rows)} "
                             f"frames")
    stream = open(out + ".hevc", "rb").read()
    n_hash = verify_hash_seis(stream, out + ".y4m", bit_depth)
    types = [r[1] for r in rows]
    n_p = types.count("P")
    u16 = bit_depth > 8
    want = {"gather_windows": 4 * n_p, "int_search": 2 * n_p,
            "int_search_pair": n_p}
    want_u16 = {"gather_windows": 4 * n_p if u16 else 0,
                "int_search_pair": n_p if u16 else 0,
                "int_search_single": n_p if u16 else 0}
    if not _want(launches, want) or launches["u16"] != want_u16:
        raise AssertionError(f"{path}: launches {launches}, want {want} "
                             f"with uint16 {want_u16}")
    sps = sps_fields(stream)
    if sps != {"profile_idc": 2 if u16 else 1, "bit_depth_luma": bit_depth,
               "bit_depth_chroma": bit_depth}:
        raise AssertionError(f"{path}: SPS {sps}")
    # card == CPU: the CPU's first 2 frames under the same flags
    t0 = time.perf_counter()
    leg = out + "_leg_cpu"
    if cli_main([src, "-o", leg + ".hevc", "--csv", leg + ".csv", "-f", "2",
                 "--no-progress", *flags], device="cpu") != 0:
        raise AssertionError(f"1080p {path} leg failed on the CPU")
    cpu_s = time.perf_counter() - t0
    cpu_stream, cpu_rows = open(leg + ".hevc", "rb").read(), \
        csv_rows(leg + ".csv")[1:]
    if stream[:len(cpu_stream)] != cpu_stream or cpu_rows != rows[:2] or \
            stream[len(cpu_stream):len(cpu_stream) + 4] != b"\0\0\0\1":
        raise AssertionError(f"1080p {path} leg: card != CPU (bytes or "
                             f"QPs)")
    print(json.dumps({"cli_card_equals_cpu": f"1080p {path} "
                      + " ".join(flags) + ", 1 I + 1 P",
                      "bytes": len(cpu_stream),
                      "qps": [r[2] for r in cpu_rows], "cpu_s": cpu_s}),
          flush=True)
    # the VBV buffer through the coded frames, as the CLI's controller
    # saw it (the CLI's settings after its level check)
    cfg = EncoderConfig(width=1920, height=1080, bitrate=3000,
                        rc_mode="abr", vbv_bufsize=6000, vbv_maxrate=3000,
                        bit_depth=bit_depth)
    cfg.enforce_level()
    vbv = RateControl(cfg)
    for r in rows:
        vbv.frame_done(int(r[3]), int(r[2]), 1.0, r[1] == "I")
    qps = {t: [int(r[2]) for r in rows if r[1] == t] for t in ("I", "P")}
    kbps = len(stream) * 8 * 25 / GOP / 1000
    rec = {
        "path": path, "clip": f"1080p {bit_depth}-bit y4m, 25 frames, "
        "python -m x265_tpu_torch.cli " + " ".join(flags),
        "frames": len(rows), "frame_types": "".join(types),
        "bytes": len(stream), "wall_s": wall, "fps": GOP / wall,
        "kbps": kbps, "kbps_target": 3000, "kbps_over_target": kbps / 3000,
        "qp_range": {t: [min(q), max(q)] for t, q in qps.items() if q},
        "qps": [int(r[2]) for r in rows],
        "vbv_underflows": vbv.vbv_underflows,
        "i_frame_s_each": sum(timer.secs["I"]) / max(len(timer.secs["I"]), 1),
        "p_frame_s": sum(timer.secs["P"]) / max(n_p, 1),
        "host_rest_s_per_frame": (wall - sum(timer.secs["I"]) -
                                  sum(timer.secs["P"])) / GOP,
        "md5_seis_verified": n_hash, "sps": sps, "launches": launches,
        "psnr_y_mean": float(np.mean([float(r[4]) for r in rows]))}
    rec["kbps_within_5pct"] = abs(kbps / 3000 - 1) <= 0.05
    print(json.dumps(rec), flush=True)
    return rec


def phase_cli(workdir):
    """The CLI at 1080p: the 64x96 legs card == CPU; one timed pass of
    the bench clip (25 frames as y4m) with --preset medium --tune
    zerolatency under ABR 3000 kb/s + VBV, hash SEIs verified, launch
    counts set to 0 just before it and read just after; a card == CPU
    leg of 1 I + 1 P: the CPU's 2-frame encode against the timed pass's
    first 2 frames (rate control is causal, and the CLI writes each
    frame as it is coded, so those are the card's 2-frame encode):
    bytes and QPs; scale_frame 1080p -> 1280x720 card == CPU with its
    device time. Returns the launches."""
    from x265_tpu_torch.ops.scaler import scale_frame, scale_plane_t
    phase_cli_card_equals_cpu(workdir)
    frames = [synth_1080p(i % 3, shift=2 * i) for i in range(GOP)]
    src = write_y4m(f"{workdir}/bench.y4m", frames)
    run = cli_pass(src, f"{workdir}/cli_1080p", CLI_1080P, 8)
    launches = run["launches"]
    # the scaler: 1080p -> 1280x720 on the card against the CPU
    card = scale_frame(frames[0], 1280, 720, device="cuda")
    cpu = scale_frame(frames[0], 1280, 720, device="cpu")
    if any(not np.array_equal(a, b) for a, b in zip(card, cpu)):
        raise AssertionError("scale_frame: card != CPU")
    planes = [torch.from_numpy(p.astype(np.int32)).cuda() for p in frames[0]]

    def scale_all():
        scale_plane_t(planes[0], 720, 1280)
        scale_plane_t(planes[1], 360, 640)
        scale_plane_t(planes[2], 360, 640)

    scale_all()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        scale_all()
    stop.record()
    torch.cuda.synchronize()
    print(json.dumps({"scale_frame": "1080p -> 1280x720, card == CPU",
                      "ms_per_frame": start.elapsed_time(stop) / 10,
                      "ms_of": "CUDA events around 10 calls of the three "
                      "planes, their tap-index uploads included"}),
          flush=True)
    return launches


# --- Main10: 10-bit planes end to end -------------------------------------

def main10_config(h, w, preset=None, tune=None, **kw):
    """A 10-bit configuration at QP 32 with a preset (and tune), SAO off
    (ROADMAP item 31: the reference codes 10-bit SAO offsets with the
    8-bit cMax), then the keyword overrides."""
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=QP, bit_depth=10)
    if preset:
        cfg.apply_preset(preset)
    if tune:
        cfg.apply_tune(tune)
    cfg.sao = False
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def fade10(n, h=64, w=96):
    """synth10_clip's first frame panning and fading (weightp finds
    weights): frame i at (10 - i) / 10 of its brightness."""
    y, cb, cr = synth10_clip(1, h, w)[0]
    return [(y, cb, cr)] + [
        ((np.roll(y, 2 * i, axis=1).astype(np.int32) * (10 - i) // 10)
         .astype(np.uint16), cb, cr) for i in range(1, n)]


def phase_main10_card_equals_cpu(workdir):
    """The Main10 legs (tests/test_torch_main10.py's configurations on
    64x96 and 72x128 clips), card against CPU, byte-identical: the I
    frame at CTU 32; an IPPP weightp sequence with the MD5 SEI;
    --preset slow --tune zerolatency --no-sao (CTU 64, 4 references,
    RDOQ) 1 I + 3 P in one chunk, whose I frame is the CTU-64
    wavefront; a --preset fast --no-sao hierarchical-B mini-GOP;
    encode_sequence with aq-mode 2 + cuTree (the host-recon I frame);
    and the CLI on a 420p10 y4m with the HDR10 flags and --hash 1
    (bytes and csv rows)."""
    from x265_tpu_torch.enc import IntraEncoder

    def enc(cfg, device):
        return IntraEncoder(cfg, device=device)

    legs = (
        ("I frame CTU 32 64x96", synth10_clip(1, 64, 96),
         lambda fr, d: [enc(main10_config(64, 96), d).encode_frame(*fr[0])]),
        ("weightp IPPP encode_sequence hash 64x96 1I+3P", fade10(4),
         lambda fr, d: enc(main10_config(64, 96, hash_sei=1),
                           d).encode_sequence(fr)),
        ("slow/zerolatency no-sao 72x128 1I+3P chunk 3",
         synth10_clip(4, 72, 128),
         lambda fr, d: encode_ippp(fr, d, main10_config(
             72, 128, "slow", "zerolatency"), chunk=3, need_recon=True)),
        ("fast no-sao 64x96 encode_hier_gop 1I+4", synth10_clip(5, 64, 96),
         lambda fr, d: enc(main10_config(64, 96, "fast"),
                           d).encode_hier_gop(fr)),
        ("aq2 + cutree encode_sequence 64x96 1I+2P",
         synth10_clip(3, 64, 96, seed=5),
         lambda fr, d: enc(main10_config(64, 96, aq_mode=2, cutree=True,
                                         deblock=True),
                           d).encode_sequence(fr)))
    for tag, frames, run in legs:
        t0 = time.perf_counter()
        gpu = run(frames, "cuda")
        t1 = time.perf_counter()
        cpu = run(frames, "cpu")
        t2 = time.perf_counter()
        if len(gpu) != len(cpu) or any(
                a.bitstream != b.bitstream for a, b in zip(gpu, cpu)):
            raise AssertionError(f"Main10 card != CPU at {tag}")
        keep_for_decode(f"Main10 {tag}", gpu)
        print(json.dumps({"main10_card_equals_cpu": tag,
                          "frame_types": "".join(r.ftype for r in gpu),
                          "bytes": sum(len(r.bitstream) for r in gpu),
                          "card_s": t1 - t0, "cpu_s": t2 - t1}), flush=True)
        if "B" in tag and not any(r.ftype == "B" for r in gpu):
            raise AssertionError(f"{tag}: no B frame")
    from x265_tpu_torch.cli import main as cli_main
    src = write_y4m(f"{workdir}/m10.y4m", fade10(3), bit_depth=10)
    outs = {}
    for device in ("cuda", "cpu"):
        out = f"{workdir}/m10_{device}"
        if cli_main([src, "-o", out + ".hevc", "--csv", out + ".csv",
                     "--recon", out + ".y4m", "--no-progress", *ZL_FAST,
                     "--qp", "30", "--hash", "1", *HDR10],
                    device=device) != 0:
            raise AssertionError(f"Main10 CLI leg failed on {device}")
        outs[device] = (open(out + ".hevc", "rb").read(),
                        csv_rows(out + ".csv"), open(out + ".y4m",
                                                     "rb").read())
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("Main10 CLI leg: card != CPU")
    n_hash = verify_hash_seis(outs["cuda"][0], f"{workdir}/m10_cuda.y4m", 10)
    keep_cli_for_decode("Main10 CLI 420p10 64x96 --hash 1 HDR10",
                        outs["cuda"][0], f"{workdir}/m10_cuda.y4m")
    print(json.dumps({"main10_card_equals_cpu": "CLI 420p10 y4m 64x96 "
                      "ultrafast/zerolatency --qp 30 --hash 1 HDR10, 3 "
                      "frames", "bytes": len(outs["cuda"][0]),
                      "md5_seis_verified": n_hash,
                      "sps": sps_fields(outs["cuda"][0])}), flush=True)


def phase_main10(workdir, elapsed_s=0.0):
    """Main10 at 1080p through the CLI: the card == CPU legs, then the
    bench clip lifted to 10 bits (synth10_1080p) as a 25-frame 420p10
    y4m through one timed pass of CLI_MAIN10 (cli_pass: the uint16
    gather 4 times and the uint16 searches 2 times per P frame, no
    uint8 instance; every MD5 SEI against the 10-bit recon; the SPS's
    Main10 profile and bit depth; kb/s within 5% of 3000 and no VBV
    underflow; the CPU's 1 I + 1 P against the pass's), whose stream
    starts decoding at once. elapsed_s: the run's seconds at the
    phase's start. Returns the launches."""
    t0 = time.perf_counter()
    phase_main10_card_equals_cpu(workdir)
    frames = [synth10_1080p(i) for i in range(GOP)]
    src = write_y4m(f"{workdir}/bench10.y4m", frames, bit_depth=10)
    del frames
    run = cli_pass(src, f"{workdir}/cli_main10", CLI_MAIN10, 10,
                   path="cli_main10")
    out = f"{workdir}/cli_main10"
    # its I frame and DECODE_MAIN10_P P frames, one fewer from each
    # DECODE_LATE_S mark the run has passed, decoded from now on
    late = sum(elapsed_s + time.perf_counter() - t0 > s
               for s in DECODE_LATE_S)
    DECODES.main10_p = max(DECODE_MAIN10_P - late, 0)
    keep_cli_for_decode("cli_main10 1080p", open(out + ".hevc", "rb").read(),
                        out + ".y4m", frames=1 + DECODES.main10_p, early=True)
    DECODES.start()
    return run["launches"]


# --- decode: the port's validation decoder on the card's own streams -------

SMALL_AREA = 72 * 128        # legs up to this size are decoded whole
DECODE_MAIN10_P = 1          # P frames of the Main10 1080p pass decoded
DECODE_LATE_S = (950,)       # elapsed s from which one fewer each
DECODE_JOBS = 4              # decoding processes
SLICE_NALS = (0, 1, 19, 20, 21)   # TRAIL_N, TRAIL_R, IDR_W_RADL, IDR_N_LP,
#                                   CRA: one picture each


class Decodes:
    """The card streams kept for the decode phase, each (tag, stream,
    [(poc, y, cb, cr)] in decode order, frame types), and the phase's
    processes: one spawned pool of DECODE_JOBS. The 1080p streams are
    decoded early, each in a job of its own from start(): the bench
    leg's and the host B path's once phase 3's CPU halves are done
    (before any timed pass), the Main10 pass's right after it (phase 12
    runs before the CLI phase), so that none of their minutes ends the
    run."""

    def __init__(self) -> None:
        self.kept = []
        self.waiting = []        # early streams not started yet
        self.early = []          # AsyncResults of the early streams
        self.pool = None
        self.main10_p = None     # P frames of the Main10 pass decoded

    def keep(self, item, early=False) -> None:
        (self.waiting if early else self.kept).append(item)

    def start(self) -> None:
        """Start decoding the early streams kept so far."""
        if self.pool is None:
            import multiprocessing
            self.pool = multiprocessing.get_context("spawn").Pool(
                DECODE_JOBS)
        self.early.extend(self.pool.apply_async(decode_job, ([item],))
                          for item in self.waiting)
        self.waiting = []


DECODES = Decodes()


def _recon_planes(r):
    rec = r.recon if r.recon is not None else r.device_ref.to_recon()
    return rec.y, rec.cb, rec.cr


def keep_for_decode(tag, results, early=False) -> None:
    """Keep a leg's card stream (results in decode order) and its recon
    for phase_decode; early: to be decoded from the next DECODES.start()."""
    DECODES.keep((tag, b"".join(r.bitstream for r in results),
                  [(r.poc, *_recon_planes(r)) for r in results],
                  "".join(r.ftype for r in results)), early)


def first_pictures(stream: bytes, n: int) -> bytes:
    """The Annex-B units of a stream up to its n-th picture and that
    picture's suffix units."""
    from x265_tpu_torch.bitstream.nal import nal_header, split_annexb
    out, seen = [], 0
    for t, _, raw in split_annexb(stream):
        if int(t) in SLICE_NALS:
            seen += 1
            if seen > n:
                break
        out.append(b"\0\0\0\1" + nal_header(t) + raw)
    return b"".join(out)


def keep_cli_for_decode(tag, stream: bytes, recon_y4m, frames=None,
                        early=False) -> None:
    """Keep an IPPP CLI stream (decode order is display order, POC the
    frame index) with its --recon y4m, cut to its first `frames`
    pictures when given; early: to be decoded from the next
    DECODES.start()."""
    from x265_tpu_torch.io import Y4MReader
    recon = []
    for k, planes in enumerate(Y4MReader(str(recon_y4m))):
        if frames is not None and k >= frames:
            break
        recon.append((k, *planes))
    if frames is not None:
        stream = first_pictures(stream, frames)
    DECODES.keep((tag, stream, recon, "I" + "P" * (len(recon) - 1)), early)


def decode_job(items) -> list:
    """Decode each kept (tag, stream, recon, types) with
    x265_tpu_torch.decoder in this process (it verifies every picture
    hash SEI as it goes), each picture's slice timed, and hold every
    decoded frame, in decode order, to the card's recon: POC and
    planes. Raises on a mismatch. Returns one record per stream."""
    from x265_tpu_torch.bitstream.nal import split_annexb
    from x265_tpu_torch.decoder import decoder as dec
    records = []
    for tag, stream, recon, types in items:
        secs = []
        real = dec._decode_slice

        def timed(*a, **k):
            t = time.perf_counter()
            f = real(*a, **k)
            secs.append(time.perf_counter() - t)
            return f

        dec._decode_slice = timed
        try:
            t0 = time.perf_counter()
            frames = dec.decode_annexb(stream)
            wall = time.perf_counter() - t0
        finally:
            dec._decode_slice = real
        if len(frames) != len(recon):
            raise AssertionError(f"decode {tag}: {len(frames)} frames for "
                                 f"{len(recon)} recon pictures")
        for i, (f, (poc, y, cb, cr)) in enumerate(zip(frames, recon)):
            if f.poc != poc:
                raise AssertionError(f"decode {tag}: frame {i} has POC "
                                     f"{f.poc}, the card's {poc}")
            for k, want in zip(("y", "cb", "cr"), (y, cb, cr)):
                got = getattr(f, k)
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise AssertionError(f"decode {tag}: frame {i} {k} "
                                         f"differs from the card's recon")
        units = split_annexb(stream)
        sps = dec.parse_sps(next(rb for t, rb, _ in units if int(t) == 33))
        rec = {"decode": tag, "frames": len(frames), "frame_types": types,
               "bytes": len(stream), "size": list(frames[0].y.shape),
               "bit_depth": sps.bit_depth, "decode_s": wall,
               "decode_s_per_frame": wall / len(frames), "slice_s": secs,
               "equals_recon": True,
               "hash_seis_verified": sum(int(t) == 40 for t, _, _ in units)}
        for t in set(types):
            rec[f"{t}_frame_s"] = float(np.mean(
                [s for s, ft in zip(secs, types) if ft == t]))
        records.append(rec)
    return records


def phase_decode(elapsed_s: float) -> list:
    """Every kept card stream through the port's validation decoder
    (decode_job) in the Decodes pool: the small streams spread over its
    processes, beside the early 1080p streams still decoding. One line
    per stream, then this phase's wall seconds and the Main10 pass's
    P frames decoded and cut. Returns the records."""
    big = [it[0] for it in DECODES.kept if it[2][0][1].size > SMALL_AREA]
    if big or DECODES.waiting or len(DECODES.early) != 3:
        raise AssertionError(f"decode: want the bench leg's, the host B "
                             f"path's and the Main10 pass's 1080p streams "
                             f"decoding early, got {len(DECODES.early)} "
                             f"early, {len(DECODES.waiting)} not started, "
                             f"{big} kept")
    small = sorted(DECODES.kept, key=lambda it: -len(it[1]))
    jobs = [small[k::DECODE_JOBS] for k in range(DECODE_JOBS)]
    t0 = time.perf_counter()
    pool = DECODES.pool
    try:
        pending = [pool.apply_async(decode_job, (job,)) for job in jobs]
        done = [r.get() for r in DECODES.early + pending]
    finally:
        pool.close()
        pool.join()
    wall = time.perf_counter() - t0
    records = [r for job in done for r in job]
    for r in records:
        print(json.dumps(r), flush=True)
    print(json.dumps({"decode_phase_s": wall, "streams": len(records),
                      "frames": sum(r["frames"] for r in records),
                      "processes": DECODE_JOBS,
                      "decoded_early": [r["decode"] for job in
                                        done[:len(DECODES.early)]
                                        for r in job],
                      "cli_main10_p_frames_decoded": DECODES.main10_p,
                      "cli_main10_p_frames_cut":
                          DECODE_MAIN10_P - DECODES.main10_p,
                      "elapsed_at_start_s": elapsed_s}), flush=True)
    return records


def kernel_entries(launches, gather, search, me_windowed) -> list:
    """The kernels line's entries, one per kernel instance, from the
    launches of every path (read_launches), the gather and search
    phases' per-path numbers and phase_me_windowed's result."""
    # each kernel instance: its launches summed over the timed passes of
    # the paths that run it (uint8: the eight 8-bit paths and the 8-bit
    # me_size_windowed run; uint16: the Main10 CLI pass and the 10-bit
    # me_size_windowed run), by path; its times and bound per P frame at
    # the shapes of one path (ms_of: the bench path for uint8, the
    # Main10 path for uint16), the 8- and 16-block searches' per call of
    # the me_size_windowed run
    u16_paths = ("cli_main10", "me_windowed_10")
    u8_paths = [p for p in launches if p not in u16_paths]

    def counts(path):
        n, u16 = launches[path], launches[path]["u16"]
        pair = n["int_search_pair"]
        sn, sn16 = n["int_search_single_n"], n["int_search_single_n_u16"]
        return {"gather_windows_u8": n["gather_windows"] -
                u16["gather_windows"],
                "gather_windows_u16": u16["gather_windows"],
                "int_search_pair_u8": pair - u16["int_search_pair"],
                "int_search_u8": sn[32] - sn16[32],
                "int_search_pair_u16": u16["int_search_pair"],
                "int_search_u16": sn16[32],
                **{f"int_search_n{k}_{dt}": sn16[k] if dt == "u16"
                   else sn[k] - sn16[k]
                   for k in (8, 16) for dt in ("u8", "u16")}}

    by_path = {path: counts(path) for path in launches}
    entries = []
    for name, src, replaces, path, nums, bound_by, lib, err in (
            ("gather_windows_u8", "gather_windows", ":80", "bench",
             gather["bench"], "bytes", gather["bench"]["library_ms"],
             max(g["max_abs_err"] for g in gather.values())),
            ("gather_windows_u16", "gather_windows", ":80", "cli_main10",
             gather["cli_main10"], "bytes",
             gather["cli_main10"]["library_ms"],
             gather["cli_main10"]["max_abs_err"]),
            *((f"{inst}_{dt}", "int_search", ":308,350",
               "bench" if dt == "u8" else "cli_main10",
               search["bench" if dt == "u8" else "cli_main10"]["by"][shape],
               None, None,
               search["bench" if dt == "u8" else "cli_main10"]["by"][
                   f"{shape}_max_abs_err"])
              for dt in ("u8", "u16")
              for inst, shape in (("int_search_pair",
                                   "pair_16region_8block"),
                                  ("int_search", "single_32block")))):
        paths = u8_paths if name.endswith("u8") else list(u16_paths)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"x265_tpu_torch/csrc/{src}.cu",
            "replaces": f"x265_tpu/ops/me_win.py{replaces}",
            "launches": sum(by_path[p][name] for p in paths),
            "launches_by_path": {p: by_path[p][name] for p in paths},
            "ms_of": f"{path} path, per P frame", "max_abs_err": err,
            "ms": nums["ms"], "plain_ms": nums["plain_ms"],
            "bound_ms": nums["bound_ms"],
            "bound_by": bound_by or nums["bound_by"], "library_ms": lib})
    for bits, dt in ((8, "u8"), (10, "u16")):
        for k in (8, 16):
            c = next(c for c in me_windowed[bits]["calls"]
                     if c["kernel"] == f"int_search_{dt}" and c["n"] == k)
            name = f"int_search_n{k}_{dt}"
            paths = u8_paths if dt == "u8" else list(u16_paths)
            entries.append({
                "name": name, "route": "cuda",
                "source": "x265_tpu_torch/csrc/int_search.cu",
                "replaces": "x265_tpu/ops/me_win.py:308",
                "launches": sum(by_path[p][name] for p in paths),
                "launches_by_path": {p: by_path[p][name] for p in paths},
                "ms_of": f"me_windowed path at 1080p, per call (side "
                         f"{c['side']}, lead {c['lead']}, {c['units']} "
                         f"blocks)",
                "max_abs_err": me_windowed[bits]["max_abs_err"],
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None, "geometry": c["geometry"]})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        log("CUDA is not available: this script runs on a GPU only")
        return 1
    from x265_tpu_torch import kernels
    from x265_tpu_torch.native.entropy_native import get_lib

    card = card_line()
    digests = RefDigests()
    t0 = time.perf_counter()
    phase_s, last = {}, [t0]
    cpu_legs = CpuLegs()

    def done(phase):
        """Record the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[phase] = phase_s.get(phase, 0.0) + now - last[0]
        last[0] = now

    nvcc_s = kernels.build(kernels.sources())
    t1 = time.perf_counter()
    get_lib()
    gxx_s = time.perf_counter() - t1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": card, "kernels": kernels.sources(),
                      "nvcc_s": nvcc_s, "native_cabac_s": gxx_s,
                      "build_s": time.perf_counter() - t0}), flush=True)
    walks = print_build_report(kernels)
    check_main_path_sass(kernels)
    done("build")

    rates = phase_int_rates()
    gather = {"bench": phase_gather(SHAPES),
              "fast": phase_gather(FAST_SHAPES, (torch.uint8,)),
              "medium": phase_gather(MEDIUM_SHAPES, (torch.uint8,)),
              "fast_b": phase_gather(FAST_B_SHAPES, (torch.uint8,)),
              "slow": phase_gather(SLOW_SHAPES, (torch.uint8,)),
              "placebo": phase_gather(PLACEBO_SHAPES, (torch.uint8,),
                                      timing=False)}
    search = phase_search()
    # the Main10 path (the CLI cell at 10 bits, medium/zerolatency):
    # the uint16 gather at its shapes, the uint16 searches
    gather["cli_main10"] = phase_gather(MEDIUM_SHAPES, (torch.uint16,),
                                        agg_dtype=torch.uint16)
    search.update(phase_search(10, rates["sad16_max_imad"],
                               RATE_SAMPLES["sad16_max_imad"],
                               "sad16_max_imad"))
    search["cli_main10"] = search.pop("main10")
    log("kernel == plain at every main-path shape")
    done("kernels")
    me_windowed = phase_me_windowed(rates, walks)
    log("me_size_windowed at 1080p: kernel path == plain path, pred == MC")
    done("me_windowed")
    cards = phase_card_halves()
    log("card == CPU: the card halves ran")
    done("card_halves")
    # phase 3's CPU halves are still running: the host B path and the
    # chains run on the card meanwhile
    phase_host_b_card_equals_cpu()
    log("host B path: card == CPU")
    phase_host_b_1080p()
    log("host B path at 1080p ran")
    done("host_b")
    launches = {f"me_windowed_{bits}": me_windowed[bits]["launches"]
                for bits in (8, 10)}
    phase_chains_card_equals_cpu()
    log("chains: card == CPU")
    launches["chains"] = phase_chains_1080p(
        next(gpu for tag, _, gpu, _ in cards if tag == BENCH_LEG)[0]
        .device_ref if CARD_CPU_SIZE == (1080, 1920) else None)
    log(f"chains at 1080p ran, launches {launches['chains']}")
    phase_b_fan_out()
    log("B fan-out == the single-device batch")
    done("chains_and_fan_out")
    legs = phase_card_equals_cpu(cards, cpu_legs)
    DECODES.start()
    log("card == CPU")
    done("card_equals_cpu")
    for path, make_cfg, first in (
            ("bench", bench_config,
             legs[BENCH_LEG] if CARD_CPU_SIZE == (1080, 1920) else []),
            ("fast", fast_config, legs["fast/zerolatency 1080x1920 1I+1P"]),
            ("medium", medium_config,
             legs["medium/zerolatency 1080x1920 1I+1P"]),
            ("slow", slow_config, legs["slow/zerolatency 1080x1920 1I+1P"])):
        launches[path], frames, i_ref = phase_path(path, make_cfg, first,
                                                   digests)
        log(f"{path} path ran, launches {launches[path]}")
        done(f"{path}_path")
        phase_profile(frames, make_cfg(1080, 1920), path, i_ref=i_ref)
        done(f"{path}_profile")
    phase_rdoq(frames, i_ref)
    done("rdoq")
    first = phase_b_card_equals_cpu()
    log("B path: card == CPU")
    done("b_card_equals_cpu")
    launches["fast_b"], frames = phase_b_path(first, digests)
    log(f"fast_b path ran, launches {launches['fast_b']}")
    done("fast_b_path")
    phase_b_profile(frames)
    done("fast_b_profile")
    first = phase_dqp_card_equals_cpu()
    log("dQP legs: card == CPU")
    done("dqp_card_equals_cpu")
    launches["aq_cutree"] = phase_aq_cutree(first, digests)
    log(f"aq_cutree path ran, launches {launches['aq_cutree']}")
    done("aq_cutree_path_and_profile")
    # Main10 before the CLI phase, so that its stream decodes meanwhile
    with tempfile.TemporaryDirectory() as workdir:
        launches["cli_main10"] = phase_main10(workdir,
                                              time.perf_counter() - t0)
    log(f"cli_main10 ran, launches {launches['cli_main10']}")
    done("main10")
    with tempfile.TemporaryDirectory() as workdir:
        launches["cli"] = phase_cli(workdir)
    log(f"cli ran, launches {launches['cli']}")
    done("cli")
    phase_decode(time.perf_counter() - t0)
    log("decode: every kept card stream decodes to its recon")
    done("decode")
    digests.finish()
    log(f"card == reference: legs {sorted(digests.checked)}")
    print(json.dumps({"phase_seconds": phase_s,
                      "total_s": time.perf_counter() - t0}), flush=True)

    # per path, each kernel's per-P-frame numbers at that path's shapes
    # (the B path's searches have the fast path's shapes: side 11; the
    # aq_cutree path has the medium path's shapes)
    search["fast_b"] = search["fast"]
    for path in ("aq_cutree", "cli"):
        gather[path], search[path] = gather["medium"], search["medium"]
    gather["chains"], search["chains"] = gather["bench"], search["bench"]
    print(json.dumps({"kernels_per_path": {
        path: {"gather_windows": {**{k: gather[path][k] for k in
                                     ("ms", "plain_ms", "library_ms",
                                      "bound_ms")},
                                  "launches": launches[path][
                                      "gather_windows"]},
               "int_search": {**{k: search[path][k] for k in
                                 ("ms", "plain_ms", "bound_ms", "bound_by")},
                              "launches": launches[path]["int_search"]}}
        for path in launches if path in gather}}), flush=True)
    print(json.dumps({"kernels": kernel_entries(launches, gather, search,
                                                 me_windowed)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
