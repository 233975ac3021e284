#!/usr/bin/env python3
"""Smoke run of the GPU port on one NVIDIA card: python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. setup: require CUDA, print the card's name and power limit, build
     every CUDA kernel (one nvcc per source, all started together) and
     the native CABAC coder;
  2. kernel vs plain: the window-gather kernel against its plain PyTorch
     version at the four main-path window shapes, uint8 and uint16,
     exact equality, timed beside a one-call PyTorch indexing yardstick
     and its memory bound;
  3. card == CPU: the same clips encoded on the card and on the CPU give
     byte-identical streams (64x96 1 I + 6 P, then I + 1 P at the size
     in CARD_CPU_SIZE);
  4. the main path at full size: 1080p, 1 I (QP 29) + 24 P (CQP 32),
     pipelined chunks of 8, one warm-up pass, one timed pass; the kernel
     must have launched 4 times per P frame in the timed pass;
  5. one torch.profiler trace of a P chunk: the ten device ops that
     take the most time;
  6. the kernels line (one JSON object), the card line, and the last
     line {"ok": true, "device": {...}}.
Imports neither JAX nor the x265_tpu reference package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

GOP = 25                     # 1 I + 24 P, the bench clip
CHUNK = 8
QP = 32
CARD_CPU_SIZE = (1080, 1920)  # (h, w) of the I + 1 P card-vs-CPU leg
BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak

# the four gathers of one P frame at 1080p (coded 1080, scan 1088) and
# me_range 10: (name, plane rows, plane cols, window, windows per frame)
SHAPES = (
    ("luma_16region_44", 1088 + 56, 1920 + 56, 44, 8160),
    ("luma_32block_60", 1088 + 56, 1920 + 56, 60, 2040),
    ("chroma_16region_22", 2 * (544 + 36), 960 + 36, 22, 2 * 8160),
    ("chroma_32block_30", 2 * (544 + 36), 960 + 36, 30, 2 * 2040),
)


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def encode_ippp(frames, device, timing=None):
    """The main path through its user entry points: I frame at QP-3 on
    the device recon, then pipelined P chunks. Returns the results;
    `timing`, when a dict, receives the I frame's and the P frames'
    wall seconds (the device is synchronized between them)."""
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc import IntraEncoder
    h, w = frames[0][0].shape
    cfg = EncoderConfig(width=w, height=h, qp=QP, deblock=True, sao=False)
    enc = IntraEncoder(cfg, device=device)
    t0 = time.perf_counter()
    r0 = enc.encode_frame(*frames[0], qp=cfg.qp - 3, use_device_recon=True,
                          need_recon=False)
    if timing is not None:
        torch.cuda.synchronize()
        timing["i_frame_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc.ref = r0.device_ref
    enc.poc = 0
    rs = enc.encode_pgop_pipelined(frames[1:], chunk=CHUNK)
    if timing is not None:
        torch.cuda.synchronize()
        timing["p_frames_s"] = time.perf_counter() - t0
    return [r0] + rs


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


def phase_kernels():
    """Kernel vs plain at the main-path shapes; returns the per-frame
    aggregate numbers for the kernels line."""
    from x265_tpu_torch.ops.me_win import gather_windows, \
        gather_windows_plain
    rng = np.random.default_rng(2024)
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0}
    for name, hh, ww, win, nb in SHAPES:
        for dt in (torch.uint8, torch.uint16):
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
            # one PyTorch indexing call on precomputed index grids
            ar = torch.arange(win, device="cuda")
            yy = (ys_t.long()[:, None] + ar)[:, :, None]
            xx = (xs_t.long()[:, None] + ar)[:, None, :]
            src_i = src.view(torch.int16) if dt == torch.uint16 else src
            ms = cuda_time(lambda: gather_windows(src, ys_t, xs_t, win))
            plain_ms = cuda_time(
                lambda: gather_windows_plain(src, ys_t, xs_t, win))
            lib_ms = cuda_time(lambda: src_i[yy, xx])
            nbytes = src.numel() * src.element_size() + 8 * nb + \
                got.numel() * got.element_size()
            bound_ms = nbytes / BYTES_PER_S * 1e3
            rec = {"shape": name, "dtype": str(dt).replace("torch.", ""),
                   "windows": nb, "win": win, "kernel_ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bytes": nbytes,
                   "max_abs_err": err, "launches_per_p_frame": 1}
            print(json.dumps(rec), flush=True)
            if dt == torch.uint8:      # the main path's dtype
                agg["ms"] += ms
                agg["plain_ms"] += plain_ms
                agg["library_ms"] += lib_ms
                agg["bound_ms"] += bound_ms
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
    return agg


def phase_card_equals_cpu():
    for tag, frames in (("64x96 1I+6P", small_clip(7)),
                        (f"{CARD_CPU_SIZE[0]}x{CARD_CPU_SIZE[1]} 1I+1P",
                         [tuple(p[:CARD_CPU_SIZE[0] // (1 if k == 0 else 2),
                                  :CARD_CPU_SIZE[1] // (1 if k == 0 else 2)]
                                for k, p in enumerate(synth_1080p(i, 2 * i)))
                          for i in range(2)])):
        t0 = time.perf_counter()
        gpu = encode_ippp(frames, "cuda")
        t1 = time.perf_counter()
        cpu = encode_ippp(frames, "cpu")
        t2 = time.perf_counter()
        for i, (a, b) in enumerate(zip(gpu, cpu)):
            if a.bitstream != b.bitstream:
                raise AssertionError(f"card != CPU at {tag}, frame {i}")
        print(json.dumps({"card_equals_cpu": tag, "frames": len(gpu),
                          "bytes": sum(len(r.bitstream) for r in gpu),
                          "card_s": t1 - t0, "cpu_s": t2 - t1}), flush=True)
    return gpu


def phase_main_path(first_two):
    from x265_tpu_torch.ops.me_win import gather_windows
    frames = [synth_1080p(i % 3, shift=2 * i) for i in range(GOP)]
    t0 = time.perf_counter()
    warm = encode_ippp(frames, "cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    gather_windows.launches = 0
    split = {}
    t0 = time.perf_counter()
    res = encode_ippp(frames, "cuda", timing=split)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gather_windows.launches
    if launches != 4 * (GOP - 1):
        raise AssertionError(f"gather kernel launched {launches} times in "
                             f"the timed pass, want {4 * (GOP - 1)}")
    if len(res) != GOP or any(len(r.bitstream) == 0 for r in res):
        raise AssertionError("main path produced missing frames")
    if any(a.bitstream != b.bitstream for a, b in zip(res, warm)):
        raise AssertionError("two passes over one clip differ")
    if CARD_CPU_SIZE == (1080, 1920) and \
            [r.bitstream for r in res[:2]] != first_two:
        raise AssertionError("full-size clip's first frames differ from "
                             "the card-vs-CPU leg")
    nbytes = sum(len(r.bitstream) for r in res)
    print(json.dumps({"main_path": "1080p IPPP CQP32 1I+24P chunk 8",
                      "frames": len(res), "bytes": nbytes,
                      "i_frame_bytes": len(res[0].bitstream),
                      "warmup_s": warm_s, "wall_s": wall,
                      "fps": GOP / wall, **split,
                      "p_frame_s": split["p_frames_s"] / (GOP - 1),
                      "gather_launches": launches}),
          flush=True)
    return launches, frames


def phase_profile(frames):
    """torch.profiler over one P chunk: the ten device ops that take the
    most time, and the chunk's device-busy share."""
    from torch.profiler import ProfilerActivity, profile
    from x265_tpu_torch.common.params import EncoderConfig
    from x265_tpu_torch.enc import IntraEncoder
    cfg = EncoderConfig(width=1920, height=1080, qp=QP, deblock=True)
    enc = IntraEncoder(cfg, device="cuda")
    r0 = enc.encode_frame(*frames[0], qp=QP - 3, need_recon=False)
    enc.ref = r0.device_ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enc.encode_pgop(frames[1:1 + CHUNK], need_recon=False)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def self_dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    ev = prof.key_averages()

    kernels = sorted((e for e in ev if self_dev_us(e) > 0),
                     key=self_dev_us, reverse=True)
    busy_ms = sum(self_dev_us(e) for e in kernels) / 1e3
    print(json.dumps({"profile": f"one P chunk of {CHUNK} at 1080p",
                      "wall_ms_profiled": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / wall_ms}), flush=True)
    for e in kernels[:10]:
        print(json.dumps({"top_device_op": e.key[:120],
                          "self_device_ms": self_dev_us(e) / 1e3,
                          "calls": e.count}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        log("CUDA is not available: this script runs on a GPU only")
        return 1
    from x265_tpu_torch import kernels
    from x265_tpu_torch.native.entropy_native import get_lib

    card = card_line()
    t0 = time.perf_counter()
    nvcc_s = kernels.build(kernels.sources())
    t1 = time.perf_counter()
    get_lib()
    gxx_s = time.perf_counter() - t1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": card, "kernels": kernels.sources(),
                      "nvcc_s": nvcc_s, "native_cabac_s": gxx_s,
                      "build_s": time.perf_counter() - t0}), flush=True)

    agg = phase_kernels()
    log("kernel == plain at every main-path shape")
    gpu_small = phase_card_equals_cpu()
    log("card == CPU")
    launches, frames = phase_main_path([r.bitstream for r in gpu_small])
    log(f"main path ran, {launches} gather launches")
    phase_profile(frames)

    print(json.dumps({"kernels": [{
        "name": "gather_windows", "route": "cuda",
        "source": "x265_tpu_torch/csrc/gather_windows.cu",
        "replaces": "x265_tpu/ops/me_win.py:80",
        "launches": launches, "max_abs_err": agg["max_abs_err"],
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": "bytes",
        "library_ms": agg["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
