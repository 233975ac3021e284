#!/usr/bin/env python3
"""The GPU port against the JAX reference on the CPU, frame for frame:

    python3 tools/port_vs_ref.py [--size HxW] [--bits 8|10]
        [--legs bench,fast,medium,slow,placebo,fast_b,aq_cutree]

Encodes the first frames of chip_smoke.py's bench clip (cropped to
--size, default 1080x1920) with x265_tpu and with x265_tpu_torch, both on
the CPU, in seven legs: 1 I + 2 P in the bench configuration and under
--preset fast|medium|slow|placebo --tune zerolatency (slow: RDOQ and 4
references; placebo: RDOQ, 5 references, merge 5, me_range 12), 1 I +
one mini-GOP of 4 under --preset fast (B frames), and encode_sequence
over 1 I + 2 P under --preset medium --tune zerolatency with aq-mode 2
and cuTree (aq_cutree: the device lookahead's per-CTU QP maps, the
host-recon I frame, dQP P frames). For each frame it diffs the bytes,
every syntax field and the 8x8 inter leaf cost inter_c8 of every P and
B frame (read from both packages' _rd_depth_decision as they run), and
in the aq_cutree leg the lookahead's QP maps entry by entry. Prints
one JSON line per leg (differing frames, bytes, syntax fields, QP-map
entries and inter_c8 cells, seconds) and exits 1 if any leg differs.
--bits 10 runs the same legs on the clip lifted to 10 bits as
chip_smoke.synth10_1080p lifts it (chip_smoke.to_10bit) and with SAO
off, which neither package codes at 10 bits (ROADMAP item 31). Needs
JAX: run it where the reference runs, not on
the GPU machine. The reference traces its programs anew for each size
and configuration (minutes each at 1080p, and tens of GiB of host
memory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

LEGS = ("bench", "fast", "medium", "slow", "placebo", "fast_b",
        "aq_cutree")


def _config(leg, h, w, RefConfig, bits=8):
    if leg == "bench":
        return RefConfig(width=w, height=h, qp=32, deblock=True, sao=False,
                         me_range=10, bit_depth=bits)
    cfg = RefConfig(width=w, height=h, qp=32, bit_depth=bits)
    cfg.apply_preset({"fast_b": "fast", "aq_cutree": "medium"}.get(leg, leg))
    if leg != "fast_b":
        cfg.apply_tune("zerolatency")
    if leg == "aq_cutree":
        cfg.aq_mode, cfg.cutree = 2, True
    if bits > 8:
        cfg.sao = False
    return cfg


def _record_inter_c8(ref_pgop, port_pgop):
    """Wrap both packages' _rd_depth_decision so every call appends its
    inter_c8 plane, the reference's through a host callback from inside
    its jitted scan. The B modules bind the wrapped function: they are
    imported at their first use, after this. Returns (ref list, port
    list)."""
    import jax
    got_ref, got_port = [], []
    ref_fn, port_fn = ref_pgop._rd_depth_decision, port_pgop._rd_depth_decision

    def ref_wrap(*a, **k):
        out = ref_fn(*a, **k)
        jax.debug.callback(lambda c: got_ref.append(np.asarray(c)), out[4])
        return out

    def port_wrap(*a, **k):
        out = port_fn(*a, **k)
        got_port.append(out[4].cpu().numpy())
        return out

    ref_pgop._rd_depth_decision = ref_wrap
    port_pgop._rd_depth_decision = port_wrap
    return got_ref, got_port


def _fields(syn):
    return {k: v for k, v in vars(syn).items() if v is not None}


def _differs(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) != len(b) or any(_differs(x, y) for x, y in zip(a, b))
    return not np.array_equal(np.asarray(a), np.asarray(b))


def run_leg(leg, h, w, bits=8):
    import chip_smoke
    from x265_tpu.common.params import EncoderConfig as RefConfig
    from x265_tpu.enc import IntraEncoder as RefEncoder
    from x265_tpu_torch.convert import config_from_dict
    from x265_tpu_torch.enc import IntraEncoder
    frames = chip_smoke.full_size_clip(5 if leg == "fast_b" else 3, (h, w))
    if bits > 8:
        # frame i of the bench clip is synth_1080p(i % 3, shift=2 i)
        frames = [chip_smoke.to_10bit(f, i % 3, shift=2 * i)
                  for i, f in enumerate(frames)]
    rcfg = _config(leg, h, w, RefConfig, bits)
    out, maps = {}, {}
    for side, enc in (("ref", RefEncoder(rcfg)),
                      ("port", IntraEncoder(config_from_dict(
                          dataclasses.asdict(rcfg)), device="cpu"))):
        t0 = time.perf_counter()
        if leg == "aq_cutree":
            maps[side] = enc.lookahead_qp_maps(frames)
            out[side] = (enc.encode_sequence(frames),
                         time.perf_counter() - t0)
            continue
        r0 = enc.encode_frame(*frames[0], qp=rcfg.qp - 3,
                              use_device_recon=True)
        enc.ref = r0.device_ref
        enc.poc = 0
        if leg == "fast_b":
            rs = enc.encode_minigop(frames[1:], qp=rcfg.qp)
        else:
            rs = enc.encode_pgop(frames[1:], qp=rcfg.qp)
        out[side] = ([r0] + rs, time.perf_counter() - t0)
    (ref, ref_s), (port, port_s) = out["ref"], out["port"]
    frames_differ, fields_differ = [], []
    for i, (a, b) in enumerate(zip(ref, port)):
        if a.bitstream != b.bitstream:
            frames_differ.append(i)
        fa, fb = _fields(a.syntax), _fields(b.syntax)
        for k in sorted(set(fa) | set(fb)):
            if (k in fa) != (k in fb) or _differs(fa[k], fb[k]):
                fields_differ.append(f"frame {i} ({a.ftype} POC {a.poc}) {k}")
    qp_maps = {}
    if maps:
        qp_maps = {"qp_map_entries": int(maps["port"].size),
                   "qp_map_entries_differ": int(
                       (maps["ref"] != maps["port"]).sum()),
                   "qp_map_min_max": [int(maps["port"].min()),
                                      int(maps["port"].max())]}
    return {"leg": leg, "size": f"{h}x{w}", "bits": bits,
            "frames": len(ref), **qp_maps,
            "ref_bytes": sum(len(r.bitstream) for r in ref),
            "port_bytes": sum(len(r.bitstream) for r in port),
            "frames_differ": frames_differ,
            "bytes_differ": sum(sum(x != y for x, y in zip(a.bitstream,
                                                           b.bitstream)) +
                                abs(len(a.bitstream) - len(b.bitstream))
                                for a, b in zip(ref, port)),
            "fields_differ": fields_differ, "ref_s": ref_s, "port_s": port_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--bits", type=int, choices=(8, 10), default=8)
    args = ap.parse_args()
    h, w = (int(v) for v in args.size.split("x"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    from x265_tpu.enc import pgop_tpu as ref_pgop
    from x265_tpu_torch.enc import pgop_gpu as port_pgop
    ok = True
    c8_ref, c8_port = _record_inter_c8(ref_pgop, port_pgop)
    for leg in args.legs.split(","):
        c8_ref.clear()
        c8_port.clear()
        t0 = time.perf_counter()
        rec = run_leg(leg, h, w, args.bits)
        jax.effects_barrier()
        cells = [int((np.asarray(a, np.float32).view(np.int32) !=
                      np.asarray(b, np.float32).view(np.int32)).sum())
                 for a, b in zip(c8_ref, c8_port)]
        rec.update(inter_c8_planes=(len(c8_ref), len(c8_port)),
                   inter_c8_cells=int(sum(np.asarray(a).size
                                          for a in c8_port)),
                   inter_c8_cells_differ=sum(cells),
                   seconds=time.perf_counter() - t0)
        ok &= not (rec["frames_differ"] or rec["fields_differ"] or
                   rec["inter_c8_cells_differ"] or
                   rec.get("qp_map_entries_differ") or
                   len(c8_ref) != len(c8_port))
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
