#!/usr/bin/env python3
"""The GPU port against the JAX reference on the CPU, frame for frame:

    python3 tools/port_vs_ref.py [--size HxW] [--bits 8|10] [--frames N]
        [--legs bench,fast,medium,slow,placebo,fast_b,aq_cutree]
        [--write-digests FILE]

Encodes the first N frames of chip_smoke.py's bench clip (frame i is
synth_1080p(i % 3, shift=2 i), cropped to --size, default 1080x1920)
with x265_tpu and with x265_tpu_torch, both on the CPU, through the
calls chip_smoke.py makes on the card, in seven legs:

- bench, fast, medium, slow, placebo (N = 3 unless --frames): low-delay
  IPPP as chip_smoke.encode_ippp codes it (the I frame at QP - 3 on the
  device recon, then encode_pgop_pipelined in chunks of 8), in the bench
  configuration and under --preset fast|medium|slow|placebo --tune
  zerolatency. At N = 25 a leg is the whole timed pass of
  chip_smoke.phase_path.
- fast_b (N = 5): --preset fast with B frames through the CLI's
  mini-GOP loop (chip_smoke.encode_random_access: plan_minigop picks
  each B-run, encode_minigop codes it).
- aq_cutree (N = 3): encode_sequence under --preset medium --tune
  zerolatency with aq-mode 2 and cuTree (chip_smoke.encode_seq: the
  device lookahead's per-CTU QP maps, the host-recon I frame, dQP P
  chunks).

The port's side runs chip_smoke.py's own function; the reference's runs
the same calls on x265_tpu's encoder. For each frame the tool diffs the
bytes, every syntax field and the 8x8 inter leaf cost inter_c8 of every
P and B frame (read from both packages' _rd_depth_decision as they run),
and in the aq_cutree leg the QP maps the lookahead gave, entry by entry.
Prints one JSON line per leg (differing frames, bytes, syntax fields,
QP-map entries and inter_c8 cells, seconds) and exits 1 if any leg
differs.

--bits 10 runs the same legs on the clip lifted to 10 bits as
chip_smoke.synth10_1080p lifts it (chip_smoke.to_10bit) and with SAO
off, which neither package codes at 10 bits (ROADMAP item 31).

--write-digests FILE adds each leg whose frames all equal to FILE (a
JSON file, created or updated leg by leg): the chip_smoke.py stream it
is checked against (null where the card codes no such stream: another
size, 10 bits, placebo; chip_smoke.RefDigests refuses such a leg), the
configuration, the clip's definition, and per frame of the reference in
coded order its type, POC, byte count and sha256. chip_smoke.py holds
the card's streams to the committed tools/ref_digests_1080p.json
(chip_smoke.RefDigests); renew that file only from this tool's
reference run.

Needs JAX: run it where the reference runs, not on the GPU machine.
Each leg traces the reference's programs anew; at 1080p run one leg per
process, one process at a time (4-21 minutes a leg and 4.4-6.8 GiB of
host memory; SKILL.md gives the measured times).
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

IPPP = ("bench", "fast", "medium", "slow", "placebo")
LEGS = IPPP + ("fast_b", "aq_cutree")
DEFAULT_FRAMES = {"fast_b": 5}
CARD_SIZE = (1080, 1920)
CLIP = "chip_smoke.synth_1080p(i % 3, shift=2 * i)"
CLIP_10 = "chip_smoke.to_10bit(synth_1080p(i % 3, shift=2 * i), i % 3, " \
    "shift=2 * i)"
CALLS = {
    "ippp": "chip_smoke.encode_ippp: encode_frame(qp - 3, device recon), "
            "encode_pgop_pipelined(frames[1:], chunk=8)",
    "fast_b": "chip_smoke.encode_random_access: the CLI's mini-GOP loop "
              "(plan_minigop, encode_minigop)",
    "aq_cutree": "chip_smoke.encode_seq: encode_sequence"}


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


def card_stream(leg, n, size, bits):
    """The chip_smoke.py stream whose first n frames a leg's digests
    hold (chip_smoke.RefDigests.check names the same), or None where
    the card codes no such stream: the timed pass of phase_path (IPPP
    legs but placebo, any n up to its 25 frames), or the whole 25-frame
    timed pass of phase_b_path and of phase_aq_cutree (their lookahead
    sees the whole clip, so a shorter encode is not a prefix)."""
    import chip_smoke
    if size != CARD_SIZE or bits != 8:
        return None
    if leg in IPPP and leg != "placebo" and n <= chip_smoke.GOP:
        return f"phase_path:{leg}"
    if n == chip_smoke.GOP:
        return {"fast_b": "phase_b_path",
                "aq_cutree": "phase_aq_cutree"}.get(leg)
    return None


def _record_inter_c8(ref_pgop, port_pgop):
    """Wrap both packages' _rd_depth_decision so every call appends its
    inter_c8 plane, the reference's through a host callback from inside
    its jitted scan. The B modules bind the wrapped function: they are
    imported at their first use, after this. Returns (ref list, port
    list, a function that puts both back)."""
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

    def restore():
        ref_pgop._rd_depth_decision = ref_fn
        port_pgop._rd_depth_decision = port_fn

    ref_pgop._rd_depth_decision = ref_wrap
    port_pgop._rd_depth_decision = port_wrap
    return got_ref, got_port, restore


def _fields(syn):
    return {k: v for k, v in vars(syn).items() if v is not None}


def _differs(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) != len(b) or any(_differs(x, y) for x, y in zip(a, b))
    return not np.array_equal(np.asarray(a), np.asarray(b))


def ref_ippp(enc, frames, chunk):
    """chip_smoke.encode_ippp's calls on the reference's encoder."""
    r0 = enc.encode_frame(*frames[0], qp=enc.cfg.qp - 3,
                          use_device_recon=True)
    enc.ref = r0.device_ref
    enc.poc = 0
    return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=chunk)


def ref_random_access(enc, frames):
    """chip_smoke.encode_random_access's calls on the reference's
    encoder and lookahead; its I frame as the reference's CLI codes it
    (x265_tpu/cli.py:547-551: the host recon, whose bytes are its
    device wavefront's)."""
    from x265_tpu.enc.lookahead import Lookahead
    cfg = enc.cfg
    la = Lookahead(cfg)
    r0 = enc.encode_frame(*frames[0], qp=cfg.qp - 3)
    enc.ref = r0.recon
    enc.poc = 0
    results, buf = [r0], []
    anchor_y = frames[0][0]

    def flush(count):
        nonlocal buf, anchor_y
        results.extend(enc.encode_minigop(buf[:count], qp=cfg.qp))
        anchor_y = buf[count - 1][0]
        buf = buf[count:]

    for fr in frames[1:]:
        buf.append(fr)
        if len(buf) >= cfg.bframes + 1:
            nb = la.plan_minigop(anchor_y, [f[0] for f in buf]) \
                if cfg.b_adapt else len(buf) - 1
            flush(nb + 1)
    if buf:
        flush(len(buf))
    return results


def ref_seq(enc, frames):
    """chip_smoke.encode_seq's call on the reference's encoder: the
    results and the QP maps as coded (the I frame's lowered by 3)."""
    import chip_smoke
    maps, real = [], enc.lookahead_qp_maps

    def lookahead(*a, **k):
        maps.append(real(*a, **k))
        return maps[-1]

    enc.lookahead_qp_maps = lookahead
    res = enc.encode_sequence(frames)
    return res, chip_smoke.coded_qp_maps(maps, enc.cfg.qp)


def run_leg(leg, h, w, bits=8, n=None):
    """One leg: (the JSON record, the reference's results, the
    reference's configuration)."""
    import chip_smoke
    from x265_tpu.common.params import EncoderConfig as RefConfig
    from x265_tpu.enc import IntraEncoder as RefEncoder
    from x265_tpu_torch.convert import config_from_dict
    n = n or DEFAULT_FRAMES.get(leg, 3)
    frames = chip_smoke.full_size_clip(n, (h, w))
    if bits > 8:
        # frame i of the bench clip is synth_1080p(i % 3, shift=2 i)
        frames = [chip_smoke.to_10bit(f, i % 3, shift=2 * i)
                  for i, f in enumerate(frames)]
    rcfg = _config(leg, h, w, RefConfig, bits)
    pcfg = config_from_dict(dataclasses.asdict(rcfg))
    out, maps = {}, {}
    for side in ("ref", "port"):
        t0 = time.perf_counter()
        if leg == "aq_cutree":
            res, maps[side] = (ref_seq(RefEncoder(rcfg), frames)
                               if side == "ref" else
                               chip_smoke.encode_seq(frames, "cpu", pcfg))
        elif leg == "fast_b":
            res = (ref_random_access(RefEncoder(rcfg), frames)
                   if side == "ref" else
                   chip_smoke.encode_random_access(frames, "cpu", pcfg)[0])
        elif side == "ref":
            res = ref_ippp(RefEncoder(rcfg), frames, chip_smoke.CHUNK)
        else:
            res = chip_smoke.encode_ippp(frames, "cpu", pcfg)
        out[side] = (res, time.perf_counter() - t0)
    (ref, ref_s), (port, port_s) = out["ref"], out["port"]
    frames_differ, fields_differ = [], []
    for i, (a, b) in enumerate(zip(ref, port)):
        if (a.bitstream, a.ftype, a.poc) != (b.bitstream, b.ftype, b.poc):
            frames_differ.append(i)
        fa, fb = _fields(a.syntax), _fields(b.syntax)
        for k in sorted(set(fa) | set(fb)):
            if (k in fa) != (k in fb) or _differs(fa[k], fb[k]):
                fields_differ.append(f"frame {i} ({a.ftype} POC {a.poc}) {k}")
    if len(ref) != len(port):
        frames_differ.append(min(len(ref), len(port)))
    qp_maps = {}
    if maps:
        mr, mp = (np.concatenate([m.ravel() for m, _ in maps[s]])
                  for s in ("ref", "port"))
        differ = int((mr != mp).sum()) if mr.size == mp.size else \
            max(mr.size, mp.size)
        qp_maps = {"qp_map_entries": int(mp.size),
                   "qp_map_entries_differ": differ,
                   "qp_map_min_max": [int(mp.min()), int(mp.max())]}
    rec = {"leg": leg, "size": f"{h}x{w}", "bits": bits,
           "frames": len(ref), "types": "".join(r.ftype for r in ref),
           **qp_maps,
           "ref_bytes": sum(len(r.bitstream) for r in ref),
           "port_bytes": sum(len(r.bitstream) for r in port),
           "frames_differ": frames_differ,
           "bytes_differ": sum(sum(x != y for x, y in zip(a.bitstream,
                                                          b.bitstream)) +
                               abs(len(a.bitstream) - len(b.bitstream))
                               for a, b in zip(ref, port)),
           "fields_differ": fields_differ, "ref_s": ref_s, "port_s": port_s}
    return rec, ref, rcfg


def digest_entry(leg, rec, ref, rcfg, h, w, bits) -> dict:
    """A leg's entry of the digest file (chip_smoke.RefDigests reads
    it)."""
    import chip_smoke
    calls = CALLS.get(leg, CALLS["ippp"])
    return {"stream": card_stream(leg, len(ref), (h, w), bits),
            "size": f"{h}x{w}", "bits": bits,
            "config": json.loads(json.dumps(dataclasses.asdict(rcfg))),
            "clip": {"frame_i": CLIP if bits == 8 else CLIP_10,
                     "crop": [h, w], "frames": len(ref)},
            "calls": calls,
            "frames": [chip_smoke.frame_digest(r) for r in ref],
            "bytes": rec["ref_bytes"]}


def write_digests(path, leg, entry) -> None:
    """Add (or replace) one leg's entry of the digest file at path."""
    path = Path(path)
    doc = json.loads(path.read_text()) if path.exists() else {
        "about": "The reference's (x265_tpu's) frames of chip_smoke.py's "
                 "1080p streams, written by tools/port_vs_ref.py "
                 "--write-digests on the CPU where every frame of the port "
                 "equalled them; chip_smoke.RefDigests holds the card's "
                 "streams to them.",
        "legs": {}}
    doc["legs"][leg] = entry
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--bits", type=int, choices=(8, 10), default=8)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a leg codes (default 3, fast_b 5)")
    ap.add_argument("--write-digests", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.size.split("x"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from x265_tpu.enc import pgop_tpu as ref_pgop
    from x265_tpu_torch.enc import pgop_gpu as port_pgop
    ok = True
    c8_ref, c8_port, restore = _record_inter_c8(ref_pgop, port_pgop)
    try:
        for leg in args.legs.split(","):
            c8_ref.clear()
            c8_port.clear()
            t0 = time.perf_counter()
            rec, ref, rcfg = run_leg(leg, h, w, args.bits, args.frames)
            jax.effects_barrier()
            cells = [int((np.asarray(a, np.float32).view(np.int32) !=
                          np.asarray(b, np.float32).view(np.int32)).sum())
                     for a, b in zip(c8_ref, c8_port)]
            rec.update(inter_c8_planes=(len(c8_ref), len(c8_port)),
                       inter_c8_cells=int(sum(np.asarray(a).size
                                              for a in c8_port)),
                       inter_c8_cells_differ=sum(cells),
                       seconds=time.perf_counter() - t0)
            same = not (rec["frames_differ"] or rec["fields_differ"] or
                        rec["inter_c8_cells_differ"] or
                        rec.get("qp_map_entries_differ") or
                        len(c8_ref) != len(c8_port))
            ok &= same
            if same and args.write_digests:
                write_digests(args.write_digests, leg, digest_entry(
                    leg, rec, ref, rcfg, h, w, args.bits))
                rec["digests"] = args.write_digests
            print(json.dumps(rec), flush=True)
    finally:
        restore()
    return 0 if ok else 1


if __name__ == "__main__":
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    sys.exit(main())
