#!/usr/bin/env python3
"""Where a dQP P frame's wall goes, on the card:

    python3 tools/dqp_p_split.py

One 1080p chunk of 8 P frames of chip_smoke.py's bench clip after its
I frame, encoded with encode_pgop_pipelined in five ways, in turns (3
rounds after a warm-up, the order reversed every other round):
--preset medium --tune zerolatency without and with the recon download
(need_recon, which encode_sequence asks for), and the same with aq-mode
2 + cuTree: with the lookahead's QP maps, with them and the recon
download, and with flat maps. Prints the card line and one JSON line:
per way the seconds per P frame of each round, their median and the
chunk's bytes. Needs a CUDA card.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402
from x265_tpu_torch import kernels  # noqa: E402
from x265_tpu_torch.enc import IntraEncoder  # noqa: E402
from x265_tpu_torch.native.entropy_native import get_lib  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(c.card_line(), flush=True)
    kernels.build(kernels.sources())
    get_lib()
    frames = [c.synth_1080p(i % 3, shift=2 * i) for i in range(9)]
    med, aq = c.medium_config(1080, 1920), c.aq_cutree_config(1080, 1920)
    enc = IntraEncoder(aq, device="cuda")
    maps = enc.lookahead_qp_maps(frames)
    i_aq = enc.encode_frame(*frames[0], qp=29,
                            qp_map=np.clip(maps[0] - 3, 0, 51)).device_ref
    i_med = IntraEncoder(med, device="cuda").encode_frame(
        *frames[0], qp=29).device_ref

    def run(cfg, iref, qmaps, need_recon):
        enc = IntraEncoder(cfg, device="cuda")
        enc.ref, enc.poc = iref, 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs = enc.encode_pgop_pipelined(frames[1:], need_recon=need_recon,
                                       qp_maps=qmaps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 8, sum(len(r.bitstream)
                                                  for r in rs)

    ways = {"medium": (med, i_med, None, False),
            "medium_recon": (med, i_med, None, True),
            "aq": (aq, i_aq, maps[1:], False),
            "aq_recon": (aq, i_aq, maps[1:], True),
            "aq_flat": (aq, i_aq, None, False)}
    for way in ways.values():
        run(*way)                      # warm-up
    out = {k: [] for k in ways}
    for rnd in range(3):
        for k in (list(ways) if rnd % 2 == 0 else list(ways)[::-1]):
            out[k].append(run(*ways[k]))
    print(json.dumps({k: {"p_frame_s": [t for t, _ in v],
                          "median": float(np.median([t for t, _ in v])),
                          "bytes": v[0][1]} for k, v in out.items()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
