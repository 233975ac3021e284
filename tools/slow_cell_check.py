#!/usr/bin/env python3
"""The slow/zerolatency cell's new pieces alone on one card, in a few
minutes (chip_smoke.py runs them with everything else):

    python3 tools/slow_cell_check.py

Builds the kernels, then: the gather at the slow/zerolatency shapes
(timed) and the placebo/zerolatency shapes (exactness only); card ==
CPU on the placebo/zerolatency 72x128 clip (1 I + 5 P in one chunk), the
NR 600 + lowpass 64x96 clip (chunks of 2) and one --preset fast
mini-GOP with RDOQ; one unwarmed slow/zerolatency pass of 1 I + 8 P at
1080p with its shares; RDOQ's cost in one slow P frame
(chip_smoke.phase_rdoq); one profile of a slow P chunk. Prints what
chip_smoke.py prints for these phases and exits 1 if card != CPU.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        c.log("CUDA is not available: this script runs on a GPU only")
        return 1
    from x265_tpu_torch import kernels
    from x265_tpu_torch.native.entropy_native import get_lib
    t0 = time.perf_counter()
    kernels.build(kernels.sources())
    get_lib()
    print(json.dumps({"card": c.card_line(),
                      "build_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps(c.phase_gather(c.SLOW_SHAPES, (torch.uint8,))),
          flush=True)
    c.phase_gather(c.PLACEBO_SHAPES, (torch.uint8,), timing=False)
    ok = True
    for tag, frames, make_cfg, chunk in (
            ("placebo 72x128", c.medium_clip(6), c.placebo_config, 5),
            ("NR 600 + lowpass 64x96", c.small_clip(5), c.nr_lowpass_config,
             2)):
        h, w = frames[0][0].shape
        card = c.encode_ippp(frames, "cuda", make_cfg(h, w), chunk=chunk)
        cpu = c.encode_ippp(frames, "cpu", make_cfg(h, w), chunk=chunk)
        same = [a.bitstream for a in card] == [b.bitstream for b in cpu]
        ok &= same
        print(json.dumps({"card_equals_cpu": tag, "equal": same,
                          "bytes": [len(r.bitstream) for r in card]}),
              flush=True)
    frames = c.b_clip(5)
    card, lc = c.encode_random_access(frames, "cuda",
                                      c.fast_b_rdoq_config(64, 96))
    cpu, lp = c.encode_random_access(frames, "cpu",
                                     c.fast_b_rdoq_config(64, 96))
    same = lc == lp and [a.bitstream for a in card] == \
        [b.bitstream for b in cpu]
    ok &= same
    print(json.dumps({"card_equals_cpu": "fast + RDOQ 64x96 mini-GOP",
                      "equal": same, "minigop_lengths": lc}), flush=True)
    frames = [c.synth_1080p(i % 3, shift=2 * i) for i in range(9)]
    t0 = time.perf_counter()
    res = c.encode_ippp(frames, "cuda", c.slow_config(1080, 1920))
    torch.cuda.synchronize()
    print(json.dumps({"slow_1080p_1i8p_unwarmed_s": time.perf_counter() - t0,
                      "bytes": sum(len(r.bitstream) for r in res),
                      **c.path_stats(res, 64)}), flush=True)
    c.phase_rdoq(frames)
    c.phase_profile(frames, c.slow_config(1080, 1920), "slow")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
