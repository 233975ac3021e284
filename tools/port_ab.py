#!/usr/bin/env python3
"""Two versions of the GPU port on one card, in turns:

    python3 tools/port_ab.py OTHER_CHECKOUT [ROUNDS]

Runs the 1080p bench clip of chip_smoke.py (1 I + 24 P, chunk 8: one
warm-up pass, one timed pass, then chip_smoke's torch.profiler trace of
one P chunk) with the x265_tpu_torch of OTHER_CHECKOUT and with this
checkout's, in the order other, this, this, other for each of ROUNDS
rounds (default 1), each run in a fresh process. The measuring code is
this checkout's chip_smoke.py for both; only the port differs, and
OTHER_CHECKOUT's package must take the calls that chip_smoke's
encode_ippp and phase_profile make. Prints
every line the runs print, each tagged with its run, then a summary
line of each side's P-frame and I-frame wall seconds.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

CHILD = r'''
import importlib.util, json, sys
tree, smoke_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("smoke", smoke_path)
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
from x265_tpu_torch import kernels
kernels.build(kernels.sources())
frames = [c.synth_1080p(i % 3, shift=2 * i) for i in range(c.GOP)]
c.encode_ippp(frames, "cuda", c.bench_config(1080, 1920))
split = {}
c.encode_ippp(frames, "cuda", c.bench_config(1080, 1920), timing=split)
print(json.dumps({"timed_pass": split,
                  "p_frame_s": split["p_frames_s"] / (c.GOP - 1)}), flush=True)
c.phase_profile(frames, c.bench_config(1080, 1920))
'''


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"other": Path(sys.argv[1]).resolve(), "this": HERE}
    rounds = int(sys.argv[2]) if len(sys.argv) == 3 else 1
    walls = {"other": [], "this": []}
    for rnd in range(rounds):
        for side in ("other", "this", "this", "other"):
            out = subprocess.run(
                [sys.executable, "-c", CHILD, str(trees[side]),
                 str(HERE / "chip_smoke.py")], cwd=trees[side],
                capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"{side} run failed")
            for line in out.stdout.splitlines():
                rec = json.loads(line)
                print(json.dumps({"round": rnd, "side": side, **rec}),
                      flush=True)
                if "timed_pass" in rec:
                    walls[side].append((rec["p_frame_s"],
                                        rec["timed_pass"]["i_frame_s"]))
    print(json.dumps({side: {"p_frame_s": [p for p, _ in ts],
                             "i_frame_s": [i for _, i in ts]}
                      for side, ts in walls.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
