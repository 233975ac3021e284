"""tools/port_vs_ref.py's --frames and --write-digests on a 64x96 bench
leg of 10 frames (1 I + two P chunks, of 8 and of 1, as
chip_smoke.encode_ippp codes them): the port equals the reference, and
the digests the tool writes from the reference's frames equal the
port's frames, which chip_smoke.RefDigests checks as it checks the
card's."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import torch

import chip_smoke as cs

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def test_port_vs_ref_writes_the_references_digests(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "port_vs_ref", REPO / "tools" / "port_vs_ref.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "digests.json"
    assert tool.main(["--size", "64x96", "--legs", "bench", "--frames",
                      "10", "--write-digests", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 10 and rec["types"] == "I" + "P" * 9
    assert rec["frames_differ"] == rec["fields_differ"] == []
    assert rec["inter_c8_planes"] == [9, 9]
    assert rec["inter_c8_cells_differ"] == 0
    leg = json.loads(out.read_text())["legs"]["bench"]
    cfg = cs.bench_config(64, 96)
    assert leg["stream"] is None and leg["size"] == "64x96"
    assert leg["config"] == json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert leg["clip"]["frames"] == 10 and leg["clip"]["crop"] == [64, 96]
    port = cs.encode_ippp(cs.full_size_clip(10, (64, 96)), "cpu", cfg)
    assert leg["frames"] == [cs.frame_digest(r) for r in port]
    assert leg["bytes"] == rec["ref_bytes"] == rec["port_bytes"]
    # as the card's streams are checked, at this leg's size
    doc = {"legs": {"bench": {**leg, "stream": "phase_path:bench",
                              "size": "1080x1920"}}}
    d = cs.RefDigests(doc=doc)
    d.check("phase_path:bench", cfg, port)
    d.finish()
