"""The reference's digests of the card's 1080p streams
(tools/ref_digests_1080p.json) and chip_smoke.py's check of them
(RefDigests): every leg names the chip_smoke.py stream it holds, the
configuration that stream is coded in, the clip and its frames; the
check passes on the recorded frames and fails on a frame with one byte
changed, a frame missing, a stream of another length where its length
matters, another configuration, or a leg no phase checked. Stand-in
streams, no encode."""

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent
CONFIGS = {"bench": cs.bench_config, "fast": cs.fast_config,
           "medium": cs.medium_config, "slow": cs.slow_config,
           "fast_b": cs.fast_b_config, "aq_cutree": cs.aq_cutree_config}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "port_vs_ref", REPO / "tools" / "port_vs_ref.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config_json(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_digest_file_lists_each_legs_stream_configuration_clip_and_frames():
    doc = json.loads(cs.REF_DIGESTS.read_text())
    cs.RefDigests(doc=doc)                      # well formed
    tool = _tool()
    legs = doc["legs"]
    assert {"bench", "fast", "medium", "slow", "aq_cutree"} <= set(legs)
    for leg, e in legs.items():
        n = len(e["frames"])
        assert e["stream"] == tool.card_stream(leg, n, (1080, 1920), 8), leg
        assert e["config"] == _config_json(CONFIGS[leg](1080, 1920)), leg
        assert e["clip"] == {"frame_i": tool.CLIP, "crop": [1080, 1920],
                             "frames": n}, leg
        assert e["calls"] == tool.CALLS.get(leg, tool.CALLS["ippp"]), leg
        types = "".join(f["type"] for f in e["frames"])
        assert types[0] == "I" and set(types[1:]) <= {"P", "B"}, leg
        assert sorted(f["poc"] for f in e["frames"]) == list(range(n)), leg
        assert all(f["bytes"] > 0 and len(f["sha256"]) == 64
                   for f in e["frames"]), leg
        if e["stream"].startswith("phase_path:"):
            assert types == "I" + "P" * (n - 1) and n <= cs.GOP, leg
            assert [f["poc"] for f in e["frames"]] == list(range(n)), leg


def _standin(n, seed=5):
    """A stand-in stream of n frames in coded order: an I frame, then P."""
    rng = np.random.default_rng(seed)
    return [SimpleNamespace(ftype="P" if i else "I", poc=i,
                            bitstream=rng.integers(0, 256, 40 + 7 * i)
                            .astype(np.uint8).tobytes()) for i in range(n)]


def _doc(stream, cfg, frames):
    digests = [cs.frame_digest(r) for r in frames]
    return {"legs": {"leg": {
        "stream": stream, "size": "1080x1920", "bits": 8,
        "config": _config_json(cfg), "clip": {"frames": len(frames)},
        "frames": digests, "bytes": sum(d["bytes"] for d in digests)}}}


def test_frame_digest_is_type_poc_bytes_and_sha256():
    r = _standin(2)[1]
    assert cs.frame_digest(r) == {
        "type": "P", "poc": 1, "bytes": 47,
        "sha256": hashlib.sha256(r.bitstream).hexdigest()}


@pytest.mark.parametrize("stream,coded", [("phase_path:bench", 3),
                                          ("phase_path:bench", 5),
                                          ("phase_b_path", 3)])
def test_check_passes_on_the_recorded_frames(stream, coded, capsys):
    cfg = cs.bench_config(1080, 1920)
    frames = _standin(coded)
    d = cs.RefDigests(doc=_doc(stream, cfg, frames[:3]))
    d.check("phase_path:fast", cfg, frames)     # another stream: no leg
    assert d.checked == set()
    d.check(stream, cfg, frames)
    d.finish()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"card_equals_reference": "leg", "stream": stream,
                    "frames": 3, "bytes": sum(len(r.bitstream)
                                              for r in frames[:3])}


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_check_fails_on_one_changed_byte(frame):
    cfg = cs.bench_config(1080, 1920)
    frames = _standin(4)
    d = cs.RefDigests(doc=_doc("phase_path:bench", cfg, frames[:3]))
    b = bytearray(frames[frame].bitstream)
    b[len(b) // 2] ^= 1
    frames[frame].bitstream = bytes(b)
    with pytest.raises(AssertionError, match=f"at leg: frame {frame} "):
        d.check("phase_path:bench", cfg, frames)
    with pytest.raises(AssertionError, match="never checked"):
        d.finish()


@pytest.mark.parametrize("case", ["short", "whole_longer", "config", "type",
                                  "poc"])
def test_check_fails_on_another_stream(case):
    cfg = cs.bench_config(1080, 1920)
    frames = _standin(4)
    stream = "phase_b_path" if case == "whole_longer" else "phase_path:bench"
    d = cs.RefDigests(doc=_doc(stream, cfg, frames[:3]))
    if case == "short":
        frames = frames[:2]
    elif case == "config":
        cfg = cs.fast_config(1080, 1920)
    elif case == "type":
        frames[2].ftype = "B"
    elif case == "poc":
        frames[1].poc = 2
    with pytest.raises(AssertionError, match="card != reference at leg"):
        d.check(stream, cfg, frames)


@pytest.mark.parametrize("field,value", [("size", "64x96"), ("bits", 10),
                                         ("stream", None), ("bytes", 1)])
def test_malformed_leg_raises(field, value):
    doc = _doc("phase_path:bench", cs.bench_config(1080, 1920), _standin(3))
    doc["legs"]["leg"][field] = value
    with pytest.raises(ValueError, match="leg leg is malformed"):
        cs.RefDigests(doc=doc)
