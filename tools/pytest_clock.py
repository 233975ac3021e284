"""Where the tier-1 test run's time goes: a pytest plugin that writes,
per xdist worker, each test's start and finish time and each XLA
compile's seconds, and a report of them.

Record (the tier-1 command with the plugin loaded; CLOCK_DIR must
exist):

    PYTHONPATH=tools CLOCK_DIR=DIR python -m pytest tests/ ... \\
        -p pytest_clock

Report (per file: worker, first start and last finish in seconds from
the run's first start, span, compile seconds; then the totals):

    python3 tools/pytest_clock.py DIR

A compile is logged only where the JAX persistent cache missed, so the
compile seconds of a run from an empty cache directory are the cost of
tracing every distinct program of the files that started.
"""

import json
import logging
import os
import re
import time

_state = {"test": "<collection>", "file": None}


def _write(rec):
    if _state["file"] is None:
        name = os.environ.get("PYTEST_XDIST_WORKER", "controller")
        _state["file"] = open(os.path.join(os.environ["CLOCK_DIR"],
                                           name + ".jsonl"), "a")
    _state["file"].write(json.dumps(rec) + "\n")
    _state["file"].flush()


class _Compiles(logging.Handler):
    def emit(self, record):
        m = re.search(r"Finished XLA compilation of (\S+) in ([0-9.]+) sec",
                      record.getMessage())
        if m:
            _write({"id": _state["test"], "ev": "compile",
                    "program": m.group(1), "s": float(m.group(2))})


def pytest_configure(config):
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return                      # the controller runs no test
    import jax
    jax.config.update("jax_log_compiles", True)     # logged at WARNING
    logging.getLogger("jax").addHandler(_Compiles())


def pytest_runtest_logstart(nodeid, location):
    if "PYTEST_XDIST_WORKER" in os.environ:
        _state["test"] = nodeid
        _write({"id": nodeid, "ev": "start", "t": time.time()})


def pytest_runtest_logfinish(nodeid, location):
    if "PYTEST_XDIST_WORKER" in os.environ:
        _write({"id": nodeid, "ev": "end", "t": time.time()})


def report(d):
    files = {}
    for name in sorted(os.listdir(d)):
        if not name.endswith(".jsonl"):
            continue
        for line in open(os.path.join(d, name)):
            r = json.loads(line)
            f = files.setdefault(r["id"].split("::")[0], {
                "worker": name[:-6], "start": None, "end": None,
                "compile_s": 0.0})
            if r["ev"] == "compile":
                f["compile_s"] += r["s"]
                continue
            t = r["t"]
            f["start"] = t if f["start"] is None else min(f["start"], t)
            f["end"] = t if f["end"] is None else max(f["end"], t)
    ran = {k: v for k, v in files.items() if v["start"] is not None}
    t0 = min(v["start"] for v in ran.values())
    for k, v in sorted(ran.items(), key=lambda kv: kv[1]["start"]):
        print(f"{v['worker']:6s} {v['start'] - t0:7.0f} {v['end'] - t0:7.0f} "
              f"{v['end'] - v['start']:7.0f} {v['compile_s']:7.0f}  {k}")
    for label, keep in (("port", lambda k: "test_torch_" in k),
                        ("reference", lambda k: "test_torch_" not in k)):
        sel = [v for k, v in ran.items() if keep(k)]
        print(f"{label}: {len(sel)} files, "
              f"{sum(v['end'] - v['start'] for v in sel):.0f} worker-s of "
              f"spans, {sum(v['compile_s'] for v in sel):.0f} s compiling")
    print(f"last finish {max(v['end'] for v in ran.values()) - t0:.0f} s")


if __name__ == "__main__":
    import sys
    report(sys.argv[1])
