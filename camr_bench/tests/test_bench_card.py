"""On the card: one short run of each cell through the benchmark's
command, traced and untraced, and the keys of its result's line."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

BM = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_run_on_the_card(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "camr_bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = BM["per_layer"] if trace else BM["end_to_end"]
    assert set(res["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
