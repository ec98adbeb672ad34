"""The harness refuses to time anything but a card."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

CMD = [sys.executable, "camr_bench/run.py", "--workload",
       "granite_l2_f32.sync_4x1024", "--seed", "3000000001", "--seconds", "1",
       "--trace", "0"]


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


def test_no_card_is_an_error():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness would time it")
    proc = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    _no_result(proc)
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_are_an_error(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder
    (no program) gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "camr_bench", tmp_path / "camr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    _no_result(proc)
