"""Puts the checkout's root (``camr_bench``) and ``src`` (the port) on
the path of the benchmark's tests; builds the tiny cells they run on
the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the widths a CPU test runs each family at
TINY = {
    "dense": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab=250, vocab_rows=256, loss_chunk=64),
    "ssm": dict(d_model=64, ssm_state=16, ssm_heads=4, ssm_d_inner=128,
                vocab=250, vocab_rows=256, loss_chunk=64),
}


def tiny_cell(name: str, **over):
    """The cell ``name`` at the widths of :data:`TINY`, two 64-token rows
    a subfile, the reference one row at a time, one traced step;
    ``over`` replaces further configuration fields."""
    from camr_bench import bench
    cell = bench.load_cell(name)
    cell.config = {**cell.config, **TINY[cell.config["family"]], **over}
    cell.traffic = {"seqs_per_subfile": 2, "seq_len": 64}
    cell.workload = {**cell.workload, "reference_rows": 1, "trace_steps": 1}
    return cell


@pytest.fixture
def card():
    """Skips a test without a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")
