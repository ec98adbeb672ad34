"""The check fails what it has to: a run of the harness on the CPU at a
tiny width (float32, so that a sound run reads round-off alone), the
look for a card skipped, with each fault of ``camr_bench.faults``
planted in the trainer underneath, comes out not correct at the cell's
own limits; so does the control, the reference computed with float8
products in the program's place; a sound run comes out correct."""

import pytest
from conftest import tiny_cell

from camr_bench import bench, check
from camr_bench.faults import FAULTS

CELLS = ["granite_l2_f32.sync_4x1024", "mamba2_l2_bf16.map_32x512",
         "granite_l2_f32.map_2x4096"]
SEED = 2**31 + 12345


def _run(name, plant=None):
    cell = tiny_cell(name, dtype="float32")
    return bench.run_cell(cell, SEED, 0.2, False, "cpu", 0.0, plant)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    res = _run(name, FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name, dtype="float32")
    ref = bench.reference_record(cell, SEED, "cpu")
    control = bench.reference_record(cell, SEED, "cpu", fp8=True)
    ok, checks = check.judge(check.gaps(control, ref),
                             cell.workload["limits"])
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_twin_reference_is_correct(name):
    """The reference computed in float64 inside each op, with the same
    roundings, reads as sound against the float32 one: the calibration's
    twin measures round-off, not a fault."""
    cell = tiny_cell(name, dtype="float32")
    ref = bench.reference_record(cell, SEED, "cpu")
    twin = bench.reference_record(cell, SEED, "cpu", twin=True)
    ok, checks = check.judge(check.gaps(twin, ref), cell.workload["limits"])
    assert ok, checks


def test_traced_run_reads_the_per_layer_metrics():
    cell = tiny_cell(CELLS[0], dtype="float32")
    res = bench.run_cell(cell, SEED, 0.2, True, "cpu", 0.0)
    assert {"map_ms", "aggregate_ms", "shuffle_ms", "update_ms"} <= set(
        res["metrics"])
    # no device: nothing to read the idle share or a peak's share from
    assert "device_idle_pct" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
