"""The program's spans as the benchmark reads them: an idle gap of the
device named by a ``camr.*`` host event, and the readers of the span
metrics, on a program that records spans and on one that does not."""

import pytest
import torch

from camr_bench import bench, devtrace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class _Event:
    """The parts of a kineto event that ``reduce_events`` reads."""

    def __init__(self, name, start, end, device=CPU, annotation=False):
        self._v = (name, start, end, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_idle_gap_named_by_a_span():
    """A gap that no aten op covers takes the innermost ``camr.`` span
    running at its middle; a user annotation of the same name would
    not name it."""
    events = [
        _Event(devtrace.WINDOW, 0, 2000, annotation=True),
        _Event("gemm", 0, 300, CUDA),
        _Event("gemm", 700, 1200, CUDA),
        _Event("gemm", 1600, 2000, CUDA),
        _Event("camr.map", 0, 1300),
        _Event("camr.map.forward", 250, 800),
        _Event("aten::mm", 100, 300),           # ends before the gap
        _Event("cudaLaunchKernel", 400, 600),   # a runtime call: dropped
        _Event("camr.update.adamw", 1250, 1700, annotation=True),
    ]
    tr = devtrace.reduce_events(events)
    gaps = dict(tr.idle_gaps)
    assert gaps == {"camr.map.forward": pytest.approx(400e-9),
                    "host: no op running": pytest.approx(400e-9)}
    assert tr.window_s == pytest.approx(2e-6)
    assert tr.busy_s == pytest.approx(1.2e-6)


def _ctx(phase_ms):
    return bench.Context(steps=len(phase_ms), window_s=1.0,
                         tokens_per_step=1, step_flops=1.0,
                         sync_least_bytes=1.0, setup_s=1.0,
                         window_peak_bytes=None, phase_ms=phase_ms,
                         trace=None, peak_flops=None, hbm_bytes_per_s=None)


def _steps():
    base = {"map": 100.0, "aggregate": 5.0, "shuffle": 8.0, "update": 6.0}
    one = dict(base, **{"map.upload:host": 30.0, "map.forward:host": 20.0,
                        "map.backward:host": 25.0, "map.row:host": 2.0,
                        "shuffle.encode": 1.5, "shuffle.decode": 3.5})
    two = {k: 2 * v for k, v in one.items()}
    return base, [one, two]


def test_span_metric_readers():
    base, steps = _steps()
    read = lambda name, ms: bench._reader(name)(_ctx(ms))
    assert read("map_host_ms", steps) == pytest.approx(1.5 * 47.0)
    assert read("map_wait_ms", steps) == pytest.approx(1.5 * 30.0)
    assert read("shuffle_codec_ms", steps) == pytest.approx(1.5 * 5.0)
    # a program without the spans (the phases alone): nothing to read,
    # and the metric is left out of the line
    for name in ("map_host_ms", "map_wait_ms", "shuffle_codec_ms"):
        assert read(name, [base, base]) is None
        assert read(name, [steps[0], base]) is None
    specs = [{"name": n, "unit": "ms"} for n in
             ("map_ms", "map_host_ms", "map_wait_ms", "shuffle_codec_ms")]
    assert set(bench.read_metrics(specs, _ctx([base]))) == {"map_ms"}
