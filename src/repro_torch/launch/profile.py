"""Where one training step's device time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile

Builds the measured cell (:mod:`repro_torch.launch.cell`) on the current
CUDA device, once per run of ``RUNS`` (the f32 lane, the bf16 lane, then
the f32 lane through the multipass codec, each trainer freed before the
next is built), runs ``WARM`` steps, then one step
under ``torch.profiler`` and prints: the step's wall time, the summed
device time of its kernels and their share of the wall time (one stream,
so kernels do not overlap), and the kernels with the most device time.
Prints "device time: not measured" when the profiler records no device
activity.
"""

from __future__ import annotations

import gc
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.cell import make_cell

WARM = 2     # steps before the traced one: cuBLAS and allocator warm-up
TOP = 25     # kernels listed
#: (grad_sync_dtype, codec) of each profiled run
RUNS = (("float32", "fused"), ("bfloat16", "fused"), ("float32", "multipass"))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    for lane, codec in RUNS:
        print(f"== grad_sync_dtype={lane} codec={codec}")
        profile_lane(lane, codec)
        gc.collect()
        torch.cuda.empty_cache()


def profile_lane(lane: str, codec: str) -> None:
    tr, pipe = make_cell(grad_sync_dtype=lane, codec=codec)
    tr.train_steps(pipe, WARM)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = tr.train_steps(pipe, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type.name == "CUDA"]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(json.dumps({"step_wall_ms": wall_ms, "phase_ms": rep.phase_ms[0]}))
    if not kernels:
        print("device time: not measured (the profiler recorded none)")
        return
    print(f"device time: {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}% busy)")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:TOP]:
        print(f"{_device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:110]}")


if __name__ == "__main__":
    main()
