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

Then, for each cell of ``REMAT_MAPS`` (the smoke's granite cell on the
f32 lane and its zamba2 cell on the bf16 lane), one subfile's map
gradient as the trainer computes it (``_grad_vec``), at the config's
``remat="block"`` and at ``"none"``: the host's time to enqueue it
(until the call returns) and its wall time (to a synchronise), medians
of ``MAP_REPS`` calls after one warm call, then one call of each under
``torch.profiler``: the device time and count of its kernels, the
number of aten ops the host dispatched and the host's self time in
them, and the host ops with the most self time.
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
#: (grad_sync_dtype, arch, n_layers) of each map profiled at both remats
REMAT_MAPS = (("float32", "granite_3_2b", 2), ("bfloat16", "zamba2_2p7b", 6))
MAP_REPS = 3
TOP_HOST = 8  # host ops listed per map


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
    for lane, arch, n_layers in REMAT_MAPS:
        print(f"== map gradient {arch} n_layers={n_layers} "
              f"grad_sync_dtype={lane}, remat block and none")
        profile_remat_map(lane, arch, n_layers)
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


def profile_remat_map(lane: str, arch: str, n_layers: int) -> None:
    from repro_torch.runtime.train_loop import _full_f32
    tr, pipe = make_cell(grad_sync_dtype=lane, arch=arch, n_layers=n_layers)
    cfg, batch = tr.cfg, pipe.batch(0)
    tr._last_loss = [dict() for _ in range(tr.J)]

    def one_map():
        t0 = time.perf_counter()
        with _full_f32(tr.device):
            row = tr._grad_vec(0, 0, batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del row
        return (t1 - t0) * 1e3, (t2 - t0) * 1e3

    try:
        for remat in ("block", "none"):
            tr.cfg = cfg.replace(remat=remat)
            one_map()
            times = [one_map() for _ in range(MAP_REPS)]
            host_ms, wall_ms = (sorted(t)[MAP_REPS // 2] for t in zip(*times))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one_map()
            evts = prof.key_averages()
            kernels = [e for e in evts if _device_us(e) > 0
                       and e.device_type.name == "CUDA"]
            host = [e for e in evts if e.device_type.name == "CPU"
                    and e.key.startswith("aten::")]
            rec = {"remat": remat, "host_enqueue_ms": host_ms,
                   "wall_ms": wall_ms,
                   "device_ms": (sum(_device_us(e) for e in kernels) / 1e3
                                 if kernels else None),
                   "kernel_launches": sum(e.count for e in kernels),
                   "aten_ops": sum(e.count for e in host),
                   "aten_self_cpu_ms": sum(e.self_cpu_time_total
                                           for e in host) / 1e3}
            print(json.dumps(rec))
            top = sorted((e for e in evts if e.device_type.name == "CPU"),
                         key=lambda e: e.self_cpu_time_total, reverse=True)
            for e in top[:TOP_HOST]:
                print(f"  host {e.self_cpu_time_total / 1e3:9.2f} ms  "
                      f"{e.count:6d}x  {e.key[:100]}")
    finally:
        tr.cfg = cfg


if __name__ == "__main__":
    main()
