#!/usr/bin/env python3
"""Time one checkout's ``flash_attention`` at the serving shapes.

    python3 scripts/flash_bench.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and, at each bf16 shape of ``chip_smoke.py``'s ``FLASH_SHAPES``, prints
one JSON line: the median CUDA-event time of a call (``ms``, host launch
included, as ``chip_smoke.time_ms``), the device time of its kernels in a
``torch.profiler`` trace (``device_ms``, as ``chip_smoke.device_ms``),
the host time to enqueue a call (``host_us``) and, where SDPA computes
the same function (causal, no softcap, no window), SDPA's two times. A
shape the checkout's wrapper refuses prints ``"refused"``. To compare
two versions of the kernel on one card, run both checkouts in one call,
in turns (parent, change, change, parent).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def host_us(fn, calls=20) -> float:
    """Host microseconds to enqueue one call (no synchronisation between
    calls)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bench: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import flash_attention
    smoke = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in smoke.FLASH_SHAPES:
        B, Hq, Hkv, Tq, Tk, D, causal, window, softcap = case
        q, k, v = (torch.randn(s, device="cuda", generator=gen)
                   .to(torch.bfloat16)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D),
                             (B, Hkv, Tk, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        row = dict(tag=args.tag, src=args.src, shape=list(case))
        try:
            flash_attention(q, k, v, **kw)
        except ValueError as e:
            row["refused"] = str(e)
        else:
            call = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
            row.update(ms=smoke.time_ms(call),
                       device_ms=smoke.device_ms(call),
                       host_us=host_us(call))
        sdpa = smoke._sdpa_fn(q, k, v, causal, window, softcap)
        if sdpa is not None:
            row.update(sdpa_ms=smoke.time_ms(sdpa),
                       sdpa_device_ms=smoke.device_ms(sdpa))
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
