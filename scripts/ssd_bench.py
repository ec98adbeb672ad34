#!/usr/bin/env python3
"""Time one checkout's ``ssd_scan`` at the serving shapes, and show what
``ptxas`` makes of its kernels.

    python3 scripts/ssd_bench.py [--src DIR] [--tag NAME] [--ptxas]
                                 [--dtype bfloat16|float32]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and, at each shape of ``chip_smoke.py``'s ``SSD_SHAPES`` (x, b, c in
``--dtype``, default bf16, group-shared b/c, the model's log-decay
``-softplus(.)``), prints one JSON line with the times of
``kernel_tools.times``: ``ms``, ``device_ms`` and ``host_us``, and
``kernels_ms``, the device time of each CUDA kernel of the call by name.
``--ptxas`` first compiles ``DIR``'s ``csrc/ssd_scan.cu`` with the
port's ``nvcc`` flags plus ``-Xptxas -v`` and prints one line per
kernel instantiation: the body (``tc``: bf16 on the tensor cores, by its
64-column panels of the state; ``f32 gram``, ``f32 state`` and ``f32
out``: the f32 body's three CUDA-core kernels; ``simt f32``: the single
f32 kernel of checkouts before the split), registers a thread, spill stores and
loads, static shared memory and, for the tensor-core body, the dynamic
shared memory it launches with (``TcShape<SP>::kSmem``). To compare two
versions of the kernel on one card, run both checkouts in one call, in
turns (parent, change, change, parent). Needs one CUDA card
(``--ptxas`` alone needs only ``nvcc``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import kernel_tools

PANELS = (1, 2, 4)


def ptxas(build, tag: str) -> None:
    src = os.path.join(os.path.dirname(build.__file__), "csrc",
                       "ssd_scan.cu")
    with open(src) as f:
        has_tc = "struct TcShape" in f.read()
    consts = [f"TcShape<{sp}>::kSmem" for sp in PANELS] if has_tc else []
    rows, smem, notes = kernel_tools.ptxas(build, src, consts)
    for row in rows:
        body = re.search(r"ssd_(?:tcILi(\d+)E|kernelIfE|(gram|state|out)_f32)",
                         row["name"])
        if not body:
            continue
        if body.group(1):
            panels = int(body.group(1))
            what = f"tc S <= {64 * panels} ({panels} panels)"
            dyn = f", dynamic smem {smem[PANELS.index(panels)]} B"
        else:
            what, dyn = f"f32 {body.group(2)}" if body.group(2) \
                else "simt f32", ""
        print(f"ssd_scan [{tag}] {what}: {row['registers']} registers, "
              f"spill stores {row['spill_stores']} B, spill loads "
              f"{row['spill_loads']} B, static smem {row['static_smem']} B"
              f"{dyn}", flush=True)
    for line in notes:
        print("ptxas:", line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(kernel_tools.ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    if args.ptxas:
        from repro_torch.kernels import _build
        ptxas(_build, args.tag)
    import torch
    if not torch.cuda.is_available():
        if args.ptxas:
            return 0
        print("ssd_bench: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import ssd_scan
    dtype = getattr(torch, args.dtype)
    smoke = kernel_tools.chip_smoke()
    print(kernel_tools.card())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for shape in smoke.SSD_SHAPES:
        B, T, H, P, S = shape
        x, b, c = (torch.randn(sh, device="cuda", generator=gen)
                   .to(dtype)
                   for sh in ((B, T, H, P), (B, T, S), (B, T, S)))
        a = -torch.nn.functional.softplus(
            torch.randn((B, T, H), device="cuda", generator=gen))
        row = dict(tag=args.tag, src=args.src, shape=list(shape),
                   dtype=args.dtype,
                   **kernel_tools.times(smoke, lambda: ssd_scan(x, a, b, c)),
                   kernels_ms=smoke.device_ms_by_kernel(
                       lambda: ssd_scan(x, a, b, c)))
        print(json.dumps(row), flush=True)
        del x, a, b, c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
