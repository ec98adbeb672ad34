#!/usr/bin/env python3
"""Time one checkout's ``flash_attention`` at the serving shapes.

    python3 scripts/flash_bench.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and, at each bf16 shape of ``chip_smoke.py``'s ``FLASH_SHAPES``, prints
one JSON line with the times of ``kernel_tools.times`` (``ms``,
``device_ms``, ``host_us``) and, where SDPA computes the same function
(causal, no softcap, no window), SDPA's ``ms`` and ``device_ms``. A
shape the checkout's wrapper refuses prints ``"refused"``. To compare
two versions of the kernel on one card, run both checkouts in one call,
in turns (parent, change, change, parent).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import kernel_tools


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(kernel_tools.ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bench: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import flash_attention
    smoke = kernel_tools.chip_smoke()
    print(kernel_tools.card())
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
            row.update(kernel_tools.times(
                smoke, lambda: flash_attention(q, k, v, **kw)))
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
