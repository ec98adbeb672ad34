#!/usr/bin/env python3
"""Time one checkout's ``flash_attention`` at the serving shapes.

    python3 scripts/flash_bench.py [--src DIR] [--tag NAME]
                                   [--dtype bfloat16|float32] [--seamless]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and prints one JSON line per shape with the times of
``kernel_tools.times`` (``ms``, ``device_ms``, ``host_us``) and, where
SDPA computes the same function (no softcap, no window, a causal mask
only at Tq = Tk), SDPA's ``ms`` and ``device_ms`` on the same inputs. The
shapes: ``chip_smoke.py``'s ``FLASH_SHAPES`` in bf16 (the tensor-core
body), or with ``--dtype float32`` its ``ENCDEC_SHAPES`` (seamless's
encoder and cross-attention) in f32 (the CUDA-core body, SDPA in f32).
A shape the checkout's wrapper refuses prints ``"refused"``.
``--seamless`` then serves full-depth ``seamless_m4t_large_v2`` on
random weights at each request of ``chip_smoke.LEGACY_RUNS``: one line
each with its prefill ms (``chip_smoke.time_ms``) and the host loop's
step p50 / p99 over 32 greedy tokens of ``generate``. To compare two
versions of the kernel on one card, run both checkouts in one call, in
turns (parent, change, change, parent). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import kernel_tools


def seamless(smoke, row):
    """The host-loop numbers of full-depth seamless, one line a request."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.serve import generate
    cfg = get_config("seamless_m4t_large_v2")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    for n, T, dtype in dict(smoke.LEGACY_RUNS)["seamless_m4t_large_v2"]:
        prompt = rng.integers(0, cfg.vocab, (1, T)).astype(np.int32)
        frames = torch.from_numpy(rng.standard_normal(
            (1, n, cfg.frontend_dim)).astype(np.float32)).to(
            "cuda", getattr(torch, dtype))
        batch = {"tokens": torch.from_numpy(prompt).cuda(), "frames": frames}
        prefill = smoke.time_ms(lambda: lm.prefill(cfg, params, batch,
                                                   max_len=T + 32),
                                warmup=1, reps=3)
        steps = generate(cfg, params, prompt, max_new=32,
                         extras={"frames": frames}, device="cuda").step_times
        print(json.dumps(dict(
            row, model="seamless_m4t_large_v2", frames=n, prompt=T,
            frames_dtype=dtype, prefill_ms=prefill,
            step_p50_ms=1e3 * float(np.percentile(steps, 50)),
            step_p99_ms=1e3 * float(np.percentile(steps, 99)))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(kernel_tools.ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seamless", action="store_true")
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
    dt = getattr(torch, args.dtype)
    shapes = (smoke.FLASH_SHAPES if args.dtype == "bfloat16"
              else smoke.ENCDEC_SHAPES)
    for case in shapes:
        B, Hq, Hkv, Tq, Tk, D, causal, window, softcap = case
        q, k, v = (torch.randn(s, device="cuda", generator=gen).to(dt)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D),
                             (B, Hkv, Tk, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        row = dict(tag=args.tag, src=args.src, dtype=args.dtype,
                   shape=list(case))
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
    if args.seamless:
        seamless(smoke, dict(tag=args.tag, src=args.src))
    return 0


if __name__ == "__main__":
    sys.exit(main())
