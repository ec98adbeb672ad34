"""Serving launcher of the port — the multi-tenant front door.

The default path is the continuous-batching :class:`DecodeEngine` +
:class:`ServeStream` (one engine per arch, requests interleaved across
waves); ``--legacy`` takes the host-loop ``serve_legacy`` path. Both
run the self-healing knobs of DESIGN.md §15 (per-request deadlines,
bounded admission with load-shedding, and on the engine path supervised
wave retry) and report the same terminal statuses. Runs on the current
CUDA device unless ``--device`` says otherwise (``--device cpu`` runs
the plain versions, best with ``--reduced``):

    # one model, engine path, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --archs gemma2_2b \\
        --reduced --device cpu --requests 8 --max-new 16

    # multi-tenant: two models share the stream
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --archs gemma2_2b,granite_3_2b --reduced --device cpu --requests 8

    # self-healing policy: deadlines + bounded queue + wave retry
    PYTHONPATH=src python -m repro_torch.launch.serve --archs gemma2_2b \\
        --reduced --device cpu --requests 16 --deadline-s 5 \\
        --max-queue 8 --wave-timeout-s 30 --max-retries 2

    # legacy host loop (same status accounting)
    PYTHONPATH=src python -m repro_torch.launch.serve --archs gemma2_2b \\
        --reduced --device cpu --legacy --requests 4

    # the SSM family (mamba2: the ssd_scan kernel on every prefill)
    PYTHONPATH=src python -m repro_torch.launch.serve --archs mamba2_1p3b \\
        --reduced --device cpu

    # the hybrid family (zamba2: ssd_scan and flash_attention on every
    # prefill, one shared attention block)
    PYTHONPATH=src python -m repro_torch.launch.serve --archs zamba2_2p7b \\
        --reduced --device cpu

    # the MoE family (top-k experts in place of the MLP)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --archs moonshot_v1_16b_a3b --reduced --device cpu

    # the enc-dec family (audio frames) and the ViT frontend (patches):
    # the legacy host loop only
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --archs seamless_m4t_large_v2,internvl2_26b --reduced \\
        --device cpu --legacy --requests 4

Parameters are the port's ``init_params`` from seed 0; every arch of
``repro_torch.configs.ARCHS`` is served. With ``--legacy`` an enc-dec
model takes f32 ``frames [1, prompt-len, frontend_dim]`` and a ViT one
f32 ``patches [1, frontend_len, frontend_dim]``, drawn from the seed as
the JAX launcher draws them; a ViT prompt is at least ``frontend_len``
tokens long (the port refuses a shorter one, which JAX's ``_embed``
would silently cut to the patches). Without ``--legacy`` both are
refused, as in the JAX launcher: ``DecodeEngine`` does not serve them.
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.serve import (DecodeEngine, Request, ServeStream,
                                       serve_legacy)


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def _status_line(results) -> str:
    counts = Counter(r.status for r in results)
    return " ".join(f"{k}={v}" for k, v in sorted(counts.items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", required=True,
                    help="comma-separated arch names (multi-tenant when "
                         "more than one)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per arch")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length (ragged: 1..prompt-len)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos", type=int, default=None)
    ap.add_argument("--legacy", action="store_true",
                    help="host-loop serve_legacy() instead of the engine")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--wave", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    # self-healing policy knobs (DESIGN.md §15)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget; past it the "
                         "request terminates 'expired' with its clean "
                         "prefix")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue per model; overflow "
                         "is load-shed at submission")
    ap.add_argument("--shed-policy", choices=("newest", "oldest"),
                    default="newest")
    ap.add_argument("--wave-timeout-s", type=float, default=None,
                    help="a wave slower than this is discarded and "
                         "replayed from the snapshot (engine path)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="wave retry budget before giving up")
    ap.add_argument("--retry-backoff-s", type=float, default=0.0,
                    help="base backoff between wave retries (doubles "
                         "per attempt)")
    args = ap.parse_args(argv)

    names = [a.strip() for a in args.archs.split(",") if a.strip()]
    for a in names:
        if a not in ARCHS:
            ap.error(f"unknown arch {a!r} (choose from {ARCHS})")
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    cfgs, params = {}, {}
    for a in names:
        cfg = get_config(a)
        cfgs[a] = reduced(cfg) if args.reduced else cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params[a] = lm.init_params(cfgs[a], gen)

    def requests_for(a):
        out = []
        lo = cfgs[a].frontend_len if cfgs[a].frontend == "vit" else 1
        for i in range(args.requests):
            T = int(rng.integers(lo, max(args.prompt_len, lo) + 1))
            prompt = rng.integers(0, cfgs[a].vocab, (T,)).astype(np.int32)
            out.append(Request(prompt=prompt, max_new=args.max_new,
                               eos=args.eos, temperature=args.temperature,
                               seed=i, deadline_s=args.deadline_s))
        return out

    if args.legacy:
        total = tot_time = 0
        all_results = []
        for a in names:
            cfg = cfgs[a]
            extras = {}
            if cfg.frontend == "vit":
                extras["patches"] = rng.standard_normal(
                    (1, cfg.frontend_len, cfg.frontend_dim)).astype(
                    np.float32)
            if cfg.frontend == "audio":
                extras["frames"] = rng.standard_normal(
                    (1, args.prompt_len, cfg.frontend_dim)).astype(
                    np.float32)
            t0 = time.perf_counter()
            results = serve_legacy(cfg, params[a], requests_for(a),
                                   max_queue=args.max_queue,
                                   shed_policy=args.shed_policy,
                                   extras=extras or None, model=a,
                                   device=device)
            dt = time.perf_counter() - t0
            tot_time += dt
            toks = sum(r.emitted for r in results)
            total += toks
            all_results.extend(results)
            print(f"{a}: {args.requests} reqs (legacy host loop) "
                  f"{toks} tokens in {dt:.2f}s, "
                  f"status: {_status_line(results)}")
        print(f"legacy: {total} tokens in {tot_time:.2f}s "
              f"({total / max(tot_time, 1e-9):.1f} tok/s), "
              f"status: {_status_line(all_results)}")
        return

    for a in names:
        if cfgs[a].family == "encdec" or cfgs[a].frontend:
            ap.error(f"{a}: enc-dec/frontend archs need --legacy")
    engines = {
        a: DecodeEngine(cfgs[a], params[a], slots=args.slots,
                        page_size=args.page_size,
                        max_ctx=args.prompt_len + args.max_new,
                        max_new_cap=args.max_new, name=a, device=device)
        for a in names}
    stream = ServeStream(engines, wave_len=args.wave,
                         max_queue=args.max_queue,
                         shed_policy=args.shed_policy,
                         wave_timeout_s=args.wave_timeout_s,
                         max_retries=args.max_retries,
                         retry_backoff_s=args.retry_backoff_s)
    jobs = [(a, req) for a in names for req in requests_for(a)]
    t0 = time.perf_counter()
    results = stream.run(jobs)
    dt = time.perf_counter() - t0
    rep = stream.last_report
    toks = sum(r.emitted for r in results)
    per_tok = [s[1] / max(1, s[2]) for s in rep.wave_stats]
    print(f"engine: {len(results)} reqs / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {device}, {rep.waves} waves, "
          f"occupancy {rep.occupancy:.2f}, "
          f"step p50={1e3 * _percentile(per_tok, 50):.2f}ms "
          f"p99={1e3 * _percentile(per_tok, 99):.2f}ms, "
          f"kernel builds/loads during run: {rep.traces}")
    print(f"status: {_status_line(results)}, wave retries: "
          f"{rep.retries}, recovery {rep.recovery_s * 1e3:.1f}ms")
    for r in results[:4]:
        print(f"  [{r.model}#{r.index}] +{r.emitted} ({r.status}): "
              f"{r.generated}")


if __name__ == "__main__":
    main()
