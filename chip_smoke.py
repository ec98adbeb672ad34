#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then runs all three phases, always in full, and fails (nonzero exit, no
result line) on any mismatch:

1. **kernels** — each kernel against its plain PyTorch version on the
   card, at a ragged shape and at the shapes the training step gives it
   (XOR gathers bitwise; ``aggregate`` bitwise with one row per segment,
   rtol 1e-6 with several), timed with CUDA events beside its byte bound,
   its plain version and, where one PyTorch call computes the same
   function, that call;
2. **shuffle** — the coded shuffle of (q, k) in {(2,3), (3,3), (2,4)},
   both routers, bitwise equal to the same shuffle through the plain
   versions on the card and close to the numpy reference;
3. **train** — the slice's main path: ``MultiModelCAMRTrainer`` on
   the cell of ``repro_torch.launch.cell`` (``granite_3_2b`` at full
   width, cut to 2 layers, q=2, k=3: K=6 virtual workers, J=4 models),
   2 steps of ``camr_spmd`` on ``ShardedTokenPipeline(seq_len=512,
   global_batch=1)``, with the kernel
   launch counts of that run, step 1's synced gradient held bitwise
   against the plain-version shuffle of the same contributions on a
   column slice, and the step-time split and peak memory.

The last lines are the card's name and power limit, the ``kernels`` JSON
line and ``{"ok": true, "device": {...}}``. Needs one CUDA card, the
CUDA toolkit (``nvcc``) and the rest of this checkout; imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
DEVICE = "cuda"
SOURCES = {"xor_encode_gather": ("src/repro_torch/kernels/csrc/xor_gather.cu",
                                 "src/repro/kernels/xor_code.py:240"),
           "xor_decode_gather": ("src/repro_torch/kernels/csrc/xor_gather.cu",
                                 "src/repro/kernels/xor_code.py:309"),
           "aggregate": ("src/repro_torch/kernels/csrc/aggregate.cu",
                         "src/repro/kernels/aggregate.py:71")}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, *, warmup=2, reps=5):
    """Median milliseconds of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    """Largest elementwise difference: of the values for floats, of the
    32-bit words for the XOR lane's integer words."""
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def bitwise_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape:
        return False
    wa = a.contiguous().view(torch.int32) if a.element_size() == 4 else a
    wb = b.contiguous().view(torch.int32) if b.element_size() == 4 else b
    return bool(torch.equal(wa, wb))


@contextlib.contextmanager
def plain_codec():
    """Route the shuffle's codec through the plain versions (the
    comparison runs; no kernel launches)."""
    from repro_torch.core import collective
    from repro_torch.kernels import ref
    saved = collective.xor_encode_gather, collective.xor_decode_gather
    collective.xor_encode_gather = ref.xor_encode_gather_ref
    collective.xor_decode_gather = ref.xor_decode_gather_ref
    try:
        yield
    finally:
        collective.xor_encode_gather, collective.xor_decode_gather = saved


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #
def _rand_words(shape, gen):
    import torch
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device=DEVICE, generator=gen)


def _gather_bytes(idx, mask, pk, out_rows, recv_rows=0):
    """Bytes the gather must move: each valid source row and each
    selected recv row read once, each output row written once, plus the
    index tables."""
    valid = int(mask.sum())
    return (4 * pk * (valid + out_rows + recv_rows)
            + idx.numel() * 4 + mask.numel())


def check_gathers(gen, K, P, pk, n, m, p_valid=0.5):
    """Random chunks / indices / masks; encode and decode bitwise against
    the plain versions."""
    import torch
    from repro_torch.kernels import ref, xor_decode_gather, xor_encode_gather
    chunks = _rand_words((K, P, pk), gen)
    idx = torch.randint(0, P, (K, n, m), dtype=torch.int32, device=DEVICE,
                        generator=gen)
    mask = torch.rand((K, n, m), device=DEVICE, generator=gen) < p_valid
    idx = torch.where(mask, idx, 0)       # masked entries carry index 0
    enc = xor_encode_gather(chunks, idx, mask)
    if not bitwise_equal(enc, ref.xor_encode_gather_ref(chunks, idx, mask)):
        fail(f"xor_encode_gather != plain at K={K} P={P} pk={pk} n={n} m={m}")
    recv = _rand_words((K, n, pk), gen)
    rsel = torch.stack([torch.randperm(n, device=DEVICE, generator=gen)
                        for _ in range(K)]).to(torch.int32)
    dec = xor_decode_gather(recv, chunks, rsel, idx, mask)
    if not bitwise_equal(dec, ref.xor_decode_gather_ref(recv, chunks, rsel,
                                                        idx, mask)):
        fail(f"xor_decode_gather != plain at K={K} P={P} pk={pk} n={n} m={m}")


def phase_kernels(gen, tr):
    """At the shapes the trainer ``tr`` gives the kernels."""
    import torch
    from repro_torch.core.collective import make_plan, _device_tables
    from repro_torch.kernels import aggregate, ref, xor_decode_gather, \
        xor_encode_gather
    results = {}
    # ragged shapes: u32, u64 and u128 access paths, odd pk, dead rows
    for pk in (1001, 1002, 4096):
        check_gathers(gen, K=3, P=7, pk=pk, n=5, m=4)
    log("kernels: XOR gathers bitwise at ragged shapes (pk 1001/1002/4096)")

    # the training step's shapes: stage 1 of (q, k) at the model's d_shard
    q, k, d_shard = tr.q, tr.k, tr.d_shard
    plan = make_plan(q, k, d_shard)
    K, pk = plan.K, d_shard // (k - 1)
    st = _device_tables(plan, torch.device(DEVICE), "all_to_all")["stages"][1]
    P = plan.J_own * (k - 1) * K * (k - 1)
    chunks = _rand_words((K, P, pk), gen)
    enc_idx, enc_ok = st["enc_src"], st["src_ok"]
    enc = xor_encode_gather(chunks, enc_idx, enc_ok)
    want = ref.xor_encode_gather_ref(chunks, enc_idx, enc_ok)
    if not bitwise_equal(enc, want):
        fail("xor_encode_gather != plain at the step's shape")
    enc_err = max_abs_err(enc, want)
    del enc, want
    rows = st["dec_recv"].shape[1]
    recv = _rand_words((K, rows, pk), gen)
    dargs = (recv, chunks, st["dec_recv"], st["dec_src"], st["dec_mask"])
    dec = xor_decode_gather(*dargs)
    want = ref.xor_decode_gather_ref(*dargs)
    if not bitwise_equal(dec, want):
        fail("xor_decode_gather != plain at the step's shape")
    dec_err = max_abs_err(dec, want)
    del dec, want
    log(f"kernels: XOR gathers bitwise at the step's shape (K={K} P={P} "
        f"pk={pk} n={st['n']} rows={rows})")
    enc_bytes = _gather_bytes(enc_idx, enc_ok, pk, K * st["n"])
    dec_bytes = _gather_bytes(st["dec_src"], st["dec_mask"], pk, K * rows,
                              recv_rows=K * rows) + st["dec_recv"].numel() * 4
    results["xor_encode_gather"] = dict(
        ms=time_ms(lambda: xor_encode_gather(chunks, enc_idx, enc_ok)),
        plain_ms=time_ms(lambda: ref.xor_encode_gather_ref(chunks, enc_idx,
                                                           enc_ok),
                         warmup=1, reps=3),
        bytes=enc_bytes, library_ms=None, max_abs_err=enc_err,
        shape=f"chunks [{K},{P},{pk}] u32, idx/mask [{K},{st['n']},{k}]")
    results["xor_decode_gather"] = dict(
        ms=time_ms(lambda: xor_decode_gather(*dargs)),
        plain_ms=time_ms(lambda: ref.xor_decode_gather_ref(*dargs),
                         warmup=1, reps=3),
        bytes=dec_bytes, library_ms=None, max_abs_err=dec_err,
        shape=f"recv [{K},{rows},{pk}], idx/mask [{K},{rows},{k}]")
    del chunks, recv, dargs
    torch.cuda.empty_cache()

    # aggregate: several rows per segment with padding ids, then the
    # step's shape (one row per segment, bit-exact)
    vals = torch.randn((12, 100_003), device=DEVICE, generator=gen)
    ids = torch.tensor([2, 0, 2, -1, 1, 0, 5, 2, 1, 3, -1, 0],
                       dtype=torch.int32, device=DEVICE)
    got, want = aggregate(vals, ids, 4), ref.aggregate_ref(vals, ids, 4)
    if not torch.allclose(got, want, rtol=1e-6, atol=0):
        fail("aggregate != plain (rtol 1e-6) with several rows per segment")
    S = plan.J_own * (k - 1)
    Dpad = K * d_shard
    vals = torch.randn((S, Dpad), device=DEVICE, generator=gen)
    ids = torch.arange(S, dtype=torch.int32, device=DEVICE)
    got, want = aggregate(vals, ids, S), ref.aggregate_ref(vals, ids, S)
    if not bitwise_equal(got, want):
        fail("aggregate != plain (bitwise) with one row per segment")
    err = max_abs_err(got, want)
    del got, want
    log(f"kernels: aggregate bitwise at the step's shape [{S},{Dpad}], "
        "rtol 1e-6 with several rows per segment")
    ids64 = ids.long()
    results["aggregate"] = dict(
        ms=time_ms(lambda: aggregate(vals, ids, S)),
        plain_ms=time_ms(lambda: ref.aggregate_ref(vals, ids, S),
                         warmup=1, reps=3),
        library_ms=time_ms(lambda: torch.zeros((S, Dpad), device=DEVICE)
                           .index_add_(0, ids64, vals)),
        bytes=2 * S * Dpad * 4 + S * 4, max_abs_err=err,
        shape=f"values [{S},{Dpad}] f32, {S} segments")
    del vals
    torch.cuda.empty_cache()
    for name, r in results.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"kernels: {name} {r['shape']}: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.3f} ms)")
    return results


# --------------------------------------------------------------------- #
# phase 2: the coded shuffle on the card
# --------------------------------------------------------------------- #
def phase_shuffle():
    import numpy as np
    import torch
    from repro_torch.core.collective import (camr_shuffle,
                                             camr_shuffle_reference,
                                             make_plan,
                                             scatter_contributions)
    for q, k in ((2, 3), (3, 3), (2, 4)):
        d = (k - 1) * 30_011                        # odd packets
        plan = make_plan(q, k, d)
        rng = np.random.default_rng(q * 10 + k)
        bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
        contribs = torch.from_numpy(scatter_contributions(plan, bg)).to(DEVICE)
        ref = camr_shuffle_reference(plan, bg)
        for router in ("all_to_all", "ppermute"):
            out = camr_shuffle(plan, contribs, router=router)
            with plain_codec():
                plain = camr_shuffle(plan, contribs, router=router)
            if not bitwise_equal(out, plain):
                fail(f"shuffle ({q},{k}) {router}: kernels != plain")
            if not np.allclose(out.cpu().numpy(), ref, rtol=2e-5, atol=2e-6):
                fail(f"shuffle ({q},{k}) {router}: not close to reference")
        log(f"shuffle: (q,k)=({q},{k}) d={d} both routers bitwise == plain, "
            "allclose to the reference")


# --------------------------------------------------------------------- #
# phase 3: the slice's main path
# --------------------------------------------------------------------- #
def build_cell():
    """The slice's trainer and pipeline (``repro_torch.launch.cell``)."""
    import torch
    from repro_torch.launch.cell import make_cell
    t0 = time.perf_counter()
    tr, pipe = make_cell(DEVICE)
    torch.cuda.synchronize()
    log(f"train: {tr.cfg.name} {tr.cfg.n_layers} layers, D={tr.D} "
        f"Dpad={tr.Dpad} d_shard={tr.d_shard}, K={tr.K} J={tr.J}, seq_len "
        f"{pipe.seq_len}, init {time.perf_counter() - t0:.1f} s")
    return tr, pipe


def phase_train(tr, pipe, steps=2):
    import numpy as np
    import torch
    from repro_torch.core.collective import camr_shuffle, make_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    q, k = tr.q, tr.k

    # step 1's synced gradient on a column slice (the codec is per value
    # column): one slice at the head, one across the packet boundary
    pk = tr.d_shard // (k - 1)
    w = min(1 << 16, pk // 2)
    cols = torch.cat([torch.arange(0, w), torch.arange(pk - w, pk + w)]
                     ).to(DEVICE)
    captured = {}
    sync = tr._sync_spmd

    def capture(contribs, report):
        out = sync(contribs, report)
        if not captured:
            captured["contribs"] = contribs.index_select(4, cols)
            captured["out"] = out.index_select(2, cols)
        return out

    tr._sync_spmd = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = tr.train_steps(pipe, steps, mode="camr_spmd")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"xor_encode_gather": 2 * steps, "xor_decode_gather": 2 * steps,
            "aggregate": tr.K * steps}
    if counts != want:
        fail(f"launch counts {counts} != expected {want}")
    losses = np.asarray(rep.losses)
    if losses.shape != (steps, tr.J) or not np.isfinite(losses).all():
        fail(f"losses not finite: {rep.losses}")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        fail(f"peak memory {peak} >= card memory {total}")
    log(f"train: losses {rep.losses}")
    log(f"train: launches {counts} over {steps} steps")
    for i, ms in enumerate(rep.phase_ms):
        log(f"train: step {i + 1} {sum(ms.values()):.1f} ms = " + ", ".join(
            f"{p} {v:.1f}" for p, v in ms.items()))
    log(f"train: {steps} steps {wall:.2f} s wall, peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) of {total / 1e9:.1f} GB")

    plan = make_plan(q, k, captured["contribs"].shape[-1])
    with plain_codec():
        plain = camr_shuffle(plan, captured["contribs"])
    if not bitwise_equal(captured["out"], plain):
        fail("step 1 synced gradient != plain-version shuffle of the same "
             "contributions")
    log(f"train: step 1 synced gradient bitwise == plain shuffle on "
        f"{cols.numel()} of {tr.d_shard} columns per shard")
    return counts, rep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s ({_build.build_dir()})")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    tr, pipe = build_cell()     # its d_shard sets the kernels' shapes
    results = phase_kernels(gen, tr)
    phase_shuffle()
    counts, _ = phase_train(tr, pipe)

    kernels = []
    for name, r in results.items():
        src, replaces = SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=r["library_ms"]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
