#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then runs all three phases, always in full, and fails (nonzero exit, no
result line) on any mismatch:

1. **kernels** — each kernel against its plain PyTorch version on the
   card, at ragged shapes and at the shapes the training step gives it
   (XOR gathers, u32 words and u16 lanes, bitwise; ``aggregate`` and
   ``aggregate_bf16`` bitwise with one row per segment, rtol 1e-6 / one
   bf16 ulp with several), timed with CUDA events beside its byte bound,
   its plain version and, where one PyTorch call computes the same
   function, that call;
2. **shuffle** — the coded shuffle of (q, k) in {(2,3), (3,3), (2,4)},
   both routers, bitwise equal to the same shuffle through the plain
   versions on the card: f32 (and close to the numpy reference), and the
   packed 16-bit lane in bf16 and f16;
3. **train** — the main path, on each grad-sync lane in turn:
   ``MultiModelCAMRTrainer`` on the cell of ``repro_torch.launch.cell``
   (``granite_3_2b`` at full width, cut to 2 layers, q=2, k=3: K=6
   virtual workers, J=4 models), 2 steps of ``camr_spmd`` on
   ``ShardedTokenPipeline(seq_len=512, global_batch=1)``, first with f32
   grad sync, then with bf16 (the f32 trainer freed first). Each run has
   its kernel launch counts (counters set to 0 just before it), step 1's
   synced gradient held bitwise against the plain-version shuffle of the
   same contributions on a column slice, the step-time split and its own
   peak memory. The bf16 run also holds step 1's losses to the f32 run's
   (same parameters and data, the map runs before any sync), its wire
   bytes to exactly half and its peak memory below the f32 run's.

The last lines are the card's name and power limit, the ``kernels`` JSON
line and ``{"ok": true, "device": {...}}``. Needs one CUDA card, the
CUDA toolkit (``nvcc``) and the rest of this checkout; imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import gc
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
_GATHER = "src/repro_torch/kernels/csrc/xor_gather.cu"
_AGG = "src/repro_torch/kernels/csrc/aggregate.cu"
SOURCES = {"xor_encode_gather": (_GATHER, "src/repro/kernels/xor_code.py:240"),
           "xor_decode_gather": (_GATHER, "src/repro/kernels/xor_code.py:309"),
           "aggregate": (_AGG, "src/repro/kernels/aggregate.py:71"),
           "xor_encode_gather16": (_GATHER,
                                   "src/repro/kernels/xor_code.py:371"),
           "xor_decode_gather16": (_GATHER,
                                   "src/repro/kernels/xor_code.py:415"),
           "aggregate_bf16": (_AGG, "src/repro/kernels/aggregate.py:71")}


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
    32-bit words or 16-bit lanes for the XOR lanes' integers."""
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def _bits(t):
    import torch
    words = {4: torch.int32, 2: torch.int16}.get(t.element_size())
    return t.contiguous().view(words) if words else t


def bitwise_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(_bits(a), _bits(b)))


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 values (ulps) between two bf16 tensors of
    finite values: bit patterns mapped to integers in value order."""
    import torch

    def ordered(t):
        x = _bits(t).long()
        return torch.where(x < 0, -(x & 0x7FFF), x)
    return int((ordered(a) - ordered(b)).abs().max())


_CODEC = ("xor_encode_gather", "xor_decode_gather", "xor_encode_gather16",
          "xor_decode_gather16")


@contextlib.contextmanager
def plain_codec():
    """Route the shuffle's codec through the plain versions (the
    comparison runs; no kernel launches)."""
    from repro_torch.core import collective
    from repro_torch.kernels import ref
    saved = {name: getattr(collective, name) for name in _CODEC}
    for name in _CODEC:
        setattr(collective, name, getattr(ref, name + "_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(collective, name, fn)


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #
def _lane(half: bool):
    """(encode, decode, encode plain, decode plain, element dtype) of the
    u32 word lane or the packed 16-bit lane."""
    import torch
    from repro_torch.kernels import (ref, xor_decode_gather,
                                     xor_decode_gather16, xor_encode_gather,
                                     xor_encode_gather16)
    if half:
        return (xor_encode_gather16, xor_decode_gather16,
                ref.xor_encode_gather16_ref, ref.xor_decode_gather16_ref,
                torch.int16)
    return (xor_encode_gather, xor_decode_gather, ref.xor_encode_gather_ref,
            ref.xor_decode_gather_ref, torch.int32)


def _rand_bits(shape, gen, dtype, offset=0):
    """Random bit patterns of ``dtype`` (int32 words or int16 lanes); a
    nonzero ``offset`` starts the tensor that many elements into its
    buffer, so its rows lose their natural alignment."""
    import torch
    hi = 2 ** (8 * torch.empty((), dtype=dtype).element_size() - 1)
    n = 1
    for x in shape:
        n *= x
    flat = torch.randint(-hi, hi, (n + offset,), dtype=dtype, device=DEVICE,
                         generator=gen)
    return flat[offset:].view(shape)


def _gather_bytes(idx, mask, row_bytes, out_rows, recv_rows=0):
    """Bytes the gather must move: each valid source row and each
    selected recv row read once, each output row written once, plus the
    index tables."""
    valid = int(mask.sum())
    return (row_bytes * (valid + out_rows + recv_rows)
            + idx.numel() * 4 + mask.numel())


def check_gathers(gen, K, P, row, n, m, half=False, offset=0, p_valid=0.5):
    """Random chunks / indices / masks; encode and decode bitwise against
    the plain versions."""
    import torch
    enc_fn, dec_fn, enc_ref, dec_ref, dtype = _lane(half)
    chunks = _rand_bits((K, P, row), gen, dtype, offset)
    idx = torch.randint(0, P, (K, n, m), dtype=torch.int32, device=DEVICE,
                        generator=gen)
    mask = torch.rand((K, n, m), device=DEVICE, generator=gen) < p_valid
    idx = torch.where(mask, idx, 0)       # masked entries carry index 0
    where = f"K={K} P={P} row={row} n={n} m={m} offset={offset}"
    if not bitwise_equal(enc_fn(chunks, idx, mask),
                         enc_ref(chunks, idx, mask)):
        fail(f"{enc_fn.__name__} != plain at {where}")
    recv = _rand_bits((K, n, row), gen, dtype, offset)
    rsel = torch.stack([torch.randperm(n, device=DEVICE, generator=gen)
                        for _ in range(K)]).to(torch.int32)
    if not bitwise_equal(dec_fn(recv, chunks, rsel, idx, mask),
                         dec_ref(recv, chunks, rsel, idx, mask)):
        fail(f"{dec_fn.__name__} != plain at {where}")


def step_gathers(gen, st, K, P, row, half):
    """Both gathers of one lane at the training step's shape (stage 1's
    tables): bitwise against the plain versions, then timed."""
    enc_fn, dec_fn, enc_ref, dec_ref, dtype = _lane(half)
    esize = 2 if half else 4
    chunks = _rand_bits((K, P, row), gen, dtype)
    eargs = (chunks, st["enc_src"], st["src_ok"])
    enc, want = enc_fn(*eargs), enc_ref(*eargs)
    if not bitwise_equal(enc, want):
        fail(f"{enc_fn.__name__} != plain at the step's shape")
    enc_err = max_abs_err(enc, want)
    del enc, want
    rows = st["dec_recv"].shape[1]
    recv = _rand_bits((K, rows, row), gen, dtype)
    dargs = (recv, chunks, st["dec_recv"], st["dec_src"], st["dec_mask"])
    dec, want = dec_fn(*dargs), dec_ref(*dargs)
    if not bitwise_equal(dec, want):
        fail(f"{dec_fn.__name__} != plain at the step's shape")
    dec_err = max_abs_err(dec, want)
    del dec, want
    kind = "u16 lanes" if half else "u32 words"
    log(f"kernels: {enc_fn.__name__} / {dec_fn.__name__} bitwise at the "
        f"step's shape (K={K} P={P} row={row} {kind}, n={st['n']} "
        f"rows={rows})")
    rb = row * esize
    enc_bytes = _gather_bytes(eargs[1], eargs[2], rb, K * st["n"])
    dec_bytes = (_gather_bytes(st["dec_src"], st["dec_mask"], rb, K * rows,
                               recv_rows=K * rows)
                 + st["dec_recv"].numel() * 4)
    out = {
        enc_fn.__name__: dict(
            ms=time_ms(lambda: enc_fn(*eargs)),
            plain_ms=time_ms(lambda: enc_ref(*eargs), warmup=1, reps=3),
            bytes=enc_bytes, library_ms=None, max_abs_err=enc_err,
            shape=f"chunks [{K},{P},{row}] {kind}, idx/mask "
                  f"[{K},{st['n']},{eargs[1].shape[2]}]"),
        dec_fn.__name__: dict(
            ms=time_ms(lambda: dec_fn(*dargs)),
            plain_ms=time_ms(lambda: dec_ref(*dargs), warmup=1, reps=3),
            bytes=dec_bytes, library_ms=None, max_abs_err=dec_err,
            shape=f"recv [{K},{rows},{row}] {kind}, idx/mask "
                  f"[{K},{rows},{dargs[3].shape[2]}]")}
    return out


def check_aggregate(gen, S, Dpad, dtype):
    """``aggregate`` on ``dtype`` values: several rows per segment with
    padding ids (rtol 1e-6 in f32, one ulp in bf16), then the step's
    shape with one row per segment (bitwise), timed."""
    import torch
    from repro_torch.kernels import aggregate, ref
    name = "aggregate" if dtype == torch.float32 else "aggregate_bf16"
    vals = torch.randn((12, 100_003), device=DEVICE, generator=gen).to(dtype)
    ids = torch.tensor([2, 0, 2, -1, 1, 0, 5, 2, 1, 3, -1, 0],
                       dtype=torch.int32, device=DEVICE)
    got, want = aggregate(vals, ids, 4), ref.aggregate_ref(vals, ids, 4)
    if dtype == torch.float32:
        if not torch.allclose(got, want, rtol=1e-6, atol=0):
            fail(f"{name} != plain (rtol 1e-6) with several rows per "
                 "segment")
        several = "rtol 1e-6"
    else:
        ulps = bf16_ulps(got, want)
        if ulps > 1:
            fail(f"{name} != plain ({ulps} ulps) with several rows per "
                 "segment")
        several = f"{ulps} ulp (limit 1)"
    vals = torch.randn((S, Dpad), device=DEVICE, generator=gen).to(dtype)
    ids = torch.arange(S, dtype=torch.int32, device=DEVICE)
    got, want = aggregate(vals, ids, S), ref.aggregate_ref(vals, ids, S)
    if not bitwise_equal(got, want):
        fail(f"{name} != plain (bitwise) with one row per segment")
    err = max_abs_err(got, want)
    del got, want
    log(f"kernels: {name} bitwise at the step's shape [{S},{Dpad}], "
        f"{several} with several rows per segment")
    ids64 = ids.long()
    esize = vals.element_size()
    res = dict(
        ms=time_ms(lambda: aggregate(vals, ids, S)),
        plain_ms=time_ms(lambda: ref.aggregate_ref(vals, ids, S),
                         warmup=1, reps=3),
        library_ms=time_ms(lambda: torch.zeros((S, Dpad), dtype=dtype,
                                               device=DEVICE)
                           .index_add_(0, ids64, vals)),
        bytes=2 * S * Dpad * esize + S * 4, max_abs_err=err,
        shape=f"values [{S},{Dpad}] {str(dtype)[6:]}, {S} segments")
    del vals
    torch.cuda.empty_cache()
    return {name: res}


def phase_kernels(gen, tr):
    """At the shapes the trainer ``tr`` gives the kernels, on both lanes
    (the tables are lane-independent; the row width is not)."""
    import torch
    from repro_torch.core.collective import make_plan, _device_tables
    from repro_torch.core.schedule import payload_words
    results = {}
    # ragged shapes: u32, u64 and u128 access paths, odd pk, dead rows
    for pk in (1001, 1002, 4096):
        check_gathers(gen, K=3, P=7, row=pk, n=5, m=4)
    log("kernels: XOR gathers bitwise at ragged shapes (pk 1001/1002/4096)")
    # 16-bit lanes: the 4-, 8- and 16-byte paths, rows of mixed 16-byte
    # phases (1002, 2004), and the 2-byte path (a one-lane offset)
    for lanes, offset in ((2, 0), (1002, 0), (2004, 0), (4096, 0),
                          (4096, 1), (1002, 1)):
        check_gathers(gen, K=3, P=7, row=lanes, n=5, m=4, half=True,
                      offset=offset)
    log("kernels: 16-bit XOR gathers bitwise at ragged lane counts "
        "(2/1002/2004/4096, and 4096/1002 one lane off alignment)")

    # the training step's shapes: stage 1 of (q, k) at the model's d_shard
    q, k, d_shard = tr.q, tr.k, tr.d_shard
    plan = make_plan(q, k, d_shard)
    K = plan.K
    st = _device_tables(plan, torch.device(DEVICE), "all_to_all")["stages"][1]
    P = plan.J_own * (k - 1) * K * (k - 1)
    results.update(step_gathers(gen, st, K, P, d_shard // (k - 1),
                                half=False))
    torch.cuda.empty_cache()
    lanes = 2 * (payload_words(d_shard, 2, k) // (k - 1))
    results.update(step_gathers(gen, st, K, P, lanes, half=True))
    torch.cuda.empty_cache()

    S = plan.J_own * (k - 1)
    for dtype in (torch.float32, torch.bfloat16):
        results.update(check_aggregate(gen, S, K * d_shard, dtype))
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
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            c = contribs.to(dtype)                  # normal values
            for router in ("all_to_all", "ppermute"):
                out = camr_shuffle(plan, c, router=router)
                with plain_codec():
                    plain = camr_shuffle(plan, c, router=router)
                if out.dtype != dtype or not bitwise_equal(out, plain):
                    fail(f"shuffle ({q},{k}) {dtype} {router}: kernels != "
                         "plain")
                if not torch.isfinite(out).all():
                    fail(f"shuffle ({q},{k}) {dtype} {router}: not finite")
                if dtype == torch.float32 and not np.allclose(
                        out.cpu().numpy(), ref, rtol=2e-5, atol=2e-6):
                    fail(f"shuffle ({q},{k}) {router}: not close to "
                         "reference")
        log(f"shuffle: (q,k)=({q},{k}) d={d} both routers bitwise == plain "
            "in f32 (allclose to the reference), bf16 and f16")


# --------------------------------------------------------------------- #
# phase 3: the slice's main path
# --------------------------------------------------------------------- #
def build_cell(grad_sync_dtype):
    """The slice's trainer and pipeline (``repro_torch.launch.cell``) on
    one grad-sync lane."""
    import torch
    from repro_torch.launch.cell import make_cell
    t0 = time.perf_counter()
    tr, pipe = make_cell(DEVICE, grad_sync_dtype)
    torch.cuda.synchronize()
    log(f"train[{grad_sync_dtype}]: {tr.cfg.name} {tr.cfg.n_layers} layers, "
        f"D={tr.D} Dpad={tr.Dpad} d_shard={tr.d_shard}, K={tr.K} J={tr.J}, "
        f"seq_len {pipe.seq_len}, init {time.perf_counter() - t0:.1f} s")
    return tr, pipe


def lane_kernels(lane: str, K: int) -> dict:
    """Kernel launches per step on a grad-sync lane: one encode and one
    decode per coded stage, one combiner launch per worker."""
    names = {"float32": ("xor_encode_gather", "xor_decode_gather",
                         "aggregate"),
             "bfloat16": ("xor_encode_gather16", "xor_decode_gather16",
                          "aggregate_bf16")}[lane]
    return dict(zip(names, (2, 2, K)))


def phase_train(tr, pipe, steps=2):
    """``steps`` steps of the main path on the trainer's lane, with the
    launch counts of that run alone; returns (counts, report, peak)."""
    import numpy as np
    import torch
    from repro_torch.core.collective import camr_shuffle, make_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    q, k, lane = tr.q, tr.k, tr.grad_sync_dtype
    tag = f"train[{lane}]"

    # step 1's synced gradient on a column slice (the codec is per value
    # column): one slice at the head, one across the packet boundary
    pk = tr.d_shard // (k - 1)
    w = min(1 << 16, pk // 2) // (k - 1) * (k - 1)    # (k-1) | 3w
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
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = tr.train_steps(pipe, steps, mode="camr_spmd")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        del tr._sync_spmd               # no reference cycle keeps tr alive
    want = dict.fromkeys(counts, 0)
    want.update({n: c * steps for n, c in lane_kernels(lane, tr.K).items()})
    if counts != want:
        fail(f"{tag}: launch counts {counts} != expected {want}")
    losses = np.asarray(rep.losses)
    if losses.shape != (steps, tr.J) or not np.isfinite(losses).all():
        fail(f"{tag}: losses not finite: {rep.losses}")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        fail(f"{tag}: peak memory {peak} >= card memory {total}")
    log(f"{tag}: losses {rep.losses}")
    log(f"{tag}: launches {counts} over {steps} steps")
    for i, ms in enumerate(rep.phase_ms):
        log(f"{tag}: step {i + 1} {sum(ms.values()):.1f} ms = " + ", ".join(
            f"{p} {v:.1f}" for p, v in ms.items()))
    log(f"{tag}: {steps} steps {wall:.2f} s wall, peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) of {total / 1e9:.1f} "
        f"GB, wire bytes {rep.bytes_total} ({rep.bytes_total // steps} per "
        "step)")

    plan = make_plan(q, k, captured["contribs"].shape[-1])
    with plain_codec():
        plain = camr_shuffle(plan, captured["contribs"])
    if (captured["out"].dtype != getattr(torch, lane)
            or not bitwise_equal(captured["out"], plain)):
        fail(f"{tag}: step 1 synced gradient != plain-version shuffle of "
             "the same contributions")
    log(f"{tag}: step 1 synced gradient ({lane}) bitwise == plain shuffle "
        f"on {cols.numel()} of {tr.d_shard} columns per shard")
    return counts, rep, peak


def compare_lanes(rep32, peak32, rep16, peak16):
    """The bf16 run against the f32 run of the same cell."""
    import numpy as np
    l32, l16 = np.asarray(rep32.losses[0]), np.asarray(rep16.losses[0])
    if not np.allclose(l16, l32, rtol=1e-6, atol=0):
        fail(f"train: bf16 step 1 losses {l16} != f32 step 1 {l32} "
             "(rtol 1e-6)")
    log(f"train: bf16 step 1 losses == f32 step 1 within rtol 1e-6 "
        f"(bitwise: {bool((l16 == l32).all())})")
    if 2 * rep16.bytes_total != rep32.bytes_total:
        fail(f"train: bf16 wire bytes {rep16.bytes_total} are not half of "
             f"f32's {rep32.bytes_total}")
    if peak16 >= peak32:
        fail(f"train: bf16 peak memory {peak16} not below f32's {peak32}")
    log(f"train: bf16/f32 wire bytes {rep16.bytes_total}/"
        f"{rep32.bytes_total} = 0.5 exactly; peak memory "
        f"{peak16 / 1e9:.2f} GB < {peak32 / 1e9:.2f} GB")


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
    tr, pipe = build_cell("float32")   # its d_shard sets the kernels' shapes
    results = phase_kernels(gen, tr)
    phase_shuffle()
    counts, rep32, peak32 = phase_train(tr, pipe)
    del tr, pipe                       # the bf16 cell's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    tr, pipe = build_cell("bfloat16")
    counts16, rep16, peak16 = phase_train(tr, pipe)
    compare_lanes(rep32, peak32, rep16, peak16)
    for name in lane_kernels("bfloat16", tr.K):
        counts[name] = counts16[name]

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
