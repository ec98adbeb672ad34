#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then runs all six phases, always in full, and fails (nonzero exit, no
result line) on any mismatch:

1. **kernels** — each kernel against its plain PyTorch version on the
   card, at ragged shapes and at the shapes the training step gives it
   (XOR gathers, u32 words and u16 lanes, and the dense XOR folds of the
   multipass codec, bitwise; ``aggregate`` and ``aggregate_bf16``
   bitwise with one row per segment, rtol 1e-6 / one bf16 ulp with
   several), ``flash_attention`` within 2e-5 (f32) / 2e-2 (bf16) of its
   plain version at every ``ATTN_CASES`` shape of tests/test_kernels.py,
   and within two bf16 ulps of each output (rtol 2**-6, atol 1e-5) at
   the serving prefills' shapes (granite: 32/8 heads, D 64,
   Tq = Tk in {129, 1000, 1024, 2048}; gemma2: 8/4 heads, D 256, softcap
   50, window 4096, Tq = Tk in {1000, 5000}; zamba2: 32/32 heads, D 80,
   Tq = Tk in {77, 129, 1024}; moonshot: 16/16 heads, D 128, Tq = Tk in
   {129, 1024}; mixtral: 32/8 heads, D 128, window 4096, Tq = Tk in
   {1024, 5000}; internlm2: 48/8 heads, D 128, Tq = Tk = 1024;
   seamless: 16/16 heads, D 64, non-causal, its encoder at 1000 frames,
   its cross-attention prefill at 4 x 1000 and 513 x 257 (Tq > Tk) and
   its cross-attention decode at 1 x 1000, also in f32 within 2e-5;
   and bf16 queries over f32 k/v through ``ops.attention`` at the cross
   shapes, one f32-body launch within one bf16 ulp plus 2e-5); timed
   with CUDA events
   beside its bound (bytes, or for ``flash_attention`` the FLOPs of the
   visible pairs at the bf16 tensor-core peak when larger), its plain
   version and, where one PyTorch call computes the same function, that
   call (SDPA; none with softcap or window), and
   for ``flash_attention`` also the device time of the kernel's and of
   SDPA's kernels in a ``torch.profiler`` trace (host launch time left
   out);
   ``ssd_scan`` within 2e-4 of its plain version (``ref.ssd_chunked``)
   at every ``SSD_CASES`` shape of tests/test_kernels.py in f32, with
   per-head and with group-shared b/c, and at mamba2's serving prefills
   (bf16, group-shared b/c, 64 heads of P 64, state 128, T in {77, 1000,
   1024, 2048}) and zamba2's (80 heads of P 64, state 64, T in {77, 129,
   1024}) within 1e-5 x max|y| of an f64 evaluation in f32 (the same
   bits on a second call) and within two bf16 ulps of each output (plus
   twice that f32 error) of its plain version in bf16, timed beside its
   bound (bytes; for the f32 body operations at 67 TFLOP/s, of the
   work the function needs with group-shared b/c, timed at
   mamba2's and zamba2's 1024 tokens with each of its three kernels'
   device time), its plain version and no library call (none computes
   an SSD scan);
2. **shuffle** — the coded shuffle of (q, k) in {(2,3), (3,3), (2,4)},
   both routers, bitwise equal to the same shuffle through the plain
   versions on the card: f32 (and close to the numpy reference), and the
   packed 16-bit lane in bf16 and f16; the multipass codec and the looped
   exchange bitwise equal to the fused batched shuffle (and each to its
   own plain-version run), the ``debug`` dict's output to the plain one,
   and in f32 the uncoded baseline close to the reference; then
   ``ShuffleStream`` waves at (2, 3) and d = ``WAVE_D`` (about a quarter
   of the cell's d_shard), f32 and bf16: four waves through ``run_waves``
   at ``wave_batch=2, depth=2``, each bitwise the ``sync`` of its wave;
   the same waves with worker ``FAILED`` failed for the second stacked
   dispatch, bitwise the healthy ones (``compiles`` flat, ``swaps`` 2);
   the degraded executor bitwise the host interpreter
   ``degraded_shuffle_host`` on two column slices and timed beside its
   byte bound; no build at a degrade after ``warm_degraded_execs``;
   then ``phase_topology`` at (q, k, hosts) = ``TOPO_QKH`` = (2, 4, 2),
   d = ``TOPO_D``, f32 and bf16: the two-level ``sync`` (both routers,
   and with gateways ``TOPO_AVOID`` avoided) bitwise the flat one,
   launching the lane's gathers twice each and running every relay
   lane; the self-verifying wire's ``sync`` bitwise the flat one, its
   u32 gathers at rows of pk+1 words; a payload fault in stage 1 and a
   checksum fault in stage 2 (``bits=0x80000000``) detected and replayed
   bitwise, ``WireCorruptionError`` at ``max_replays=0``; the lane's
   gathers (and the verify lane's u32 ones at rows of pk+1 words) on the
   lane's own inputs in both stages, bitwise their plain versions; four
   verified waves at ``wave_batch=2, depth=2`` with a fault on wave 1,
   waves 0-1 dispatched on the two-level plan, wave 2 on the surviving
   flat one after ``kill_host(1)``, wave 3 on the two-level one after
   ``rejoin_host(1)``, bitwise, ``host_swaps`` 2, no schedule lowering
   after the first dispatch; it
   prints ``camr_edge_bytes``, the flat, two-level, verified and
   replayed sync ms and its peak memory;
3. **train** — the training path, in four runs: ``MultiModelCAMRTrainer``
   on the cell of ``repro_torch.launch.cell`` (``granite_3_2b`` at full
   width, cut to 2 layers, q=2, k=3: K=6 virtual workers, J=4 models),
   2 steps of ``camr_spmd`` on ``ShardedTokenPipeline(seq_len=512,
   global_batch=1)``, with f32 grad sync, then with bf16, then with f32
   through the multipass codec, then the SSM family (``mamba2_1p3b`` at
   full width cut to 2 layers) on the f32 lane, whose scans take the
   plain differentiable form: no ``ssd_scan`` or ``flash_attention``
   launch, then the hybrid family (``zamba2_2p7b`` at full width cut to
   one pattern unit of 6 sublayers) on the bf16 lane, likewise, then the
   MoE family (``moonshot_v1_16b_a3b`` with its 64 experts, top-6 and
   capacity 1.25 at d_model 2048, cut to one layer, d_ff 512 and a vocab
   of 16,384: ``MOE_TRAIN_CUT``) on the f32 lane, likewise (each trainer
   freed before the next). Every run trains at its config's ``remat``,
   JAX's ``"block"``; after the f32 run one subfile's map gradient at
   ``"block"`` is held bitwise to the same at ``"none"`` (map ms and
   peak printed both ways, ``check_remat_map``).
   Each run has its kernel launch counts (counters set to 0 just before
   it), step 1's synced gradient held bitwise on a column slice against
   the shuffle of the same contributions (the fused runs against the
   plain versions, the multipass run against the fused kernels), the
   step-time split and its own peak memory. The bf16 run also holds step
   1's losses to the f32 run's (same parameters and data, the map runs
   before any sync), its wire bytes to exactly half and its peak memory
   below the f32 run's; the multipass run holds its step-1 losses to the
   f32 run's. After the f32 run, a kill/rejoin run of the same cell
   (``phase_churn``): step 1 healthy, step 2 with worker ``FAILED``
   failed (the stream's degraded executor in place of the coded
   shuffle: no gather launch, ``aggregate`` 6), step 3 restored; the
   degraded step's synced gradient bitwise the healthy shuffle of its
   contributions, the parameters after step 2 bitwise the f32 run's on
   column slices, the losses its losses, the stream's ``compiles`` 1
   and ``swaps`` 2; its phase split and peak memory are printed. Then
   the granite cell at 2048 tokens on the f32 lane at ``remat="none"``,
   past the attention lanes' switch point of 1448: the same gates, the
   chunked attention in every attention call of the map, one subfile's
   loss and flat gradient through it held to the materialized attention
   at the dense tolerances of tests/test_torch_train.py (an f32 model of
   job 0's master row, TF32 off), and the memory one subfile's map and
   one step take without the block checkpoint. Then the paper's
   comparison: ``camr_spmd``, ``camr`` (the numpy engine) and
   ``uncoded`` (the unicast baseline) trainers from one seed at a
   reduced width (``MODES_CFG``), 2 steps each on the f32 and the bf16
   lanes: parameters and losses bitwise equal across the modes of a
   lane, the bf16 ``camr`` bytes exactly half the f32 ones, the lanes'
   trajectories apart, the host modes launching no kernel; their loads
   and bytes printed; ``camr_spmd`` (both lanes) and ``camr`` (f32)
   again with worker ``FAILED`` failed in step 2, parameters and losses
   bitwise that mode's healthy run; and one ``uncoded`` step of the full
   granite cell
   (its host time; step 1's losses those of the f32 run). Then
   ``phase_oracle``: one ``camr_spmd`` step with ``spmd_oracle=True`` at
   ``MODES_CFG`` on each lane, the numpy engine beside the shuffle (no
   assertion, its loads and bytes those of a ``camr`` step, the lane's
   kernels once each); ``phase_checkpoint``: the single-model
   ``Trainer`` on the granite cell, 4 steps saving at steps 2 and 4, a
   leaf file of step 4 deleted, a resume from another seed that warns
   "failed verification" and lands on step 2 bitwise, then 2 steps
   bitwise the first run's (no kernel launch); ``phase_process_group``:
   two child processes (``chip_smoke.py --process-group-child <rank>
   <port>``) joined by a gloo group on the one card, 4 of the 8 workers
   each at ``TOPO_QKH``'s (q, k) and d = ``TOPO_D``, the shuffle's
   process lane flat and two-level, f32 and bf16, both routers and the
   multipass codec, every row bitwise the single-process shuffle's, the
   bytes across processes ``camr_edge_bytes``' inter-host bytes, and the
   lane's other modes on the f32 flat plan: the looped exchange, the
   verified wire clean and with one corrupted word (its mismatch counts
   the single-process rows'), a verified ``ShuffleStream(mesh=)`` wave
   with that fault (one replay in both processes) and a degraded wave,
   each bitwise; each child's launches exact (added to the ``kernels``
   line); ``phase_compare``: the paper's camr-vs-uncoded-vs-allreduce
   comparison (``repro_torch.launch.camr_compare``) at the cell's shard
   width, at the CLI's (4, 4) and at the two-level cell, the collective
   ledger's counts and wire bytes gated against
   ``expected_collective_calls`` and their closed form, each scheme
   timed by CUDA events, then ``measure_stream`` at (2, 3), d 1,048,576,
   8 waves with a kill and a rejoin (its launches exact, added to the
   ``kernels`` line); ``phase_examples``: ``examples/torch/
   multimodel_camr.py --steps 3``, ``serve_lm.py`` and ``train_lm.py
   --steps 40`` as subprocesses on the card, each exit 0 and ``OK``,
   ``train_lm.py``'s loss falling;
4. **serve** — seven models served through ``DecodeEngine(slots=4,
   page_size=16, max_ctx=1056)`` behind ``ServeStream(wave_len=8)``,
   each on random bf16 weights from seed 0: ``granite_3_2b`` at full
   depth (40 layers), ``mamba2_1p3b`` at full depth (48 SSM layers),
   ``zamba2_2p7b`` at full depth (54 sublayers: 45 SSM layers and 9
   occurrences of one shared attention block), ``moonshot_v1_16b_a3b``
   at full width and full depth (48 layers of 64 experts, top-6) and
   ``mixtral_8x7b`` at full width cut to 16 of its 32 layers (8 experts,
   top-2), 8 greedy requests each with prompts of {1000, 129, 257, 640,
   1024, 77, 513, 900} tokens and 32 new tokens, and ``gemma2_2b`` and
   ``internlm2_20b`` cut to 4 layers, 4 requests each. Each run has its
   own launch counts (counters set to 0 just before it): one
   ``flash_attention`` per attention layer and prefill, one ``ssd_scan``
   per SSM layer and prefill, no other kernel (granite 320 / 0, gemma2
   16 / 0, mamba2 0 / 384, zamba2 72 / 360, moonshot 384 / 0, mixtral
   128 / 0, internlm2 16 / 0). An MoE run's warm second run tallies its
   dispatches (``count_moe_drops``): the assignments dropped past an
   expert's capacity in prefill, which it prints, and in decode, which
   must be none. Gates: every status ``ok``,
   engine tokens bitwise the port's ``generate`` on the card (and on a
   warm second run that builds or loads no kernel library), the page
   pool's invariants, the prefill logits through the kernels within 5%
   of max |logit| of the same prefill through the plain versions
   (mamba2's at 4 layers and zamba2's at one pattern unit of 6: the
   random bf16 models amplify rounding with depth as far between two
   plain evaluations, which it prints, so each of a full-depth prefill's
   kernel calls is also held, at the model's own activations, to the
   bf16 limit of phase 1). Reports prefill ms by prompt length, decode
   tok/s, step p50/p99 and peak memory. Then the legacy host loop
   (``phase_legacy``; ``DecodeEngine`` refuses these models, as JAX's
   does): ``seamless_m4t_large_v2`` (24 encoder + 24 decoder layers) and
   ``internvl2_26b`` (48 layers) at full width and full depth on random
   bf16 weights, each request through ``serve_legacy`` with its own
   frames or patches (``LEGACY_RUNS``: seamless on f32 frames of 257-1024
   frames under prompts of 4-513 tokens, one more on bf16 frames;
   internvl2 on f32 patches ``[1, 256, 1024]`` under prompts of 257-1024
   tokens), 32 new tokens each: statuses ``ok``, tokens bitwise
   ``generate``'s on the card, ``flash_attention`` launches exact (72 a
   seamless prefill: 24 encoder, 24 self and 24 cross; 24 a seamless
   decode step, its cross-attention; 48 an internvl2 prefill; none
   other; of these, the f32 body's exact too: 792 a seamless request on
   f32 frames, its encoder and cross-attention, none else), every request's prefill logits through the kernels within 5%
   of max |logit| of the plain versions' at full depth; it reports
   prefill ms by length, the host loop's tok/s and step p50/p99, and
   peak memory. Last, ``SERVE_F32_RUN``: ``mamba2_1p3b`` at full width
   in f32 (its training dtype), cut to 4 layers, two requests of 1024
   and 77 tokens with 8 new tokens each, the same gates, its prefill
   logits within ``F32_LOGIT_SHARE`` = 1e-3 of max |logit| of the plain
   versions' and exactly one f32 ``ssd_scan`` launch per layer and
   prefill (8).

5. **dryrun** — ``phase_dryrun``: the dry run of
   ``repro_torch.launch.dryrun`` against the card. First each kernel at
   the shapes its prefills here give it (32,768 tokens: ``flash_attention``
   at granite's heads against the materialized plain attention a block
   of queries at a time, ``ssd_scan`` at mamba2's against the plain
   chunked scan, both in bf16 at the serving limits of phase 1). Then
   for each of ``DRYRUN_CELLS`` (mamba2 at ``long_500k`` and
   ``decode_32k`` and zamba2 at ``long_500k``, JAX's shapes as they
   stand; mamba2's and granite's prefill at 32,768 tokens and granite's
   train step at 4,096, each at batch 1, and granite's train step at
   4,096 x 8, ``REMAT_CELL``, whose trace must fit the card at the
   config's ``remat="block"`` and not at ``"none"``) the step of
   ``repro_torch.launch.steps`` traced on ``meta``, then built on the
   card from seed 0 and run twice: its FLOPs (the dry run's tracer, by
   ``FlopCounterMode``'s formulas, plus the kernels' formulas of
   ``repro_torch.kernels.cost``) equal to the
   trace's exactly, its peak memory within 10% or 256 MiB of the
   trace's, its result finite (a train step's loss and norm, the
   logits of the others), its step ms printed beside the roofline's
   ``step_time_s`` and ``useful_flops_ratio``. ``python3 chip_smoke.py
   --dryrun-only`` builds the kernels and runs this phase alone (no
   result line).

6. **mesh** — ``phase_mesh``: JAX's production mesh on one card. For
   each of ``MESH_CELLS`` (granite's ``train_4k`` and ``prefill_32k``,
   mamba2's ``prefill_32k`` and mistral's ``train_4k``, cut to 4 of 88
   layers, all at full width) the step of ``repro_torch.launch.steps``
   as rank 0 of the 256-device ``(data, model)`` mesh: traced on
   ``meta`` (``dryrun.run_cell(..., "single")``), then built on the card
   from seed 0 over a fake process group of 256 ranks (DTensor; the
   group's collectives move no byte, so the phase checks no values: the
   CPU tests hold the sharded step's values to the one-device step's
   and to JAX's)
   and run twice: its FLOPs (this rank's local products, counted by the
   dry run's tracer, plus the kernels' formulas) equal to the trace's,
   its peak within 2% of the trace's, ``flash_attention``
   and ``ssd_scan`` launched by the prefills at the rank's local heads;
   its step ms printed beside the roofline's compute and memory terms,
   the collective term on a line of its own. ``python3 chip_smoke.py
   --mesh-only`` builds the kernels and runs this phase alone (no result
   line).

The last lines are the card's name and power limit, the ``kernels`` JSON
line (eleven kernels, each with its main-path launches: the granite
training runs' counts, the codec kernels' plus the process lane's
children's and ``phase_compare``'s, ``flash_attention``'s summed over
the granite, gemma2, zamba2, moonshot, mixtral, internlm2, seamless and
internvl2 serving runs and ``phase_dryrun``'s and ``phase_mesh``'s
granite prefills, ``ssd_scan``'s over the mamba2 and zamba2 runs and
``phase_dryrun``'s and ``phase_mesh``'s mamba2 prefills;
a twelfth entry, ``flash_attention_f32``, for ``flash_attention``'s f32 body at
seamless's encoder shape, its launches those of the f32 body alone,
3,168 in the four seamless requests on f32 frames; and a thirteenth,
``ssd_scan_f32``, for ``ssd_scan``'s f32 body at mamba2's 1024 tokens,
its launches those of the f32 serving run) and ``{"ok": true,
"device": {...}}``. Needs one CUDA card, the CUDA toolkit (``nvcc``) and
the rest of this checkout; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
DEVICE = "cuda"
_GATHER = "src/repro_torch/kernels/csrc/xor_gather.cu"
_FOLD = "src/repro_torch/kernels/csrc/xor_fold.cu"
_AGG = "src/repro_torch/kernels/csrc/aggregate.cu"
_FLASH = "src/repro_torch/kernels/csrc/flash_attention.cu"
_SSD = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SOURCES = {"xor_encode_gather": (_GATHER, "src/repro/kernels/xor_code.py:240"),
           "xor_decode_gather": (_GATHER, "src/repro/kernels/xor_code.py:309"),
           "aggregate": (_AGG, "src/repro/kernels/aggregate.py:71"),
           "xor_encode_gather16": (_GATHER,
                                   "src/repro/kernels/xor_code.py:371"),
           "xor_decode_gather16": (_GATHER,
                                   "src/repro/kernels/xor_code.py:415"),
           "aggregate_bf16": (_AGG, "src/repro/kernels/aggregate.py:71"),
           "xor_fold": (_FOLD, "src/repro/kernels/xor_code.py:138"),
           "xor_decode": (_FOLD, "src/repro/kernels/xor_code.py:180"),
           "xor_encode": (_FOLD, "src/repro/kernels/xor_code.py:106"),
           "flash_attention": (_FLASH,
                               "src/repro/kernels/flash_attention.py:127"),
           "flash_attention_f32": (_FLASH,
                                   "src/repro/kernels/flash_attention.py:127"),
           "ssd_scan": (_SSD, "src/repro/kernels/ssd_scan.py:98"),
           "ssd_scan_f32": (_SSD, "src/repro/kernels/ssd_scan.py:98")}
#: H100 SXM peaks (data sheet, dense): bf16 tensor cores, f32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def phase_total(ms: dict) -> float:
    """A step's ms over the trainer's phases (``phase_ms`` also holds the
    spans inside them, which would count twice)."""
    from repro_torch.runtime.train_loop import PHASES
    return sum(ms[p] for p in PHASES)


def phase_list(ms: dict) -> str:
    """``map 1.0, aggregate 2.0, ...``: a step's phases alone."""
    from repro_torch.runtime.train_loop import PHASES
    return ", ".join(f"{p} {ms[p]:.1f}" for p in PHASES)


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


def device_ms(fn, *, reps=5):
    """Device milliseconds of one call: the sum of
    :func:`device_ms_by_kernel`; the host's launch time is left out. None
    when the profiler records no device activity."""
    return sum(device_ms_by_kernel(fn, reps=reps).values()) or None


def device_ms_by_kernel(fn, *, reps=5):
    """Device milliseconds of one call by CUDA kernel: {name (the
    function's, with its template arguments): its kernels' own time in a
    ``torch.profiler`` trace of ``reps`` calls (after one warm-up), over
    ``reps``}; empty when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0))
        if e.device_type.name == "CUDA" and us > 0:
            m = re.search(r"\w+(<[^()]*>)?(?=\()", e.key)
            name = m.group(0) if m else e.key
            out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


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


#: the codec kernels the shuffle calls, by the module that calls them
_CODEC = {"repro_torch.core.collective": (
              "xor_encode_gather", "xor_decode_gather", "xor_encode_gather16",
              "xor_decode_gather16", "xor_fold", "xor_decode"),
          "repro_torch.kernels.ops": ("xor_encode",)}


@contextlib.contextmanager
def plain_codec():
    """Route the codec through the plain versions (the comparison runs;
    no kernel launches)."""
    import importlib
    from repro_torch.kernels import ref
    saved = []
    for mod_name, names in _CODEC.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(ref, name + "_ref"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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


def check_folds(gen, R, m, n, offset=0):
    """Random packets and recv words, masks with a row wholly off and one
    wholly on; the multipass codec's dense folds bitwise against the
    plain versions."""
    import torch
    from repro_torch.kernels import ops, ref, xor_decode, xor_fold
    packets = _rand_bits((R, m, n), gen, torch.int32, offset)
    recv = _rand_bits((R, n), gen, torch.int32, offset)
    mask = torch.rand((R, m), device=DEVICE, generator=gen) < 0.5
    mask[0], mask[1] = False, True
    where = f"R={R} m={m} n={n} offset={offset}"
    for name, got, want in (
            ("xor_fold", xor_fold(packets), ref.xor_fold_ref(packets)),
            ("xor_decode", xor_decode(recv, packets, mask),
             ref.xor_decode_ref(recv, packets, mask)),
            ("xor_encode", ops.xor_fold(packets[2]),
             ref.xor_encode_ref(packets[2]))):
        if not bitwise_equal(got, want):
            fail(f"{name} != plain at {where}")


def step_folds(gen, st, K, k, pk):
    """The dense folds at the multipass step's shapes (stage 1's tables):
    ``xor_fold`` over the ``[K*n, k, pk]`` packets of Δ, ``xor_decode``
    over ``[K*n*(k-1), k, pk]`` cancellation packets with the step's
    ``cancel_mask``, and one server's Δ ``[k-1, pk]`` through
    ``ops.xor_fold``; bitwise against the plain versions, then timed."""
    import torch
    from repro_torch.kernels import ops, ref, xor_decode, xor_fold
    n = st["n"]
    R = K * n * (k - 1)
    mask = st["cancel_mask"]                          # [R, k]
    packets = _rand_bits((R, k, pk), gen, torch.int32)
    recv = _rand_bits((R, pk), gen, torch.int32)
    fold_in = packets[:K * n]                         # [K*n, k, pk]
    enc_in = packets[0, :k - 1]                       # [k-1, pk]
    valid = int(mask.sum())
    cases = (
        ("xor_fold", xor_fold, ref.xor_fold_ref, (fold_in,),
         4 * pk * (K * n * k + K * n), f"packets [{K * n},{k},{pk}] u32"),
        ("xor_decode", xor_decode, ref.xor_decode_ref, (recv, packets, mask),
         4 * pk * (2 * R + valid) + mask.numel(),
         f"recv [{R},{pk}], packets [{R},{k},{pk}] u32, {valid} of "
         f"{mask.numel()} selected"),
        ("xor_encode", ops.xor_fold, ref.xor_encode_ref, (enc_in,),
         4 * pk * k, f"packets [{k - 1},{pk}] u32 (ops.xor_fold)"))
    out = {}
    for name, fn, plain, args, nbytes, shape in cases:
        got, want = fn(*args), plain(*args)
        if not bitwise_equal(got, want):
            fail(f"{name} != plain at the step's shape")
        err = max_abs_err(got, want)
        del got, want
        out[name] = dict(
            ms=time_ms(lambda: fn(*args)),
            plain_ms=time_ms(lambda: plain(*args), warmup=1, reps=3),
            bytes=nbytes, library_ms=None, max_abs_err=err, shape=shape)
    log(f"kernels: xor_fold / xor_decode / xor_encode bitwise at the "
        f"multipass step's shapes (pk={pk})")
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


#: tests/test_kernels.py's ATTN_CASES: B, Hq, Hkv, Tq, Tk, D, causal,
#: window, softcap
ATTN_CASES = [
    (1, 2, 2, 64, 64, 16, True, None, None),
    (2, 4, 2, 32, 32, 32, True, None, None),
    (1, 2, 1, 128, 128, 16, True, 32, None),
    (1, 2, 2, 64, 64, 16, True, None, 50.0),
    (1, 4, 4, 48, 48, 16, False, None, None),
    (1, 2, 1, 1, 96, 16, True, None, None),
    (1, 2, 2, 100, 100, 16, True, None, None),
    (1, 8, 2, 8, 72, 16, True, 24, None),
]
#: the serving prefills' shapes (bf16): granite_3_2b (32/8 heads, D 64,
#: causal), gemma2_2b (8/4 heads, D 256, softcap 50, window 4096),
#: zamba2_2p7b's shared attention block (32/32 heads, D 80, causal; at 77
#: and 129 tokens a ragged last query tile and key tile),
#: moonshot_v1_16b_a3b (16/16 heads, D 128, causal), mixtral_8x7b (32/8
#: heads, D 128, window 4096; at 5000 tokens past the window),
#: internlm2_20b and internvl2_26b (48/8 heads, D 128, causal) and
#: seamless_m4t_large_v2 (``ENCDEC_SHAPES``); the first is the one the
#: ``kernels`` line reports
FLASH_MAIN = (1, 32, 8, 1024, 1024, 64, True, None, None)
#: seamless_m4t_large_v2 (16/16 heads, D 64, non-causal): its encoder over
#: 1000 frames, its cross-attention prefill over them (a 4-token prompt,
#: and 513 tokens over 257 frames: Tq > Tk) and its cross-attention in a
#: decode step; held in f32 (f32 frames, as the JAX launcher makes them:
#: the CUDA-core body) and in bf16
ENCDEC_SHAPES = [(1, 16, 16, 1000, 1000, 64, False, None, None),
                 (1, 16, 16, 4, 1000, 64, False, None, None),
                 (1, 16, 16, 513, 257, 64, False, None, None),
                 (1, 16, 16, 1, 1000, 64, False, None, None)]
FLASH_SHAPES = [FLASH_MAIN] + [
    (1, 32, 8, t, t, 64, True, None, None) for t in (129, 1000, 2048)] + [
    (1, 8, 4, t, t, 256, True, 4096, 50.0) for t in (1000, 5000)] + [
    (1, 32, 32, t, t, 80, True, None, None) for t in (77, 129, 1024)] + [
    (1, 16, 16, t, t, 128, True, None, None) for t in (129, 1024)] + [
    (1, 32, 8, t, t, 128, True, 4096, None) for t in (1024, 5000)] + [
    (1, 48, 8, 1024, 1024, 128, True, None, None)] + ENCDEC_SHAPES
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the serving shapes' limit, relative to each output: the kernel works
#: in f32 like the plain version and rounds once to bf16, so an element
#: may differ by one bf16 ulp of its value (at most 2**-7 of it, taken
#: twice here) plus f32 rounding near 0. The ATTN_CASES' 2e-2 is about
#: half of a typical output at these key counts (|o| ~ 0.03-0.08)
FLASH_SERVE_TOL = dict(rtol=2 ** -6, atol=1e-5)
#: bf16 queries over f32 k/v through ``ops.attention`` (the f32 body, the
#: output rounded to bf16) against the plain version (f32 math rounded
#: once): one bf16 ulp of each output (2**-7 of it) plus the f32 body's
#: 2e-5 (an output near 0 has ulps far below the f32 sums' differences)
MIXED_TOL = dict(rtol=2 ** -7, atol=2e-5)


def _sdpa_fn(q, k, v, causal, window, softcap):
    """The one PyTorch call that computes the same function, or None
    (SDPA has no softcap and no sliding window; its causal mask is the
    top-left one, the kernel's the right-aligned one, which agree where
    Tq = Tk, the causal serving shapes)."""
    import torch.nn.functional as F
    if window is not None or softcap is not None or (
            causal and q.shape[2] != k.shape[2]):
        return None
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)


def _ms_txt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_flash(gen):
    """``flash_attention`` against its plain version on the card: every
    ATTN_CASES shape in f32 and bf16 (tolerances of tests/test_kernels.py:
    2e-5 / 2e-2), and the serving prefills' shapes in bf16 (within
    ``FLASH_SERVE_TOL`` of each output), seamless's (``ENCDEC_SHAPES``)
    also in f32 (within 2e-5); each serving shape timed beside its bound,
    its plain version and SDPA, by CUDA events around each call and by
    the device time of its kernels in a profiler trace. Then seamless's
    cross-attention on bf16 queries over f32 k/v through
    ``ops.attention`` (one launch of the f32 body), within one bf16 ulp
    of its plain version plus 2e-5 (``MIXED_TOL``)."""
    import torch
    from repro_torch.kernels import cost, flash_attention, ops, ref
    timed = {}
    cases = [(c, dt) for c in ATTN_CASES for dt in ("float32", "bfloat16")]
    cases += [(c, "bfloat16") for c in FLASH_SHAPES]
    cases += [(c, "float32") for c in ENCDEC_SHAPES]
    for case, dtype in cases:
        B, Hq, Hkv, Tq, Tk, D, causal, window, softcap = case
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(s, device=DEVICE, generator=gen).to(dt)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D),
                             (B, Hkv, Tk, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        got, want = flash_attention(q, k, v, **kw), ref.flash_attention_ref(
            q, k, v, **kw)
        torch.cuda.synchronize()
        serving = case in FLASH_SHAPES
        tol = (FLASH_SERVE_TOL if serving and dtype == "bfloat16"
               else dict(rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype]))
        err = max_abs_err(got.float(), want.float())
        if got.dtype != dt or not torch.allclose(got.float(), want.float(),
                                                 **tol):
            fail(f"flash_attention != plain at {case} {dtype} "
                 f"(max abs err {err}, limit {tol})")
        if not serving:
            continue
        rms = float(want.float().square().mean().sqrt())
        share = float(((got.float() - want.float()).abs() / (
            tol["atol"] + tol["rtol"] * want.float().abs())).max())
        del got, want
        flops, nbytes = cost.flash_attention(B, Hq, Hkv, Tq, Tk, D, causal,
                                             window, q.element_size())
        bound = max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
        lib = _sdpa_fn(q, k, v, causal, window, softcap)
        r = dict(ms=time_ms(lambda: flash_attention(q, k, v, **kw)),
                 plain_ms=time_ms(lambda: ref.flash_attention_ref(
                     q, k, v, **kw), warmup=1, reps=3),
                 library_ms=time_ms(lib) if lib is not None else None,
                 device_ms=device_ms(lambda: flash_attention(q, k, v, **kw)),
                 library_device_ms=(device_ms(lib) if lib is not None
                                    else None),
                 bound_ms=bound * 1e3,
                 bound_by=("operations" if flops / PEAK_FLOPS[dtype]
                           >= nbytes / HBM_BYTES_PER_S else "bytes"),
                 max_abs_err=err, rms_want=rms, limit_share=share,
                 bytes=nbytes,
                 shape=f"q [{B},{Hq},{Tq},{D}] k/v [{B},{Hkv},{Tk},{D}] "
                       f"{dtype} causal={causal} window={window} "
                       f"softcap={softcap}, {flops / 1e9:.3f} GFLOP")
        timed[case, dtype] = r
        lib_txt = (f"{r['library_ms']:.3f} ms" if lib is not None
                   else "none: SDPA has no softcap/window")
        log(f"kernels: flash_attention {r['shape']}: {r['ms']:.3f} ms "
            f"(plain {r['plain_ms']:.3f} ms, SDPA {lib_txt}, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} at "
            f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s / 3.35 TB/s), max abs "
            f"err {err:.2e} (RMS of the output {rms:.3e}; the worst element "
            f"at {share:.3f} of its limit)")
        log(f"kernels: flash_attention {r['shape']}: device time "
            f"(torch.profiler) {_ms_txt(r['device_ms'])}, SDPA's "
            f"{_ms_txt(r['library_device_ms']) if lib is not None else 'n/a'}")
        del q, k, v
        torch.cuda.empty_cache()
    for case in ENCDEC_SHAPES[2:]:       # the cross prefill and decode
        B, Hq, Hkv, Tq, Tk, D = case[:6]
        q = torch.randn((B, Hq, Tq, D), device=DEVICE,
                        generator=gen).bfloat16()
        k, v = (torch.randn((B, Hkv, Tk, D), device=DEVICE, generator=gen)
                for _ in range(2))
        before = flash_attention.launches
        got = ops.attention(q, k, v, causal=False)
        launches = flash_attention.launches - before
        want = ref.flash_attention_ref(q, k, v, causal=False).float()
        share = float(((got.float() - want).abs() / (
            MIXED_TOL["atol"] + MIXED_TOL["rtol"] * want.abs())).max())
        if got.dtype != torch.bfloat16 or launches != 1 or share > 1:
            fail(f"ops.attention bf16 q over f32 k/v at {case}: {got.dtype}, "
                 f"{launches} launches, the worst element at {share} of its "
                 f"limit {MIXED_TOL}")
        log(f"kernels: ops.attention bf16 q [{B},{Hq},{Tq},{D}] over f32 k/v "
            f"[{B},{Hkv},{Tk},{D}] non-causal: one f32-body launch, within "
            f"one bf16 ulp + 2e-5 of plain (the worst element at "
            f"{share:.3f} of its limit)")
    log(f"kernels: flash_attention within 2e-5 (f32) / 2e-2 (bf16) of plain "
        f"at {len(ATTN_CASES)} ATTN_CASES shapes x 2 dtypes, within rtol "
        f"2**-6 + atol 1e-5 at {len(FLASH_SHAPES)} bf16 serving shapes and "
        f"within 2e-5 at {len(ENCDEC_SHAPES)} f32 ones")
    return {"flash_attention": timed[FLASH_MAIN, "bfloat16"],
            "flash_attention_f32": timed[ENCDEC_SHAPES[0], "float32"]}


#: tests/test_kernels.py's SSD_CASES: B, T, H, P, S, chunk (the chunk is
#: the plain version's; the kernel's is 64)
SSD_CASES = [(1, 32, 2, 8, 4, 8), (2, 64, 1, 16, 8, 16),
             (1, 100, 2, 8, 4, 32), (1, 16, 3, 4, 16, 16)]
#: the serving prefills' shapes (bf16, group-shared b/c), B, T, H, P, S:
#: mamba2_1p3b (64 heads of P 64, state 128) at these lengths, the first
#: the one the ``kernels`` line reports, and zamba2_2p7b's mamba2 blocks
#: (80 heads of P 64, state 64; at 77 and 129 tokens a ragged last chunk)
SSD_MAIN = (1, 1024, 64, 64, 128)
SSD_SHAPES = [SSD_MAIN] + [(1, t, 64, 64, 128) for t in (77, 1000, 2048)] + [
    (1, t, 80, 64, 64) for t in (77, 129, 1024)]
#: the shapes at which the f32 body is timed, each kernel apart: mamba2's
#: (the ``kernels`` line's ``ssd_scan_f32``) and zamba2's at 1024 tokens
SSD_F32_TIMED = (SSD_MAIN, (1, 1024, 80, 64, 64))
SSD_TOL = 2e-4
#: the serving shapes' accuracy: the kernel's f32 result (the bf16 inputs
#: upcast) within this share of max |y| of an f64 evaluation. The chunked
#: form's weights exp(cum_t - cum_s) are differences of in-chunk sums of
#: up to ~100 in magnitude, so both f32 evaluations (kernel and plain)
#: are off by a few 1e-6 of max |y| (|y| up to ~130 at RMS ~13)
SSD_F32_REL = 1e-5
#: the serving shapes' limit for the bf16 outputs, kernel against plain:
#: each rounds its f32 result once to bf16, so an element may differ by
#: a bf16 ulp of its value (at most 2**-7 of it, taken twice here) plus
#: the two f32 errors (``SSD_F32_REL`` of max |y| each)
SSD_SERVE_RTOL = 2 ** -6


def _ssd_work(B, T, H, P, S, C=64, itemsize=2):
    """(FLOPs, bytes) of one scan with group-shared b/c: the work the
    function needs, which its bound is taken from. Per chunk of L real
    steps, in multiply-adds: c b^T on and below the diagonal once (b and
    c are shared by the heads), ``L (L + 1) / 2 * S``; per head M x on and
    below the diagonal, ``L (L + 1) / 2 * P``; c h for every chunk but the
    first (its entering state is zero) and the state update for every
    chunk but the last (no output reads its result), ``L * S * P`` each.
    The decays' exponentials and scalings are not counted. Bytes as
    ``repro_torch.kernels.cost.ssd_scan`` (x and y in bf16, ``itemsize``
    2, or f32, 4; a in f32; b and c in x's dtype; each read or written
    once). ``cost.ssd_scan``, which the dry run charges, counts JAX's
    products instead: c b^T per head and the whole M x, 1.6x this at
    mamba2's 1024 tokens."""
    from repro_torch.kernels import cost
    lens = [min(C, T - t0) for t0 in range(0, T, C)]
    tri = sum(L * (L + 1) // 2 for L in lens)
    macs = tri * S + H * tri * P + H * S * P * (2 * T - lens[0] - lens[-1])
    return 2 * B * macs, cost.ssd_scan(B, T, H, P, S, itemsize, False, C)[1]


def check_ssd(gen):
    """``ssd_scan`` against its plain version on the card: every
    SSD_CASES shape in f32 with per-head and group-shared b/c (2e-4, the
    tolerance of tests/test_kernels.py), and the serving prefills'
    shapes (``SSD_SHAPES``) in f32 (within ``SSD_F32_REL`` x max|y| of an
    f64 evaluation, and the same bits on a second call) and in bf16
    (within ``SSD_SERVE_RTOL`` of each output plus twice ``SSD_F32_REL`` x
    max|y| of the plain version), each bf16 shape and the f32 body at
    ``SSD_F32_TIMED`` timed beside its bound and its plain version (no
    single PyTorch call computes an SSD scan), by CUDA events around each
    call and by the device time of its kernels in a profiler trace (the
    f32 body's also by kernel)."""
    import torch
    from repro_torch.kernels import ref, ssd_scan

    def inputs(B, T, H, P, S, dt, shared, decay):
        bs = (B, T, S) if shared else (B, T, H, S)
        x, b, c = (torch.randn(sh, device=DEVICE, generator=gen).to(dt)
                   for sh in ((B, T, H, P), bs, bs))
        a = torch.randn((B, T, H), device=DEVICE, generator=gen)
        # the model's log-decay -softplus(.), or tests/test_kernels.py's
        a = (-torch.nn.functional.softplus(a) if decay == "model"
             else -a.abs() * 0.1)
        return x, a, b, c

    for B, T, H, P, S, chunk in SSD_CASES:
        for shared in (False, True):
            args = inputs(B, T, H, P, S, torch.float32, shared, "test")
            got, want = ssd_scan(*args), ref.ssd_chunked(*args, chunk=chunk)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if got.dtype != torch.float32 or not torch.allclose(
                    got, want, rtol=SSD_TOL, atol=SSD_TOL):
                fail(f"ssd_scan != plain at {(B, T, H, P, S)} shared={shared} "
                     f"f32 (max abs err {err})")
    timed, timed32 = {}, {}
    for shape in SSD_SHAPES:
        B, T, H, P, S = shape
        args = inputs(B, T, H, P, S, torch.bfloat16, True, "model")
        x, a, b, c = args
        exact = ref.ssd_chunked(*(t.double() for t in args))
        scale = float(exact.abs().max())
        a32 = (x.float(), a, b.float(), c.float())
        k32, p32 = (fn(*a32) for fn in (ssd_scan, ref.ssd_chunked))
        f32_err, plain_err = (float((t.double() - exact).abs().max()) / scale
                              for t in (k32, p32))
        if not f32_err <= SSD_F32_REL:
            fail(f"ssd_scan at {shape} (f32): max abs err {f32_err} x max|y| "
                 f"against an f64 evaluation > {SSD_F32_REL}")
        if not torch.equal(_bits(ssd_scan(*a32)), _bits(k32)):
            fail(f"ssd_scan at {shape} (f32): two calls differ in their bits")
        err32 = max_abs_err(k32, p32)
        del exact, k32, p32
        if shape in SSD_F32_TIMED:     # the f32 body (CUDA cores), by kernel
            flops, nbytes = _ssd_work(B, T, H, P, S, itemsize=4)
            t_ops, t_bytes = (flops / PEAK_FLOPS["float32"],
                              nbytes / HBM_BYTES_PER_S)
            split = device_ms_by_kernel(lambda: ssd_scan(*a32))
            r = dict(ms=time_ms(lambda: ssd_scan(*a32)),
                     device_ms=sum(split.values()) or None,
                     plain_ms=time_ms(lambda: ref.ssd_chunked(*a32),
                                      warmup=1, reps=3),
                     library_ms=None, bound_ms=max(t_ops, t_bytes) * 1e3,
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     max_abs_err=err32, bytes=nbytes,
                     shape=f"x [{B},{T},{H},{P}] f32, a f32, b/c [{B},{T},"
                           f"{S}] group-shared, {flops / 1e9:.3f} GFLOP, "
                           f"{nbytes / 1e6:.2f} MB")
            timed32[shape] = r
            log(f"kernels: ssd_scan f32 body {r['shape']}: {r['ms']:.3f} ms, "
                f"device time (torch.profiler) {_ms_txt(r['device_ms'])}: "
                + ", ".join(f"{name} {ms:.4f} ms" for name, ms in
                            sorted(split.items()))
                + f" (plain {r['plain_ms']:.3f} ms, library none, bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']} at 67 TFLOP/s / "
                f"3.35 TB/s), max abs err against plain {err32:.2e}")
        del a32
        got, want = ssd_scan(*args), ref.ssd_chunked(*args)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        err = max_abs_err(g, w)
        limit = 2 * SSD_F32_REL * scale + SSD_SERVE_RTOL * w.abs()
        share = float(((g - w).abs() / limit).max())
        rms = float(w.square().mean().sqrt())
        if got.dtype != torch.bfloat16 or not torch.isfinite(g).all() \
                or share > 1:
            fail(f"ssd_scan != plain at {shape} bf16 (max abs err {err}, worst "
                 f"element at {share:.3f} of its limit)")
        log(f"kernels: ssd_scan {shape}: f32 max abs err against f64 "
            f"{f32_err:.2e} x max|y| {scale:.1f} (plain {plain_err:.2e}; "
            f"limit {SSD_F32_REL})")
        del got, want, g, w, limit
        flops, nbytes = _ssd_work(B, T, H, P, S)
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / HBM_BYTES_PER_S
        r = dict(ms=time_ms(lambda: ssd_scan(*args)),
                 device_ms=device_ms(lambda: ssd_scan(*args)),
                 plain_ms=time_ms(lambda: ref.ssd_chunked(*args), warmup=1,
                                  reps=3),
                 library_ms=None, bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 max_abs_err=err, bytes=nbytes,
                 shape=f"x [{B},{T},{H},{P}] bf16, a f32, b/c [{B},{T},{S}] "
                       f"group-shared, {flops / 1e9:.3f} GFLOP, "
                       f"{nbytes / 1e6:.2f} MB")
        timed[shape] = r
        log(f"kernels: ssd_scan {r['shape']}: {r['ms']:.3f} ms, device time "
            f"(torch.profiler) {_ms_txt(r['device_ms'])} (plain "
            f"{r['plain_ms']:.3f} ms, library none: no single call computes "
            f"an SSD scan, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"at 989 TFLOP/s / 3.35 TB/s), max abs err {err:.2e} (RMS of the "
            f"output {rms:.3e}; the worst element at {share:.3f} of its "
            "limit)")
        del x, a, b, c, args
        torch.cuda.empty_cache()
    log(f"kernels: ssd_scan within {SSD_TOL} of plain at {len(SSD_CASES)} "
        f"SSD_CASES shapes x per-head/group-shared b/c (f32), and at "
        f"{len(SSD_SHAPES)} serving shapes within {SSD_F32_REL} x max|y| of "
        f"f64 (f32) and within rtol 2**-6 + {2 * SSD_F32_REL} x max|y| of "
        "plain (bf16)")
    return {"ssd_scan": timed[SSD_MAIN], "ssd_scan_f32": timed32[SSD_MAIN]}


def phase_kernels(gen, tr):
    """At the shapes the trainer ``tr`` gives the kernels, on both lanes
    (the tables are lane-independent; the row width is not)."""
    import torch
    from repro_torch.core.collective import make_plan, _device_tables
    from repro_torch.core.schedule import payload_words
    from repro_torch.kernels import launch_counts
    results = {}
    # ragged shapes: u32, u64 and u128 access paths, odd pk, dead rows
    for pk in (1001, 1002, 4096):
        check_gathers(gen, K=3, P=7, row=pk, n=5, m=4)
    log("kernels: XOR gathers bitwise at ragged shapes (pk 1001/1002/4096)")
    # 16-bit lanes: rows of 0, 2, 4 and 6 mod 8 lanes (16-byte phases
    # stepping by 0, 4, 8 and 12 bytes a row), bases 0-7 lanes off a
    # 16-byte boundary (odd: the 2-byte instantiation), 1 to 64 sources,
    # rows of several 16-KB tiles, and masks wholly on and wholly off
    for lanes, offset, m in ((2, 0, 4), (1002, 0, 4), (2004, 0, 4),
                             (4096, 0, 4), (4096, 1, 4), (1002, 1, 4),
                             (1002, 2, 1), (1002, 3, 3), (1002, 5, 64),
                             (2004, 4, 3), (2004, 6, 1), (2004, 7, 64),
                             (4094, 2, 64), (4094, 5, 3), (4094, 6, 1),
                             (50002, 0, 3), (50002, 3, 3)):
        check_gathers(gen, K=3, P=7, row=lanes, n=5, m=m, half=True,
                      offset=offset)
    for p_valid in (0.0, 1.0):
        check_gathers(gen, K=3, P=7, row=4094, n=5, m=3, half=True,
                      offset=2, p_valid=p_valid)
    log("kernels: 16-bit XOR gathers bitwise at ragged lane counts "
        "(2 to 50002 lanes, 0/2/4/6 mod 8), bases 0-7 lanes off "
        "alignment, m 1/3/4/64, masks wholly on and off")

    # the training step's shapes: stage 1 of (q, k) at the model's d_shard
    q, k, d_shard = tr.q, tr.k, tr.d_shard
    plan = make_plan(q, k, d_shard)
    K = plan.K
    for codec in ("fused", "multipass"):    # both codecs' stage tables
        tabs = _device_tables(plan, torch.device(DEVICE), "all_to_all", codec)
    st = tabs["stages"][1]
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

    # the multipass codec's dense folds: n of 1, 2, 3 and 0 mod 4 words,
    # m from 1 to 4, and inputs one word off alignment
    for n in (1001, 1002, 1003, 4096):
        for m in (1, 2, 3, 4):
            check_folds(gen, R=5, m=m, n=n)
    for n in (1002, 4096):
        check_folds(gen, R=5, m=3, n=n, offset=1)
    log("kernels: xor_fold / xor_decode / xor_encode bitwise at ragged "
        "shapes (n 1001/1002/1003/4096 words, m 1-4, masks with whole "
        "rows off, one word off alignment)")
    results.update(step_folds(gen, st, K, k, d_shard // (k - 1)))
    torch.cuda.empty_cache()
    results.update(check_flash(gen))
    results.update(check_ssd(gen))
    log(f"kernels: the checks and timings above launched xor_encode "
        f"{launch_counts()['xor_encode']} times (no training path calls "
        "ops.xor_fold: its main-path count is 0)")
    for name, r in results.items():
        r.setdefault("bound_ms", r["bytes"] / HBM_BYTES_PER_S * 1e3)
        log(f"kernels: {name} {r['shape']}: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms)")
    return results


# --------------------------------------------------------------------- #
# phase 2: the coded shuffle on the card
# --------------------------------------------------------------------- #
#: the other lanes of the shuffle, each held to the fused batched one
_LANES = (("batched", "multipass"), ("looped", "fused"),
          ("looped", "multipass"))


def phase_shuffle():
    import numpy as np
    import torch
    from repro_torch.core.collective import (camr_shuffle,
                                             camr_shuffle_reference,
                                             make_plan,
                                             scatter_contributions,
                                             uncoded_reduce_scatter)
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
                where = f"shuffle ({q},{k}) {dtype} {router}"
                out = camr_shuffle(plan, c, router=router)
                with plain_codec():
                    plain = camr_shuffle(plan, c, router=router)
                if out.dtype != dtype or not bitwise_equal(out, plain):
                    fail(f"{where}: kernels != plain")
                if not torch.isfinite(out).all():
                    fail(f"{where}: not finite")
                if dtype == torch.float32 and not np.allclose(
                        out.cpu().numpy(), ref, rtol=2e-5, atol=2e-6):
                    fail(f"{where}: not close to reference")
                for mode, codec in _LANES:
                    kw = dict(router=router, mode=mode, codec=codec)
                    got = camr_shuffle(plan, c, **kw)
                    with plain_codec():
                        got_plain = camr_shuffle(plan, c, **kw)
                    if not bitwise_equal(got, out):
                        fail(f"{where} {mode} {codec}: != fused batched")
                    if not bitwise_equal(got, got_plain):
                        fail(f"{where} {mode} {codec}: kernels != plain")
                dbg = camr_shuffle(plan, c, router=router, debug=True)
                if not bitwise_equal(dbg["out"], plain):
                    fail(f"{where}: debug out != plain")
                del out, plain, got, got_plain, dbg
        unc = uncoded_reduce_scatter(contribs, plan=plan)
        if not np.allclose(unc.cpu().numpy(), ref, rtol=2e-5, atol=2e-6):
            fail(f"uncoded reduce-scatter ({q},{k}): not close to reference")
        log(f"shuffle: (q,k)=({q},{k}) d={d} both routers bitwise == plain "
            "in f32 (allclose to the reference), bf16 and f16; multipass "
            "and looped lanes bitwise == fused batched (and == their plain "
            "runs); debug out == plain; uncoded allclose to the reference")


#: the waves' value width: about a quarter of the cell's d_shard
#: (37,095,084), a multiple of k-1; one f32 wave of contributions
#: [6, 2, 2, 6, d] is 5.34 GB
WAVE_D = 9_273_770
#: the worker failed in the degraded runs (every single failure of
#: q=2, k=3 has the same plan shape: R 24, G 2, E 2, 48 real elements)
FAILED = 2


def _device_waves(gen, plan, dtype, n):
    """``n`` random waves ``[K, J_own, k-1, K, d]`` made on the card from
    per-batch gradients ``[J, k, K, d]`` (every holder of a batch stores
    the same values, as the placement says), about one value in 997 a
    ``-0.0``, no NaN."""
    import torch
    jobs = torch.as_tensor(plan.owned_jobs[:, :, None].repeat(plan.k - 1, 2)
                           .astype("int64"), device=DEVICE)
    bats = torch.as_tensor(plan.stored_batches.astype("int64"),
                           device=DEVICE)
    out = []
    for _ in range(n):
        bg = torch.randn((plan.J, plan.k, plan.K, plan.d), generator=gen,
                         device=DEVICE).to(dtype)
        bg.view(-1)[::997] = -0.0
        out.append(bg[jobs, bats])
        del bg
    return out


def phase_waves(gen):
    """``ShuffleStream`` waves and its degraded lane at (q, k) = (2, 3),
    d = ``WAVE_D``, on the f32 and bf16 lanes: four waves through
    ``run_waves`` at ``wave_batch=2, depth=2``, each output bitwise the
    ``sync`` of its wave; the same waves with worker ``FAILED`` failed for
    the second stacked dispatch, bitwise the healthy outputs with
    ``compiles`` flat and ``swaps`` 2; the degraded executor bitwise the
    fault runtime's host interpreter on two column slices; no build at a
    degrade after ``warm_degraded_execs``. Logs ``wave_times`` and the
    degraded executor's ms beside its byte bound."""
    import numpy as np
    import torch
    from repro_torch.core.collective import ShuffleStream, make_plan
    from repro_torch.core.schedule import EXEC_CACHE, SCHEDULE_CACHE
    from repro_torch.runtime.fault import (degraded_dense_plan,
                                           degraded_shuffle_host)
    from repro_torch.runtime.train_loop import bf16_add
    q, k, d = 2, 3, WAVE_D
    plan = make_plan(q, k, d)
    a_idx, _, g_mask = degraded_dense_plan(plan.program, {FAILED})
    rows = len(a_idx)
    cols = column_slices(d, k)
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"waves[{str(dtype).removeprefix('torch.')}]"
        waves = _device_waves(gen, plan, dtype, 4)
        ref = ShuffleStream(q, k, d, device=DEVICE)
        want = [ref.sync(w).cpu() for w in waves]
        sync_ms = time_ms(lambda: ref.sync(waves[0]), warmup=1, reps=3)
        del ref
        s = ShuffleStream(q, k, d, device=DEVICE, wave_batch=2, depth=2)
        got = s.run_waves(waves)
        if len(got) != 4 or not all(bitwise_equal(g, w)
                                    for g, w in zip(got, want)):
            fail(f"{tag}: run_waves (wave_batch 2, depth 2) != sync")
        st0 = dict(s.stats())
        for i, w in enumerate(waves):
            if i == 2:
                s.degrade({FAILED})
            s.submit(w)
            if i == 3:
                s.restore()
        got = s.drain()
        st = s.stats()
        if not all(bitwise_equal(g, w) for g, w in zip(got, want)):
            fail(f"{tag}: degraded waves != healthy waves")
        if st["compiles"] != st0["compiles"] or st["swaps"] != 2:
            fail(f"{tag}: compiles {st0['compiles']} -> {st['compiles']}, "
                 f"swaps {st['swaps']} (want flat, 2)")
        log(f"{tag}: d={d}, 4 waves at wave_batch 2, depth 2 bitwise == "
            f"sync; with worker {FAILED} failed for waves 3-4 bitwise == "
            f"healthy, compiles {st['compiles']}, swaps {st['swaps']}, "
            f"degraded_compiles {st['degraded_compiles']}; wave_times ms "
            + ", ".join(f"{t * 1e3:.1f}" for t in s.wave_times))
        del got, s

        # the degraded executor (W = 1) against the host interpreter
        dev = ShuffleStream(q, k, d, device=DEVICE)
        dev.degrade({FAILED})
        out = dev.sync(waves[0])
        if not bitwise_equal(out.cpu(), want[0]):
            fail(f"{tag}: degraded sync != healthy sync")
        part = waves[0].index_select(4, cols).cpu()
        if dtype == torch.bfloat16:
            bits = part.view(torch.int16).numpy().view(np.uint16)
            host = degraded_shuffle_host(plan.program, {FAILED}, bits,
                                         combine=bf16_add)
            host = torch.from_numpy(host.view(np.int16)).view(dtype)
        else:
            host = torch.from_numpy(degraded_shuffle_host(
                plan.program, {FAILED}, part.numpy()))
        if not bitwise_equal(out.index_select(2, cols).cpu(), host):
            fail(f"{tag}: degraded executor != host interpreter")
        ms = time_ms(lambda: dev.sync(waves[0]), warmup=1, reps=5)
        nbytes = (2 * rows + int(g_mask.sum())) * d * dtype.itemsize
        log(f"{tag}: degraded executor bitwise == degraded_shuffle_host on "
            f"{cols.numel()} of {d} columns; {ms:.3f} ms (CUDA events) "
            f"against a byte bound of {nbytes / HBM_BYTES_PER_S * 1e3:.3f} "
            f"ms ({nbytes} bytes: {rows} rows of A, "
            f"{int(g_mask.sum())} folded, {rows} written); the healthy "
            f"sync {sync_ms:.3f} ms")
        del out, dev, waves, want
        torch.cuda.empty_cache()

    # the warm gate: every single-failure executor built before the
    # failure, so the degrade builds nothing
    EXEC_CACHE.clear()
    SCHEDULE_CACHE.warm_survivors(plan.program)
    s = ShuffleStream(q, k, d, device=DEVICE)
    n = s.warm_degraded_execs(max_failures=1)
    built = s.stats()["degraded_compiles"]
    (w,) = _device_waves(gen, plan, torch.float32, 1)
    s.degrade({FAILED})
    s.sync(w)
    if n != q * k or built != n or s.stats()["degraded_compiles"] != built:
        fail(f"waves: warm_degraded_execs {n}, built {built}, then "
             f"{s.stats()['degraded_compiles']} after a degrade")
    log(f"waves: warm_degraded_execs built {built} executors; the degrade "
        "and its sync built none")
    del s, w
    torch.cuda.empty_cache()


#: the two-level cell: (q, k, hosts) = (2, 4, 2) is the smallest (q, k)
#: whose phase B has traffic (at (2, 3) only hosts = 3 divides k, and
#: there no packet is relayed); d a multiple of k-1 = 3 at which one f32
#: wave [8, 4, 3, 8, d] is 5.44 GB, about the size of phase_waves' waves
TOPO_QKH = (2, 4, 2)
TOPO_D = 1_769_472
#: the gateways avoided in the failover run: the first device of each host
TOPO_AVOID = frozenset({0, 4})


def _gathers(dtype) -> tuple:
    """The fused gathers a shuffle of ``dtype`` launches (u32 words, or
    the packed 16-bit lane)."""
    import torch
    if dtype == torch.float32:
        return ("xor_encode_gather", "xor_decode_gather")
    return ("xor_encode_gather16", "xor_decode_gather16")


def _count_launches(fn):
    """``fn()``'s result and the kernel launches it made."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    return out, {n: c for n, c in launch_counts().items() if c}


def topology_gathers(plan, wave, verify):
    """The fused gathers of the two-level ``plan``'s lane on the lane's own
    inputs, in both coded stages: the wire buffer of ``wave`` (as int32
    words widened by the checksum word when ``verify``, else the lane's
    words or packed 16-bit lanes), its Δ, and the receive buffer that
    phase A and phase B build from it. Each kernel launch is held bitwise
    to its plain version on the same inputs; stage 1's pair is timed.
    Returns ``(names, row, ms)``: the kernels, the row width in words or
    lanes, and their stage-1 CUDA-event ms beside their plain versions'."""
    import torch
    from repro_torch.core import collective as C
    from repro_torch.core.schedule import payload_words
    k, K = plan.k, plan.K
    tabs = C._device_tables(plan, wave.device, "all_to_all")
    wp = payload_words(plan.d, wave.element_size(), k)
    pk = wp // (k - 1)
    if verify:
        wire, pkw = C._widen(C._wire_buffer(wave, wp, "multipass"), k,
                             pk), pk + 1
    else:
        wire, pkw = C._wire_buffer(wave, wp, "fused"), pk
    half = wire.dtype == torch.int16
    enc_fn, dec_fn, enc_ref, dec_ref, _ = _lane(half)
    row = 2 * pkw if half else pkw
    chunks = wire.reshape(K, -1, row)
    ms = {}
    for stage in (1, 2):
        st = tabs["stages"][stage]
        eargs = (chunks, st["enc_src"], st["src_ok"])
        delta = enc_fn(*eargs)
        if not bitwise_equal(delta, enc_ref(*eargs)):
            fail(f"{enc_fn.__name__} != plain on the two-level lane's "
                 f"stage-{stage} inputs (rows of {row})")
        recv = C._relay(C._exchange(delta.view(torch.int32), st, K=K, k=k,
                                    pk=pkw), st, {"stage12": 0}, pk=pkw)
        dargs = (recv.view(torch.int16) if half else recv, chunks,
                 st["dec_recv"], st["dec_src"], st["dec_mask"])
        if not bitwise_equal(dec_fn(*dargs), dec_ref(*dargs)):
            fail(f"{dec_fn.__name__} != plain on the two-level lane's "
                 f"stage-{stage} inputs (rows of {row})")
        if stage == 1:
            for fn, ref, args in ((enc_fn, enc_ref, eargs),
                                  (dec_fn, dec_ref, dargs)):
                ms[fn.__name__] = (time_ms(lambda: fn(*args)),
                                   time_ms(lambda: ref(*args), warmup=1,
                                           reps=3))
        del delta, recv, dargs
    return (enc_fn.__name__, dec_fn.__name__), row, ms


def phase_topology(gen):
    """The two-level topology, gateway failover and the self-verifying
    wire at ``TOPO_QKH``, d = ``TOPO_D``, on the f32 and bf16 lanes (waves
    with ``-0.0`` inside), each output held bitwise to the flat ``sync``
    of its wave: two-level ``sync`` under both routers and with gateways
    ``TOPO_AVOID`` avoided, launching the lane's gathers twice each;
    the verified ``sync``, launching the u32 gathers twice each at rows
    of pk+1 words on both lanes; one fault in stage 1 (a payload word)
    and one in stage 2 (the checksum word, ``bits=0x80000000``), each
    detected and replayed; ``WireCorruptionError`` on a
    ``max_replays=0`` stream; the gathers of the two-level and the verify
    lane held to their plain versions on each lane's own inputs
    (:func:`topology_gathers`); then four verified waves at
    ``wave_batch=2, depth=2`` with a fault on wave 1, host 1 killed
    (``HostMembership.kill_host``) before wave 2 and rejoined before
    wave 3, each dispatch drained before the next topology change so
    that waves 0-1 run on the two-level plan, wave 2 on the surviving
    flat one and wave 3 on the two-level one; ``host_swaps`` 2 and no
    schedule lowering after the first dispatch. Logs ``camr_edge_bytes``
    and the CUDA-event ms of the flat, two-level and verified syncs, of a
    verified sync with one replay and of the lanes' stage-1 gathers."""
    import torch
    from repro_torch.core.collective import (ShuffleStream, camr_edge_bytes,
                                             expected_collective_calls,
                                             make_plan)
    from repro_torch.core.schedule import (SCHEDULE_CACHE, Topology,
                                           payload_words)
    from repro_torch.runtime.fault import HostMembership, WireCorruptionError
    q, k, hosts = TOPO_QKH
    d, K = TOPO_D, q * k
    torch.cuda.reset_peak_memory_stats()
    topo = Topology.two_level(hosts)
    plan = make_plan(q, k, d)
    two = make_plan(q, k, d, topo)
    for dtype in (None, torch.bfloat16):
        eb = camr_edge_bytes(two, dtype=dtype)
        log(f"topology: camr_edge_bytes ({q},{k},{hosts}) d={d} "
            f"{'float32' if dtype is None else 'bfloat16'}: {json.dumps(eb)}")
    calls = {n: expected_collective_calls(p)["stage12"]
             for n, p in (("flat", plan), ("two_level", two))}
    relays = calls["two_level"] - calls["flat"]
    log(f"topology: collectives of stages 1-2 (JAX executor) flat "
        f"{calls['flat']}, two-level {calls['two_level']} ({relays} relay "
        "lanes)")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tag = f"topology[{name}]"
        lane = {n: 2 for n in _gathers(dtype)}
        word_lane = {n: 2 for n in _gathers(torch.float32)}
        waves = _device_waves(gen, plan, dtype, 4)
        flat = ShuffleStream(q, k, d, device=DEVICE)
        want = [flat.sync(w) for w in waves]
        ms = {"flat": time_ms(lambda: flat.sync(waves[0]), warmup=1,
                              reps=5)}
        runs = (("all_to_all", frozenset()), ("ppermute", frozenset()),
                ("all_to_all", TOPO_AVOID))
        for router, avoid in runs:
            s = ShuffleStream(q, k, d, device=DEVICE, topology=topo,
                              router=router, gateway_avoid=avoid)
            out, launched = _count_launches(lambda: s.sync(waves[0]))
            if not bitwise_equal(out, want[0]):
                fail(f"{tag}: two-level {router} avoid {sorted(avoid)} "
                     "!= flat sync")
            if launched != lane:
                fail(f"{tag}: two-level {router} launched {launched}, "
                     f"want {lane}")
            (p,) = s._plans.values()
            if p.permutations["stage12"] != relays:
                fail(f"{tag}: {p.permutations['stage12']} relay lanes run, "
                     f"want {relays}")
            if not avoid and router == "all_to_all":
                ms["two_level"] = time_ms(lambda: s.sync(waves[0]),
                                          warmup=1, reps=5)
            del s, out
        log(f"{tag}: two-level sync (all_to_all, ppermute, gateways "
            f"{sorted(TOPO_AVOID)} avoided) bitwise == flat sync, each "
            f"launching {lane} and running {relays} relay lanes")

        v = ShuffleStream(q, k, d, device=DEVICE, topology=topo,
                          verify_wire=True)
        out, launched = _count_launches(lambda: v.sync(waves[0]))
        if not bitwise_equal(out, want[0]) or v.wire_faults:
            fail(f"{tag}: clean verified sync != flat sync or flagged")
        if launched != word_lane:
            fail(f"{tag}: verify lane launched {launched}, want "
                 f"{word_lane}")
        pk = payload_words(d, dtype.itemsize, k) // (k - 1)
        log(f"{tag}: verify lane launched "
            + ", ".join(f"{n} {c}" for n, c in launched.items())
            + f" at rows of pk+1 = {pk + 1} words (the 16-bit gathers 0)")
        ms["verify"] = time_ms(lambda: v.sync(waves[0]), warmup=1, reps=5)
        faults = ((1, 0, 0, 1, waves[1], want[1]),
                  (2, K - 1, pk, 0x80000000, waves[2], want[2]))
        for stage, dev, word, bits, w, ref in faults:
            v.inject_corruption(stage=stage, device=dev, word=word,
                                bits=bits)
            if not bitwise_equal(v.sync(w), ref):
                fail(f"{tag}: replay of a stage-{stage} fault != flat sync")
        st = v.stats()
        if st["wire_faults"] != 2 or st["wire_replays"] != 2:
            fail(f"{tag}: wire_faults {st['wire_faults']}, wire_replays "
                 f"{st['wire_replays']} (want 2, 2)")

        def replayed():
            v.inject_corruption(stage=1, device=3, word=1, bits=0xFFFFFFFF)
            return v.sync(waves[3])
        ms["verify_replay"] = time_ms(replayed, warmup=1, reps=3)
        if not bitwise_equal(replayed(), want[3]):
            fail(f"{tag}: timed replays != flat sync")
        m = ShuffleStream(q, k, d, device=DEVICE, topology=topo,
                          verify_wire=True, max_replays=0)
        m.inject_corruption(stage=2, device=5, word=pk, bits=1)
        try:
            m.sync(waves[0])
        except WireCorruptionError:
            pass
        else:
            fail(f"{tag}: max_replays=0 let a corrupted wave through")
        for verify in (False, True):
            names, row, gms = topology_gathers(two, waves[0], verify)
            unit = "lanes" if names[0].endswith("16") else "words"
            log(f"{tag}: {' / '.join(names)} bitwise == plain on the "
                f"{'verify' if verify else 'two-level'} lane's own inputs "
                f"(rows of {row} {unit}, stages 1 and 2); stage-1 ms "
                "(CUDA events) "
                + ", ".join(f"{n} {a:.3f} (plain {b:.3f})"
                            for n, (a, b) in gms.items()))
        torch.cuda.empty_cache()
        log(f"{tag}: verified sync bitwise == flat sync; a stage-1 payload "
            f"fault and a stage-2 checksum fault (bits 0x80000000) each "
            f"detected and replayed bitwise (wire_faults "
            f"{st['wire_faults']}, wire_replays {st['wire_replays']}); "
            "WireCorruptionError at max_replays=0")
        log(f"{tag}: sync ms (CUDA events) flat {ms['flat']:.3f}, two-level "
            f"{ms['two_level']:.3f}, verified {ms['verify']:.3f}, verified "
            f"with one replay {ms['verify_replay']:.3f}")
        del v, m, flat
        torch.cuda.empty_cache()

        # verified waves through a host kill and rejoin, each dispatch on
        # the topology it was submitted under: waves 0-1 (a fault on wave
        # 1) stacked on the two-level plan, wave 2 alone on the surviving
        # (flat) one, wave 3 alone on the rejoined two-level one; a wave
        # is let go once submitted (a verified dispatch keeps its copy)
        hm = HostMembership(q, k, topo)
        s = ShuffleStream(q, k, d, device=DEVICE, wave_batch=2, depth=2,
                          topology=topo, verify_wire=True)
        s.warm_host_survivors()

        def feed(i):
            s.submit(waves[i])
            waves[i] = None

        feed(0)
        s.inject_corruption(stage=2, device=6, word=2, bits=0xFFFFFFFF)
        feed(1)
        got = s.drain()
        misses = SCHEDULE_CACHE.stats()["misses"]
        hm.kill_host(1)
        s.set_topology(hm.current_topology())
        if s.topology is not None:
            fail(f"{tag}: the surviving topology of (2, 4, 2) is not flat")
        feed(2)
        got += s.drain()
        hm.rejoin_host(1)
        s.set_topology(hm.current_topology())
        feed(3)
        got += s.drain()
        st = s.stats()
        if len(got) != 4 or not all(bitwise_equal(g, x.cpu())
                                    for g, x in zip(got, want)):
            fail(f"{tag}: kill/rejoin waves != flat syncs")
        tk = topo.key()
        if set(s._plans) != {(2, tk, ()), (1, None, ()), (1, tk, ())}:
            fail(f"{tag}: dispatched on {sorted(map(str, s._plans))}, want "
                 "waves 0-1 two-level, 2 flat, 3 two-level")
        if (st["host_swaps"] != 2 or st["wire_faults"] != 1
                or SCHEDULE_CACHE.stats()["misses"] != misses):
            fail(f"{tag}: host_swaps {st['host_swaps']}, wire_faults "
                 f"{st['wire_faults']}, schedule misses {misses} -> "
                 f"{SCHEDULE_CACHE.stats()['misses']} (want 2, 1, flat)")
        log(f"{tag}: 4 verified waves (wave_batch 2, depth 2) through "
            f"kill_host(1) / rejoin_host(1), dispatched as waves 0-1 on "
            f"the two-level plan, 2 on the surviving flat one, 3 on the "
            f"rejoined two-level one, bitwise == flat sync; "
            f"host_swaps {st['host_swaps']}, wire_faults "
            f"{st['wire_faults']}, wire_replays {st['wire_replays']}, no "
            f"schedule lowering after the first dispatch; wave_times ms "
            + ", ".join(f"{t * 1e3:.1f}" for t in s.wave_times))
        del s, got, waves, want
        torch.cuda.empty_cache()
    log(f"topology: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB (the f32 cell of phase 3 resident)")


# --------------------------------------------------------------------- #
# phase 3: the slice's main path
# --------------------------------------------------------------------- #
def _tag(tr, pipe=None) -> str:
    from repro_torch.configs import get_config
    from repro_torch.launch.cell import ARCH, SEQ_LEN
    codec = "" if tr.codec == "fused" else f"/{tr.codec}"
    arch = ("" if tr.cfg.name == get_config(ARCH).name
            else f"{tr.cfg.name}/")
    seq = ("" if pipe is None or pipe.seq_len == SEQ_LEN
           else f"@{pipe.seq_len}")
    return f"train[{arch}{tr.grad_sync_dtype}{codec}{seq}]"


def build_cell(grad_sync_dtype, codec="fused", **arch):
    """The slice's trainer and pipeline (``repro_torch.launch.cell``) on
    one grad-sync lane and codec; ``arch`` (``arch=``, ``n_layers=``,
    ``seq_len=``) puts another config or sequence length in the cell's
    place."""
    import torch
    from repro_torch.launch.cell import make_cell
    t0 = time.perf_counter()
    tr, pipe = make_cell(DEVICE, grad_sync_dtype, codec, **arch)
    torch.cuda.synchronize()
    log(f"{_tag(tr, pipe)}: {tr.cfg.name} {tr.cfg.n_layers} layers, "
        f"D={tr.D} Dpad={tr.Dpad} d_shard={tr.d_shard}, K={tr.K} J={tr.J}, "
        f"seq_len {pipe.seq_len}, init {time.perf_counter() - t0:.1f} s")
    return tr, pipe


def lane_kernels(lane: str, K: int, codec: str = "fused") -> dict:
    """Kernel launches per step on a grad-sync lane and codec: one encode
    (a fused gather or the multipass fold) and one decode per coded
    stage, one combiner launch per worker."""
    names = {("float32", "fused"): ("xor_encode_gather", "xor_decode_gather",
                                    "aggregate"),
             ("bfloat16", "fused"): ("xor_encode_gather16",
                                     "xor_decode_gather16", "aggregate_bf16"),
             ("float32", "multipass"): ("xor_fold", "xor_decode",
                                        "aggregate")}[lane, codec]
    return dict(zip(names, (2, 2, K)))


#: the SSM-family training run: mamba2_1p3b at full width cut to 2 layers
#: (D = 257,693,952, 1.16x the granite cell's), the cell's q, k and
#: pipeline, the f32 fused lane
SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS = "mamba2_1p3b", 2
#: the hybrid-family training run: zamba2_2p7b at full width cut to one
#: pattern unit (6 sublayers: 5 SSM layers and the shared attention
#: block), on the bf16 lane: its D of 467,989,280 would need about 109 GB
#: on the f32 lane; on the bf16 one its peak is 78.7 GB of the card's 85.0
HYBRID_TRAIN_ARCH, HYBRID_TRAIN_LAYERS = "zamba2_2p7b", 6
#: the MoE-family training run: moonshot_v1_16b_a3b with its 64 experts,
#: top-6 and capacity 1.25, d_model 2048 and its 16 heads of 128, cut to
#: one layer, d_ff 512 (from 1408) and a vocab of 16,384 (from 163,840):
#: D = 285,349,888, about the most the f32 lane holds (the granite cell
#: peaks at 233 bytes a parameter, 51.8 GB at D 222,570,496); at full
#: width one layer and its vocabulary are 1.24 B parameters
MOE_TRAIN_ARCH = "moonshot_v1_16b_a3b"
MOE_TRAIN_CUT = dict(n_layers=1, d_ff=512, vocab=16384)


def column_slices(d, k):
    """Value columns of a shard of width ``d`` to hold on the host: one
    slice at the head and one across the boundary of the first packet
    (every step of the codec and of the degraded fold is per column)."""
    import torch
    pk = d // (k - 1)
    w = min(1 << 16, pk // 2) // (k - 1) * (k - 1)    # (k-1) | 3w
    return torch.cat([torch.arange(0, w), torch.arange(pk - w, pk + w)]
                     ).to(DEVICE)


def param_slices(tr):
    """The trainer's f32 master ``[J, Dpad]`` on :func:`column_slices` of
    every worker's shard, copied to the host."""
    import torch
    cols = column_slices(tr.d_shard, tr.k)
    idx = torch.cat([s * tr.d_shard + cols for s in range(tr.K)])
    return tr.flat.index_select(1, idx).cpu()


def phase_train(tr, pipe, steps=2):
    """``steps`` steps of the main path on the trainer's lane, with the
    launch counts of that run alone; returns (counts, report, peak)."""
    import numpy as np
    import torch
    from repro_torch.core.collective import camr_shuffle, make_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    q, k, lane = tr.q, tr.k, tr.grad_sync_dtype
    tag = _tag(tr, pipe)

    # step 1's synced gradient on a column slice (the codec is per value
    # column): one slice at the head, one across the packet boundary
    cols = column_slices(tr.d_shard, k)
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
    want.update({n: c * steps
                 for n, c in lane_kernels(lane, tr.K, tr.codec).items()})
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
        log(f"{tag}: step {i + 1} {phase_total(ms):.1f} ms = "
            + phase_list(ms))
    log(f"{tag}: {steps} steps {wall:.2f} s wall, peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) of {total / 1e9:.1f} "
        f"GB, wire bytes {rep.bytes_total} ({rep.bytes_total // steps} per "
        "step)")

    # the fused runs against the plain versions; the multipass run, whose
    # codec is the fused codec's oracle, against the fused kernels
    plan = make_plan(q, k, captured["contribs"].shape[-1])
    fused = tr.codec == "fused"
    with plain_codec() if fused else contextlib.nullcontext():
        want_out = camr_shuffle(plan, captured["contribs"])
    what = "plain" if fused else "fused-kernel"
    if (captured["out"].dtype != getattr(torch, lane)
            or not bitwise_equal(captured["out"], want_out)):
        fail(f"{tag}: step 1 synced gradient != {what} shuffle of the same "
             "contributions")
    log(f"{tag}: step 1 synced gradient ({lane}) bitwise == {what} shuffle "
        f"on {cols.numel()} of {tr.d_shard} columns per shard")
    return counts, rep, peak


def phase_churn(p32, rep32):
    """A kill/rejoin run of the f32 cell: the cell's seed and pipeline,
    step 1 healthy, step 2 with worker ``FAILED`` failed (the stream's
    degraded executor in place of the coded shuffle), step 3 restored.
    The parameters after step 2 are bitwise the phase-3 f32 run's
    (``p32``, :func:`param_slices`) and the losses its losses (``rep32``);
    the stream built its healthy executor once and swapped twice; step
    2 launches no gather and the combiner once a worker."""
    import numpy as np
    import torch
    from repro_torch.core.collective import camr_shuffle, make_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    tr, pipe = build_cell("float32")
    tag = "churn[float32]"
    cols = column_slices(tr.d_shard, tr.k)
    captured = {}
    sync = tr._sync_spmd

    def capture(contribs, report):     # the degraded step's, on the slices
        out = sync(contribs, report)
        if tr.failed:
            captured["contribs"] = contribs.index_select(4, cols)
            captured["out"] = out.index_select(2, cols)
        return out

    tr._sync_spmd = capture
    steps = []
    try:
        for failed in (None, {FAILED}, None):
            tr.set_failed(failed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            rep = tr.train_steps(pipe, 1, mode="camr_spmd")
            torch.cuda.synchronize()
            steps.append((launch_counts(), rep,
                          torch.cuda.max_memory_allocated()))
            if failed:
                after2 = param_slices(tr)
    finally:
        del tr._sync_spmd
    healthy = lane_kernels("float32", tr.K)
    for i, (counts, rep, _) in enumerate(steps):
        want = dict.fromkeys(counts, 0)
        want.update(healthy if i != 1 else
                    {n: c for n, c in healthy.items()
                     if n.startswith("aggregate")})
        if counts != want:
            fail(f"{tag}: step {i + 1} launches {counts} != {want}")
    # the degraded sync against the healthy shuffle of the same
    # contributions (the executor alone, whatever the map gave)
    plan = make_plan(tr.q, tr.k, cols.numel())
    if not bitwise_equal(captured["out"],
                         camr_shuffle(plan, captured["contribs"])):
        fail(f"{tag}: the degraded step's synced gradient != the healthy "
             "shuffle of its contributions")
    if not bitwise_equal(after2, p32):
        fail(f"{tag}: parameters after the degraded step 2 != the f32 "
             "run's after its step 2")
    losses = [rep.losses[0] for _, rep, _ in steps]
    if losses[:2] != rep32.losses:
        fail(f"{tag}: losses {losses[:2]} != the f32 run's {rep32.losses}")
    st = tr._stream.stats()
    if st["compiles"] != 1 or st["swaps"] != 2 or st["failed"] != ():
        fail(f"{tag}: stream stats {st} (want compiles 1, swaps 2)")
    if not np.isfinite(losses[2]).all():
        fail(f"{tag}: step 3 losses not finite: {losses[2]}")
    ms = steps[1][1].phase_ms[0]
    log(f"{tag}: steps healthy / worker {FAILED} failed / restored: "
        f"parameters after step 2 bitwise == the f32 run's on "
        f"{after2.numel() // tr.J} columns a job, losses bitwise; stream "
        f"compiles {st['compiles']}, swaps {st['swaps']}, "
        f"degraded_compiles {st['degraded_compiles']}")
    log(f"{tag}: degraded step's synced gradient bitwise == the healthy "
        f"shuffle of its contributions on {cols.numel()} of {tr.d_shard} "
        "columns; launches by step "
        + " / ".join(str({n: c[n] for n in healthy}) for c, _, _ in steps))
    log(f"{tag}: degraded step 2 {phase_total(ms):.1f} ms = "
        + phase_list(ms)
        + f"; peak memory {steps[1][2] / 1e9:.2f} GB (healthy steps "
        f"{steps[0][2] / 1e9:.2f} / {steps[2][2] / 1e9:.2f} GB)")
    del tr, pipe


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


def compare_codecs(rep32, peak32, rep_mp, peak_mp):
    """The multipass run against the fused f32 run of the same cell."""
    import numpy as np
    l32, lmp = np.asarray(rep32.losses[0]), np.asarray(rep_mp.losses[0])
    if not np.allclose(lmp, l32, rtol=1e-6, atol=0):
        fail(f"train: multipass step 1 losses {lmp} != f32 step 1 {l32} "
             "(rtol 1e-6)")
    if rep_mp.bytes_total != rep32.bytes_total:
        fail(f"train: multipass wire bytes {rep_mp.bytes_total} != fused "
             f"{rep32.bytes_total}")
    log(f"train: multipass step 1 losses == f32 step 1 within rtol 1e-6 "
        f"(bitwise: {bool((lmp == l32).all())}; all steps bitwise: "
        f"{rep_mp.losses == rep32.losses}); peak memory "
        f"{peak_mp / 1e9:.2f} GB against the fused run's "
        f"{peak32 / 1e9:.2f} GB")


# --------------------------------------------------------------------- #
# phase 3, continued: the chunked attention lane and the paper's modes
# --------------------------------------------------------------------- #
#: the chunked attention run: the granite cell at 2048 tokens, where
#: Tq*Tk = 2**22 is past the 2**21 switch point of the attention lanes
CHUNK_SEQ_LEN = 2048
#: the dense tolerances of tests/test_torch_train.py: loss rtol, flat
#: gradient rtol and atol
DENSE_TOL = (1e-5, 1e-4, 1e-6)


@contextlib.contextmanager
def count_chunked():
    """Count the calls of the chunked attention lane (a list of one)."""
    from repro_torch.kernels import ops
    saved, calls = ops.flash_attention_chunked, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return saved(*a, **kw)
    ops.flash_attention_chunked = counted
    try:
        yield calls
    finally:
        ops.flash_attention_chunked = saved


@contextlib.contextmanager
def no_block_checkpoint():
    """The chunked lane with its block steps not checkpointed (autograd
    keeps every block's scores): for the peak memory it saves."""
    from repro_torch.kernels import ref
    saved = ref.checkpoint
    ref.checkpoint = lambda fn, *a, use_reentrant=False: fn(*a)
    try:
        yield
    finally:
        ref.checkpoint = saved


def check_chunked_lane(tr, pipe):
    """One subfile's loss and flat gradient through the chunked lane
    against the materialized attention at the same tokens, on the card,
    at the dense tolerances: job 0's f32 master row as an f32 model (so
    both lanes compute in f32; TF32 off)."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.train_loop import _full_f32
    from repro_torch.weights import unravel

    cfg = tr.cfg.replace(dtype="float32")
    spec = dataclasses.replace(tr._spec, dtypes=(torch.float32,)
                               * len(tr._spec.dtypes))
    batch = {key: torch.as_tensor(v, device=DEVICE)
             for key, v in pipe.batch(0).items()}
    out = {}
    for lane, threshold in (("chunked", ops.CHUNK_THRESHOLD),
                            ("materialized", float("inf"))):
        saved, ops.CHUNK_THRESHOLD = ops.CHUNK_THRESHOLD, threshold
        try:
            with _full_f32(torch.device(DEVICE)), count_chunked() as calls:
                row = tr.flat[0, :tr.D].clone().requires_grad_(True)
                loss, _ = lm.train_loss(cfg, unravel(row, spec), batch)
                grad, = torch.autograd.grad(loss, row)
        finally:
            ops.CHUNK_THRESHOLD = saved
        if calls[0] != (cfg.n_layers if lane == "chunked" else 0):
            fail(f"chunked lane: {lane} run took the chunked attention "
                 f"{calls[0]} times")
        out[lane] = (float(loss.detach()), grad)
        del row
    (l1, g1), (l2, g2) = out["chunked"], out["materialized"]
    rtol_l, rtol_g, atol_g = DENSE_TOL
    excess = float(((g1 - g2).abs() / (atol_g + rtol_g * g2.abs())).max())
    log(f"chunked lane @{pipe.seq_len}: loss {l1!r} vs materialized "
        f"{l2!r} (rel {abs(l1 - l2) / abs(l2):.3g}, rtol {rtol_l}); flat "
        f"gradient worst |diff| / (atol + rtol |g|) = {excess:.3g} "
        f"(rtol {rtol_g}, atol {atol_g}); max |g| "
        f"{float(g2.abs().max()):.3g}")
    if abs(l1 - l2) > rtol_l * abs(l2) or not excess <= 1.0:
        fail("chunked lane: loss or flat gradient off the materialized "
             "attention's beyond the dense tolerances")


def phase_chunked():
    """The granite cell at ``CHUNK_SEQ_LEN`` tokens on the f32 lane at
    ``remat="none"`` (a unit's recompute would run the chunked lane a
    second time and its checkpoint would hide the block steps' saving):
    the main path's gates (launch counts, step 1's synced gradient
    bitwise the plain shuffle, finite losses, peak memory), the chunked
    lane taken in every attention call of the map, one subfile held to
    the materialized attention, and the memory one subfile's map and one
    more step take with the block steps not checkpointed."""
    import torch
    tr, pipe = build_cell("float32", seq_len=CHUNK_SEQ_LEN, remat="none")
    tag = _tag(tr, pipe)
    log(f"{tag}: remat {tr.cfg.remat} (the block steps' own checkpoint "
        "measured alone)")
    with count_chunked() as calls:
        _, _, peak = phase_train(tr, pipe)
    want = tr.J * tr.N * tr.cfg.n_layers * 2
    if calls[0] != want:
        fail(f"{tag}: the map took the chunked attention {calls[0]} "
             f"times, not {want}")
    log(f"{tag}: chunked attention in all {calls[0]} attention calls of "
        "the map")
    check_chunked_lane(tr, pipe)
    # what the block checkpoint saves: one subfile's map above the
    # resident state, then a whole step, each without it
    batch = pipe.batch(0)
    tr._last_loss = [dict() for _ in range(tr.J)]
    maps = []
    for ctx in (contextlib.nullcontext, no_block_checkpoint):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ctx():
            row = tr._grad_vec(0, 0, batch)
        torch.cuda.synchronize()
        maps.append(torch.cuda.max_memory_allocated() - base)
        del row
    torch.cuda.reset_peak_memory_stats()
    with no_block_checkpoint():
        tr.train_steps(pipe, 1)
    torch.cuda.synchronize()
    peak_nockpt = torch.cuda.max_memory_allocated()
    log(f"{tag}: one subfile's map {maps[0] / 1e9:.3f} GB above the "
        f"resident state with the block steps checkpointed, "
        f"{maps[1] / 1e9:.3f} GB without; step peak {peak / 1e9:.2f} GB "
        f"with, {peak_nockpt / 1e9:.2f} GB for a step without")


def check_remat_map(tr, pipe):
    """One subfile's map gradient of the cell (job 0, subfile 0), as the
    trainer computes it, at the config's ``remat`` (``"block"``) and at
    ``"none"``, twice each in turns: the four rows bitwise equal. Logs
    the map ms (host clock to a synchronise) and its peak above the
    resident state, each way."""
    import torch
    from repro_torch.runtime.train_loop import _full_f32
    tag = _tag(tr, pipe)
    cfg, batch = tr.cfg, pipe.batch(0)
    if cfg.remat != "block":
        fail(f"{tag}: the cell trains at remat {cfg.remat!r}, not JAX's "
             "default 'block'")
    tr._last_loss = [dict() for _ in range(tr.J)]
    rows, ms, peaks = {}, {}, {}
    try:
        for remat in ("block", "none", "none", "block"):
            tr.cfg = cfg.replace(remat=remat)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _full_f32(torch.device(DEVICE)):
                row = tr._grad_vec(0, 0, batch)
            torch.cuda.synchronize()
            ms.setdefault(remat, []).append(1e3 * (time.perf_counter() - t0))
            peaks.setdefault(remat, []).append(
                torch.cuda.max_memory_allocated() - base)
            if remat in rows and not bitwise_equal(rows[remat], row):
                fail(f"{tag}: two map gradients at remat {remat} differ")
            rows.setdefault(remat, row)
    finally:
        tr.cfg = cfg
    if not bitwise_equal(rows["block"], rows["none"]):
        n = int((_bits(rows["block"]) != _bits(rows["none"])).sum())
        fail(f"{tag}: the map gradient at remat block differs from remat "
             f"none in {n} of {rows['none'].numel()} values")
    log(f"{tag}: one subfile's map gradient ({rows['none'].numel()} values) "
        f"bitwise equal at remat block and none; map ms block "
        f"{', '.join(f'{v:.2f}' for v in ms['block'])}, none "
        f"{', '.join(f'{v:.2f}' for v in ms['none'])}; peak above the "
        f"resident state block {peaks['block'][0] / 1e9:.3f} GB, none "
        f"{peaks['none'][0] / 1e9:.3f} GB")


#: the paper's three modes at a reduced width (the host engine XORs bytes
#: in Python, so a camr step at this D takes seconds of host time):
#: granite_3_2b's layout (2 layers, heads of 64, GQA 4:1, SwiGLU at 4x,
#: tied embeddings, bf16 weights) at d_model 256 and vocab 6144,
#: D = 3,474,688
MODES_CFG = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
                 head_dim=64, d_ff=1024, vocab=6144)
MODES_SEQ_LEN = 64


def phase_modes(rep32):
    """The paper's comparison on the card: ``camr_spmd``, ``camr`` and
    ``uncoded`` trainers from one seed, 2 steps each, on the f32 and the
    bf16 lanes, at ``MODES_CFG``: parameters and losses bitwise equal
    across the modes of a lane, and after a step 2 with worker
    ``FAILED`` failed bitwise the healthy run's (``camr_spmd`` on both
    lanes, ``camr`` on f32), the engine-measured bf16 ``camr`` bytes
    exactly half the f32 run's, the two lanes' trajectories apart, each
    run's launches its own (the host modes launch no kernel); then one
    ``uncoded`` step of the full granite cell (step 1's losses those of
    the f32 ``camr_spmd`` run ``rep32``). Prints the loads and bytes of
    ``camr`` against ``uncoded``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardedTokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.cell import ARCH, Q, K
    from repro_torch.runtime import MultiModelCAMRTrainer

    cfg = get_config(ARCH).replace(**MODES_CFG)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=MODES_SEQ_LEN,
                                global_batch=1)
    runs = {}
    for lane in ("float32", "bfloat16"):
        for mode in ("camr_spmd", "camr", "uncoded"):
            tr = MultiModelCAMRTrainer(cfg, q=Q, k=K, seed=0, device=DEVICE,
                                       grad_sync_dtype=lane)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            rep = tr.train_steps(pipe, 2, mode=mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            want = dict.fromkeys(counts, 0)
            if mode == "camr_spmd":
                want.update({n: 2 * c for n, c in
                             lane_kernels(lane, tr.K).items()})
            tag = f"modes[{lane}/{mode}]"
            if counts != want:
                fail(f"{tag}: launch counts {counts} != expected {want}")
            if not np.isfinite(np.asarray(rep.losses)).all():
                fail(f"{tag}: losses not finite: {rep.losses}")
            runs[lane, mode] = (tr.flat.cpu(), rep)
            log(f"{tag}: D={tr.D}, 2 steps {wall:.2f} s wall; " + "; ".join(
                f"step {i + 1} " + phase_list(ms)
                for i, ms in enumerate(rep.phase_ms))
                + f" ms; bytes {rep.bytes_total}, loads {rep.loads}")
            del tr
        flat0, rep0 = runs[lane, "camr_spmd"]
        for mode in ("camr", "uncoded"):
            flat, rep = runs[lane, mode]
            if not bitwise_equal(flat, flat0) or rep.losses != rep0.losses:
                fail(f"modes[{lane}]: {mode} parameters or losses != "
                     "camr_spmd's (bitwise)")
        log(f"modes[{lane}]: camr_spmd == camr == uncoded, parameters "
            f"({flat0.numel()} f32) and losses bitwise, 2 steps")
        # the churn: step 2 with worker FAILED failed (camr's engine is
        # the Python XOR, seconds a step: f32 only)
        for mode in ("camr_spmd", "camr")[:2 if lane == "float32" else 1]:
            tr = MultiModelCAMRTrainer(cfg, q=Q, k=K, seed=0, device=DEVICE,
                                       grad_sync_dtype=lane)
            reset_launch_counts()
            t0 = time.perf_counter()
            rep = tr.train_steps(pipe, 1, mode=mode)
            tr.set_failed({FAILED})
            rep.losses += tr.train_steps(pipe, 1, mode=mode).losses
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            want = dict.fromkeys(counts, 0)
            if mode == "camr_spmd":
                # step 1's codec kernels, both steps' combiner launches
                want.update({n: 2 * c if n.startswith("aggregate") else c
                             for n, c in lane_kernels(lane, tr.K).items()})
            tag = f"modes[{lane}/{mode}/churn]"
            if counts != want:
                fail(f"{tag}: launch counts {counts} != expected {want}")
            flat, rep0 = runs[lane, mode]
            if not bitwise_equal(tr.flat.cpu(), flat) or \
                    rep.losses != rep0.losses:
                fail(f"{tag}: parameters or losses after the degraded step "
                     "2 != the healthy run's (bitwise)")
            log(f"{tag}: worker {FAILED} failed in step 2: parameters and "
                f"losses bitwise == the healthy {mode} run; 2 steps "
                f"{wall:.2f} s wall")
            del tr
    b32, b16 = (runs[lane, "camr"][1].bytes_total
                for lane in ("float32", "bfloat16"))
    if 2 * b16 != b32:
        fail(f"modes: bf16 camr bytes {b16} are not half of f32's {b32}")
    f32, f16 = runs["float32", "camr"], runs["bfloat16", "camr"]
    if bitwise_equal(f32[0], f16[0]) or f32[1].losses[1] == f16[1].losses[1]:
        fail("modes: the bf16 lane's trajectory equals the f32 lane's")
    for lane in ("float32", "bfloat16"):
        c, u = runs[lane, "camr"][1], runs[lane, "uncoded"][1]
        log(f"modes[{lane}]: paper load L_total_bus camr "
            f"{c.loads['L_total_bus']:.4f} vs uncoded "
            f"{u.loads['L_total_bus']:.4f}; bytes camr {c.bytes_total} vs "
            f"uncoded {u.bytes_total} ({c.bytes_total / u.bytes_total:.4f})")
    log(f"modes: bf16 camr bytes {b16} = f32's {b32} / 2 exactly; the "
        "lanes' parameters and step-2 losses differ")

    # one uncoded step of the full cell: host memory and host time
    tr, pipe = build_cell("float32")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = tr.train_steps(pipe, 1, mode="uncoded")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(launch_counts().values()):
        fail(f"modes[cell/uncoded]: kernel launches {launch_counts()}")
    if not np.allclose(rep.losses[0], rep32.losses[0], rtol=1e-6, atol=0):
        fail(f"modes[cell/uncoded]: step 1 losses {rep.losses[0]} != the "
             f"camr_spmd run's {rep32.losses[0]}")
    ms = rep.phase_ms[0]
    log(f"modes[cell/uncoded]: D={tr.D}, step 1 {wall:.2f} s wall = "
        + phase_list(ms)
        + f" ms; bytes {rep.bytes_total}, loads {rep.loads}; step 1 losses "
        f"== camr_spmd's within rtol 1e-6 (bitwise: "
        f"{rep.losses[0] == rep32.losses[0]})")
    del tr, pipe
    return {lane: (runs[lane, "camr"][1].loads,
                   runs[lane, "camr"][1].bytes_total // 2)
            for lane in ("float32", "bfloat16")}


def phase_oracle(camr):
    """One ``camr_spmd`` step with ``spmd_oracle=True`` at ``MODES_CFG`` on
    the f32 and the bf16 lane: the numpy engine runs beside the shuffle
    on the same memo rows and asserts the synced gradient bitwise (no
    assertion may fire); the step's loads and bytes must be those of a
    ``camr`` step of ``phase_modes`` (``camr``: its loads, bytes per
    step), and the lane's kernels launch once each a coded stage and once
    a worker. Prints the step's split: its "shuffle" phase is the device
    sync plus the oracle's host engine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardedTokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.cell import ARCH, Q, K
    from repro_torch.runtime import MultiModelCAMRTrainer

    cfg = get_config(ARCH).replace(**MODES_CFG)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=MODES_SEQ_LEN,
                                global_batch=1)
    for lane in ("float32", "bfloat16"):
        tag = f"oracle[{lane}]"
        tr = MultiModelCAMRTrainer(cfg, q=Q, k=K, seed=0, device=DEVICE,
                                   grad_sync_dtype=lane, spmd_oracle=True)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rep = tr.train_steps(pipe, 1, mode="camr_spmd")
        except AssertionError as e:
            fail(f"{tag}: {e}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(lane_kernels(lane, tr.K))
        if counts != want:
            fail(f"{tag}: launch counts {counts} != expected {want}")
        loads, nbytes = camr[lane]
        if rep.loads != loads or rep.bytes_total != nbytes:
            fail(f"{tag}: loads {rep.loads}, bytes {rep.bytes_total} != the "
                 f"camr step's {loads}, {nbytes}")
        if not np.isfinite(np.asarray(rep.losses)).all():
            fail(f"{tag}: losses not finite: {rep.losses}")
        ms = rep.phase_ms[0]
        log(f"{tag}: D={tr.D}, synced gradient bitwise == the engine's; "
            f"loads and bytes ({rep.bytes_total}) == the camr step's; "
            f"launches {dict((n, c) for n, c in counts.items() if c)}; "
            f"step {wall:.2f} s wall = " + phase_list(ms)
            + " ms (shuffle: the device sync and the oracle's host engine; "
            "aggregate: the combiner and the memo's copy to the host)")
        del tr


#: the single-model checkpoint run: the cell's model, four steps, a save
#: every second one
CKPT_STEPS, CKPT_EVERY = 4, 2


def phase_checkpoint():
    """The single-model ``Trainer`` on the card with checkpoints: the
    cell's ``granite_3_2b`` (full width, ``N_LAYERS`` layers, ``SEQ_LEN``
    tokens, batch 1) in a temporary directory. Run A: ``CKPT_STEPS``
    steps saving every ``CKPT_EVERY`` (async writes), its state copied to
    the host as each save returns. The crash: one leaf file of the last
    step is deleted. Run B, from another seed: ``resume()`` must warn
    "failed verification" and land on step 2 with A's row and moments
    bitwise; after 2 more steps its state must be bitwise A's last. No
    kernel launches (the single-model loop trains on the plain lane).
    Prints the bytes a checkpoint holds, the host copy's ms on the
    training thread, the writer's seconds and GB/s, the load-and-verify
    seconds of a step, and A's step ms with a save and without."""
    import shutil
    import tempfile
    import warnings
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ShardedTokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.cell import ARCH, N_LAYERS, SEQ_LEN
    from repro_torch.runtime import Trainer

    cfg = get_config(ARCH).replace(n_layers=N_LAYERS)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=SEQ_LEN,
                                global_batch=1)
    state = lambda tr: [t.to("cpu", copy=True)
                        for t in (tr.flat, tr.opt.mu, tr.opt.nu, tr.opt.step)]
    same = lambda x, y: all(bitwise_equal(a, b) for a, b in zip(x, y))
    root = tempfile.mkdtemp(prefix="camr_ckpt_")
    try:
        a = Trainer(cfg, ckpt_dir=root, seed=0, device=DEVICE)
        snaps, marks, snap_s = {}, [], {}
        step_fn, save_fn = a._train_step, a.ckpt.save

        def timed_step(batch):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return step_fn(batch)

        def save(tree, *, step, metadata=None):
            save_fn(tree, step=step, metadata=metadata)
            t0 = time.perf_counter()
            snaps[step] = state(a)      # the check's copy, not timed
            snap_s[step] = time.perf_counter() - t0

        a._train_step, a.ckpt.save = timed_step, save
        torch.cuda.synchronize()
        reset_launch_counts()
        a.run(pipe, CKPT_STEPS, ckpt_every=CKPT_EVERY)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if any(launch_counts().values()):
            fail(f"checkpoint: kernel launches {launch_counts()}")
        stats = a.ckpt.stats
        a.ckpt.close()
        del a._train_step, a.ckpt.save, a
        gc.collect()
        torch.cuda.empty_cache()
        if sorted(snaps) != [2, 4]:
            fail(f"checkpoint: saves at steps {sorted(snaps)}, want [2, 4]")
        last = os.path.join(root, "step_00000004")
        os.remove(os.path.join(last, "params.embed.npy"))

        b = Trainer(cfg, ckpt_dir=root, seed=1, device=DEVICE)
        if bitwise_equal(b.flat.cpu(), snaps[2][0]):
            fail("checkpoint: run B's initial row is run A's")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            ok = b.resume()
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        warned = [str(w.message) for w in caught
                  if "failed verification" in str(w.message)]
        if not ok or b.step != 2 or len(warned) != 1 \
                or "step_00000004" not in warned[0]:
            fail(f"checkpoint: resume() {ok} at step {b.step}, warnings "
                 f"{[str(w.message) for w in caught]} (want step 2 and one "
                 "'failed verification' of step_00000004)")
        if not same(state(b), snaps[2]):
            fail("checkpoint: resumed row and moments != run A's at step 2")
        t0 = time.perf_counter()
        load_checkpoint(root, b.state_tree(), step=2)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        b.run(pipe, CKPT_STEPS - 2)
        if not same(state(b), snaps[4]):
            fail("checkpoint: row and moments after the resumed steps 3-4 "
                 "!= run A's after step 4")
        del b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ms = [(y - x - snap_s.get(i + 1, 0.0)) * 1e3
          for i, (x, y) in enumerate(zip(marks, marks[1:]))]
    nbytes = stats[0]["bytes"]
    log(f"checkpoint: {cfg.name} {cfg.n_layers} layers, {nbytes} bytes a "
        "checkpoint (parameters in their dtypes, f32 moments); saves at "
        f"steps {[r['step'] for r in stats]}: host copy on the training "
        "thread " + ", ".join(f"{r['copy_s'] * 1e3:.1f}" for r in stats)
        + " ms; writer " + ", ".join(
            f"{r['write_s']:.2f} s ({nbytes / r['write_s'] / 1e9:.2f} GB/s)"
            for r in stats))
    log(f"checkpoint: step ms (host clock, synchronized; the check's own "
        f"copies of the state left out) "
        + ", ".join(f"{i + 1}: {v:.1f}" for i, v in enumerate(ms))
        + f" (step 2 with a save, step 3 without while the writer runs, "
        f"step 4 with a save and the run's final wait); load and verify "
        f"of step 2 {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} GB/s); "
        f"resume with the corrupt step 4 skipped {resume_s:.2f} s")
    log("checkpoint: step 4 with a deleted leaf file skipped with a "
        "'failed verification' warning; resumed at step 2 bitwise run A's "
        "row and moments; after steps 3-4 bitwise run A's; no kernel "
        "launch")


#: the process lane's case: TOPO_QKH's (q, k), two processes of 4
#: workers, d = TOPO_D; the seconds a child may take
PG_TIMEOUT = 300


def _pg_cases():
    """(layout, dtype, router, codec) of the process lane's runs."""
    fused = [(lay, dt, router, "fused")
             for lay in ("flat", "two_level")
             for dt in ("float32", "bfloat16")
             for router in ("all_to_all", "ppermute")]
    return fused + [(lay, dt, "all_to_all", "multipass")
                    for lay in ("flat", "two_level")
                    for dt in ("float32", "bfloat16")]


def _pg_kernels(dtype: str, codec: str) -> dict:
    """Kernel launches of one process-lane shuffle: an encode and a
    decode a coded stage (the aggregate is not on this path)."""
    import torch
    if codec == "multipass":
        return {"xor_fold": 2, "xor_decode": 2}
    return dict.fromkeys(_gathers(getattr(torch, dtype)), 2)


#: the device whose Δ the process lane's verified runs corrupt (in
#: process 0), and the u32 pattern
PG_CORRUPT_DEV = 1
PG_CORRUPT_BITS = 0x00000001


def _pg_mode_kernels() -> dict:
    """Kernel launches of the process lane's other modes in one child:
    the u32 gathers once each a coded stage in the looped shuffle, the
    clean and the corrupted verified shuffles, and the streamed wave's
    dispatch and its one replay; the degraded waves launch none."""
    return {"xor_encode_gather": 10, "xor_decode_gather": 10}


def process_group_child(rank: int, port: int) -> int:
    """One process of ``phase_process_group``: joins the gloo group, owns
    4 of the 8 workers, and runs every case of :func:`_pg_cases` twice
    through ``camr_shuffle(mesh=)``, each output bitwise this process's
    rows of the single-process shuffle of the same contributions on the
    card (computed first; those launches are not counted). Then the
    lane's other modes on the f32 flat plan, each bitwise the
    single-process rows: the looped exchange (its permutations
    ``expected_collective_calls(mode="looped")``'), the verified wire
    clean and with one corrupted word of device ``PG_CORRUPT_DEV`` in
    stage 1 (``bad`` the single-process rows'), a verified
    ``ShuffleStream(mesh=)`` wave with that fault injected (one fault,
    exactly one replay, in both processes) and two degraded waves
    (worker ``FAILED`` failed, then the last worker). Prints one JSON line: its launch counts, each
    case's ``plan.process_stats`` of the second call, the modes' records
    and whether gloo takes CUDA tensors for ``all_to_all_single``."""
    import numpy as np
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.core.collective import camr_shuffle, make_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import (detect_topology, init_distributed,
                                         make_camr_mesh)
    if not init_distributed(coordinator=f"localhost:{port}",
                            num_processes=2, process_id=rank):
        fail(f"process {rank}: init_distributed() returned False")
    q, k, hosts = TOPO_QKH
    d, K = TOPO_D, q * k
    mesh = make_camr_mesh(K, device=DEVICE)
    topo = detect_topology(k)
    if topo.key() != (hosts, 4.0) or mesh.workers != range(
            rank * K // 2, (rank + 1) * K // 2):
        fail(f"process {rank}: topology {topo.key()}, workers "
             f"{mesh.workers}")
    probe = torch.zeros(2, device=DEVICE)
    try:
        torch.distributed.all_to_all_single(torch.empty_like(probe), probe)
        gloo_cuda = "accepted"
    except RuntimeError as e:
        gloo_cuda = f"refused: {str(e).splitlines()[0][:160]}"
    plans = {"flat": make_plan(q, k, d), "two_level": make_plan(q, k, d,
                                                                topo)}
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    waves = {dt: _device_waves(gen, plans["flat"], getattr(torch, dt), 1)[0]
             for dt in ("float32", "bfloat16")}
    refs = {case: camr_shuffle(plans[case[0]], waves[case[1]],
                               router=case[2], codec=case[3])
            [mesh.lo:mesh.hi].clone() for case in _pg_cases()}
    flat, w32 = plans["flat"], waves["float32"]
    row = int(np.flatnonzero(
        flat.program.stage_tables(1).valid[PG_CORRUPT_DEV])[0])
    spec = (1, PG_CORRUPT_DEV, row, 1, PG_CORRUPT_BITS)
    block = lambda t: t[mesh.lo:mesh.hi].clone()
    mode_refs = dict(
        looped=block(camr_shuffle(flat, w32, mode="looped")),
        verified=[block(t) for t in camr_shuffle(flat, w32,
                                                 verify_wire=True)],
        corrupt=[block(t) for t in camr_shuffle(flat, w32, verify_wire=True,
                                                corrupt=spec)])
    mine = {dt: w[mesh.lo:mesh.hi].contiguous() for dt, w in waves.items()}
    del waves, w32
    torch.cuda.synchronize()
    reset_launch_counts()
    cases = {}
    for case in _pg_cases():
        lay, dt, router, codec = case
        for _ in range(2):
            out = camr_shuffle(plans[lay], mine[dt], router=router,
                               codec=codec, mesh=mesh)
            if not bitwise_equal(out, refs[case]):
                fail(f"process {rank}: {case} != the single-process "
                     "shuffle's rows")
        cases["/".join(case)] = dict(plans[lay].process_stats)
        del out
    modes = _pg_modes(rank, mesh, mine["float32"], mode_refs,
                      refs[("flat", "float32", "all_to_all", "fused")], spec)
    counts = {n: c for n, c in launch_counts().items() if c}
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "counts": counts, "cases": cases,
                      "modes": modes, "gloo_cuda": gloo_cuda}), flush=True)
    return 0


def _pg_modes(rank, mesh, m32, mode_refs, healthy, spec) -> dict:
    """The process lane's other modes in one child (see
    :func:`process_group_child`); fails on any mismatch; returns each
    mode's record: its ``process_stats`` and host ms, the mismatch
    counts, the stream's ``stats()``."""
    import torch
    from repro_torch.core.collective import (ShuffleStream, camr_shuffle,
                                             expected_collective_calls,
                                             make_plan)
    q, k, _ = TOPO_QKH
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    lp = make_plan(q, k, TOPO_D)
    got, ms = timed(lambda: camr_shuffle(lp, m32, mode="looped", mesh=mesh))
    want = expected_collective_calls(lp, mode="looped")
    if not bitwise_equal(got, mode_refs["looped"]):
        fail(f"process {rank}: looped != the single-process looped rows")
    if lp.permutations != {"stage12": want["stage12"],
                           "stage3": want["stage3"]}:
        fail(f"process {rank}: looped permutations {lp.permutations}, "
             f"want {want}")
    out["looped"] = dict(lp.process_stats, host_ms=ms,
                         permutations=want["total"])
    for name, kw in (("verified", {}), ("corrupt", dict(corrupt=spec))):
        (got, bad), ms = timed(lambda: camr_shuffle(
            lp, m32, verify_wire=True, mesh=mesh, **kw))
        ref, ref_bad = mode_refs[name]
        if not (bitwise_equal(got, ref) and torch.equal(bad, ref_bad)):
            fail(f"process {rank}: {name} wire != the single-process rows "
                 f"(bad {bad.tolist()} vs {ref_bad.tolist()})")
        out[name] = dict(lp.process_stats, host_ms=ms, bad=int(bad.sum()))
    st = ShuffleStream(q, k, TOPO_D, mesh=mesh, verify_wire=True)
    st.inject_corruption(stage=spec[0], device=spec[1], row=spec[2],
                         word=spec[3], bits=spec[4])
    (got,), ms = timed(lambda: st.run_waves([m32]))
    if not bitwise_equal(got, healthy.cpu()):
        fail(f"process {rank}: the streamed wave != the healthy rows")
    if (st.wire_faults, st.wire_replays) != (1, 1):
        fail(f"process {rank}: stream faults {st.wire_faults}, replays "
             f"{st.wire_replays}, want 1 and 1")
    out["stream"] = dict(host_ms=ms, **{n: st.stats()[n] for n in (
        "dispatches", "wire_faults", "wire_replays")})
    # worker FAILED, then the last worker, whose rows the degraded plan
    # reads nowhere (the exchange must still find each row's process)
    ms = []
    for failed in (FAILED, q * k - 1):
        st.degrade({failed})
        (got,), t = timed(lambda: st.run_waves([m32]))
        if not bitwise_equal(got, healthy.cpu()):
            fail(f"process {rank}: the wave with worker {failed} failed != "
                 "the healthy rows")
        ms.append(t)
    st.restore()
    out["degraded"] = dict(host_ms=ms, swaps=st.stats()["swaps"])
    return out


def phase_process_group():
    """The process lane of the coded shuffle: two child processes on the
    one card (``python3 chip_smoke.py --process-group-child <rank>
    <port>``, ``PYTHONPATH=src``, a free port), each owning 4 of the 8
    workers at ``TOPO_QKH``'s (q, k) and d = ``TOPO_D``, over a gloo
    group. Every case of :func:`_pg_cases` (flat and the detected
    two-level topology, f32 and bf16, both routers on the fused codec,
    the multipass codec on all_to_all) runs twice in each child, bitwise
    the single-process shuffle's rows; the bytes both children send in
    stages 1 and 2 must equal ``camr_edge_bytes``' inter-host bytes of
    the layout; the lane's other modes (:func:`_pg_modes`) bitwise, with
    no mismatching row on the clean wire and some on the corrupted one;
    each child's launch counts must be exact. A child that fails or
    outlives ``PG_TIMEOUT`` fails the smoke. Logs each case's per-stage
    encode / exchange (host staging and gloo) / decode ms and each
    mode's host ms; returns the children's launch counts, summed."""
    import socket
    from repro_torch.core.collective import camr_edge_bytes, make_plan
    from repro_torch.core.schedule import Topology
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--process-group-child",
         str(rank), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=PG_TIMEOUT))
            except subprocess.TimeoutExpired:
                fail(f"process_group: a child ran past {PG_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"process_group: child {rank} exit {p.returncode}:\n"
                 f"{out[-2000:]}\n{err[-3000:]}")
    reports = [json.loads(out.splitlines()[-1]) for out, _ in outs]
    wall = time.perf_counter() - t0
    q, k, hosts = TOPO_QKH
    two = make_plan(q, k, TOPO_D, Topology.two_level(hosts))
    want = dict(_pg_mode_kernels())
    for lay, dt, router, codec in _pg_cases():
        for n, c in _pg_kernels(dt, codec).items():
            want[n] = want.get(n, 0) + 2 * c
    total = {}
    for r in reports:
        if r["counts"] != want:
            fail(f"process_group: child {r['rank']} launched {r['counts']}, "
                 f"want {want}")
        for n, c in r["counts"].items():
            total[n] = total.get(n, 0) + c
    for tag in reports[0]["cases"]:
        lay, dt = tag.split("/")[:2]
        eb = camr_edge_bytes(two, dtype=dt)[f"{lay}_inter_bytes"]
        sent = sum(r["cases"][tag][s]["bytes"] for r in reports
                   for s in ("stage1", "stage2"))
        s3 = sum(r["cases"][tag]["stage3"]["bytes"] for r in reports)
        if sent != eb or s3:
            fail(f"process_group: {tag} sent {sent} bytes across processes "
                 f"in stages 1-2 ({s3} in stage 3), camr_edge_bytes {eb}")
        for r in reports:
            st = r["cases"][tag]
            log(f"process_group[{tag}] rank {r['rank']}: " + "; ".join(
                f"stage {i} encode {st[f'stage{i}']['encode_ms']:.3f}, "
                f"exchange {st[f'stage{i}']['exchange_ms']:.3f} (staging "
                f"{st[f'stage{i}']['staging_ms']:.3f}, gloo "
                f"{st[f'stage{i}']['gloo_ms']:.3f}), decode "
                f"{st[f'stage{i}']['decode_ms']:.3f}, "
                f"{st[f'stage{i}']['bytes']} bytes" for i in (1, 2))
                + f"; stage 3 + assembly {st['stage3']['ms']:.3f} ms")
    modes = [r["modes"] for r in reports]
    bad = {name: sum(m[name]["bad"] for m in modes)
           for name in ("verified", "corrupt")}
    if bad["verified"] or not bad["corrupt"]:
        fail(f"process_group: mismatching rows {bad} (clean, one corrupted "
             "word)")
    for r, m in zip(reports, modes):
        lp = m["looped"]
        log(f"process_group[modes] rank {r['rank']}: looped "
            f"{lp['host_ms']:.1f} ms ({lp['permutations']} permutations, "
            f"{lp['stage1']['exchanges'] + lp['stage2']['exchanges']} "
            "stage-1/2 gloo exchanges, "
            f"{lp['stage1']['bytes'] + lp['stage2']['bytes']} bytes, gloo "
            f"{lp['stage1']['gloo_ms'] + lp['stage2']['gloo_ms']:.1f} ms); "
            f"verified {m['verified']['host_ms']:.1f} ms clean, "
            f"{m['corrupt']['host_ms']:.1f} ms with the corrupted word "
            f"({m['corrupt']['bad']} rows flagged here); streamed wave "
            f"{m['stream']['host_ms']:.1f} ms ({m['stream']['dispatches']} "
            f"dispatches, faults {m['stream']['wire_faults']}, replays "
            f"{m['stream']['wire_replays']}); degraded waves (worker "
            f"{FAILED}, worker {q * k - 1} failed) " + ", ".join(
                f"{t:.1f}" for t in m['degraded']['host_ms']) + " ms")
    log(f"process_group: 2 processes x 4 workers at (q, k) = ({q}, {k}), "
        f"d {TOPO_D}, gloo; {len(reports[0]['cases'])} cases x 2 calls each "
        "bitwise the single-process shuffle's rows; stage 1-2 bytes across "
        "processes == camr_edge_bytes (flat "
        f"{camr_edge_bytes(two)['flat_inter_bytes']}, two-level "
        f"{camr_edge_bytes(two)['two_level_inter_bytes']} f32); looped, "
        f"verified (mismatching rows {bad}), streamed with one replay and "
        f"degraded f32 waves (worker {FAILED}, then worker {q * k - 1} "
        "failed) bitwise the single-process rows; launches a "
        f"child {want} (exact); gloo and CUDA tensors: "
        f"{reports[0]['gloo_cuda']}; {wall:.1f} s wall")
    return total


#: phase_compare's points (name, q, k, d, hosts): the training cell's
#: shard width (set at run time from the cell), the CLI's (q, k) at the
#: width of its default 4096 cut to a multiple of k-1 = 3 (both packages'
#: make_plan refuse 4096 there), and phase_topology's two-level cell
COMPARE_POINTS = (("cell", 2, 3, None, None), ("cli", 4, 4, 4095, None),
                  ("two_level", 2, 4, TOPO_D, 2))
#: measure_stream's run: (2, 3) at 0.6 GB of contributions a wave
STREAM_ARGS = dict(q=2, k=3, d=1_048_576, waves=8, wave_batch=2, depth=2,
                   kill_at=3, rejoin_at=6)


def _stream_shuffles(waves, wave_batch, kill_at, rejoin_at) -> int:
    """Coded shuffles (each two launches of each gather) of
    ``measure_stream``: one build and ``waves`` serial ones, the stream's
    warm-up and timed dispatches, and the churn pass's healthy ones (a
    batch dispatched while the worker is failed goes to the degraded
    executor, which launches no kernel)."""
    stream = -(-waves // wave_batch)
    warm = 1 + (1 if waves % wave_batch else 0)
    healthy, pending = 0, 0
    failed = False
    for i in range(waves):
        if i == kill_at:
            failed = True
        if rejoin_at is not None and i == rejoin_at:
            failed = False
        pending += 1
        if pending == wave_batch:
            healthy += not failed
            pending = 0
    healthy += bool(pending) and not failed
    return 1 + waves + warm + stream + healthy


def _cpu_width(d: int, k: int, lane_bytes: int, cap: int = 1 << 28) -> int:
    """The smallest ``m`` dividing ``d`` with ``k-1 | d/m`` whose
    contributions (``lane_bytes`` a unit of width) fit in ``cap`` bytes
    on the host: every collective the ledger notes is ``d`` or
    ``d/(k-1)`` whole words wide there, so the CPU's ledger at ``d/m``
    times ``m`` is the ledger at ``d``
    (``tests/test_torch_compare.py::test_ledger_linear_in_width``)."""
    for m in range(1, d + 1):
        if d % m == 0 and (d // m) % (k - 1) == 0 \
                and lane_bytes * (d // m) <= cap:
            return m
    fail(f"no width of the host's ledger divides d = {d}")


def phase_compare(d_cell: int):
    """The paper's comparison (``repro_torch.launch.camr_compare``) on the
    card. At each of ``COMPARE_POINTS`` (the cell's at ``d_cell``):
    ``lower_schedules`` runs the coded shuffle, the uncoded masked psum
    and the dense all-reduce once each on zero contributions, and its
    ledger must give ``expected_collective_calls``' counts and the CPU
    executors' ledger at the same point (the numbers the CPU tests hold
    equal to the JAX package's HLO parse; where the point's contributions
    would not fit the host, at the divisor of ``_cpu_width``, scaled),
    edge bytes too on the two-level point; then each scheme's ms by CUDA
    events. One
    card times the executors' device work, not a network: the uncoded
    baseline may well be faster; the paper's gain is in the bytes. Then
    ``measure_stream`` at ``STREAM_ARGS`` (its own checks: outputs close
    to the reference, bitwise the serial ones, the churn pass bitwise
    with ``compiles`` flat). Launch counts exact; returns them."""
    import torch
    from repro_torch.core.collective import (expected_collective_calls,
                                             make_plan)
    from repro_torch.core.schedule import Topology
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import camr_compare
    total = {}
    t_phase = time.perf_counter()
    for name, q, k, d, hosts in COMPARE_POINTS:
        d = d_cell if d is None else d
        topo = None if hosts is None else Topology.two_level(hosts)
        plan = make_plan(q, k, d, topo)
        K, J, J_own = plan.K, plan.J, plan.J_own
        contrib = K * J_own * (k - 1) * K * d * 4
        dense = J * K * d * 4
        # the uncoded scheme's peak: the contributions, their masked copy,
        # the stored-batch sums [K, J_own, K, d], the [J, K, d] sum and
        # the outputs
        reckoned = 2 * contrib + K * J_own * K * d * 4 + 2 * dense
        log(f"compare[{name}] (q, k, d) = ({q}, {k}, {d})"
            f"{'' if topo is None else f', two-level hosts {hosts}'}: "
            f"contributions {contrib / 1e9:.2f} GB, a [J, K, d] sum "
            f"{dense / 1e9:.2f} GB; reckoned peak {reckoned / 1e9:.2f} GB")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = camr_compare.lower_schedules(q, k, d, topology=topo)
        exp = expected_collective_calls(plan)
        ops = {"all-to-all": 2 * (k - 1),
               "collective-permute": exp["total"] - 2 * (k - 1)}
        if (res["camr_ops"] != ops
                or res["uncoded_ops"] != {"all-reduce": 1}
                or res["allreduce_ops"] != {"all-reduce": 1}):
            fail(f"compare[{name}]: ops {res['camr_ops']}, "
                 f"{res['uncoded_ops']}, {res['allreduce_ops']}; want {ops}")
        div = _cpu_width(d, k, contrib // d)
        cpu = camr_compare.lower_schedules(q, k, d // div, topology=topo,
                                           device="cpu")
        got = {s: res[f"{s}_wire"] for s in ("camr", "uncoded", "allreduce")}
        want = {s: div * cpu[f"{s}_wire"] for s in got}
        if got != want or any(res[f"{s}_ops"] != cpu[f"{s}_ops"]
                              for s in got):
            fail(f"compare[{name}]: wire bytes {got} != the CPU ledger's at "
                 f"d / {div}, times {div}: {want}")
        if topo is not None and res["edge_bytes"] != {
                n: v if n == "hosts" else div * v
                for n, v in cpu["edge_bytes"].items()}:
            fail(f"compare[{name}]: edge bytes {res['edge_bytes']}")
        c = torch.zeros((K, J_own, k - 1, K, d), device=DEVICE)
        ms = {m: time_ms(lambda: fn(c), warmup=1, reps=3)
              for m, fn in camr_compare.schemes(plan).items()}
        del c
        counts = {n: v for n, v in launch_counts().items() if v}
        # each shuffle launches each gather once a coded stage
        want = dict.fromkeys(_gathers(torch.float32), 2 * (1 + 1 + 3))
        if counts != want:
            fail(f"compare[{name}]: launched {counts}, want {want}")
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v
        peak = torch.cuda.max_memory_allocated()
        base = got["allreduce"]
        log(f"compare[{name}]: " + "; ".join(
            f"{m} {got[m]:,} wire bytes ({got[m] / base:.3f}x of "
            f"allreduce), {res[f'{m}_ops']}, {ms[m]:.3f} ms (CUDA events)"
            for m in got) + f"; analytic camr_total "
            f"{res['analytic']['camr_total']:,}; the CPU ledger at d / "
            f"{div}, times {div}, equal; peak {peak / 1e9:.2f} GB "
            f"(reckoned {reckoned / 1e9:.2f})")
        if topo is not None:
            log(f"compare[{name}]: edge bytes {res['edge_bytes']}")
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    a = STREAM_ARGS
    r = camr_compare.measure_stream(a["q"], a["k"], a["d"], a["waves"],
                                    wave_batch=a["wave_batch"],
                                    depth=a["depth"], kill_at=a["kill_at"],
                                    rejoin_at=a["rejoin_at"])
    counts = {n: v for n, v in launch_counts().items() if v}
    want = dict.fromkeys(_gathers(torch.float32), 2 * _stream_shuffles(
        a["waves"], a["wave_batch"], a["kill_at"], a["rejoin_at"]))
    if counts != want:
        fail(f"compare[stream]: launched {counts}, want {want}")
    if r["churn"]["swaps"] != 2:
        fail(f"compare[stream]: churn {r['churn']}")
    for n, v in counts.items():
        total[n] = total.get(n, 0) + v
    log(f"compare[stream] {STREAM_ARGS}: serial {r['serial_s'] * 1e3:.1f} "
        f"ms, streamed {r['stream_s'] * 1e3:.1f} ms ({r['speedup']:.2f}x, "
        f"{r['stream_wps']:.1f} waves/s); outputs close to the reference and "
        f"bitwise the serial ones; churn {r['churn']} bitwise; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return total


#: the examples of examples/torch that run on the card: (file, arguments)
EXAMPLES = (("multimodel_camr.py", ("--steps", "3")),
            ("serve_lm.py", ()),
            ("train_lm.py", ("--steps", "40")))


def phase_examples():
    """The user entry points that touch the card, each a subprocess
    (``PYTHONPATH=src``, on the current CUDA device) that must exit 0 and
    print ``OK``; ``train_lm.py`` must reduce its loss (its own assert;
    the ``loss a -> b`` line is read too) and checkpoints into a fresh
    temporary directory."""
    import re
    import shutil
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    try:
        for name, args in EXAMPLES:
            extra = ("--ckpt-dir", ckpt) if name == "train_lm.py" else ()
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.join(ROOT, "examples", "torch",
                                              name), *args, *extra],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=600)
            lines = res.stdout.splitlines()
            if res.returncode != 0 or not any(ln.startswith("OK")
                                              for ln in lines):
                fail(f"examples: {name} exit {res.returncode}:\n"
                     f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
            note = ""
            if name == "train_lm.py":
                m = [re.match(r"loss (\S+) -> (\S+) over", ln)
                     for ln in lines]
                m = [x for x in m if x]
                if not m or not float(m[0][2]) < float(m[0][1]):
                    fail(f"examples: train_lm.py's loss did not fall: "
                         f"{lines[-3:]}")
                note = f"; {m[0][0]}"
            log(f"examples[{name} {' '.join(args)}]: exit 0, OK, "
                f"{time.perf_counter() - t0:.1f} s wall{note}; last lines "
                f"{lines[-2:]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# --------------------------------------------------------------------- #
# phase 4: serving (DecodeEngine behind ServeStream)
# --------------------------------------------------------------------- #
#: (arch, depth, prompt lengths): granite_3_2b at full width and full
#: depth, gemma2_2b at full width cut to 4 layers (2 pattern units),
#: mamba2_1p3b and zamba2_2p7b at full width and full depth (six of the
#: lengths leave a ragged last SSD chunk of 64), moonshot_v1_16b_a3b at
#: full width and full depth (48 layers, 56.1 GB of bf16 weights),
#: mixtral_8x7b at full width cut to 16 of 32 layers (47.0 GB; all 32
#: would be 93.4) and internlm2_20b cut to 4 layers
_LENS = (1000, 129, 257, 640, 1024, 77, 513, 900)
SERVE_RUNS = (("granite_3_2b", None, _LENS),
              ("gemma2_2b", 4, (1000, 300, 513, 64)),
              ("mamba2_1p3b", None, _LENS),
              ("zamba2_2p7b", None, _LENS),
              ("moonshot_v1_16b_a3b", None, _LENS),
              ("mixtral_8x7b", 16, _LENS),
              ("internlm2_20b", 4, (1000, 300, 513, 64)))
#: the prefill logits through the kernel and through its plain version
#: (bf16 activations round differently once the attention outputs differ
#: in their last bits): max abs difference <= this share of max |logit|
LOGIT_SHARE = 0.05
#: layers of an SSM or hybrid model whose prefill logits are held to the
#: plain versions' under ``LOGIT_SHARE``, rounded down to whole pattern
#: units (at least one: 4 for mamba2, 6 for zamba2; see ``gate_depth``).
#: The random bf16 models amplify rounding with depth: two plain
#: evaluations (SSD chunks of 64 and of 32) drift apart as far as the
#: kernels and the plain versions do, which ``check_prefill_kernels``
#: prints at this depth and at full depth; at full depth each kernel
#: call is held to its plain version instead
SSM_LOGIT_LAYERS = 4
#: the same gate for an f32 model: no bf16 rounding between the layers,
#: so the kernels and the plain versions differ only by their f32 sums
#: (each scan within ``SSD_F32_REL`` x max|y| of an exact one)
F32_LOGIT_SHARE = 1e-3
#: the f32 serving run (``phase_serve``'s arguments): mamba2_1p3b at full
#: width in f32 (the dtype its training lane trains it in), cut to 4
#: layers, two requests of 1024 and 77 tokens with 8 new tokens each, so
#: that the f32 ``ssd_scan`` body runs on a model path (8 launches)
SERVE_F32_RUN = dict(arch="mamba2_1p3b", n_layers=4, lens=(1024, 77),
                     max_new=8, dtype="float32")


def gate_depth(cfg) -> int:
    """Depth of the prefill logits gate: all layers of an attention-only
    model; ``SSM_LOGIT_LAYERS`` rounded down to whole pattern units (at
    least one) of a model with SSM sublayers."""
    if "ssm" not in cfg.pattern:
        return cfg.n_layers
    unit = len(cfg.pattern)
    return min(cfg.n_layers, unit * max(1, SSM_LOGIT_LAYERS // unit))


@contextlib.contextmanager
def plain_attention(attn=None):
    """Route prefill attention through ``attn``, by default the plain
    version (no launch)."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention
    ops.flash_attention = attn or ref.flash_attention_ref
    try:
        yield
    finally:
        ops.flash_attention = saved


@contextlib.contextmanager
def plain_ssd(scan=None):
    """Route the SSM prefill's scan through ``scan``, by default the plain
    version in the kernel's chunks of 64 (no launch)."""
    from repro_torch.kernels import ops, ref
    saved = ops.ssd_scan
    ops.ssd_scan = scan or ref.ssd_chunked
    try:
        yield
    finally:
        ops.ssd_scan = saved


def check_prefill_kernels(cfg, params, probe, tag):
    """A full-depth prefill's kernel calls at the model's own activations:
    every ``ssd_scan`` and ``flash_attention`` launch recorded and held
    against its plain version on the same inputs (the bf16 limits of
    ``check_ssd`` and ``check_flash``; an f32 scan within twice
    ``SSD_F32_REL`` x max|y|, each f32 evaluation being within one of an
    exact one); then the logits' drift between two
    plain evaluations (SSD chunks of 64 and of 32) at ``gate_depth`` and
    at full depth, beside the kernels'."""
    import functools
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    kernels = {"ssd_scan": ops.ssd_scan,
               "flash_attention": ops.flash_attention}
    calls = {name: [] for name in kernels}

    def recorder(name):
        def record(*args, **kw):
            y = kernels[name](*args, **kw)
            calls[name].append((args, kw, y))
            return y
        return record

    with plain_ssd(recorder("ssd_scan")), \
            plain_attention(recorder("flash_attention")):
        lg_kernel, _ = lm.prefill(cfg, params, probe)
    worst = dict.fromkeys(kernels, 0.0)
    for args, kw, y in calls["ssd_scan"]:
        want = ref.ssd_chunked(*args).float()
        rtol = SSD_SERVE_RTOL if y.dtype == torch.bfloat16 else 0.0
        limit = (2 * SSD_F32_REL * float(want.abs().max())
                 + rtol * want.abs())
        worst["ssd_scan"] = max(worst["ssd_scan"], float(
            ((y.float() - want).abs() / limit).max()))
    for args, kw, y in calls["flash_attention"]:
        want = ref.flash_attention_ref(*args, **kw).float()
        limit = FLASH_SERVE_TOL["atol"] + FLASH_SERVE_TOL["rtol"] * want.abs()
        worst["flash_attention"] = max(worst["flash_attention"], float(
            ((y.float() - want).abs() / limit).max()))
    want_n = {"ssd_scan": cfg.repeats * cfg.pattern.count("ssm"),
              "flash_attention": cfg.repeats * sum(
                  k != "ssm" for k in cfg.pattern)}
    got_n = {name: len(c) for name, c in calls.items()}
    if got_n != want_n or max(worst.values()) > 1:
        fail(f"{tag}: prefill kernel calls recorded {got_n} (want {want_n}), "
             f"the worst element at {worst} of its limit")
    del calls
    T = probe["tokens"].shape[1]
    log(f"{tag}: the {want_n['ssd_scan']} scans and "
        f"{want_n['flash_attention']} attention calls of a {T}-token "
        f"prefill within the {cfg.dtype} limits of their plain versions on "
        f"the "
        f"model's activations (worst element at "
        + ", ".join(f"{worst[n]:.3f} ({n})" for n in kernels if want_n[n])
        + " of its limit)")
    chunk32 = functools.partial(ref.ssd_chunked, chunk=32)
    for depth in (gate_depth(cfg), cfg.n_layers):
        c = cfg.replace(n_layers=depth)
        with plain_attention(), plain_ssd():
            lp, _ = lm.prefill(c, params, probe)
        with plain_attention(), plain_ssd(chunk32):
            lp32, _ = lm.prefill(c, params, probe)
        drift = float((lg_kernel - lp).abs().max())
        kernel_txt = (f"kernels vs plain {drift:.4g}, "
                      if depth == cfg.n_layers else "")
        log(f"{tag}: prefill logits at {depth} layers: max |logit| "
            f"{float(lp.abs().max()):.4g}; {kernel_txt}plain (chunks of 64) "
            f"vs plain (chunks of 32) {float((lp - lp32).abs().max()):.4g}")


@contextlib.contextmanager
def count_moe_drops():
    """Wrap ``layers._moe_dispatch_compute`` (every MoE block's dispatch)
    and tally, apart for prefill and decode calls, the calls, the
    assignments routed and those dropped past an expert's capacity, in
    all and per layer (the routing recomputed by ``layers._moe_route`` on
    the call's own inputs; the dropped counts stay on the card until the
    end)."""
    from repro_torch.models import layers
    inner = layers._moe_dispatch_compute
    tally = {kind: {"calls": 0, "assignments": 0, "dropped": 0,
                    "layers": {}} for kind in ("prefill", "decode")}

    def wrapped(p, xf, cfg, *args, n_tokens=None, **kw):
        n = xf.shape[-2] if n_tokens is None else n_tokens
        keep = layers._moe_route(p, xf, cfg, n)[-1]
        t = tally["prefill" if n_tokens is None else "decode"]
        per = t["layers"].setdefault(t["calls"] % cfg.n_layers, [0, []])
        per[0] += keep.numel()
        per[1].append((~keep).sum())
        t["calls"] += 1
        return inner(p, xf, cfg, *args, n_tokens=n_tokens, **kw)

    layers._moe_dispatch_compute = wrapped
    try:
        yield tally
    finally:
        layers._moe_dispatch_compute = inner
        for t in tally.values():
            for per in t["layers"].values():
                per[1] = sum(int(d) for d in per[1])
            t["assignments"] = sum(a for a, _ in t["layers"].values())
            t["dropped"] = sum(d for _, d in t["layers"].values())


def serve_kernels(cfg, n_requests: int) -> dict:
    """Prefill launches of a serving run: one ``flash_attention`` per
    attention sublayer (a ``shared_attn`` block at each of its
    occurrences) and one ``ssd_scan`` per SSM sublayer, per request, all
    of them on the f32 bodies for an f32 model; no other kernel."""
    per = {"flash_attention": ("attn", "local", "shared_attn"),
           "ssd_scan": ("ssm",)}
    n = {name: cfg.repeats * n_requests * sum(k in kinds
                                              for k in cfg.pattern)
         for name, kinds in per.items()}
    f32 = cfg.dtype == "float32"
    return dict(n, **{f"{name}_f32": c if f32 else 0
                      for name, c in n.items()})


def kernel_launches() -> dict:
    """``launch_counts()`` and, as ``flash_attention_f32`` and
    ``ssd_scan_f32``, the launches of ``flash_attention``'s and
    ``ssd_scan``'s f32 bodies (shares of their kernels' counts)."""
    from repro_torch.kernels import flash_attention, launch_counts, ssd_scan
    return dict(launch_counts(),
                flash_attention_f32=flash_attention.launches_by_dtype[
                    "float32"],
                ssd_scan_f32=ssd_scan.launches_by_dtype["float32"])


def phase_serve(arch, n_layers, lens, seed=0, max_new=32, dtype=None):
    """One model served through the port's entry points: its launch
    counts, statuses, tokens bitwise ``generate``'s, zero builds on a
    second warm run, the pool's invariants, the prefill logits against
    the plain versions (within ``LOGIT_SHARE`` of max |logit| in bf16,
    ``F32_LOGIT_SHARE`` in f32); returns the run's launch counts.
    ``dtype`` replaces the config's (``None``: its own, bf16)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.runtime.serve import (DecodeEngine, Request,
                                           ServeStream, generate,
                                           trace_total)
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    tag = f"serve[{arch}{', ' + dtype if dtype else ''}]"
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (T,)).astype(np.int32),
                    max_new=max_new, seed=i) for i, T in enumerate(lens)]
    eng = DecodeEngine(cfg, params, slots=4, page_size=16, max_ctx=1056,
                       max_new_cap=max_new, name=arch, device=DEVICE)
    stream = ServeStream(eng, wave_len=8)
    torch.cuda.synchronize()
    mixers = []
    if "ssm" in cfg.pattern:
        mixers.append(f"{cfg.pattern.count('ssm') * cfg.repeats} SSM layers "
                      f"of {cfg.ssm_heads} heads x "
                      f"{cfg.ssm_d_inner // cfg.ssm_heads}, state "
                      f"{cfg.ssm_state}")
    n_attn = sum(k != "ssm" for k in cfg.pattern) * cfg.repeats
    if n_attn:
        shared = (" (one shared block)" if "shared_attn" in cfg.pattern
                  else "")
        mixers.append(f"{n_attn} attention layers{shared} of "
                      f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}")
    if cfg.n_experts:
        mixers.append(f"{cfg.n_experts} experts (top-{cfg.experts_per_token}"
                      f") of d_ff {cfg.d_ff}")
    mixer = " + ".join(mixers)
    log(f"{tag}: {cfg.n_layers} layers, d_model {cfg.d_model}, {mixer}, "
        f"{cfg.dtype}; {len(reqs)} greedy requests, prompts {list(lens)}, "
        f"max_new {max_new}; engine slots 4, page 16, max_ctx 1056, wave 8; "
        f"init {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = stream.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    rep = stream.last_report
    want = dict.fromkeys(counts, 0)
    want.update(serve_kernels(cfg, len(reqs)))
    if counts != want:
        fail(f"{tag}: launch counts {counts} != expected {want}")
    if [r.status for r in results] != ["ok"] * len(reqs):
        fail(f"{tag}: statuses {[r.status for r in results]}")
    eng.pool.check_invariants()
    builds = trace_total()
    # the warm run's MoE dispatches are tallied (the first run is timed)
    with (count_moe_drops() if cfg.n_experts
          else contextlib.nullcontext()) as drops:
        again = stream.run(reqs)
    if trace_total() != builds or stream.last_report.traces:
        fail(f"{tag}: the warm run built or loaded "
             f"{trace_total() - builds} kernel libraries")
    eng.pool.check_invariants()
    if drops is not None:
        share = {i: d / a for i, (a, d) in
                 drops["prefill"]["layers"].items()}
        log(f"{tag}: MoE dispatch of the warm run ({cfg.n_experts} experts, "
            f"top-{cfg.experts_per_token}, capacity factor "
            f"{cfg.moe_capacity_factor}): " + "; ".join(
                f"{kind} {t['calls']} calls, {t['dropped']} of "
                f"{t['assignments']} assignments dropped"
                for kind, t in drops.items())
            + f"; prefill drop share by layer: layer 0 {share[0]:.4f}, "
            f"min {min(share.values()):.4f}, max {max(share.values()):.4f}")
        if drops["decode"]["dropped"] or not drops["decode"]["calls"]:
            fail(f"{tag}: decode dropped {drops['decode']['dropped']} "
                 f"assignments in {drops['decode']['calls']} calls (slots=4 "
                 "can overflow no expert)")
    for req, r, r2 in zip(reqs, results, again):
        want_toks = generate(cfg, params, req.prompt[None], max_new=max_new,
                             device=DEVICE).tokens[0, len(req.prompt):]
        if not (np.array_equal(r.generated, want_toks)
                and np.array_equal(r2.generated, want_toks)):
            fail(f"{tag}: prompt {len(req.prompt)}: engine tokens "
                 f"{r.generated} != generate {want_toks}")
    log(f"{tag}: {len(reqs)} requests ok, tokens bitwise == generate on the "
        f"card (and on a second warm run); launches {counts}; warm run: 0 "
        f"kernel builds/loads; pool invariants hold")

    # the prefill logits through the kernels and through the plain versions
    # (a model with SSM sublayers at gate_depth, its kernel calls one by
    # one at full depth)
    probe = {"tokens": torch.from_numpy(reqs[0].prompt[None]).to(DEVICE)}
    ssm = "ssm" in cfg.pattern
    gate = cfg.replace(n_layers=gate_depth(cfg))
    lg_kernel, _ = lm.prefill(gate, params, probe)
    with plain_attention(), plain_ssd():
        lg_plain, _ = lm.prefill(gate, params, probe)
    diff = float((lg_kernel - lg_plain).abs().max())
    scale = float(lg_plain.abs().max())
    share = F32_LOGIT_SHARE if cfg.dtype == "float32" else LOGIT_SHARE
    if not torch.isfinite(lg_kernel).all() or diff > share * scale:
        fail(f"{tag}: prefill logits kernel vs plain differ by {diff} "
             f"(limit {share} x max |logit| {scale})")
    if ssm:
        check_prefill_kernels(cfg, params, probe, tag)
    log(f"{tag}: prefill logits ({len(reqs[0].prompt)} tokens, "
        f"{gate.n_layers} layers) through the kernels vs the plain "
        f"versions: max abs diff {diff:.4g} <= "
        f"{share} x max |logit| {scale:.4g} (tokens are not compared "
        "across the two: bf16 rounding can flip a greedy argmax); argmax "
        f"equal: {bool(lg_kernel.argmax() == lg_plain.argmax())}")

    lines = []
    for req in sorted(reqs, key=lambda r: len(r.prompt)):
        ms = time_ms(lambda: eng.prefill(req), warmup=1, reps=3)
        lines.append(f"{len(req.prompt)}:{ms:.2f}")
    log(f"{tag}: prefill ms by prompt length {', '.join(lines)}")
    toks = sum(r.emitted for r in results)
    wave_s = sum(s[1] for s in rep.wave_stats)
    per_step = [s[1] / max(1, s[2]) for s in rep.wave_stats]
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{tag}: {toks} tokens in {wall:.2f} s wall ({toks / wall:.1f} tok/s "
        f"end to end), decode {toks / wave_s:.1f} tok/s over {rep.waves} "
        f"waves ({wave_s:.2f} s), occupancy {rep.occupancy:.3f}, step "
        f"p50 {1e3 * float(np.percentile(per_step, 50)):.2f} ms p99 "
        f"{1e3 * float(np.percentile(per_step, 99)):.2f} ms; peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) of {total / 1e9:.1f} GB")
    del eng, stream, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


#: the legacy host loop's runs (``serve_legacy``, ``generate`` the
#: oracle), both at full width and full depth, as (arch, [(frames Ts or
#: patch positions, prompt T, dtype of the frames or patches)]):
#: seamless_m4t_large_v2 (24 encoder and 24 decoder layers, 3.9 GB of bf16
#: weights) on f32 frames, as the JAX launcher makes them (its encoder and
#: cross-attention in f32 through the CUDA-core body, bf16 queries over f32
#: k/v), one request with a cross prefill of Tq > Tk, then one on bf16
#: frames (the tensor-core body on the encoder); internvl2_26b (48 layers,
#: 39.7 GB) on f32 patches [1, 256, 1024], prompts of at least the 256
#: positions the patches replace
LEGACY_RUNS = (("seamless_m4t_large_v2",
                ((1000, 4, "float32"), (1024, 64, "float32"),
                 (500, 16, "float32"), (257, 513, "float32"),
                 (1000, 4, "bfloat16"))),
               ("internvl2_26b",
                ((256, 1024, "float32"), (256, 257, "float32"),
                 (256, 513, "float32"), (256, 300, "float32"))))


def legacy_launches(cfg, max_new: int) -> int:
    """``flash_attention`` launches of one ``serve_legacy`` request: its
    prefill's (an enc-dec model: each encoder layer, decoder self-
    attention and cross-attention) and, for an enc-dec model, one per
    cross-attention in each of its ``max_new - 1`` decode steps (the
    self-attention of a decode step is the plain masked one)."""
    if cfg.family != "encdec":
        return cfg.n_layers
    return cfg.n_enc_layers + 2 * cfg.n_layers + (max_new - 1) * cfg.n_layers


def legacy_f32_launches(cfg, max_new: int, dtype: str) -> int:
    """Of :func:`legacy_launches`, those of the f32 body: on an f32 model
    all; on a bf16 one, with f32 frames, an enc-dec model's encoder
    layers and its cross-attention in the prefill and each decode step
    (bf16 queries widened over the f32 k/v); else none (a ViT prefix is
    cast to the model's dtype)."""
    if cfg.dtype == "float32":
        return legacy_launches(cfg, max_new)
    if cfg.family != "encdec" or dtype != "float32":
        return 0
    return cfg.n_enc_layers + max_new * cfg.n_layers


def phase_legacy(arch, runs, seed=0, max_new=32):
    """One enc-dec or ViT model served through ``serve_legacy`` (the
    legacy host loop: ``DecodeEngine`` refuses these models, as JAX's
    does), each request with its own frames or patches as ``extras``:
    statuses, exact launch counts, tokens bitwise ``generate``'s on the
    card, each request's prefill logits through the kernels against the
    plain versions at full depth; returns the run's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.runtime.serve import Request, generate, serve_legacy
    from repro_torch.weights import leaves
    cfg = get_config(arch)
    tag = f"legacy[{arch}]"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    rng = np.random.default_rng(seed)
    key = "frames" if cfg.family == "encdec" else "patches"
    reqs, extras = [], []
    for i, (n, T, dtype) in enumerate(runs):
        reqs.append(Request(prompt=rng.integers(0, cfg.vocab, (T,)).astype(
            np.int32), max_new=max_new, seed=i))
        x = rng.standard_normal((1, n, cfg.frontend_dim)).astype(np.float32)
        extras.append({key: torch.from_numpy(x).to(DEVICE,
                                                  getattr(torch, dtype))})
    n_w = sum(t.numel() * t.element_size() for _, t in leaves(params))
    enc = (f"{cfg.n_enc_layers} encoder + " if cfg.n_enc_layers else "")
    log(f"{tag}: {enc}{cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.hd}, {cfg.dtype}, "
        f"{n_w / 1e9:.2f} GB of weights; {len(reqs)} greedy requests "
        f"({key}, prompt, dtype) {[tuple(r) for r in runs]}, max_new "
        f"{max_new}; init {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    counts = dict.fromkeys(kernel_launches(), 0)
    results, wall = [], 0.0
    for req, ex, run in zip(reqs, extras, runs):   # each request's exact
        want = dict(dict.fromkeys(counts, 0),
                    flash_attention=legacy_launches(cfg, max_new),
                    flash_attention_f32=legacy_f32_launches(cfg, max_new,
                                                            run[2]))
        reset_launch_counts()
        t0 = time.perf_counter()
        results += serve_legacy(cfg, params, [req], extras=ex, model=arch,
                                device=DEVICE)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        got = kernel_launches()
        if got != want:
            fail(f"{tag}: prompt {len(req.prompt)}: launch counts {got} != "
                 f"expected {want}")
        counts = {name: counts[name] + n for name, n in got.items()}
    peak = torch.cuda.max_memory_allocated()
    if [r.status for r in results] != ["ok"] * len(reqs):
        fail(f"{tag}: statuses {[r.status for r in results]}")
    steps = []
    for req, ex, r in zip(reqs, extras, results):
        g = generate(cfg, params, req.prompt[None], max_new=max_new,
                     extras=ex, device=DEVICE)
        steps.extend(g.step_times)
        if not np.array_equal(r.generated, g.tokens[0, len(req.prompt):]):
            fail(f"{tag}: prompt {len(req.prompt)}: serve_legacy tokens "
                 f"{r.generated} != generate {g.tokens[0, len(req.prompt):]}")
    log(f"{tag}: {len(reqs)} requests ok, serve_legacy tokens bitwise == "
        f"generate on the card; launches {counts} (each request's exact: "
        f"{legacy_launches(cfg, max_new)} a request of {max_new} tokens, of "
        f"which the f32 body's by frames dtype "
        f"{ {r[2]: legacy_f32_launches(cfg, max_new, r[2]) for r in runs} })")

    worst = []
    for req, ex in zip(reqs, extras):
        batch = {"tokens": torch.from_numpy(req.prompt[None]).to(DEVICE),
                 **ex}
        lg_kernel, _ = lm.prefill(cfg, params, batch)
        with plain_attention():
            lg_plain, _ = lm.prefill(cfg, params, batch)
        diff = float((lg_kernel - lg_plain).abs().max())
        scale = float(lg_plain.abs().max())
        if not torch.isfinite(lg_kernel).all() or diff > LOGIT_SHARE * scale:
            fail(f"{tag}: prompt {len(req.prompt)}: prefill logits kernel vs "
                 f"plain differ by {diff} (limit {LOGIT_SHARE} x max |logit| "
                 f"{scale})")
        worst.append(f"{len(req.prompt)}/{ex[key].shape[1]} "
                     f"{str(ex[key].dtype)[6:]}: {diff:.4g} of {scale:.4g}")
    log(f"{tag}: prefill logits ({cfg.n_layers} layers) through the kernels "
        f"vs the plain versions, max abs diff of max |logit| (prompt/{key} "
        f"dtype): {'; '.join(worst)} (limit {LOGIT_SHARE})")

    lines = []
    for req, ex in zip(reqs, extras):
        batch = {"tokens": torch.from_numpy(req.prompt[None]).to(DEVICE),
                 **ex}
        ms = time_ms(lambda: lm.prefill(cfg, params, batch,
                                        max_len=len(req.prompt) + max_new),
                     warmup=1, reps=3)
        lines.append(f"{len(req.prompt)}/{ex[key].shape[1]}:{ms:.2f}")
    log(f"{tag}: prefill ms by prompt/{key} length {', '.join(lines)}")
    toks = sum(r.emitted for r in results)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{tag}: {toks} tokens in {wall:.2f} s wall ({toks / wall:.1f} tok/s "
        f"end to end, prefills included); generate's host-loop steps: "
        f"{len(steps) / sum(steps):.1f} tok/s, step p50 "
        f"{1e3 * float(np.percentile(steps, 50)):.2f} ms p99 "
        f"{1e3 * float(np.percentile(steps, 99)):.2f} ms; peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated) of {total / 1e9:.1f} GB; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    del params, extras
    gc.collect()
    torch.cuda.empty_cache()
    return counts


#: the dry run's cells driven on the card: (arch, shape); a shape name
#: is a key of ``SHAPES`` (JAX's shape as it stands), a tuple a reduced
#: batch ``(name, seq_len, global_batch, kind)`` of one of them
DRYRUN_CELLS = (
    ("mamba2_1p3b", "long_500k"),
    ("mamba2_1p3b", "decode_32k"),
    ("zamba2_2p7b", "long_500k"),
    ("mamba2_1p3b", ("prefill_32k_b1", 32768, 1, "prefill")),
    ("granite_3_2b", ("prefill_32k_b1", 32768, 1, "prefill")),
    ("granite_3_2b", ("train_4k_b1", 4096, 1, "train")),
    ("granite_3_2b", ("train_4k_b8", 4096, 8, "train")),
)
#: the cell one card holds only with JAX's block remat (every config's
#: ``remat``): its trace at ``remat="none"`` must not fit the card, its
#: trace at ``"block"`` must
REMAT_CELL = ("granite_3_2b", "train_4k_b8")
#: measured peak against the trace's: within 10% or 256 MiB
PEAK_REL, PEAK_ABS = 0.10, 256 * 2 ** 20
#: a mesh cell's measured peak against rank 0's trace, with no floor
#: (0.00-0.28% apart on an H100, the process's cuBLAS workspaces left
#: out; ``scripts/mesh_peak.py`` sets the trace and the allocator side
#: by side)
MESH_PEAK_REL = 0.02


def check_path_kernels(gen):
    """The two kernels at the shapes ``phase_dryrun``'s prefills give
    them (32,768 tokens) against their plain versions on the card:
    ``flash_attention`` at granite's heads in bf16 against the plain
    attention (``FLASH_SERVE_TOL``), ``ssd_scan`` at mamba2's in
    bf16 against the plain chunked scan (``SSD_SERVE_RTOL`` plus twice
    ``SSD_F32_REL`` of the largest output). The attention's plain version
    is the materialized one, a block of queries at a time (the plain
    chunked lane rounds its probabilities to bf16)."""
    import torch
    from repro_torch.kernels import flash_attention, ref, ssd_scan
    B, Hq, Hkv, T, D = 1, 32, 8, 32768, 64
    q, k, v = (torch.randn(s, device=DEVICE, generator=gen).bfloat16()
               for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    got = flash_attention(q, k, v).float()
    # the materialized plain version, 1024 queries at a time over the
    # keys they see (its [rows, keys] scores fit where [T, T] would not)
    want = torch.cat([ref.flash_attention_ref(
        q[:, :, i:i + 1024], k[:, :, :i + 1024], v[:, :, :i + 1024]).float()
        for i in range(0, T, 1024)], dim=2)
    share = float(((got - want).abs() / (
        FLASH_SERVE_TOL["atol"]
        + FLASH_SERVE_TOL["rtol"] * want.abs())).max())
    if not share <= 1:
        fail(f"flash_attention != plain at q [{B},{Hq},{T},{D}] bf16 (the "
             f"worst element at {share} of its limit)")
    log(f"dryrun: flash_attention q [{B},{Hq},{T},{D}] k/v [{B},{Hkv},{T},"
        f"{D}] bf16 causal within rtol 2**-6 + atol 1e-5 of the plain "
        f"attention (max abs err {max_abs_err(got, want):.2e}; the "
        f"worst element at {share:.3f} of its limit)")
    del q, k, v, got, want
    B, T, H, P, S = 1, 32768, 64, 64, 128
    x = torch.randn((B, T, H, P), device=DEVICE, generator=gen).bfloat16()
    a = -torch.nn.functional.softplus(
        torch.randn((B, T, H), device=DEVICE, generator=gen))
    b, c = (torch.randn((B, T, S), device=DEVICE, generator=gen).bfloat16()
            for _ in range(2))
    got = ssd_scan(x, a, b, c).float()
    want = ref.ssd_chunked(x, a, b, c).float()
    limit = (2 * SSD_F32_REL * float(want.abs().max())
             + SSD_SERVE_RTOL * want.abs())
    share = float(((got - want).abs() / limit).max())
    if not torch.isfinite(got).all() or not share <= 1:
        fail(f"ssd_scan != plain at x [{B},{T},{H},{P}] bf16 (the worst "
             f"element at {share} of its limit)")
    log(f"dryrun: ssd_scan x [{B},{T},{H},{P}] b/c [{B},{T},{S}] bf16 within "
        f"rtol 2**-6 + {2 * SSD_F32_REL} x max|y| of the plain chunked scan "
        f"(max abs err {max_abs_err(got, want):.2e}; the worst element at "
        f"{share:.3f} of its limit)")
    del x, a, b, c, got, want, limit
    torch.cuda.empty_cache()


def check_remat_cell(arch, shape, rec):
    """The ``REMAT_CELL``'s trace at ``"block"`` (``rec``) fits the card
    and its trace at ``remat="none"`` does not; prints both peaks."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import HBM_BYTES
    none = dryrun.run_cell(arch, shape, overrides={"remat": "none"})
    if rec["status"] != "ok" or none["status"] != "ok":
        fail(f"dryrun: {arch} {shape.name}: {rec} / remat none {none}")
    peaks = {"block": rec["memory"]["peak_bytes"],
             "none": none["memory"]["peak_bytes"]}
    log(f"dryrun: {arch} {shape.name} traced peak {peaks['block'] / 1e9:.3f}"
        f" GB at remat block, {peaks['none'] / 1e9:.3f} GB at remat none "
        f"(card {HBM_BYTES / 1e9:.0f} GB); FLOPs {rec['cost']['flops']} "
        f"block, {none['cost']['flops']} none "
        f"({rec['cost']['flops'] / none['cost']['flops']:.4f}x); trace "
        f"{none['lower_s']} s at none")
    if not (rec["fits"] and peaks["none"] > HBM_BYTES):
        fail(f"dryrun: {arch} {shape.name} does not split the remat modes: "
             f"block {peaks['block']} bytes, none {peaks['none']} (card "
             f"{HBM_BYTES})")


def _card_flops(bundle) -> int:
    """FLOPs of one run of a step on the card, counted as the dry run
    counts them: the aten matrix products by the dry run's tracer (on a
    mesh, this rank's local products) plus the kernels' formulas."""
    from repro_torch.kernels import cost
    from repro_torch.launch import dryrun
    with cost.counting() as kc, dryrun.StepTracer(bundle.args) as tr:
        out = bundle.fn(*bundle.args)
    del out
    return tr.flops + kc.flops


def dryrun_cell(arch, spec):
    """One cell of ``phase_dryrun``: ``spec`` is a key of ``SHAPES`` or a
    ``(name, seq_len, global_batch, kind)`` tuple. Traces the step on
    ``meta`` (a tuple's length halved until its trace fits), builds it on
    the card from seed 0 at the config's ``remat``, and gates and logs
    its FLOPs, peak and ms against the trace's."""
    import torch
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.steps import build_step
    shape = SHAPES[spec] if isinstance(spec, str) else ShapeSpec(*spec)
    rec = dryrun.run_cell(arch, shape)
    if (arch, shape.name) == REMAT_CELL:
        check_remat_cell(arch, shape, rec)
    while rec["status"] == "ok" and not rec["fits"] \
            and not isinstance(spec, str):
        log(f"dryrun: {arch} {shape.name} at {shape.seq_len} tokens "
            f"does not fit ({rec['memory']['peak_bytes'] / 1e9:.2f} GB):"
            " halved")
        shape = ShapeSpec(f"{shape.name}_{shape.seq_len // 2}",
                          shape.seq_len // 2, shape.global_batch,
                          shape.kind)
        rec = dryrun.run_cell(arch, shape)
    if rec["status"] != "ok":
        fail(f"dryrun: {arch} {shape.name}: {rec}")
    if not rec["fits"]:
        log(f"dryrun: {arch} {shape.name}: the trace's peak "
            f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB does not fit: "
            "not run on the card")
        return
    pred = rec["memory"]["peak_bytes"]
    roof = roofline.roofline_from_cell(rec)
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    bundle = build_step(cfg, shape, device=DEVICE, seed=0)
    flops = _card_flops(bundle)
    if flops != rec["cost"]["flops"]:
        fail(f"dryrun: {arch} {shape.name}: the card counts {flops} "
             f"FLOPs, the trace {rec['cost']['flops']}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = bundle.fn(*bundle.args)
    t1.record()
    t1.synchronize()
    ms = t0.elapsed_time(t1)
    peak = torch.cuda.max_memory_allocated() - base
    # the step's result: the loss and norm of a train step, the
    # logits [B, 1, V] of a prefill or decode step, finite
    res = (list(out[2].values()) if shape.kind == "train"
           else [out[0]])
    ok = all(bool(torch.isfinite(t).all()) for t in res) and (
        shape.kind == "train" or tuple(res[0].shape) ==
        (shape.global_batch, 1, cfg.vocab_padded))
    del out, res, bundle
    if not ok:
        fail(f"dryrun: {arch} {shape.name}: a non-finite or misshapen "
             "result")
    if abs(peak - pred) > max(PEAK_REL * pred, PEAK_ABS):
        fail(f"dryrun: {arch} {shape.name}: measured peak "
             f"{peak / 1e9:.3f} GB against the trace's "
             f"{pred / 1e9:.3f} GB (limit 10% or 256 MiB)")
    log(f"dryrun: {arch} {shape.name} (seq {shape.seq_len}, batch "
        f"{shape.global_batch}, {shape.kind}, remat {cfg.remat}): FLOPs "
        f"{flops} on the card = the trace's; peak {peak / 1e9:.3f} GB "
        f"measured, {pred / 1e9:.3f} GB traced "
        f"({(peak - pred) / pred:+.2%}); step {ms:.2f} ms measured, "
        f"roofline {roof.step_time_s * 1e3:.2f} ms ({roof.dominant}; "
        f"{ms / 1e3 / roof.step_time_s:.2f}x), useful_flops_ratio "
        f"{roof.useful_flops_ratio:.4f}, trace {rec['lower_s']} s")
    gc.collect()
    torch.cuda.empty_cache()


def phase_dryrun(gen):
    """The dry run (``repro_torch.launch.dryrun``) against the card, cell
    by cell (``DRYRUN_CELLS``): trace the step on ``meta`` (a reduced
    batch halved in length until its trace fits), build the same step on
    the card from seed 0, run it twice (the first run under the FLOP
    counters, the peak reset before the second, which is timed by CUDA
    events); the card's FLOPs must equal the trace's exactly and its
    peak (``max_memory_allocated`` above what was allocated before the
    step was built) must lie within 10% or 256 MiB of the trace's.
    Every step runs at its config's ``remat`` (``"block"``); the
    ``REMAT_CELL`` is also traced at ``"none"``, whose peak must exceed
    the card's 80 GB while the ``"block"`` trace fits. Prints the
    measured step ms beside the roofline's ``step_time_s`` and
    ``useful_flops_ratio``. Returns the phase's launch counts."""
    import torch
    from repro_torch.kernels import reset_launch_counts
    t_phase = time.perf_counter()
    check_path_kernels(gen)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    for arch, spec in DRYRUN_CELLS:
        dryrun_cell(arch, spec)
    counts = kernel_launches()
    log(f"dryrun: launches {counts['flash_attention']} flash_attention, "
        f"{counts['ssd_scan']} ssd_scan; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not counts["flash_attention"] or not counts["ssd_scan"]:
        fail(f"dryrun: the prefills launched no kernel: {counts}")
    return counts


#: JAX's production mesh on one card (``phase_mesh``): (arch, shape, depth
#: or None) traced as rank 0 of the 256-device ``single`` mesh and run on
#: the card as that rank over a fake group of 256
MESH_CELLS = (
    ("granite_3_2b", "train_4k", None),
    ("granite_3_2b", "prefill_32k", None),
    ("mamba2_1p3b", "prefill_32k", None),
    ("mistral_large_123b", "train_4k", 4),
)
#: ranks of JAX's pod
MESH_DEVICES = 256


def mesh_cell(arch, shape_name, n_layers):
    """One cell of ``phase_mesh``: the rank-0 trace of the step on the
    256-device mesh (``dryrun.run_cell(..., "single")``, on ``meta``),
    then the same rank's step built on the card from seed 0 over a fake
    group of 256 and run twice (the first under the FLOP counters, the
    second timed by CUDA events with the peak reset before it)."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.launch.steps import build_step
    over = None if n_layers is None else {"n_layers": n_layers}
    cfg = get_config(arch)
    if over:
        log(f"mesh: {arch} {shape_name} cut from {cfg.n_layers} to "
            f"{n_layers} layers (the rank's step is host-bound: the full "
            "depth's trace and two runs would not fit the smoke's time)")
        cfg = cfg.replace(**over)
    rec = dryrun.run_cell(arch, shape_name, "single", overrides=over)
    if rec["status"] != "ok" or rec["devices"] != MESH_DEVICES:
        fail(f"mesh: {arch} {shape_name}: {rec}")
    roof = roofline.roofline_from_cell(rec)
    pred = rec["memory"]["peak_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    with fake_group(MESH_DEVICES):
        mesh = make_production_mesh(device_type=DEVICE)
        base = torch.cuda.memory_allocated()
        bundle = build_step(cfg, SHAPES[shape_name], device=DEVICE, seed=0,
                            mesh=mesh)
        t0 = time.perf_counter()
        flops = _card_flops(bundle)
        t_count = time.perf_counter() - t0
        if flops != rec["cost"]["flops"]:
            fail(f"mesh: {arch} {shape_name}: the card counts {flops} "
                 f"FLOPs, the trace {rec['cost']['flops']}")
        gc.collect()
        torch.cuda.synchronize()
        # what the process holds beside the step's arguments is not the
        # step's: cuBLAS's workspace of each thread (the backward's
        # thread too), made by its first product, stays allocated
        held = torch.cuda.memory_allocated() - sum(
            st.nbytes() for st in {id(t.untyped_storage()):
                                   t.untyped_storage() for t in
                                   dryrun._tensors(bundle.args)}.values())
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = bundle.fn(*bundle.args)
        e1.record()
        e1.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated() - held
        del out, bundle
    if abs(peak - pred) > MESH_PEAK_REL * pred:
        fail(f"mesh: {arch} {shape_name}: measured peak {peak / 1e9:.3f} GB"
             f" against the trace's {pred / 1e9:.3f} GB (limit "
             f"{MESH_PEAK_REL:.0%})")
    coll = rec["collectives"]
    log(f"mesh: {arch} {shape_name} rank 0 of {MESH_DEVICES} "
        f"({cfg.n_layers} layers, remat {cfg.remat}): FLOPs {flops} on the "
        f"card = the trace's; peak {peak / 1e9:.3f} GB measured, "
        f"{pred / 1e9:.3f} GB traced ({(peak - pred) / pred:+.2%}; "
        f"{(held - base) / 2 ** 20:.1f} MiB held by the process besides, "
        "not counted); step "
        f"{ms:.2f} ms by CUDA events ({wall:.1f} ms host wall, counted run "
        f"{t_count:.1f} s), roofline compute {roof.compute_s * 1e3:.2f} ms, "
        f"memory {roof.memory_s * 1e3:.2f} ms; trace {rec['lower_s']} s")
    log(f"mesh: {arch} {shape_name} collectives {coll['count_by_kind']}, "
        f"{coll['wire_bytes']} wire bytes a device: roofline collective "
        f"{roof.collective_s * 1e3:.2f} ms over the network; one card runs "
        "them over a fake group (no byte moves), so the measured step has "
        "no network time")
    gc.collect()
    torch.cuda.empty_cache()


def phase_mesh():
    """JAX's production mesh on one card (``MESH_CELLS``): each cell's
    step as rank 0 of the 256-device ``(data, model)`` mesh, traced on
    ``meta`` and run on the card over a fake group, whose collectives
    return without moving a byte (so the outputs hold no values to check;
    the CPU tests hold the sharded step's values to the one-device
    step's and to JAX's). Gates: FLOPs equal to the trace's, peak within
    2% of it (``MESH_PEAK_REL``), and ``flash_attention`` and
    ``ssd_scan`` launched (at the rank's local heads) by the prefills.
    Returns the phase's launch counts."""
    from repro_torch.kernels import reset_launch_counts
    t_phase = time.perf_counter()
    reset_launch_counts()
    for arch, shape_name, n_layers in MESH_CELLS:
        mesh_cell(arch, shape_name, n_layers)
    counts = kernel_launches()
    log(f"mesh: launches {counts['flash_attention']} flash_attention, "
        f"{counts['ssd_scan']} ssd_scan; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not counts["flash_attention"] or not counts["ssd_scan"]:
        fail(f"mesh: the prefills launched no kernel: {counts}")
    return counts


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--process-group-child"]:
        return process_group_child(int(sys.argv[2]), int(sys.argv[3]))
    dryrun_only = sys.argv[1:2] == ["--dryrun-only"]
    mesh_only = sys.argv[1:2] == ["--mesh-only"]
    t_main = time.perf_counter()
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
    if dryrun_only or mesh_only:       # one phase alone: no result line
        phase_dryrun(gen) if dryrun_only else phase_mesh()
        log(f"total: {time.perf_counter() - t_main:.1f} s")
        log(smi)
        return 0
    tr, pipe = build_cell("float32")   # its d_shard sets the kernels' shapes
    d_cell = tr.d_shard
    results = phase_kernels(gen, tr)
    phase_shuffle()
    phase_waves(gen)
    phase_topology(gen)
    counts, rep32, peak32 = phase_train(tr, pipe)
    p32 = param_slices(tr)
    check_remat_map(tr, pipe)
    del tr, pipe                       # the bf16 cell's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    phase_churn(p32, rep32)
    gc.collect()
    torch.cuda.empty_cache()
    tr, pipe = build_cell("bfloat16")
    counts16, rep16, peak16 = phase_train(tr, pipe)
    compare_lanes(rep32, peak32, rep16, peak16)
    for name in lane_kernels("bfloat16", tr.K):
        counts[name] = counts16[name]
    del tr, pipe
    gc.collect()
    torch.cuda.empty_cache()
    tr, pipe = build_cell("float32", "multipass")
    counts_mp, rep_mp, peak_mp = phase_train(tr, pipe)
    compare_codecs(rep32, peak32, rep_mp, peak_mp)
    for name in lane_kernels("float32", tr.K, "multipass"):
        counts[name] = counts_mp[name]
    # xor_encode is on no training path: every run held its count to 0
    del tr, pipe
    gc.collect()
    torch.cuda.empty_cache()
    # the SSM family on the f32 lane: its scans take the plain
    # differentiable form, so the run launches the lane's codec kernels
    # and neither prefill kernel (phase_train holds every other count to 0)
    tr, pipe = build_cell("float32", arch=SSM_TRAIN_ARCH,
                          n_layers=SSM_TRAIN_LAYERS)
    phase_train(tr, pipe)
    del tr, pipe
    gc.collect()
    torch.cuda.empty_cache()
    # the hybrid family on the bf16 lane, with the same gates
    tr, pipe = build_cell("bfloat16", arch=HYBRID_TRAIN_ARCH,
                          n_layers=HYBRID_TRAIN_LAYERS)
    phase_train(tr, pipe)
    del tr, pipe
    gc.collect()
    torch.cuda.empty_cache()
    # the MoE family on the f32 lane (its training attention is plain
    # and its experts are batched products: the lane's kernels only)
    tr, pipe = build_cell("float32", arch=MOE_TRAIN_ARCH, **MOE_TRAIN_CUT)
    phase_train(tr, pipe)
    del tr, pipe
    gc.collect()
    torch.cuda.empty_cache()
    # the chunked attention lane past 1448 tokens, then the paper's modes
    phase_chunked()
    gc.collect()
    torch.cuda.empty_cache()
    camr = phase_modes(rep32)
    gc.collect()
    torch.cuda.empty_cache()
    phase_oracle(camr)
    gc.collect()
    torch.cuda.empty_cache()
    phase_checkpoint()
    pg_counts = phase_process_group()
    for name, c in pg_counts.items():
        counts[name] += c
    for name, c in phase_compare(d_cell).items():
        counts[name] += c
    phase_examples()
    served = [phase_serve(arch, depth, lens)
              for arch, depth, lens in SERVE_RUNS]
    served += [phase_legacy(arch, runs) for arch, runs in LEGACY_RUNS]
    served.append(phase_serve(**SERVE_F32_RUN))
    for name in ("flash_attention", "flash_attention_f32", "ssd_scan",
                 "ssd_scan_f32"):
        counts[name] = sum(c[name] for c in served)
    for name, c in phase_dryrun(gen).items():
        counts[name] += c
    for name, c in phase_mesh().items():
        counts[name] += c

    kernels = []
    for name, r in results.items():
        src, replaces = SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r.get("bound_by", "bytes"),
            library_ms=r["library_ms"]))
    log(f"total: {time.perf_counter() - t_main:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
