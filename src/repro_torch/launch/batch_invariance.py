"""Does a decode row's result depend on how many rows share the step?

    PYTHONPATH=src python -m repro_torch.launch.batch_invariance

On the current CUDA device, at ``granite_3_2b``'s full width in bf16
(weights from ``init_params`` with seed 0):

1. each product and norm of a decode step alone: row 0 of a call on M
   rows (the others random) against the call on row 0 alone, for M in
   ``ROWS``; then at the fixed width ``lm.DECODE_ROWS`` with the other
   rows zero against random;
2. the whole :func:`repro_torch.models.lm.decode_step` (``LAYERS``
   layers, ``B`` prompts of ``PROMPT`` tokens, each prefilled alone and
   their caches stacked): the ``B``-row step against each row's ``B=1``
   step, unpadded (``DECODE_ROWS`` set to the row count) and at the
   fixed width, bitwise and by greedy token; and the steps' wall times.

Prints one line per reading and a last JSON line with all of them.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm

ROWS = (2, 3, 4, 8, 16)
LAYERS = 40
B = 4
PROMPT = 512


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                            else a, b.view(torch.int16)
                            if b.dtype == torch.bfloat16 else b))


def ops_alone(cfg, params, gen) -> dict:
    """Row 0's bits at M rows against M = 1, per product and norm."""
    blk = {k: v[0] for k, v in params["blocks"]["0_attn"]["attn"].items()}
    blk.update({k: v[0] for k, v in params["blocks"]["0_attn"]["mlp"].items()})
    products = {name: blk[name] for name in
                ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
    products["logits"] = params["embed"].T
    norm = params["blocks"]["0_attn"]["norm1"][0]
    ops = {name: (w.shape[0], lambda x, w=w: L.dense(x, w))
           for name, w in products.items()}
    ops["rms_norm"] = (cfg.d_model, lambda x: L.rms_norm(x, norm))
    out = {}
    for name, (d_in, fn) in ops.items():
        x = torch.randn((lm.DECODE_ROWS, 1, d_in), generator=gen,
                        device=gen.device).to(cfg.torch_dtype)
        one = fn(x[:1])
        differs = [m for m in ROWS if not _same(fn(x[:m])[:1], one)]
        wide = fn(x)[:1]
        zeros = fn(torch.cat([x[:1], torch.zeros_like(x[1:])]))[:1]
        out[name] = {"differs_at_rows": differs,
                     "fixed_width_rows_independent": _same(wide, zeros)}
        print(f"{name} [{d_in} in]: row 0 differs from the 1-row call at M = "
              f"{differs or 'none'} of {list(ROWS)}; at {lm.DECODE_ROWS} "
              f"rows, other rows random == zero: "
              f"{out[name]['fixed_width_rows_independent']}", flush=True)
    return out


def _clone(cache):
    return {n: {"self": {k: v.clone() for k, v in e["self"].items()}}
            for n, e in cache.items()}


def _step_ms(cfg, params, cache, toks, reps=5) -> tuple:
    """(logits of the step, median wall ms over ``reps`` reruns on clones)."""
    times = []
    for _ in range(reps + 1):
        c = _clone(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = lm.decode_step(cfg, params, c, toks, PROMPT)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return lg, float(np.median(times[1:]))


def whole_step(cfg, params) -> dict:
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    dev = params["embed"].device
    caches, toks = [], []
    for r in range(B):
        lg, c = lm.prefill(cfg, params, {"tokens": torch.from_numpy(
            prompts[r:r + 1]).to(dev)}, max_len=PROMPT + 1)
        caches.append(c)
        toks.append(lg[:, -1, :cfg.vocab].argmax(-1).to(torch.int32))
    stacked = {n: {"self": {k: torch.cat([c[n]["self"][k] for c in caches],
                                         dim=1)
                            for k in ("k", "v")}} for n in caches[0]}
    toks = torch.stack(toks)                                  # [B, 1]
    out = {}
    fixed = lm.DECODE_ROWS
    try:
        for label, width in (("unpadded", None), ("fixed width", fixed)):
            lm.DECODE_ROWS = B if width is None else width
            batch, ms_b = _step_ms(cfg, params, stacked, toks)
            lm.DECODE_ROWS = 1 if width is None else width
            rows = [_step_ms(cfg, params, caches[r], toks[r:r + 1])
                    for r in range(B)]
            bitwise = [_same(batch[r], rows[r][0][0]) for r in range(B)]
            argmax = [bool(batch[r].argmax() == rows[r][0][0].argmax())
                      for r in range(B)]
            diff = max(float((batch[r] - rows[r][0][0]).abs().max())
                       for r in range(B))
            out[label] = {"rows_bitwise": bitwise, "argmax_equal": argmax,
                          "max_abs_logit_diff": diff,
                          "step_ms_batch": ms_b,
                          "step_ms_one_row": [r[1] for r in rows]}
            print(f"decode_step {label} ({cfg.n_layers} layers, {B} rows at "
                  f"position {PROMPT}): rows bitwise the B=1 step's: "
                  f"{bitwise}; greedy token equal: {argmax}; max |logit "
                  f"diff| {diff:.3g}; step {ms_b:.2f} ms for {B} rows, "
                  f"{[round(r[1], 2) for r in rows]} ms for one", flush=True)
    finally:
        lm.DECODE_ROWS = fixed
    return out


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cfg = get_config("granite_3_2b").replace(n_layers=LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    print(f"device: {smi}; granite_3_2b, {LAYERS} layers, {cfg.dtype}",
          flush=True)
    res = {"ops": ops_alone(cfg, params, gen),
           "decode_step": whole_step(cfg, params)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
