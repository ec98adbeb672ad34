"""Serve a small model two ways on the PyTorch port: the legacy host
loop (``generate``, one host sync per token) and the continuous-batching
``DecodeEngine`` / ``ServeStream`` (wave decode over paged KV slots) —
then check the engine reproduces the host loop token-for-token.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.serve import (DecodeEngine, Request, ServeStream,
                                       generate)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = reduced(get_config("gemma2_2b"))   # local/global + softcaps
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    B, P, NEW = 4, 12, 16
    prompts = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)

    t0 = time.time()
    res = generate(cfg, params, prompts, max_new=NEW, device=device)
    dt = time.time() - t0
    print(f"host loop: batch={B} prompt={P} new={res.steps} "
          f"({B * res.steps / dt:.1f} tok/s on {device.type})")
    print(res.tokens[:, P:])

    # consistency: greedy decode must match teacher-forced argmax
    with torch.no_grad():
        lg, _ = lm.prefill(cfg, params, {"tokens": torch.as_tensor(
            res.tokens[:, :P + 1], device=device)})
    want = int(torch.argmax(lg[0, -1, :cfg.vocab]))
    assert want == int(res.tokens[0, P + 1])
    print("OK (teacher-forcing consistency verified)")

    # the production shape: ragged requests through the wave engine
    reqs = [Request(prompt=prompts[i, :P - 2 * i], max_new=NEW)
            for i in range(B)]
    engine = DecodeEngine(cfg, params, slots=2, page_size=8,
                          max_ctx=P + NEW, max_new_cap=NEW, device=device)
    stream = ServeStream(engine, wave_len=8)
    stream.run(reqs)                         # warm the engine
    t0 = time.time()
    results = stream.run(reqs)
    dt = time.time() - t0
    rep = stream.last_report
    toks = sum(r.emitted for r in results)
    print(f"engine: {len(reqs)} ragged reqs, {toks} tokens "
          f"({toks / dt:.1f} tok/s), {rep.waves} waves, "
          f"occupancy {rep.occupancy:.2f}, traces {rep.traces}")
    for r in results:
        oracle = generate(cfg, params, r.tokens[None, :r.prompt_len],
                          max_new=NEW, device=device)
        assert np.array_equal(oracle.tokens[0, r.prompt_len:],
                              r.generated)
    print("OK (engine == host-loop oracle, token for token)")


if __name__ == "__main__":
    main()
