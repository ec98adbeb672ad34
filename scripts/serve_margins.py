"""Greedy margins of the JAX reference on the page-reuse case of
``tests/test_serve.py::test_paged_eviction_reuse_never_aliases_live_rows``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/serve_margins.py

Runs the test's requests (reduced gemma2 from ``PRNGKey(0)``, prompts of
6, 4 and 5 tokens from seed 7; B stops after 2 tokens and C reuses its
pages) through the JAX ``DecodeEngine`` behind ``ServeStream``, then each
request through ``generate``'s own prefill and decode steps, and prints
per request the tokens of both, the first step where they differ (if
any) and, at every step, the gap between the two largest logits of
``generate``. A token that flips between the two needs a logit change of
at least that gap.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced
from repro.models import lm
from repro.runtime.serve import (DecodeEngine, Request, ServeStream,
                                 _legacy_fns)


def main() -> None:
    cfg = reduced(get_config("gemma2_2b"))
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
               for t in (6, 4, 5)]
    reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts,
                                                        (10, 2, 10))]
    eng = DecodeEngine(cfg, params, slots=2, page_size=4, max_ctx=16,
                       n_pages=9, max_new_cap=10)
    results = ServeStream(eng, wave_len=2).run(reqs)
    for name, req, res in zip("ABC", reqs, results):
        T = len(req.prompt)
        prefill_fn, step_fn = _legacy_fns(cfg, T + req.max_new)
        logits, cache = prefill_fn(params,
                                   {"tokens": jnp.asarray(req.prompt[None])})
        toks, gaps = [], []
        for i in range(req.max_new):
            lg = np.sort(np.asarray(logits[0, -1, :cfg.vocab], np.float64))
            gaps.append(lg[-1] - lg[-2])
            toks.append(int(np.argmax(logits[0, -1, :cfg.vocab])))
            logits, cache = step_fn(params, cache,
                                    jnp.asarray([[toks[-1]]], jnp.int32),
                                    jnp.int32(T + i))
        got = [int(t) for t in res.generated[:len(toks)]]
        diff = [i for i, (a, b) in enumerate(zip(toks, got)) if a != b]
        print(f"{name}: generate {toks}; engine {got}; first difference "
              f"at step {diff[0] if diff else None}; top-two gaps "
              + ", ".join(f"{g:.4g}" for g in gaps))


if __name__ == "__main__":
    main()
