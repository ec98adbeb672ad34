"""The port's serving path on the CPU: the model's prefill and decode
steps against the JAX package's, the legacy ``generate`` and the
``DecodeEngine`` against JAX's, and inside the port the twins of
``tests/test_serve.py`` (its mamba cases are in ``test_torch_ssm.py``) and of
``tests/test_serve_chaos.py``, driven through ``tests/chaos.py``'s
``ServeChaosController``.

Both packages start from the same parameters: ``repro.models.lm.
init_params`` exported through ``repro_torch.weights.params_from_jax``.

Tolerances, and why: logits atol/rtol 1e-4 against JAX (the same f32
math, summed in other orders by XLA and by PyTorch's CPU kernels);
greedy tokens exact against JAX (the logits' differences are far below
the reduced models' top-1 margins); inside the port every token
comparison is bitwise (a decode step runs at one fixed width whatever
its row count, so the engine's batched step gives each row the bits of
``generate``'s ``B=1`` step). Temperature > 0 is held inside the port only:
torch's random numbers are not ``jax.random``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chaos import (ServeChaosController, ServeFaultPlan, SlotPoison,
                   WaveCrash, WaveLatency)
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm as jlm
from repro.runtime import serve as jserve
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.runtime.serve import (STATUSES, DecodeEngine, PagePool,
                                       Request, ServeStream, WaveCrashError,
                                       generate, serve_legacy, trace_total)
from repro_torch.weights import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch):
    """(jax cfg, jax params, port cfg, port params) from one init."""
    jcfg = jax_reduced(jax_get_config(arch))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def granite():
    return _pair("granite_3_2b")


@pytest.fixture(scope="module")
def gemma_pair():
    return _pair("gemma2_2b")


@pytest.fixture(scope="module")
def gemma(gemma_pair):
    return gemma_pair[2], gemma_pair[3]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
            for t in lens]


def _oracle_gen(cfg, params, req):
    """Per-request B=1 host loop of the port (the oracle)."""
    res = generate(cfg, params, np.asarray(req.prompt)[None],
                   max_new=req.max_new, eos=req.eos,
                   temperature=req.temperature, seed=req.seed,
                   pad=req.pad, device="cpu")
    return res.tokens[0, len(req.prompt):]


def _assert_parity(cfg, params, reqs, results):
    for req, res in zip(reqs, results):
        want = _oracle_gen(cfg, params, req)
        got = res.generated[:len(want)]
        assert np.array_equal(want, got), (
            f"plen={res.prompt_len}: oracle {want} != engine {got}")


def _engine(cfg, params, **kw):
    kw = {"slots": 2, "page_size": 4, "max_ctx": 16, "max_new_cap": 6,
          **kw}
    return DecodeEngine(cfg, params, device="cpu", **kw)


# --------------------------------------------------------------------- #
# the model's serving half against JAX
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["granite_3_2b", "gemma2_2b"])
def test_prefill_and_decode_logits_match_jax(arch, request):
    """Contiguous cache: prefill then two decode steps; paged cache: two
    slots admitted from B=1 prefills, then ragged decode steps (host
    positions) with a finished (-1) row. The JAX paged step attends over
    the whole slot under a length mask, the port's over exactly the
    valid keys: f32 sums in another order, hence the tolerance."""
    jcfg, jp, cfg, p = request.getfixturevalue(
        {"granite_3_2b": "granite", "gemma2_2b": "gemma_pair"}[arch])
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         max_len=12)
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)},
                        max_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i, col in ((9, toks[:, :1]), (10, toks[:, 1:2])):
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(col),
                                 jnp.int32(i))
        tl, tc = lm.decode_step(cfg, p, tc, torch.from_numpy(col), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # paged: slots of 3 pages of 4; prompts of 5 and 7 tokens
    pages = [np.array([1, 2, 3], np.int32), np.array([4, 5, 6], np.int32)]
    jpg = jlm.init_paged_cache(jcfg, 2, 7, 4, 3)
    tpg = lm.init_paged_cache(cfg, 2, 7, 4, 3, device="cpu")
    lens = [5, 7]
    for s, T in enumerate(lens):
        pr = toks[s:s + 1, :T]
        _, jpc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(pr)},
                             max_len=8)
        _, tpc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(pr)},
                            max_len=8)
        jpg = jlm.admit_prefill(jcfg, jpg, jpc, jnp.asarray(pages[s]),
                                jnp.int32(s))
        lm.admit_prefill(cfg, tpg, tpc, torch.from_numpy(pages[s]), s)
    for name in lm.slot_names(cfg):
        for key in ("k", "v", "pages"):
            np.testing.assert_allclose(tpg[name]["self"][key].numpy(),
                                       np.asarray(jpg[name]["self"][key]),
                                       **TOL)
    for step, ci in enumerate(([5, 7], [6, -1])):
        col = toks[:, step:step + 1]
        jl, jpg = jlm.decode_step(jcfg, jp, jpg, jnp.asarray(col),
                                  jnp.asarray(ci, jnp.int32))
        tl, tpg = lm.decode_step(cfg, p, tpg, torch.from_numpy(col), ci)
        live = [b for b, i in enumerate(ci) if i >= 0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)


def _clone_cache(cache):
    return {n: {"self": {k: v.clone() for k, v in e["self"].items()}}
            for n, e in cache.items()}


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_rows_do_not_depend_on_batch(granite, paged):
    """A row's logits are bitwise the same in a step of three rows and in
    a step of its own: every step runs its products and norms at one
    width (``lm.DECODE_ROWS``), and each row attends over exactly its
    own valid keys. This is what lets the engine batch its slots."""
    _, _, cfg, p = granite
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 9)) \
        .astype(np.int32)
    col = torch.from_numpy(toks[:, :1])
    if paged:
        lens = [9, 5, 7]
        cache = lm.init_paged_cache(cfg, 3, 10, 4, 3, device="cpu")
        for s, T in enumerate(lens):
            _, pc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(
                toks[s:s + 1, :T])}, max_len=12)
            lm.admit_prefill(cfg, cache, pc, torch.tensor(
                [3 * s + 1, 3 * s + 2, 3 * s + 3], dtype=torch.int32), s)
        batch, _ = lm.decode_step(cfg, p, _clone_cache(cache), col, lens)
        for s, T in enumerate(lens):
            one = {n: {"self": dict(e["self"], pages=e["self"]["pages"][
                :, s:s + 1])} for n, e in _clone_cache(cache).items()}
            row, _ = lm.decode_step(cfg, p, one, col[s:s + 1], [T])
            assert torch.equal(batch[s], row[0])
    else:
        caches = [lm.prefill(cfg, p, {"tokens": torch.from_numpy(
            toks[s:s + 1])}, max_len=10)[1] for s in range(3)]
        cache = {n: {"self": {k: torch.cat([c[n]["self"][k] for c in caches],
                                           dim=1) for k in ("k", "v")}}
                 for n in caches[0]}
        batch, _ = lm.decode_step(cfg, p, cache, col, 9)
        for s in range(3):
            row, _ = lm.decode_step(cfg, p, caches[s], col[s:s + 1], 9)
            assert torch.equal(batch[s], row[0])


def test_engine_decodes_all_slots_in_one_step(gemma, monkeypatch):
    """Each wave step of the engine is one ``decode_step`` of all its
    slots (finished ones at -1), not one per live slot."""
    cfg, params = gemma
    calls = []
    real = lm.decode_step

    def spy(cfg_, params_, cache, tokens, cache_index):
        calls.append(list(cache_index))
        return real(cfg_, params_, cache, tokens, cache_index)

    monkeypatch.setattr(lm, "decode_step", spy)
    eng = _engine(cfg, params, slots=3, max_ctx=24, max_new_cap=6)
    reqs = [Request(prompt=pr, max_new=m) for pr, m in
            zip(_prompts(cfg, [5, 9, 3, 7]), [6, 2, 4, 3])]
    results = ServeStream(eng, wave_len=2).run(reqs)
    assert [r.status for r in results] == ["ok"] * 4
    assert len(calls) == int(eng.st["step"])
    assert all(len(c) == 3 for c in calls)
    assert any(sum(i >= 0 for i in c) > 1 for c in calls)
    monkeypatch.undo()
    _assert_parity(cfg, params, reqs, results)


def test_engine_refuses_more_slots_than_a_step_has_rows(gemma):
    cfg, params = gemma
    with pytest.raises(ValueError, match="DECODE_ROWS"):
        _engine(cfg, params, slots=lm.DECODE_ROWS + 1)
    with pytest.raises(ValueError, match="DECODE_ROWS"):
        lm.decode_step(cfg, params, {}, torch.zeros(
            (lm.DECODE_ROWS + 1, 1), dtype=torch.int32), 0)


def test_prefill_matches_jax_with_the_pallas_kernel(granite):
    """The JAX prefill with ``use_pallas=True`` runs the Pallas
    ``flash_attention`` in interpret mode inside the model."""
    jcfg, jp, cfg, p = granite
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 40)) \
        .astype(np.int32)
    jl, _ = jlm.prefill(jcfg.replace(use_pallas=True), jp,
                        {"tokens": jnp.asarray(toks)})
    tl, _ = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.fixture(scope="module")
def jax_greedy(gemma_pair):
    """JAX's greedy tokens: ``generate`` per prompt and one
    ``DecodeEngine`` stream over ragged requests."""
    jcfg, jp, cfg, _ = gemma_pair
    prompts = _prompts(cfg, [3, 11, 6, 9, 1, 5], seed=21)
    gen = [np.asarray(jserve.generate(jcfg, jp, pr[None], max_new=7)
                      .tokens[0, len(pr):]) for pr in prompts[:3]]
    reqs = [jserve.Request(prompt=pr, max_new=7) for pr in prompts]
    eng = jserve.DecodeEngine(jcfg, jp, slots=3, page_size=4, max_ctx=24,
                              max_new_cap=7)
    res = jserve.ServeStream(eng, wave_len=3).run(reqs)
    return prompts, gen, [np.asarray(r.generated) for r in res]


def test_generate_greedy_tokens_match_jax(gemma_pair, jax_greedy):
    _, _, cfg, p = gemma_pair
    prompts, want, _ = jax_greedy
    for pr, w in zip(prompts, want):
        got = generate(cfg, p, pr[None], max_new=7, device="cpu")
        assert np.array_equal(got.tokens[0, len(pr):], w)


def test_engine_greedy_tokens_match_jax_engine(gemma_pair, jax_greedy):
    _, _, cfg, p = gemma_pair
    prompts, _, want = jax_greedy
    eng = _engine(cfg, p, slots=3, max_ctx=24, max_new_cap=7)
    res = ServeStream(eng, wave_len=3).run(
        [Request(prompt=pr, max_new=7) for pr in prompts])
    for r, w in zip(res, want):
        assert r.status == "ok" and np.array_equal(r.generated, w)


# --------------------------------------------------------------------- #
# twins of tests/test_serve.py (inside the port)
# --------------------------------------------------------------------- #
def test_generate_post_eos_rows_emit_pad(gemma):
    cfg, params = gemma
    prompts = np.asarray(_prompts(cfg, [6])[0])[None].repeat(3, 0)
    first = generate(cfg, params, prompts, max_new=1,
                     device="cpu").tokens[0, -1]
    res = generate(cfg, params, prompts, max_new=8, eos=int(first),
                   device="cpu")
    for row in res.tokens[:, prompts.shape[1]:]:
        hit = np.where(row == int(first))[0]
        assert len(hit) > 0
        assert (row[hit[0]:] == int(first)).all()
    res2 = generate(cfg, params, prompts, max_new=8, eos=int(first), pad=0,
                    device="cpu")
    for row in res2.tokens[:, prompts.shape[1]:]:
        hit = np.where(row == int(first))[0]
        assert (row[hit[0] + 1:] == 0).all()


def test_generate_second_call_zero_rebuild(gemma):
    cfg, params = gemma
    prompts = np.stack(_prompts(cfg, [7, 7], seed=3))
    r1 = generate(cfg, params, prompts, max_new=5, eos=1, device="cpu")
    before = trace_total()
    r2 = generate(cfg, params, prompts, max_new=5, eos=1, device="cpu")
    assert trace_total() == before
    assert np.array_equal(r1.tokens, r2.tokens)
    assert len(r1.step_times) == r1.steps


def test_page_pool_never_aliases():
    pool = PagePool(8)
    a = pool.alloc(0, 3)
    b = pool.alloc(1, 3)
    assert a is not None and b is not None
    assert 0 not in a + b
    assert not set(a) & set(b)
    pool.check_invariants()
    assert pool.alloc(2, 2) is None
    pool.free(0)
    assert set(pool.alloc(2, 3)) == set(a)
    pool.check_invariants()
    with pytest.raises(ValueError):
        pool.alloc(1, 1)
    with pytest.raises(ValueError):
        PagePool(1)


def test_paged_eviction_reuse_never_aliases_live_rows(gemma):
    cfg, params = gemma
    pa, pb, pc = _prompts(cfg, [6, 4, 5], seed=7)
    reqs = [Request(prompt=pa, max_new=10), Request(prompt=pb, max_new=2),
            Request(prompt=pc, max_new=10)]
    eng = _engine(cfg, params, n_pages=9, max_new_cap=10)
    results = ServeStream(eng, wave_len=2).run(reqs)
    eng.pool.check_invariants()
    _assert_parity(cfg, params, reqs, results)


def test_engine_greedy_parity_ragged_prompts(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=8)
            for p in _prompts(cfg, [3, 11, 6, 9, 1, 5], seed=1)]
    eng = _engine(cfg, params, slots=3, max_ctx=24, max_new_cap=8)
    _assert_parity(cfg, params, reqs, ServeStream(eng, wave_len=4).run(reqs))


def test_engine_early_eos_parity(gemma):
    cfg, params = gemma
    prompts = _prompts(cfg, [5, 5, 8, 8], seed=2)
    eos = [int(generate(cfg, params, p[None], max_new=1,
                        device="cpu").tokens[0, -1]) for p in prompts]
    reqs = [Request(prompt=p, max_new=6, eos=e if i % 2 == 0 else None)
            for i, (p, e) in enumerate(zip(prompts, eos))]
    eng = _engine(cfg, params, slots=4)
    results = ServeStream(eng, wave_len=3).run(reqs)
    _assert_parity(cfg, params, reqs, results)
    for req, res in zip(reqs, results):
        if req.eos is not None:
            assert res.emitted < req.max_new


def test_engine_temperature_parity_pinned_seed(gemma):
    """Sampled tokens bitwise the port's ``generate`` with the same seed
    (one generator per slot, one draw per token); another seed samples
    another sequence."""
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=6, temperature=0.8, seed=40 + i)
            for i, p in enumerate(_prompts(cfg, [4, 7, 6], seed=4))]
    results = ServeStream(_engine(cfg, params), wave_len=4).run(reqs)
    _assert_parity(cfg, params, reqs, results)
    other = [Request(prompt=r.prompt, max_new=6, temperature=0.8,
                     seed=r.seed + 100) for r in reqs]
    again = ServeStream(_engine(cfg, params), wave_len=4).run(other)
    assert any(not np.array_equal(a.tokens, b.tokens)
               for a, b in zip(results, again))


@pytest.mark.parametrize("waves", [(1, 8), (2, 3)])
def test_engine_wave_length_invariance(gemma, waves):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=8)
            for p in _prompts(cfg, [6, 4, 9], seed=6)]

    def run(wave):
        eng = _engine(cfg, params, max_ctx=24, max_new_cap=8)
        stream = ServeStream(eng, wave_len=wave)
        res = stream.run(reqs)
        rep = stream.last_report
        assert sum(s[2] for s in rep.wave_stats) == int(eng.st["step"])
        assert sum(s[3] for s in rep.wave_stats) == 24
        assert 0 < rep.occupancy <= 1
        return res

    a, b = (run(w) for w in waves)
    for ra, rb in zip(a, b):
        assert np.array_equal(ra.tokens, rb.tokens)


def test_engine_mid_stream_admission_zero_rebuilds(gemma):
    cfg, params = gemma
    lens = [3, 6, 9]

    def mk(seed):
        return [Request(prompt=p, max_new=5)
                for p in _prompts(cfg, lens * 2, seed=seed)]

    eng = _engine(cfg, params, max_new_cap=5)
    stream = ServeStream(eng, wave_len=3)
    stream.run(mk(8))
    assert stream.last_report.admitted == 6
    before = trace_total()
    r2 = stream.run(mk(9))
    assert trace_total() == before
    assert stream.last_report.traces == 0
    _assert_parity(cfg, params, mk(9), r2)


def test_engine_multi_tenant_stream(gemma, granite):
    gcfg, gparams = gemma
    _, _, rcfg, rparams = granite
    engines = {"gemma": _engine(gcfg, gparams, max_new_cap=5, name="gemma"),
               "granite": _engine(rcfg, rparams, max_new_cap=5,
                                  name="granite")}
    jobs = [("gemma", Request(prompt=p, max_new=5))
            for p in _prompts(gcfg, [4, 7, 5], seed=10)]
    jobs += [("granite", Request(prompt=p, max_new=5))
             for p in _prompts(rcfg, [6, 3, 8], seed=11)]
    results = ServeStream(engines, wave_len=3).run(jobs)
    for (name, req), res in zip(jobs, results):
        assert res.model == name and res.status == "ok"
        cfg, params = ((gcfg, gparams) if name == "gemma"
                       else (rcfg, rparams))
        want = _oracle_gen(cfg, params, req)
        assert np.array_equal(want, res.generated[:len(want)])


def test_engine_rejects_oversized_and_unsupported(gemma):
    cfg, params = gemma
    eng = _engine(cfg, params, max_ctx=8, max_new_cap=4)
    with pytest.raises(ValueError):
        eng.validate(Request(prompt=np.zeros(7, np.int32), max_new=4))
    with pytest.raises(ValueError):
        eng.validate(Request(prompt=np.zeros(2, np.int32), max_new=9))
    with pytest.raises(KeyError):
        ServeStream(eng).run([("nope", Request(prompt=np.zeros(2, np.int32),
                                               max_new=2))])
    # the enc-dec and ViT configs are served by the legacy path only:
    # the engine and the paged cache refuse them, as JAX's do
    enc = cfg.replace(name="seamless", family="encdec", n_enc_layers=2)
    vit = cfg.replace(name="internvl2", frontend="vit", frontend_dim=24,
                      frontend_len=8)
    for c in (enc, vit):
        with pytest.raises(NotImplementedError, match="legacy generate"):
            DecodeEngine(c, None)
    with pytest.raises(NotImplementedError, match="legacy generate"):
        lm.init_paged_cache(enc, 2, 5, 4, 2, device="cpu")
    moe = cfg.replace(name="mixtral", family="moe", n_experts=4,
                      experts_per_token=2)
    assert set(lm.init_paged_cache(moe, 2, 5, 4, 2, device="cpu")) == \
        set(lm.slot_names(moe))
    assert {"gemma2_2b", "mamba2_1p3b", "zamba2_2p7b", "mixtral_8x7b",
            "moonshot_v1_16b_a3b", "seamless_m4t_large_v2",
            "internvl2_26b"} <= set(ARCHS)


def test_serial_stream_matches_pipelined(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=5)
            for p in _prompts(cfg, [5, 8, 4, 6], seed=12)]

    def run(pipeline):
        eng = _engine(cfg, params, max_new_cap=5)
        return ServeStream(eng, wave_len=3, pipeline=pipeline).run(reqs)

    for ra, rb in zip(run(True), run(False)):
        assert np.array_equal(ra.tokens, rb.tokens)


def test_gemma2_reduced_config_matches_jax():
    want = jax_reduced(jax_get_config("gemma2_2b"))
    got = reduced(get_config("gemma2_2b"))
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "pattern", "local_window", "window",
              "attn_softcap", "final_softcap", "mlp_act", "tie_embeddings",
              "scale_embed", "rope_theta", "dtype", "loss_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.local_window == 32
    full = get_config("gemma2_2b")
    assert (full.n_layers, full.d_model, full.hd, full.vocab_padded) == \
        (26, 2304, 256, 256000)


# --------------------------------------------------------------------- #
# serving needs a card or an explicit CPU
# --------------------------------------------------------------------- #
def test_serving_without_a_card_raises(monkeypatch, gemma):
    cfg, params = gemma
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(cfg, params, prompt, max_new=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_legacy(cfg, params, [Request(prompt=prompt[0], max_new=2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--archs", "gemma2_2b", "--reduced"])
    with pytest.raises(ValueError, match="params lie on"):
        DecodeEngine(cfg, {"embed": torch.zeros(1, device="meta")},
                     device="cpu")


def test_launcher_engine_and_legacy_paths(capsys):
    launch_serve.main(["--archs", "gemma2_2b,granite_3_2b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--max-new",
                       "4", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "engine: 6 reqs / 24 tokens" in out and "status: ok=6" in out
    assert "builds/loads during run: 0" in out
    launch_serve.main(["--archs", "gemma2_2b", "--reduced", "--device",
                       "cpu", "--legacy", "--requests", "2", "--max-new",
                       "3", "--max-queue", "1"])
    out = capsys.readouterr().out
    assert "status: ok=1 shed=1" in out
    launch_serve.main(["--archs", "seamless_m4t_large_v2", "--reduced",
                       "--device", "cpu", "--legacy", "--requests", "2",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "seamless_m4t_large_v2: 2 reqs (legacy host loop) 6 tokens" in out
    assert "status: ok=2" in out


# --------------------------------------------------------------------- #
# twins of tests/test_serve_chaos.py
# --------------------------------------------------------------------- #
class _PortChaos(ServeChaosController):
    """``tests/chaos.py``'s controller raises the JAX package's
    ``WaveCrashError``; the port's supervisor retries its own."""

    def on_wave_crash(self, model, wave, engine):
        try:
            super().on_wave_crash(model, wave, engine)
        except jserve.WaveCrashError as e:
            raise WaveCrashError(str(e)) from None


def run_serve_plan(engine, requests, plan, *, tick_s=1.0, wave_len=8,
                   pipeline=False, **stream_kw):
    """The port's twin of ``tests/chaos.py::run_serve_plan``."""
    ctrl = _PortChaos(plan, tick_s=tick_s)
    stream = ServeStream(engine, wave_len=wave_len, pipeline=pipeline,
                         chaos=ctrl, **stream_kw)
    return stream.run(requests), stream, ctrl


def _check_terminal(eng, results):
    assert all(r is not None for r in results)
    assert all(r.status in STATUSES for r in results)
    assert eng.live == 0
    assert sorted(eng._free_slots) == list(range(eng.slots))
    eng.pool.check_invariants()
    assert eng.pool.free_pages == eng.n_pages - 1


def _check_vs_oracle(cfg, params, reqs, results):
    for req, res in zip(reqs, results):
        if res.status == "shed":
            assert res.emitted == 0
            continue
        want = _oracle_gen(cfg, params, req)
        if res.ok:
            assert np.array_equal(res.generated[:len(want)], want)
        else:
            assert np.array_equal(res.generated, want[:res.emitted])


def test_wave_crash_retry_bitwise_and_status(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=6)
            for p in _prompts(cfg, [4, 7, 5], seed=1)]
    plan = ServeFaultPlan((WaveCrash(wave=1, times=1),), name="crash1")
    eng = _engine(cfg, params)
    results, stream, ctrl = run_serve_plan(eng, reqs, plan, wave_len=3)
    assert ctrl.injected_crashes == 1 and eng.rollbacks == 1
    assert stream.last_report.retries == 1
    assert stream.last_report.status_counts.get("retried_ok", 0) >= 1
    _check_terminal(eng, results)
    _check_vs_oracle(cfg, params, reqs, results)
    assert any(r.status == "retried_ok" and r.retries == 1 for r in results)


def test_wave_crash_repeated_within_budget(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=5)
            for p in _prompts(cfg, [5, 6], seed=2)]
    plan = ServeFaultPlan((WaveCrash(wave=0, times=2),), name="crash2x")
    eng = _engine(cfg, params)
    results, stream, ctrl = run_serve_plan(eng, reqs, plan, wave_len=2,
                                           max_retries=2)
    assert ctrl.injected_crashes == 2 and stream.last_report.retries == 2
    _check_terminal(eng, results)
    _check_vs_oracle(cfg, params, reqs, results)
    assert all(r.status == "retried_ok" and r.retries == 2
               for r in results[:2])


def test_wave_crash_exhausts_retry_budget(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=4) for p in _prompts(cfg, [4], seed=3)]
    plan = ServeFaultPlan((WaveCrash(wave=0, times=5),), name="crash5x")
    with pytest.raises(WaveCrashError):
        run_serve_plan(_engine(cfg, params), reqs, plan, wave_len=2,
                       max_retries=2)


def test_rollback_without_snapshot_raises(gemma):
    cfg, params = gemma
    with pytest.raises(WaveCrashError, match="no snapshot"):
        _engine(cfg, params).rollback()


def test_recovery_path_zero_rebuilds(gemma):
    cfg, params = gemma

    def mk():
        return [Request(prompt=p, max_new=6)
                for p in _prompts(cfg, [4, 7, 5], seed=4)]

    plan = ServeFaultPlan((WaveCrash(wave=1, times=1),
                           SlotPoison(wave=1, slot=0)), name="warm")
    run_serve_plan(_engine(cfg, params), mk(), plan, wave_len=3)
    before = trace_total()
    eng2 = _engine(cfg, params)
    results, stream, _ = run_serve_plan(eng2, mk(), plan, wave_len=3)
    assert trace_total() == before
    assert stream.last_report.traces == 0
    _check_terminal(eng2, results)


def test_slot_poison_quarantines_exactly_one(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=6)
            for p in _prompts(cfg, [4, 7, 5], seed=5)]
    plan = ServeFaultPlan((SlotPoison(wave=1, slot=0),), name="poison")
    eng = _engine(cfg, params)
    results, stream, ctrl = run_serve_plan(eng, reqs, plan, wave_len=2)
    assert ctrl.injected_poisons == 1
    _check_terminal(eng, results)
    _check_vs_oracle(cfg, params, reqs, results)
    statuses = [r.status for r in results]
    assert statuses.count("quarantined") == 1
    assert 0 < results[statuses.index("quarantined")].emitted < 6
    assert stream.last_report.status_counts == {"ok": 2, "quarantined": 1}


def test_slot_poison_on_dead_slot_is_skipped(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=3) for p in _prompts(cfg, [4], seed=6)]
    plan = ServeFaultPlan((SlotPoison(wave=50, slot=1),), name="noop")
    eng = _engine(cfg, params)
    results, _, ctrl = run_serve_plan(eng, reqs, plan, wave_len=4)
    assert ctrl.injected_poisons == 0 and results[0].status == "ok"
    with pytest.raises(ValueError):
        eng.poison_slot(1)


def test_deadline_expires_queued_request(gemma):
    cfg, params = gemma
    ps = _prompts(cfg, [4, 5], seed=7)
    reqs = [Request(prompt=ps[0], max_new=4),
            Request(prompt=ps[1], max_new=4, deadline_s=0.0)]
    eng = _engine(cfg, params)
    results, _, _ = run_serve_plan(eng, reqs, ServeFaultPlan(()))
    assert results[0].status == "ok"
    assert results[1].status == "expired" and results[1].emitted == 0
    _check_terminal(eng, results)


def test_deadline_cancels_mid_flight_keeps_clean_prefix(gemma):
    cfg, params = gemma
    ps = _prompts(cfg, [4, 6], seed=8)
    reqs = [Request(prompt=ps[0], max_new=6),
            Request(prompt=ps[1], max_new=6, deadline_s=1.5)]
    eng = _engine(cfg, params)
    results, _, _ = run_serve_plan(eng, reqs, ServeFaultPlan(()), wave_len=2)
    assert results[0].status == "ok"
    r = results[1]
    assert r.status == "expired" and 0 < r.emitted < 6
    assert np.array_equal(r.generated,
                          _oracle_gen(cfg, params, reqs[1])[:r.emitted])
    _check_terminal(eng, results)


def test_bounded_queue_sheds_with_policy(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=3)
            for p in _prompts(cfg, [4, 5, 6], seed=9)]

    def run(policy):
        eng = _engine(cfg, params)
        res, _, _ = run_serve_plan(eng, reqs, ServeFaultPlan(()),
                                   max_queue=1, shed_policy=policy)
        _check_terminal(eng, res)
        return [r.status for r in res]

    assert run("newest") == ["ok", "shed", "shed"]
    assert run("oldest") == ["shed", "shed", "ok"]
    with pytest.raises(ValueError):
        ServeStream(_engine(cfg, params), shed_policy="random")


def test_wave_timeout_discards_and_replays_bitwise(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=5)
            for p in _prompts(cfg, [5, 6], seed=10)]
    plan = ServeFaultPlan((WaveLatency(wave=1, delay_s=60.0),), name="slow")
    eng = _engine(cfg, params)
    results, stream, _ = run_serve_plan(eng, reqs, plan, wave_len=2,
                                        wave_timeout_s=5.0)
    assert stream.last_report.retries == 1 and eng.rollbacks == 1
    _check_terminal(eng, results)
    _check_vs_oracle(cfg, params, reqs, results)
    assert all(r.status == "retried_ok" for r in results)


def test_combined_fault_storm_with_sampling(gemma):
    """Crash, poison and timeout in one run, with sampled requests: the
    rollback restores the slots' generators, so replayed waves draw the
    same numbers (survivors bitwise the oracle's)."""
    cfg, params = gemma
    ps = _prompts(cfg, [4, 7, 5, 6], seed=11)
    reqs = [Request(prompt=ps[0], max_new=6, temperature=0.7, seed=1),
            Request(prompt=ps[1], max_new=6),
            Request(prompt=ps[2], max_new=6, deadline_s=2.5),
            Request(prompt=ps[3], max_new=6, temperature=1.3, seed=2)]
    plan = ServeFaultPlan((WaveCrash(wave=0, times=1),
                           SlotPoison(wave=1, slot=1),
                           WaveLatency(wave=2, delay_s=60.0)), name="storm")
    eng = _engine(cfg, params)
    results, stream, ctrl = run_serve_plan(eng, reqs, plan, wave_len=2,
                                           wave_timeout_s=5.0, max_retries=3)
    assert ctrl.injected_crashes == 1 and ctrl.injected_poisons == 1
    assert stream.last_report.retries >= 2
    _check_terminal(eng, results)
    _check_vs_oracle(cfg, params, reqs, results)
    assert sum(stream.last_report.status_counts.values()) == len(reqs)


@pytest.mark.parametrize("seed", range(6))
def test_randomized_plans_always_terminal(gemma, seed):
    cfg, params = gemma
    rng = np.random.default_rng(seed)
    slots = int(rng.integers(2, 4))
    n_req = int(rng.integers(2, 6))
    lens = rng.choice([4, 6], size=n_req).tolist()
    deadlines = [None if rng.random() < 0.6
                 else float(rng.choice([0.0, 1.5, 2.5]))
                 for _ in range(n_req)]
    max_queue = None if rng.random() < 0.7 else 2
    events = [WaveCrash(wave=int(w), times=int(rng.integers(1, 3)))
              for w in rng.permutation(4)[:rng.integers(0, 3)]]
    events += [SlotPoison(wave=int(rng.integers(0, 4)),
                          slot=int(rng.integers(0, slots)))
               for _ in range(int(rng.integers(0, 3)))]
    if rng.random() < 0.5:
        events.append(WaveLatency(wave=int(rng.integers(0, 4)),
                                  delay_s=60.0))
    reqs = [Request(prompt=p, max_new=5, deadline_s=d)
            for p, d in zip(_prompts(cfg, lens, seed=1000 + seed),
                            deadlines)]
    eng = _engine(cfg, params, slots=slots, max_new_cap=5)
    results, stream, _ = run_serve_plan(
        eng, reqs, ServeFaultPlan(tuple(events), name=f"prop{seed}"),
        wave_len=2, max_queue=max_queue, wave_timeout_s=5.0, max_retries=4)
    _check_terminal(eng, results)
    _check_vs_oracle(cfg, params, reqs, results)
    assert sum(stream.last_report.status_counts.values()) == n_req


class _TickClock:
    def __init__(self, step=0.25):
        self.t, self.step = 0.0, step

    def __call__(self):
        t, self.t = self.t, self.t + self.step
        return t


def test_serve_legacy_ok_tokens_match_generate(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=p, max_new=4)
            for p in _prompts(cfg, [4, 6, 5], seed=14)]
    reqs.append(Request(prompt=reqs[0].prompt, max_new=4, temperature=0.9,
                        seed=5))
    results = serve_legacy(cfg, params, reqs, device="cpu")
    for i, (req, res) in enumerate(zip(reqs, results)):
        assert res.status == "ok" and res.ok and res.index == i
        want = _oracle_gen(cfg, params, req)
        assert np.array_equal(res.generated[:len(want)], want)


def test_serve_legacy_deadline_and_shed_statuses(gemma):
    cfg, params = gemma
    ps = _prompts(cfg, [4, 5, 6], seed=15)
    reqs = [Request(prompt=ps[0], max_new=6, deadline_s=1.0),
            Request(prompt=ps[1], max_new=4),
            Request(prompt=ps[2], max_new=4)]
    results = serve_legacy(cfg, params, reqs, max_queue=2,
                           clock=_TickClock(step=0.25), device="cpu")
    assert results[2].status == "shed" and results[2].emitted == 0
    r0 = results[0]
    assert r0.status == "expired" and 0 < r0.emitted < 6
    assert np.array_equal(r0.generated,
                          _oracle_gen(cfg, params, reqs[0])[:r0.emitted])
    assert results[1].status == "ok"
    assert all(r.status in STATUSES for r in results)


def test_serve_legacy_deadline_zero_expires_before_start(gemma):
    cfg, params = gemma
    reqs = [Request(prompt=_prompts(cfg, [4], seed=16)[0], max_new=4,
                    deadline_s=0.0)]
    results = serve_legacy(cfg, params, reqs, clock=_TickClock(),
                           device="cpu")
    assert results[0].status == "expired" and results[0].emitted == 0
    with pytest.raises(ValueError):
        serve_legacy(cfg, params, reqs, shed_policy="random", device="cpu")
