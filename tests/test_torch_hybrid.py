"""The port's hybrid family (zamba2: Mamba2 ``ssm`` sublayers and one
``shared_attn`` block whose single parameter set serves every repeat)
against the JAX package, on the CPU: the config, the parameter tree,
``lm.prefill`` / ``lm.decode_step`` and every cache
entry of the reduced ``zamba2_2p7b`` against JAX's XLA lane and against
JAX with its Pallas kernels in interpret mode, the engine's tokens
against ``generate`` and against the JAX engine, a two-tenant stream,
snapshot/rollback of a hybrid cache, training's route around the
kernels, and the serving launcher.

Both packages start from the same parameters (``repro.models.lm.
init_params`` exported through ``repro_torch.weights.params_from_jax``)
and the same numpy inputs. The loss and flat gradient against
``jax.value_and_grad`` and the trainer's synced gradient against the JAX
trainer's are in ``test_torch_train.py``, beside the dense cases.

Tolerances, and why: parameters bitwise (pure data movement); logits 1e-4 (rtol and atol), as ``test_torch_serve.py`` and
``test_torch_ssm.py``: the same f32 math summed in other orders by XLA
and by PyTorch's CPU kernels; cache entries (k/v of each occurrence of
the shared block, SSM state rows) rtol 1e-4 and atol 5e-4
(``CACHE_TOL``): the reduced zamba2 is 12 sublayers deep, and its deepest
state rows carry f32 rounding of up to 4.5 x (1e-4 + 1e-4 |x|) in either
package, measured against an f64 evaluation of the same model (the
port's code with every cast to f32 kept in f64), so two f32 evaluations
differ by more than 1e-4 in a few elements; greedy
tokens exact against JAX (the logits' differences are far below the
reduced model's top-1 margins) and bitwise inside the port (a decode
step runs at one fixed width whatever its row count).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm as jlm
from repro.runtime import serve as jserve
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import CHUNK
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.runtime.serve import (DecodeEngine, Request, ServeStream,
                                       WaveCrashError, generate)
from repro_torch.weights import leaves, params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-4, atol=5e-4)
ARCH = "zamba2_2p7b"


@pytest.fixture(scope="module")
def zamba_pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def zamba(zamba_pair):
    return zamba_pair[2], zamba_pair[3]


# --------------------------------------------------------------------- #
# config, parameters and the flat layout
# --------------------------------------------------------------------- #
def test_zamba2_config_matches_jax():
    """The port's config (full and reduced) field by field against the
    JAX package's (``ssm_chunk`` is an XLA knob the port has none of:
    the chunk is the kernel's constant, 64)."""
    assert ARCH in ARCHS
    for want, got in ((jax_get_config(ARCH), get_config(ARCH)),
                      (jax_reduced(jax_get_config(ARCH)),
                       reduced(get_config(ARCH)))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "hd",
                  "pattern", "rope_theta", "window", "local_window",
                  "attn_softcap", "final_softcap", "mlp_act",
                  "ssm_state", "ssm_heads", "ssm_d_inner", "tie_embeddings",
                  "scale_embed", "dtype", "loss_chunk", "vocab_padded",
                  "microbatches", "grad_sync_dtype",
                  "repeats"):
            assert getattr(got, f) == getattr(want, f), f
        assert want.ssm_chunk == CHUNK
    full = get_config(ARCH)
    assert (full.n_layers, full.repeats, full.d_model, full.hd, full.d_ff,
            full.ssm_d_inner // full.ssm_heads, full.ssm_state,
            full.vocab_padded) == (54, 9, 2560, 80, 10240, 64, 64, 32000)
    assert full.pattern.count("ssm") == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_over_with_one_shared_block(dtype):
    """A JAX zamba2 tree carries over bit for bit, ``shared`` included:
    one parameter set with no ``repeats`` axis and no entry in
    ``blocks``, its leaves last in flat order (sorted keys: after
    ``out``); the port's own ``init_params`` gives the same tree of
    shapes and dtypes. ``ravel`` against ``ravel_pytree`` on this tree is
    ``test_torch_train.py::test_ravel_matches_ravel_pytree``."""
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(dtype=dtype)
    cfg = reduced(get_config(ARCH)).replace(dtype=dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = list(leaves(tp))
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        [p for p, _ in tleaves]
    for (_, jleaf), (_, tleaf) in zip(jleaves, tleaves):
        assert np.array_equal(tleaf.contiguous().view(torch.uint8).numpy(),
                              np.ascontiguousarray(jleaf).view(np.uint8))
    assert set(tp["blocks"]) == {f"{i}_ssm" for i in range(5)}
    assert tp["shared"]["attn"]["wq"].shape == (cfg.d_model,
                                                cfg.n_heads * cfg.hd)
    assert tp["blocks"]["0_ssm"]["norm"].shape == (cfg.repeats, cfg.d_model)
    n_shared = len(list(leaves(tp["shared"])))
    assert [p[0] for p, _ in tleaves[-n_shared:]] == ["shared"] * n_shared
    gen = torch.Generator()
    gen.manual_seed(0)
    own = lm.init_params(cfg, gen)
    assert [(p, tuple(v.shape), v.dtype) for p, v in leaves(own)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in tleaves]


# --------------------------------------------------------------------- #
# the model's serving half against JAX
# --------------------------------------------------------------------- #
def _assert_cache_close(tc, jc, slots=None):
    """Every entry of a hybrid cache (attention k/v[/pages] of each
    occurrence, SSM state rows) within CACHE_TOL of JAX's; ``slots``
    limits the state rows compared, and with it the page pools leave out
    the trash page 0, which the JAX step writes for a finished row and
    the port's does not."""
    for name, ent in tc.items():
        if "state" in ent:
            got, want = ent["state"].numpy(), np.asarray(jc[name]["state"])
            if slots is not None:
                got, want = got[:, slots], want[:, slots]
            np.testing.assert_allclose(got, want, **CACHE_TOL)
            continue
        for key, t in ent["self"].items():
            got, want = t.numpy(), np.asarray(jc[name]["self"][key])
            if slots is not None and key != "pages":
                got, want = got[:, 1:], want[:, 1:]
            np.testing.assert_allclose(got, want, **CACHE_TOL)


def test_prefill_and_decode_logits_match_jax(zamba_pair):
    """Contiguous cache: prefill, then two decode steps, each cache entry
    compared; paged cache: two slots admitted from B=1 prefills (pages
    and state rows), then ragged decode steps with a finished (-1) row
    (the JAX step updates its state, the port's keeps it: tokens are
    unaffected)."""
    jcfg, jp, cfg, p = zamba_pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         max_len=12)
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)},
                        max_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)
    for i, col in ((9, toks[:, :1]), (10, toks[:, 1:2])):
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(col),
                                 jnp.int32(i))
        tl, tc = lm.decode_step(cfg, p, tc, torch.from_numpy(col), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(tc, jc)

    pages = [np.array([1, 2, 3], np.int32), np.array([4, 5, 6], np.int32)]
    jpg = jlm.init_paged_cache(jcfg, 2, 7, 4, 3)
    tpg = lm.init_paged_cache(cfg, 2, 7, 4, 3, device="cpu")
    assert {n: set(e) for n, e in tpg.items()} == {
        n: set(e) for n, e in jpg.items()}
    for s, T in enumerate([5, 7]):
        pr = toks[s:s + 1, :T]
        _, jpc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(pr)},
                             max_len=8)
        _, tpc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(pr)},
                            max_len=8)
        jpg = jlm.admit_prefill(jcfg, jpg, jpc, jnp.asarray(pages[s]),
                                jnp.int32(s))
        lm.admit_prefill(cfg, tpg, tpc, torch.from_numpy(pages[s]), s)
    _assert_cache_close(tpg, jpg)
    for step, ci in enumerate(([5, 7], [6, -1])):
        col = toks[:, step:step + 1]
        jl, jpg = jlm.decode_step(jcfg, jp, jpg, jnp.asarray(col),
                                  jnp.asarray(ci, jnp.int32))
        tl, tpg = lm.decode_step(cfg, p, tpg, torch.from_numpy(col), ci)
        live = [b for b, i in enumerate(ci) if i >= 0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        _assert_cache_close(tpg, jpg, slots=live)


def test_prefill_matches_jax_with_the_pallas_kernels(zamba_pair):
    """The JAX prefill with ``use_pallas=True`` runs both Pallas kernels in
    interpret mode inside the model (``flash_attention`` in the shared
    block, ``ssd_scan`` in the SSM sublayers, a ragged last chunk of 64):
    logits and every cache entry."""
    jcfg, jp, cfg, p = zamba_pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 100)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jcfg.replace(use_pallas=True), jp,
                         {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)


def test_training_routes_around_both_kernels(zamba, monkeypatch):
    """``train_loss`` runs the plain differentiable forms (``ref.
    ssd_chunked`` and the materialized attention) and never calls
    ``ops.ssd_scan`` or ``ops.flash_attention``; a prefill calls each
    once per occurrence of its sublayer kind."""
    cfg, p = zamba
    calls = {"ssd_scan": 0, "flash_attention": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    def refuse(*args, **kw):
        raise AssertionError("a kernel was called in training")

    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    monkeypatch.setattr(ops, "ssd_scan", refuse)
    monkeypatch.setattr(ops, "flash_attention", refuse)
    params = {k: v for k, v in p.items()}
    params["shared"] = {k: ({kk: vv.detach().clone().requires_grad_(True)
                             for kk, vv in v.items()}
                            if isinstance(v, dict)
                            else v.detach().clone().requires_grad_(True))
                        for k, v in p["shared"].items()}
    loss, _ = lm.train_loss(cfg, params, {"tokens": toks, "labels": toks})
    loss.backward()
    g = params["shared"]["attn"]["wq"].grad
    assert torch.isfinite(loss) and g is not None and g.abs().sum() > 0
    monkeypatch.setattr(ops, "ssd_scan", counting("ssd_scan", ref.ssd_chunked))
    monkeypatch.setattr(ops, "flash_attention",
                        counting("flash_attention", ref.flash_attention_ref))
    lm.prefill(cfg, p, {"tokens": toks})
    assert calls == {"ssd_scan": cfg.repeats * 5,
                     "flash_attention": cfg.repeats}


# --------------------------------------------------------------------- #
# serving: engine, streams, snapshots
# --------------------------------------------------------------------- #
def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32) for t in lens]


def _oracle_gen(cfg, params, req):
    res = generate(cfg, params, np.asarray(req.prompt)[None],
                   max_new=req.max_new, eos=req.eos,
                   temperature=req.temperature, seed=req.seed,
                   pad=req.pad, device="cpu")
    return res.tokens[0, len(req.prompt):]


def _rows(entry, rows):
    """A cache entry's batch rows ``rows`` (axis 1), cloned; a paged
    attention entry keeps its whole page pool and takes the rows of its
    page table."""
    if "self" in entry and "pages" in entry["self"]:
        ent = entry["self"]
        return {"self": {"k": ent["k"].clone(), "v": ent["v"].clone(),
                         "pages": ent["pages"][:, rows].clone()}}
    return {k: ({kk: vv[:, rows].clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v[:, rows].clone())
            for k, v in entry.items()}


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_rows_do_not_depend_on_batch(zamba, paged):
    """A row's logits and what it writes (its SSM state rows; its k/v, in
    each occurrence's cache) are bitwise the same in a step of three rows
    and in a step of its own."""
    cfg, p = zamba
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 9)) \
        .astype(np.int32)
    col = torch.from_numpy(toks[:, :1])
    lens = [9, 5, 7] if paged else [9, 9, 9]
    if paged:
        cache = lm.init_paged_cache(cfg, 3, 10, 4, 3, device="cpu")
        for s, T in enumerate(lens):
            _, pc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(
                toks[s:s + 1, :T])}, max_len=12)
            lm.admit_prefill(cfg, cache, pc, torch.tensor(
                [3 * s + 1, 3 * s + 2, 3 * s + 3], dtype=torch.int32), s)
    else:
        singles = [lm.prefill(cfg, p, {"tokens": torch.from_numpy(
            toks[s:s + 1])}, max_len=10)[1] for s in range(3)]
        cache = {n: {"state": torch.cat([c[n]["state"] for c in singles], 1)}
                 if "state" in singles[0][n] else
                 {"self": {k: torch.cat([c[n]["self"][k] for c in singles], 1)
                           for k in ("k", "v")}} for n in singles[0]}
    batch_cache = {n: _rows(e, slice(None)) for n, e in cache.items()}
    batch, _ = lm.decode_step(cfg, p, batch_cache, col,
                              lens if paged else 9)
    for s, T in enumerate(lens):
        one = {n: _rows(e, slice(s, s + 1)) for n, e in cache.items()}
        row, _ = lm.decode_step(cfg, p, one, col[s:s + 1],
                                [T] if paged else T)
        assert torch.equal(batch[s], row[0])
        for n, e in one.items():
            if "state" in e:
                assert torch.equal(batch_cache[n]["state"][:, s],
                                   e["state"][:, 0])
                continue
            for key in ("k", "v"):
                if paged:        # the pool at this slot's pages
                    for r, pg in enumerate(e["self"]["pages"][:, 0].long()):
                        assert torch.equal(batch_cache[n]["self"][key][r, pg],
                                           e["self"][key][r, pg])
                else:
                    assert torch.equal(batch_cache[n]["self"][key][:, s],
                                       e["self"][key][:, 0])


def test_engine_parity_hybrid_arch(zamba):
    cfg, params = zamba
    reqs = [Request(prompt=p, max_new=6)
            for p in _prompts(cfg, [5, 9, 3], seed=5)]
    eng = DecodeEngine(cfg, params, slots=2, page_size=4, max_ctx=16,
                       max_new_cap=6, device="cpu")
    results = ServeStream(eng, wave_len=3).run(reqs)
    for req, res in zip(reqs, results):
        assert res.status == "ok"
        assert np.array_equal(res.generated, _oracle_gen(cfg, params, req))
    eng.pool.check_invariants()
    assert eng.pool.free_pages == eng.n_pages - 1


def test_engine_matches_jax_engine_greedy(zamba_pair):
    """The port's engine and ``generate`` against the JAX package's engine
    on the same parameters and ragged requests (greedy tokens exact)."""
    jcfg, jp, cfg, p = zamba_pair
    prompts = _prompts(cfg, [3, 11, 6, 9, 1], seed=21)
    jeng = jserve.DecodeEngine(jcfg, jp, slots=2, page_size=4, max_ctx=20,
                               max_new_cap=6)
    want = jserve.ServeStream(jeng, wave_len=3).run(
        [jserve.Request(prompt=pr, max_new=6) for pr in prompts])
    eng = DecodeEngine(cfg, p, slots=2, page_size=4, max_ctx=20,
                       max_new_cap=6, device="cpu")
    reqs = [Request(prompt=pr, max_new=6) for pr in prompts]
    got = ServeStream(eng, wave_len=3).run(reqs)
    for g, w, req in zip(got, want, reqs):
        assert g.status == "ok"
        assert np.array_equal(g.generated, np.asarray(w.generated))
        assert np.array_equal(g.generated, _oracle_gen(cfg, p, req))


def test_engine_multi_tenant_stream(zamba):
    """gemma2 and zamba2 share one stream: each request's tokens bitwise
    its own model's ``generate``."""
    gcfg = reduced(get_config("gemma2_2b"))
    jp = jlm.init_params(jax_reduced(jax_get_config("gemma2_2b")),
                         jax.random.PRNGKey(0))
    gparams = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    zcfg, zparams = zamba
    engines = {
        "gemma": DecodeEngine(gcfg, gparams, slots=2, page_size=4,
                              max_ctx=16, max_new_cap=5, name="gemma",
                              device="cpu"),
        "zamba": DecodeEngine(zcfg, zparams, slots=2, page_size=4,
                              max_ctx=16, max_new_cap=5, name="zamba",
                              device="cpu")}
    jobs = [("gemma", Request(prompt=p, max_new=5))
            for p in _prompts(gcfg, [4, 7, 5], seed=10)]
    jobs += [("zamba", Request(prompt=p, max_new=5))
             for p in _prompts(zcfg, [6, 3, 8], seed=11)]
    results = ServeStream(engines, wave_len=3).run(jobs)
    for (name, req), res in zip(jobs, results):
        assert res.model == name and res.status == "ok"
        cfg, params = ((gcfg, gparams) if name == "gemma"
                       else (zcfg, zparams))
        assert np.array_equal(res.generated, _oracle_gen(cfg, params, req))


def test_snapshot_rollback_restores_pages_and_state_bitwise(zamba):
    """A wave writes the shared block's pages (one pool per occurrence)
    and advances the SSM state rows in place; a rollback copies the
    snapshot back, bitwise, and a replayed wave gives the same bits."""
    cfg, params = zamba
    eng = DecodeEngine(cfg, params, slots=2, page_size=4, max_ctx=16,
                       max_new_cap=6, device="cpu")
    for p in _prompts(cfg, [5, 8], seed=13):
        assert eng.admit(Request(prompt=p, max_new=6)) is not None
    eng.run_wave(2)                    # past the first boundary
    cache = eng.st["cache"]
    names = lm.slot_names(cfg)
    assert set(cache[names[0]]) == {"state"}
    assert set(cache[names[5]]["self"]) == {"k", "v", "pages"}

    def snap():
        return [t.clone() for _, t in leaves(cache)]

    before = snap()
    eng.run_wave(3)
    after = snap()
    changed = [not torch.equal(a, b) for a, b in zip(before, after)]
    paths = [p for p, _ in leaves(cache)]
    assert any(c for p, c in zip(paths, changed) if p[-1] == "state")
    assert any(c for p, c in zip(paths, changed) if p[-1] == "k")
    eng.rollback()
    assert all(torch.equal(a, b) for a, b in zip(snap(), before))
    eng.run_wave(3)
    assert all(torch.equal(a, b) for a, b in zip(snap(), after))
    fresh = DecodeEngine(cfg, params, slots=1, page_size=4, max_ctx=8,
                         max_new_cap=2, device="cpu")
    with pytest.raises(WaveCrashError):
        fresh.rollback()


def test_launcher_serves_zamba2(capsys):
    launch_serve.main(["--archs", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "engine: 3 reqs / 12 tokens" in out and "status: ok=3" in out
    launch_serve.main(["--archs", f"{ARCH},gemma2_2b", "--reduced",
                       "--device", "cpu", "--legacy", "--requests", "2",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "legacy: 12 tokens" in out and "status: ok=4" in out
