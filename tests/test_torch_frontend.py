"""The port's ViT frontend (``internvl2_26b``: projected patches in place
of the first ``frontend_len`` token embeddings of an InternLM2 decoder)
against the JAX package, on the CPU.

Both packages start from the same parameters (``repro.models.lm.
init_params`` exported through ``repro_torch.weights.params_from_jax``)
and the same numpy inputs, at the reduced config (2 layers, d 64, 8
patches of 24 features). JAX runs its XLA lane (``use_pallas=False``),
as its own tests run it.

Tolerances, and why: the loss rtol 1e-5 and its flat gradient rtol 1e-4
/ atol 1e-6 (``test_torch_train.py``'s dense tolerances); f32 logits and
caches 1e-4, as ``test_torch_serve.py``; prefill->decode consistency
1e-3, as ``tests/test_archs_smoke.py``; a bf16 model (with the f32
patches the JAX launcher gives it) within 5% of each value's largest
magnitude, the smoke's ``LOGIT_SHARE``; greedy tokens exact against JAX
and bitwise inside the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm as jlm
from repro.runtime import serve as jserve
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.runtime.serve import (STATUSES, Request, generate,
                                       serve_legacy)
from repro_torch.weights import (flat_spec, leaves, params_from_jax, ravel,
                                 unravel)

from test_torch_serve import _TickClock
from test_torch_train import _torch_bits

ARCH = "internvl2_26b"
TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16 values' share of their largest magnitude (see the module doc)
BF16_SHARE = 0.05


def _pair(seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) from one init."""
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(**kw)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    # the port at remat none (tests/test_torch_remat.py holds the default
    # "block" bitwise to it)
    cfg = reduced(get_config(ARCH)).replace(**{"remat": "none", **kw})
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    patches = rng.standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return toks, patches


def _jb(toks, patches):
    return {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}


def _tb(toks, patches):
    return {"tokens": torch.from_numpy(toks),
            "patches": torch.from_numpy(patches)}


def _close(got, want, bf16):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_SHARE * float(
            np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_over_and_ravel(dtype):
    """A JAX ViT tree (``front.w`` beside the decoder) carries over bit
    for bit, ``ravel`` is ``ravel_pytree`` on it, and the port's own
    ``init_params`` gives the same tree of shapes and dtypes."""
    _, jp, cfg, tp = _pair(seed=5, dtype=dtype)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        [p for p, _ in leaves(tp)]
    for (_, jleaf), (_, tleaf) in zip(jleaves, leaves(tp)):
        assert np.array_equal(tleaf.contiguous().view(torch.uint8).numpy(),
                              np.ascontiguousarray(jleaf).view(np.uint8))
    assert tuple(tp["front"]["w"].shape) == (cfg.frontend_dim, cfg.d_model)
    assert tp["front"]["w"].dtype == cfg.torch_dtype and "enc" not in tp
    flat, _ = ravel_pytree(jp)
    assert np.array_equal(_torch_bits(ravel(tp)),
                          _torch_bits(torch.from_numpy(np.array(flat))))
    gen = torch.Generator()
    gen.manual_seed(0)
    own = lm.init_params(cfg, gen)
    assert [(p, tuple(v.shape), v.dtype) for p, v in leaves(own)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in leaves(tp)]


def test_loss_and_flat_gradient_match_jax():
    """``train_loss`` with the patch prefix, and its gradient w.r.t. the
    flat parameter vector (``front.w`` included) against
    ``jax.value_and_grad``."""
    jcfg, jp, cfg, tp = _pair(seed=1, vocab=64, loss_chunk=8)
    flat, junravel = ravel_pytree(jp)
    toks, patches = _inputs(cfg, 2, 16, seed=4)
    labels = np.roll(toks, -1, axis=1)
    jloss, jgrad = jax.value_and_grad(
        lambda fl: jlm.train_loss(jcfg, junravel(fl), dict(
            _jb(toks, patches), labels=jnp.asarray(labels)))[0])(flat)
    row = ravel(tp).requires_grad_(True)
    loss, _ = lm.train_loss(cfg, unravel(row, flat_spec(tp)),
                            dict(_tb(toks, patches),
                                 labels=torch.from_numpy(labels)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(row.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)
    spec = flat_spec(tp)
    i = spec.paths.index(("front", "w"))
    assert np.abs(row.grad.numpy()[spec.offsets[i]:spec.offsets[i] + int(
        np.prod(spec.shapes[i]))]).max() > 0


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lane_run(request):
    """JAX's prefill (prompt 12, 8 of its positions patches, f32 patches)
    and two decode steps, and the port's on the same parameters."""
    dtype = request.param
    jcfg, jp, cfg, tp = _pair(seed=2, dtype=dtype)
    toks, patches = _inputs(cfg, 2, 12, seed=6)
    jl, jc = jlm.prefill(jcfg, jp, _jb(toks, patches), max_len=14)
    tl, tc = lm.prefill(cfg, tp, _tb(toks, patches), max_len=14)
    # the port writes its cache in place: each step's is kept as a copy
    out = {"bf16": dtype == "bfloat16", "steps": [
        (tl, jl, {n: {k: v.clone() for k, v in e["self"].items()}
                  for n, e in tc.items()}, jc)]}
    for i, col in ((12, toks[:, :1]), (13, toks[:, 1:2])):
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(col),
                                 jnp.int32(i))
        tl, tc = lm.decode_step(cfg, tp, tc, torch.from_numpy(col), i)
        out["steps"].append((tl, jl, {n: {k: v.clone() for k, v in
                                          e["self"].items()}
                                      for n, e in tc.items()}, jc))
    return out


def test_prefill_and_decode_match_jax(lane_run):
    """The prefill's logits and self caches (in the model's dtype), then
    two decode steps', which read no patches: the prefix is the
    prompt's only."""
    for tl, jl, tc, jc in lane_run["steps"]:
        _close(tl, jl, lane_run["bf16"])
        for name in jc:
            for key in ("k", "v"):
                want = jc[name]["self"][key]
                assert str(tc[name][key].dtype).split(".")[-1] == \
                    want.dtype.name
                _close(tc[name][key], want, lane_run["bf16"])


def test_prefill_and_decode_call_the_kernel_wrapper(pair, monkeypatch):
    """A prefill calls ``flash_attention`` (the kernel on a card) once per
    layer over the whole prompt, patches included; a decode step
    never."""
    _, _, cfg, p = pair
    calls = []
    inner = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks, patches = _inputs(cfg, 1, 11, seed=8)
    _, cache = lm.prefill(cfg, p, _tb(toks, patches), max_len=12)
    assert calls == [(1, cfg.n_heads, 11, cfg.hd)] * cfg.n_layers
    lm.decode_step(cfg, p, cache, torch.from_numpy(toks[:, :1]), 11)
    assert len(calls) == cfg.n_layers


def test_patches_replace_the_first_positions(pair):
    """The prefix: only the prompt's tokens past ``frontend_len`` reach
    the model, so two prompts that differ in their first 8 tokens give
    the same logits; other patches give others."""
    _, _, cfg, p = pair
    toks, patches = _inputs(cfg, 1, 12, seed=9)
    other = toks.copy()
    other[:, :cfg.frontend_len] = (other[:, :cfg.frontend_len] + 1) % 256
    a, _ = lm.prefill(cfg, p, _tb(toks, patches))
    b, _ = lm.prefill(cfg, p, _tb(other, patches))
    c, _ = lm.prefill(cfg, p, _tb(toks, patches[:, ::-1].copy()))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_short_prompt_is_refused(pair):
    """A prompt shorter than its patches: JAX's ``_embed`` returns the
    ``frontend_len`` patch positions and drops the prompt's tokens
    (pinned here); the port raises ``ValueError``."""
    jcfg, jp, cfg, p = pair
    toks, patches = _inputs(cfg, 1, 5, seed=10)
    x = jlm._embed(jcfg, jp, _jb(toks, patches))
    assert x.shape[1] == cfg.frontend_len > toks.shape[1]
    with pytest.raises(ValueError, match="shorter than its 8 patch"):
        lm.prefill(cfg, p, _tb(toks, patches))


def test_prefill_decode_consistency(pair):
    """``tests/test_archs_smoke.py``'s check in the port: decode_step(T)
    after prefill(:T) gives prefill(:T+1)'s last logits."""
    _, _, cfg, params = pair
    T = 32
    toks, patches = _inputs(cfg, 2, T + 1, seed=3)
    lg_full, _ = lm.prefill(cfg, params, _tb(toks, patches))
    _, cache = lm.prefill(cfg, params, _tb(toks[:, :T], patches),
                          max_len=T + 1)
    lg_dec, _ = lm.decode_step(cfg, params, cache,
                               torch.from_numpy(toks[:, T:]), T)
    np.testing.assert_allclose(lg_full.numpy(), lg_dec.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_decode_step_rows_do_not_depend_on_batch(pair):
    """A row's logits are bitwise the same in a step of three rows (each
    prefilled with its own patches) and in a step of its own."""
    _, _, cfg, p = pair
    toks, patches = _inputs(cfg, 3, 10, seed=3)
    singles = [lm.prefill(cfg, p, _tb(toks[s:s + 1], patches[s:s + 1]),
                          max_len=11)[1] for s in range(3)]
    cache = {n: {"self": {k: torch.cat([c[n]["self"][k] for c in singles], 1)
                          for k in ("k", "v")}} for n in singles[0]}
    col = torch.from_numpy(toks[:, :1])
    batch, _ = lm.decode_step(cfg, p, cache, col, 10)
    for s in range(3):
        row, _ = lm.decode_step(cfg, p, singles[s], col[s:s + 1], 10)
        assert torch.equal(batch[s], row[0])


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """JAX's greedy tokens: ``generate`` per prompt (8, 12 and 9 tokens)
    over one shared ``[1, 8, 24]`` patches array."""
    jcfg, jp, cfg, _ = pair
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
               for t in (8, 12, 9)]
    patches = rng.standard_normal(
        (1, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    want = [np.asarray(jserve.generate(jcfg, jp, pr[None], max_new=6,
                                       extras={"patches": patches})
                       .tokens[0, len(pr):]) for pr in prompts]
    return prompts, patches, want


def test_generate_and_serve_legacy_tokens_match_jax(pair, jax_greedy):
    """``generate`` and ``serve_legacy`` (patches as ``extras``) give
    JAX's greedy tokens; a 2-row ``generate`` with ``[2, ...]`` patches
    gives each row its own ``B=1`` tokens."""
    _, _, cfg, p = pair
    prompts, patches, want = jax_greedy
    ex = {"patches": patches}
    for pr, w in zip(prompts, want):
        got = generate(cfg, p, pr[None], max_new=6, extras=ex, device="cpu")
        assert np.array_equal(got.tokens[0, len(pr):], w)
    res = serve_legacy(cfg, p, [Request(prompt=pr, max_new=6)
                                for pr in prompts], extras=ex, device="cpu")
    for r, w in zip(res, want):
        assert r.status == "ok" and np.array_equal(r.generated, w)
    other = patches[:, ::-1].copy()
    two = generate(cfg, p, np.stack([prompts[1], prompts[1]]), max_new=6,
                   extras={"patches": np.concatenate([patches, other])},
                   device="cpu")
    assert np.array_equal(two.tokens[0, 12:], want[1])
    one = generate(cfg, p, prompts[1][None], max_new=6,
                   extras={"patches": other}, device="cpu")
    assert np.array_equal(two.tokens[1], one.tokens[0])


def test_serve_legacy_shed_and_expired_with_extras(pair):
    """The legacy path's statuses with patches: the oldest request past
    ``max_queue`` shed, a deadline expiring mid-request keeping its clean
    prefix."""
    _, _, cfg, p = pair
    rng = np.random.default_rng(15)
    ps = [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
          for t in (9, 10, 11)]
    ex = {"patches": rng.standard_normal(
        (1, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}
    reqs = [Request(prompt=ps[0], max_new=4),
            Request(prompt=ps[1], max_new=6, deadline_s=1.0),
            Request(prompt=ps[2], max_new=4)]
    res = serve_legacy(cfg, p, reqs, max_queue=2, shed_policy="oldest",
                       extras=ex, clock=_TickClock(step=0.25), device="cpu")
    assert [r.status for r in res] == ["shed", "expired", "ok"]
    assert all(r.status in STATUSES for r in res)
    r1 = res[1]
    assert 0 < r1.emitted < 6 and res[0].emitted == 0
    want = generate(cfg, p, ps[1][None], max_new=6, extras=ex,
                    device="cpu").tokens[0, 10:]
    assert np.array_equal(r1.generated, want[:r1.emitted])


def test_launchers_serve_legacy_and_refuse_the_rest(capsys):
    """``launch/serve.py --legacy`` serves the reduced model on the CPU
    (f32 patches, prompts of at least ``frontend_len`` tokens); the
    engine path and the trainer refuse it."""
    launch_serve.main(["--archs", ARCH, "--reduced", "--device", "cpu",
                       "--legacy", "--requests", "3", "--max-new", "4",
                       "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert f"{ARCH}: 3 reqs (legacy host loop) 12 tokens" in out
    assert "status: ok=3" in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--archs", ARCH, "--reduced", "--device", "cpu"])
    assert "need --legacy" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="served only"):
        launch_train.main(["--arch", ARCH, "--reduced", "--multi-model",
                           "--grad-sync", "camr_spmd", "--steps", "1",
                           "--device", "cpu"])
