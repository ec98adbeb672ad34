"""The port's enc-dec family (``seamless_m4t_large_v2``: a bidirectional
encoder over projected audio frames, decoder slots with a cross-
attention to its memory, self and cross k/v caches) against the JAX
package, on the CPU.

Both packages start from the same parameters (``repro.models.lm.
init_params`` exported through ``repro_torch.weights.params_from_jax``)
and the same numpy inputs, at the reduced config (2 encoder and 2
decoder layers, d 64, frames of 24 features). JAX runs its XLA lane
(``use_pallas=False``), as its own tests run it, except in the one case
that puts its Pallas kernel, in interpret mode, on the encoder and the
cross-attention.

Tolerances, and why:

* ``train_loss`` and its flat gradient: loss rtol 1e-5, gradient rtol
  1e-4 / atol 1e-6, the dense tolerances of ``test_torch_train.py`` (the
  same f32 math, summed in other orders);
* f32 prefill and decode logits, and every f32 cache leaf, 1e-4, as
  ``test_torch_serve.py``; prefill->decode consistency 1e-3, as
  ``tests/test_archs_smoke.py``;
* a bf16 model: its f32 cross caches (f32 frames) 1e-5 (the encoder runs
  in f32 on both sides, its bf16 weights widened exactly); its bf16
  logits and self caches within 5% of their largest magnitude, the
  smoke's ``LOGIT_SHARE`` (XLA and PyTorch round bf16 activations at
  other points, and one flipped bit grows through the layers);
* greedy tokens exact against JAX and bitwise inside the port.
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

ARCH = "seamless_m4t_large_v2"
TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16 values' share of their largest magnitude (see the module doc)
BF16_SHARE = 0.05
#: (prompt T, frames Ts): the cross-attention prefill with Tq > Tk (every
#: key visible, so the right alignment does not matter) and with Tq < Tk
SHAPES = [(12, 9), (5, 11)]


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


def _inputs(cfg, B, T, Ts, seed, frames_dtype=np.float32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    frames = rng.standard_normal((B, Ts, cfg.frontend_dim)).astype(
        np.float32).astype(frames_dtype)
    return toks, frames


def _jb(toks, frames):
    return {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _tb(toks, frames):
    return {"tokens": torch.from_numpy(toks),
            "frames": params_from_jax(frames, "cpu")}


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _close(got, want, bf16):
    got = got.float().numpy()
    want = _f32(want)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_SHARE * float(
            np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()


def _assert_cache_close(tc, jc, bf16=False):
    """Every leaf (self and cross k/v of each slot) in JAX's shape and
    dtype, within its tolerance."""
    assert set(tc) == set(jc)
    for name in jc:
        assert set(tc[name]) == set(jc[name]) == {"self", "cross"}
        for kind in ("self", "cross"):
            for key in ("k", "v"):
                got, want = tc[name][kind][key], jc[name][kind][key]
                assert tuple(got.shape) == want.shape, (name, kind, key)
                assert str(got.dtype).split(".")[-1] == want.dtype.name
                if got.dtype == torch.float32 and bf16:
                    np.testing.assert_allclose(got.numpy(), _f32(want),
                                               rtol=1e-5, atol=1e-5)
                else:
                    _close(got, want, bf16 and got.dtype == torch.bfloat16)


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_over_and_ravel(dtype):
    """A JAX enc-dec tree (``enc`` blocks stacked over ``n_enc_layers``
    with no cross-attention, decoder blocks with ``norm_x`` and ``cross``,
    ``front.w``) carries over bit for bit, ``ravel`` is ``ravel_pytree``
    on it, and the port's own ``init_params`` gives the same tree of
    shapes and dtypes."""
    jcfg, jp, cfg, tp = _pair(seed=5, dtype=dtype)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        [p for p, _ in leaves(tp)]
    for (_, jleaf), (_, tleaf) in zip(jleaves, leaves(tp)):
        assert np.array_equal(tleaf.contiguous().view(torch.uint8).numpy(),
                              np.ascontiguousarray(jleaf).view(np.uint8))
    assert set(tp["blocks"]["0_attn"]) == {"norm1", "attn", "norm2", "mlp",
                                           "norm_x", "cross"}
    assert set(tp["enc"]["blocks"]) == {"norm1", "attn", "norm2", "mlp"}
    assert tp["enc"]["blocks"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert tuple(tp["front"]["w"].shape) == (cfg.frontend_dim, cfg.d_model)
    flat, _ = ravel_pytree(jp)
    assert np.array_equal(_torch_bits(ravel(tp)),
                          _torch_bits(torch.from_numpy(np.array(flat))))
    gen = torch.Generator()
    gen.manual_seed(0)
    own = lm.init_params(cfg, gen)
    assert [(p, tuple(v.shape), v.dtype) for p, v in leaves(own)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in leaves(tp)]


# --------------------------------------------------------------------- #
# the loss and its gradient
# --------------------------------------------------------------------- #
def test_loss_and_flat_gradient_match_jax():
    """``train_loss`` (encoder over the frames, decoder units closing
    over its memory) and its gradient w.r.t. the flat parameter vector
    against ``jax.value_and_grad``; the frames are longer than the
    tokens, so the cross-attention has Tq < Tk."""
    jcfg, jp, cfg, tp = _pair(seed=1, vocab=64, loss_chunk=8)
    flat, junravel = ravel_pytree(jp)
    toks, frames = _inputs(cfg, 2, 16, 20, seed=4)
    labels = np.roll(toks, -1, axis=1)
    jb = dict(_jb(toks, frames), labels=jnp.asarray(labels))
    jloss, jgrad = jax.value_and_grad(
        lambda fl: jlm.train_loss(jcfg, junravel(fl), jb)[0])(flat)
    row = ravel(tp).requires_grad_(True)
    before = ops.flash_attention.launches
    loss, m = lm.train_loss(cfg, unravel(row, flat_spec(tp)),
                            dict(_tb(toks, frames),
                                 labels=torch.from_numpy(labels)))
    loss.backward()
    assert ops.flash_attention.launches == before
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(m["moe_aux"]) == 0.0
    np.testing.assert_allclose(row.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------- #
# prefill and decode against JAX
# --------------------------------------------------------------------- #
#: (model dtype, frames dtype): f32; a bf16 model with the f32 frames the
#: JAX launcher gives it (f32 encoder and cross caches beside bf16 self
#: caches); a bf16 model with bf16 frames (all bf16)
LANES = [("float32", np.float32), ("bfloat16", np.float32),
         ("bfloat16", jnp.bfloat16)]
LANE_IDS = ["f32", "bf16_model_f32_frames", "bf16"]


@pytest.fixture(scope="module", params=list(zip(LANES, LANE_IDS)),
                ids=LANE_IDS)
def lane_run(request):
    """One lane's JAX prefill (prompt 12, frames 9) and two decode steps,
    and the port's on the same parameters and inputs."""
    (dtype, fdt), _ = request.param
    jcfg, jp, cfg, tp = _pair(seed=2, dtype=dtype)
    toks, frames = _inputs(cfg, 2, 12, 9, seed=6, frames_dtype=fdt)
    jl, jc = jlm.prefill(jcfg, jp, _jb(toks, frames), max_len=14)
    tl, tc = lm.prefill(cfg, tp, _tb(toks, frames), max_len=14)
    # the port writes its cache in place: each step's is kept as a copy
    out = {"prefill": (tl, jl, _copy(tc), jc), "decode": []}
    for i, col in ((12, toks[:, :1]), (13, toks[:, 1:2])):
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(col),
                                 jnp.int32(i))
        tl, tc = lm.decode_step(cfg, tp, tc, torch.from_numpy(col), i)
        out["decode"].append((tl, jl, _copy(tc), jc))
    out["bf16"] = dtype == "bfloat16"
    return out


def test_prefill_logits_and_caches_match_jax(lane_run):
    """The prefill's logits and every cache leaf, values and dtypes: the
    cross caches in the frames' dtype, the self caches in the model's."""
    tl, jl, tc, jc = lane_run["prefill"]
    _close(tl, jl, lane_run["bf16"])
    _assert_cache_close(tc, jc, lane_run["bf16"])


def test_decode_logits_match_jax(lane_run):
    """Two decode steps over the self cache and the cross cache (read as
    it is, never written)."""
    for tl, jl, tc, jc in lane_run["decode"]:
        _close(tl, jl, lane_run["bf16"])
        _assert_cache_close(tc, jc, lane_run["bf16"])


@pytest.mark.parametrize("T,Ts", SHAPES, ids=["tq_gt_tk", "tq_lt_tk"])
def test_prefill_matches_jax_with_the_pallas_kernel(pair, T, Ts):
    """The JAX prefill with ``use_pallas=True`` runs the Pallas
    ``flash_attention`` in interpret mode on the encoder (non-causal, Tq
    = Tk), the decoder's self-attention and its cross-attention
    (non-causal, Tq > Tk and Tq < Tk); the port's prefill on the CPU
    takes the kernel's plain version at the same calls."""
    jcfg, jp, cfg, p = pair
    toks, frames = _inputs(cfg, 1, T, Ts, seed=T)
    jl, jc = jlm.prefill(jcfg.replace(use_pallas=True), jp,
                         _jb(toks, frames))
    tl, tc = lm.prefill(cfg, p, _tb(toks, frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)


def test_prefill_and_decode_call_the_kernel_wrapper(pair, monkeypatch):
    """The kernel's routing: a prefill calls ``flash_attention`` (the
    kernel on a card) once per encoder layer, once per decoder self-
    attention and once per cross-attention, at the shapes of each; a
    decode step once per cross-attention (Tq = 1 over the cross cache,
    the batch's real rows only); training never."""
    _, _, cfg, p = pair
    calls = []
    inner = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"],
                      q.dtype, k.dtype))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks, frames = _inputs(cfg, 3, 12, 9, seed=8)
    _, cache = lm.prefill(cfg, p, _tb(toks, frames), max_len=13)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    enc = ((3, H, 9, D), (3, Hkv, 9, D), False)
    dec = ((3, H, 12, D), (3, Hkv, 12, D), True)
    cross = ((3, H, 12, D), (3, Hkv, 9, D), False)
    assert [c[:3] for c in calls] == [enc] * cfg.n_enc_layers + \
        [dec, cross] * cfg.n_layers
    calls.clear()
    lm.decode_step(cfg, p, cache, torch.from_numpy(toks[:, :1]), 12)
    assert [c[:3] for c in calls] == [
        ((3, H, 1, D), (3, Hkv, 9, D), False)] * cfg.n_layers
    calls.clear()
    lm.train_loss(cfg, p, dict(_tb(toks, frames),
                               labels=torch.from_numpy(toks)))
    assert calls == []


def test_prefill_decode_consistency(pair):
    """``tests/test_archs_smoke.py``'s check in the port: decode_step(T)
    after prefill(:T) gives prefill(:T+1)'s last logits, the frames the
    same."""
    _, _, cfg, params = pair
    T = 32
    toks, frames = _inputs(cfg, 2, T + 1, T + 1, seed=3)
    lg_full, _ = lm.prefill(cfg, params, _tb(toks, frames))
    _, cache = lm.prefill(cfg, params, _tb(toks[:, :T], frames),
                          max_len=T + 1)
    lg_dec, _ = lm.decode_step(cfg, params, cache,
                               torch.from_numpy(toks[:, T:]), T)
    np.testing.assert_allclose(lg_full.numpy(), lg_dec.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_decode_step_rows_do_not_depend_on_batch(pair):
    """A row's logits and the k/v it writes are bitwise the same in a step
    of three rows and in a step of its own: the step's products run at
    the fixed width, and the cross-attention over the real rows of its
    cross cache."""
    _, _, cfg, p = pair
    toks, frames = _inputs(cfg, 3, 9, 7, seed=3)
    singles = [lm.prefill(cfg, p, _tb(toks[s:s + 1], frames[s:s + 1]),
                          max_len=10)[1] for s in range(3)]
    cache = {n: {kind: {k: torch.cat([c[n][kind][k] for c in singles], 1)
                        for k in ("k", "v")} for kind in ("self", "cross")}
             for n in singles[0]}
    col = torch.from_numpy(toks[:, :1])
    batch, _ = lm.decode_step(cfg, p, cache, col, 9)
    for s in range(3):
        row, _ = lm.decode_step(cfg, p, singles[s], col[s:s + 1], 9)
        assert torch.equal(batch[s], row[0])
        for n in cache:
            for key in ("k", "v"):
                assert torch.equal(cache[n]["self"][key][:, s],
                                   singles[s][n]["self"][key][:, 0])


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_greedy(pair):
    """JAX's greedy tokens: ``generate`` per prompt over one shared
    ``[1, 9, 24]`` frames array (prompts 4, 12 and 7 tokens: the cross
    prefill at Tq < Tk and Tq > Tk)."""
    jcfg, jp, cfg, _ = pair
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
               for t in (4, 12, 7)]
    frames = rng.standard_normal((1, 9, cfg.frontend_dim)).astype(np.float32)
    want = [np.asarray(jserve.generate(jcfg, jp, pr[None], max_new=6,
                                       extras={"frames": frames})
                       .tokens[0, len(pr):]) for pr in prompts]
    return prompts, frames, want


def test_generate_and_serve_legacy_tokens_match_jax(pair, jax_greedy):
    """``generate`` and ``serve_legacy`` (frames as ``extras``) give JAX's
    greedy tokens; a 2-row ``generate`` with ``[2, ...]`` frames gives
    each row its own ``B=1`` tokens."""
    _, _, cfg, p = pair
    prompts, frames, want = jax_greedy
    ex = {"frames": frames}
    for pr, w in zip(prompts, want):
        got = generate(cfg, p, pr[None], max_new=6, extras=ex, device="cpu")
        assert np.array_equal(got.tokens[0, len(pr):], w)
    res = serve_legacy(cfg, p, [Request(prompt=pr, max_new=6)
                                for pr in prompts], extras=ex, device="cpu")
    for r, w in zip(res, want):
        assert r.status == "ok" and np.array_equal(r.generated, w)
    other = np.random.default_rng(5).standard_normal(frames.shape).astype(
        np.float32)
    two = generate(cfg, p, np.stack([prompts[0], prompts[0]]), max_new=6,
                   extras={"frames": np.concatenate([frames, other])},
                   device="cpu")
    assert np.array_equal(two.tokens[0, 4:], want[0])
    one = generate(cfg, p, prompts[0][None], max_new=6,
                   extras={"frames": other}, device="cpu")
    assert np.array_equal(two.tokens[1], one.tokens[0])


def test_serve_legacy_shed_and_expired_with_extras(pair):
    """The legacy path's statuses with frames: the newest request past
    ``max_queue`` shed, a deadline expiring mid-request keeping its clean
    prefix (the ``generate`` oracle's first tokens)."""
    _, _, cfg, p = pair
    rng = np.random.default_rng(15)
    ps = [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
          for t in (4, 5, 6)]
    ex = {"frames": rng.standard_normal((1, 6, cfg.frontend_dim)).astype(
        np.float32)}
    reqs = [Request(prompt=ps[0], max_new=6, deadline_s=1.0),
            Request(prompt=ps[1], max_new=4),
            Request(prompt=ps[2], max_new=4)]
    res = serve_legacy(cfg, p, reqs, max_queue=2, extras=ex,
                       clock=_TickClock(step=0.25), device="cpu")
    assert [r.status for r in res] == ["expired", "ok", "shed"]
    assert all(r.status in STATUSES for r in res)
    r0 = res[0]
    assert 0 < r0.emitted < 6 and res[2].emitted == 0
    want = generate(cfg, p, ps[0][None], max_new=6, extras=ex,
                    device="cpu").tokens[0, 4:]
    assert np.array_equal(r0.generated, want[:r0.emitted])


def test_launchers_serve_legacy_and_refuse_the_rest(capsys):
    """``launch/serve.py --legacy`` serves the reduced model on the CPU
    (f32 frames of ``--prompt-len``, as the JAX launcher draws them);
    the engine path and the trainer refuse it."""
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
