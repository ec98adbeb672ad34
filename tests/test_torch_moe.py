"""The port's MoE family (``mixtral_8x7b``, ``moonshot_v1_16b_a3b``) and
the two dense configs added with it (``internlm2_20b``,
``mistral_large_123b``) against the JAX package, on the CPU.

Both packages start from the same parameters (``repro.models.lm.
init_params`` exported through ``repro_torch.weights.params_from_jax``)
and the same numpy inputs, at the reduced configs (4 experts, top-2,
capacity 8.0: no drop) unless a case sets ``moe_capacity_factor`` 1.0 to
make assignments drop.

Tolerances, and why:

* the dispatch (``layers._moe_dispatch_compute``): experts, slots and the
  kept mask exact (integer work on the same top-k order); ``out``,
  ``me`` and ``ce`` 1e-5 (the same f32 products summed in other orders);
* ``train_loss`` and its flat gradient: loss rtol 1e-5, gradient rtol
  1e-4 / atol 1e-6, as ``test_torch_train.py``;
* ``prefill`` / ``decode_step`` logits 1e-4, as ``test_torch_serve.py``;
  prefill->decode consistency 1e-3, as ``tests/test_archs_smoke.py``;
* greedy tokens exact against JAX and bitwise inside the port (a decode
  step runs at one fixed width, its expert products at one shape);
* the trainer: parameters and losses bitwise across the three wires,
  and the synced gradient bitwise the JAX trainer's given its
  per-subfile gradients (``test_torch_train.py``);
* the virtual-mesh lanes against the no-mesh lane: loss 2e-4,
  gradients 2e-2, decode logits 2e-3, the tolerances of
  ``tests/test_moe_shardmap.py``; against JAX's ``shard_map`` lane on a
  (4, 2) mesh of host devices (one subprocess): loss rtol 1e-5, aux
  1e-5, gradients rtol 1e-4 / atol 1e-6 (the same f32 math, with the
  same drops at capacity 1.25).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import ShardedTokenPipeline
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.runtime import serve as jserve
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, lm
from repro_torch.runtime import MultiModelCAMRTrainer
from repro_torch.runtime.serve import (DecodeEngine, Request, ServeStream,
                                       generate)
from repro_torch.weights import (flat_spec, leaves, params_from_jax, ravel,
                                 unravel)

from chip_smoke_module import chip_smoke
from test_torch_train import (TINY, _check_synced_gradient, _record_jax_run,
                              _torch_bits)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = ["moonshot_v1_16b_a3b", "mixtral_8x7b"]
DENSE = ["internlm2_20b", "mistral_large_123b"]
TOL = dict(rtol=1e-4, atol=1e-4)
#: the fields a config shares with the JAX package's (``microbatches``
#: and ``grad_sync_dtype`` set what the train step computes)
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab", "head_dim", "hd", "pattern", "rope_theta",
          "window", "local_window", "attn_softcap", "final_softcap",
          "mlp_act", "tie_embeddings", "scale_embed", "n_experts",
          "experts_per_token", "moe_capacity_factor", "moe_shard_mode",
          "n_enc_layers", "frontend", "frontend_dim", "frontend_len",
          "dtype", "loss_chunk", "vocab_padded", "repeats", "microbatches",
          "grad_sync_dtype")


def _pair(arch, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) from one init."""
    jcfg = jax_reduced(jax_get_config(arch)).replace(**kw)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    # the port at remat none, as tests/test_torch_train.py's _cfgs
    cfg = reduced(get_config(arch)).replace(**{"remat": "none", **kw})
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module", params=MOE)
def moe_pair(request):
    return _pair(request.param)


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


# --------------------------------------------------------------------- #
# configs and parameters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE + DENSE)
def test_config_matches_jax(arch):
    """Full and reduced configs field by field against the JAX
    package's."""
    assert arch in ARCHS
    for want, got in ((jax_get_config(arch), get_config(arch)),
                      (jax_reduced(jax_get_config(arch)),
                       reduced(get_config(arch)))):
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "internvl2_26b"])
def test_encdec_and_frontend_configs_match_jax(arch):
    """``get_config`` serves the enc-dec and ViT configs: full and
    reduced (2 encoder layers, frontend 24 x 8) field by field against
    the JAX package's; an unknown name is refused."""
    for want, got in ((jax_get_config(arch), get_config(arch)),
                      (jax_reduced(jax_get_config(arch)),
                       reduced(get_config(arch)))):
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), f
    small = reduced(get_config(arch))
    assert (small.n_enc_layers, small.frontend_dim, small.frontend_len) == \
        ((2 if small.family == "encdec" else 0), 24, 8)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config(arch + "_x")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_carry_over_and_ravel(arch, dtype):
    """A JAX MoE tree (stacked expert leaves ``[R, E, d, f]``) carries
    over bit for bit, ``ravel`` is ``ravel_pytree`` on it, and the
    port's own ``init_params`` gives the same tree of shapes and
    dtypes."""
    jcfg, jp, cfg, tp = _pair(arch, seed=5, dtype=dtype)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        [p for p, _ in leaves(tp)]
    for (_, jleaf), (_, tleaf) in zip(jleaves, leaves(tp)):
        assert np.array_equal(tleaf.contiguous().view(torch.uint8).numpy(),
                              np.ascontiguousarray(jleaf).view(np.uint8))
    moe = tp["blocks"]["0_attn"]["moe"]
    R, E, d, f = cfg.repeats, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (R, d, E), "w_gate": (R, E, d, f), "w_up": (R, E, d, f),
        "w_down": (R, E, f, d)}
    assert "mlp" not in tp["blocks"]["0_attn"]
    flat, _ = ravel_pytree(jp)
    assert np.array_equal(_torch_bits(ravel(tp)),
                          _torch_bits(torch.from_numpy(np.array(flat))))
    gen = torch.Generator()
    gen.manual_seed(0)
    own = lm.init_params(cfg, gen)
    assert [(p, tuple(v.shape), v.dtype) for p, v in leaves(own)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in leaves(tp)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_scales_in_place_bitwise(dtype):
    """``lm._normal`` scales the draw in place: bitwise ``randn *
    scale`` from the same generator state, with no second copy."""
    gen = torch.Generator()
    gen.manual_seed(7)
    want = torch.randn((3, 5, 7), generator=gen, dtype=dtype) * 64 ** -0.5
    gen.manual_seed(7)
    got = lm._normal(gen, (3, 5, 7), dtype, 64 ** -0.5)
    assert got.dtype == dtype and torch.equal(got.view(torch.uint8),
                                              want.view(torch.uint8))


# --------------------------------------------------------------------- #
# the dispatch against JAX's
# --------------------------------------------------------------------- #
def _jax_route(p, xf, cfg):
    """``repro.models.layers._moe_dispatch_compute``'s routing, step for
    step: top-k experts, slots and the kept mask."""
    N = xf.shape[0]
    E, topk = cfg.n_experts, cfg.experts_per_token
    gates = jax.nn.softmax(
        jlayers.dense(xf, p["router"]).astype(jnp.float32), axis=-1)
    _, idx = lax.top_k(gates, topk)
    cap = max(int(cfg.moe_capacity_factor * N * topk / E), 4)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(N * topk, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


def _layer_moe(jp):
    """Layer 0's MoE parameters of a JAX tree, in both packages."""
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["0_attn"]["moe"])
    return jm, params_from_jax(jax.tree.map(np.asarray, jm), "cpu")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf,N", [(8.0, 16), (1.0, 9)],
                         ids=["no_drop", "drops"])
def test_dispatch_matches_jax(arch, cf, N):
    """``_moe_dispatch_compute`` on the same ``xf`` and parameters as
    JAX's: the same experts, slots and kept set (at capacity 1.0 some
    assignments drop), ``out``, ``me`` and ``ce`` within 1e-5."""
    jcfg, jp, cfg, _ = _pair(arch, moe_capacity_factor=cf)
    jm, tm = _layer_moe(jp)
    xf = np.random.default_rng(N).standard_normal(
        (N, cfg.d_model)).astype(np.float32)
    jo, (jme, jce) = jlayers._moe_dispatch_compute(jm, jnp.asarray(xf), jcfg)
    to, (tme, tce) = layers._moe_dispatch_compute(tm, torch.from_numpy(xf),
                                                  cfg)
    idx, pos, keep = _jax_route(jm, jnp.asarray(xf), jcfg)
    _, _, tidx, eidx, tpos, tkeep = layers._moe_route(
        tm, torch.from_numpy(xf), cfg, N)
    assert np.array_equal(tidx.numpy(), idx)
    assert np.array_equal(eidx.numpy(), idx.reshape(-1))
    assert np.array_equal(tpos.numpy(), pos)
    assert np.array_equal(tkeep.numpy(), keep)
    assert keep.all() == (cf == 8.0)
    for got, want in ((to, jo), (tme, jme), (tce, jce)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("tied", ["columns", "bf16_rounding"])
def test_bf16_gate_ties_take_lax_top_k_order(tied):
    """Equal gates go to the lower expert index first, as ``lax.top_k``
    orders them: router columns duplicated in pairs (every row ties at
    the top-k boundary), and 64 experts of bf16-rounded logits (ties from
    rounding): the experts, slots and kept set are JAX's; ``out`` within
    5% of its largest element (XLA rounds ``silu`` and the products'
    bf16 activations at other points than PyTorch's CPU kernels)."""
    kw = dict(dtype="bfloat16", moe_capacity_factor=1.0)
    if tied == "bf16_rounding":
        kw.update(n_experts=64, experts_per_token=6)
    jcfg, jp, cfg, _ = _pair("moonshot_v1_16b_a3b", seed=3, **kw)
    jm, tm = _layer_moe(jp)
    if tied == "columns":
        k = cfg.experts_per_token + 1            # ties straddle the top-k
        cfg, jcfg = (c.replace(experts_per_token=k) for c in (cfg, jcfg))
        r = np.asarray(jm["router"]).copy()
        r[:, 1::2] = r[:, 0::2]
        jm = dict(jm, router=jnp.asarray(r))
        tm = dict(tm, router=params_from_jax(r, "cpu"))
    xf = jnp.asarray(np.random.default_rng(11).standard_normal(
        (64, cfg.d_model)), jnp.bfloat16)
    txf = params_from_jax(np.asarray(xf), "cpu")
    idx, pos, keep = _jax_route(jm, xf, jcfg)
    gates, _, tidx, _, tpos, tkeep = layers._moe_route(tm, txf, cfg, 64)
    g = np.sort(gates.numpy(), axis=-1)[:, ::-1]
    ties = (g[:, :cfg.experts_per_token + 1][:, 1:]
            == g[:, :cfg.experts_per_token + 1][:, :-1]).any(axis=1)
    assert ties.sum() >= (64 if tied == "columns" else 5), ties.sum()
    assert np.array_equal(tidx.numpy(), idx)
    assert np.array_equal(tpos.numpy(), pos)
    assert np.array_equal(tkeep.numpy(), keep) and not keep.all()
    jo, _ = jlayers._moe_dispatch_compute(jm, xf, jcfg)
    to, _ = layers._moe_dispatch_compute(tm, txf, cfg)
    want = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), want, rtol=0,
                               atol=0.05 * float(np.abs(want).max()))


# --------------------------------------------------------------------- #
# the loss and its gradient
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["no_drop", "drops"])
def test_loss_aux_and_flat_gradient_match_jax(arch, cf):
    """``train_loss`` (its ``0.01 * aux / n_layers`` term included),
    ``moe_aux`` and the gradient w.r.t. the flat parameter vector against
    ``jax.value_and_grad``."""
    jcfg, jp, cfg, tp = _pair(arch, seed=1, moe_capacity_factor=cf,
                              vocab=64, loss_chunk=8)
    flat, junravel = ravel_pytree(jp)
    batch = ShardedTokenPipeline(vocab=64, seq_len=16,
                                 global_batch=2).batch(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrad = jax.value_and_grad(
        lambda fl: jlm.train_loss(jcfg, junravel(fl), jb), has_aux=True)(flat)
    row = ravel(tp).requires_grad_(True)
    loss, m = lm.train_loss(cfg, unravel(row, flat_spec(tp)),
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["moe_aux"].detach()),
                               float(jm["moe_aux"]), rtol=1e-5)
    assert float(m["moe_aux"].detach()) > 0
    np.testing.assert_allclose(row.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)


def test_dense_loss_reports_zero_aux():
    """A dense model's metrics carry ``moe_aux`` 0, as JAX's."""
    cfg = reduced(get_config("internlm2_20b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    p = lm.init_params(cfg, gen)
    toks = torch.from_numpy(_toks(cfg, (1, 8), 0))
    loss, m = lm.train_loss(cfg, p, {"tokens": toks, "labels": toks})
    assert set(m) == {"loss", "moe_aux"} and float(m["moe_aux"]) == 0.0
    assert torch.isfinite(loss)


# --------------------------------------------------------------------- #
# serving against JAX
# --------------------------------------------------------------------- #
def test_prefill_and_decode_logits_match_jax(moe_pair):
    """Contiguous cache: prefill then two decode steps; paged cache: two
    slots admitted from B=1 prefills, then ragged decode steps with a
    finished (-1) row (the JAX step routes it too; so does the port's)."""
    jcfg, jp, cfg, p = moe_pair
    toks = _toks(cfg, (2, 9), 1)
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

    pages = [np.array([1, 2, 3], np.int32), np.array([4, 5, 6], np.int32)]
    jpg = jlm.init_paged_cache(jcfg, 2, 7, 4, 3)
    tpg = lm.init_paged_cache(cfg, 2, 7, 4, 3, device="cpu")
    for s, T in enumerate([5, 7]):
        pr = toks[s:s + 1, :T]
        _, jpc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(pr)},
                             max_len=8)
        _, tpc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(pr)},
                            max_len=8)
        jpg = jlm.admit_prefill(jcfg, jpg, jpc, jnp.asarray(pages[s]),
                                jnp.int32(s))
        lm.admit_prefill(cfg, tpg, tpc, torch.from_numpy(pages[s]), s)
    for step, ci in enumerate(([5, 7], [6, -1])):
        col = toks[:, step:step + 1]
        jl, jpg = jlm.decode_step(jcfg, jp, jpg, jnp.asarray(col),
                                  jnp.asarray(ci, jnp.int32))
        tl, tpg = lm.decode_step(cfg, p, tpg, torch.from_numpy(col), ci)
        live = [b for b, i in enumerate(ci) if i >= 0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)


class _Drops:
    """Wraps ``layers._moe_dispatch_compute`` and counts, per call, the
    tokens it saw and the assignments that did not fit."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = layers._moe_dispatch_compute

        def wrapped(p, xf, cfg, *args, n_tokens=None, **kw):
            n = xf.shape[-2] if n_tokens is None else n_tokens
            keep = layers._moe_route(p, xf, cfg, n)[-1]
            self.calls.append((n, int((~keep).sum())))
            return inner(p, xf, cfg, *args, n_tokens=n_tokens, **kw)

        monkeypatch.setattr(layers, "_moe_dispatch_compute", wrapped)


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_of_8_rows_at_capacity_one_matches_jax(arch,
                                                           monkeypatch):
    """``decode_step`` at ``B = 8`` rows and capacity 1.0, after a prefill
    that drops too: the port pads the step to ``lm.DECODE_ROWS`` = 16
    rows, whose capacity (8) is not that of 8 rows (4); the MoE slot
    counts the 8 real rows only, so the same assignments drop as in JAX's
    step and the logits match."""
    jcfg, jp, cfg, p = _pair(arch, moe_capacity_factor=1.0)
    assert layers.moe_capacity(cfg, 8) == 4
    assert layers.moe_capacity(cfg, lm.DECODE_ROWS) == 8
    toks = _toks(cfg, (8, 7), 2)
    drops = _Drops(monkeypatch)
    jl, jc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :6])},
                         max_len=7)
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :6])},
                        max_len=7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pre = list(drops.calls)
    assert [n for n, _ in pre] == [48] * cfg.n_layers and \
        sum(d for _, d in pre) > 0
    jl, _ = jlm.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 6:]),
                            jnp.int32(6))
    tl, _ = lm.decode_step(cfg, p, tc, torch.from_numpy(toks[:, 6:]), 6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    dec = drops.calls[len(pre):]
    assert [n for n, _ in dec] == [8] * cfg.n_layers and \
        sum(d for _, d in dec) > 0


def test_smoke_drop_tally_counts_prefill_and_decode(monkeypatch):
    """``chip_smoke.py``'s ``count_moe_drops`` (which wraps
    ``layers._moe_dispatch_compute``) tallies a prefill's and a decode
    step's dispatches apart, with the drops ``_Drops`` sees."""
    _, _, cfg, p = _pair("mixtral_8x7b", moe_capacity_factor=1.0)
    toks = torch.from_numpy(_toks(cfg, (8, 7), 2))
    mine = _Drops(monkeypatch)
    with chip_smoke().count_moe_drops() as tally:
        _, cache = lm.prefill(cfg, p, {"tokens": toks[:, :6]}, max_len=7)
        lm.decode_step(cfg, p, cache, toks[:, 6:], 6)
    n = cfg.n_layers
    assert [tally[k]["calls"] for k in ("prefill", "decode")] == [n, n]
    assert tally["prefill"]["assignments"] == 48 * 2 * n
    assert tally["decode"]["assignments"] == 8 * 2 * n
    assert [tally["prefill"]["dropped"], tally["decode"]["dropped"]] == [
        sum(d for _, d in mine.calls[:n]), sum(d for _, d in mine.calls[n:])]
    assert [tally["prefill"]["layers"][i][1] for i in range(n)] == [
        d for _, d in mine.calls[:n]]


@pytest.mark.parametrize("arch", MOE + DENSE)
def test_prefill_decode_consistency(arch):
    """``tests/test_archs_smoke.py``'s check in the port: decode_step(T)
    after prefill(:T) gives prefill(:T+1)'s last logits."""
    cfg = reduced(get_config(arch))
    gen = torch.Generator()
    gen.manual_seed(1)
    params = lm.init_params(cfg, gen)
    B, T = 2, 32
    toks = torch.from_numpy(_toks(cfg, (B, T + 1), 3))
    lg_full, _ = lm.prefill(cfg, params, {"tokens": toks})
    _, cache = lm.prefill(cfg, params, {"tokens": toks[:, :T]},
                          max_len=T + 1)
    lg_dec, _ = lm.decode_step(cfg, params, cache, toks[:, T:], T)
    np.testing.assert_allclose(lg_full.numpy(), lg_dec.numpy(), rtol=1e-3,
                               atol=1e-3)


def _rows(entry, rows):
    ent = entry["self"]
    if "pages" in ent:
        return {"self": {"k": ent["k"].clone(), "v": ent["v"].clone(),
                         "pages": ent["pages"][:, rows].clone()}}
    return {"self": {k: v[:, rows].clone() for k, v in ent.items()}}


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_rows_do_not_depend_on_batch(moe_pair, paged):
    """A row's logits and the k/v it writes are bitwise the same in a step
    of three rows and in a step of its own: its routing runs at the fixed
    width, and its expert products at one shape, whatever slots the
    other rows take in the buffer."""
    _, _, cfg, p = moe_pair
    toks = _toks(cfg, (3, 9), 3)
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
        cache = {n: {"self": {k: torch.cat([c[n]["self"][k] for c in singles],
                                           1) for k in ("k", "v")}}
                 for n in singles[0]}
    batch_cache = {n: _rows(e, slice(None)) for n, e in cache.items()}
    batch, _ = lm.decode_step(cfg, p, batch_cache, col, lens if paged else 9)
    for s, T in enumerate(lens):
        one = {n: _rows(e, slice(s, s + 1)) for n, e in cache.items()}
        row, _ = lm.decode_step(cfg, p, one, col[s:s + 1],
                                [T] if paged else T)
        assert torch.equal(batch[s], row[0])
        if not paged:
            for n, e in one.items():
                for key in ("k", "v"):
                    assert torch.equal(batch_cache[n]["self"][key][:, s],
                                       e["self"][key][:, 0])


def _oracle(cfg, params, req):
    res = generate(cfg, params, np.asarray(req.prompt)[None],
                   max_new=req.max_new, temperature=req.temperature,
                   seed=req.seed, device="cpu")
    return res.tokens[0, len(req.prompt):]


def test_engine_tokens_equal_generate_and_jax_engine(moe_pair):
    """The engine's tokens (greedy and sampled) are bitwise the port's
    ``generate``; its greedy tokens equal the JAX engine's."""
    jcfg, jp, cfg, p = moe_pair
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
               for t in (3, 11, 6, 9, 1)]
    reqs = [Request(prompt=pr, max_new=6, temperature=0.7 * (i % 2), seed=i)
            for i, pr in enumerate(prompts)]
    eng = DecodeEngine(cfg, p, slots=2, page_size=4, max_ctx=20,
                       max_new_cap=6, device="cpu")
    got = ServeStream(eng, wave_len=3).run(reqs)
    for g, req in zip(got, reqs):
        assert g.status == "ok"
        assert np.array_equal(g.generated, _oracle(cfg, p, req))
    eng.pool.check_invariants()
    jeng = jserve.DecodeEngine(jcfg, jp, slots=2, page_size=4, max_ctx=20,
                               max_new_cap=6)
    want = jserve.ServeStream(jeng, wave_len=3).run(
        [jserve.Request(prompt=pr, max_new=6) for pr in prompts[::2]])
    for g, w in zip(got[::2], want):
        assert np.array_equal(g.generated, np.asarray(w.generated))


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #
#: the tiny pipeline's widths for the MoE trainer (4 experts, top-2)
MOE_TINY = dict(TINY, d_ff=32)


@pytest.fixture(scope="module")
def jax_run_moe():
    """One step of the JAX trainer on a tiny moonshot (4 experts, top-2,
    capacity 8.0)."""
    return _record_jax_run("moonshot_v1_16b_a3b", MOE_TINY, steps=1)


def test_moe_synced_gradient_bitwise_equals_jax(jax_run_moe):
    """Given the JAX trainer's per-subfile gradients, the combiner and the
    shuffle give its synced gradient; the port's first step's losses are
    its losses."""
    _check_synced_gradient(jax_run_moe, map_lane=False)
    tr = MultiModelCAMRTrainer(
        jax_run_moe["cfg"], q=2, k=3, device="cpu",
        params=[params_from_jax(p, "cpu") for p in jax_run_moe["init"]])
    rep = tr.train_steps(ShardedTokenPipeline(vocab=64, seq_len=8,
                                              global_batch=2), 1)
    np.testing.assert_allclose(np.asarray(rep.losses),
                               jax_run_moe["losses"], rtol=1e-4)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_moe_three_wires_are_bitwise_equal(lane):
    """``camr_spmd``, ``camr`` and ``uncoded`` from one seed on a tiny
    mixtral (tensor-parallel experts in JAX; one lane here), 2 steps:
    parameters and losses bitwise equal on each lane."""
    cfg = reduced(get_config("mixtral_8x7b")).replace(remat="none",
                                                      **MOE_TINY)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    runs = {}
    for mode in ("camr_spmd", "camr", "uncoded"):
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=6,
                                   grad_sync_dtype=lane)
        runs[mode] = (tr, tr.train_steps(pipe, 2, mode=mode))
    tr0, rep0 = runs["camr_spmd"]
    assert np.isfinite(rep0.losses).all()
    for mode in ("camr", "uncoded"):
        tr, rep = runs[mode]
        assert torch.equal(tr.flat.view(torch.int32),
                           tr0.flat.view(torch.int32)), mode
        assert rep.losses == rep0.losses, mode


# --------------------------------------------------------------------- #
# the virtual-mesh lanes
# --------------------------------------------------------------------- #
#: (arch, T, lane): ``ep`` with the sequence split over model (the
#: all_to_all), ``ep`` with T odd (the ep-replicated lane), ``tp``
MESH_CASES = [("moonshot_v1_16b_a3b", 32, "ep"),
              ("moonshot_v1_16b_a3b", 31, "ep_replicated"),
              ("mixtral_8x7b", 32, "tp")]


def _grad(cfg, p, batch, mesh):
    row = ravel(p).requires_grad_(True)
    loss, m = lm.train_loss(cfg, unravel(row, flat_spec(p)), batch,
                            mesh=mesh)
    loss.backward()
    return float(loss.detach()), float(m["moe_aux"].detach()), row.grad


@pytest.mark.parametrize("arch,T,lane", MESH_CASES,
                         ids=[c[2] for c in MESH_CASES])
def test_mesh_lanes_match_the_no_mesh_lane(arch, T, lane, monkeypatch):
    """``moe_block(mesh=(4, 2))`` against the no-mesh lane: the loss, its
    flat gradient, and a decode step after a prefill on the mesh (T = 1:
    the ep-replicated lane) against the no-mesh prefill's last logits."""
    cfg = reduced(get_config(arch))
    gen = torch.Generator()
    gen.manual_seed(0)
    p = lm.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    seen = []
    inner = layers._moe_dispatch_compute

    def spy(p_, xf, cfg_, ep_replicated=False, **kw):
        seen.append((tuple(xf.shape[:-2]), ep_replicated))
        return inner(p_, xf, cfg_, ep_replicated, **kw)

    monkeypatch.setattr(layers, "_moe_dispatch_compute", spy)
    loss0, aux0, g0 = _grad(cfg, p, batch, None)
    seen.clear()
    loss, aux, g = _grad(cfg, p, batch, (4, 2))
    assert set(seen) == {((4, 2), lane == "ep_replicated")}
    assert abs(loss - loss0) < 2e-4 and abs(aux - aux0) < 2e-4
    assert float((g - g0).abs().max()) < 2e-2

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 17))
                            .astype(np.int32))
    lg_full, _ = lm.prefill(cfg, p, {"tokens": toks})
    _, cache = lm.prefill(cfg, p, {"tokens": toks[:, :16]}, max_len=17,
                          mesh=(4, 2))
    seen.clear()
    lg_dec, _ = lm.decode_step(cfg, p, cache, toks[:, 16:], 16, mesh=(4, 2))
    assert set(seen) == {((4, 2), cfg.moe_shard_mode == "ep")}
    np.testing.assert_allclose(lg_full.numpy(), lg_dec.numpy(), rtol=2e-3,
                               atol=2e-3)


_RUN_JAX_MESH = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.flatten_util import ravel_pytree
    from repro.compat import make_mesh
    from repro.configs import get_config, reduced
    from repro.models import lm
    from repro.launch import partitioning as pt
    mesh = make_mesh((4, 2), ('data', 'model'))
    out = {{}}
    for arch in {archs!r}:
        cfg = reduced(get_config(arch)).replace(moe_capacity_factor=1.25)
        params = lm.init_params(cfg, jax.random.PRNGKey(0))
        flat, unravel = ravel_pytree(params)
        rng = np.random.default_rng(0)
        batch = {{k: jnp.asarray(rng.integers(0, cfg.vocab, (8, 32)),
                                jnp.int32) for k in ('tokens', 'labels')}}
        def step(fl):
            with pt.axis_rules(mesh):
                return jax.value_and_grad(
                    lambda f: lm.train_loss(cfg, unravel(f), batch),
                    has_aux=True)(fl)
        with mesh:
            (loss, m), g = jax.jit(step)(flat)
        np.save({tmp!r} + f'/{{arch}}_grad.npy', np.asarray(g))
        out[arch] = [float(loss), float(m['moe_aux'])]
    print(json.dumps(out))
""")


def test_mesh_lanes_match_jax_shard_map(tmp_path):
    """One JAX subprocess on a (4, 2) mesh of host devices: the loss,
    ``moe_aux`` and flat gradient of JAX's ``shard_map`` lane (``ep``
    with its all_to_all on moonshot, ``tp`` on mixtral) at capacity 1.25,
    where each local token block drops on its own capacity, against the
    port's mesh lane on the same parameters and batch."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", _RUN_JAX_MESH.format(archs=MOE,
                                                    tmp=str(tmp_path))],
        capture_output=True, text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for arch in MOE:
        _, _, cfg, p = _pair(arch, moe_capacity_factor=1.25)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        loss, aux, g = _grad(cfg, p, batch, (4, 2))
        _, aux0, _ = _grad(cfg, p, batch, None)
        np.testing.assert_allclose(loss, want[arch][0], rtol=1e-5)
        np.testing.assert_allclose(aux, want[arch][1], rtol=1e-5)
        assert aux != aux0        # per-block capacity: not the no-mesh lane
        np.testing.assert_allclose(g.numpy(),
                                   np.load(tmp_path / f"{arch}_grad.npy"),
                                   rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE + ["internlm2_20b"])
def test_launcher_serves(arch, capsys):
    launch_serve.main(["--archs", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "engine: 3 reqs / 12 tokens" in out and "status: ok=3" in out


def test_launcher_trains_mixtral(capsys, monkeypatch):
    # at remat none, as _pair (tests/test_torch_remat.py holds the
    # default "block" bitwise to it)
    monkeypatch.setattr(launch_train, "reduced",
                        lambda c: reduced(c).replace(remat="none"))
    launch_train.main(["--arch", "mixtral_8x7b", "--reduced",
                       "--multi-model", "--grad-sync", "camr_spmd",
                       "--steps", "2", "--seq-len", "8", "--batch", "2",
                       "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    steps = [json.loads(x) for x in lines if x.startswith('{"step"')]
    assert [s["step"] for s in steps] == [1, 2]
    assert np.isfinite([s["losses"] for s in steps]).all()
    assert '"mode": "camr_spmd"' in lines[-2]
