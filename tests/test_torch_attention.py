"""The port's attention against the JAX package, on the CPU: the plain
``flash_attention`` (the kernel's plain version) against the Pallas
kernel in interpret mode and against ``repro.kernels.ref.
flash_attention_ref``; the wrapper's checks and the routing of
``ops.attention``; the cached attention block against JAX's.

Tolerances, and why: against the Pallas kernel 2e-5 in f32 and 2e-2 in
bf16, those of ``tests/test_kernels.py`` (the online softmax sums in
another order than the materialized one; bf16 rounds the output);
against the JAX reference 1e-5 (the same materialized f32 math, summed
by XLA and by PyTorch in other orders). The chunked lane past 1448
tokens against JAX's ``flash_attention_chunked`` at 1e-5 in f32 (the
same block schedule and online softmax) and 2e-2 in bf16 (the
probabilities rounded to bf16 before P V on both sides, summed in
other orders); prefill logits past 1448 tokens at 1e-4, as
``tests/test_torch_serve.py`` holds them.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import KERNELS, flash_attention, launch_counts, ops
from repro_torch.kernels.ref import flash_attention_chunked, flash_attention_ref
from repro_torch.models import layers, lm
from repro_torch.weights import params_from_jax

from chip_smoke_module import chip_smoke

# the shapes of tests/test_kernels.py::ATTN_CASES:
# B, Hq, Hkv, Tq, Tk, D, causal, window, softcap
ATTN_CASES = [
    (1, 2, 2, 64, 64, 16, True, None, None),
    (2, 4, 2, 32, 32, 32, True, None, None),        # GQA
    (1, 2, 1, 128, 128, 16, True, 32, None),        # sliding window
    (1, 2, 2, 64, 64, 16, True, None, 50.0),        # softcap (gemma2)
    (1, 4, 4, 48, 48, 16, False, None, None),       # bidirectional
    (1, 2, 1, 1, 96, 16, True, None, None),         # decode: Tq=1
    (1, 2, 2, 100, 100, 16, True, None, None),      # non-divisible lengths
    (1, 8, 2, 8, 72, 16, True, 24, None),           # decode-window combo
]
# zamba2's head dim 80 (d_model 2560 over 32 heads), which the JAX file's
# ATTN_CASES do not reach: causal GQA with Tq = Tk, non-causal with Tq < Tk
D80_CASES = [
    (1, 4, 2, 100, 100, 80, True, None, None),
    (1, 2, 2, 40, 90, 80, False, None, None),
]
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(_NP[dtype])
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


def _torch(a):
    return params_from_jax(a, "cpu")


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap",
                         ATTN_CASES + D80_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_interpret(B, Hq, Hkv, Tq, Tk, D, causal,
                                              window, softcap, dtype):
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed=Tq * 7 + Tk)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, softcap=softcap,
                        block_q=32, block_k=32)
    before = flash_attention.launches
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                          window=window, softcap=softcap)
    assert flash_attention.launches == before      # the CPU: no launch
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 5, None), (True, None, 30.0),
    (False, None, None)])
def test_plain_flash_valid_len_matches_jax_ref(causal, window, softcap):
    """Scalar and per-row ``[B]`` valid lengths (the ragged decode over a
    paged cache), against the JAX reference; each row of the vector form
    equals the scalar form at its own length (twin of
    ``tests/test_serve.py::test_attention_vector_valid_len_matches_scalar``)."""
    B, Hq, Hkv, Tq, Tk, D = 3, 4, 2, 2, 12, 8
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, "float32", seed=3)
    lens = np.array([4, 9, 12], np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention_ref(_torch(q), _torch(k), _torch(v),
                              valid_len=torch.from_numpy(lens), **kw)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    valid_len=jnp.asarray(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for b, n in enumerate(lens):
        one = flash_attention_ref(_torch(q[b:b + 1]), _torch(k[b:b + 1]),
                                  _torch(v[b:b + 1]), valid_len=int(n), **kw)
        np.testing.assert_allclose(got[b].numpy(), one[0].numpy(), atol=1e-6)
        jone = jref.flash_attention_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), valid_len=int(n), **kw)
        np.testing.assert_allclose(one.numpy(), np.asarray(jone), atol=1e-5,
                                   rtol=1e-5)


def test_bad_gqa_and_bad_shapes_raise():
    q = torch.zeros((1, 3, 8, 4))
    k = v = torch.zeros((1, 2, 8, 4))
    for fn in (flash_attention, flash_attention_ref, ops.attention):
        with pytest.raises(ValueError, match="multiple"):
            fn(q, k, v)
    k2 = torch.zeros((1, 1, 4, 4))
    with pytest.raises(ValueError, match="Tq <= Tk"):
        flash_attention(torch.zeros((1, 2, 8, 4)), k2, k2)
    q1 = torch.zeros((1, 2, 4, 4))
    for kw in (dict(window=0), dict(softcap=0.0)):
        with pytest.raises(ValueError):
            flash_attention(q1, k2, k2, **kw)


#: non-causal attention with more queries than keys (an enc-dec prompt
#: longer than its frames, in the cross-attention prefill), GQA and MHA
TQ_GT_TK = [(1, 4, 2, 40, 17, 16), (2, 2, 2, 9, 4, 64)]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", TQ_GT_TK)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_more_queries_than_keys_matches_jax(B, Hq, Hkv, Tq, Tk, D,
                                                      dtype):
    """Non-causal ``Tq > Tk`` (every key visible, so the right alignment
    does not matter): the wrapper admits it and its plain version equals
    the JAX reference (1e-5 in f32; bf16 inputs, f32 math, the output
    rounded once: one bf16 ulp)."""
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed=Tq)
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=False)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False),
        np.float32)
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    assert ops.attention(_torch(q), _torch(k), _torch(v),
                         causal=False).equal(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_more_queries_than_keys_matches_pallas_interpret(dtype):
    """The Pallas kernel in interpret mode computes non-causal ``Tq > Tk``
    too: the plain version against it at one small shape, within the
    ATTN_CASES tolerances."""
    q, k, v = _inputs(1, 4, 2, 40, 17, 16, dtype, seed=5)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, block_q=32, block_k=32)
    got = flash_attention(_torch(q), _torch(k), _torch(v), causal=False)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_masked_more_queries_than_keys_still_raises():
    """A causal or window mask over ``Tq > Tk`` stays refused: the JAX
    kernel's rows with no visible key would mix in masked keys
    (ROADMAP.md, Queue 3)."""
    q = torch.zeros((1, 2, 9, 16))
    k = torch.zeros((1, 2, 4, 16))
    for kw in (dict(causal=True), dict(causal=False, window=3)):
        with pytest.raises(ValueError, match="Tq <= Tk"):
            flash_attention(q, k, k, **kw)
        with pytest.raises(ValueError, match="Tq <= Tk"):
            ops.attention(q, k, k, **kw)


@pytest.mark.parametrize("Tq,Tk", [(1, 12), (9, 5)])
def test_mixed_dtype_attention_matches_jax_ref(Tq, Tk):
    """``ops.attention`` on bf16 queries over f32 k/v (an enc-dec model's
    cross-attention over f32 frames): the JAX reference upcasts all three
    and rounds the output to q's dtype; the port promotes q to f32 (exact)
    and rounds its output likewise. On the CPU both give the same bf16
    values within one ulp (f32 sums in other orders, rounded once)."""
    q, _, _ = _inputs(1, 4, 2, Tq, Tk, 16, "bfloat16", seed=Tq)
    _, k, v = _inputs(1, 4, 2, Tq, Tk, 16, "float32", seed=Tk)
    got = ops.attention(_torch(q), _torch(k), _torch(v), causal=False)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=0)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device the kernel wrappers do not
    take."""
    @property
    def device(self):
        return torch.device("xpu")


def test_wrapper_refuses_grad_and_other_devices():
    """Grad is refused; ``meta`` takes the cost twin (an output of the
    kernel's shape, no launch); any other device is refused."""
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    k = torch.zeros((1, 2, 4, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    before = flash_attention.launches
    m = torch.zeros((1, 2, 4, 16), device="meta")
    out = flash_attention(m, m, m)
    assert out.device.type == "meta" and out.shape == m.shape
    assert flash_attention.launches == before
    x = torch.zeros((1, 2, 4, 16)).as_subclass(_Elsewhere)
    with pytest.raises(RuntimeError,
                       match="CPU .plain version., a CUDA device or meta"):
        flash_attention(x, x, x)


def test_head_dims_cover_every_attention_config():
    """Every config of the JAX zoo with an attention sublayer has a head
    dim that both CUDA bodies are instantiated for (64, 80, 128, 256)."""
    from repro.configs import ARCHS
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    kinds = {"attn", "local", "shared_attn"}
    dims = {name: jax_get_config(name).hd for name in ARCHS
            if kinds & set(jax_get_config(name).pattern)}
    assert "zamba2_2p7b" in dims and "mamba2_1p3b" not in dims
    assert {n: d for n, d in dims.items() if d not in HEAD_DIMS} == {}


def test_aligned_keeps_16_byte_views_and_copies_others():
    """The CUDA bodies read q, k and v in place when every stride but the
    last and the base are multiples of 16 bytes (the f32 body's float4
    loads, the bf16 body's TMA maps); otherwise the wrapper copies into
    fresh, aligned memory. Strides of axes of extent 1 do not count."""
    from repro_torch.kernels.flash_attention import _aligned
    x = torch.zeros((2, 40, 6, 80), dtype=torch.bfloat16)     # [B, T, H, D]
    view = x.transpose(1, 2)                                  # [B, H, T, D]
    assert _aligned(view) is view
    one = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16).as_strided(
        (1, 8, 4, 16), (3, 64, 16, 1))                        # odd b stride
    assert _aligned(one) is one
    for bad in (torch.zeros((1, 2, 5, 20), dtype=torch.bfloat16)[..., :16],
                torch.zeros(1 + 2 * 5 * 16, dtype=torch.bfloat16)[1:]
                .view(1, 2, 5, 16),
                torch.zeros((1, 2, 5, 16))[..., ::2]):
        got = _aligned(bad)
        assert got is not bad and torch.equal(got, bad)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()


def test_kernel_table_lists_ten_kernels():
    """Ten kernels through slice 4; ``ssd_scan`` (slice 5) makes eleven."""
    assert len(KERNELS) == 11 and KERNELS["flash_attention"] is \
        flash_attention
    assert launch_counts()["flash_attention"] == flash_attention.launches


def test_ops_attention_routes_by_valid_len(monkeypatch):
    """``valid_len=None`` goes through the kernel's wrapper (its plain
    version on the CPU); a decode with ``valid_len`` takes the plain
    masked lane and never reaches the wrapper, on any device."""
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(1, 4, 2, 1, 9, 16, "float32", seed=5))
    ops.attention(q, k, v, valid_len=6)
    assert calls == []
    ops.attention(q, k, v)
    assert calls == [1]


@pytest.mark.parametrize("arch", ["granite_3_2b", "gemma2_2b"])
def test_attention_block_prefill_then_decode_matches_jax(arch):
    """One attention sublayer with a contiguous cache: a 10-token prefill
    then a decode step, against ``repro.models.layers.attention_block``
    (rtol/atol 1e-4: f32 sums in other orders)."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(11)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.standard_normal((d, hq * dh)) * d ** -0.5,
         "wk": rng.standard_normal((d, hkv * dh)) * d ** -0.5,
         "wv": rng.standard_normal((d, hkv * dh)) * d ** -0.5,
         "wo": rng.standard_normal((hq * dh, d)) * d ** -0.5}
    p = {n: w.astype(np.float32) for n, w in p.items()}
    x = rng.standard_normal((2, 10, d)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    kw = dict(window=cfg.local_window, softcap=cfg.attn_softcap)
    zeros = np.zeros((2, hkv, 16, dh), np.float32)

    jc = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    jp = {n: jnp.asarray(w) for n, w in p.items()}
    jo, jc = jlayers.attention_block(jp, jnp.asarray(x), jnp.arange(10),
                                     jcfg, cache=jc,
                                     cache_index=jnp.int32(0), **kw)
    jo1, jc = jlayers.attention_block(jp, jnp.asarray(x1),
                                     jnp.full((2, 1), 10), jcfg, cache=jc,
                                     cache_index=jnp.int32(10), **kw)
    tc = {"k": torch.from_numpy(zeros.copy()),
          "v": torch.from_numpy(zeros.copy())}
    tp = {n: torch.from_numpy(w) for n, w in p.items()}
    to, tc = layers.attention_block(tp, torch.from_numpy(x),
                                    torch.arange(10), cfg, cache=tc,
                                    cache_index=0, **kw)
    to1, _ = layers.attention_block(tp, torch.from_numpy(x1),
                                    torch.full((2, 1), 10), cfg, cache=tc,
                                    cache_index=10, **kw)
    for got, want in ((to, jo), (to1, jo1), (tc["k"], jc["k"]),
                      (tc["v"], jc["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_materialized_lanes_keep_the_1448_limit():
    """Training and a CPU prefill keep the materialized attention up to
    ``seq_len`` 1448 (``Tq*Tk <= 2**21``) and take the chunked lane past
    it, with the same outputs as the materialized attention there."""
    cfg = reduced(get_config("granite_3_2b"))
    d = cfg.d_model
    gen = torch.Generator().manual_seed(0)
    p = {name: torch.randn(shape, generator=gen) * d ** -0.5
         for name, shape in (("wq", (d, cfg.n_heads * cfg.hd)),
                             ("wk", (d, cfg.n_kv_heads * cfg.hd)),
                             ("wv", (d, cfg.n_kv_heads * cfg.hd)),
                             ("wo", (cfg.n_heads * cfg.hd, d)))}
    assert 1448 ** 2 <= ops.CHUNK_THRESHOLD < 1449 ** 2
    calls = []
    real = ops.flash_attention_chunked

    def counted(*a, **kw):
        calls.append(a[0].shape[2])
        return real(*a, **kw)

    def run(T, cached):
        x = torch.randn((1, T, d), generator=torch.Generator().manual_seed(T))
        cache = ({"k": torch.zeros((1, cfg.n_kv_heads, T, cfg.hd)),
                  "v": torch.zeros((1, cfg.n_kv_heads, T, cfg.hd))}
                 if cached else None)
        out, _ = layers.attention_block(p, x, torch.arange(T), cfg,
                                        cache=cache, cache_index=0)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "flash_attention_chunked", counted)
    try:
        for cached in (False, True):
            run(1448, cached)
            assert calls == []
            got = run(1449, cached)
            assert calls == [1449]
            calls.clear()
            mp.setattr(ops, "CHUNK_THRESHOLD", float("inf"))
            want = run(1449, cached)
            mp.setattr(ops, "CHUNK_THRESHOLD", 2 ** 21)
            assert calls == []
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    finally:
        mp.undo()


# B, Hq, Hkv, T, D, causal, window, softcap, block_q, block_k: past 1448
# tokens at the JAX package's blocks of 1024, and smaller blocks that
# give several query and key blocks (skipped blocks, a padded last one)
CHUNKED_CASES = [
    (1, 4, 2, 1500, 16, True, None, None, 1024, 1024),     # GQA, causal
    (1, 2, 1, 1600, 16, True, 300, None, 512, 256),        # window
    (1, 2, 2, 1500, 16, True, None, 30.0, 1024, 1024),     # softcap
    (2, 4, 1, 700, 16, False, None, None, 256, 192),       # bidirectional
]


@pytest.mark.parametrize("B,Hq,Hkv,T,D,causal,window,softcap,bq,bk",
                         CHUNKED_CASES)
def test_chunked_lane_matches_jax(B, Hq, Hkv, T, D, causal, window, softcap,
                                  bq, bk):
    q, k, v = _inputs(B, Hq, Hkv, T, T, D, "float32", seed=T)
    kw = dict(causal=causal, window=window, softcap=softcap, block_q=bq,
              block_k=bk)
    want = jref.flash_attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw)
    got = flash_attention_chunked(_torch(q), _torch(k), _torch(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if bq == bk == 1024:     # the materialized attention of the same call
        np.testing.assert_allclose(
            got.numpy(), flash_attention_ref(
                _torch(q), _torch(k), _torch(v), causal=causal,
                window=window, softcap=softcap).numpy(), rtol=1e-5, atol=1e-5)


def test_chunked_lane_bf16_matches_jax():
    q, k, v = _inputs(1, 4, 2, 1500, 1500, 16, "bfloat16", seed=11)
    want = jref.flash_attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=700)
    got = flash_attention_chunked(_torch(q), _torch(k), _torch(v),
                                  window=700)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


def test_cpu_prefill_past_1448_matches_jax():
    """A 1456-token prefill of reduced granite on the CPU (the chunked
    lane in both packages) against JAX's logits and cache."""
    jcfg = jax_reduced(jax_get_config("granite_3_2b"))
    cfg = reduced(get_config("granite_3_2b"))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 1456)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         max_len=1460)
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)},
                        max_len=1460)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in lm.slot_names(cfg):
        np.testing.assert_allclose(tc[name]["self"]["k"].numpy(),
                                   np.asarray(jc[name]["self"]["k"]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [4095, 4097])
def test_serving_limit_catches_a_window_off_by_one(window):
    """``chip_smoke.py`` holds the kernel at the long serving shapes to
    two bf16 ulps of each output (``FLASH_SERVE_TOL``), not to the
    ``ATTN_CASES``' 2e-2, which is about half of a typical output over
    thousands of keys: a window one key off passes 2e-2 and fails the
    serving limit (gemma2's serving shape: D 256, softcap 50, window
    4096, 5000 keys; two heads)."""
    smoke = chip_smoke()
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        torch.bfloat16) for s in ((1, 2, 5000, 256), (1, 1, 5000, 256),
                                  (1, 1, 5000, 256)))
    kw = dict(causal=True, softcap=50.0)
    want = flash_attention_ref(q, k, v, window=4096, **kw).float()
    off = flash_attention_ref(q, k, v, window=window, **kw).float()
    assert torch.allclose(off, want, rtol=2e-2, atol=2e-2)
    assert not torch.allclose(off, want, **smoke.FLASH_SERVE_TOL)


def _tiled_bf16_attention(q, k, v, *, causal, window, softcap, parts):
    """A CPU model of the bf16 CUDA body's arithmetic: logits and the
    online softmax over 64-key tiles in f32, and P V with V in bf16 and f32
    sums, P rounded to bf16 once (``parts=1``) or split into ``bf16(P) +
    bf16(P - bf16(P))`` (``parts=2``, the kernel's plan); output in bf16."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    kf, vf = (t.float().repeat_interleave(Hq // Hkv, 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * D ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Tq)[:, None] + Tk - Tq
    kpos = torch.arange(Tk)[None]
    mask = kpos <= qpos if causal else torch.ones(Tq, Tk, dtype=torch.bool)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    m = torch.full((B, Hq, Tq), -1e30)
    l = torch.zeros((B, Hq, Tq))
    o = torch.zeros((B, Hq, Tq, D))
    for k0 in range(0, Tk, 64):
        st, mk = s[..., k0:k0 + 64], mask[:, k0:k0 + 64]
        vt = vf[:, :, k0:k0 + 64]
        m_new = torch.maximum(m, torch.where(mk, st, -1e30).amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(st - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if parts == 2:
            pv = pv + (p - hi).bfloat16().float() @ vt
        o = o * alpha[..., None] + pv
        m = m_new
    return (o / torch.where(l == 0, 1.0, l)[..., None]).bfloat16()


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap", [
    (1, 4, 1, 300, 300, 64, True, None, None),      # granite, reduced
    (1, 2, 1, 300, 300, 256, True, 200, 50.0),      # gemma2, reduced
    (1, 4, 1, 300, 300, 128, True, 200, None),      # mixtral, reduced
])
def test_pv_precision_plan_holds_the_serving_limit(B, Hq, Hkv, Tq, Tk, D,
                                                   causal, window, softcap):
    """The bf16 body multiplies P into V as two bf16 parts. Modelled on the
    CPU, that lands within ``FLASH_SERVE_TOL`` (rtol 2**-6 + atol 1e-5 of
    each output, which ``chip_smoke.py`` holds the kernel to at the serving
    shapes) of ``flash_attention_ref``; P rounded once to bf16 does not."""
    tol = chip_smoke().FLASH_SERVE_TOL
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).bfloat16()
               for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_ref(q, k, v, **kw).float()
    split = _tiled_bf16_attention(q, k, v, parts=2, **kw).float()
    once = _tiled_bf16_attention(q, k, v, parts=1, **kw).float()
    torch.testing.assert_close(split, want, **tol)
    assert not torch.allclose(once, want, **tol)
