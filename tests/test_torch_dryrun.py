"""The port's step builders, dry run and roofline
(``repro_torch.launch.{steps,dryrun,roofline}``) against the JAX
package's, on the CPU.

* Shapes, registries and closed forms at every arch and shape, exactly:
  ``SHAPES``, ``shape_supported``, ``list_archs``, the parameter tree
  (``jax.eval_shape(init_params)``) and ``input_specs`` (the decode cache
  through ``jax.eval_shape``), shapes and dtypes; ``param_count``;
  ``model_flops``.
* At reduced granite, mixtral and mamba2, JAX's ``build_step`` compiled
  on a one-device ``("data", "model")`` mesh against the port's step:
  argument and alias bytes equal ``memory_analysis()``'s exactly, output
  bytes too once XLA's result tuple is added (one 8-byte pointer per
  output leaf); the outputs from the same parameters (carried across by
  ``repro_torch.weights``) within f32 tolerances: loss rtol 1e-5, gnorm
  rtol 1e-4, updated parameters atol 2e-5 (AdamW normalises each
  gradient element, see ``test_torch_train.py``), prefill and decode
  logits and caches rtol / atol 1e-4 (``test_torch_serve.py``'s).
* The train step's matrix-product FLOPs on real CPU tensors equal the
  ``dot`` FLOPs of JAX's compiled HLO at ``scan_unroll=True``, at
  ``remat="none"`` and at JAX's default ``"block"`` (the recompute of
  each unit and loss chunk counted in both): exactly for granite and
  mixtral at ``"none"`` and at ``"block"`` over four loss chunks; at one
  loss chunk XLA drops the chunk's logits recompute (a pinned pair, one
  logits product apart, shown product by product); on the chunked
  attention lane (forced at the reduced size) the port computes one
  block-step product per block step that XLA drops, at both settings
  (pinned pairs, product by product; the unit recompute adds the same
  FLOPs in both); mamba2's differ
  inside the SSD chunked scan only (pinned ratio; with the scan replaced
  by one dot-free stand-in in both packages the counts are equal).
* The dry run: the meta trace counts what the CPU trace counts on a
  train step, ``cost_pass``'s affine identity holds exactly, the kernel
  formulas give ``PERF.md``'s Bound figures, each kernel's ``meta`` route
  gives the plain version's shape and dtype and launches nothing, the
  device-side decode lane matches the host one, the full-size cells
  that fit one card are judged so from their traces, and the CLIs run.
"""

import collections
import functools
import os
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch.steps import build_step as jax_build_step
from repro.models import lm as jlm
from repro.optim import AdamWState as JaxAdamWState
from repro_torch import configs
from repro_torch.kernels import (aggregate, cost, flash_attention, ops,
                                 ssd_scan, xor_code)
from repro_torch.kernels.flash_attention import split_plan
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.steps import build_step
from repro_torch.models import layers, lm
from repro_torch.optim import adamw_init, tree_leaves
from repro_torch.weights import params_from_jax

ARCHS3 = ["granite_3_2b", "mixtral_8x7b", "mamba2_1p3b"]
#: reduced steps: (seq_len, global_batch) per kind
SMALL = {"train": (64, 4), "prefill": (64, 2), "decode": (64, 2)}
#: arguments JAX's ``jit`` drops because the step never reads them
#: (``keep_unused=False``): an SSM decode step uses no position
PRUNED = {("mamba2_1p3b", "decode"): 4}
#: the position a reduced decode step writes and attends up to
DECODE_AT = 40
#: the same f32 math summed in other orders
TOL = dict(rtol=1e-4, atol=1e-4)
#: (port, JAX) dot FLOPs of reduced mamba2's train step (64 tokens x 4):
#: the port's SSD chunked scan computes c b^T per head, the product with
#: the zero initial state and the unused final state, which XLA folds or
#: drops; JAX's recomputes its checkpointed chunk body
MAMBA2_DOT_FLOPS = (151_781_376, 146_669_568)
#: (port, JAX) dot FLOPs of the reduced train step (64 tokens x 4) at
#: ``remat="block"`` with the reduced config's one loss chunk: the port
#: recomputes the chunk's logits product in the backward, XLA's compile
#: of the one-trip chunk loop does not (at four chunks it does, and the
#: counts are equal); the difference is that one product, 2 * 256 * 64
#: * 256 FLOPs
REMAT_ONE_CHUNK_DOT_FLOPS = {"granite_3_2b": (209_715_200, 201_326_592),
                             "mixtral_8x7b": (1_729_101_824, 1_720_713_216)}
#: (port, JAX) dot FLOPs of the reduced train step (64 tokens x 4, four
#: loss chunks) on the chunked attention lane with blocks of 16, at each
#: ``remat``: the port recomputes one block-step product per block step
#: that XLA drops (20 of 2 * 4 * 4 * 16 * 16 * 16 FLOPs), at either
#: setting
CHUNKED_DOT_FLOPS = {"none": (156_762_112, 154_140_672),
                     "block": (199_753_728, 197_132_288)}
#: the reduced config's fields at JAX's ``remat="block"`` over four loss
#: chunks of the 64-token train step
BLOCK4 = {"loss_chunk": 16, "remat": "block"}


def _port_cfg(arch, **kw):
    return configs.reduced(configs.get_config(arch)).replace(**kw)


def _jax_cfg(arch, **kw):
    return jconfigs.reduced(jconfigs.get_config(arch)).replace(**kw)


def _shapes(kind):
    T, B = SMALL[kind]
    return (configs.ShapeSpec(f"{kind}_small", T, B, kind),
            jconfigs.ShapeSpec(f"{kind}_small", T, B, kind))


def _compile(jcfg, shape, mesh):
    b = jax_build_step(jcfg, mesh, shape)
    with mesh:
        return b, b.fn.lower(*b.args).compile()


def _np_params(cfg):
    """Random reduced parameters as a numpy tree (both packages take
    the same tree layout)."""
    gen = torch.Generator().manual_seed(1)
    return jax.tree.map(lambda t: t.numpy(), lm.init_params(cfg, gen))


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _avals(tree) -> dict:
    """{path: (shape, dtype name)} of a nested dict of arrays, avals or
    tensors."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


# --------------------------------------------------------------------- #
# registries, shapes and closed forms at full size
# --------------------------------------------------------------------- #
def test_shapes_and_registry_match_jax():
    assert configs.SHAPES == {
        k: configs.ShapeSpec(v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in jconfigs.SHAPES.items()}
    assert configs.list_archs() == jconfigs.list_archs()
    for arch in configs.ARCHS:
        for name in configs.SHAPES:
            got = configs.shape_supported(configs.get_config(arch),
                                          configs.SHAPES[name])
            want = jconfigs.shape_supported(jconfigs.get_config(arch),
                                            jconfigs.SHAPES[name])
            assert got == want, (arch, name)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_full_size_arguments_match_jax(arch):
    """Parameters (``jax.eval_shape(init_params)``), every shape's
    inputs (the cache through ``jax.eval_shape``), ``microbatches``,
    ``grad_sync_dtype``, ``param_count`` and ``model_flops``, at full
    size on ``meta``."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert (cfg.microbatches, cfg.grad_sync_dtype) == \
        (jcfg.microbatches, jcfg.grad_sync_dtype)
    for active in (False, True):
        assert cfg.param_count(active) == jcfg.param_count(active)
    want = jax.eval_shape(lambda: jlm.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    assert _avals(lm.init_params(cfg, None, device="meta")) == _avals(want)
    for name, shape in configs.SHAPES.items():
        assert roofline.model_flops(arch, name) == \
            jroofline.model_flops(arch, name)
        if not configs.shape_supported(cfg, shape)[0]:
            continue
        got = configs.input_specs(cfg, shape, device="meta")
        want = jconfigs.input_specs(jcfg, jconfigs.SHAPES[name])
        assert _avals(got) == _avals(want), (arch, name)
        assert all(t.device.type == "meta" for t in tree_leaves(got)
                   if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------- #
# the reduced steps against JAX's compiled steps
# --------------------------------------------------------------------- #
#: (arch, overrides, kind) of the step comparisons: each arch's three
#: steps at its reduced config with ``remat="none"`` unless the case
#: sets it, granite's train step with two microbatches and with bf16
#: gradient casts, and each arch's train step at JAX's default
#: ``remat="block"`` over four loss chunks
CASES = [(a, {}, kind) for a in ARCHS3
         for kind in ("train", "prefill", "decode")] + [
    ("granite_3_2b", {"microbatches": 2}, "train"),
    ("granite_3_2b", {"grad_sync_dtype": "bfloat16"}, "train")] + [
    (a, BLOCK4, "train") for a in ARCHS3]


def _case_id(case):
    arch, kw, kind = case
    return "-".join([arch, kind] + [f"{k}={v}" for k, v in kw.items()])


@functools.lru_cache(maxsize=None)
def _jax_step(arch, kw, kind):
    """JAX's reduced step on a one-device mesh, compiled with its scans
    unrolled and no remat unless ``kw`` sets it (the port's computation;
    the argument and output buffers are those of the scanned,
    rematerialised compile)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jcfg = _jax_cfg(arch, scan_unroll=True, **{"remat": "none", **dict(kw)})
    return (mesh, *_compile(jcfg, _shapes(kind)[1], mesh))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_step_matches_jax(case):
    arch, kw, kind = case
    cfg = _port_cfg(arch, **{"remat": "none", **kw})
    shape, jshape = _shapes(kind)
    mesh, jb, compiled = _jax_step(arch, tuple(sorted(kw.items())), kind)
    mem = compiled.memory_analysis()
    # bytes: the meta trace against XLA's buffer assignment
    res = dryrun.trace_step(build_step(cfg, shape, device="meta"))
    got = res["memory"]
    n_out = len(dryrun._tensors(res["out"]))
    assert got["argument_bytes"] - PRUNED.get((arch, kind), 0) == \
        mem.argument_size_in_bytes
    assert got["output_bytes"] + 8 * n_out == mem.output_size_in_bytes
    assert got["alias_bytes"] == mem.alias_size_in_bytes
    # values: the same parameters and inputs through both steps
    rng = np.random.default_rng(0)
    npp = _np_params(cfg)
    jp = jax.tree.map(jnp.array, npp)
    params = params_from_jax(npp, "cpu")
    T, B = shape.seq_len, shape.global_batch
    pb = build_step(cfg, shape, device="cpu")
    if kind == "train":
        batch = {k: rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
                 for k in ("tokens", "labels")}
        opt = adamw_init(params)
        _, opt, m = pb.fn(params, opt,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
        jopt = JaxAdamWState(step=np.int32(0),
                             mu=jax.tree.map(np.zeros_like, npp),
                             nu=jax.tree.map(np.zeros_like, npp))
        with mesh:
            jparams, jopt, jm = jb.fn(jp, jopt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-4)
        assert int(opt.step) == int(jopt.step) == 1
        for a, b in zip(tree_leaves(params), _np_leaves(jparams)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-5)
        return
    if kind == "prefill":
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, T))
                 .astype(np.int32)}
        logits, cache = pb.fn(params, {"tokens": torch.from_numpy(
            batch["tokens"])})
        with mesh:
            jlogits, jcache = jb.fn(jp, batch)
    else:
        spec = jconfigs.input_specs(_jax_cfg(arch), jshape)
        ncache = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(s.dtype),
            spec["cache"])
        toks = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jcache = jax.tree.map(jnp.array, ncache)   # copies: the port's
        cache = params_from_jax(ncache, "cpu")     # step writes in place
        logits, cache = pb.fn(params, cache, torch.from_numpy(toks),
                              torch.tensor(DECODE_AT, dtype=torch.int32))
        with mesh:
            jlogits, jcache = jb.fn(jp, jcache, toks, np.int32(DECODE_AT))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    got_c, want_c = tree_leaves(cache), _np_leaves(jcache)
    assert len(got_c) == len(want_c)
    for a, b in zip(got_c, want_c):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


_DEF = re.compile(r"^\s*(?:ROOT\s+)?%(\S+)\s*=\s*\w+\[([\d,]*)\]")
_DOT = re.compile(r"\bdot\(%([^,\s]+), %([^,\s)]+)\)"
                  r".*lhs_contracting_dims=\{([\d,]*)\}")


def hlo_dot_flops_each(text: str) -> collections.Counter:
    """The FLOPs ``2 * prod(out) * prod(contracted)`` of each ``dot`` of
    an HLO module's text (operand shapes from their definitions), as a
    multiset."""
    shapes, out = {}, collections.Counter()
    assert "convolution(" not in text and " while(" not in text
    for line in text.splitlines():
        m = _DEF.match(line)
        if not m:
            continue
        shapes[m.group(1)] = [int(x) for x in m.group(2).split(",") if x]
        d = _DOT.search(line)
        if d:
            lhs = shapes[d.group(1)]
            k = int(np.prod([lhs[int(i)] for i in d.group(3).split(",")
                             if i]))
            out[2 * int(np.prod(shapes[m.group(1)])) * k] += 1
    return out


def hlo_dot_flops(text: str) -> int:
    """Sum of the FLOPs of every ``dot`` of an HLO module's text."""
    return sum(f * n for f, n in hlo_dot_flops_each(text).items())


def _dot_flops(arch, compiled=None, **kw):
    """(port matrix-product FLOPs on CPU tensors, JAX's HLO dot FLOPs) of
    the reduced train step (JAX's compiled with its scans unrolled), both
    at no remat unless ``kw`` sets it."""
    shape, jshape = _shapes("train")
    res = dryrun.trace_step(build_step(
        _port_cfg(arch, **{"remat": "none", **kw}), shape, device="cpu"))
    if compiled is None:
        compiled = _jax_step(arch, tuple(sorted(kw.items())), "train")[2]
    return res["aten_flops"], hlo_dot_flops(compiled.as_text())


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x7b"])
def test_train_flops_equal_jax_hlo_dots(arch):
    got, want = _dot_flops(arch)
    assert got == want > 0


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x7b"])
def test_remat_train_flops_equal_jax_hlo_dots(arch):
    """At JAX's default ``remat="block"`` over four loss chunks: both
    counts hold the recompute of each unit (all but its last MLP
    product, which no residual reads: torch's early stop, XLA's DCE) and
    of each chunk's logits product, and are equal."""
    got, want = _dot_flops(arch, **BLOCK4)
    none = _dot_flops(arch)[0]
    assert got == want > none


def test_chunked_lane_train_flops_differ_by_one_product_a_block_step(
        monkeypatch):
    """The chunked attention lane, which every ``train_4k`` cell takes
    (4,096 tokens, past the 1448-token switch point), at ``remat="none"``
    and ``"block"``: the switch forced below the reduced step's 64 x 64
    scores and blocks of 16 in both packages, so at ``"block"`` each
    unit's checkpoint nests around the block steps' own
    (``jax.checkpoint`` in JAX's K-block scan, unrolled;
    ``torch.utils.checkpoint`` in the port's). The pinned pairs, product
    by product: at both settings the port's products are JAX's dots and
    one more of a block step's size per block step (the backward's
    recompute of a step runs on to its last saved tensor, where XLA drops
    a product no residual reads), so the unit recompute adds the same
    FLOPs in both packages."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops, ref
    bq = 16
    monkeypatch.setattr(jops, "_CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(ops, "CHUNK_THRESHOLD", 0)
    calls = []

    def chunked(*a, **kw):
        calls.append(1)
        return ref.flash_attention_chunked(*a, block_q=bq, block_k=bq, **kw)

    monkeypatch.setattr(ops, "flash_attention_chunked", chunked)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    shape, jshape = _shapes("train")
    counts = {}
    for remat in ("none", "block"):
        kw = dict(BLOCK4, remat=remat)
        _, compiled = _compile(_jax_cfg("granite_3_2b", scan_unroll=True,
                                        attn_block=bq, **kw), jshape, mesh)
        counts[remat] = _dot_flops("granite_3_2b", compiled, **kw)
        assert counts[remat] == CHUNKED_DOT_FLOPS[remat]
        cfg = _port_cfg("granite_3_2b", **kw)
        bundle = build_step(cfg, shape, device="cpu")
        with _ProductFlops() as port:
            bundle.fn(*bundle.args)
        jax_dots = hlo_dot_flops_each(compiled.as_text())
        nq = shape.seq_len // bq
        steps = cfg.n_layers * nq * (nq + 1) // 2       # causal: visible
        step = 2 * shape.global_batch * cfg.n_heads * bq * bq * cfg.head_dim
        assert port.flops - jax_dots == collections.Counter({step: steps})
        assert not jax_dots - port.flops
    assert calls
    (got, want), (got0, want0) = counts["block"], counts["none"]
    assert got - got0 == want - want0 > 0


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default)


class _ProductFlops(TorchDispatchMode):
    """The FLOPs of each aten matrix product, as a multiset."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            self.flops[2 * out.numel() * args[-2].shape[-1]] += 1
        return out


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x7b"])
def test_remat_one_loss_chunk_differs_by_the_logits_recompute(arch):
    """The pinned pair at ``remat="block"`` and one loss chunk, and where
    it lies, product by product: the port's products are JAX's dots and
    one more, of the logits' ``2 * B * T * d_model * vocab_padded``
    FLOPs (the chunk's recompute)."""
    kw = {"remat": "block"}
    got, want = _dot_flops(arch, **kw)
    assert (got, want) == REMAT_ONE_CHUNK_DOT_FLOPS[arch]
    cfg = _port_cfg(arch, **kw)
    shape, _ = _shapes("train")
    bundle = build_step(cfg, shape, device="cpu")
    with _ProductFlops() as port:
        bundle.fn(*bundle.args)
    jax_dots = hlo_dot_flops_each(
        _jax_step(arch, tuple(kw.items()), "train")[2].as_text())
    logits = 2 * shape.global_batch * shape.seq_len * cfg.d_model \
        * cfg.vocab_padded
    assert port.flops - jax_dots == collections.Counter({logits: 1})
    assert not jax_dots - port.flops
    assert got - want == logits


def test_mamba2_train_flops_differ_in_the_ssd_scan_only(monkeypatch):
    """The pinned ratio, and the proof that the SSD chunked scan holds
    all of it: with the scan replaced by one dot-free stand-in in both
    packages the two counts are equal."""
    got, want = _dot_flops("mamba2_1p3b")
    assert (got, want) == MAMBA2_DOT_FLOPS
    assert round(got / want, 4) == 1.0349

    def jax_stand_in(x, a, b, c, **kw):
        return x * (a[..., None] + jnp.sum(c, -1)[:, :, None, None]
                    ).astype(x.dtype)

    def port_stand_in(x, a, b, c, **kw):
        return x * (a[..., None] + c.sum(-1)[:, :, None, None]).to(x.dtype)

    from repro.models import layers as jlayers
    monkeypatch.setattr(jlayers.ops, "ssd", jax_stand_in)
    monkeypatch.setattr(layers, "ssd_chunked", port_stand_in)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, compiled = _compile(_jax_cfg("mamba2_1p3b", scan_unroll=True,
                                    remat="none"), _shapes("train")[1], mesh)
    got, want = _dot_flops("mamba2_1p3b", compiled)
    assert got == want > 0


# --------------------------------------------------------------------- #
# the dry run
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS3)
def test_meta_trace_counts_what_the_cpu_trace_counts(arch):
    shape, _ = _shapes("train")
    for remat in ("none", "block"):
        cfg = _port_cfg(arch, remat=remat)
        meta = dryrun.trace_step(build_step(cfg, shape, device="meta"))
        cpu = dryrun.trace_step(build_step(cfg, shape, device="cpu"))
        assert meta["cost"]["flops"] == cpu["cost"]["flops"] > 0
        assert meta["memory"] == cpu["memory"]
        assert meta["kernels"] == cpu["kernels"] == {}


def _overrides(arch, n_units):
    """The reduced config's fields as ``run_cell`` overrides, at
    ``n_units`` repeats of the layer pattern."""
    full, red = configs.get_config(arch), configs.reduced(
        configs.get_config(arch))
    kw = {f: getattr(red, f) for f in red.__dataclass_fields__
          if getattr(red, f) != getattr(full, f)}
    kw["n_layers"] = n_units * len(full.pattern)
    return kw


@pytest.mark.parametrize("arch,kind", [("granite_3_2b", "train"),
                                       ("granite_3_2b", "prefill"),
                                       ("granite_3_2b", "decode"),
                                       ("mixtral_8x7b", "train"),
                                       ("zamba2_2p7b", "prefill")])
def test_cost_pass_affine_identity(arch, kind):
    shape, _ = _shapes(kind)
    res = dryrun.cost_pass(arch, shape, overrides=_overrides(arch, 4))
    assert res["status"] == "ok" and res["repeats"] == 4
    p1, p2 = res["points"][1], res["points"][2]
    for key, full in (("flops", res["cost"]["flops"]),
                      ("bytes", res["cost"]["bytes_accessed"])):
        assert full == p1[key] + 3 * (p2[key] - p1[key]), key
        assert p2[key] > p1[key] > 0


def test_kernel_formulas_give_perf_md_figures():
    # granite's prefill at 1024 tokens, bf16: 4.30 GFLOP, 10.5 MB
    assert cost.flash_attention(1, 32, 8, 1024, 1024, 64, True, None, 2) \
        == (4_299_161_600, 10_485_760)
    # seamless's encoder, 1000 x 1000, 16 heads, D 64, f32
    assert cost.flash_attention(1, 16, 16, 1000, 1000, 64, False, None,
                                4) == (4_096_000_000, 16_384_000)
    # mamba2's prefill at T = 1024: 3.758 GFLOP; 17.56 MB bf16, 34.87 f32
    assert cost.ssd_scan(1, 1024, 64, 64, 128, 2, False) == \
        (3_758_096_384, 17_563_648)
    assert cost.ssd_scan(1, 1024, 64, 64, 128, 4, False)[1] == 34_865_152
    # the visible pairs of a causal, a windowed and a right-aligned mask
    assert cost.visible_pairs(4, 4, True, None) == 10
    assert cost.visible_pairs(4, 4, True, 2) == 7
    assert cost.visible_pairs(2, 5, True, None) == 9
    assert cost.visible_pairs(3, 7, False, None) == 21


def _kernel_calls(dev):
    """One call of each kernel wrapper on ``dev`` (their outputs)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    def i(hi, *shape):
        return torch.randint(0, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    def m(*shape):
        return (torch.rand(shape, generator=g) < 0.5).to(dev)

    words = i(1 << 30, 2, 5, 8)
    return {
        "flash_attention": flash_attention(r(1, 4, 16, 32), r(1, 2, 16, 32),
                                           r(1, 2, 16, 32)),
        "flash_attention_bf16": ops.attention(
            r(1, 4, 3, 16, dtype=torch.bfloat16),
            r(1, 2, 9, 16, dtype=torch.bfloat16),
            r(1, 2, 9, 16, dtype=torch.bfloat16), window=4),
        "ssd_scan": ssd_scan(r(1, 70, 2, 8), -r(1, 70, 2).abs(),
                             r(1, 70, 4), r(1, 70, 4)),
        "aggregate": aggregate(r(6, 10), i(3, 6), 3),
        "xor_fold": xor_code.xor_fold(i(1 << 30, 2, 3, 8)),
        "xor_decode": xor_code.xor_decode(i(1 << 30, 2, 8),
                                          i(1 << 30, 2, 3, 8), m(2, 3)),
        "xor_encode": ops.xor_fold(i(1 << 30, 3, 8)),
        "xor_encode_gather": xor_code.xor_encode_gather(
            words, i(5, 2, 4, 3), m(2, 4, 3)),
        "xor_decode_gather": xor_code.xor_decode_gather(
            words, words, i(5, 2, 4), i(5, 2, 4, 3), m(2, 4, 3)),
        "xor_encode_gather16": xor_code.xor_encode_gather16(
            words.view(torch.int16), i(5, 2, 4, 3), m(2, 4, 3)),
    }


def test_meta_routes_match_plain_shapes_and_launch_nothing():
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    with cost.counting() as kc:
        meta = _kernel_calls("meta")
    cpu = _kernel_calls("cpu")
    assert launch_counts() == before
    for name, out in meta.items():
        assert out.device.type == "meta"
        assert (out.shape, out.dtype) == (cpu[name].shape, cpu[name].dtype), \
            name
    assert set(kc.by_kernel) == {
        "flash_attention", "ssd_scan", "aggregate", "xor_fold",
        "xor_decode", "xor_encode", "xor_encode_gather",
        "xor_decode_gather", "xor_encode_gather16"}
    assert kc.by_kernel["flash_attention"]["calls"] == 2
    assert kc.by_kernel["flash_attention"]["flops"] == (
        cost.flash_attention(1, 4, 2, 16, 16, 32, True, None, 4)[0]
        + cost.flash_attention(1, 4, 2, 3, 9, 16, True, 4, 2)[0])
    assert kc.by_kernel["ssd_scan"]["bytes"] == \
        cost.ssd_scan(1, 70, 2, 8, 4, 4, False)[1]
    with cost.counting() as cpu_count:
        _kernel_calls("cpu")
    assert cpu_count.flops == cpu_count.bytes == 0


def test_meta_route_keeps_the_f32_split_scratch():
    """An f32 call with few query tiles allocates the key-split partials
    on ``meta`` as on a card (the dry run's peak counts them)."""
    q, k = (torch.empty(1, 4, 8, 64, device="meta"),
            torch.empty(1, 4, 4096, 64, device="meta"))
    tr = dryrun.StepTracer()
    with tr:
        ops.attention(q, k, k, causal=False)
    n = len(split_plan(8, 4096, False, None)[0])
    assert n > 1
    out = 4 * 8 * 64 * 4
    assert tr.peak >= out + 4 * n * 8 * (64 + 2) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_route_keeps_the_ssd_f32_scratch(dtype):
    """An f32 ``ssd_scan`` allocates its scratch on ``meta`` as on a card
    (the dry run's peak counts it): the state entering each chunk after
    the first, ``[B, H, n_chunks - 1, S, P rounded up to 4]`` f32, and the
    Gram tiles ``c b^T`` of each chunk, ``[B, 1, n_chunks, 64, 64]`` f32
    for group-shared b/c; a bf16 call allocates none. Both charge
    ``cost.ssd_scan`` as it stands."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Allocations(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.empty.memory_format:
                self.made.append((tuple(out.shape), out.dtype))
            return out

    B, T, H, P, S = 2, 200, 3, 6, 16         # 4 chunks, P padded to 8
    x = torch.empty(B, T, H, P, device="meta", dtype=dtype)
    a = torch.empty(B, T, H, device="meta")
    b = torch.empty(B, T, S, device="meta", dtype=dtype)
    tr = dryrun.StepTracer()
    with cost.counting() as kc, tr, Allocations() as allocs:
        y = ssd_scan(x, a, b, b)
    scratch = [((B, H, 3, S, 8), torch.float32),
               ((B, 1, 4, 64, 64), torch.float32)]
    f32 = dtype == torch.float32
    assert allocs.made == [(tuple(y.shape), dtype)] + (scratch if f32 else [])
    assert tr.peak >= y.numel() * y.element_size() + (
        (B * H * 3 * S * 8 + B * 4 * 64 * 64) * 4 if f32 else 0)
    flops, nbytes = cost.ssd_scan(B, T, H, P, S, x.element_size(), False)
    assert kc.by_kernel["ssd_scan"] == {"calls": 1, "flops": flops,
                                        "bytes": nbytes}


@pytest.mark.parametrize("arch", ARCHS3 + ["zamba2_2p7b"])
def test_device_decode_lane_matches_host_lane(arch):
    """``decode_step`` at a 0-d tensor position (any batch, nothing read
    back to the host) against the host-int lane (padded to
    ``DECODE_ROWS``)."""
    cfg = _port_cfg(arch)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen)
    cache = lm.init_cache(cfg, 3, 32, device="cpu")
    for t in tree_leaves(cache):
        t.normal_(generator=gen)
    twin = {k: {kk: {n: t.clone() for n, t in vv.items()}
                if isinstance(vv, dict) else vv.clone()
                for kk, vv in v.items()} for k, v in cache.items()}
    toks = torch.randint(0, cfg.vocab, (3, 1), generator=gen)
    want, _ = lm.decode_step(cfg, params, cache, toks, 20)
    got, _ = lm.decode_step(cfg, params, twin, toks,
                            torch.tensor(20, dtype=torch.int32))
    torch.testing.assert_close(got, want, **TOL)
    for a, b in zip(tree_leaves(twin), tree_leaves(cache)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("arch,shape,fits", [
    ("mamba2_1p3b", "decode_32k", True), ("mamba2_1p3b", "long_500k", True),
    ("zamba2_2p7b", "long_500k", True), ("granite_3_2b", "decode_32k",
                                          False)])
def test_full_size_fit_from_the_trace(arch, shape, fits):
    res = dryrun.run_cell(arch, shape)
    assert res["status"] == "ok" and res["fits"] is fits
    mem = res["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert res["collectives"]["total_bytes"] == 0
    assert res["devices"] == 1 and res["compile_s"] == 0.0


def test_cli_and_roofline(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2_1p3b", "--shape", "long_500k"])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite_3_2b", "--shape", "long_500k"])
    assert e.value.code == 0
    cell = roofline.load_cell("mamba2_1p3b", "long_500k")
    assert cell["status"] == "ok" and cell["fits"]
    assert roofline.load_cell("granite_3_2b", "long_500k")["status"] == \
        "skipped"
    rows = roofline.table()
    assert [(r.arch, r.shape) for r in rows] == [("mamba2_1p3b",
                                                  "long_500k")]
    r = rows[0]
    assert r.dominant == "memory" and r.collective_s == 0
    assert r.step_time_s == r.memory_s == \
        cell["cost"]["bytes_accessed"] / roofline.HBM_BW
    assert 0 < r.mfu < 1 and r.useful_flops_ratio > 0
    roofline.main([])
    assert "mamba2_1p3b" in capsys.readouterr().out
    roofline.main(["--markdown"])
    md = capsys.readouterr().out.splitlines()
    assert len(md) == 4 and "| granite_3_2b | long_500k | skipped" in md[2]
    assert md[3].startswith("| mamba2_1p3b | long_500k | ok |")
    with pytest.raises(ValueError, match="choose from card, single, "
                                         "multipod"):
        dryrun.run_cell("mamba2_1p3b", "long_500k", "pod")
    assert collections.Counter(os.listdir(tmp_path)) == collections.Counter(
        ["mamba2_1p3b_long_500k_card.json",
         "granite_3_2b_long_500k_card.json"])
