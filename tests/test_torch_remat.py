"""JAX's block rematerialisation (``ModelConfig.remat``) in the port's
training path, on the CPU.

* ``remat`` is JAX's, with JAX's values, for every arch and in
  ``reduced()``; any other value is refused.
* At ``"block"`` and ``"none"`` the loss and every gradient are bitwise
  equal, for every trainable family (dense with local and softcapped
  attention, MoE with and without a virtual mesh, SSM, hybrid with its
  shared block, enc-dec with its encoder and cross-attention, the ViT
  prefix) over four loss chunks, and through each caller that takes
  gradients to leaves (the step builder, the CAMR trainer's map lane,
  the single-model ``Trainer``).
* The recompute is real and counted once: on ``meta`` and on the CPU a
  reduced granite train step at ``"block"`` peaks lower than at
  ``"none"`` and counts more FLOPs by exactly the recompute (each unit's
  forward products but its last, and each loss chunk's logits product);
  the roofline's ``useful_flops_ratio`` falls by the ratio of the two
  counts. A recompute repeats no host-side effect: no kernel launch
  and no collective is counted in a training forward.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.core.collective_stats import record_collectives
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.kernels import launch_counts
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.steps import build_step
from repro_torch.models import lm
from repro_torch.optim import tree_leaves
from repro_torch.runtime import MultiModelCAMRTrainer, Trainer

#: the trainable families' reduced configs (gemma2: local and global
#: attention with softcaps; zamba2: SSM sublayers and the shared block;
#: seamless: encoder and enc-dec decoder; internvl2: the ViT prefix)
FAMILIES = ["granite_3_2b", "gemma2_2b", "mixtral_8x7b", "mamba2_1p3b",
            "zamba2_2p7b", "seamless_m4t_large_v2", "internvl2_26b"]
#: 64 tokens in four loss chunks
T, B, CHUNK = 64, 2, 16


def _cfg(arch, remat, **kw):
    return configs.reduced(configs.get_config(arch)).replace(
        remat=remat, loss_chunk=CHUNK, **kw)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    batch["labels"][0, :5] = -1                 # ignored labels
    if cfg.frontend == "audio":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, T, cfg.frontend_dim)).astype(np.float32))
    if cfg.frontend == "vit":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32))
    return batch


def _loss_and_grads(cfg, mesh=None):
    params = lm.init_params(cfg, torch.Generator().manual_seed(3))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = lm.train_loss(cfg, params, _batch(cfg), mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    return [loss.detach(), metrics["moe_aux"].detach(), *grads]


def _bits(t):
    return t.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16}[t.element_size()])


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_remat_is_jax_for_every_arch(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.remat == jcfg.remat == "block"
    assert configs.reduced(cfg).remat == jconfigs.reduced(jcfg).remat
    assert cfg.replace(remat="none").remat == "none"


def test_other_remat_values_are_refused():
    cfg = configs.get_config("granite_3_2b")
    for bad in ("full", "Block", "", None):
        with pytest.raises(ValueError, match="remat"):
            cfg.replace(remat=bad)
    assert configs.REMAT_MODES == ("none", "block")


@pytest.mark.parametrize("arch", FAMILIES)
def test_block_gradients_bitwise_equal_none(arch):
    cfg = _cfg(arch, "block")
    assert T // cfg.loss_chunk == 4
    assert _bitwise(_loss_and_grads(cfg),
                    _loss_and_grads(cfg.replace(remat="none")))


@pytest.mark.parametrize("mode,mesh", [("ep", (2, 2)), ("ep", (1, 4)),
                                       ("tp", (2, 2))])
def test_moe_mesh_lanes_bitwise_equal_none(mode, mesh):
    """The virtual-mesh lanes of ``moe_block`` (``ep`` with the batch and
    the tokens split, ``tp``) under the unit's recompute."""
    cfg = _cfg("mixtral_8x7b", "block", moe_shard_mode=mode)
    assert _bitwise(_loss_and_grads(cfg, mesh),
                    _loss_and_grads(cfg.replace(remat="none"), mesh))


def test_every_gradient_caller_bitwise_equal_none():
    """The step builder's train step, the CAMR trainer's map row and the
    single-model ``Trainer``'s flat gradient: each takes gradients to
    leaves with ``torch.autograd.grad`` (which the reentrant checkpoint
    refuses), and each gives the same bits at both settings."""
    shape = configs.ShapeSpec("train_small", T, B, "train")
    out = {}
    pipe = ShardedTokenPipeline(vocab=256, seq_len=T, global_batch=B)
    for remat in ("block", "none"):
        cfg = _cfg("granite_3_2b", remat)
        bundle = build_step(cfg, shape, device="cpu")
        params, opt, batch = bundle.args
        batch.update(_batch(cfg))
        params, opt, m = bundle.fn(params, opt, batch)
        step = [m["loss"], m["gnorm"], *tree_leaves(params)]
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=0, device="cpu")
        tr._last_loss = [dict() for _ in range(tr.J)]
        row = tr._grad_vec(1, 0, pipe.batch(0))
        single = Trainer(cfg, seed=0, device="cpu")
        loss, g = single._loss_grad({k: torch.as_tensor(v) for k, v in
                                     pipe.batch(1).items()})
        out[remat] = (step, [row], [loss, g])
    for a, b in zip(out["block"], out["none"]):
        assert _bitwise(a, b)


def _trace(remat, device):
    shape = configs.ShapeSpec("train_small", T, 4, "train")
    cfg = configs.reduced(configs.get_config("granite_3_2b")).replace(
        remat=remat)
    return cfg, shape, dryrun.trace_step(build_step(cfg, shape,
                                                    device=device))


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_block_peaks_lower_and_counts_the_recompute(device):
    """Reduced granite's train step (64 tokens x 4, one loss chunk):
    the ``"block"`` trace peaks below the ``"none"`` trace and counts
    more FLOPs by the recompute alone: the forward's products less each
    unit's last MLP product (``w_down``, which no residual reads)."""
    cfg, shape, block = _trace("block", device)
    _, _, none = _trace("none", device)
    assert block["memory"]["peak_bytes"] < none["memory"]["peak_bytes"]
    assert block["memory"]["argument_bytes"] == \
        none["memory"]["argument_bytes"]
    params = lm.init_params(cfg, None, device="meta")
    batch = configs.input_specs(cfg, shape, device="meta")["batch"]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        lm.train_loss(cfg, params, batch)
    w_down = 2 * shape.global_batch * shape.seq_len * cfg.d_ff * cfg.d_model
    recompute = fc.get_total_flops() - cfg.repeats * w_down
    assert block["cost"]["flops"] - none["cost"]["flops"] == recompute > 0


def test_useful_flops_ratio_falls_by_the_recompute():
    shape = configs.ShapeSpec("train_small", T, 4, "train")
    red = configs.reduced(configs.get_config("granite_3_2b"))
    full = configs.get_config("granite_3_2b")
    kw = {f: getattr(red, f) for f in red.__dataclass_fields__
          if getattr(red, f) != getattr(full, f)}
    cells = {r: dryrun.run_cell("granite_3_2b", shape,
                                overrides={**kw, "remat": r})
             for r in ("block", "none")}
    assert cells["block"]["remat"] == "block"
    roof = {r: roofline.roofline_from_cell(c) for r, c in cells.items()}
    flops = {r: c["cost"]["flops"] for r, c in cells.items()}
    assert roof["block"].useful_flops_ratio < roof["none"].useful_flops_ratio
    assert roof["none"].useful_flops_ratio / roof["block"].useful_flops_ratio \
        == pytest.approx(flops["block"] / flops["none"], rel=1e-12)


def test_recompute_repeats_no_host_side_effect():
    """A training forward counts no kernel launch and no collective, so
    its recompute counts none twice: at ``"block"`` a step of the MoE
    family on a virtual mesh leaves the launch counters and the
    collective ledger as ``"none"`` does."""
    cfg = _cfg("mixtral_8x7b", "block")
    counts = {}
    for remat in ("block", "none"):
        before = launch_counts()
        with record_collectives() as coll:
            _loss_and_grads(cfg.replace(remat=remat), mesh=(2, 2))
        counts[remat] = (launch_counts(), coll.as_dict())
        assert counts[remat][0] == before
    assert counts["block"] == counts["none"]
    assert counts["block"][1]["total_bytes"] == 0
