"""The port's training slice against the JAX package, on the CPU at a
tiny size: the flat parameter layout, the LM loss and its flat gradient,
the synced gradient of the coded gradient-sync step, and 3 training
steps of the trainer.

Tolerances, and why:

* flat layout (``ravel``/``unravel``): bitwise — pure data movement and
  the same round-to-nearest-even casts;
* loss rtol 1e-5, gradient rtol 1e-4 / atol 1e-6: the same f32 math,
  summed in other orders by XLA and by PyTorch's CPU kernels. The SSM
  and hybrid cases (reduced mamba2 and zamba2 at 80 tokens, two SSD
  chunks) hold each leaf's gradient at rtol 1e-4 and atol 1e-3 x that
  leaf's largest |gradient| (``SSM_GRAD_SCALE``): their backward passes
  lose more f32 digits than the dense ones — against an f64 evaluation
  of the same function (the port's code with every cast to f32 kept in
  f64), JAX's f32 gradient is off by up to 3.1e-4 x its leaf's largest
  element on zamba2 and 4.4e-5 on mamba2, and the port's by as much, so
  the elementwise 1e-4 / 1e-6 is beyond either package's own accuracy;
* synced gradient ``[K, J, d]``: bitwise, given the same per-subfile
  gradients — the alpha-combiner is exact with one row per segment, the
  XOR transport is lossless and assembly folds in the engine's order;
* 3 trainer steps: losses rtol 1e-4 (gradients differ at 1e-4 relative,
  see above), parameters atol 2e-5 (AdamW normalises each gradient
  element, so a relative gradient difference moves a parameter by at
  most about lr * 1e-4 per step, and the clip norm sums in another
  order);
* the bf16 grad-sync lane: the memo row is the round-to-nearest-even of
  the f32 row, bitwise; the synced gradient is bitwise the JAX bf16
  trainer's given the same per-subfile bf16 gradients; 3 steps match the
  JAX bf16 trainer's losses at rtol 1e-4 and parameters at atol
  BF16_PARAM_ATOL (see there);
* the multipass codec: the trainer's parameters after 2 steps are
  bitwise the fused codec trainer's (same map, bitwise the same synced
  gradient), and its synced gradient is bitwise that of the JAX trainer
  with ``codec="multipass"`` on a 6-device mesh, given its per-subfile
  gradients;
* the chunked attention lane (``seq_len`` 1536, past the switch point of
  1448): loss and flat gradient at the dense tolerances above;
* the paper's ``camr`` and ``uncoded`` wires: parameters and losses
  bitwise ``camr_spmd``'s on both lanes (one map, a lossless transport,
  one canonical combine order, one update), and given the JAX trainer's
  per-subfile gradients the port's host engines give its ``camr``
  synced gradient, bitwise, with the same wire bytes;
* the single-model ``Trainer``: 2 steps against JAX's, losses rtol 1e-5
  at step 1 (the same parameters) and 1e-4 at step 2, the learning rate
  bitwise (the same f32 schedule), parameters atol 2e-5 (as above).
"""

import json
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from repro.configs import get_config as jax_get_config
from repro.core import collective as jcoll
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import ShardedTokenPipeline
from repro.models import lm as jlm
from repro.runtime.train_loop import MultiModelCAMRTrainer as JaxTrainer
from repro_torch.configs import get_config, reduced
from repro_torch.core.collective import (ShuffleStream, camr_collective_bytes,
                                         make_plan)
from repro_torch.launch import cell
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.runtime import MultiModelCAMRTrainer, Trainer
from repro_torch.runtime.train_loop import CAMRTrainReport, _full_f32
from repro_torch.weights import flat_spec, params_from_jax, ravel, unravel
from test_torch_spans import PHASE_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reduced SSM and hybrid configs at the tiny pipeline's vocab
SSM_TINY = dict(vocab=64, loss_chunk=8)
#: the SSM and hybrid gradients' atol, a share of each leaf's largest
#: |gradient| (see the module docstring)
SSM_GRAD_SCALE = 1e-3
TINY = dict(n_layers=2, vocab=64, d_model=32, d_ff=64, n_heads=2,
            n_kv_heads=1, head_dim=16, loss_chunk=8)
# the other dense options the port's layers carry
VARIANT = dict(TINY, n_layers=4, pattern=("attn", "local"), local_window=4,
               attn_softcap=50.0, final_softcap=30.0, mlp_act="geglu",
               tie_embeddings=False, scale_embed=True, rope_theta=500.0)


def _cfgs(arch="granite_3_2b", **kw):
    """The same reduced config in both packages, the port's at
    ``remat="none"``: ``tests/test_torch_remat.py`` holds every family's
    gradients and every gradient caller bitwise equal at ``"block"`` and
    ``"none"``, and the checkpoint's per-tensor bookkeeping doubles a
    tiny step's CPU time."""
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced(get_config(arch)).replace(**{"remat": "none", **kw}))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _torch_bits(t):
    t = t.detach().contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        .numpy().view({2: np.uint16, 4: np.uint32}[t.element_size()])


@pytest.mark.parametrize("arch,kw", [("granite_3_2b", TINY),
                                     ("zamba2_2p7b", SSM_TINY)],
                         ids=["granite", "zamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ravel_matches_ravel_pytree(dtype, arch, kw):
    """``ravel`` / ``unravel`` against ``ravel_pytree`` on a dense tree and
    on a hybrid one (zamba2's shared block once, after ``out``)."""
    jcfg, _ = _cfgs(arch, **kw, dtype=dtype)
    p = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    flat, junravel = ravel_pytree(p)
    tp = params_from_jax(_np_tree(p), "cpu")
    got = ravel(tp)
    assert got.dtype == torch.float32 and np.asarray(flat).dtype == np.float32
    np.testing.assert_array_equal(_torch_bits(got), _bits(np.asarray(flat)))
    # unravel of a perturbed flat vector casts each leaf exactly as JAX's
    noise = np.random.default_rng(0).standard_normal(flat.shape) * 1e-3
    flat2 = (np.asarray(flat) + noise).astype(np.float32)
    want = _np_tree(junravel(jnp.asarray(flat2)))
    back = unravel(torch.from_numpy(flat2), flat_spec(tp))
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(jleaves) == len(flat_spec(tp).paths)
    for (path, leaf), tpath in zip(jleaves, flat_spec(tp).paths):
        assert tuple(k.key for k in path) == tpath
        node = back
        for key in tpath:
            node = node[key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(_torch_bits(node), _bits(leaf))


@pytest.mark.parametrize("arch,kw,seq_len", [
    ("granite_3_2b", TINY, 8), ("granite_3_2b", VARIANT, 8),
    ("mamba2_1p3b", SSM_TINY, 80), ("zamba2_2p7b", SSM_TINY, 80)],
    ids=["granite", "variant", "mamba2", "zamba2"])
def test_loss_and_flat_gradient_match_jax(arch, kw, seq_len):
    """The loss and its gradient w.r.t. the flat parameter vector against
    ``jax.value_and_grad``; the SSM and hybrid families train through the
    plain chunked scan on both sides (JAX's XLA lane), over two chunks
    of 64."""
    jcfg, cfg = _cfgs(arch, **kw)
    p = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    flat, junravel = ravel_pytree(p)
    batch = ShardedTokenPipeline(vocab=64, seq_len=seq_len,
                                 global_batch=2).batch(4)
    jloss, jgrad = jax.value_and_grad(
        lambda fl: jlm.train_loss(jcfg, junravel(fl),
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})[0])(flat)
    tp = params_from_jax(_np_tree(p), "cpu")
    row = ravel(tp).requires_grad_(True)
    loss, _ = lm.train_loss(cfg, unravel(row, flat_spec(tp)),
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got, want = row.grad.numpy(), np.asarray(jgrad)
    if arch == "granite_3_2b":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        return
    spec = flat_spec(tp)
    for path, off, size in zip(spec.paths, spec.offsets,
                               (int(np.prod(s)) for s in spec.shapes)):
        w = want[off:off + size]
        np.testing.assert_allclose(
            got[off:off + size], w, rtol=1e-4,
            atol=SSM_GRAD_SCALE * float(np.abs(w).max()), err_msg=str(path))


def _record_jax_run(arch="granite_3_2b", cfg_kw=TINY, steps=3, **kw):
    """``steps`` steps of the JAX trainer (mode="camr", the numpy engine
    wire — in-process, no mesh), recording its per-subfile gradients and
    its synced gradient of every step."""
    jcfg, cfg = _cfgs(arch, **cfg_kw)
    jtr = JaxTrainer(jcfg, q=2, k=3, seed=0, **kw)
    init = [_np_tree(p) for p in jtr.params]
    grads, gsync = {}, {}
    grad_vec, sync = jtr._grad_vec, jtr._sync_interpreter

    def rec_grad(j, n, batch):
        g = grad_vec(j, n, batch)
        grads[(jtr.step, j, n)] = g.copy()
        return g

    def rec_sync(map_fn, datasets, report):
        out = sync(map_fn, datasets, report)
        gsync[jtr.step] = out.copy()
        return out

    jtr._grad_vec, jtr._sync_interpreter = rec_grad, rec_sync
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    rep = jtr.train_steps(pipe, steps, mode="camr")
    return dict(trainer=jtr, cfg=cfg, init=init, grads=grads, gsync=gsync,
                losses=np.asarray(rep.losses), flat=np.asarray(jtr.flat))


@pytest.fixture(scope="module")
def jax_run():
    return _record_jax_run()


@pytest.fixture(scope="module")
def jax_run_bf16():
    """The bf16 twin: grad_sync_dtype="bfloat16" (memo rounded to bf16,
    the engine sums bf16)."""
    return _record_jax_run(grad_sync_dtype="bfloat16")


@pytest.fixture(scope="module")
def jax_run_zamba2():
    """One step of the JAX trainer on the reduced hybrid zamba2 (its
    SSD scans on the XLA lane, the shared block's gradient summed over
    its repeats)."""
    return _record_jax_run("zamba2_2p7b", SSM_TINY, steps=1)


def _port_trainer(jax_run, **kw):
    return MultiModelCAMRTrainer(
        jax_run["cfg"], q=2, k=3, device="cpu",
        params=[params_from_jax(p, "cpu") for p in jax_run["init"]], **kw)


def _from_np(a):
    """numpy f32 / ml_dtypes bf16 -> torch (bf16 through its bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def test_synced_gradient_bitwise_equals_jax(jax_run):
    _check_synced_gradient(jax_run)


def test_bf16_synced_gradient_bitwise_equals_jax(jax_run_bf16):
    """The bf16 lane: given the JAX bf16 trainer's per-subfile gradients,
    the bf16 combiner and the packed shuffle give its synced gradient."""
    _check_synced_gradient(jax_run_bf16, grad_sync_dtype="bfloat16")


def test_hybrid_synced_gradient_bitwise_equals_jax(jax_run_zamba2):
    """The hybrid family through the trainer: the flat layout (the shared
    block once) is the JAX trainer's, and given its per-subfile
    gradients the combiner and the shuffle give its synced gradient."""
    _check_synced_gradient(jax_run_zamba2, map_lane=False)
    tr = _port_trainer(jax_run_zamba2)
    assert sum(p[0] == "shared" for p in tr._spec.paths) == 9
    rep = tr.train_steps(ShardedTokenPipeline(vocab=64, seq_len=8,
                                              global_batch=2), 1)
    np.testing.assert_allclose(np.asarray(rep.losses),
                               jax_run_zamba2["losses"], rtol=1e-4)


def _check_synced_gradient(jax_run, map_lane=True, **kw):
    """Given the JAX trainer's per-subfile gradients, the port's combiner
    and shuffle give its synced gradient of every step, bitwise;
    ``map_lane`` also holds step 0's contributions to those of JAX's map
    lane (its Pallas combiner in interpret mode, slow at a large D)."""
    jtr = jax_run["trainer"]
    tr = _port_trainer(jax_run, **kw)
    assert (tr.D, tr.d_shard, tr.Dpad) == (jtr.D, jtr.d_shard, jtr.Dpad)
    init = np.stack([np.asarray(ravel_pytree(p)[0]) for p in jax_run["init"]])
    np.testing.assert_array_equal(_torch_bits(tr.flat[:, :tr.D]), _bits(init))
    assert not tr.flat[:, tr.D:].any()
    stream = ShuffleStream(2, 3, tr.d_shard, device="cpu")
    datasets = [[(n, None) for n in range(tr.N)] for _ in range(tr.J)]
    for step in range(len(jax_run["gsync"])):
        g = {(j, n): jax_run["grads"][(step, j, n)]
             for j in range(tr.J) for n in range(tr.N)}
        contribs = tr._build_contribs(
            lambda j, sf: _from_np(g[(j, sf[0])].reshape(-1)), datasets)
        assert contribs.dtype == getattr(torch, tr.grad_sync_dtype)
        if step == 0 and map_lane:   # JAX's, Pallas alpha-combiner included
            want = jtr._build_contribs(lambda j, sf: g[(j, sf[0])], datasets)
            np.testing.assert_array_equal(_torch_bits(contribs), _bits(want))
        out = stream.sync(contribs)
        np.testing.assert_array_equal(_torch_bits(out),
                                      _bits(jax_run["gsync"][step]),
                                      err_msg=f"step {step}")
    assert stream.stats()["compiles"] == 1


def test_trainer_three_steps_match_jax(jax_run):
    tr = _port_trainer(jax_run)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    rep = tr.train_steps(pipe, 3, mode="camr_spmd")
    assert tr.map_calls == 3 * tr.J * tr.N
    np.testing.assert_allclose(np.asarray(rep.losses), jax_run["losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(tr.flat.numpy(), jax_run["flat"], rtol=0,
                               atol=2e-5)
    assert rep.sync["dispatches"] == 3 and rep.sync["compiles"] == 1
    assert [list(ms) for ms in rep.phase_ms] == [PHASE_KEYS] * 3
    assert rep.bytes_total == 3 * jcoll.camr_collective_bytes(
        jcoll.make_plan(2, 3, tr.d_shard), dtype=np.float32)["camr_total"]


def test_bf16_memo_row_is_the_rounded_f32_row(jax_run):
    """The bf16 lane's memo row equals the ml_dtypes (JAX) rounding of the
    f32 lane's row for the same parameters and batch, bitwise."""
    f32, bf16 = (_port_trainer(jax_run, grad_sync_dtype=g)
                 for g in ("float32", "bfloat16"))
    batch = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2).batch(1)
    for tr in (f32, bf16):
        tr._last_loss = [dict() for _ in range(tr.J)]
    for j in range(f32.J):
        row32 = f32._grad_vec(j, 0, batch)
        row16 = bf16._grad_vec(j, 0, batch)
        assert row32.dtype == torch.float32 and row16.dtype == torch.bfloat16
        assert row16.shape == (bf16.Dpad,) and not row16[bf16.D:].any()
        want = row32.numpy()
        assert np.isfinite(want).all()
        np.testing.assert_array_equal(
            _torch_bits(row16), want.astype(ml_dtypes.bfloat16)
            .view(np.uint16))
        assert f32._last_loss[j][0] == bf16._last_loss[j][0]


#: parameters after 3 bf16-lane steps, against the JAX bf16 trainer. The
#: per-subfile gradients differ at about 1e-4 relative (see the module
#: docstring); rounding to bf16 turns a few of those into one-ulp
#: differences (2**-8 relative) of the memo rows, summed in bf16. AdamW's
#: m / sqrt(v) passes a relative gradient difference through, amplified
#: where an element's gradients of successive steps cancel in m; each
#: step moves a parameter by about lr = 1e-3 at most. The worst element
#: here differs by 6.4e-5 after 3 steps; the bound is three times that.
BF16_PARAM_ATOL = 2e-4


def test_bf16_trainer_three_steps_match_jax(jax_run_bf16):
    tr = _port_trainer(jax_run_bf16, grad_sync_dtype="bfloat16")
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    rep = tr.train_steps(pipe, 3, mode="camr_spmd")
    assert rep.grad_sync_dtype == "bfloat16" and tr.flat.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(rep.losses),
                               jax_run_bf16["losses"], rtol=1e-4)
    np.testing.assert_allclose(tr.flat.numpy(), jax_run_bf16["flat"],
                               rtol=0, atol=BF16_PARAM_ATOL)
    assert rep.sync["dispatches"] == 3 and rep.sync["compiles"] == 1
    jplan = jcoll.make_plan(2, 3, tr.d_shard)
    assert rep.bytes_total == 3 * jcoll.camr_collective_bytes(
        jplan, dtype="bfloat16")["camr_total"]
    # exactly half the f32 lane's where d_shard fills whole wire words
    # with no pad (the smoke cell's d_shard); here pad words make it more
    f32_bytes = jcoll.camr_collective_bytes(jplan, dtype=np.float32)
    assert 2 * rep.bytes_total > 3 * f32_bytes["camr_total"]
    cell = make_plan(2, 3, 37_095_084)    # the smoke cell's d_shard
    assert (2 * camr_collective_bytes(cell, dtype=torch.bfloat16)["camr_total"]
            == camr_collective_bytes(cell, dtype=torch.float32)["camr_total"]
            == 5_341_692_096)


def test_trainer_needs_a_card_or_an_explicit_cpu(monkeypatch, jax_run):
    _, cfg = _cfgs(**TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiModelCAMRTrainer(cfg, q=2, k=3)
    tr = _port_trainer(jax_run)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    assert MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu",
                                 failed={1}).failed == {1}
    tr.set_failed({2})
    assert tr.failed == {2}
    tr.set_failed(set())
    assert tr.failed is None
    with pytest.raises(ValueError, match="mode"):
        tr.train_steps(pipe, 1, mode="nope")
    with pytest.raises(ValueError, match="loss scaling"):
        MultiModelCAMRTrainer(cfg.replace(grad_sync_dtype="float16"),
                              q=2, k=3, device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu",
                              grad_sync_dtype="float64")
    tr16 = MultiModelCAMRTrainer(cfg.replace(grad_sync_dtype="bfloat16"),
                                 q=2, k=3, device="cpu")
    assert tr16.grad_sync_dtype == "bfloat16"


def test_full_f32_scope_restores_the_process_flags():
    """The trainer turns TF32 and reduced-precision bf16 reductions off
    only for its own steps; the flags are process-wide, so whatever the
    caller had set comes back afterwards, also when a step raises."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    names = ((mm, "allow_tf32"), (cudnn, "allow_tf32"),
             (mm, "allow_bf16_reduced_precision_reduction"))
    before = [getattr(o, n) for o, n in names]
    try:
        for o, n in names:
            setattr(o, n, True)
        with pytest.raises(KeyError):
            with _full_f32(torch.device("cuda")):
                assert [getattr(o, n) for o, n in names] == [False] * 3
                raise KeyError("a failing step")
        assert [getattr(o, n) for o, n in names] == [True] * 3
        with _full_f32(torch.device("cpu")):      # the CPU has no TF32
            assert [getattr(o, n) for o, n in names] == [True] * 3
    finally:
        for (o, n), v in zip(names, before):
            setattr(o, n, v)


def test_trainer_own_init_runs_and_launcher_points_at_roadmap(capsys):
    _, cfg = _cfgs(**TINY)
    tr = MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=1)
    assert tr.flat.shape == (tr.J, tr.Dpad)
    assert not torch.equal(tr.flat[0], tr.flat[1])   # one generator per job
    launch_train.main(["--arch", "granite_3_2b", "--reduced", "--multi-model",
                       "--grad-sync", "camr_spmd", "--steps", "1",
                       "--seq-len", "8", "--batch", "2", "--device", "cpu"])
    assert '"mode": "camr_spmd"' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="single-model"):
        launch_train.main(["--arch", "granite_3_2b", "--multi-model",
                           "--grad-sync", "camr", "--ckpt-dir", "ckpt"])
    with pytest.raises(SystemExit, match="--multi-model options"):
        launch_train.main(["--arch", "granite_3_2b", "--failed", "1"])


def test_launcher_runs_the_bf16_lane(capsys):
    launch_train.main(["--arch", "granite_3_2b", "--reduced", "--multi-model",
                       "--grad-sync", "camr_spmd", "--steps", "1",
                       "--seq-len", "8", "--batch", "2", "--device", "cpu",
                       "--grad-sync-dtype", "bfloat16"])
    out = capsys.readouterr().out
    assert '"grad_sync_dtype": "bfloat16"' in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite_3_2b", "--multi-model",
                           "--grad-sync", "camr_spmd",
                           "--grad-sync-dtype", "float16"])


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b"])
def test_launcher_trains_the_ssm_and_hybrid_families(capsys, monkeypatch,
                                                     arch):
    # the family's reduced config at remat none (tests/test_torch_remat.py
    # holds the default "block" bitwise to it)
    monkeypatch.setattr(launch_train, "reduced",
                        lambda c: reduced(c).replace(remat="none"))
    launch_train.main(["--arch", arch, "--reduced", "--multi-model",
                       "--grad-sync", "camr_spmd", "--steps", "1",
                       "--seq-len", "8", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    step = json.loads(lines[0])
    assert step["step"] == 1 and np.isfinite(step["losses"]).all()
    assert json.loads(lines[1])["mode"] == "camr_spmd"
    # make_cell takes the arch and the depth (at the
    # reduced width here: full width is the card's)
    monkeypatch.setattr(cell, "get_config",
                        lambda name: reduced(get_config(name)))
    tr, pipe = cell.make_cell("cpu", arch=arch, n_layers=6)
    assert tr.cfg.name == get_config(arch).name and tr.cfg.n_layers == 6
    assert (tr.q, tr.k, pipe.seq_len) == (cell.Q, cell.K, cell.SEQ_LEN)


def test_launcher_runs_the_multipass_codec(capsys):
    launch_train.main(["--arch", "granite_3_2b", "--reduced", "--multi-model",
                       "--grad-sync", "camr_spmd", "--steps", "1",
                       "--seq-len", "8", "--batch", "2", "--device", "cpu",
                       "--codec", "multipass"])
    assert '"codec": "multipass"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite_3_2b", "--multi-model",
                           "--grad-sync", "camr_spmd", "--codec", "nope"])


def test_multipass_trainer_equals_fused_trainer():
    _, cfg = _cfgs(**TINY)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    trs = {codec: MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=4,
                                        codec=codec)
           for codec in ("fused", "multipass")}
    reps = {codec: tr.train_steps(pipe, 2) for codec, tr in trs.items()}
    assert reps["multipass"].sync["codec"] == "multipass"
    assert reps["multipass"].losses == reps["fused"].losses
    assert torch.equal(trs["multipass"].flat.view(torch.int32),
                       trs["fused"].flat.view(torch.int32))
    assert reps["multipass"].bytes_total == reps["fused"].bytes_total
    with pytest.raises(ValueError, match="codec"):
        MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", codec="nope")


# one camr_spmd step of the JAX trainer with the multipass codec (its
# Pallas xor_fold / xor_decode in interpret mode) on a 6-device CPU mesh,
# recording its per-subfile gradients and its synced gradient
_RUN_JAX_TRAINER = textwrap.dedent("""
    import numpy as np
    from repro.configs import get_config, reduced
    from repro.data.pipeline import ShardedTokenPipeline
    from repro.runtime.train_loop import MultiModelCAMRTrainer
    cfg = reduced(get_config("granite_3_2b")).replace(**{tiny!r})
    tr = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=0, codec="multipass",
                               use_kernels=True)
    out = {{}}
    grad_vec, sync = tr._grad_vec, tr._sync_spmd
    def rec_grad(j, n, batch):
        g = grad_vec(j, n, batch)
        out[f"g{{j}}_{{n}}"] = np.array(g)
        return g
    def rec_sync(map_fn, datasets, report):
        res = sync(map_fn, datasets, report)
        out["gsync"] = np.asarray(res)
        return res
    tr._grad_vec, tr._sync_spmd = rec_grad, rec_sync
    rep = tr.train_steps(ShardedTokenPipeline(vocab=64, seq_len=8,
                                              global_batch=2), 1,
                         mode="camr_spmd")
    assert rep.sync["dispatches"] == 1, rep.sync
    np.savez({path!r}, **out)
    print("OK")
""")


def test_multipass_synced_gradient_bitwise_equals_jax_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    path = str(tmp_path / "run.npz")
    res = subprocess.run(
        [sys.executable, "-c", _RUN_JAX_TRAINER.format(tiny=TINY, path=path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    run = np.load(path)
    _, cfg = _cfgs(**TINY)
    tr = MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu",
                               codec="multipass")
    datasets = [[(n, None) for n in range(tr.N)] for _ in range(tr.J)]
    contribs = tr._build_contribs(
        lambda j, sf: torch.from_numpy(run[f"g{j}_{sf[0]}"].reshape(-1)),
        datasets)
    report = CAMRTrainReport()
    out = tr._sync_spmd(contribs, report)
    assert report.sync["codec"] == "multipass"
    np.testing.assert_array_equal(_torch_bits(out), _bits(run["gsync"]))


def test_unported_modes_point_at_their_roadmap_item(jax_run):
    """Nothing of the process lane is left unported (ROADMAP.md, Queue 1
    item 10b, done): it refuses exactly what the stacked lane refuses,
    with the same messages, and on a one-process mesh its looped
    exchange, verified wire and fault injection are the stacked
    shuffle's. Checkpointing (item 9) is ported: the multi-model launcher
    refuses its options, as it does not checkpoint. Failed workers
    (items 5-6) are ported: the trainer takes a failed set at
    construction and between steps."""
    from repro_torch.core.collective import camr_shuffle
    from repro_torch.launch.mesh import CAMRMesh, make_camr_mesh
    plan = make_plan(2, 3, 6)
    mesh = CAMRMesh(K=6, world=2, rank=0, device=torch.device("cpu"))
    block, full = torch.zeros((3, 2, 2, 6, 6)), torch.zeros((6, 2, 2, 6, 6))
    for kw, what in ((dict(mode="looped", codec="x"), "unknown codec"),
                     (dict(verify_wire=True, codec="multipass"),
                      "verify_wire requires"),
                     (dict(verify_wire=True, debug=True), "exclusive"),
                     (dict(corrupt=(1, 0, 0, 0, 1)), "without verify_wire")):
        for c, m in ((block, mesh), (full, None)):
            with pytest.raises(ValueError, match=what):
                camr_shuffle(plan, c, mesh=m, **kw)
    one = make_camr_mesh(6, device="cpu")
    for kw in (dict(mode="looped"), dict(verify_wire=True),
               dict(verify_wire=True, corrupt=(1, 0, 0, 0, 1))):
        got, want = (camr_shuffle(plan, full, mesh=m, **kw)
                     for m in (one, None))
        for g, w in zip(*((x if isinstance(x, tuple) else (x,))
                          for x in (got, want))):
            assert torch.equal(g, w), kw
    with pytest.raises(SystemExit, match="single-model"):
        launch_train.main(["--arch", "granite_3_2b", "--multi-model",
                           "--grad-sync", "camr", "--resume"])
    tr = _port_trainer(jax_run)
    tr.set_failed({0})
    assert tr.failed == {0}
    assert _port_trainer(jax_run, failed=[3]).failed == {3}
    assert Trainer(jax_run["cfg"], device="cpu",
                   ckpt_dir="ckpt").ckpt is not None


_JAX_ORACLE = textwrap.dedent("""
    import json
    from repro.configs import get_config, reduced
    from repro.data.pipeline import ShardedTokenPipeline
    from repro.runtime.train_loop import MultiModelCAMRTrainer

    cfg = reduced(get_config("granite_3_2b")).replace(**{tiny})
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    out = {{}}
    for lane in ("float32", "bfloat16"):
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=0, spmd_oracle=True,
                                   grad_sync_dtype=lane)
        rep = tr.train_steps(pipe, 2, mode="camr_spmd")
        out[lane] = dict(loads=rep.loads, bytes_total=rep.bytes_total)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_oracle():
    """JAX's ``spmd_oracle=True`` trainer, 2 ``camr_spmd`` steps on a
    6-device subprocess mesh, per lane: its loads and bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    res = subprocess.run([sys.executable, "-c",
                          _JAX_ORACLE.format(tiny=repr(TINY))],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_spmd_oracle_matches_jax_and_catches_a_flipped_bit(lane, jax_oracle,
                                                          monkeypatch):
    """``spmd_oracle=True``: 2 ``camr_spmd`` steps with the numpy engine
    beside the shuffle give the JAX oracle run's loads and bytes, the
    parameters of the run without the oracle bitwise, and a device result
    with one flipped bit raises the engine oracle's ``AssertionError``."""
    _, cfg = _cfgs(**TINY)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    trs = {}
    for oracle in (True, False):
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=0,
                                   grad_sync_dtype=lane, spmd_oracle=oracle)
        trs[oracle] = (tr, tr.train_steps(pipe, 2, mode="camr_spmd"))
    tr, rep = trs[True]
    assert rep.loads == jax_oracle[lane]["loads"]
    assert rep.bytes_total == jax_oracle[lane]["bytes_total"]
    assert rep.loads["L_total_bus"] == pytest.approx(1.0)
    assert torch.equal(tr.flat.view(torch.int32),
                       trs[False][0].flat.view(torch.int32))
    assert rep.losses == trs[False][1].losses
    stream = tr._spmd_stream()
    sync = stream.sync

    def flipped(contribs):
        out = sync(contribs).clone()
        out.view(torch.int16).view(-1)[7] ^= 1
        return out

    monkeypatch.setattr(stream, "sync", flipped)
    with pytest.raises(AssertionError, match="diverged from the engine "
                                             "oracle"):
        tr.train_steps(pipe, 1, mode="camr_spmd")


def test_chunked_lane_loss_and_flat_gradient_match_jax():
    """Reduced granite at ``seq_len`` 1536, past the 1448 switch point:
    both packages train through their chunked attention lane (the port's
    counted here); loss and flat gradient at the dense tolerances."""
    from repro_torch.kernels import ops
    jcfg, cfg = _cfgs(**dict(TINY, loss_chunk=512))
    p = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    flat, junravel = ravel_pytree(p)
    batch = ShardedTokenPipeline(vocab=64, seq_len=1536,
                                 global_batch=1).batch(2)
    jloss, jgrad = jax.value_and_grad(
        lambda fl: jlm.train_loss(jcfg, junravel(fl),
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})[0])(flat)
    tp = params_from_jax(_np_tree(p), "cpu")
    row = ravel(tp).requires_grad_(True)
    calls = []
    real = ops.flash_attention_chunked
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "flash_attention_chunked",
               lambda *a, **kw: calls.append(1) or real(*a, **kw))
    try:
        loss, _ = lm.train_loss(cfg, unravel(row, flat_spec(tp)),
                                {k: torch.from_numpy(v) for k, v in
                                 batch.items()})
    finally:
        mp.undo()
    assert len(calls) == cfg.n_layers
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(row.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_camr_spmd_camr_and_uncoded_are_bitwise_equal(lane):
    """The paper's three wires from one seed, 2 steps: parameters and
    losses bitwise equal on each grad-sync lane (the twin of
    tests/test_train_loop.py's cross-mode identity); the engines' bytes
    are the paper's loads (camr 1.0, uncoded 1.5), the bf16 camr bytes
    exactly half the f32 ones."""
    _, cfg = _cfgs(**TINY)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    runs = {}
    for mode in ("camr_spmd", "camr", "uncoded"):
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=6,
                                   grad_sync_dtype=lane)
        rep = tr.train_steps(pipe, 2, mode=mode)
        assert rep.mode == mode and tr.map_calls == 2 * tr.J * tr.N
        runs[mode] = (tr, rep)
    tr0, rep0 = runs["camr_spmd"]
    for mode in ("camr", "uncoded"):
        tr, rep = runs[mode]
        assert torch.equal(tr.flat.view(torch.int32),
                           tr0.flat.view(torch.int32)), mode
        assert rep.losses == rep0.losses, mode
        assert [list(ms) for ms in rep.phase_ms] == [PHASE_KEYS] * 2
    camr, unc = runs["camr"][1], runs["uncoded"][1]
    assert camr.loads["L_total_bus"] == pytest.approx(1.0)
    assert unc.loads["L_total_bus"] == pytest.approx(1.5)
    assert 3 * camr.bytes_total == 2 * unc.bytes_total
    width = {"float32": 4, "bfloat16": 2}[lane]
    # bus bytes of a step: L * J * Q * B, B = d_shard values of the lane
    assert camr.bytes_total == 2 * tr0.J * tr0.K * tr0.d_shard * width


def _host_grads(jax_run, step):
    """The JAX trainer's per-subfile gradients of one step as the port's
    host engines take them: f32, or the bf16 bit patterns."""
    out = {}
    for (st, j, n), g in jax_run["grads"].items():
        if st == step:
            g = np.ascontiguousarray(g)
            out[(j, n)] = g.view(np.uint16) if g.dtype.itemsize == 2 else g
    return out


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_camr_mode_synced_gradient_bitwise_equals_jax(lane, request):
    """Given the JAX trainer's per-subfile gradients (its ``camr`` run),
    the port's JobStream wave and its uncoded engine give its synced
    gradient of every step bitwise, and the camr wave its wire bytes."""
    jax_run = request.getfixturevalue(
        {"float32": "jax_run", "bfloat16": "jax_run_bf16"}[lane])
    tr = _port_trainer(jax_run, grad_sync_dtype=lane)
    jtr = jax_run["trainer"]
    datasets = [[(n, None) for n in range(tr.N)] for _ in range(tr.J)]
    for step in range(len(jax_run["gsync"])):
        g = _host_grads(jax_run, step)
        want = _bits(jax_run["gsync"][step])
        for sync in (tr._sync_interpreter, tr._sync_uncoded):
            report = CAMRTrainReport()
            out = sync(lambda j, sf: g[(j, sf[0])], datasets, report)
            assert out.dtype == {"float32": np.float32,
                                 "bfloat16": np.uint16}[lane]
            np.testing.assert_array_equal(_bits(out), want,
                                          err_msg=f"step {step}")
            if sync == tr._sync_interpreter:
                assert report.bytes_total == _jax_camr_step_bytes(jtr, lane)
        back = tr._device_sync(out)
        assert back.dtype == getattr(torch, lane)
        np.testing.assert_array_equal(_torch_bits(back), want)


def _jax_camr_step_bytes(jtr, lane):
    """The wire bytes of one step of the JAX trainer's camr wave (they
    depend on the shapes only)."""
    from repro.core.engine import CAMRConfig as JCfg
    from repro.runtime.jobstream import JobSpec as JSpec
    from repro.runtime.jobstream import JobStream as JStream
    dt = np.float32 if lane == "float32" else ml_dtypes.bfloat16
    row = np.zeros((jtr.K, jtr.d_shard), dt)
    spec = JSpec(JCfg(q=2, k=3, gamma=1), lambda j, sf: row,
                 [[None] * 3 for _ in range(4)], value_dtype=dt)
    stream = JStream(pipeline=False)
    stream.run([spec])
    return stream.last_engines[0].trace.total_bytes()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_single_model_trainer_matches_jax(microbatches):
    """2 steps of the single-model loop against JAX's ``Trainer`` from
    its initial parameters, with and without gradient accumulation."""
    from repro.runtime.train_loop import Trainer as JaxSingleTrainer
    jcfg, cfg = _cfgs(**TINY)
    jcfg = jcfg.replace(microbatches=microbatches)
    kw = dict(lr=1e-3, warmup=1, total_steps=4)
    jtr = JaxSingleTrainer(jcfg, seed=3, **kw)
    tr = Trainer(cfg, params=params_from_jax(_np_tree(jtr.params), "cpu"),
                 microbatches=microbatches, device="cpu", **kw)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=4)
    want = jtr.run(pipe, 2, log_every=1)
    got = tr.run(pipe, 2, log_every=1)
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w, rtol in zip(got, want, (1e-5, 1e-4)):
        assert g["lr"] == w["lr"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=rtol)
        np.testing.assert_allclose(g["gnorm"], w["gnorm"], rtol=1e-4)
    jflat = np.asarray(ravel_pytree(jtr.params)[0])
    np.testing.assert_allclose(tr.flat[0].numpy(), jflat, rtol=0, atol=2e-5)
    assert tr.step == jtr.step == 2


def test_single_model_trainer_keeps_each_leaf_in_its_dtype():
    """With bf16 weights the loop keeps them bf16 values after an update
    (its f32 state rounded per leaf, as the JAX loop casts each leaf
    back), its norms f32; the launcher runs it."""
    _, cfg = _cfgs(**dict(TINY, dtype="bfloat16"))
    tr = Trainer(cfg, device="cpu", seed=1, lr=1e-2, warmup=1)
    before = tr.flat.clone()
    tr.run(ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2), 1)
    assert not torch.equal(tr.flat, before)
    leaves = dict(zip(tr._spec.paths, _leaves(tr.params)))
    assert leaves[("embed",)].dtype == torch.bfloat16
    assert leaves[("norm_f",)].dtype == torch.float32
    assert torch.equal(ravel(tr.params), tr.flat[0])


def _leaves(params):
    from repro_torch.weights import leaves
    return [leaf for _, leaf in leaves(params)]


def test_launcher_runs_the_host_wires_and_the_single_model_loop(capsys,
                                                                monkeypatch):
    for mode in ("camr", "uncoded"):
        launch_train.main(["--arch", "granite_3_2b", "--reduced",
                           "--multi-model", "--grad-sync", mode, "--steps",
                           "1", "--seq-len", "8", "--batch", "2",
                           "--device", "cpu"])
        last = json.loads(capsys.readouterr().out.splitlines()[-2])
        assert last["mode"] == mode and last["peak_memory_bytes"] is None
        assert last["loads"]["L_total_bus"] == {"camr": 1.0,
                                                "uncoded": 1.5}[mode]
    launch_train.main(["--arch", "granite_3_2b", "--reduced", "--steps", "2",
                       "--seq-len", "16", "--batch", "4", "--microbatches",
                       "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["step"] for x in lines[:2]] == [1, 2]
    for argv in (["--grad-sync", "uncoded"], ["--multi-model"],
                 ["--grad-sync-dtype", "bfloat16"]):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", "granite_3_2b", *argv])
    monkeypatch.setattr(cell, "get_config",
                        lambda name: reduced(get_config(name)))
    tr, pipe = cell.make_cell("cpu", seq_len=2048)
    assert pipe.seq_len == 2048 and tr.cfg.n_layers == cell.N_LAYERS
