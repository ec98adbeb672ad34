"""Training through a failed worker on the CPU: the port's
``MultiModelCAMRTrainer`` with a worker killed after step 2 and
rejoined after step 3, the twin of tests/test_elastic.py's trainer
churn.

* ``camr_spmd`` (the stream's degraded device executor) and ``camr``
  (the numpy ``DegradedCAMREngine``), on the f32 and bf16 lanes:
  parameters and losses BITWISE the uninterrupted run's (every degraded
  route folds in the healthy order), the stream's healthy executor
  built once, ``swaps`` 2;
* given the JAX trainer's per-subfile gradients of its own churned
  ``camr`` run, the port's ``camr`` wave and its degraded ``camr_spmd``
  sync give the JAX synced gradient of every step, bitwise;
* ``uncoded`` with a failed set raises, as JAX's does; the launcher's
  ``--failed`` runs.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import ShardedTokenPipeline
from repro.runtime.train_loop import MultiModelCAMRTrainer as JaxTrainer
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.runtime import MultiModelCAMRTrainer
from repro_torch.runtime.train_loop import CAMRTrainReport
from repro_torch.weights import params_from_jax

TINY = dict(n_layers=2, vocab=64, d_model=32, d_ff=64, n_heads=2,
            n_kv_heads=1, head_dim=16, loss_chunk=8)
#: failed set of each of the 4 steps: kill after step 2, rejoin after 3
CHURN = (None, None, {2}, None)


def _pipe():
    return ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)


def _cfg():
    # remat none: the subject is churn (tests/test_torch_remat.py holds
    # the default "block" bitwise to it)
    return reduced(get_config("granite_3_2b")).replace(remat="none", **TINY)


def _churn(tr, mode):
    """Four steps of ``tr`` under :data:`CHURN`; returns the losses."""
    losses = []
    for failed in CHURN:
        tr.set_failed(failed)
        losses += tr.train_steps(_pipe(), 1, mode=mode).losses
    return losses


def _bits(t):
    return t.contiguous().view(torch.int32)


def _torch_row(v):
    """A host memo row (f32, or bf16 bits as ``uint16``) as a flat torch
    row in the sync dtype."""
    v = np.ascontiguousarray(v).reshape(-1)
    if v.dtype == np.uint16:
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_trainer_kill_rejoin_bitwise(lane):
    cfg = _cfg()
    ref = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=0, device="cpu",
                                grad_sync_dtype=lane)
    ref_losses = ref.train_steps(_pipe(), 4, mode="camr_spmd").losses
    assert np.isfinite(ref_losses).all()
    for mode in ("camr_spmd", "camr"):
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=0, device="cpu",
                                   grad_sync_dtype=lane)
        losses = _churn(tr, mode)
        assert torch.equal(_bits(tr.flat), _bits(ref.flat)), mode
        assert losses == ref_losses, mode
        if mode == "camr_spmd":
            st = tr._stream.stats()
            assert st["compiles"] == 1 and st["widths"] == [1], st
            assert st["swaps"] == 2 and st["failed"] == (), st
            assert st["degraded_compiles"] <= 1, st


def test_trainer_built_degraded_then_restored():
    """``failed=`` at construction: the stream is first built under the
    failure (no healthy executor until the restore)."""
    cfg = _cfg()
    ref = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=1, device="cpu")
    ref_losses = ref.train_steps(_pipe(), 2, mode="camr_spmd").losses
    tr = MultiModelCAMRTrainer(cfg, q=2, k=3, seed=1, device="cpu",
                               failed={5})
    rep = tr.train_steps(_pipe(), 1, mode="camr_spmd")
    assert rep.sync["failed"] == (5,) and rep.sync["compiles"] == 0
    tr.failed = None                    # reconciled by the next step
    rep2 = tr.train_steps(_pipe(), 1, mode="camr_spmd")
    assert rep2.sync["failed"] == () and rep2.sync["compiles"] == 1
    assert torch.equal(_bits(tr.flat), _bits(ref.flat))
    assert rep.losses + rep2.losses == ref_losses


def test_uncoded_with_a_failed_set_raises():
    tr = MultiModelCAMRTrainer(_cfg(), q=2, k=3, device="cpu", failed={2})
    with pytest.raises(ValueError, match="no degraded mode"):
        tr.train_steps(_pipe(), 1, mode="uncoded")
    with pytest.raises(ValueError, match="uncoded baseline"):
        launch_train.main(["--arch", "granite_3_2b", "--reduced",
                           "--multi-model", "--grad-sync", "uncoded",
                           "--failed", "2", "--steps", "1", "--seq-len",
                           "8", "--batch", "2", "--device", "cpu"])


@pytest.mark.parametrize("mode", ["camr_spmd", "camr"])
def test_launcher_trains_with_a_failed_worker(mode, capsys):
    launch_train.main(["--arch", "granite_3_2b", "--reduced",
                       "--multi-model", "--grad-sync", mode, "--failed",
                       "2", "--steps", "2", "--seq-len", "8", "--batch",
                       "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f'"mode": "{mode}"' in out
    if mode == "camr_spmd":
        assert '"failed": [2]' in out and '"swaps": 1' in out


def _record_jax_churn(lane):
    """The JAX trainer's ``camr`` run under :data:`CHURN`, recording its
    per-subfile gradients and synced gradient of every step."""
    jcfg = jax_reduced(jax_get_config("granite_3_2b")).replace(**TINY)
    jtr = JaxTrainer(jcfg, q=2, k=3, seed=0, grad_sync_dtype=lane)
    init = [jax.tree.map(np.asarray, p) for p in jtr.params]
    grads, gsync = {}, {}
    grad_vec, sync = jtr._grad_vec, jtr._sync_interpreter

    def rec_grad(j, n, batch):
        g = grad_vec(j, n, batch)
        grads[(jtr.step, j, n)] = np.ascontiguousarray(g).copy()
        return g

    def rec_sync(map_fn, datasets, report):
        out = sync(map_fn, datasets, report)
        gsync[jtr.step] = np.ascontiguousarray(out).copy()
        return out

    jtr._grad_vec, jtr._sync_interpreter = rec_grad, rec_sync
    for failed in CHURN:
        jtr.set_failed(failed)
        jtr.train_steps(_pipe(), 1, mode="camr")
    return init, grads, gsync


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_churned_synced_gradient_bitwise_equals_jax(lane):
    init, grads, gsync = _record_jax_churn(lane)
    tr = MultiModelCAMRTrainer(_cfg(), q=2, k=3, device="cpu",
                               grad_sync_dtype=lane,
                               params=[params_from_jax(p, "cpu")
                                       for p in init])
    datasets = [[(n, None) for n in range(tr.N)] for _ in range(tr.J)]
    for step, failed in enumerate(CHURN):
        tr.set_failed(failed)
        g = {(j, n): grads[(step, j, n)] for j in range(tr.J)
             for n in range(tr.N)}
        host = {key: v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16
                else v for key, v in g.items()}
        want = gsync[step]
        want = want.view(np.uint16) if want.dtype.itemsize == 2 else want
        out = tr._sync_interpreter(lambda j, sf: host[(j, sf[0])],
                                   datasets, CAMRTrainReport())
        np.testing.assert_array_equal(out, want, err_msg=f"camr {step}")
        contribs = tr._build_contribs(
            lambda j, sf: _torch_row(host[(j, sf[0])]), datasets)
        spmd = tr._sync_spmd(contribs, CAMRTrainReport())
        bits = spmd.contiguous().view(
            torch.int16 if lane == "bfloat16" else torch.int32).numpy()
        np.testing.assert_array_equal(bits.view(want.dtype), want,
                                      err_msg=f"camr_spmd {step}")
    assert tr._stream.stats()["swaps"] == 2
