"""The port's checkpointing against the JAX package, on the CPU.

* twins of tests/test_substrate.py's checkpoint tests and of
  tests/test_train_loop.py's manager tests (roundtrip with int32 and bf16
  leaves, corruption detected, a corrupt resume falling back to the
  newest intact step while an explicit step raises, async retention,
  temp directories, writer errors);
* the format in both directions: a directory written by
  ``repro.checkpoint.save_checkpoint`` loads in the port, and one the
  port writes loads in JAX, bitwise for f32, int32 and bf16 leaves, with
  equal manifests (keys, shapes, dtype strings, sha256 and crc32);
* the trainers: a directory JAX's ``Trainer`` wrote has the port's key
  set and resumes in the port's ``Trainer`` bitwise, and the reverse;
  3 further steps stay within tests/test_torch_train.py's single-model
  tolerance of JAX's uninterrupted 6-step run (losses rtol 1e-4,
  parameters atol 2e-5);
* port-only: crash-resume bitwise the uninterrupted run (f32 and bf16
  weights), an async save followed at once by in-place updates still
  writes the values at save time, and the launcher's ``--ckpt-dir`` /
  ``--ckpt-every`` / ``--resume``.
"""

import json
import os
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import ShardedTokenPipeline
from repro.runtime.train_loop import Trainer as JaxTrainer
from repro_torch.checkpoint import (CheckpointManager, available_steps,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint import ckpt as pckpt
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamWState
from repro_torch.runtime import Trainer
from repro_torch.weights import params_from_jax

#: the reduced 2-layer granite of tests/test_substrate.py's crash-resume
CFG_KW = dict(n_layers=2, vocab=64, loss_chunk=16)
#: JAX's Trainer defaults (lr 3e-4, warmup 20) at a 50-step schedule
TRAIN_KW = dict(total_steps=50)


def _pipe():
    return ShardedTokenPipeline(vocab=64, seq_len=16, global_batch=4)


def _cfgs(**kw):
    kw = dict(CFG_KW, **kw)
    # the port at remat none (tests/test_torch_remat.py holds the default
    # "block" bitwise to it)
    return (jax_reduced(jax_get_config("granite_3_2b")).replace(**kw),
            reduced(get_config("granite_3_2b")).replace(
                **{"remat": "none", **kw}))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tbits(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


# --------------------------------------------------------------------- #
# twins of tests/test_substrate.py
# --------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.full((4,), -1.5, dtype=torch.bfloat16),
                  "d": np.arange(3, dtype=np.float32)}}
    save_checkpoint(str(tmp_path), tree, step=7, metadata={"x": 1})
    like = {"a": torch.zeros(2, 3, dtype=torch.int32),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16),
                  "d": np.zeros(3, np.float32)}}
    got, meta = load_checkpoint(str(tmp_path), like)
    assert torch.equal(got["a"], tree["a"]) and got["a"].dtype == torch.int32
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(got["b"]["d"], tree["b"]["d"])
    assert meta["x"] == 1 and meta["step"] == 7
    # a numpy caller gets bf16 back as its uint16 bits
    got, _ = load_checkpoint(str(tmp_path), {"a": np.zeros((2, 3)),
                                             "b": {"c": np.zeros(4),
                                                   "d": np.zeros(3)}})
    assert got["b"]["c"].dtype == np.uint16
    np.testing.assert_array_equal(got["b"]["c"], _tbits(tree["b"]["c"]))


def _flip_first_leaf(d):
    fn = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    raw = np.load(os.path.join(d, fn))
    raw[0] ^= 0xFF
    np.save(os.path.join(d, fn), raw)


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.arange(4.0)}
    d = save_checkpoint(str(tmp_path), tree, step=1)
    _flip_first_leaf(d)
    with pytest.raises(IOError), \
            pytest.warns(RuntimeWarning, match="failed verification"):
        load_checkpoint(str(tmp_path), tree)


def test_checkpoint_corrupt_resume_falls_back_to_intact(tmp_path):
    tree = {"a": torch.arange(4.0)}
    d1 = save_checkpoint(str(tmp_path), {"a": torch.full((4,), 1.0)}, step=1)
    d2 = save_checkpoint(str(tmp_path), {"a": torch.full((4,), 2.0)}, step=2)
    d3 = save_checkpoint(str(tmp_path), {"a": torch.full((4,), 3.0)}, step=3)
    assert all("crc32" in e for e in _manifest(d1)["leaves"].values())
    _flip_first_leaf(d3)
    os.remove(os.path.join(
        d2, [f for f in os.listdir(d2) if f.endswith(".npy")][0]))
    with pytest.warns(RuntimeWarning, match="failed verification"):
        got, meta = load_checkpoint(str(tmp_path), tree)
    assert meta["step"] == 1 and float(got["a"][0]) == 1.0
    with pytest.raises(IOError):
        load_checkpoint(str(tmp_path), tree, step=3)
    with pytest.raises(IOError):
        load_checkpoint(str(tmp_path), tree, step=2)


def test_checkpoint_manager_async_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save({"w": torch.full((3,), float(s))}, step=s)
    mgr.wait()
    assert mgr.latest_step() == 4
    got, _ = mgr.restore({"w": torch.zeros(3)})
    assert float(got["w"][0]) == 4.0
    assert available_steps(str(tmp_path)) == [3, 4]
    assert [r["step"] for r in mgr.stats] == [1, 2, 3, 4]
    assert all(r["bytes"] == 12 and r["write_s"] >= 0 for r in mgr.stats)
    mgr.close()


# --------------------------------------------------------------------- #
# twins of tests/test_train_loop.py's manager tests
# --------------------------------------------------------------------- #
def test_available_steps_skips_tmp_dirs(tmp_path):
    os.makedirs(tmp_path / "step_00000003")
    (tmp_path / "step_00000003" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_00000007.tmp.12345")
    os.makedirs(tmp_path / "step_00000002.tmp.1")
    assert available_steps(str(tmp_path)) == [3]


def test_gc_reaps_orphaned_tmp_dirs(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    orphan = tmp_path / f"step_00000001.tmp.{dead.pid}"
    os.makedirs(orphan)
    (orphan / "junk.npy").write_bytes(b"x")
    old = time.time() - 2 * CheckpointManager.STALE_TMP_SECS
    os.utime(orphan, (old, old))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save({"w": torch.zeros(3)}, step=1)
    mgr.wait()
    assert not orphan.exists()
    assert available_steps(str(tmp_path)) == [1]
    mgr.close()


def test_gc_keeps_fresh_and_own_tmp_dirs(tmp_path):
    mine = tmp_path / f"step_00000009.tmp.{os.getpid()}"
    os.makedirs(mine)
    fresh_foreign = tmp_path / "step_00000008.tmp.999999"
    os.makedirs(fresh_foreign)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save({"w": torch.zeros(3)}, step=1)
    mgr.wait()
    assert mine.exists() and fresh_foreign.exists()
    mgr.close()


def test_checkpoint_manager_wait_reraises(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("torn write")

    monkeypatch.setattr(pckpt, "save_checkpoint", boom)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": torch.zeros(2)}, step=1)
    with pytest.raises(RuntimeError, match="torn write"):
        mgr.wait()
    mgr.close()


def test_async_checkpoint_error_surfaces_in_run(tmp_path, monkeypatch):
    _, cfg = _cfgs(vocab=32)
    tr = Trainer(cfg, ckpt_dir=str(tmp_path), device="cpu", **TRAIN_KW)

    def boom(*a, **kw):
        raise IOError("disk full")

    monkeypatch.setattr(pckpt, "save_checkpoint", boom)
    with pytest.raises(IOError, match="disk full"):
        tr.run(ShardedTokenPipeline(vocab=32, seq_len=8, global_batch=2),
               steps=2, ckpt_every=2)


# --------------------------------------------------------------------- #
# the format, both directions
# --------------------------------------------------------------------- #
def _mixed_tree(rng):
    """One tree in both packages' leaf types: f32, int32 and bf16 leaves,
    nested dicts, a list, and the optimiser state's dataclass (a
    NamedTuple in JAX)."""
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    f32[0, 0] = -0.0
    i32 = rng.integers(-2**31, 2**31, size=(4,), dtype=np.int64).astype(
        np.int32)
    bf = rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16)
    mu = rng.standard_normal((7,)).astype(np.float32)
    step = np.int32(5)
    from repro.optim import AdamWState as JaxAdamWState
    jtree = {"params": {"w": f32, "b16": bf, "layers": [i32, f32[1]]},
             "opt": JaxAdamWState(step=np.asarray(step), mu={"w": mu},
                                  nu={"w": mu * 2})}
    ttree = {"params": {"w": torch.from_numpy(f32.copy()),
                        "b16": torch.from_numpy(bf.view(np.int16).copy())
                        .view(torch.bfloat16),
                        "layers": [torch.from_numpy(i32.copy()),
                                   torch.from_numpy(f32[1].copy())]},
             "opt": AdamWState(step=torch.tensor(5, dtype=torch.int32),
                               mu={"w": torch.from_numpy(mu.copy())},
                               nu={"w": torch.from_numpy(mu * 2)})}
    return jtree, ttree


def test_leaf_keys_are_jax_keys():
    jtree, ttree = _mixed_tree(np.random.default_rng(0))
    assert list(pckpt._flatten(ttree)) == list(jckpt._flatten(jtree))
    assert "opt].step" in pckpt._flatten(ttree)
    assert "params.layers.0" in pckpt._flatten(ttree)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_format_is_jax_format(tmp_path, direction):
    """Save in one package, load in the other: every leaf bitwise in its
    dtype (f32 with -0.0, int32, bf16), and the manifest each package
    writes for the same tree is the same document."""
    jtree, ttree = _mixed_tree(np.random.default_rng(1))
    dj = jckpt.save_checkpoint(str(tmp_path / "j"), jtree, step=9,
                               metadata={"pipeline_step": 9})
    dp = save_checkpoint(str(tmp_path / "p"), ttree, step=9,
                         metadata={"pipeline_step": 9})
    assert _manifest(dj) == _manifest(dp)
    if direction == "jax_to_port":
        got, meta = load_checkpoint(str(tmp_path / "j"), ttree)
        want = pckpt._flatten(ttree)
        for key, leaf in pckpt._flatten(got).items():
            assert leaf.dtype == want[key].dtype, key
            np.testing.assert_array_equal(_tbits(leaf), _tbits(want[key]),
                                          err_msg=key)
    else:
        got, meta = jckpt.load_checkpoint(str(tmp_path / "p"), jtree)
        want = jckpt._flatten(jtree)
        for key, leaf in jckpt._flatten(got).items():
            assert leaf.dtype == np.asarray(want[key]).dtype, key
            np.testing.assert_array_equal(_bits(leaf),
                                          _bits(np.asarray(want[key])),
                                          err_msg=key)
    assert meta == {"pipeline_step": 9, "step": 9}


# --------------------------------------------------------------------- #
# the trainers, both directions
# --------------------------------------------------------------------- #
def _jflat(tree):
    return np.asarray(ravel_pytree(tree)[0])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's ``Trainer`` from seed 1: 3 steps saved at step 3, then 3 more
    (its uninterrupted 6-step run); the state at steps 0, 3 and 6."""
    jcfg, cfg = _cfgs()
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jt = JaxTrainer(jcfg, ckpt_dir=d, seed=1, **TRAIN_KW)
    init = jax.tree.map(np.asarray, jt.params)
    metrics = jt.run(_pipe(), steps=3, ckpt_every=3, log_every=1)
    at3 = dict(flat=_jflat(jt.params), mu=_jflat(jt.opt.mu),
               nu=_jflat(jt.opt.nu), step=int(jt.opt.step))
    metrics += jt.run(_pipe(), steps=3, log_every=1)
    return dict(cfg=cfg, dir=d, init=init, at3=at3, flat6=_jflat(jt.params),
                losses=[m["loss"] for m in metrics], trainer=jt)


def test_port_trainer_resumes_a_jax_trainer_checkpoint(jax_run):
    tr = Trainer(jax_run["cfg"], ckpt_dir=jax_run["dir"], seed=999,
                 device="cpu", **TRAIN_KW)
    on_disk = set(_manifest(os.path.join(jax_run["dir"], "step_00000003"))
                  ["leaves"])
    assert set(pckpt._flatten(tr.state_tree())) == on_disk
    assert len(on_disk) == 34
    assert tr.resume() and tr.step == 3
    at3 = jax_run["at3"]
    np.testing.assert_array_equal(_tbits(tr.flat[0]), _bits(at3["flat"]))
    np.testing.assert_array_equal(_tbits(tr.opt.mu[0]), _bits(at3["mu"]))
    np.testing.assert_array_equal(_tbits(tr.opt.nu[0]), _bits(at3["nu"]))
    assert int(tr.opt.step[0]) == at3["step"] == 3
    metrics = tr.run(_pipe(), steps=3, log_every=1)
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               jax_run["losses"][3:], rtol=1e-4)
    np.testing.assert_allclose(tr.flat[0].numpy(), jax_run["flat6"], rtol=0,
                               atol=2e-5)


def test_jax_trainer_resumes_a_port_trainer_checkpoint(jax_run, tmp_path):
    tr = Trainer(jax_run["cfg"], ckpt_dir=str(tmp_path), device="cpu",
                 params=params_from_jax(jax_run["init"], "cpu"), **TRAIN_KW)
    tr.run(_pipe(), steps=3, ckpt_every=3)
    at3 = (tr.flat[0].clone(), tr.opt.mu[0].clone(), tr.opt.nu[0].clone())
    jcfg, _ = _cfgs()
    jt = JaxTrainer(jcfg, ckpt_dir=str(tmp_path), seed=999, **TRAIN_KW)
    assert jt.resume() and jt.step == 3 and int(jt.opt.step) == 3
    for got, want in zip((jt.params, jt.opt.mu, jt.opt.nu), at3):
        np.testing.assert_array_equal(_bits(_jflat(got)), _tbits(want))
    metrics = jt.run(_pipe(), steps=3, log_every=1)
    tr.run(_pipe(), steps=3)
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               jax_run["losses"][3:], rtol=1e-4)
    for want in (jax_run["flat6"], tr.flat[0].numpy()):
        np.testing.assert_allclose(_jflat(jt.params), want, rtol=0,
                                   atol=2e-5)


# --------------------------------------------------------------------- #
# port-only
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crash_resume_is_bitwise_the_uninterrupted_run(tmp_path, dtype):
    """Save at steps 2 and 4, "crash", resume in a trainer of another
    seed, run 2 more steps: the row, the moments and the losses are
    bitwise those of 6 uninterrupted steps (bf16 weights: the row holds
    each leaf rounded to its dtype)."""
    _, cfg = _cfgs(dtype=dtype)
    straight = Trainer(cfg, seed=3, device="cpu", **TRAIN_KW)
    want = straight.run(_pipe(), steps=6, log_every=1)
    t1 = Trainer(cfg, ckpt_dir=str(tmp_path), seed=3, device="cpu",
                 **TRAIN_KW)
    t1.run(_pipe(), steps=4, ckpt_every=2)
    assert available_steps(str(tmp_path)) == [2, 4]
    t2 = Trainer(cfg, ckpt_dir=str(tmp_path), seed=1234, device="cpu",
                 **TRAIN_KW)
    assert t2.resume() and t2.step == 4
    _, meta = t2.ckpt.restore(t2.state_tree())
    assert meta == {"pipeline_step": 4, "step": 4}
    got = t2.run(_pipe(), steps=2, log_every=1)
    assert [m["loss"] for m in got] == [m["loss"] for m in want[4:]]
    for a, b in ((t2.flat, straight.flat), (t2.opt.mu, straight.opt.mu),
                 (t2.opt.nu, straight.opt.nu),
                 (t2.opt.step, straight.opt.step)):
        assert torch.equal(a, b)
    leaves = pckpt._flatten(t2.state_tree())
    assert leaves["params.embed"].dtype == getattr(torch, dtype)
    assert leaves["opt].mu[embed"].dtype == torch.float32


def test_resume_without_a_checkpoint_is_false(tmp_path):
    _, cfg = _cfgs()
    assert not Trainer(cfg, device="cpu").resume()
    assert not Trainer(cfg, ckpt_dir=str(tmp_path), device="cpu").resume()


def test_async_save_writes_the_values_at_save_time(tmp_path):
    """The port's tensors change in place: an async save followed at once
    by updates of the same storage still writes the values it was given
    (the trainer's state tree is made of views of its flat row)."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    view = {"w": w[: 1 << 15].view(128, 256), "n": w.numpy()}
    mgr.save(view, step=1)
    w.add_(1.0)                         # the next step's in-place update
    mgr.wait()
    got, _ = mgr.restore({"w": torch.zeros(128, 256),
                          "n": np.zeros(1 << 16, np.float32)})
    assert torch.equal(got["w"].reshape(-1), w[: 1 << 15] - 1.0)
    np.testing.assert_array_equal(got["n"], w.numpy() - 1.0)
    mgr.close()
    _, cfg = _cfgs()
    tr = Trainer(cfg, ckpt_dir=str(tmp_path / "tr"), device="cpu",
                 **TRAIN_KW)
    tr.run(_pipe(), steps=1)
    at1 = tr.flat[0].clone()
    tr.ckpt.save(tr.state_tree(), step=1)
    tr.run(_pipe(), steps=2)            # updates the row the save viewed
    assert not torch.equal(tr.flat[0], at1)
    got, _ = tr.ckpt.restore(tr.state_tree(), step=1)
    # the checkpoint's leaf order is the flat row's (sorted keys)
    row = torch.cat([v.reshape(-1).float()
                     for v in pckpt._flatten(got["params"]).values()])
    assert torch.equal(row, at1)


def test_launcher_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "granite_3_2b", "--reduced", "--steps", "2",
            "--seq-len", "16", "--batch", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--resume"]
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert "resumed" not in out
    assert available_steps(str(tmp_path)) == [2]
    launch_train.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "resumed from step 2"
    assert [json.loads(x)["step"] for x in lines[1:3]] == [3, 4]
    assert available_steps(str(tmp_path)) == [2, 4]
    with pytest.raises(SystemExit, match="single-model"):
        launch_train.main(["--arch", "granite_3_2b", "--multi-model",
                           "--grad-sync", "camr", "--ckpt-dir",
                           str(tmp_path)])
