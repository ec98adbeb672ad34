"""The port's training slice against the JAX package, on the CPU at a
tiny size: the flat parameter layout, the LM loss and its flat gradient,
the synced gradient of the coded gradient-sync step, and 3 training
steps of the trainer.

Tolerances, and why:

* flat layout (``ravel``/``unravel``): bitwise — pure data movement and
  the same round-to-nearest-even casts;
* loss rtol 1e-5, gradient rtol 1e-4 / atol 1e-6: the same f32 math,
  summed in other orders by XLA and by PyTorch's CPU kernels;
* synced gradient ``[K, J, d]``: bitwise, given the same per-subfile
  gradients — the alpha-combiner is exact with one row per segment, the
  XOR transport is lossless and assembly folds in the engine's order;
* 3 trainer steps: losses rtol 1e-4 (gradients differ at 1e-4 relative,
  see above), parameters atol 2e-5 (AdamW normalises each gradient
  element, so a relative gradient difference moves a parameter by at
  most about lr * 1e-4 per step, and the clip norm sums in another
  order).
"""

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
from repro_torch.core.collective import ShuffleStream
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.runtime import MultiModelCAMRTrainer
from repro_torch.runtime.train_loop import _full_f32
from repro_torch.weights import flat_spec, params_from_jax, ravel, unravel

TINY = dict(n_layers=2, vocab=64, d_model=32, d_ff=64, n_heads=2,
            n_kv_heads=1, head_dim=16, loss_chunk=8)
# the other dense options the port's layers carry
VARIANT = dict(TINY, n_layers=4, pattern=("attn", "local"), local_window=4,
               attn_softcap=50.0, final_softcap=30.0, mlp_act="geglu",
               tie_embeddings=False, scale_embed=True, rope_theta=500.0)


def _cfgs(**kw):
    """The same config in both packages."""
    return (jax_reduced(jax_get_config("granite_3_2b")).replace(**kw),
            reduced(get_config("granite_3_2b")).replace(**kw))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _torch_bits(t):
    t = t.detach().contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        .numpy().view({2: np.uint16, 4: np.uint32}[t.element_size()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ravel_matches_ravel_pytree(dtype):
    jcfg, _ = _cfgs(**TINY, dtype=dtype)
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


@pytest.mark.parametrize("kw", [TINY, VARIANT], ids=["granite", "variant"])
def test_loss_and_flat_gradient_match_jax(kw):
    jcfg, cfg = _cfgs(**kw)
    p = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    flat, junravel = ravel_pytree(p)
    batch = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2).batch(4)
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
    np.testing.assert_allclose(row.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jax_run():
    """3 steps of the JAX trainer (mode="camr", the numpy engine wire —
    in-process, no mesh), recording its per-subfile gradients and its
    synced gradient of every step."""
    jcfg, _ = _cfgs(**TINY)
    jtr = JaxTrainer(jcfg, q=2, k=3, seed=0)
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
    rep = jtr.train_steps(pipe, 3, mode="camr")
    return dict(trainer=jtr, init=init, grads=grads, gsync=gsync,
                losses=np.asarray(rep.losses), flat=np.asarray(jtr.flat))


def _port_trainer(jax_run, **kw):
    _, cfg = _cfgs(**TINY)
    return MultiModelCAMRTrainer(
        cfg, q=2, k=3, device="cpu",
        params=[params_from_jax(p, "cpu") for p in jax_run["init"]], **kw)


def test_synced_gradient_bitwise_equals_jax(jax_run):
    jtr = jax_run["trainer"]
    tr = _port_trainer(jax_run)
    assert (tr.D, tr.d_shard, tr.Dpad) == (jtr.D, jtr.d_shard, jtr.Dpad)
    init = np.stack([np.asarray(ravel_pytree(p)[0]) for p in jax_run["init"]])
    np.testing.assert_array_equal(_torch_bits(tr.flat[:, :tr.D]), _bits(init))
    assert not tr.flat[:, tr.D:].any()
    stream = ShuffleStream(2, 3, tr.d_shard, device="cpu")
    datasets = [[(n, None) for n in range(tr.N)] for _ in range(tr.J)]
    for step in range(3):
        g = {(j, n): jax_run["grads"][(step, j, n)]
             for j in range(tr.J) for n in range(tr.N)}
        contribs = tr._build_contribs(
            lambda j, sf: torch.from_numpy(g[(j, sf[0])].reshape(-1)),
            datasets)
        if step == 0:   # the JAX map lane, Pallas alpha-combiner included
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
    assert [list(ms) for ms in rep.phase_ms] == [["map", "aggregate",
                                                  "shuffle", "update"]] * 3
    assert rep.bytes_total == 3 * jcoll.camr_collective_bytes(
        jcoll.make_plan(2, 3, tr.d_shard), dtype=np.float32)["camr_total"]


def test_trainer_needs_a_card_or_an_explicit_cpu(monkeypatch, jax_run):
    _, cfg = _cfgs(**TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiModelCAMRTrainer(cfg, q=2, k=3)
    tr = _port_trainer(jax_run)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    for mode in ("camr", "uncoded"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tr.train_steps(pipe, 1, mode=mode)
    with pytest.raises(ValueError, match="mode"):
        tr.train_steps(pipe, 1, mode="nope")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiModelCAMRTrainer(cfg.replace(grad_sync_dtype="bfloat16"),
                              q=2, k=3, device="cpu")


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
    for argv in (["--grad-sync", "camr", "--multi-model"], []):
        with pytest.raises(SystemExit, match="ROADMAP"):
            launch_train.main(["--arch", "granite_3_2b", *argv])
