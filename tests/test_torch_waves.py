"""The port's ``ShuffleStream`` on the CPU: wave batching, the ``depth``
window and the degraded lane.

* ``run_waves`` at ``wave_batch`` 1, 2 and 3 with ``depth`` 1 and 2, on
  the f32 and bf16 lanes: every drained output BITWISE the ``sync`` of
  its wave (stacking along the value axis commutes with the codec), and
  bitwise the JAX stream's on a 6-device CPU mesh (subprocess);
* degrade and restore mid-stream on both degraded lanes (the device
  executor and the host interpreter): outputs bitwise the healthy
  stream's (every degraded route folds in the healthy order),
  ``compiles`` flat, ``swaps`` 2 — the twin of tests/test_elastic.py's
  stream churn, and of its warm zero-build gate;
* the two-level ``topology``, ``gateway_avoid``, ``verify_wire`` and
  ``max_replays`` are taken and validated as the JAX stream validates
  them (their lanes: tests/test_torch_topology.py).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.collective import (ShuffleStream, make_plan,
                                         scatter_contributions)
from repro_torch.core.schedule import EXEC_CACHE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q, K3, D = 2, 3, 8
N_WAVES = 6


def _waves(dtype, n=N_WAVES, d=D, seed=0):
    plan = make_plan(Q, K3, d)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bg = rng.standard_normal((plan.J, K3, plan.K, d)).astype(np.float32)
        bg[rng.random(bg.shape) < 0.05] = -0.0
        out.append(torch.from_numpy(scatter_contributions(plan, bg))
                   .to(dtype))
    return out


def _bits(t):
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("wave_batch", [1, 2, 3])
def test_run_waves_bitwise_sync(wave_batch, depth, dtype):
    waves = _waves(dtype)
    stream = ShuffleStream(Q, K3, D, device="cpu", wave_batch=wave_batch,
                           depth=depth)
    got = stream.run_waves(waves)
    assert len(got) == N_WAVES
    assert not stream._in_flight and not stream._pending
    n_disp = -(-N_WAVES // wave_batch)
    st = stream.stats()
    assert st["dispatches"] == n_disp and len(stream.wave_times) == n_disp
    assert st["widths"] == [wave_batch] and st["compiles"] == 1
    for w, out in zip(waves, got):
        assert out.device.type == "cpu" and out.shape == (6, 4, D)
        assert _same(out, stream.sync(w))
    assert stream.stats()["compiles"] == 1 + (wave_batch != 1)


def test_partial_last_batch_and_submission_order():
    """5 waves at ``wave_batch`` 2: two stacked dispatches and a single
    one at ``drain``, outputs in submission order."""
    waves = _waves(torch.float32, n=5, seed=3)
    stream = ShuffleStream(Q, K3, D, device="cpu", wave_batch=2, depth=1)
    for w in waves:
        stream.submit(w)
    assert stream.stats()["dispatches"] == 2 and len(stream._pending) == 1
    got = stream.drain()
    assert stream.stats()["widths"] == [1, 2]
    ref = ShuffleStream(Q, K3, D, device="cpu")
    assert all(_same(g, ref.sync(w)) for g, w in zip(got, waves))
    assert stream.drain() == []
    with pytest.raises(ValueError, match="share one dtype"):
        stream.submit(waves[0])
        stream.submit(waves[1].bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lane", ["device", "host"])
def test_degrade_restore_mid_stream_bitwise(lane, dtype):
    """Kill worker 4 at wave 2, restore at wave 4, on the same stream."""
    waves = _waves(dtype, seed=1)
    stream = ShuffleStream(Q, K3, D, device="cpu", wave_batch=1, depth=2,
                           degraded_lane=lane)
    healthy = stream.run_waves(waves)
    st0 = dict(stream.stats())
    for i, w in enumerate(waves):
        if i == 2:
            stream.degrade({4})
            assert stream.failed == {4}
        if i == 4:
            stream.restore()
        stream.submit(w)
    churned = stream.drain()
    st1 = stream.stats()
    for h, o in zip(healthy, churned):
        assert _same(h, o)
    assert st1["compiles"] == st0["compiles"] == 1, st1
    assert st1["swaps"] == 2 and st1["failed"] == (), st1
    assert st1["degraded_lane"] == lane
    assert len(stream.wave_times) == 2 * N_WAVES
    with pytest.raises(ValueError):
        stream.degrade({0, 1})              # same class: unrecoverable
    stream.degrade(set())                   # empty set: restore, no swap
    assert stream.stats()["swaps"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.uint32])
def test_sync_on_both_degraded_lanes_is_the_healthy_sync(dtype):
    """Every codec payload dtype: u32 words add wrapping (on the int32
    view on the device lane, as ``uint32`` on the host lane)."""
    if dtype == torch.uint32:
        plan = make_plan(Q, K3, D)
        rng = np.random.default_rng(4)
        waves = [torch.from_numpy(scatter_contributions(plan, rng.integers(
            -2**31, 2**31, size=(plan.J, K3, plan.K, D), dtype=np.int32)))
            .view(torch.uint32) for _ in range(2)]
    else:
        waves = _waves(dtype, n=2, seed=4)
    healthy = ShuffleStream(Q, K3, D, device="cpu")
    lanes = {lane: ShuffleStream(Q, K3, D, device="cpu", degraded_lane=lane)
             for lane in ("device", "host")}
    for failed in range(6):
        for s in lanes.values():
            s.degrade({failed})
        for w in waves:
            want = healthy.sync(w)
            for lane, s in lanes.items():
                got = s.sync(w)
                assert got.device.type == "cpu"
                assert _same(got, want), (lane, failed)
    assert lanes["host"].stats()["degraded_compiles"] == 0
    assert lanes["device"].stats()["compiles"] == 0


def test_warm_degraded_execs_zero_builds():
    """Warmed before any failure, a degrade and every degraded dispatch
    build nothing; a second stream of the same shape hits the
    process-wide EXEC_CACHE; the device lane is bitwise the host one."""
    EXEC_CACHE.clear()
    waves = _waves(torch.float32, n=4, seed=3)
    host = ShuffleStream(Q, K3, D, device="cpu", degraded_lane="host")
    host.degrade({4})
    want = host.run_waves(waves)
    assert host.stats()["degraded_compiles"] == 0
    dev = ShuffleStream(Q, K3, D, device="cpu")
    assert dev.warm_degraded_execs(max_failures=1) == 6
    warmed = dev.stats()["degraded_compiles"]
    assert warmed == 6
    dev.degrade({4})
    got = dev.run_waves(waves)
    st = dev.stats()
    assert st["degraded_compiles"] == warmed and st["compiles"] == 0, st
    assert all(_same(w, g) for w, g in zip(want, got))
    dev2 = ShuffleStream(Q, K3, D, device="cpu")
    dev2.degrade({1})
    got2 = dev2.run_waves(waves)
    assert dev2.stats()["degraded_compiles"] == 0
    host.degrade({1})
    assert all(_same(w, g) for w, g in zip(host.run_waves(waves), got2))
    # stacked widths and the bf16 dtype are executors of their own
    assert dev.warm_degraded_execs(widths=(1, 2),
                                   dtype=torch.bfloat16) == 12
    assert dev.stats()["degraded_compiles"] == warmed + 12
    assert dev.warm_degraded_execs(max_failures=2) == 6   # k=3: no pairs


def test_stream_refuses_item7_arguments_and_bad_options():
    """The item-7 arguments are taken, and refused only where the JAX
    stream refuses them."""
    from repro_torch.core.schedule import Topology
    s = ShuffleStream(Q, K3, D, device="cpu", topology=Topology.two_level(3),
                      gateway_avoid={1}, verify_wire=True, max_replays=0)
    st = s.stats()
    assert st["topology"] == (3, 4.0) and st["gateway_avoid"] == (1,)
    assert st["verify_wire"] and s.max_replays == 0
    flat = ShuffleStream(Q, K3, D, device="cpu", topology=Topology.flat(),
                         gateway_avoid={1})
    assert flat.topology is None and flat.gateway_avoid == frozenset()
    for kw, what in ((dict(depth=0), "depth"), (dict(wave_batch=0),
                                                 "wave_batch"),
                     (dict(degraded_lane="gpu"), "degraded_lane"),
                     (dict(topology=Topology.two_level(2)), r"hosts \| k"),
                     (dict(topology=Topology.two_level(3), mode="looped"),
                      "batched"),
                     (dict(gateway_avoid={6}), "outside"),
                     (dict(verify_wire=True, codec="multipass"),
                      "verify_wire"),
                     (dict(max_replays=-1), "max_replays")):
        with pytest.raises(ValueError, match=what):
            ShuffleStream(Q, K3, D, device="cpu", **kw)
    stream = ShuffleStream(Q, K3, D, device="cpu")
    with pytest.raises(ValueError, match="wave shape"):
        stream.submit(torch.zeros((6, 2, 2, 6, 4)))
    with pytest.raises(TypeError, match="supported payload dtypes"):
        stream.submit(torch.zeros((6, 2, 2, 6, D), dtype=torch.float64))


# the JAX stream on a 6-device CPU mesh (its fused codec's Pallas kernels
# in interpret mode): run_waves at three widths, and a degrade/restore
# churn on its device lane, f32 and bf16
_RUN_JAX = textwrap.dedent("""
    import numpy as np, ml_dtypes
    from repro.compat import make_mesh
    from repro.core.collective import ShuffleStream
    waves = np.load({path!r})
    mesh = make_mesh((6,), ('camr',))
    out = {{}}
    for dt in ('f32', 'bf16'):
        ws = [w if dt == 'f32' else w.view(ml_dtypes.bfloat16)
              for w in (waves['f32'] if dt == 'f32' else waves['bf16'])]
        for W in {widths!r}:
            s = ShuffleStream(2, 3, {d}, mesh=mesh, wave_batch=W, depth=2,
                              use_kernels=True)
            out[f'{{dt}}-W{{W}}'] = np.stack(
                [np.asarray(o) for o in s.run_waves(ws)])
        s = ShuffleStream(2, 3, {d}, mesh=mesh, wave_batch=2,
                          use_kernels=True)
        for i, w in enumerate(ws):
            if i == 2:
                s.degrade({{4}})
            if i == 4:
                s.restore()
            s.submit(w)
        out[f'{{dt}}-churn'] = np.stack([np.asarray(o) for o in s.drain()])
        assert s.stats()['swaps'] == 2, s.stats()
    np.savez({out!r}, **{{k: (v.view(np.uint16) if v.dtype.itemsize == 2
                             else v) for k, v in out.items()}})
    print('OK')
""")


def test_waves_bitwise_equal_jax_stream_mesh(tmp_path):
    widths = (1, 2, 3)
    waves = {dt: _waves(dt, seed=7) for dt in (torch.float32,
                                                torch.bfloat16)}
    np.savez(tmp_path / "waves.npz",
             f32=np.stack([w.numpy() for w in waves[torch.float32]]),
             bf16=np.stack([_bits(w).numpy().view(np.uint16)
                            for w in waves[torch.bfloat16]]))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    code = _RUN_JAX.format(path=str(tmp_path / "waves.npz"), d=D,
                           widths=widths, out=str(tmp_path / "out.npz"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ws = waves[dtype]
        runs = {f"W{W}": ShuffleStream(Q, K3, D, device="cpu", wave_batch=W)
                .run_waves(ws) for W in widths}
        s = ShuffleStream(Q, K3, D, device="cpu", wave_batch=2)
        for i, w in enumerate(ws):
            if i == 2:
                s.degrade({4})
            if i == 4:
                s.restore()
            s.submit(w)
        runs["churn"] = s.drain()
        for key, outs in runs.items():
            got = np.stack([_bits(o).numpy() for o in outs])
            w = want[f"{tag}-{key}"]
            np.testing.assert_array_equal(
                got.view(w.dtype), w, err_msg=f"{tag} {key}")
