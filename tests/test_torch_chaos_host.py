"""Host-granularity chaos on the port's ``ShuffleStream`` (the twin of
tests/test_chaos_host.py), on the CPU: scripted whole-host kills re-home
the two-level stream through the port's ``HostMembership`` onto the
surviving topology, and scripted wire corruption is detected by the
checksum lane and replayed, every wave BITWISE the healthy flat stream's
(the serial oracle) and bitwise the JAX stream running the same plan on
an 8- or 12-device CPU mesh (subprocesses), with JAX's ``host_swaps``,
``wire_faults`` and ``wire_replays``. tests/chaos.py lends the plan
dataclasses; its JAX runner drives the JAX side."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chaos import CorruptPacket, FaultPlan, KillHost, RejoinHost
from repro_torch.core.collective import (ShuffleStream,
                                         camr_shuffle_reference, make_plan,
                                         scatter_contributions)
from repro_torch.core.schedule import SCHEDULE_CACHE, Topology
from repro_torch.runtime.fault import HostMembership

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WAVES = 5

#: name -> (q, k, hosts, dtype, events, host_swaps, wire_faults, dead
#: hosts, executors built: one per topology the plan visits)
PLANS = {
    "kill-242": (2, 4, 2, "float32",
                 (KillHost(wave=1, host=1), RejoinHost(wave=3, host=1)),
                 2, 0, frozenset(), 2),
    "kill-263": (2, 6, 3, "float32",
                 (KillHost(wave=1, host=2), RejoinHost(wave=3, host=2)),
                 2, 0, frozenset(), 2),
    "flat-fallback": (2, 4, 4, "float32",
                      (KillHost(wave=1, host=3), KillHost(wave=2, host=2)),
                      2, 0, frozenset({2, 3}), 3),
    "corrupt-f32": (2, 4, 2, "float32",
                    (CorruptPacket(wave=1, stage=1, device=0, bits=1),
                     CorruptPacket(wave=2, stage=2, device=7, word=0,
                                   bits=0x80000000)), 0, 2, frozenset(), 1),
    "corrupt-bf16": (2, 4, 2, "bfloat16",
                     (CorruptPacket(wave=1, stage=1, device=0, bits=1),
                      CorruptPacket(wave=2, stage=2, device=7, word=0,
                                    bits=0x80000000)), 0, 2, frozenset(),
                     1),
    "corrupt-checksum": (2, 6, 3, "float32",
                         (CorruptPacket(wave=0, stage=2, device=4, word=2,
                                        bits=0xFFFFFFFF),
                          CorruptPacket(wave=3, stage=1, device=11, word=2,
                                        bits=0x80000000)), 0, 2,
                         frozenset(), 1),
    "corrupt-then-kill": (2, 4, 2, "float32",
                          (CorruptPacket(wave=1), KillHost(wave=2, host=0)),
                          1, 1, frozenset({0}), 2),
}


def _bits(t):
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _waves(q, k, d, dtype, seed):
    """``N_WAVES`` waves of contributions (one value in 20 a ``-0.0``) and
    their numpy reduction reference."""
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(seed)
    waves, refs = [], []
    for _ in range(N_WAVES):
        bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
        bg[rng.random(bg.shape) < 0.05] = -0.0
        waves.append(torch.from_numpy(scatter_contributions(plan, bg))
                     .to(dtype))
        refs.append(camr_shuffle_reference(plan, bg))
    return waves, refs


def run_host_plan(q, k, d, waves, plan: FaultPlan, *, hosts,
                  verify_wire=False, warm=True):
    """tests/chaos.py's ``run_host_plan`` on the port: ``KillHost`` /
    ``RejoinHost`` drive a ``HostMembership`` and re-home the stream onto
    its ``current_topology()``, ``CorruptPacket`` arms the stream's
    one-shot wire fault; one wave per dispatch. Returns ``(outputs,
    stream, host_membership)``."""
    topo = Topology.two_level(hosts)
    hm = HostMembership(q, k, topo)
    stream = ShuffleStream(q, k, d, device="cpu", topology=topo,
                           verify_wire=verify_wire)
    if warm:
        stream.warm_host_survivors(max_host_failures=hosts - 1)
    outs = []
    for w, wave in enumerate(waves):
        for ev in plan.events:
            if ev.wave != w:
                continue
            if isinstance(ev, KillHost):
                hm.kill_host(ev.host)
                stream.set_topology(hm.current_topology())
            elif isinstance(ev, RejoinHost):
                hm.rejoin_host(ev.host)
                stream.set_topology(hm.current_topology())
            elif isinstance(ev, CorruptPacket):
                stream.inject_corruption(stage=ev.stage, device=ev.device,
                                         row=ev.row, word=ev.word,
                                         bits=ev.bits)
        outs.extend(stream.run_waves([wave]))
    return outs, stream, hm


def _run_port(name):
    q, k, hosts, dtype, events, *_ = PLANS[name]
    d = 2 * (k - 1)
    waves, refs = _waves(q, k, d, getattr(torch, dtype), seed=len(name))
    oracle = ShuffleStream(q, k, d, device="cpu").run_waves(waves)
    if dtype == "float32":
        for o, r in zip(oracle, refs):
            np.testing.assert_allclose(o.numpy(), r, rtol=2e-5, atol=2e-6)
    verify = any(isinstance(ev, CorruptPacket) for ev in events)
    outs, stream, hm = run_host_plan(q, k, d, waves,
                                     FaultPlan(events, name=name),
                                     hosts=hosts, verify_wire=verify)
    return waves, oracle, outs, stream, hm


@pytest.mark.parametrize("name", sorted(PLANS))
def test_host_plan_bitwise_serial_oracle(name):
    _, _, _, _, _, swaps, faults, dead, built = PLANS[name]
    _, oracle, outs, stream, hm = _run_port(name)
    assert len(outs) == N_WAVES
    for w, (got, want) in enumerate(zip(outs, oracle)):
        assert got.dtype == want.dtype
        assert torch.equal(_bits(got), _bits(want)), f"wave {w}"
    st = stream.stats()
    assert st["host_swaps"] == swaps and st["wire_faults"] == faults, st
    assert st["wire_replays"] == faults
    assert st["dispatches"] == N_WAVES + faults
    # one executor per topology the plan visits; a fault spec builds none
    assert st["compiles"] == built, st
    assert hm.failed_hosts() == dead


def test_kill_host_recovery_is_pure_cache_hit():
    """After ``warm_host_survivors``, a host kill re-homes with zero cold
    schedule lowerings, outputs bitwise."""
    q, k, hosts, d = 2, 4, 2, 6
    waves, _ = _waves(q, k, d, torch.float32, seed=1)
    oracle = ShuffleStream(q, k, d, device="cpu").run_waves(waves)
    topo = Topology.two_level(hosts)
    hm = HostMembership(q, k, topo)
    stream = ShuffleStream(q, k, d, device="cpu", topology=topo)
    stream.warm_host_survivors(max_host_failures=hosts - 1)
    outs = stream.run_waves(waves[:2])
    misses = SCHEDULE_CACHE.stats()["misses"]
    hm.kill_host(1)
    stream.set_topology(hm.current_topology())
    outs += stream.run_waves(waves[2:])
    assert SCHEDULE_CACHE.stats()["misses"] == misses
    for w, (got, want) in enumerate(zip(outs, oracle)):
        assert torch.equal(got, want), f"wave {w}"


def test_corrupt_packet_requires_verify_wire():
    stream = ShuffleStream(2, 4, 6, device="cpu")
    with pytest.raises(ValueError, match="verify_wire"):
        stream.inject_corruption()


# the same plans through the JAX stream (tests/chaos.py's runner)
_RUN_JAX = textwrap.dedent("""
    import numpy as np, ml_dtypes
    from repro.compat import make_mesh
    from chaos import (CorruptPacket, FaultPlan, KillHost, RejoinHost,
                       run_host_plan)
    inp = np.load({path!r})
    res = {{}}
    mesh = make_mesh(({ndev},), ('camr',))
    for name, (q, k, hosts, dtype, events) in {plans!r}.items():
        waves = inp[name].view(ml_dtypes.bfloat16 if dtype == 'bfloat16'
                               else np.float32)
        plan = FaultPlan(tuple(eval(e) for e in events), name=name)
        verify = any(isinstance(ev, CorruptPacket) for ev in plan.events)
        outs, stream, hm = run_host_plan(q, k, 2 * (k - 1), list(waves),
                                         plan, mesh=mesh, hosts=hosts,
                                         verify_wire=verify)
        outs = np.stack([np.asarray(o) for o in outs])
        res[name] = outs.view(np.uint16) if outs.itemsize == 2 else outs
        st = stream.stats()
        res[name + '/stats'] = np.array([st['host_swaps'],
                                         st['wire_faults'],
                                         st['wire_replays'],
                                         st['dispatches']])
    np.savez({out!r}, **res)
    print('OK')
""")


@pytest.mark.parametrize("ndev", [8, 12])
def test_host_plans_bitwise_equal_jax_stream(ndev, tmp_path):
    names = [n for n, p in PLANS.items() if p[0] * p[1] == ndev]
    ports, arrays, plans = {}, {}, {}
    for name in names:
        q, k, hosts, dtype, events, *_ = PLANS[name]
        waves, _, outs, stream, _ = _run_port(name)
        ports[name] = (outs, stream.stats())
        arrays[name] = np.stack([_bits(w).numpy() for w in waves])
        plans[name] = (q, k, hosts, dtype, [repr(ev) for ev in events])
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}")
    code = _RUN_JAX.format(path=str(tmp_path / "in.npz"), ndev=ndev,
                           plans=plans, out=str(tmp_path / "out.npz"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    for name in names:
        outs, st = ports[name]
        got = np.stack([_bits(o).numpy() for o in outs])
        np.testing.assert_array_equal(got, want[name].view(got.dtype),
                                      err_msg=name)
        assert [st["host_swaps"], st["wire_faults"], st["wire_replays"],
                st["dispatches"]] == list(want[name + "/stats"]), name
