"""The port's two-level topology, gateway failover and self-verifying wire
on the CPU (plain codec versions).

* the two-level executor (phase A on the primary-masked send tables,
  phase B one relay gather per live (round, shift) lane) BITWISE the
  port's flat shuffle and the numpy ``CAMREngine`` at four (q, k, hosts),
  both routers and both codecs, on the f32 and bf16 lanes; bitwise the
  JAX ``camr_shuffle`` on 8- and 12-device CPU meshes (subprocesses) at
  (2,4,2), (3,4,2), (2,6,3) f32 and (2,4,2) bf16, with the JAX package's
  collective counts;
* phase A's buffer is zero at exactly the ``b_mask`` slots and phase B
  rebuilds the flat receive buffer word for word, on the rows of each
  device's groups;
* ``camr_edge_bytes`` dict-equal to the JAX package's and to the
  closed forms of ``loads``; a flat plan and the looped mode refused;
* every gateway assignment bitwise flat;
* the stream's ``set_topology`` / ``warm_host_survivors`` are cache
  hits, and its degraded lane is keyed per topology;
* the self-verifying wire: clean waves bitwise the unverified ones, a
  one-word fault (payload or checksum word, each stage, ``bits`` 1,
  ``0x80000000`` and ``0xFFFFFFFF``) flagged on exactly the packet's
  ``k-1`` receivers and equal to JAX's mismatch counts, replayed
  bitwise by the stream (``sync`` and the wave window), and
  ``WireCorruptionError`` after ``max_replays``.
No tolerance anywhere: XOR delivery is lossless.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import collective as jcoll
from repro.core.loads import camr_edge_loads, camr_load_hierarchical
from repro_torch.core import collective as coll
from repro_torch.core.collective import (ShuffleStream, camr_edge_bytes,
                                         camr_shuffle,
                                         expected_collective_calls,
                                         make_plan, scatter_contributions)
from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.core.schedule import (EXEC_CACHE, SCHEDULE_CACHE,
                                       AutoTopology, Topology,
                                       payload_words, surviving_topology)
from repro_torch.runtime.fault import HostMembership, WireCorruptionError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(2, 4, 2), (3, 4, 2), (2, 6, 2), (2, 6, 3)]
#: the cases held to the JAX executor, by mesh size
JAX_CASES = {8: [(2, 4, 2, "float32"), (2, 4, 2, "bfloat16")],
             12: [(3, 4, 2, "float32"), (2, 6, 3, "float32")]}
ROUTERS = ("all_to_all", "ppermute")


def _bits(t):
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _batch_grads(q, k, d, seed):
    """Per-batch gradients ``[J, k, K, d]``, one value in 20 a ``-0.0``."""
    rng = np.random.default_rng(seed)
    bg = rng.standard_normal((q ** (k - 1), k, q * k, d)).astype(np.float32)
    bg[rng.random(bg.shape) < 0.05] = -0.0
    return bg


def _contribs(q, k, d, dtype=torch.float32, seed=0):
    plan = make_plan(q, k, d)
    bg = _batch_grads(q, k, d, seed)
    return plan, bg, torch.from_numpy(scatter_contributions(plan, bg)).to(
        dtype)


def _pk(d, dtype, k):
    return payload_words(d, torch.empty((), dtype=dtype).element_size(),
                         k) // (k - 1)


def _corrupt_specs(plan, d, dtype):
    """(stage, device, row, word, bits): a payload word and the checksum
    word of each stage, at bits 1, 0x80000000 and 0xFFFFFFFF, on the
    first group row of a device of each host half."""
    K, pk = plan.K, _pk(d, dtype, plan.k)
    out = []
    for stage, dev, word, bits in ((1, 0, 0, 1), (1, K - 1, pk, 0xFFFFFFFF),
                                   (2, 1, pk, 0x80000000),
                                   (2, K - 2, pk - 1, 0xFFFFFFFF),
                                   (1, 2, pk - 1, 0x80000000)):
        T = plan.program.stage_tables(stage)
        row = int(np.flatnonzero(T.valid[dev])[0])
        out.append((stage, dev, row, word, bits))
    return out


# --------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------- #
def test_make_plan_topology_resolves_as_jax():
    flat = make_plan(2, 4, 6)
    assert flat.topology is None
    assert make_plan(2, 4, 6, Topology.flat()).program is flat.program
    auto = make_plan(2, 4, 6, Topology.auto(2, alpha=4.0))
    assert isinstance(Topology.auto(2), AutoTopology)
    assert auto.topology == Topology.two_level(2, alpha=4.0)
    assert make_plan(2, 4, 6, Topology.auto(2, alpha=1.0)).topology is None
    two = make_plan(2, 4, 6, Topology.two_level(2), gateway_avoid={0})
    assert two.program.gateway_avoid == frozenset({0})
    ref = jcoll.make_plan(2, 4, 6, jcoll.Topology.two_level(2),
                          gateway_avoid={0})
    np.testing.assert_array_equal(two.program.hx1.a2a_send,
                                  ref.program.hx1.a2a_send)
    with pytest.raises(ValueError, match=r"hosts \| k"):
        make_plan(2, 3, 8, Topology.two_level(2))
    with pytest.raises(ValueError, match="outside"):
        make_plan(2, 4, 6, Topology.two_level(2), gateway_avoid={99})


# --------------------------------------------------------------------- #
# the two-level executor
# --------------------------------------------------------------------- #
def _engine(q, k, bg):
    eng = CAMREngine(CAMRConfig(q=q, k=k, gamma=1), lambda job, sf: sf)
    return eng.run([[bg[j, t] for t in range(k)]
                    for j in range(q ** (k - 1))])


@pytest.mark.parametrize("codec", ["fused", "multipass"])
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("q,k,hosts", CONFIGS)
def test_two_level_bitwise_flat_and_engine(q, k, hosts, router, codec):
    d = 2 * (k - 1)
    plan, bg, c = _contribs(q, k, d, seed=q * 100 + k * 10 + hosts)
    two = make_plan(q, k, d, Topology.two_level(hosts))
    out = camr_shuffle(two, c, router=router, codec=codec)
    assert _same(out, camr_shuffle(plan, c, router=router, codec=codec))
    results = _engine(q, k, bg)
    for s in range(plan.K):
        for j in range(plan.J):
            np.testing.assert_array_equal(
                out[s, j].numpy().view(np.uint32),
                results[s][(j, s)].view(np.uint32), err_msg=f"{s} {j}")


@pytest.mark.parametrize("codec", ["fused", "multipass"])
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_two_level_packed_lane_bitwise_flat(dtype, router, codec):
    """(2,4,2) on the packed lane, odd d: a pad lane rides the relay."""
    q, k, hosts, d = 2, 4, 2, 15
    plan, _, c = _contribs(q, k, d, dtype, seed=9)
    two = make_plan(q, k, d, Topology.two_level(hosts))
    out = camr_shuffle(two, c, router=router, codec=codec)
    assert out.dtype == dtype
    assert _same(out, camr_shuffle(plan, c, router=router, codec=codec))


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("q,k,hosts", CONFIGS)
def test_relay_lanes_counted_as_expected_calls(q, k, hosts, router):
    """One relay permutation per live (round, shift) lane of each coded
    stage: the two-level term of ``expected_collective_calls``, which
    equals the JAX package's."""
    d = 2 * (k - 1)
    _, _, c = _contribs(q, k, d)
    two = make_plan(q, k, d, Topology.two_level(hosts))
    camr_shuffle(two, c, router=router)
    lanes = sum(len(live) for X in (two.program.hx1, two.program.hx2)
                for live in X.b_live)
    assert lanes > 0
    assert two.permutations == {"stage12": lanes, "stage3": q - 1}
    want = expected_collective_calls(two, router=router)
    flat = expected_collective_calls(make_plan(q, k, d), router=router)
    assert want["stage12"] - flat["stage12"] == lanes
    ref = jcoll.make_plan(q, k, d, jcoll.Topology.two_level(hosts))
    assert want == jcoll.expected_collective_calls(ref, router=router)


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("q,k,hosts", CONFIGS)
def test_phase_a_zero_at_exactly_b_mask(q, k, hosts, router):
    """On the rows of its groups, a device's phase-A buffer is zero at
    exactly the ``b_mask`` slots phase B fills; phase B then rebuilds the
    flat receive buffer there word for word (other rows decode garbage
    under either exchange and are masked out)."""
    d = 2 * (k - 1)
    flat = make_plan(q, k, d)
    two = make_plan(q, k, d, Topology.two_level(hosts))
    K, pk = two.K, d // (k - 1)
    gen = torch.Generator().manual_seed(q * k)
    for stage in (1, 2):
        T = two.program.stage_tables(stage)
        X = two.program.host_tables(stage)
        a_rows, lanes = coll._route_rows_two_level(T, X, router, q, k, K)
        f_rows = coll._route_rows(T, router, q, k, K)
        b_mask = X.b_mask.transpose(1, 2, 0)               # [K, n, k-1]
        # rows of groups a device is not a member of decode garbage in
        # either exchange; on member rows phase A zeroes exactly b_mask
        member = np.broadcast_to(T.valid[..., None], b_mask.shape)
        assert not (b_mask & ~member).any()
        assert (f_rows[member] >= 0).all()
        np.testing.assert_array_equal((a_rows < 0)[member], b_mask[member])
        assert len(lanes) == sum(len(live) for live in X.b_live)
        # the device step: phase A, then phase B in place
        st_t = coll._device_tables(two, torch.device("cpu"), router)
        st_f = coll._device_tables(flat, torch.device("cpu"), router)
        st_t, st_f = st_t["stages"][stage], st_f["stages"][stage]
        delta = torch.randint(1, 2 ** 31 - 1, (K, T.n, pk), generator=gen,
                              dtype=torch.int32)
        recv_a = coll._exchange(delta, st_t, K=K, k=k, pk=pk)
        zero = (recv_a == 0).all(dim=-1).view(K, T.n, k - 1).numpy()
        np.testing.assert_array_equal(zero[member], b_mask[member])
        calls = {"stage12": 0}
        recv = coll._relay(recv_a, st_t, calls, pk=pk)
        assert calls["stage12"] == len(lanes)
        want = coll._exchange(delta, st_f, K=K, k=k, pk=pk)
        sel = torch.from_numpy(np.ascontiguousarray(member))
        assert torch.equal(recv.view(K, T.n, k - 1, pk)[sel],
                           want.view(K, T.n, k - 1, pk)[sel])


def test_relay_rows_refuse_a_broken_in_place_invariant():
    """Phase B writes in place only because every relay source is a slot
    phase A filled and every destination a distinct slot it left zero:
    relay tables over an unmasked phase A (the flat send tables, which
    fill the destinations too) are refused with an error, not an
    assert."""
    import dataclasses
    two = make_plan(2, 4, 6, Topology.two_level(2))
    T = two.program.stage_tables(1)
    X = two.program.host_tables(1)
    coll._route_rows_two_level(T, X, "all_to_all", 2, 4, two.K)
    unmasked = dataclasses.replace(X, a2a_send=T.a2a_send,
                                   pp_send=T.pp_send)
    for router in ROUTERS:
        with pytest.raises(RuntimeError, match="in-place invariant"):
            coll._route_rows_two_level(T, unmasked, router, 2, 4, two.K)


def test_two_level_refuses_looped_mode():
    two = make_plan(2, 4, 6, Topology.two_level(2))
    _, _, c = _contribs(2, 4, 6)
    with pytest.raises(ValueError, match="batched"):
        camr_shuffle(two, c, mode="looped")
    with pytest.raises(ValueError, match="batched"):
        ShuffleStream(2, 4, 6, device="cpu", mode="looped",
                      topology=Topology.two_level(2))
    assert (expected_collective_calls(two)["total"]
            > expected_collective_calls(make_plan(2, 4, 6))["total"])


# --------------------------------------------------------------------- #
# per-edge bytes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [None, torch.bfloat16, torch.uint32])
@pytest.mark.parametrize("q,k,hosts", CONFIGS)
def test_edge_bytes_equal_jax(q, k, hosts, dtype):
    d = 2 * (k - 1) * 7
    port = make_plan(q, k, d, Topology.two_level(hosts))
    ref = jcoll.make_plan(q, k, d, jcoll.Topology.two_level(hosts))
    name = None if dtype is None else str(dtype).removeprefix("torch.")
    got = camr_edge_bytes(port, dtype=dtype)
    assert got == jcoll.camr_edge_bytes(ref, dtype=name)
    if dtype is None:
        J, K, B = q ** (k - 1), q * k, d * 4
        for sched in ("flat", "two_level"):
            intra, inter = camr_edge_loads(q, k, hosts, schedule=sched)
            assert got[f"{sched}_inter_bytes"] == pytest.approx(
                inter * J * K * B, abs=1e-6)
            assert got[f"{sched}_intra_bytes"] == pytest.approx(
                intra * J * K * B, abs=1e-6)
        assert got["two_level_inter_bytes"] * k == (
            got["flat_inter_bytes"] * hosts)
        assert camr_load_hierarchical(q, k, hosts, 1.0) == pytest.approx(
            (got["flat_inter_bytes"] + got["flat_intra_bytes"]) / (J * K * B))


def test_edge_bytes_refusals():
    with pytest.raises(ValueError, match="two-level"):
        camr_edge_bytes(make_plan(2, 4, 6))
    with pytest.raises(TypeError, match="codec payload"):
        camr_edge_bytes(make_plan(2, 4, 6, Topology.two_level(2)),
                        dtype=torch.float64)


# --------------------------------------------------------------------- #
# gateway failover
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("q,k,hosts", [(2, 4, 2), (2, 6, 3)])
def test_gateway_failover_bitwise_sweep(q, k, hosts):
    """Every single-device avoid set, one avoided device per host and a
    whole host block, both routers: bitwise the flat shuffle."""
    d = 2 * (k - 1)
    plan, _, c = _contribs(q, k, d, seed=7)
    flat = camr_shuffle(plan, c)
    K, dph = plan.K, plan.K // hosts
    sweeps = ([frozenset({s}) for s in range(K)]
              + [frozenset(h * dph for h in range(hosts)),
                 frozenset(range(dph))])
    for avoid in sweeps:
        two = make_plan(q, k, d, Topology.two_level(hosts),
                        gateway_avoid=avoid)
        for router in ROUTERS:
            assert _same(camr_shuffle(two, c, router=router), flat), (
                sorted(avoid), router)


def test_stream_gateway_avoid_rekeys_its_executor():
    _, _, c = _contribs(2, 4, 6, seed=2)
    s = ShuffleStream(2, 4, 6, device="cpu", topology=Topology.two_level(2))
    want = s.sync(c)
    s.set_gateway_avoid({0, 4})
    assert s.gateway_avoid == {0, 4}
    assert _same(s.sync(c), want)
    s.set_gateway_avoid(())
    assert _same(s.sync(c), want)
    st = s.stats()
    assert st["compiles"] == 2 and st["gateway_avoid"] == ()
    with pytest.raises(ValueError, match="outside"):
        s.set_gateway_avoid({-1})


# --------------------------------------------------------------------- #
# topology changes on the stream
# --------------------------------------------------------------------- #
def test_set_topology_after_warm_host_survivors_is_a_cache_hit():
    """(2,6,3): after ``warm_host_survivors(2)`` every host loss re-homes
    the stream without a cold lowering, bitwise; a rejoin swaps back to
    the executor already built."""
    q, k, d = 2, 6, 10
    _, _, c = _contribs(q, k, d, seed=4)
    want = ShuffleStream(q, k, d, device="cpu").sync(c)
    topo = Topology.two_level(3)
    s = ShuffleStream(q, k, d, device="cpu", topology=topo)
    assert s.warm_host_survivors(max_host_failures=2) == 2
    assert _same(s.sync(c), want)
    hm = HostMembership(q, k, topo)
    misses = SCHEDULE_CACHE.stats()["misses"]
    for h, t in ((2, Topology.two_level(2)), (1, None)):
        hm.kill_host(h)
        assert hm.current_topology() == t
        s.set_topology(hm.current_topology())
        assert s.topology == t and _same(s.sync(c), want)
    hm.rejoin_host(1)
    hm.rejoin_host(2)
    s.set_topology(hm.current_topology())
    s.set_topology(topo)                        # the same: no swap
    assert _same(s.sync(c), want)
    st = s.stats()
    assert SCHEDULE_CACHE.stats()["misses"] == misses
    assert st["host_swaps"] == 3 and st["compiles"] == 3, st
    assert st["topology"] == topo.key()
    assert surviving_topology(2, 6) == Topology.two_level(2)
    with pytest.raises(ValueError, match="two-level"):
        ShuffleStream(q, k, d, device="cpu").warm_host_survivors()
    with pytest.raises(ValueError):
        s.warm_host_survivors(max_host_failures=3)
    with pytest.raises(ValueError, match=r"hosts \| k"):
        s.set_topology(Topology.two_level(4))


@pytest.mark.parametrize("lane", ["device", "host"])
def test_degraded_lane_keyed_per_topology(lane):
    """A two-level stream degrades mid-stream bitwise the healthy flat
    stream (the twin of the JAX stream test on a two-level topology), and
    its degraded executors are keyed per topology in EXEC_CACHE."""
    q, k, d = 2, 4, 6
    waves = [_contribs(q, k, d, seed=s)[2] for s in range(4)]
    ref = ShuffleStream(q, k, d, device="cpu").run_waves(waves)
    EXEC_CACHE.clear()
    two = ShuffleStream(q, k, d, device="cpu", degraded_lane=lane,
                        topology=Topology.two_level(2))
    assert _same(torch.stack(two.run_waves(waves)), torch.stack(ref))
    if lane == "device":
        assert two.warm_degraded_execs(max_failures=1) == 8
    for i, w in enumerate(waves):
        if i == 1:
            two.degrade({1})
        if i == 3:
            two.restore()
        two.submit(w)
    assert all(_same(a, b) for a, b in zip(two.drain(), ref))
    st = two.stats()
    assert st["swaps"] == 2 and st["compiles"] == 1
    if lane == "device":
        assert st["degraded_compiles"] == 8
        flat = ShuffleStream(q, k, d, device="cpu")
        flat.degrade({1})
        assert _same(flat.sync(waves[1]), ref[1])
        assert flat.stats()["degraded_compiles"] == 1   # its own key
        keys = [key for key in EXEC_CACHE._entries if key[6] == (1,)]
        assert sorted(key[7] is None for key in keys) == [False, True]


# --------------------------------------------------------------------- #
# the self-verifying wire
# --------------------------------------------------------------------- #
def test_int32_bits():
    for bits, want in ((1, 1), (0x7FFFFFFF, 2 ** 31 - 1),
                       (0x80000000, -2 ** 31), (0xFFFFFFFF, -1)):
        assert coll._int32_bits(bits) == want
        t = torch.zeros(1, dtype=torch.int32)
        t[0] ^= coll._int32_bits(bits)
        assert int(t.numpy().view(np.uint32)[0]) == bits


def test_xor_reduce_matches_numpy():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 7, 8, 33):
        x = rng.integers(-2 ** 31, 2 ** 31, (4, 5, n), dtype=np.int32)
        want = np.bitwise_xor.reduce(x, axis=-1)
        np.testing.assert_array_equal(
            coll._xor_reduce(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("topology", [None, Topology.two_level(2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_verified_wire_clean_and_each_fault_flagged(dtype, topology):
    """Clean: bitwise the unverified shuffle, no mismatch. One corrupted
    word: flagged on exactly the ``k-1`` receivers of the packet, and
    the sender's own decode stays clean."""
    q, k, d = 2, 4, 15
    flat, _, c = _contribs(q, k, d, dtype, seed=11)
    plan = make_plan(q, k, d, topology)
    want = camr_shuffle(flat, c)
    for router in ROUTERS:
        out, bad = camr_shuffle(plan, c, router=router, verify_wire=True)
        assert _same(out, want) and bad.dtype == torch.int32
        assert bad.tolist() == [0] * plan.K
        for spec in _corrupt_specs(plan, d, dtype):
            _, bad = camr_shuffle(plan, c, router=router, verify_wire=True,
                                  corrupt=spec)
            assert int(bad.sum()) == k - 1, (spec, bad)
            assert int(bad[spec[1]]) == 0, spec


def test_verify_wire_validation():
    plan, _, c = _contribs(2, 4, 6)
    pk = 2
    for kw, what in ((dict(codec="multipass"), "verify_wire requires"),
                     (dict(mode="looped"), "verify_wire requires"),
                     (dict(debug=True), "mutually exclusive"),
                     (dict(corrupt=(1, 0, 0, pk + 1, 1)), "outside packet"),
                     (dict(corrupt=(1, 0, 0, 0, 0)), "nonzero"),
                     (dict(corrupt=(3, 0, 0, 0, 1)), "not a coded stage"),
                     (dict(corrupt=(1, -1, 0, 0, 1)), "device -1 outside"),
                     (dict(corrupt=(2, 0, 99, 0, 1)), "row 99 outside"),
                     (dict(corrupt=(1, 0, 0, 0, 2 ** 32)), "nonzero")):
        with pytest.raises(ValueError, match=what):
            camr_shuffle(plan, c, verify_wire=True, **kw)
    with pytest.raises(ValueError, match="silently mis-reduce"):
        camr_shuffle(plan, c, corrupt=(1, 0, 0, 0, 1))
    s = ShuffleStream(2, 4, 6, device="cpu")
    with pytest.raises(ValueError, match="verify_wire"):
        s.inject_corruption()
    v = ShuffleStream(2, 4, 6, device="cpu", verify_wire=True)
    for kw, what in ((dict(stage=3), "stage"), (dict(device=8), "device"),
                     (dict(bits=0), "nonzero"), (dict(row=99), "row")):
        with pytest.raises(ValueError, match=what):
            v.inject_corruption(**kw)


@pytest.mark.parametrize("topology", [None, Topology.two_level(2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_replays_a_fault_bitwise(dtype, topology):
    """``sync``: each armed fault is detected and replayed bitwise; the
    spec is one-shot and builds no executor of its own."""
    q, k, d = 2, 4, 6
    _, _, c = _contribs(q, k, d, dtype, seed=5)
    want = ShuffleStream(q, k, d, device="cpu").sync(c)
    s = ShuffleStream(q, k, d, device="cpu", topology=topology,
                      verify_wire=True)
    assert _same(s.sync(c), want)
    for i, (stage, dev, row, word, bits) in enumerate(
            _corrupt_specs(make_plan(q, k, d), d, dtype)):
        s.inject_corruption(stage=stage, device=dev, row=row, word=word,
                            bits=bits)
        assert _same(s.sync(c), want)
        st = s.stats()
        assert st["wire_faults"] == st["wire_replays"] == i + 1
    assert _same(s.sync(c), want)               # one-shot: clean again
    st = s.stats()
    assert st["compiles"] == 1 and st["dispatches"] == 2 + 2 * 5
    assert st["wire_faults"] == 5


def test_stream_raises_after_max_replays():
    _, _, c = _contribs(2, 4, 6)
    s = ShuffleStream(2, 4, 6, device="cpu", verify_wire=True,
                      max_replays=0)
    s.inject_corruption(stage=2, device=3, word=2, bits=0x80000000)
    with pytest.raises(WireCorruptionError, match="0 bitwise replays"):
        s.sync(c)
    assert s.stats()["wire_faults"] == 1 and s.stats()["wire_replays"] == 0
    w = ShuffleStream(2, 4, 6, device="cpu", verify_wire=True,
                      max_replays=0, topology=Topology.two_level(2))
    w.inject_corruption()
    w.submit(c)
    with pytest.raises(WireCorruptionError):
        w.drain()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verified_waves_through_host_kill_and_rejoin(dtype):
    """The chip smoke's wave sequence at a CPU size, verified, at
    ``wave_batch=2, depth=2``: waves 0-1 (a fault on wave 1) in one
    two-level dispatch, drained; host 1 killed, wave 2 alone on the
    surviving (flat) topology; host 1 rejoined, wave 3 alone on the
    two-level one. Each dispatch runs on the topology it was submitted
    under, bitwise each wave's flat ``sync``; ``host_swaps`` 2, no
    schedule lowering after the first dispatch."""
    q, k, d = 2, 4, 6
    waves = [_contribs(q, k, d, dtype, seed=20 + s)[2] for s in range(4)]
    ref = ShuffleStream(q, k, d, device="cpu")
    want = [ref.sync(w) for w in waves]
    topo = Topology.two_level(2)
    hm = HostMembership(q, k, topo)
    s = ShuffleStream(q, k, d, device="cpu", wave_batch=2, depth=2,
                      topology=topo, verify_wire=True)
    s.warm_host_survivors()
    s.submit(waves[0])
    s.inject_corruption(stage=2, device=5, word=1, bits=0xFFFFFFFF)
    s.submit(waves[1])
    got = s.drain()
    # the stacked width lowers its own d once; nothing lowers after it
    misses = SCHEDULE_CACHE.stats()["misses"]
    hm.kill_host(1)
    s.set_topology(hm.current_topology())
    assert s.topology is None
    s.submit(waves[2])
    got += s.drain()
    hm.rejoin_host(1)
    s.set_topology(hm.current_topology())
    s.submit(waves[3])
    got += s.drain()
    assert len(got) == 4 and all(_same(g, x) for g, x in zip(got, want))
    st = s.stats()
    assert st["host_swaps"] == 2 and st["wire_faults"] == 1, st
    assert st["wire_replays"] == 1 and st["dispatches"] == 4, st
    assert set(s._plans) == {(2, topo.key(), ()), (1, None, ()),
                             (1, topo.key(), ())}
    assert SCHEDULE_CACHE.stats()["misses"] == misses


# --------------------------------------------------------------------- #
# against the JAX executor on CPU meshes (one subprocess per mesh size)
# --------------------------------------------------------------------- #
_RUN_JAX = textwrap.dedent("""
    import numpy as np, jax, ml_dtypes
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.collective import (make_plan, camr_shuffle,
        expected_collective_calls, scatter_contributions)
    from repro.core.schedule import Topology
    inp = np.load({path!r}, allow_pickle=True)
    mesh = make_mesh(({ndev},), ('camr',))
    res = {{}}
    for ci, (q, k, hosts, dtype) in enumerate(inp['cases']):
        q, k, hosts = int(q), int(k), int(hosts)
        d = 2 * (k - 1)
        bg = inp[f'bg{{ci}}']
        if dtype == 'bfloat16':
            bg = bg.view(ml_dtypes.bfloat16)
        contribs = scatter_contributions(make_plan(q, k, d), bg)
        avoid = frozenset(range(0, q * k, q * k // hosts))
        plans = dict(two=make_plan(q, k, d, Topology.two_level(hosts)),
                     gw=make_plan(q, k, d, Topology.two_level(hosts),
                                  gateway_avoid=avoid))

        def run(plan, **kw):
            verify = kw.get('verify_wire', False)
            def body(c):
                r = camr_shuffle(plan, c[0], axis_name='camr', **kw)
                return (r[0][None], r[1][None]) if verify else r[None]
            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P('camr'),
                                   out_specs=P('camr')))
            return jax.block_until_ready(fn(contribs))

        def put(key, x):
            x = np.asarray(x)
            res[key] = x.view(np.uint16) if x.dtype.itemsize == 2 else x

        for router in ('all_to_all', 'ppermute'):
            put(f'{{ci}}/two/{{router}}', run(plans['two'], router=router))
            res[f'{{ci}}/calls/{{router}}'] = np.array(list(
                expected_collective_calls(plans['two'],
                                          router=router).values()))
        put(f'{{ci}}/gw', run(plans['gw'], router='ppermute'))
        for si, spec in enumerate([None] + list(inp[f'specs{{ci}}'])):
            out, bad = run(plans['two'], verify_wire=True,
                           corrupt=None if spec is None
                           else tuple(int(x) for x in spec))
            put(f'{{ci}}/v{{si}}/out', out)
            res[f'{{ci}}/v{{si}}/bad'] = np.asarray(bad)
    np.savez({out!r}, **res)
    print('OK')
""")


@pytest.fixture(scope="module", params=sorted(JAX_CASES))
def jax_mesh(request, tmp_path_factory):
    """The JAX executor's outputs on a CPU mesh of ``ndev`` devices, and
    the inputs they came from."""
    ndev = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{ndev}")
    cases = JAX_CASES[ndev]
    arrays = {"cases": np.array(cases, dtype=object)}
    for ci, (q, k, hosts, dtype) in enumerate(cases):
        d = 2 * (k - 1)
        bg = torch.from_numpy(_batch_grads(q, k, d, seed=ci + ndev))
        bg = bg.to(getattr(torch, dtype))
        arrays[f"bg{ci}"] = (bg.numpy() if dtype == "float32"
                             else _bits(bg).numpy().view(np.uint16))
        arrays[f"specs{ci}"] = np.array(
            _corrupt_specs(make_plan(q, k, d, Topology.two_level(hosts)), d,
                           bg.dtype), dtype=np.int64)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}")
    code = _RUN_JAX.format(path=str(tmp / "in.npz"), ndev=ndev,
                           out=str(tmp / "out.npz"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return ndev, np.load(tmp / "in.npz", allow_pickle=True), \
        np.load(tmp / "out.npz")


def _port_inputs(inp, ci, case):
    q, k, hosts, dtype = case
    d = 2 * (k - 1)
    bg = inp[f"bg{ci}"]
    if dtype == "bfloat16":
        bg = bg.view(np.int16)
    plan = make_plan(q, k, d)
    c = torch.from_numpy(scatter_contributions(plan, bg))
    if dtype == "bfloat16":
        c = c.view(torch.bfloat16)
    return plan, c, d


def _np_bits(t):
    return _bits(t).numpy()


def test_two_level_bitwise_equal_jax_mesh(jax_mesh):
    """Both routers and one avoided gateway per host: the port's
    two-level shuffle bitwise the JAX one (and the port's flat one), with
    the JAX package's collective counts."""
    ndev, inp, want = jax_mesh
    for ci, case in enumerate(JAX_CASES[ndev]):
        q, k, hosts, dtype = case
        plan, c, d = _port_inputs(inp, ci, case)
        flat = camr_shuffle(plan, c)
        two = make_plan(q, k, d, Topology.two_level(hosts))
        for router in ROUTERS:
            out = camr_shuffle(two, c, router=router)
            assert _same(out, flat), (case, router)
            np.testing.assert_array_equal(
                _np_bits(out), want[f"{ci}/two/{router}"].view(
                    _np_bits(out).dtype), err_msg=f"{case} {router}")
            assert list(expected_collective_calls(
                two, router=router).values()) == list(
                    want[f"{ci}/calls/{router}"]), (case, router)
        avoid = frozenset(range(0, q * k, q * k // hosts))
        gw = make_plan(q, k, d, Topology.two_level(hosts),
                       gateway_avoid=avoid)
        out = camr_shuffle(gw, c, router="ppermute")
        np.testing.assert_array_equal(
            _np_bits(out), want[f"{ci}/gw"].view(_np_bits(out).dtype))


def test_verified_wire_equal_jax_mesh(jax_mesh):
    """The verify lane, clean and under each one-word fault: the port's
    per-device mismatch counts equal JAX's, and so do its outputs bit for
    bit (the corrupted ones too: the fault lands on the same word)."""
    ndev, inp, want = jax_mesh
    for ci, case in enumerate(JAX_CASES[ndev]):
        q, k, hosts, _ = case
        plan, c, d = _port_inputs(inp, ci, case)
        two = make_plan(q, k, d, Topology.two_level(hosts))
        specs = [None] + [tuple(int(x) for x in s)
                          for s in inp[f"specs{ci}"]]
        for si, spec in enumerate(specs):
            out, bad = camr_shuffle(two, c, verify_wire=True, corrupt=spec)
            np.testing.assert_array_equal(
                bad.numpy(), want[f"{ci}/v{si}/bad"],
                err_msg=f"{case} {spec}")
            np.testing.assert_array_equal(
                _np_bits(out), want[f"{ci}/v{si}/out"].view(
                    _np_bits(out).dtype), err_msg=f"{case} {spec}")
            if spec is None:
                assert _same(out, camr_shuffle(plan, c))
            else:
                assert int(bad.sum()) == k - 1
