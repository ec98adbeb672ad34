"""The port's fault runtime (``repro_torch.runtime.fault``) against the JAX
package's, on the CPU: the twins of tests/test_fault.py, and the degraded
survivor-set executor.

* ``DegradedCAMREngine`` recovers at JAX's ``(q, k, failed)`` cases, its
  reduce results BITWISE those of JAX's engine on the same data (the
  numpy code is a copy) and close to the oracle (rtol 1e-6, as there);
  idempotence, the bounded load inflation (bytes equal to JAX's), every
  refusal; ``elastic_replan`` and ``smallest_unrecoverable_set`` equal
  to JAX's; ``Membership`` and ``HostMembership``.
* ``build_degraded_executor`` (torch gathers and folds) BITWISE the
  port's ``degraded_shuffle_host``, JAX's host interpreter and JAX's
  compiled executor, for every recoverable set of up to two failures at
  (q, k) = (2, 3), (2, 4), (3, 3), with ``-0.0`` sprinkled in, in f32
  and in bf16 (the port's host lane on ``uint16`` bits with
  ``bf16_add``, JAX's on ``ml_dtypes`` bf16). No tolerance: both replay
  one fold order, add by add.
"""

import itertools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.engine import CAMRConfig as JCAMRConfig
from repro.core.schedule import SCHEDULE_CACHE as JSCHEDULE_CACHE
from repro.runtime import fault as jfault
from repro_torch.core.designs import make_design
from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.core.placement import make_placement
from repro_torch.core.schedule import (SCHEDULE_CACHE, Topology,
                                       surviving_topology)
from repro_torch.runtime.fault import (DegradedCAMREngine, HostMembership,
                                       Membership, MembershipError,
                                       StragglerPolicy,
                                       build_degraded_executor,
                                       degraded_dense_plan,
                                       degraded_shuffle_host, elastic_replan,
                                       smallest_unrecoverable_set)
from repro_torch.runtime.train_loop import bf16_add


def _linear_map(Q):
    def map_fn(job, sf):
        return np.outer(np.arange(1, Q + 1, dtype=np.float64), sf)
    return map_fn


def _datasets(cfg, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(dim) for _ in range(cfg.N)]
            for _ in range(cfg.J)]


# --------------------------------------------------------------------- #
# twins of tests/test_fault.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("q,k,failed", [
    (2, 3, {0}), (2, 3, {5}), (3, 3, {4}), (2, 4, {7}), (4, 3, {1}),
    (2, 4, {0, 7}), (2, 5, {0, 3, 9}),
])
def test_degraded_engine_recovers(q, k, failed):
    """Every live server reduces every (job, function): close to the
    oracle, and bitwise JAX's degraded engine on the same data."""
    cfg = CAMRConfig(q=q, k=k, gamma=1)
    ds = _datasets(cfg, dim=2 * (k - 1))
    Q = cfg.num_functions()
    eng = DegradedCAMREngine(cfg, _linear_map(Q), failed=failed)
    results = eng.run(ds)
    jeng = jfault.DegradedCAMREngine(JCAMRConfig(q=q, k=k, gamma=1),
                                     _linear_map(Q), failed=failed)
    jresults = jeng.run(ds)
    oracle = eng.oracle(ds)
    checked = 0
    for s_orig in range(cfg.K):
        s = eng.migrate_target(s_orig)
        assert s == jeng.migrate_target(s_orig)
        for qf in eng.functions_of(s_orig):
            for j in range(cfg.J):
                got = results[s][(j, qf)]
                np.testing.assert_allclose(got, oracle[(j, qf)],
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_array_equal(
                    got.view(np.uint64), jresults[s][(j, qf)].view(np.uint64))
                checked += 1
    assert checked == cfg.J * Q
    assert eng.trace.total_bytes() == jeng.trace.total_bytes()


def test_degraded_shuffle_is_idempotent():
    cfg = CAMRConfig(q=2, k=3, gamma=1)
    ds = _datasets(cfg, dim=4)
    eng = DegradedCAMREngine(cfg, _linear_map(cfg.num_functions()),
                             failed={0})
    r1 = eng.run(ds)
    eng.shuffle_phase()
    r2 = eng.reduce_phase()
    for s in range(cfg.K):
        assert r1[s].keys() == r2[s].keys()
        for key, v in r1[s].items():
            np.testing.assert_array_equal(v, r2[s][key])


def test_degraded_load_inflation_is_bounded():
    cfg = CAMRConfig(q=3, k=3, gamma=1)
    ds = _datasets(cfg, dim=4)
    healthy = CAMREngine(cfg, _linear_map(cfg.num_functions()))
    healthy.verify(ds, healthy.run(ds))
    l_health = healthy.measured_loads()["L_total_bus"]
    degraded = DegradedCAMREngine(cfg, _linear_map(cfg.num_functions()),
                                  failed={2})
    degraded.run(ds)
    l_deg = degraded.trace.total_bytes() / (
        cfg.J * cfg.num_functions() * degraded.value_bytes)
    assert l_health <= l_deg < 2.5 * l_health
    jdeg = jfault.DegradedCAMREngine(JCAMRConfig(q=3, k=3, gamma=1),
                                     _linear_map(cfg.num_functions()),
                                     failed={2})
    jdeg.run(ds)
    assert degraded.trace.total_bytes() == jdeg.trace.total_bytes()


def test_too_many_failures_rejected():
    cfg = CAMRConfig(q=2, k=3, gamma=1)
    with pytest.raises(ValueError):
        DegradedCAMREngine(cfg, _linear_map(6), failed={0, 1})
    with pytest.raises(ValueError):
        DegradedCAMREngine(cfg, _linear_map(6), failed={0, 4})


@pytest.mark.parametrize("q,k", [(2, 4), (3, 3), (2, 5)])
def test_k_minus_one_failures_always_unrecoverable(q, k):
    cfg = CAMRConfig(q=q, k=k, gamma=1)
    Q = cfg.num_functions()
    for combo in itertools.combinations(range(cfg.K), k - 1):
        with pytest.raises(ValueError):
            DegradedCAMREngine(cfg, _linear_map(Q), failed=set(combo))


def test_single_group_loss_rejected():
    cfg = CAMRConfig(q=3, k=3, gamma=1)
    cls = sorted(make_design(3, 3).parallel_classes[0])
    with pytest.raises(ValueError, match="parallel class|recompute"):
        DegradedCAMREngine(cfg, _linear_map(cfg.num_functions()),
                           failed=set(cls))


def test_failed_set_frozen_after_lowering():
    cfg = CAMRConfig(q=2, k=4, gamma=1)
    ds = _datasets(cfg, dim=6)
    eng = DegradedCAMREngine(cfg, _linear_map(cfg.num_functions()),
                             failed={0})
    eng.map_phase(ds)
    eng.failed.add(7)
    with pytest.raises(MembershipError, match="retarget_engine"):
        eng.shuffle_phase()
    with pytest.raises(MembershipError, match="frozen|re-lowered"):
        eng.reduce_phase()
    eng.failed.discard(7)
    eng.shuffle_phase()
    eng.reduce_phase()


def test_elastic_replan():
    r = elastic_replan(2, 3, 12)
    assert vars(r) == vars(jfault.elastic_replan(2, 3, 12))
    assert r.new_qk[0] * r.new_qk[1] == 12
    assert 0.0 < r.moved_fraction <= 1.0
    r2 = elastic_replan(2, 3, 6)
    assert r2.new_qk in [(2, 3), (3, 2)]
    if r2.new_qk == (2, 3):
        assert r2.moved_fraction == 0.0
    r3 = elastic_replan(2, 3, 100, mu_target=0.04)
    assert vars(r3) == vars(jfault.elastic_replan(2, 3, 100, mu_target=0.04))
    q, k = r3.new_qk
    assert q * k == 100 and abs((k - 1) / 100 - 0.04) < 0.02


@pytest.mark.parametrize("q_old,k_old", [(2, 3), (3, 3), (2, 4)])
@pytest.mark.parametrize("q_new,k_new",
                         [(2, 3), (3, 2), (2, 4), (4, 3), (2, 5)])
def test_elastic_replan_invariants(q_old, k_old, q_new, k_new):
    K_new = q_new * k_new
    mu = (k_new - 1) / K_new
    r = elastic_replan(q_old, k_old, K_new, mu_target=mu)
    assert vars(r) == vars(jfault.elastic_replan(q_old, k_old, K_new,
                                               mu_target=mu))
    assert r.new_qk == (q_new, k_new)
    assert 0.0 <= r.moved_fraction <= 1.0
    assert r.new_storage_fraction == pytest.approx(mu)
    r2 = elastic_replan(q_new, k_new, K_new, mu_target=mu)
    assert r2.new_qk == (q_new, k_new) and r2.moved_fraction == 0.0
    M = make_placement(make_design(q_new, k_new), 1).placement_matrix()
    assert (M.sum(axis=0) == k_new - 1).all()


@pytest.mark.parametrize("q,k,sizes", [
    (2, 3, (1, 2)), (3, 3, (1, 2)), (2, 4, (1, 2, 3)),
])
def test_smallest_unrecoverable_set_matches_engine(q, k, sizes):
    """Exhaustively: the witness is JAX's, and the oracle rejects exactly
    the sets the port's degraded lowering rejects."""
    cfg = CAMRConfig(q=q, k=k, gamma=1)
    Q = cfg.num_functions()
    for size in sizes:
        for combo in itertools.combinations(range(cfg.K), size):
            failed = set(combo)
            bad = smallest_unrecoverable_set(q, k, failed)
            assert bad == jfault.smallest_unrecoverable_set(q, k, failed)
            if bad is None:
                DegradedCAMREngine(cfg, _linear_map(Q), failed=failed)
            else:
                assert set(bad) <= failed
                assert smallest_unrecoverable_set(q, k, set(bad)) \
                    is not None
                with pytest.raises(ValueError):
                    DegradedCAMREngine(cfg, _linear_map(Q), failed=failed)


def test_smallest_unrecoverable_set_edges():
    assert smallest_unrecoverable_set(2, 4, set()) is None
    assert smallest_unrecoverable_set(2, 2, {3}) == (3,)
    assert smallest_unrecoverable_set(2, 4, {0, 1}) == (0, 1)
    assert smallest_unrecoverable_set(2, 4, {0, 2}) is None


def test_membership_counts_fault_domains_not_workers():
    m = Membership(2, 4, topology=Topology.two_level(2),
                   policy=StragglerPolicy(max_failed=1))
    m.kill(0)
    m.kill(2)
    assert m.failed() == {0, 2}
    assert m.domains(m.failed()) == {0}
    assert m.gateway_avoid() == {0, 2}
    with pytest.raises(MembershipError, match="max_failed") as ei:
        m.kill(4)
    assert "domains" in str(ei.value)
    with pytest.raises(MembershipError,
                       match="shuffle-unrecoverable") as ei:
        m.kill(1)
    assert "[0, 1]" in str(ei.value) and "HostMembership" in str(ei.value)
    f = Membership(2, 4, policy=StragglerPolicy(max_failed=1))
    f.kill(0)
    assert f.domains(f.failed()) == {0}
    with pytest.raises(MembershipError, match="max_failed"):
        f.kill(2)


@pytest.mark.parametrize("q,k,hosts", [
    (2, 4, 2), (3, 4, 2), (2, 6, 2), (2, 6, 3), (2, 8, 4),
])
def test_host_membership_exhaustive_block_sets(q, k, hosts):
    K = q * k
    dph = K // hosts
    for r in range(1, hosts):
        for combo in itertools.combinations(range(hosts), r):
            hm = HostMembership(q, k, Topology.two_level(hosts),
                                max_failed_hosts=hosts - 1)
            for h in combo:
                assert hm.kill_host(h) == tuple(range(h * dph,
                                                      (h + 1) * dph))
            assert hm.failed_hosts() == set(combo)
            assert hm.failed_workers() == {
                w for h in combo for w in hm.host_block(h)}
            assert smallest_unrecoverable_set(
                q, k, hm.failed_workers()) is not None
            left = hosts - r
            want = surviving_topology(left, k)
            assert hm.current_topology() == want
            if left >= 2 and k % left == 0:
                assert want == Topology.two_level(left)
            else:
                assert want is None
    hm = HostMembership(q, k, Topology.two_level(hosts),
                        max_failed_hosts=hosts - 1)
    for h in range(hosts - 1):
        hm.kill_host(h)
    with pytest.raises(MembershipError, match="unrecoverable"):
        hm.kill_host(hosts - 1)
    hm.rejoin_host(0)
    assert 0 in hm.live_hosts()
    assert hm.current_topology() == surviving_topology(2, k)


def test_host_membership_validation():
    with pytest.raises(MembershipError, match="two-level"):
        HostMembership(2, 4, None)
    with pytest.raises(MembershipError, match="max_failed_hosts"):
        HostMembership(2, 4, Topology.two_level(2), max_failed_hosts=2)
    hm = HostMembership(2, 4, Topology.two_level(2))
    assert hm.max_failed_hosts == 1
    hm.kill_host(1)
    with pytest.raises(MembershipError, match="already dead"):
        hm.kill_host(1)
    with pytest.raises(MembershipError, match="outside"):
        hm.kill_host(5)
    with pytest.raises(MembershipError, match="only dead"):
        hm.rejoin_host(0)
    hm2 = HostMembership(2, 6, Topology.two_level(3), max_failed_hosts=1)
    hm2.kill_host(0)
    with pytest.raises(MembershipError, match="max_failed_hosts"):
        hm2.kill_host(1)


# --------------------------------------------------------------------- #
# the degraded survivor-set executor
# --------------------------------------------------------------------- #
#: (q, k, d, recoverable sets of up to two failures): (2, 4) has 8
#: single and 24 double ones, (2, 3) and (3, 3) only single ones
EXEC_CASES = [(2, 3, 8, 6), (2, 4, 9, 32), (3, 3, 8, 9)]


def _recoverable(prog, K):
    out = []
    for r in (1, 2):
        for combo in itertools.combinations(range(K), r):
            try:
                SCHEDULE_CACHE.degraded(prog, set(combo))
            except ValueError:
                continue
            out.append(frozenset(combo))
    return out


def _contribs(q, k, d, seed):
    K, J_own = q * k, q ** (k - 2)
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((K, J_own, k - 1, K, d)).astype(np.float32)
    c[rng.random(c.shape) < 0.05] = -0.0
    return c


@pytest.mark.parametrize("q,k,d,n_sets", EXEC_CASES)
def test_degraded_dense_plan_equals_jax(q, k, d, n_sets):
    prog = SCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    jprog = JSCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    sets = _recoverable(prog, q * k)
    assert len(sets) == n_sets
    for fs in sets:
        for a, b in zip(degraded_dense_plan(prog, fs),
                        jfault.degraded_dense_plan(jprog, fs)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q,k,d,n_sets", EXEC_CASES)
def test_degraded_executor_bitwise_f32(q, k, d, n_sets):
    """The torch executor, the port's host interpreter, JAX's host
    interpreter and JAX's compiled executor: one set of bits."""
    prog = SCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    jprog = JSCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    c = _contribs(q, k, d, 11)
    assert (np.signbit(c) & (c == 0)).any()           # -0.0 present
    for fs in _recoverable(prog, q * k):
        got = build_degraded_executor(prog, fs, d, torch.float32, "cpu")(
            torch.from_numpy(c)).numpy()
        host = degraded_shuffle_host(prog, fs, c)
        jhost = jfault.degraded_shuffle_host(jprog, fs, c)
        jexe = np.asarray(jfault.build_degraded_executor(
            jprog, fs, d, np.float32)(jnp.asarray(c)))
        for other in (host, jhost, jexe):
            np.testing.assert_array_equal(got.view(np.uint32),
                                          other.view(np.uint32),
                                          err_msg=str(sorted(fs)))


@pytest.mark.parametrize("q,k,d,n_sets", EXEC_CASES)
def test_degraded_executor_bitwise_bf16(q, k, d, n_sets):
    """bf16: every add rounds once (torch's bf16 add, ``bf16_add`` on
    bit patterns, ``ml_dtypes`` in JAX's host lane, XLA's bf16 add)."""
    prog = SCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    jprog = JSCHEDULE_CACHE.program(q, k, Q=q * k, d=d)
    c = torch.from_numpy(_contribs(q, k, d, 12)).bfloat16()
    bits = c.view(torch.int16).numpy().view(np.uint16)
    jc = bits.view(ml_dtypes.bfloat16)
    for fs in _recoverable(prog, q * k):
        got = build_degraded_executor(prog, fs, d, torch.bfloat16, "cpu")(
            c).view(torch.int16).numpy().view(np.uint16)
        host = degraded_shuffle_host(prog, fs, bits, combine=bf16_add)
        jhost = jfault.degraded_shuffle_host(jprog, fs, jc)
        jexe = np.asarray(jfault.build_degraded_executor(
            jprog, fs, d, ml_dtypes.bfloat16)(jnp.asarray(jc)))
        for other in (host, jhost.view(np.uint16), jexe.view(np.uint16)):
            np.testing.assert_array_equal(got, other,
                                          err_msg=str(sorted(fs)))


def test_degraded_executor_refuses_other_waves():
    prog = SCHEDULE_CACHE.program(2, 3, Q=6, d=4)
    exe = build_degraded_executor(prog, {1}, 4, torch.float32, "cpu")
    c = torch.zeros((6, 2, 2, 6, 4))
    exe(c)
    for bad in (c[..., :2], c.bfloat16(), c.double()):
        with pytest.raises(ValueError, match="degraded executor"):
            exe(bad)
    with pytest.raises(ValueError):
        build_degraded_executor(prog, {0, 1}, 4, torch.float32, "cpu")


@pytest.mark.parametrize("q,k", [(2, 3), (2, 4)])
def test_degraded_lanes_never_read_dead_rows(q, k):
    """NaN-poison a failed worker's contribution rows: the host
    interpreter and the torch executor give finite output bitwise the
    healthy interpretation (the empty failed set) — no route touches
    dead data."""
    from repro_torch.core.collective import (camr_shuffle_reference,
                                             make_plan,
                                             scatter_contributions)
    d = 2 * (k - 1)
    plan = make_plan(q, k, d)
    prog = SCHEDULE_CACHE.program(q, k, Q=plan.K)
    rng = np.random.default_rng(7)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    contribs = scatter_contributions(plan, bg)
    healthy = degraded_shuffle_host(prog, set(), contribs)
    np.testing.assert_allclose(healthy, camr_shuffle_reference(plan, bg),
                               rtol=2e-5, atol=2e-6)
    for fs in _recoverable(prog, plan.K):
        poisoned = contribs.copy()
        poisoned[sorted(fs)] = np.nan
        host = degraded_shuffle_host(prog, fs, poisoned)
        dev = build_degraded_executor(prog, fs, d, torch.float32, "cpu")(
            torch.from_numpy(poisoned)).numpy()
        for out in (host, dev):
            assert np.isfinite(out).all(), sorted(fs)
            np.testing.assert_array_equal(out.view(np.uint32),
                                          healthy.view(np.uint32),
                                          err_msg=str(sorted(fs)))
