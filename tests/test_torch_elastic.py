"""Live elasticity of the port's numpy runtime on the CPU: the twins of
tests/test_elastic.py's JobStream half, driven through the port's
``JobStream`` and ``ElasticController``.

tests/chaos.py lends its plan dataclasses (``Kill``, ``Rejoin``,
``Straggle``, ``FaultPlan``) and its controller's two hooks; the
controller itself is built on the port's ``ElasticController`` over the
port's ``Membership``. Contract, as there: for every churn schedule the
elastic stream's output is BITWISE the healthy serial oracle (compared
on the bits, ``-0.0`` apart from ``0.0``), and that oracle is bitwise
the JAX package's; with a warmed schedule cache recovery pays no
lowering. ``JobStream(failed=)`` and ``JobStream(elastic=)`` run, bitwise
JAX's.
"""

import numpy as np
import pytest

import chaos
from chaos import FaultPlan, Kill, Rejoin, Straggle
from repro.runtime.jobstream import JobStream as JJobStream
from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.core.schedule import SCHEDULE_CACHE
from repro_torch.runtime.fault import (DegradedCAMREngine, ElasticController,
                                       Membership, MembershipError,
                                       StragglerPolicy, retarget_engine)
from repro_torch.runtime.jobstream import JobSpec, JobStream

# detector policy for scripted Straggle events (tests/test_elastic.py's)
DETECT = StragglerPolicy(abs_timeout_s=1.0, rel_threshold=1e9,
                         patience=2, demote=True)

PLANS = [
    FaultPlan((), "healthy"),
    FaultPlan((Kill(0, 1),), "kill-first-wave"),
    FaultPlan((Kill(2, 4),), "kill-mid"),
    FaultPlan((Kill(2, 4), Rejoin(4, 4)), "kill-rejoin"),
    FaultPlan((Kill(1, 0), Rejoin(3, 0), Kill(4, 5)), "churn-twice"),
    FaultPlan((Straggle(1, 2, waves=3, delay_s=9.0),), "straggle"),
]
PLAN_BY_NAME = {p.name: p for p in PLANS}


class PortChaos(ElasticController):
    """tests/chaos.py's ``ChaosController`` on the port's controller:
    kills and rejoins fire when their wave starts, straggles inflate the
    timings the detector sees."""

    def __init__(self, plan: FaultPlan, membership: Membership):
        super().__init__(membership)
        self.plan = plan
        self._applied: set = set()

    on_wave_start = chaos.ChaosController.on_wave_start
    on_wave_timings = chaos.ChaosController.on_wave_timings


def make_specs(q, k, waves, d=8, seed=0):
    """tests/chaos.py's ``make_specs`` on the port's config and spec."""
    cfg = CAMRConfig(q=q, k=k, gamma=1)
    Q = cfg.num_functions()
    rng = np.random.default_rng(seed)
    return [JobSpec(cfg, chaos._identity_map,
                    [[rng.standard_normal((Q, d)).astype(np.float32)
                      for _ in range(cfg.N)] for _ in range(cfg.J)],
                    name=f"wave{w}")
            for w in range(waves)]


def serial_oracle(specs):
    return [CAMREngine(sp.cfg, sp.map_fn, combine=sp.combine).run(
        sp.datasets) for sp in specs]


def run_plan(specs, plan, *, policy=None, pipeline=False):
    q, k = specs[0].cfg.q, specs[0].cfg.k
    ctrl = PortChaos(plan, Membership(
        q, k, policy=policy or StragglerPolicy(demote=False)))
    stream = JobStream(elastic=ctrl, wave_batch=1, pipeline=pipeline)
    return stream.run(specs), stream, ctrl


def assert_bitwise(oracle, got, context=""):
    assert len(oracle) == len(got), context
    for w, (want, res) in enumerate(zip(oracle, got)):
        assert len(want) == len(res), (context, w)
        for s, (a, b) in enumerate(zip(want, res)):
            assert a.keys() == b.keys(), (context, w, s)
            for key in a:
                x, y = np.ascontiguousarray(a[key]), np.ascontiguousarray(
                    b[key])
                assert x.dtype == y.dtype and x.shape == y.shape
                assert x.tobytes() == y.tobytes(), (context, w, s, key)


def _run_sweep(q, k, plan, pipeline):
    specs = make_specs(q, k, waves=6, d=6)
    oracle = serial_oracle(specs)
    SCHEDULE_CACHE.warm_survivors(
        CAMREngine(specs[0].cfg, specs[0].map_fn).program)
    policy = (DETECT if any(isinstance(ev, Straggle)
                            for ev in plan.events) else None)
    for attempt in range(2):
        got, stream, ctrl = run_plan(specs, plan, policy=policy,
                                     pipeline=pipeline)
        ctx = f"q{q}k{k}:{plan.name}:pipeline={pipeline}:run{attempt}"
        assert_bitwise(oracle, got, ctx)
        assert stream.last_report.cache_misses == 0, ctx
    return oracle, ctrl


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("plan", ["kill-rejoin", "straggle"])
def test_chaos_quick(plan, pipeline):
    oracle, _ = _run_sweep(2, 3, PLAN_BY_NAME[plan], pipeline)
    # the port's oracle is the JAX package's, bit for bit
    assert_bitwise(chaos.serial_oracle(chaos.make_specs(2, 3, 6, d=6)),
                   oracle, "jax oracle")


@pytest.mark.parametrize("q,k", [(2, 3), (3, 3), (2, 4)])
@pytest.mark.parametrize("pipeline", [False, True])
def test_chaos_sweep(q, k, pipeline):
    for plan in PLANS:
        _run_sweep(q, k, plan, pipeline)


def test_in_flight_kill_retargets_without_remap():
    q, k, waves, kill_wave, victim = 2, 3, 5, 2, 4
    specs = make_specs(q, k, waves, d=6)
    oracle = serial_oracle(specs)
    SCHEDULE_CACHE.warm_survivors(
        CAMREngine(specs[0].cfg, specs[0].map_fn).program)
    member = Membership(q, k, policy=StragglerPolicy(demote=False))
    ctrl = ElasticController(member)
    calls = [0]

    def killing_map(job, sf):
        calls[0] += 1
        with ctrl._lock:
            if member.state[victim] != Membership.DEAD:
                member.kill(victim)
        return sf

    sp = specs[kill_wave]
    specs[kill_wave] = JobSpec(sp.cfg, killing_map, sp.datasets,
                               name=sp.name)
    stream = JobStream(elastic=ctrl, wave_batch=1, pipeline=False)
    assert_bitwise(oracle, stream.run(specs), "in-flight kill")
    assert stream.last_report.migrations == 1 and ctrl.migrations == 1
    assert isinstance(stream.last_engines[kill_wave], DegradedCAMREngine)
    assert not getattr(stream.last_engines[kill_wave - 1], "failed", None)
    for w in range(kill_wave, waves):
        assert stream.last_engines[w].failed == {victim}
    n_churn, calls[0] = calls[0], 0
    JobStream(elastic=ElasticController(Membership(q, k)), wave_batch=1,
              pipeline=False).run([specs[kill_wave]])
    assert n_churn == calls[0]          # zero map recompute


def test_retarget_engine_adopts_map_state():
    cfg = CAMRConfig(q=2, k=3, gamma=1)
    rng = np.random.default_rng(1)
    Q = cfg.num_functions()
    ds = [[rng.standard_normal((Q, 4)) for _ in range(cfg.N)]
          for _ in range(cfg.J)]
    healthy = CAMREngine(cfg, chaos._identity_map).run(ds)
    eng = CAMREngine(cfg, chaos._identity_map)
    eng.map_phase(ds)
    assert retarget_engine(eng, set()) is eng
    deg = retarget_engine(eng, {3})
    assert isinstance(deg, DegradedCAMREngine)
    assert deg.servers is eng.servers and deg.map_times is eng.map_times
    deg.shuffle_phase()
    res = JobStream._logical_slots(deg, deg.reduce_phase())
    assert_bitwise([healthy], [res], "retarget")
    back = retarget_engine(deg, set())
    assert type(back) is CAMREngine and back.servers is eng.servers
    assert retarget_engine(deg, {3}) is deg


def test_straggler_flag_demote_rejoin_lifecycle():
    q, k, waves = 2, 3, 7
    specs = make_specs(q, k, waves, d=6)
    plan = FaultPlan((Straggle(1, 3, waves=3, delay_s=9.0),
                      Rejoin(5, 3)), "lifecycle")
    got, stream, ctrl = run_plan(specs, plan, policy=DETECT)
    assert_bitwise(serial_oracle(specs), got, "lifecycle")
    m = ctrl.membership
    assert [(kind, w) for _, kind, w in m.events] == \
        [("flag", 3), ("demote", 3), ("rejoin", 3)]
    assert m.state[3] == Membership.LIVE
    assert stream.last_report.migrations == 0
    for w, want in enumerate([None, None, None, {3}, {3}, None, None]):
        assert (getattr(stream.last_engines[w], "failed", None) or
                None) == want, w
    assert m.replans[-1].moved_fraction == 0.0
    assert m.replans[-1].new_qk == (q, k)


def test_membership_transitions_and_caps():
    m = Membership(2, 3)
    with pytest.raises(MembershipError, match="outside"):
        m.kill(6)
    with pytest.raises(MembershipError, match="only dead"):
        m.rejoin(0)
    m.kill(0)
    with pytest.raises(MembershipError, match="already dead"):
        m.kill(0)
    with pytest.raises(MembershipError, match="max_failed"):
        m.kill(1)
    assert m.demote(1) is False
    assert m.state[1] == Membership.LIVE
    assert m.failed() == {0} and 0 not in m.live()
    assert m.rejoin(0).moved_fraction == 0.0
    m.kill(1)
    assert m.failed() == {1}
    assert [e[1] for e in m.events] == ["kill", "rejoin", "kill"]
    assert m.generation == 3


def test_straggler_policy_knobs():
    base = {w: 1.0 for w in range(6)}
    m = Membership(2, 3, policy=StragglerPolicy(rel_threshold=2.0,
                                                patience=2))
    assert m.observe({**base, 2: 10.0}) == []
    assert m.state[2] == Membership.STRAGGLER
    assert m.observe(base) == []
    assert m.state[2] == Membership.LIVE
    assert m.observe({**base, 2: 10.0}) == []
    assert m.observe({**base, 2: 10.0}) == [2]
    assert m.state[2] == Membership.DEAD
    m2 = Membership(2, 3, policy=StragglerPolicy(
        rel_threshold=1e9, abs_timeout_s=5.0, patience=1))
    assert m2.observe({**base, 4: 6.0}) == [4]
    m3 = Membership(2, 3, policy=StragglerPolicy(rel_threshold=2.0,
                                                 patience=1, demote=False))
    assert m3.observe({**base, 1: 10.0}) == []
    assert m3.state[1] == Membership.STRAGGLER
    m4 = Membership(2, 3, policy=StragglerPolicy(rel_threshold=2.0,
                                                 patience=1,
                                                 min_wave_s=1e-3))
    assert m4.observe({**{w: 2e-6 for w in range(6)}, 3: 5.0}) == []
    assert m4.state[3] == Membership.LIVE
    m5 = Membership(2, 3, policy=StragglerPolicy(rel_threshold=2.0,
                                                 patience=1))
    m5.kill(5)
    assert m5.observe({**base, 5: 99.0}) == []


def test_warm_survivors_makes_recovery_pure_hits():
    SCHEDULE_CACHE.clear()
    prog = CAMREngine(CAMRConfig(q=2, k=3, gamma=1),
                      chaos._identity_map).program
    assert SCHEDULE_CACHE.warm_survivors(prog) == 6
    s0 = SCHEDULE_CACHE.stats()
    for w in range(6):
        SCHEDULE_CACHE.degraded(prog, {w})
    s1 = SCHEDULE_CACHE.stats()
    assert s1["misses"] == s0["misses"]
    assert s1["hits"] - s0["hits"] == 6
    assert SCHEDULE_CACHE.warm_survivors(prog, max_failures=2) == 6


def test_jobstream_rejects_elastic_plus_static_failed():
    with pytest.raises(ValueError, match="membership"):
        JobStream(failed={0}, elastic=ElasticController(Membership(2, 3)))


def test_jobstream_wraps_bare_membership():
    specs = make_specs(2, 3, 2, d=4)
    m = Membership(2, 3, policy=StragglerPolicy(demote=False))
    m.kill(5)
    stream = JobStream(elastic=m, pipeline=False)
    got = stream.run(specs)
    assert isinstance(stream.elastic, ElasticController)
    assert_bitwise(serial_oracle(specs), got, "bare membership")
    assert all(e.failed == {5} for e in stream.last_engines)


@pytest.mark.parametrize("pipeline", [False, True])
def test_jobstream_failed_and_elastic_run_like_jax(pipeline):
    """``JobStream(failed=)`` (raw degraded results: a failed server's
    functions on its migrate target) and ``JobStream(elastic=)`` (logical
    slots) on the port, bitwise the JAX package's streams."""
    from repro.runtime.fault import Membership as JMembership
    specs = make_specs(2, 4, 3, d=5)
    jspecs = chaos.make_specs(2, 4, 3, d=5)
    got = JobStream(failed={1, 6}, pipeline=pipeline).run(specs)
    want = JJobStream(failed={1, 6}, pipeline=pipeline).run(jspecs)
    assert_bitwise(want, got, "failed=")
    assert got[0][1] == {} and got[0][6] == {}
    m, jm = (M(2, 4, policy=StragglerPolicy(demote=False))
             for M in (Membership, JMembership))
    m.kill(2)
    jm.kill(2)
    got = JobStream(elastic=m, pipeline=pipeline).run(specs)
    assert_bitwise(JJobStream(elastic=jm, pipeline=pipeline).run(jspecs),
                   got, "elastic=")
    assert_bitwise(serial_oracle(specs), got, "elastic= vs oracle")
