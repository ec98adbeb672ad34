"""The paper's camr-vs-uncoded-vs-allreduce comparison on the port:
``repro_torch.launch.camr_compare`` and the collective ledger of
``repro_torch.core.collective_stats``, held against the JAX package's
``repro.launch.camr_compare`` (which parses the same numbers out of
optimized HLO) in one subprocess with forced host devices."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.collective import (ShuffleStream, camr_shuffle,
                                         expected_collective_calls,
                                         make_plan, scatter_contributions,
                                         uncoded_reduce_scatter)
from repro_torch.core.schedule import Topology
from repro_torch.core import collective_stats
from repro_torch.launch import camr_compare
from repro_torch.launch.camr_compare import (allreduce_reduce_scatter,
                                             lower_schedules,
                                             measure_stream)
from repro_torch.core.collective_stats import (CollectiveStats,
                                               record_collectives)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (q, k, d, hosts or None): the two flat points and the two-level one
POINTS = [(2, 3, 64, None), (3, 3, 8, None), (2, 4, 9, 2)]

#: JAX's lower_schedules at POINTS on the CPU: (camr_wire, camr_ops,
#: uncoded_wire, allreduce_wire, analytic camr_total)
JAX_NUMBERS = {
    (2, 3, 64): (3584, {"all-to-all": 4, "collective-permute": 1},
                 12288, 12288, 9216),
    (3, 3, 8): (1056, {"all-to-all": 4, "collective-permute": 2},
                5184, 5184, 4320),
    (2, 4, 9): (1584, {"all-to-all": 6, "collective-permute": 13},
                4608, 4608, 3456),
}
JAX_EDGE_BYTES = dict(hosts=2, packet_bytes=12, flat_inter_bytes=1536,
                      flat_intra_bytes=1920, two_level_inter_bytes=768,
                      two_level_intra_bytes=2688, s3_inter_bytes=0)

_JAX = textwrap.dedent("""
    import json
    from repro.core.schedule import Topology
    from repro.launch.camr_compare import lower_schedules
    out = []
    for q, k, d, hosts in {points!r}:
        topo = None if hosts is None else Topology.two_level(hosts)
        out.append(lower_schedules(q, k, d, topology=topo))
    print(json.dumps(out, default=str))
""")


def _topo(hosts):
    return None if hosts is None else Topology.two_level(hosts)


def _port(q, k, d, hosts):
    return lower_schedules(q, k, d, topology=_topo(hosts), device="cpu")


def test_lower_schedules_equal_jax_hlo_parse():
    """Every key of JAX's dict at each point, compared exactly: wire
    bytes and collectives by kind of the three schemes, ``analytic``,
    and on the two-level point ``topology``, ``edge_bytes``,
    ``edge_loads`` and the hierarchical loads."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    res = subprocess.run([sys.executable, "-c",
                          _JAX.format(points=POINTS)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_dicts = json.loads(res.stdout.splitlines()[-1])
    for point, want in zip(POINTS, jax_dicts):
        got = json.loads(json.dumps(_port(*point), default=str))
        assert got == want, point


@pytest.mark.parametrize("q,k,d,hosts", POINTS)
def test_lower_schedules_pinned_numbers(q, k, d, hosts):
    """The JAX numbers of the same points, pinned: the ledger's wire
    bytes and op counts, and the op counts are
    ``expected_collective_calls``'."""
    r = _port(q, k, d, hosts)
    wire, ops, unc, ar, analytic = JAX_NUMBERS[q, k, d]
    assert (r["camr_wire"], r["camr_ops"]) == (wire, ops)
    assert (r["uncoded_wire"], r["uncoded_ops"]) == (unc,
                                                     {"all-reduce": 1})
    assert (r["allreduce_wire"], r["allreduce_ops"]) == (ar,
                                                         {"all-reduce": 1})
    assert r["analytic"]["camr_total"] == analytic
    exp = expected_collective_calls(make_plan(q, k, d, _topo(hosts)))
    assert sum(r["camr_ops"].values()) == exp["total"]
    assert r["camr_ops"]["collective-permute"] == (
        exp["total"] - 2 * (k - 1))
    if hosts is not None:
        assert r["edge_bytes"] == JAX_EDGE_BYTES
        assert r["topology"] == {"hosts": 2, "alpha": 4.0}


@pytest.mark.parametrize("q,k,d,hosts", POINTS + [(4, 4, 63, None),
                                                   (2, 6, 10, 3)])
def test_ledger_linear_in_width(q, k, d, hosts):
    """Where ``k-1`` divides the width, every collective the ledger notes
    is ``d`` or ``d/(k-1)`` whole words wide, so the ledger at ``3d`` is
    three times the ledger at ``d`` (op counts equal), both routers, and
    so are the edge bytes: the chip run holds its ledger at a width too
    large for the host to the CPU's at a divisor of it, scaled."""
    one, three = _port(q, k, d, hosts), _port(q, k, 3 * d, hosts)
    for m in ("camr", "uncoded", "allreduce"):
        assert three[f"{m}_wire"] == 3 * one[f"{m}_wire"], m
        assert three[f"{m}_ops"] == one[f"{m}_ops"], m
    if hosts is not None:
        assert three["edge_bytes"] == {
            n: v if n in ("hosts",) else 3 * v
            for n, v in one["edge_bytes"].items()}
    wires = []
    for w in (d, 3 * d):
        plan = make_plan(q, k, w, _topo(hosts))
        with record_collectives() as st:
            camr_shuffle(plan, torch.zeros((plan.K, plan.J_own, k - 1,
                                            plan.K, w)), router="ppermute")
        wires.append(st.wire_bytes)
    assert wires[1] == 3 * wires[0] > 0


def _contribs(plan, dtype, seed=0):
    rng = np.random.default_rng(seed)
    bg = rng.standard_normal((plan.J, plan.k, plan.K, plan.d)).astype(
        np.float32)
    return torch.from_numpy(scatter_contributions(plan, bg)).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ledger_off_by_default_and_bits_unchanged(dtype):
    """With no block open nothing is recorded (a closed ledger stays
    empty); a shuffle's bits are the same with the recorder on and off,
    in every mode, router, codec, on a two-level plan and on the
    verified wire; the baselines' too."""
    with record_collectives() as closed:
        pass
    assert not collective_stats._OPEN
    flat, two = make_plan(2, 4, 6), make_plan(2, 4, 6, Topology.two_level(2))
    c = _contribs(flat, dtype)
    runs = [(flat, dict(mode=m, router=r, codec=cd))
            for m in ("batched", "looped")
            for r in ("all_to_all", "ppermute")
            for cd in ("fused", "multipass")]
    runs += [(two, dict(router=r)) for r in ("all_to_all", "ppermute")]
    runs += [(flat, dict(verify_wire=True)), (two, dict(verify_wire=True))]
    for plan, kw in runs:
        off = camr_shuffle(plan, c, **kw)
        with record_collectives() as st:
            on = camr_shuffle(plan, c, **kw)
        assert st.count_by_kind, kw
        if kw.get("verify_wire"):
            assert torch.equal(off[1], on[1])
            off, on = off[0], on[0]
        assert torch.equal(_bits(off), _bits(on)), kw
    for fn in (uncoded_reduce_scatter, allreduce_reduce_scatter):
        off = fn(c, plan=flat)
        with record_collectives() as st:
            on = fn(c, plan=flat)
        assert st.count_by_kind == {"all-reduce": 1}
        assert torch.equal(_bits(off), _bits(on))
    assert closed == CollectiveStats()


#: (mode, router) x (q, k, hosts); a two-level plan runs the batched
#: mode only
_LEDGER_CASES = [(m, r, q, k, h)
                 for m, r in (("batched", "all_to_all"),
                              ("batched", "ppermute"),
                              ("looped", "all_to_all"))
                 for q, k, h in ((2, 3, None), (3, 3, None), (2, 4, 2))
                 if h is None or m == "batched"]


@pytest.mark.parametrize("mode,router,q,k,hosts", _LEDGER_CASES)
def test_ledger_counts_are_expected_collective_calls(mode, router, q, k,
                                                     hosts):
    """The ledger's collectives of a shuffle are the JAX executor's:
    ``expected_collective_calls`` by kind, and the bytes of each kind
    the per-device result sizes (packets of ``pk`` words, stage 3's
    ``[J_own, d]`` values)."""
    d = 2 * (k - 1)
    plan = make_plan(q, k, d, _topo(hosts))
    with record_collectives() as st:
        camr_shuffle(plan, _contribs(plan, torch.float32), mode=mode,
                     router=router)
    exp = expected_collective_calls(plan, mode=mode, router=router)
    a2a = 2 * (k - 1) if (mode, router) == ("batched", "all_to_all") else 0
    assert st.count_by_kind.get("all-to-all", 0) == a2a
    assert st.count_by_kind["collective-permute"] == exp["total"] - a2a
    assert st.count_by_kind == st.as_dict()["count_by_kind"]
    pk_b = d // (k - 1) * 4
    s3 = (q - 1) * plan.J_own * d * 4
    assert (st.bytes_by_kind["collective-permute"]
            + st.bytes_by_kind.get("all-to-all", 0) - s3) % pk_b == 0
    assert st.wire_bytes == st.total_bytes


def test_allreduce_scheme_is_the_dense_sum():
    """The dense scheme is JAX's ``allreduce_fn``: every stored batch
    added (duplicates included) into its job's rows, worker ``s``
    keeping shard ``s``."""
    plan = make_plan(2, 3, 4)
    c = _contribs(plan, torch.float32)
    want = np.zeros((plan.J, plan.K, plan.d), np.float32)
    for s in range(plan.K):
        for a, j in enumerate(plan.owned_jobs[s]):
            want[j] += c[s, a].sum(dim=0).numpy()
    got = allreduce_reduce_scatter(c, plan=plan)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 0, 2),
                               rtol=1e-6, atol=1e-6)


def test_measure_stream_checks_and_churn():
    """``measure_stream``'s checks at (2, 3, 256), 8 waves, wave_batch 2,
    worker 0 killed at wave 3 and restored at wave 6: outputs close to
    the reference and bitwise the serial ones, churned outputs bitwise,
    ``compiles`` flat, two swaps."""
    r = measure_stream(2, 3, 256, 8, wave_batch=2, kill_at=3, rejoin_at=6,
                       device="cpu")
    assert r["waves"] == 8 and r["serial_s"] > 0 and r["stream_s"] > 0
    assert r["churn"]["swaps"] == 2
    assert r["churn"]["compiles"] == 1


def test_cli_prints_the_comparison(capsys):
    """``main`` on the CPU: the JSON dict, the three wire lines, the
    two-level edge lines and ``--topology auto``'s pick; the stream and
    churn lines. Without ``--device`` and without a card it raises."""
    camr_compare.main(["--q", "2", "--k", "4", "--d", "9", "--topology",
                       "two-level", "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"camr_wire": 1584' in out
    assert "x of allreduce" in out and "inter-host cut x2.00" in out
    camr_compare.main(["--q", "2", "--k", "4", "--d", "6", "--topology",
                       "auto", "--alpha", "8", "--device", "cpu",
                       "--stream", "3", "--kill-at", "1"])
    out = capsys.readouterr().out
    assert out.startswith("auto-topology: picked ")
    assert "stream     3 waves" in out and "churn      kill worker 0" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            camr_compare.main(["--q", "2", "--k", "3", "--d", "4"])


def test_stream_degrade_is_ledger_free():
    """A degraded wave runs no coded collective (the survivor-set
    executor's gathers), a healthy one the shuffle's."""
    s = ShuffleStream(2, 3, 4, device="cpu")
    c = _contribs(make_plan(2, 3, 4), torch.float32)
    with record_collectives() as healthy:
        s.sync(c)
    s.degrade({1})
    with record_collectives() as degraded:
        s.sync(c)
    assert healthy.count_by_kind and degraded == CollectiveStats()


def test_cli_default_width_is_refused_by_both_packages():
    """Both CLIs default to (q, k, d) = (4, 4, 4096), which neither
    package's ``make_plan`` takes (k-1 = 3 does not divide 4096): the
    port keeps the flags and refuses it the same way. The chip run takes
    (4, 4, 4095)."""
    from repro.core.collective import make_plan as jax_make_plan
    for mk in (make_plan, jax_make_plan):
        with pytest.raises(ValueError, match="divisible by k-1=3"):
            mk(4, 4, 4096)
    with pytest.raises(ValueError, match="divisible by k-1=3"):
        camr_compare.main(["--device", "cpu"])
