"""The process lane of the port's coded shuffle: a real two-process
``torch.distributed`` run over gloo, the twin of
tests/test_distributed.py.

The parent starts two processes (one spawn per (q, k)), each holding its
block of the ``K = q*k`` workers (:func:`repro_torch.launch.mesh
.make_camr_mesh`), and each runs ``camr_shuffle(plan, contribs, mesh=)``
on its own rows, saving them. Every row must be BITWISE the JAX package's
``CAMREngine`` result on the same contributions (the parent computes it
from the same seed), and the bytes each coded stage sends across
processes must be the lowered send tables' inter-process deliveries
(``camr_edge_bytes`` of the JAX package where the processes are its
hosts):

* (2, 4), 4 workers a process: flat and two-level (the detected
  topology, hosts = 2), both routers, both codecs, f32 and bf16;
* (2, 3), 3 workers a process: 2 processes do not divide k = 3, so the
  plan is flat and a class straddles the blocks: stage 3 crosses too;
  f32, both routers and codecs.

Then the lane's other modes, each bitwise the stacked executor in two
processes at (2, 4) and (2, 3): the looped exchange (its permutation
counts and ledger the stacked one's), the verified wire clean and with
a corrupted payload or checksum word (``bad`` the stacked rows), the
debug dict, the degraded executor at every single failed worker and at
pairs across the blocks, and ``ShuffleStream(mesh=)`` (batching, depth,
``sync``, degrade to worker 2 and to the last worker / restore, faults
replayed in both processes, re-homing), ``stats()`` equal; and one JAX two-process run of the verified wire
with a corrupted word, outputs and mismatch counts equal the port's.
Each new pair of children has ``PAIR_TIMEOUT`` seconds.

Skips only when this torch build has no gloo.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import collective as jcoll
from repro.core.engine import CAMRConfig, CAMREngine
from repro.core.schedule import Topology as JTopology
from repro_torch.core.collective import (camr_shuffle, make_plan,
                                         scatter_contributions)
from repro_torch.core.schedule import Topology
from repro_torch.launch.mesh import (CAMRMesh, detect_topology,
                                     host_membership, make_camr_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: shard widths: k-1 | d; at (2, 4) d = 9 pads the packed bf16 lane
#: (9 lanes -> 5 words -> 6)
WIDTH = {(2, 4): 9, (2, 3): 6}
SEED = 7

_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.core.collective import (camr_shuffle, make_plan,
                                             scatter_contributions)
    from repro_torch.launch.mesh import (detect_topology, host_membership,
                                         init_distributed, make_camr_mesh)

    q, k, d, out_dir = {q}, {k}, {d}, {out!r}
    pid = int(sys.argv[1])
    if not init_distributed(coordinator='localhost:{port}',
                            num_processes=2, process_id=pid):
        print('init_distributed() returned False')
        sys.exit(3)
    K = q * k
    mesh = make_camr_mesh(K, device='cpu')
    assert (mesh.world, mesh.rank, mesh.K_local) == (2, pid, K // 2)
    topo = detect_topology(k)
    topos = [None] if topo.is_flat else [None, topo]
    rng = np.random.default_rng({seed})
    plan = make_plan(q, k, d)
    bg = rng.standard_normal((plan.J, k, K, d)).astype(np.float32)
    bg[0, 0, 0, 0] = -0.0
    mine = torch.from_numpy(scatter_contributions(plan, bg))[mesh.lo:mesh.hi]
    dtypes = ('float32', 'bfloat16') if k % 2 == 0 else ('float32',)
    hm = host_membership(q, k)
    report = {{'topology': list(topo.key()) if not topo.is_flat else None,
              'membership': None if hm is None else
              [hm.K, list(hm.topology.key())],
              'workers': list(mesh.workers), 'cases': {{}}}}
    for tp in topos:
        plan = make_plan(q, k, d, tp)
        for dt in dtypes:
            c = mine.to(getattr(torch, dt)).contiguous()
            for router in ('all_to_all', 'ppermute'):
                for codec in ('fused', 'multipass'):
                    out = camr_shuffle(plan, c, mesh=mesh, router=router,
                                       codec=codec)
                    tag = f"{{'flat' if tp is None else 'two_level'}}-" \\
                          f"{{dt}}-{{router}}-{{codec}}"
                    bits = out.view(torch.int16 if dt == 'bfloat16'
                                    else torch.int32).numpy()
                    np.save(os.path.join(out_dir, f'{{tag}}-{{pid}}.npy'), bits)
                    sent = plan.process_stats
                    report['cases'][tag] = {{
                        s: sent[s]['bytes'] for s in sent}}
    print(json.dumps(report))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_RUNS: dict = {}


def _run_pair(q, k, tmp_path_factory):
    """Spawn the two processes for (q, k) once; their reports and the
    directory of their saved rows."""
    if (q, k) in _RUNS:
        return _RUNS[q, k]
    if not torch.distributed.is_gloo_available():
        pytest.skip("this torch build has no gloo")
    out = str(tmp_path_factory.mktemp(f"pg_{q}_{k}"))
    code = _WORKER.format(q=q, k=k, d=WIDTH[q, k], out=out,
                          port=_free_port(), seed=SEED)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    outs = _spawn_pair(code, env)
    for pid, (rc, o, e) in enumerate(outs):
        assert rc == 0, f"process {pid}:\n{o[-2000:]}\n{e[-3000:]}"
    _RUNS[q, k] = ([json.loads(o.splitlines()[-1]) for _, o, _ in outs], out)
    return _RUNS[q, k]


def _engine(q, k, dtype):
    """The JAX package's engine results on the children's contributions
    (the same seed): ``results[s][(j, s)]``."""
    d = WIDTH[q, k]
    K = q * k
    bg = np.random.default_rng(SEED).standard_normal(
        (q ** (k - 1), k, K, d)).astype(np.float32)
    bg[0, 0, 0, 0] = -0.0
    if dtype == "bfloat16":
        bg = bg.astype(ml_dtypes.bfloat16)
    eng = CAMREngine(CAMRConfig(q=q, k=k, gamma=1), lambda job, sf: sf)
    return eng.run([[bg[j, t] for t in range(k)] for j in range(len(bg))])


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_two_process_rows_bitwise_engine(q, k, tmp_path_factory):
    reports, out = _run_pair(q, k, tmp_path_factory)
    K, J = q * k, q ** (k - 1)
    want_cases = (4 if k % 2 == 0 else 1) * 4   # layouts x dtypes x 4
    assert all(len(r["cases"]) == want_cases for r in reports)
    assert [r["workers"] for r in reports] == [list(range(K // 2)),
                                               list(range(K // 2, K))]
    assert reports[0]["topology"] == ([2, 4.0] if k % 2 == 0 else None)
    # the host fault domains of the layout: the two process blocks
    assert all(r["membership"] == ([K, [2, 4.0]] if k % 2 == 0 else None)
               for r in reports)
    refs = {}
    for tag in reports[0]["cases"]:
        dtype = tag.split("-")[1]
        if dtype not in refs:
            refs[dtype] = _engine(q, k, dtype)
        res = refs[dtype]
        bits = np.uint16 if dtype == "bfloat16" else np.uint32
        for pid in range(2):
            got = np.load(os.path.join(out, f"{tag}-{pid}.npy")).view(bits)
            assert got.shape == (K // 2, J, WIDTH[q, k])
            for i, s in enumerate(range(pid * K // 2, (pid + 1) * K // 2)):
                for j in range(J):
                    np.testing.assert_array_equal(
                        got[i, j],
                        np.ascontiguousarray(res[s][(j, s)]).view(bits),
                        err_msg=f"{tag} worker {s} job {j}")


def _inter_deliveries(plan, hosts):
    """Packets of the flat send tables whose sender and receiver lie in
    different blocks of ``K / hosts`` workers (camr_edge_bytes' count,
    which needs a two-level plan, made here for any block layout)."""
    prog, K = plan.program, plan.K
    block = np.arange(K) // (K // hosts)
    cross = block[:, None] != block[None, :]
    return sum(int((prog.stage_tables(st).a2a_send >= 0).sum(axis=3)
                   .sum(axis=0)[cross].sum()) for st in (1, 2))


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_two_process_cross_bytes_equal_the_send_tables(q, k,
                                                       tmp_path_factory):
    """Stages 1 and 2 send one packet row per inter-process delivery of
    the lowered send tables: at (2, 4) JAX's ``camr_edge_bytes`` (flat
    and two-level inter-host bytes, hosts = 2); at (2, 3) the flat
    tables' deliveries across the blocks, and stage 3 the unicasts of
    the straddling class."""
    reports, _ = _run_pair(q, k, tmp_path_factory)
    d = WIDTH[q, k]
    for tag in reports[0]["cases"]:
        layout, dtype = tag.split("-")[:2]
        sent = [r["cases"][tag] for r in reports]
        coded = sum(x["stage1"] + x["stage2"] for x in sent)
        itemsize = 2 if dtype == "bfloat16" else 4
        if k % 2 == 0:
            eb = jcoll.camr_edge_bytes(
                jcoll.make_plan(q, k, d, topology=JTopology.two_level(2)),
                itemsize=itemsize)
            assert coded == eb[f"{layout}_inter_bytes"], tag
            assert all(x["stage3"] == 0 for x in sent), tag
        else:
            plan = jcoll.make_plan(q, k, d)
            pk_b = d // (k - 1) * 4
            assert coded == _inter_deliveries(plan, 2) * pk_b, tag
            K = q * k
            s3 = sum(1 for o in range(q - 1)
                     for a, b in plan.program.s3_perms[o]
                     if a // (K // 2) != b // (K // 2))
            assert s3 > 0
            assert sum(x["stage3"] for x in sent) == \
                s3 * plan.J_own * d * itemsize, tag


@pytest.mark.parametrize("q,k,d", [(2, 3, 6), (2, 4, 9), (3, 3, 8)])
def test_one_process_mesh_is_the_stacked_shuffle(q, k, d):
    """Without a process group the mesh is one process holding every
    worker: the process lane runs the whole body locally, bitwise the
    stacked shuffle, and sends nothing."""
    mesh = make_camr_mesh(q * k, device="cpu")
    assert (mesh.world, mesh.rank, mesh.workers) == (1, 0, range(q * k))
    assert detect_topology(k).is_flat
    assert host_membership(q, k) is None
    topos = [None, Topology.two_level(2)] if k % 2 == 0 else [None]
    rng = np.random.default_rng(d)
    for tp in topos:
        plan = make_plan(q, k, d, tp)
        bg = rng.standard_normal((plan.J, k, q * k, d)).astype(np.float32)
        c = torch.from_numpy(scatter_contributions(plan, bg))
        for dt, view in ((torch.float32, torch.int32),
                         (torch.bfloat16, torch.int16)):
            for codec in ("fused", "multipass"):
                for router in ("all_to_all", "ppermute"):
                    cc = c.to(dt)
                    want = camr_shuffle(plan, cc, codec=codec, router=router)
                    got = camr_shuffle(plan, cc, codec=codec, router=router,
                                       mesh=mesh)
                    assert torch.equal(got.view(view), want.view(view))
                    assert all(s["bytes"] == 0
                               for s in plan.process_stats.values())


def test_process_lane_checks_its_block_and_host_layout(monkeypatch):
    """A block of the wrong size is refused; host blocks of a two-level
    plan must nest in the process blocks (phase B stays inside a
    process); a world that does not divide K is refused."""
    import repro_torch.launch.mesh as mesh_mod
    plan = make_plan(2, 6, 10, Topology.two_level(2))
    mesh = CAMRMesh(K=12, world=4, rank=0, device=torch.device("cpu"))
    c = torch.zeros((3, plan.J_own, 5, 12, 10))
    with pytest.raises(ValueError, match="host block"):
        camr_shuffle(plan, c, mesh=mesh)
    with pytest.raises(ValueError, match="contribs shape"):
        camr_shuffle(plan, c[:2], mesh=mesh)
    monkeypatch.setattr(mesh_mod, "_world", lambda: (2, 0))
    with pytest.raises(ValueError, match="equal blocks"):
        make_camr_mesh(7, device="cpu")


# --------------------------------------------------------------------- #
# the process lane's other modes: looped, verified and corrupted, debug,
# and ShuffleStream(mesh=), each bitwise the stacked executor
# --------------------------------------------------------------------- #
#: seconds a pair of children may take, so a hang fails the test
PAIR_TIMEOUT = 120

_MODES_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    from repro_torch.core.collective import (
        ShuffleStream, camr_shuffle, expected_collective_calls, make_plan,
        scatter_contributions)
    from repro_torch.core.schedule import Topology, payload_words
    from repro_torch.core.collective_stats import record_collectives
    from repro_torch.launch.mesh import init_distributed, make_camr_mesh
    from repro_torch.runtime.fault import (build_degraded_executor,
                                           smallest_unrecoverable_set)

    q, k, d, out_dir = {q}, {k}, {d}, {out!r}
    pid = int(sys.argv[1])
    if not init_distributed(coordinator='localhost:{port}',
                            num_processes=2, process_id=pid):
        print('init_distributed() returned False')
        sys.exit(3)
    K = q * k
    mesh = make_camr_mesh(K, device='cpu')
    lo, hi = mesh.lo, mesh.hi
    rng = np.random.default_rng({seed})
    plan0 = make_plan(q, k, d)
    bgs = [rng.standard_normal((plan0.J, k, K, d)).astype(np.float32)
           for _ in range(5)]
    bgs[0][0, 0, 0, 0] = -0.0
    full = [torch.from_numpy(scatter_contributions(plan0, bg)) for bg in bgs]
    layouts = {{'flat': None}}
    if k % 2 == 0:
        layouts['two_level'] = Topology.two_level(2)
    dtypes = ('float32', 'bfloat16') if k % 2 == 0 else ('float32',)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def same(a, b):
        return bool(torch.equal(bits(a), bits(b)))

    def first_row(stage, dev):
        valid = plan0.program.stage_tables(stage).valid[dev]
        return int(np.flatnonzero(valid)[0])

    rep = {{}}
    for dt in dtypes:
        c = full[0].to(getattr(torch, dt))
        mine = c[lo:hi].contiguous()
        for codec in ('fused', 'multipass'):
            p1, p2 = make_plan(q, k, d), make_plan(q, k, d)
            with record_collectives() as l1:
                want = camr_shuffle(p1, c, mode='looped', codec=codec)
            with record_collectives() as l2:
                got = camr_shuffle(p2, mine, mode='looped', codec=codec,
                                   mesh=mesh)
            st = p2.process_stats
            rep[f'looped-{{dt}}-{{codec}}'] = dict(
                bitwise=same(got, want[lo:hi]),
                perms=[p1.permutations, p2.permutations],
                expect=expected_collective_calls(p1, mode='looped'),
                ledger=[l1.as_dict(), l2.as_dict()],
                exchanges=st['stage1']['exchanges']
                + st['stage2']['exchanges'],
                bytes=st['stage1']['bytes'] + st['stage2']['bytes'])
        wp = payload_words(d, c.element_size(), k)
        pk = wp // (k - 1)
        specs = [None, (1, 1, first_row(1, 1), 1, 1),
                 (2, K - 2, first_row(2, K - 2), pk, 0x80000000)]
        for lay, topo in layouts.items():
            plan = make_plan(q, k, d, topo)
            for i, spec in enumerate(specs):
                want, wbad = camr_shuffle(plan, c, verify_wire=True,
                                          corrupt=spec)
                got, gbad = camr_shuffle(plan, mine, verify_wire=True,
                                         corrupt=spec, mesh=mesh)
                rep[f'verified-{{lay}}-{{dt}}-{{i}}'] = dict(
                    bitwise=same(got, want[lo:hi]),
                    bad=gbad.tolist(), want_bad=wbad[lo:hi].tolist(),
                    total=int(wbad.sum()))
                if (lay, dt, i) == ('flat', 'float32', 1):
                    np.save(os.path.join(out_dir, f'verified-{{pid}}.npy'),
                            bits(got).numpy())
                    np.save(os.path.join(out_dir, f'bad-{{pid}}.npy'),
                            gbad.numpy())
        for mode in ('batched', 'looped'):
            want = camr_shuffle(plan0, c, mode=mode, debug=True)
            got = camr_shuffle(plan0, mine, mode=mode, debug=True,
                               mesh=mesh)
            rep[f'debug-{{mode}}-{{dt}}'] = dict(
                keys=sorted(got) == sorted(want),
                bitwise=all(same(got[n], want[n][lo:hi])
                            for n in want if n != 'is_own'),
                is_own=bool(torch.equal(got['is_own'],
                                        want['is_own'][lo:hi])))

    def scenario(stream, waves):
        # waves through batching and depth, sync, the degraded lane
        # (degrade to worker 2, then to the last worker / restore) and back
        outs = stream.run_waves(waves)
        outs.append(stream.sync(waves[0]))
        stream.degrade({{2}})
        outs += stream.run_waves(waves[:3])
        outs.append(stream.sync(waves[1]))
        stream.degrade({{K - 1}})
        outs += stream.run_waves(waves[2:4])
        stream.restore()
        outs += stream.run_waves(waves[3:])
        return outs

    # the degraded executor's process lane at every single failed worker
    # (the last one's rows are read by no plan entry) and at recoverable
    # pairs with one failure in each block
    pairs = [(a, b) for a in range(K // 2)
             for b in range(K // 2, K)
             if smallest_unrecoverable_set(q, k, {{a, b}}) is None][:4]
    for dt in dtypes:
        c = full[1].to(getattr(torch, dt))
        mine = c[lo:hi].contiguous()
        for failed in [(f,) for f in range(K)] + pairs:
            one = build_degraded_executor(plan0.program, set(failed), d,
                                          c.dtype, 'cpu')
            two = build_degraded_executor(plan0.program, set(failed), d,
                                          c.dtype, 'cpu', mesh=mesh)
            rep[f'degraded-{{dt}}-{{failed}}'] = same(two(mine),
                                                     one(c)[lo:hi])

    def verified(stream, waves, topo):
        # one fault on a sync and one in the streamed waves, each caught
        # and replayed; a re-homing to flat and back
        stream.inject_corruption(stage=1, device=1, word=0, bits=1)
        outs = [stream.sync(waves[0])]
        stream.inject_corruption(stage=2, device=K - 2, word=1,
                                 bits=0x80000000)
        outs += stream.run_waves(waves[:4])
        if topo is not None:
            stream.set_topology(None)
            outs += stream.run_waves(waves[:2])
            stream.set_topology(topo)
        outs += stream.run_waves(waves[2:])
        return outs

    topo = layouts.get('two_level')
    for dt in dtypes:
        waves = [w.to(getattr(torch, dt)) for w in full]
        local = [w[lo:hi].contiguous() for w in waves]
        for name, run, kw in (
                ('stream', scenario, {{}}),
                ('stream_verified', lambda s, w: verified(s, w, topo),
                 dict(verify_wire=True, topology=topo))):
            one = ShuffleStream(q, k, d, device='cpu', wave_batch=2,
                                depth=2, **kw)
            want = run(one, waves)
            two = ShuffleStream(q, k, d, wave_batch=2, depth=2, mesh=mesh,
                                **kw)
            got = run(two, local)
            rep[f'{{name}}-{{dt}}'] = dict(
                n=[len(want), len(got)],
                bitwise=all(same(g, w[lo:hi]) for g, w in zip(got, want)),
                stats=[one.stats(), two.stats()])
    torch.distributed.barrier()
    print(json.dumps(rep))
""")


_MODE_RUNS: dict = {}


def _spawn_pair(code: str, env: dict) -> list:
    """Two children of ``code`` (rank as argv[1]), each given
    ``PAIR_TIMEOUT`` seconds; their (rc, stdout, stderr)."""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=PAIR_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a child ran past {PAIR_TIMEOUT} s")
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _run_modes(q, k, tmp_path_factory):
    if (q, k) in _MODE_RUNS:
        return _MODE_RUNS[q, k]
    if not torch.distributed.is_gloo_available():
        pytest.skip("this torch build has no gloo")
    out = str(tmp_path_factory.mktemp(f"pg_modes_{q}_{k}"))
    code = _MODES_WORKER.format(q=q, k=k, d=WIDTH[q, k], out=out,
                                port=_free_port(), seed=SEED)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    outs = _spawn_pair(code, env)
    for pid, (rc, o, e) in enumerate(outs):
        assert rc == 0, f"process {pid}:\n{o[-2000:]}\n{e[-3000:]}"
    _MODE_RUNS[q, k] = ([json.loads(o.splitlines()[-1]) for _, o, _ in outs],
                        out)
    return _MODE_RUNS[q, k]


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_process_lane_looped_bitwise_with_its_permutations(
        q, k, tmp_path_factory):
    """The looped exchange across processes: bitwise the stacked looped
    shuffle's rows, both codecs, f32 (and bf16 at (2, 4)); the
    permutation counts ``expected_collective_calls(mode="looped")`` and
    the ledger the stacked one's in each process; at least one
    permutation crosses the processes, and some move bytes."""
    reports, _ = _run_modes(q, k, tmp_path_factory)
    cases = [t for t in reports[0] if t.startswith("looped")]
    assert len(cases) == (4 if k % 2 == 0 else 2)
    for tag in cases:
        for r in reports:
            c = r[tag]
            assert c["bitwise"], tag
            stacked, lane = c["perms"]
            assert lane == stacked, tag
            assert lane["stage12"] == c["expect"]["stage12"], tag
            assert lane["stage3"] == c["expect"]["stage3"], tag
            assert c["ledger"][0] == c["ledger"][1], tag
            assert c["ledger"][1]["count_by_kind"] == {
                "collective-permute": c["expect"]["total"]}, tag
            assert 0 < c["exchanges"] <= c["expect"]["stage12"], tag
            assert c["bytes"] > 0, tag


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_process_lane_verified_and_corrupted_wire(q, k, tmp_path_factory):
    """The verified wire across processes: clean, a payload word of a
    device in process 0 and a checksum word of one in process 1
    corrupted; flat (and two-level at (2, 4)); outputs bitwise the
    stacked verified shuffle's rows, ``bad`` its ``int32[K_local]``
    rows; a corruption is counted (in the process of its receivers)."""
    reports, _ = _run_modes(q, k, tmp_path_factory)
    cases = [t for t in reports[0] if t.startswith("verified")]
    assert len(cases) == (12 if k % 2 == 0 else 3)
    for tag in cases:
        for r in reports:
            c = r[tag]
            assert c["bitwise"], tag
            assert c["bad"] == c["want_bad"], tag
            assert len(c["bad"]) == q * k // 2
        assert sum(sum(r[tag]["bad"]) for r in reports) == \
            reports[0][tag]["total"], tag
        assert (reports[0][tag]["total"] > 0) == (not tag.endswith("-0")), \
            tag


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_process_lane_debug_dict(q, k, tmp_path_factory):
    reports, _ = _run_modes(q, k, tmp_path_factory)
    cases = [t for t in reports[0] if t.startswith("debug")]
    assert len(cases) == (4 if k % 2 == 0 else 2)
    for tag in cases:
        for r in reports:
            assert r[tag] == dict(keys=True, bitwise=True, is_own=True), tag


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_shuffle_stream_over_processes(q, k, tmp_path_factory):
    """``ShuffleStream(mesh=)``: waves batched two a dispatch at depth 2,
    ``sync``, degrade / restore through the degraded lane's exchange, the
    verified stream's faults replayed in both processes (no hang), a
    re-homing to flat and back at (2, 4): every output bitwise the
    single-process stream's rows, ``stats()`` equal."""
    reports, _ = _run_modes(q, k, tmp_path_factory)
    dtypes = ("float32", "bfloat16") if k % 2 == 0 else ("float32",)
    for dt in dtypes:
        for name in ("stream", "stream_verified"):
            for r in reports:
                c = r[f"{name}-{dt}"]
                assert c["n"][0] == c["n"][1] > 0, (name, dt)
                assert c["bitwise"], (name, dt)
                one, two = c["stats"]
                assert one == two, (name, dt)
                if name == "stream":
                    assert two["swaps"] == 3 and two["degraded_compiles"] > 0
                else:
                    assert two["wire_faults"] == 2
                    assert two["wire_replays"] == 2
                    assert two["host_swaps"] == (2 if k % 2 == 0 else 0)


@pytest.mark.parametrize("q,k", [(2, 4), (2, 3)])
def test_degraded_executor_over_processes_every_failed_worker(
        q, k, tmp_path_factory):
    """``build_degraded_executor(mesh=)`` at every single failed worker,
    the last included (the degraded plan reads none of its rows, so the
    flat rows' owners must come from the layout, not from the rows
    read), and at recoverable pairs with one failure in each block, f32
    (and bf16 at (2, 4)): each process's outputs bitwise the
    single-process executor's rows."""
    reports, _ = _run_modes(q, k, tmp_path_factory)
    cases = [t for t in reports[0] if t.startswith("degraded")]
    K = q * k
    assert f"degraded-float32-({K - 1},)" in cases
    assert len(cases) >= K * (2 if k % 2 == 0 else 1)
    for tag in cases:
        for r in reports:
            assert r[tag] is True, tag


_JAX_VERIFIED = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import shard_map
    from repro.core.collective import (make_plan, camr_shuffle,
                                       scatter_contributions)
    from repro.launch.mesh import init_distributed, make_camr_mesh

    q, k, d, out_dir, spec = {q}, {k}, {d}, {out!r}, {spec!r}
    pid = int(sys.argv[1])
    if not init_distributed(coordinator='localhost:{port}',
                            num_processes=2, process_id=pid):
        print('SKIP: jax.distributed init unavailable')
        sys.exit(0)
    K = q * k
    plan = make_plan(q, k, d)
    mesh = make_camr_mesh(K)
    rng = np.random.default_rng({seed})
    bg = rng.standard_normal((plan.J, k, K, d)).astype(np.float32)
    bg[0, 0, 0, 0] = -0.0
    contribs = scatter_contributions(plan, bg)
    garr = jax.make_array_from_callback(
        contribs.shape, NamedSharding(mesh, P('camr')),
        lambda idx: contribs[idx])

    def body(c):
        out, bad = camr_shuffle(plan, c[0], axis_name='camr',
                                verify_wire=True, corrupt=spec)
        return out[None], bad[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P('camr'),
                           out_specs=(P('camr'), P('camr'))))
    out, bad = jax.block_until_ready(fn(garr))
    for arr, name in ((out, 'out'), (bad, 'bad')):
        for shard in arr.addressable_shards:
            s = shard.index[0].start
            np.save(f'{{out_dir}}/jax-{{name}}-{{s}}.npy',
                    np.asarray(shard.data)[0])
    print('OK', pid)
""")


def test_verified_corrupted_wire_equal_jax_two_processes(tmp_path_factory):
    """One JAX two-process point (``jax.distributed`` over gloo, 4 host
    devices a process, as tests/test_distributed.py runs it): the
    verified wire at (2, 4) with one corrupted payload word of device 1
    in stage 1. Each device's output and mismatch count equal the port's
    two-process lane's (the children above, same seed and spec)."""
    q, k = 2, 4
    K, d = q * k, WIDTH[q, k]
    reports, port_dir = _run_modes(q, k, tmp_path_factory)
    row = int(np.flatnonzero(
        make_plan(q, k, d).program.stage_tables(1).valid[1])[0])
    spec = (1, 1, row, 1, 1)
    out = str(tmp_path_factory.mktemp("jax_verified"))
    code = _JAX_VERIFIED.format(q=q, k=k, d=d, out=out, spec=spec,
                                port=_free_port(), seed=SEED)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={K // 2}")
    outs = _spawn_pair(code, env)
    if any("SKIP:" in o for _, o, _ in outs):
        pytest.skip("jax.distributed unavailable in this environment")
    for pid, (rc, o, e) in enumerate(outs):
        assert rc == 0 and f"OK {pid}" in o, f"process {pid}:\n{e[-3000:]}"
    got = np.concatenate([np.load(os.path.join(port_dir,
                                               f"verified-{pid}.npy"))
                          for pid in range(2)])
    bad = np.concatenate([np.load(os.path.join(port_dir, f"bad-{pid}.npy"))
                          for pid in range(2)])
    jax_out = np.stack([np.load(os.path.join(out, f"jax-out-{s}.npy"))
                        for s in range(K)])
    jax_bad = np.stack([np.load(os.path.join(out, f"jax-bad-{s}.npy"))
                        for s in range(K)])
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jax_out.view(np.uint32))
    np.testing.assert_array_equal(bad, jax_bad)
    assert bad.sum() > 0
