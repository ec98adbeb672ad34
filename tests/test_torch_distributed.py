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
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=600)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
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
