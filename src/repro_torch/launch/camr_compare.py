"""The paper's technique on the wire: the twin of
``repro.launch.camr_compare``.

Runs THREE gradient-aggregation schedules for the same semantic task —
deliver the summed gradient shard of each of J jobs to its reducer on a
K-worker axis — and reads what each puts on the wire from the collective
ledger (:mod:`repro_torch.core.collective_stats`), where the JAX module
parses the optimized HLO:

  camr      the 3-stage coded shuffle (repro_torch.core.collective)
  uncoded   masked psum + shard slice (same placement, no coding)
  allreduce dense psum of the [J, K, d] gradient block (what a naive
            data-parallel trainer ships)

Also reports the analytic byte model (``camr_collective_bytes``) so the
ledger can be cross-checked. The counts depend on shapes only, so each
scheme runs once on zero contributions of the requested width.

    PYTHONPATH=src python -m repro_torch.launch.camr_compare --q 4 --k 4 \\
        --d 4096 [--device cpu]

``--stream W`` additionally measures multi-wave throughput: W waves
dispatched serially (one shuffle per wave) vs. through
:class:`~repro_torch.core.collective.ShuffleStream` (waves stacked,
``depth`` dispatches in flight), with outputs verified against the
per-wave oracle.

    PYTHONPATH=src python -m repro_torch.launch.camr_compare --q 2 --k 3 \\
        --d 256 --stream 8 --device cpu

Without ``--device cpu`` it runs on the current CUDA device and raises
where there is none.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.collective import (CAMRPlan, ShuffleStream,
                               camr_collective_bytes, camr_edge_bytes,
                               camr_shuffle, camr_shuffle_reference,
                               make_plan, scatter_contributions,
                               uncoded_reduce_scatter)
from ..core.loads import (camr_edge_loads, camr_load_hierarchical,
                          uncoded_load_hierarchical)
from ..core.schedule import Topology
from ..device import resolve_device
from ..core.collective_stats import note, record_collectives

__all__ = ["allreduce_reduce_scatter", "schemes", "lower_schedules",
           "measure_stream", "main"]


def allreduce_reduce_scatter(contribs: torch.Tensor, *,
                             plan: CAMRPlan) -> torch.Tensor:
    """The dense data-parallel sync of the JAX module's ``allreduce_fn``,
    stacked over the worker axis: every worker adds the sum of its
    stored batches into the job rows of a dense ``[J, K, d]`` block, the
    blocks are summed over the workers (one ``psum`` each in JAX; here
    the adds go into one ``[J, K, d]`` sum), and worker ``s`` keeps shard
    ``s`` of every job -> ``[K, J, d]``. Like JAX's, it does not mask the
    duplicate batch copies: it stands for the bytes of a classic
    all-reduce trainer, not for CAMR's result."""
    K, J, J_own = plan.K, plan.J, plan.J_own
    dev = contribs.device
    part = contribs.sum(dim=2)                            # [K, J_own, K, d]
    total = torch.zeros((J, K, plan.d), dtype=contribs.dtype, device=dev)
    jobs = torch.as_tensor(plan.owned_jobs.reshape(-1).astype(np.int64),
                           device=dev)
    total.index_put_((jobs,), part.reshape(K * J_own, K, plan.d),
                     accumulate=True)
    del part
    note("all-reduce", total.numel() * total.element_size())
    return total.transpose(0, 1).contiguous()


def schemes(plan: CAMRPlan, codec: str = "fused") -> dict:
    """The three schedules as callables ``contribs [K, J_own, k-1, K, d]
    -> [K, J, d]``, by name."""
    return {
        "camr": lambda c: camr_shuffle(plan, c, codec=codec),
        "uncoded": lambda c: uncoded_reduce_scatter(c, plan=plan),
        "allreduce": lambda c: allreduce_reduce_scatter(c, plan=plan),
    }


def lower_schedules(q: int, k: int, d: int, codec: str = "fused",
                    topology: Topology | None = None, *,
                    device=None) -> dict:
    """Each scheme's wire bytes (all-reduce counted twice, as a ring
    moves it) and collectives by kind from one run on zero f32
    contributions on ``device``, the analytic byte model, and on a
    two-level topology the per-edge split: the JAX module's dict."""
    dev = resolve_device(device)
    plan = make_plan(q, k, d, topology=topology)
    K, J, J_own = plan.K, plan.J, plan.J_own
    contribs = torch.zeros((K, J_own, k - 1, K, d), dtype=torch.float32,
                           device=dev)
    out = {"q": q, "k": k, "K": K, "J": J, "d": d}
    for name, fn in schemes(plan, codec).items():
        with record_collectives() as st:
            res = fn(contribs)
        del res                     # free before the next scheme runs
        out[f"{name}_wire"], out[f"{name}_ops"] = (st.wire_bytes,
                                                   st.count_by_kind)
    del contribs
    out["analytic"] = camr_collective_bytes(plan)
    if plan.topology is not None:
        # per-edge split on the two-level topology: counted from the
        # lowered send tables + the closed forms
        topo = plan.topology
        out["topology"] = {"hosts": topo.hosts, "alpha": topo.alpha}
        out["edge_bytes"] = camr_edge_bytes(plan)
        out["edge_loads"] = {
            sched: dict(zip(("intra", "inter"),
                            camr_edge_loads(q, k, topo.hosts,
                                            schedule=sched)))
            for sched in ("flat", "two_level")}
        out["hier_load"] = camr_load_hierarchical(q, k, topo.hosts,
                                                  topo.alpha)
        out["uncoded_hier_load"] = uncoded_load_hierarchical(
            q, k, topo.hosts, topo.alpha)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_stream(q: int, k: int, d: int, waves: int,
                   wave_batch: int = 2, depth: int = 2,
                   codec: str = "fused", kill_at: int | None = None,
                   rejoin_at: int | None = None,
                   kill_worker: int = 0, *, device=None) -> dict:
    """Serial-dispatch vs. ShuffleStream wall time over ``waves`` waves
    of random contributions (outputs checked against the oracle).

    ``kill_at`` additionally replays the same waves through a churn
    pass: worker ``kill_worker`` is degraded at wave ``kill_at`` (and
    restored at ``rejoin_at``, if given) through the stream's degraded
    lane. Every churned output must stay BIT-identical to the healthy
    serial output, and the healthy executors must survive the swap
    (``compiles`` flat: degrade/restore builds no healthy executor)."""
    dev = resolve_device(device)
    plan = make_plan(q, k, d)
    K = plan.K
    rng = np.random.default_rng(0)
    bgs = [rng.standard_normal((plan.J, k, K, d)).astype(np.float32)
           for _ in range(waves)]
    contribs = [torch.from_numpy(scatter_contributions(plan, bg)).to(dev)
                for bg in bgs]

    camr_shuffle(plan, contribs[0], codec=codec)        # build the tables
    _sync(dev)
    t0 = time.perf_counter()
    serial_out = [camr_shuffle(plan, c, codec=codec).cpu() for c in contribs]
    t_serial = time.perf_counter() - t0

    stream = ShuffleStream(q, k, d, device=dev, wave_batch=wave_batch,
                           depth=depth, codec=codec)
    # build every stack width the timed run will dispatch (full batches
    # of W=wave_batch, plus the trailing partial batch)
    stream.run_waves(contribs[:wave_batch])
    if waves % wave_batch:
        stream.run_waves(contribs[:waves % wave_batch])
    _sync(dev)
    t0 = time.perf_counter()
    outs = stream.run_waves(contribs)
    t_stream = time.perf_counter() - t0

    for out, bg, ser in zip(outs, bgs, serial_out):
        np.testing.assert_allclose(out.numpy(),
                                   camr_shuffle_reference(plan, bg),
                                   rtol=2e-5, atol=2e-6)
        assert torch.equal(out.view(torch.int32), ser.view(torch.int32)), \
            "streamed output is not bitwise the serial one"
    res = dict(waves=waves, wave_batch=wave_batch, depth=depth,
               serial_s=t_serial, stream_s=t_stream,
               speedup=t_serial / t_stream,
               stream_wps=waves / t_stream)

    if kill_at is not None:
        compiles_before = stream.stats()["compiles"]
        for i, c in enumerate(contribs):
            if i == kill_at:
                stream.degrade({kill_worker})
            if rejoin_at is not None and i == rejoin_at:
                stream.restore()
            stream.submit(c)
        churned = stream.drain()
        stream.restore()
        for out, ser in zip(churned, serial_out):
            assert torch.equal(out.view(torch.int32),
                               ser.view(torch.int32)), \
                "a churned output is not bitwise the healthy one"
        st = stream.stats()
        assert st["compiles"] == compiles_before, \
            "degrade/restore must not rebuild the healthy executors"
        res["churn"] = dict(kill_at=kill_at, rejoin_at=rejoin_at,
                            worker=kill_worker, swaps=st["swaps"],
                            compiles=st["compiles"])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--stream", type=int, default=0, metavar="W",
                    help="also time W waves: serial dispatch vs "
                         "ShuffleStream (stacked waves, depth in flight)")
    ap.add_argument("--wave-batch", type=int, default=2)
    ap.add_argument("--kill-at", type=int, default=None, metavar="W",
                    help="with --stream: degrade one worker at wave W "
                         "and replay the stream through the degraded "
                         "lane (outputs stay bit-identical, healthy "
                         "executors stay built)")
    ap.add_argument("--rejoin-at", type=int, default=None, metavar="W",
                    help="restore the killed worker at wave W")
    ap.add_argument("--kill-worker", type=int, default=0, metavar="N",
                    help="which worker --kill-at degrades (default 0)")
    ap.add_argument("--codec", choices=("fused", "multipass"),
                    default="fused",
                    help="XOR codec lane: fused single-pass gather "
                         "kernels vs the multipass oracle")
    ap.add_argument("--topology", choices=("flat", "two-level", "auto"),
                    default="flat",
                    help="lowering topology: two-level adds the "
                         "host-aware gateway/relay schedule and per-edge "
                         "load columns; auto picks flat vs two-level "
                         "from the alpha cost model "
                         "(camr_load_hierarchical vs camr_load_p2p)")
    ap.add_argument("--hosts", type=int, default=2, metavar="N",
                    help="with --topology two-level/auto: host count "
                         "(two-level needs hosts | k; default 2)")
    ap.add_argument("--alpha", type=float, default=4.0, metavar="X",
                    help="modeled inter-host cost per byte relative to "
                         "intra-host (default 4.0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.kill_at is not None and not args.stream:
        ap.error("--kill-at needs --stream W (churn replays the "
                 "streamed waves)")
    device = resolve_device(args.device)
    topology = None
    if args.topology == "two-level":
        topology = Topology.two_level(args.hosts, alpha=args.alpha)
        try:
            topology.check(args.q, args.k)
        except ValueError as e:
            ap.error(str(e))
    elif args.topology == "auto":
        topology = Topology.auto(args.hosts, alpha=args.alpha).resolve(
            args.q, args.k)
        pick = "flat" if topology is None else \
            f"two-level(hosts={topology.hosts})"
        if args.hosts < 2 or args.k % args.hosts:
            why = (f"hosts={args.hosts} does not give class-aligned "
                   f"blocks for k={args.k}")
        else:
            intra_f, inter_f = camr_edge_loads(args.q, args.k,
                                               args.hosts,
                                               schedule="flat")
            flat_cost = intra_f + args.alpha * inter_f
            two_cost = camr_load_hierarchical(args.q, args.k,
                                              args.hosts, args.alpha)
            why = (f"alpha={args.alpha:g}: L_flat={flat_cost:.3f} vs "
                   f"L_two_level={two_cost:.3f}")
        print(f"auto-topology: picked {pick}  [{why}]")
    res = lower_schedules(args.q, args.k, args.d, codec=args.codec,
                          topology=topology, device=device)
    print(json.dumps(res, indent=1, default=str))
    w = {m: res[f"{m}_wire"] for m in ("camr", "uncoded", "allreduce")}
    base = w["allreduce"]
    for m, b in w.items():
        print(f"{m:10s} wire={b / 2**20:9.2f} MiB  "
              f"({b / base:6.3f}x of allreduce)")
    if topology is not None:
        eb, el = res["edge_bytes"], res["edge_loads"]
        print(f"edges      hosts={topology.hosts} alpha={topology.alpha:g}"
              f"  L_hier={res['hier_load']:.3f}"
              f"  (uncoded {res['uncoded_hier_load']:.3f})")
        for sched in ("flat", "two_level"):
            print(f"  {sched:9s} inter={eb[f'{sched}_inter_bytes']:>12,}B"
                  f" (L={el[sched]['inter']:.3f})"
                  f"  intra={eb[f'{sched}_intra_bytes']:>12,}B"
                  f" (L={el[sched]['intra']:.3f})")
        cut = (eb["flat_inter_bytes"] / eb["two_level_inter_bytes"]
               if eb["two_level_inter_bytes"] else float("inf"))
        print(f"  inter-host cut x{cut:.2f} (= k/hosts)")
    if args.stream:
        s = measure_stream(args.q, args.k, args.d, args.stream,
                           wave_batch=args.wave_batch, codec=args.codec,
                           kill_at=args.kill_at,
                           rejoin_at=args.rejoin_at,
                           kill_worker=args.kill_worker, device=device)
        print(f"stream     {s['waves']} waves: serial="
              f"{s['serial_s'] * 1e3:.1f}ms  pipelined="
              f"{s['stream_s'] * 1e3:.1f}ms  "
              f"({s['speedup']:.2f}x, {s['stream_wps']:.1f} waves/s)")
        if "churn" in s:
            c = s["churn"]
            rj = ("" if c["rejoin_at"] is None
                  else f" rejoin@{c['rejoin_at']}")
            print(f"churn      kill worker {c['worker']} @wave "
                  f"{c['kill_at']}{rj}: outputs bit-identical, "
                  f"swaps={c['swaps']}, compiles={c['compiles']} "
                  "(no rebuild)")


if __name__ == "__main__":
    main()
