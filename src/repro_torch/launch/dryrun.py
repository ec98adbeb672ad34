"""Dry run of one step on one card or on JAX's production meshes, the
twin of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, the step of
:mod:`repro_torch.launch.steps` is built on ``"meta"`` (shapes only,
nothing allocated on any device) and run once in eager mode under
:class:`StepTracer`, which counts three things:

* **FLOPs**: the aten matrix products by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``; forward, backward and, at
  the config's ``remat = "block"``, the backward's recompute of each
  checkpointed unit and loss chunk), plus the hand-written kernels'
  formulas (:mod:`repro_torch.kernels.cost`), which their ``meta``
  routes charge;
* **bytes**: the bytes of the inputs and outputs of every aten op
  (views and bare allocations move none), plus the kernels' formulas;
* **memory**: every storage the step creates and frees (the
  recompute's too); the peak of the live bytes, arguments included, is
  what a card must hold.

The record has JAX's keys: ``memory.{argument,output,temp,alias}_bytes``
(``temp`` is the peak live bytes less the arguments, ``alias`` the
outputs that are arguments updated in place), ``cost.{flops,
bytes_accessed}``, ``collectives`` from the collective ledger
(:mod:`repro_torch.core.collective_stats`; a step on one card runs
none), ``params``, ``params_active``, ``devices`` (1 on a card),
``lower_s`` (the trace) and ``compile_s`` (0: nothing is compiled), and beside them
``memory.peak_bytes``, ``fits`` (the peak within
:data:`repro_torch.launch.roofline.HBM_BYTES`) and the kernels' share
(``kernels``). A step reads no value back to the host: a host read of a
``meta`` tensor raises, and the cell ends ``error`` with the op named.

``--mesh`` picks the mesh: ``card`` (the default: the whole step on one
card, ``devices`` 1), or JAX's ``single`` (the (16, 16) ``(data,
model)`` pod, 256 devices) and ``multipod`` ((2, 16, 16), 512). On a
mesh the step of :mod:`repro_torch.launch.steps` is built for rank 0 of
a fake process group of that size (:func:`repro_torch.launch.mesh.
fake_group`; JAX compiles for 512 fake host devices instead) and traced
the same way, with every count that rank's: DTensor runs each op as
local ops on the rank's shards and the collectives of its
redistributes, the tracer counts those (``FlopCounterMode`` itself would
see the DTensor ops at their global shapes, and DTensor's own shape
inference runs each op on fake tensors of the global shapes, which the
tracer skips), and each collective's result bytes go to the collective
ledger with the link it crosses, where JAX parses them out of the HLO
(``hlo_stats``). ``fits`` is then per device.

Results go to ``results/dryrun_torch/<arch>_<shape>_<mesh>.json``;
:mod:`repro_torch.launch.roofline` reads them.

Usage (no card needed)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
        --shape train_4k [--mesh {card,single,multipod}]   # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh ...]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCHS, SHAPES, ShapeSpec, get_config,
                       shape_supported)
from ..core.collective_stats import note, record_collectives
from ..kernels import cost as kernel_cost
from .mesh import fake_group, make_production_mesh, mesh_devices
from .steps import build_step

__all__ = ["StepTracer", "trace_step", "run_cell", "cost_pass", "save",
           "main", "mesh_for", "RESULTS_DIR", "MESHES"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

_aten = torch.ops.aten
_c10d = torch.ops._c10d_functional
#: the functional collectives a DTensor step runs (each rank's share of
#: a redistribute), by the HLO kind name the collective ledger keeps
_COLLECTIVES = {_c10d.all_gather_into_tensor.default: "all-gather",
                _c10d.reduce_scatter_tensor.default: "reduce-scatter",
                _c10d.all_reduce.default: "all-reduce",
                _c10d.all_to_all_single.default: "all-to-all",
                torch.ops._dtensor.shard_dim_alltoall.default: "all-to-all"}
_FAKE = torch._C._TorchDispatchModeKey.FAKE
#: meshes of the dry run: one card, and JAX's pod and two pods (this
#: rank's program traced over a fake group of that many ranks)
MESHES = {"card": 1, "single": 256, "multipod": 512}
#: ops that allocate without moving a byte
_ALLOCS = {_aten.empty.memory_format, _aten.empty_strided.default,
           _aten.new_empty.default, _aten.new_empty_strided.default,
           _aten.empty_like.default}


def _tensors(tree) -> list:
    """The tensors of nested dicts, lists, tuples and dataclasses (the
    optimiser state), in order; of a DTensor, this rank's shard."""
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _link(args) -> str:
    """The link a collective crosses: ``"nvlink"`` when every rank of its
    group sits in this rank's node of :data:`repro_torch.launch.
    roofline.GPUS_PER_NODE` cards, else ``"network"``."""
    from torch.distributed import distributed_c10d as c10d
    from .roofline import GPUS_PER_NODE
    name = [a for a in args if isinstance(a, str)][-1]
    ranks = c10d.get_process_group_ranks(c10d._resolve_process_group(name))
    return ("nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1
            else "network")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTracer(TorchDispatchMode):
    """Bytes of every aten op and the live bytes of every storage.

    ``bytes``: the sum over ops of their input and output tensors' bytes
    (a view, a bare allocation, a collective and an op on no tensor add
    nothing). ``live`` / ``peak``: the bytes of the storages alive now /
    at most since the tracer opened, counting from the storages of
    ``args`` (the step's arguments); a storage counts from the op that
    made it until it is freed (a weak reference to it says when).
    ``flops``: the matrix products' FLOPs by ``FlopCounterMode``'s
    formulas.

    A DTensor op is handed back to DTensor (``NotImplemented``), which
    runs it as local ops on this rank's shards and the collectives of its
    redistributes; the tracer counts those, so every count is this
    rank's, and feeds each collective's result bytes to the collective
    ledger (:func:`repro_torch.core.collective_stats.note`). A
    collective's ``wait_tensor`` and autograd wrapper return their input
    (or a wrapper holding it) on a device, but an empty copy on ``meta``:
    the tracer counts their output as the input's bytes on every device,
    so the ``meta`` trace's peak is the card's."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.flops = 0
        self._refs: dict = {}
        for t in _tensors(args):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _alias(self, out: torch.Tensor, src: torch.Tensor) -> None:
        """``out`` holds ``src``'s bytes: its storage counts nothing and
        keeps ``src``'s alive while it lives."""
        st, keep = out.untyped_storage(), src.untyped_storage()
        key = id(st)
        if key in self._refs:
            return

        def freed(_, key=key, keep=keep):
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(_FAKE) is not None \
                or any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs each op once on fake
            # tensors of the global shapes to learn its output's shape:
            # no work of this rank
            return func(*args, **(kwargs or {}))
        out = func(*args, **(kwargs or {}))
        kind = _COLLECTIVES.get(func)
        if kind is None and func.namespace == "_c10d_functional":
            # wait_tensor and the autograd wrapper of a collective's
            # result: on a device the output is the input or a wrapper
            # holding it; their meta kernels make an empty copy instead
            self._alias(out, args[0])
            return out
        if kind is not None:
            note(kind, sum(_nbytes(t) for t in _tensors(out)), _link(args))
        elif not func.is_view and func not in _ALLOCS \
                and func is not _aten._unsafe_view.default \
                and func.namespace != "_c10d_functional":
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs, out)))
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out)
        for t in _tensors(out):
            self._track(t)
        return out


def trace_step(bundle) -> dict:
    """Run ``bundle.fn(*bundle.args)`` once under the three counters;
    returns the step's counts (see the module docstring) and its
    outputs under ``"out"``."""
    args = bundle.args
    arg_ts = _tensors(args)
    arg_storages = {id(t.untyped_storage()) for t in arg_ts}
    arg_bytes = sum(_nbytes(t) for t in {id(t): t for t in arg_ts}.values())
    with record_collectives() as coll, kernel_cost.counting() as kc, \
            StepTracer(args) as tr:
        out = bundle.fn(*args)
    outs = list({id(t): t for t in _tensors(out)}.values())
    out_bytes = sum(_nbytes(t) for t in outs)
    alias = sum(_nbytes(t) for t in outs
                if id(t.untyped_storage()) in arg_storages)
    aten_flops = tr.flops
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": tr.peak - arg_bytes, "alias_bytes": alias,
                   "peak_bytes": tr.peak},
        "cost": {"flops": aten_flops + kc.flops,
                 "bytes_accessed": tr.bytes + kc.bytes},
        "aten_flops": aten_flops,
        "kernels": kc.by_kernel,
        "collectives": coll.as_dict(),
        "out": out,
    }


def _shape(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


@contextlib.contextmanager
def mesh_for(mesh_kind: str, device_type: str = "cpu"):
    """The mesh of ``mesh_kind`` (:data:`MESHES`): None for ``"card"``,
    else JAX's production mesh over a fake group of its size, this
    process rank 0 (the group is torn down on exit)."""
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r} (choose from "
                         f"{', '.join(MESHES)})")
    if mesh_kind == "card":
        yield None
        return
    with fake_group(MESHES[mesh_kind]):
        yield make_production_mesh(multi_pod=mesh_kind == "multipod",
                                   device_type=device_type)


def run_cell(arch: str, shape_name, mesh_kind: str = "card",
             overrides: dict | None = None) -> dict:
    """The dry run of one cell on ``meta``. ``shape_name`` is a key of
    :data:`SHAPES` or a :class:`ShapeSpec` (a reduced batch);
    ``mesh_kind``: ``"card"`` (the whole step on one card), ``"single"``
    or ``"multipod"`` (rank 0's step on JAX's 256- or 512-device mesh:
    every count is that device's); ``overrides`` replace config fields
    (``{"remat": "none"}``: the step keeping every activation)."""
    from .roofline import HBM_BYTES
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = _shape(shape_name)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    t0 = time.perf_counter()
    with mesh_for(mesh_kind) as mesh:
        bundle = build_step(cfg, shape, device="meta", mesh=mesh)
        res = trace_step(bundle)
        devices = 1 if mesh is None else mesh_devices(mesh)
        del bundle, res["out"]
    mem = res["memory"]
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "status": "ok", "devices": devices,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind, "remat": cfg.remat,
        "lower_s": round(time.perf_counter() - t0, 1), "compile_s": 0.0,
        "memory": mem,
        "fits": mem["peak_bytes"] <= HBM_BYTES,
        "cost": res["cost"],
        "aten_flops": res["aten_flops"],
        "kernels": res["kernels"],
        "collectives": res["collectives"],
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }


def _counts(cfg, shape, mesh_kind) -> dict:
    with mesh_for(mesh_kind) as mesh:
        res = trace_step(build_step(cfg, shape, device="meta", mesh=mesh))
    coll = res["collectives"]
    return {"flops": res["cost"]["flops"],
            "bytes": res["cost"]["bytes_accessed"],
            "wire": coll["wire_bytes"], "coll": coll["total_bytes"],
            "by_kind": coll["bytes_by_kind"]}


def cost_pass(arch: str, shape_name, mesh_kind: str = "card",
              overrides: dict | None = None) -> dict:
    """The cost numbers of the eager trace, which counts every layer as
    it runs: no extrapolation is needed. Beside them the ``points`` JAX's
    cost pass extrapolates from (the step at one and at two repeats of
    the layer pattern, traced the same way), so that the affine identity
    ``f(R) = f(1) + (R - 1) (f(2) - f(1))`` that JAX's method assumes can
    be checked. ``mesh_kind`` as in :func:`run_cell` (JAX's cost pass
    runs on ``"single"``)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = _shape(shape_name)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    unit = len(cfg.pattern)
    t0 = time.perf_counter()
    full = _counts(cfg, shape, mesh_kind)
    pts = {r: _counts(cfg.replace(n_layers=unit * r), shape, mesh_kind)
           for r in (1, 2)}
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "status": "ok", "repeats": cfg.repeats,
        "seconds": round(time.perf_counter() - t0, 1),
        "cost": {"flops": full["flops"], "bytes_accessed": full["bytes"]},
        "collectives": {"wire_bytes": full["wire"],
                        "total_bytes": full["coll"],
                        "bytes_by_kind": full["by_kind"]},
        "points": pts,
    }


def save(result: dict, suffix: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    fn = os.path.join(
        RESULTS_DIR,
        f"{result['arch']}_{result['shape']}_{result['mesh']}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1)
    return fn


def _host_read(exc: BaseException) -> str:
    """The op of the step that raised, from the innermost frame of the
    port (the meta device refuses a read to the host)."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename]
    if not frames:
        return ""
    f = frames[-1]
    return f" at {os.path.basename(f.filename)}:{f.lineno} ({f.line})"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="card",
                    help="card (default): the whole step on one card; "
                         "single / multipod: rank 0's step on JAX's "
                         "(16, 16) / (2, 16, 16) mesh, traced over a fake "
                         "group (per-device counts)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cost", action="store_true",
                    help="run the cost pass (the trace and its R=1/R=2 "
                         "points) instead of the dry run")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, args.mesh) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape, args.mesh)]

    suffix = "_cost" if args.cost else ""
    failures = 0
    for a, s, m in cells:
        fn = os.path.join(RESULTS_DIR, f"{a}_{s}_{m}{suffix}.json")
        if args.skip_existing and os.path.exists(fn):
            with open(fn) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped"):
                print(f"[dryrun] {a} {s} {m}{suffix}: cached "
                      f"{prev['status']}", flush=True)
                continue
        try:
            res = cost_pass(a, s, m) if args.cost else run_cell(a, s, m)
        except Exception as e:  # noqa: BLE001 — record and continue
            res = {"arch": a, "shape": s, "mesh": m, "status": "error",
                   "error": f"{type(e).__name__}: {e}{_host_read(e)}",
                   "trace": traceback.format_exc()[-2000:]}
            failures += 1
        save(res, suffix)
        msg = res["status"]
        if res["status"] == "ok" and not args.cost:
            mem = res["memory"]
            msg += (f" peak {mem['peak_bytes'] / 1e9:.1f} GB (args "
                    f"{mem['argument_bytes'] / 1e9:.1f}) "
                    f"{'fits' if res['fits'] else 'does not fit'}; "
                    f"flops={res['cost']['flops']:.4g} "
                    f"bytes={res['cost']['bytes_accessed']:.4g} "
                    f"trace={res['lower_s']}s")
        elif res["status"] == "ok":
            msg += (f" flops={res['cost']['flops']:.4g} "
                    f"bytes={res['cost']['bytes_accessed']:.4g} "
                    f"({res['seconds']}s)")
        elif res["status"] == "error":
            msg += f" {res['error']}"
        print(f"[dryrun] {a} {s} {m}{suffix}: {msg}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
