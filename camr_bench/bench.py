"""The benchmark's run of one cell: set-up, the measured window, the
traced sub-window, the correctness check and the result's line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``configs/<config>.json``), a traffic file
(``traffic/<traffic>.json``) and has a file of its own
(``workloads/<name>.json``: the check's limits and the traced steps).
What the program gets from here is the system under test and its
inputs: the J models' weights (:mod:`.params`) and the token feed
(:mod:`.feed`), both made from the seed. What comes back is read from
the trainer's report (``phase_ms``, ``losses``) and its state (the
first moment after the first step, the parameters after the recorded
steps), and the card's own clocks, allocator and profiler.

Set-up runs the window's own call for ``check.STEPS`` steps: they warm
every shape and kernel the window uses, and the reference follows them
once the window has closed and the trainer is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import check
from .devtrace import Trace, trace_steps
from .feed import TokenFeed
from .params import as_tree, make_weights, offsets
from .peaks import peaks_of
from .reference import family
from .reference.common import (TrainRecord, flat_leaves, full_f32,
                               train_steps)

__all__ = ["Cell", "Context", "load_benchmark", "load_cell", "start_program",
           "reference_record", "run_cell", "forbidden_modules",
           "program_source"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that may not be loaded in a run: JAX, and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list

    @property
    def J(self) -> int:
        c = self.config["camr"]
        return c["q"] ** (c["k"] - 1)

    @property
    def N(self) -> int:
        return self.config["camr"]["k"]

    @property
    def family(self):
        return family(self.config["family"])

    @property
    def leaves(self) -> list:
        return flat_leaves(self.family.layout(self.config))

    @property
    def tokens_per_step(self) -> int:
        t = self.traffic
        return self.J * self.N * t["seqs_per_subfile"] * t["seq_len"]

    @property
    def step_flops(self) -> float:
        """Model FLOPs of a step: 6 x the parameters that enter a product
        x the tokens, plus causal attention's."""
        fam, T = self.family, self.traffic["seq_len"]
        per_token = (6 * fam.matmul_params(self.config)
                     + fam.attention_flops_per_token(self.config, T))
        return float(per_token * self.tokens_per_step)

    @property
    def sync_least_bytes(self) -> float:
        """The gradient sync's least bytes: J x N per-subfile gradient rows
        read once in the sync dtype, and the f32 master and both moments
        read and written once (6 x 4 bytes a parameter a job)."""
        D = sum(leaf.size for leaf in self.leaves)
        row = torch.tensor([], dtype=getattr(
            torch, self.config["grad_sync_dtype"])).element_size()
        return float(self.J * self.N * D * row + 24 * self.J * D)


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, benchmark: dict | None = None,
              bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``benchmark`` (``BENCHMARK.json`` by default)
    with its configuration, traffic and workload files."""
    bm = load_benchmark() if benchmark is None else benchmark
    entry = next((w for w in bm["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bm['workloads']]}")
    conf = next(c for c in bm["configs"] if c["name"] == entry["config"])
    return Cell(name=name, chips=entry["chips"],
                config=_json(ROOT / conf["file"]),
                traffic=_json(bench_dir / "traffic"
                              / f"{entry['traffic']}.json"),
                workload=_json(bench_dir / "workloads" / f"{name}.json"),
                end_to_end=_for_cell(bm["end_to_end"], name),
                per_layer=_for_cell(bm["per_layer"], name))


# ---------------------------------------------------------------- program
def program_source() -> Path:
    """The directory the port is imported from; it has to be this
    checkout's ``src``."""
    import repro_torch
    where = Path(repro_torch.__file__).resolve().parents[1]
    if where != ROOT / "src":
        raise SystemExit(f"repro_torch was imported from {where}, not from "
                         f"this checkout's src")
    return where


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: the arch's
    config with every field the file gives replaced by the file's
    value."""
    from repro_torch.configs import ModelConfig, get_config
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"name"}
    over = {key: tuple(val) if isinstance(val, list) else val
            for key, val in cfg.items() if key in fields}
    pc = get_config(cfg["arch"]).replace(**over)
    if pc.vocab_padded != cfg["vocab_rows"]:
        raise ValueError(f"{cfg['name']}: the port stores {pc.vocab_padded} "
                         f"vocabulary rows, the file {cfg['vocab_rows']}")
    return pc


class _Device:
    def __init__(self, device):
        self.dev = torch.device(device)
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def peak(self):
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else None

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def kind(self) -> str:
        return torch.cuda.get_device_name(self.dev) if self.cuda else "cpu"


def _program_norms(rows: torch.Tensor, cell: Cell, init=None) -> torch.Tensor:
    """Per job and leaf, the norm of ``rows[j]``'s segment of that leaf
    (less the initial leaf, when ``init`` is given): ``[J, L]`` float64
    on the host."""
    out = torch.empty((cell.J, len(cell.leaves)), dtype=torch.float64)
    for i, (leaf, off) in enumerate(zip(cell.leaves, offsets(cell.leaves))):
        seg = rows[:, off:off + leaf.size]
        if init is not None:
            seg = seg - torch.stack([init[j][i].reshape(-1)
                                     for j in range(cell.J)]).float()
        out[:, i] = torch.linalg.vector_norm(seg, dim=1).double().cpu()
    return out


def _stage(what: str, since: float) -> None:
    print(f"set-up: {what} {time.perf_counter() - since:.3f} s",
          file=sys.stderr)


def start_program(cell: Cell, seed: int, device, plant=None):
    """Build the trainer from the seed's weights and run its first
    ``check.STEPS`` steps through the window's own call. Returns
    ``(trainer, feed, record, check_s)``: the program's
    :class:`TrainRecord` of those steps and the seconds spent reading
    it. ``plant(trainer)`` breaks the trainer on purpose (calibration
    and tests only)."""
    from repro_torch.runtime import MultiModelCAMRTrainer
    cfg, leaves, J = cell.config, cell.leaves, cell.J
    t = time.perf_counter()
    pc = port_config(cfg)
    feed = TokenFeed(cell.traffic, cfg["vocab"], seed)
    weights = make_weights(leaves, J, seed, device)
    camr = cfg["camr"]
    tr = MultiModelCAMRTrainer(
        pc, q=camr["q"], k=camr["k"], lr=cfg["optimizer"]["lr"],
        params=[as_tree(leaves, w) for w in weights], codec=camr["codec"],
        router=camr["router"], device=device,
        grad_sync_dtype=pc.grad_sync_dtype)
    del weights
    _stage("weights and trainer", t)
    if tr.D != sum(leaf.size for leaf in leaves):
        raise ValueError(f"the trainer holds {tr.D} parameters a job, the "
                         f"layout {sum(leaf.size for leaf in leaves)}")
    if plant is not None:
        plant(tr)
    losses, check_s = [], 0.0
    grad_norms = None
    for s in range(check.STEPS):
        t = time.perf_counter()
        rep = tr.train_steps(feed, 1, mode=camr["mode"])
        _stage(f"step {s + 1}", t)
        losses.append(rep.losses[0])
        if grad_norms is None:
            t = time.perf_counter()
            grad_norms = _program_norms(tr.opt.mu, cell) / (
                1 - cfg["optimizer"]["b1"])
            check_s += time.perf_counter() - t
    t = time.perf_counter()
    init = make_weights(leaves, J, seed, device)
    delta_norms = _program_norms(tr.flat, cell, init)
    del init
    check_s += time.perf_counter() - t
    _stage(f"reading the state ({check_s:.3f} s in all)", t)
    return tr, feed, TrainRecord(losses, grad_norms, delta_norms), check_s


def reference_record(cell: Cell, seed: int, device,
                     fp8: bool = False, twin: bool = False) -> TrainRecord:
    """The plain reference's record of the first ``check.STEPS`` steps
    from the same seed (``fp8``: the control; ``twin``: float64 inside
    each op, see :func:`~.reference.common.train_steps`)."""
    full_f32()
    init = make_weights(cell.leaves, cell.J, seed, device)
    feed = TokenFeed(cell.traffic, cell.config["vocab"], seed)
    return train_steps(cell.family, cell.config, init, feed,
                       check.STEPS, fp8=fp8, twin=twin,
                       rows=cell.workload["reference_rows"])


# ----------------------------------------------------------------- metrics
@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    steps: int
    window_s: float
    tokens_per_step: int
    step_flops: float
    sync_least_bytes: float
    setup_s: float
    window_peak_bytes: int | None
    phase_ms: list
    trace: Trace | None
    peak_flops: float | None
    hbm_bytes_per_s: float | None

    def phase_mean(self, name: str) -> float:
        return statistics.fmean(p[name] for p in self.phase_ms)


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "camr_bench.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(specs: list, ctx: Context) -> dict:
    out = {}
    for m in specs:
        val = _reader(m["name"])(ctx)
        if val is not None:
            out[m["name"]] = {"value": float(val), "unit": m["unit"]}
    return out


# --------------------------------------------------------------------- run
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, plant=None) -> dict:
    """One run of ``cell``: the result's line as a dict (``checks``
    last). ``t_start`` is the process's start on ``time.perf_counter``'s
    clock."""
    dev = _Device(device)
    mode = cell.config["camr"]["mode"]
    tr, feed, prog, check_s = start_program(cell, seed, dev.dev, plant)

    def step():
        return tr.train_steps(feed, 1, mode=mode)

    dev.sync()
    setup_peak = dev.peak()
    dev.reset_peak()
    phases, ends = [], []
    t0 = time.perf_counter()
    while True:
        phases.extend(step().phase_ms)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    dev.sync()
    window_s = time.perf_counter() - t0
    steps = len(ends)
    step_ms = sorted(1e3 * (b - a) for a, b in zip([t0] + ends, ends))
    print(f"window: {steps} steps in {window_s:.3f} s; step ms min "
          f"{step_ms[0]:.1f} median {statistics.median(step_ms):.1f} max "
          f"{step_ms[-1]:.1f}", file=sys.stderr)
    window_peak = dev.peak()
    traced = (trace_steps(step, cell.workload["trace_steps"], dev.dev)
              if trace else None)
    memory_peak = (max(setup_peak, dev.peak()) if dev.cuda else None)
    kind = dev.kind()
    del tr, step
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference_record(cell, seed, dev.dev)
    print(f"reference: {time.perf_counter() - t:.3f} s", file=sys.stderr)
    correct, checks = check.judge(check.gaps(prog, ref),
                                  cell.workload["limits"])
    peaks = peaks_of(kind)
    ctx = Context(steps=steps, window_s=window_s,
                  tokens_per_step=cell.tokens_per_step,
                  step_flops=cell.step_flops,
                  sync_least_bytes=cell.sync_least_bytes,
                  setup_s=t0 - t_start - check_s,
                  window_peak_bytes=window_peak, phase_ms=phases,
                  trace=traced, peak_flops=peaks.get("bf16_flops"),
                  hbm_bytes_per_s=peaks.get("hbm_bytes_per_s"))
    result = {"correct": correct, "attempted": steps, "failed": 0,
              "metrics": read_metrics(cell.per_layer if trace
                                      else cell.end_to_end, ctx),
              "device": {"platform": "gpu" if dev.cuda else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": memory_peak}}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """Modules of :data:`FORBIDDEN` loaded in this process (top-level
    names compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
