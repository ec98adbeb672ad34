"""Where rank 0's measured peak parts from its trace on the production
mesh: the step of each cell given traced three ways, and the storages
alive at each one's peak set side by side.

1. ``meta``: the dry run's tracer (``dryrun.StepTracer``) over the step
   built on ``meta`` (what ``dryrun --mesh single`` records);
2. ``card-tracer``: the same tracer over the step built on the card
   (its first run; the allocator's peak of that run beside it);
3. ``card-allocator``: the caching allocator's history
   (``torch.cuda.memory._record_memory_history``) over a second run on
   the card, replayed to its peak, and what the process still holds
   after the first run beside the step's arguments
   (``left_by_the_first_run``: cuBLAS's workspace of each thread that
   ran a product).

Each is rank 0 of the 256-device ``single`` mesh over a fake group, as
``chip_smoke.phase_mesh`` runs it. At each peak the live storages are
grouped by the line of ``src/repro_torch`` that made them; the groups
whose bytes differ between the three are printed, largest first, and
all of it goes to ``chiprun_out/mesh_peak.json``.

Run from the root of a checkout, on a machine with a card::

    python3 scripts/mesh_peak.py granite_3_2b:prefill_32k:4 \\
        granite_3_2b:train_4k:4

Each cell is ``arch:shape:layers`` (the depth cut to ``layers``). Prints
the card's name and power limit last.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import subprocess
import sys
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
SRC = os.path.join("src", "repro_torch")
MESH_DEVICES = 256


def _site(frames) -> str:
    """The two innermost frames in the port's package, as ``file:line``
    each, the inner first."""
    out = [f"{f[0].split(SRC)[-1].lstrip('/')}:{f[1]}" for f in frames
           if SRC in f[0]][:2]
    return " < ".join(out) or "other"


def _recording_tracer():
    import torch
    from repro_torch.launch import dryrun

    class Recording(dryrun.StepTracer):
        """The dry run's tracer, keeping each storage's size and the line
        that made it, and its allocations and frees in order."""

        def __init__(self, args=()):
            self.events, self._site, self._mine = [], None, {}
            super().__init__(args)

        def _track(self, t):
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs:
                return
            super()._track(t)
            self.events.append(("a", key, st.nbytes(),
                                self._site or "argument", t.device.type))

            def freed(_, key=key):
                self._mine.pop(key, None)
                self.events.append(("f", key))

            self._mine[key] = weakref.ref(st, freed)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f, frames = sys._getframe(1), []
            while f is not None and len(frames) < 40:
                frames.append((f.f_code.co_filename, f.f_lineno))
                f = f.f_back
            self._site = _site(frames)
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Recording


def _replay(events):
    """(peak bytes, {site: bytes} alive at the peak) of alloc / free
    events."""
    live, sizes, peak, at = 0, {}, -1, {}
    for e in events:
        if e[0] == "a":
            sizes[e[1]] = (e[2], e[3])
            live += e[2]
            if live > peak:
                peak = live
                at = dict(sizes)
        elif e[1] in sizes:
            live -= sizes.pop(e[1])[0]
    by = collections.Counter()
    for n, site in at.values():
        by[site] += n
    return peak, dict(by)


def _allocator_replay(snap, base_blocks):
    """The allocator history's peak over its base and the sites alive
    there (``free_completed`` ends a block)."""
    events = []
    for e in snap["device_traces"][0]:
        if e["action"] == "alloc":
            fr = [(f["filename"], f["line"]) for f in e.get("frames", [])]
            site = _site(fr)
            events.append(("a", e["addr"], e["size"], site, "cuda"))
        elif e["action"] == "free_completed":
            events.append(("f", e["addr"]))
    peak, by = _replay(events)
    by["argument"] = base_blocks
    return peak + base_blocks, by


def cell(arch, shape_name, layers) -> dict:
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import cost
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.launch.steps import build_step
    Recording = _recording_tracer()
    cfg = get_config(arch).replace(n_layers=layers)
    shape = SHAPES[shape_name]
    out = {"cell": f"{arch} {shape_name} {layers} layers"}
    with fake_group(MESH_DEVICES):
        mesh = make_production_mesh(device_type="cpu")
        bundle = build_step(cfg, shape, device="meta", mesh=mesh)
        with cost.counting(), Recording(bundle.args) as tr:
            res = bundle.fn(*bundle.args)
        del res, bundle
        out["meta"] = {"tracer_peak": tr.peak,
                       "replay": _replay(tr.events)}
    gc.collect()
    torch.cuda.empty_cache()
    with fake_group(MESH_DEVICES):
        mesh = make_production_mesh(device_type="cuda")
        base = torch.cuda.memory_allocated()
        bundle = build_step(cfg, shape, device="cuda", seed=0, mesh=mesh)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with cost.counting(), Recording(bundle.args) as tr:
            res = bundle.fn(*bundle.args)
        torch.cuda.synchronize()
        del res
        cpu = sum(e[2] for e in tr.events if e[0] == "a" and e[4] != "cuda")
        out["card-tracer"] = {
            "tracer_peak": tr.peak, "replay": _replay(tr.events),
            "allocator_peak": torch.cuda.max_memory_allocated() - base,
            "bytes_made_off_the_card": cpu}
        del tr
        gc.collect()
        torch.cuda.synchronize()
        args_now = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                                 stacks="python")
        try:
            res = bundle.fn(*bundle.args)
            torch.cuda.synchronize()
            replay = _allocator_replay(torch.cuda.memory._snapshot(),
                                       args_now)
        except SystemError as e:        # the history's stack capture
            print(f"  allocator history failed: {e!r}; the run again "
                  "without it", flush=True)
            torch.cuda.memory._record_memory_history(enabled=None)
            torch.cuda.reset_peak_memory_stats()
            res = bundle.fn(*bundle.args)
            torch.cuda.synchronize()
            replay = (0, {})
        torch.cuda.memory._record_memory_history(enabled=None)
        arg_bytes = sum(t.untyped_storage().nbytes() for t in {
            id(t): t for t in dryrun._tensors(bundle.args)}.values())
        del res, bundle
        out["card-allocator"] = {
            "allocator_peak": torch.cuda.max_memory_allocated() - base,
            "left_by_the_first_run": args_now - arg_bytes,
            "replay": replay}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _report(rec) -> None:
    print(f"== {rec['cell']}", flush=True)
    for k in ("meta", "card-tracer", "card-allocator"):
        v = rec[k]
        print(f"  {k}: " + ", ".join(
            f"{n} {v[n]}" for n in v if n != "replay")
            + f", replayed peak {v['replay'][0]}")
    sites = [rec[k]["replay"][1] for k in ("meta", "card-tracer",
                                            "card-allocator")]
    keys = set().union(*sites)
    rows = sorted(keys, key=lambda s: -max(abs(sites[0].get(s, 0) - x.get(
        s, 0)) for x in sites[1:]))
    print("  live at each peak by site (meta / card tracer / allocator), "
          "the sites that differ:")
    for s in rows[:25]:
        vals = [x.get(s, 0) for x in sites]
        if max(vals) - min(vals) > 0:
            print(f"    {s}: " + " / ".join(str(v) for v in vals))


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("mesh_peak: no CUDA device", file=sys.stderr)
        return 2
    recs = []
    for spec in argv:
        arch, shape_name, layers = spec.split(":")
        rec = cell(arch, shape_name, int(layers))
        _report(rec)
        recs.append(rec)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mesh_peak.json"), "w") as f:
        json.dump(recs, f, indent=1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
