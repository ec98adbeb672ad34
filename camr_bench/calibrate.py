"""The readings that the check's limits are set from, at a cell's own size.

    python3 camr_bench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control 3] [--faults 3] [--out <file.jsonl>]

For each seed: the program's first ``check.STEPS`` steps (as a run's
set-up makes them), the plain reference's, and the three numbers of
:mod:`camr_bench.check` between them (the lower readings). On the first
``--control`` seeds also the control, the reference computed with its
products in float8 (the upper reading), and on the first ``--faults``
seeds each fault of :mod:`camr_bench.faults` planted in the program
(but ``state_unchanged``, which reads 1 by construction). The control's
seeds also read the twin, the reference computed in float64 inside each
op with the same roundings (how far two sound computations lie apart),
and, where the configuration syncs its gradients in float32, the
program on its own bfloat16 lane (the control of that precision). One
JSON line per reading on standard output (and in ``--out``). The
benchmark's own runs never run this.
"""

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    from camr_bench import bench, check
    from camr_bench.faults import FAULTS

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    names = ["/".join(leaf.path) for leaf in cell.leaves]

    def emit(seed, kind, rec, ref, t0):
        line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                           **check.gaps(rec, ref),
                           "seconds": time.perf_counter() - t0,
                           "where": check.worst(rec, ref, names)})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    def program(seed, plant=None, on=cell):
        tr, _, rec, _ = bench.start_program(on, seed, "cuda", plant)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        prog = program(seed)
        t1 = time.perf_counter()
        ref = bench.reference_record(cell, seed, "cuda")
        print(f"seed {seed}: program {t1 - t0:.1f} s, reference "
              f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)
        emit(seed, "program", prog, ref, t0)
        if i < args.control:
            t0 = time.perf_counter()
            emit(seed, "control", bench.reference_record(
                cell, seed, "cuda", fp8=True), ref, t0)
            t0 = time.perf_counter()
            emit(seed, "twin", bench.reference_record(
                cell, seed, "cuda", twin=True), ref, t0)
            if cell.config["grad_sync_dtype"] == "float32":
                t0 = time.perf_counter()
                lane = dataclasses.replace(cell, config={
                    **cell.config, "grad_sync_dtype": "bfloat16"})
                emit(seed, "sync_bfloat16", program(seed, on=lane), ref, t0)
        if i < args.faults:
            for name, plant in FAULTS.items():
                if name == "state_unchanged":
                    continue
                t0 = time.perf_counter()
                emit(seed, name, program(seed, plant), ref, t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
