"""Fault tolerance demo on the PyTorch port: a worker dies after Map;
the shuffle recovers from the placement redundancy (no recomputation),
functions migrate, and the job still reduces correctly. Also shows
elastic re-planning. The engines are the port's numpy copies;
``--device`` only checks that the device is there.

    PYTHONPATH=src python examples/torch/fault_tolerance.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.device import resolve_device
from repro_torch.runtime.fault import DegradedCAMREngine, elastic_replan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    resolve_device(args.device)

    cfg = CAMRConfig(q=3, k=3, gamma=1)
    Q = cfg.num_functions()
    rng = np.random.default_rng(0)
    ds = [[rng.standard_normal(8) for _ in range(cfg.N)]
          for _ in range(cfg.J)]

    def map_fn(job, sf):
        return np.outer(np.arange(1, Q + 1), sf)

    healthy = CAMREngine(cfg, map_fn)
    healthy.verify(ds, healthy.run(ds))
    lh = healthy.measured_loads()["L_total_bus"]
    print(f"healthy run: load {lh:.4f}")

    failed = {4}
    deg = DegradedCAMREngine(cfg, map_fn, failed=failed)
    results = deg.run(ds)
    oracle = deg.oracle(ds)
    checked = 0
    for s_orig in range(cfg.K):
        s = deg.migrate_target(s_orig)
        for qf in deg.functions_of(s_orig):
            for j in range(cfg.J):
                np.testing.assert_allclose(results[s][(j, qf)],
                                           oracle[(j, qf)], rtol=1e-9)
                checked += 1
    ld = deg.trace.total_bytes() / (cfg.J * Q * deg.value_bytes)
    print(f"worker U5 failed after Map: functions migrated to "
          f"U{deg.migrate_target(4) + 1}, all {checked} (job, fn) results"
          f" still exact; degraded load {ld:.4f} ({ld / lh:.2f}x)")

    rep = elastic_replan(3, 3, 12)
    print(f"elastic scale 9 -> 12 workers: new (q, k)={rep.new_qk}, "
          f"moved {rep.moved_fraction:.1%} of stored subfiles, "
          f"mu={rep.new_storage_fraction:.3f}")
    print("OK")


if __name__ == "__main__":
    main()
