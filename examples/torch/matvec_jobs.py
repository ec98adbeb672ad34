"""The paper's neural-network use case (§I) on the PyTorch port:
distributed matrix-vector products as CAMR jobs.

Each job j is y_j = W_j x_j (a forward-prop layer for model j); subfiles
are row-blocks of W_j. Map computes partial products, aggregation is the
(associative+commutative) elementwise sum of per-function row-slices,
and the coded shuffle delivers each server the slice of y_j it owns.
The engine is the port's numpy copy; ``--device`` only checks that the
device is there.

    PYTHONPATH=src python examples/torch/matvec_jobs.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import loads
from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    resolve_device(args.device)

    q, k, gamma = 3, 3, 1
    cfg = CAMRConfig(q=q, k=k, gamma=gamma)
    Q = cfg.num_functions()          # K output slices per job
    DIM = Q * 8                      # y dimension (8 rows per function)
    rng = np.random.default_rng(0)

    # job j: W_j [DIM, DIM], x_j [DIM]; subfile n = column block n of W_j
    Ws = [rng.standard_normal((DIM, DIM)) for _ in range(cfg.J)]
    xs = [rng.standard_normal(DIM) for _ in range(cfg.J)]
    blk = DIM // cfg.N
    datasets = [
        [(Ws[j][:, n * blk:(n + 1) * blk], xs[j][n * blk:(n + 1) * blk])
         for n in range(cfg.N)]
        for j in range(cfg.J)
    ]

    def map_fn(job, subfile):
        Wblk, xblk = subfile
        y_part = Wblk @ xblk                       # [DIM]
        return y_part.reshape(Q, DIM // Q)         # one slice per function

    eng = CAMREngine(cfg, map_fn)
    results = eng.run(datasets)
    eng.verify(datasets, results)

    # server s holds slice s of every y_j — reassemble and check
    for j in range(cfg.J):
        y = np.concatenate([results[s][(j, s)] for s in range(cfg.K)])
        np.testing.assert_allclose(y, Ws[j] @ xs[j], rtol=1e-9)
    L = eng.measured_loads()
    print(f"J={cfg.J} matvec jobs on K={cfg.K} servers: all products "
          f"correct; shuffle load {L['L_total_bus']:.4f} "
          f"(closed form {loads.camr_load(q, k):.4f})")
    print("OK")


if __name__ == "__main__":
    main()
