"""Quickstart on the PyTorch port: the paper's Example 1, end to end.

J=4 word-count jobs (books) on K=6 simulated servers (q=2, k=3), N=6
chapters each. Runs Map -> aggregate -> 3-stage coded Shuffle -> Reduce,
verifies every server's counts against the ground truth, and prints the
measured communication load per stage (paper: 1/4 + 1/4 + 1/2 = 1).
The engine is the port's numpy copy, so the run is the same on every
device; ``--device`` only checks that the device is there.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import loads
from repro_torch.core.engine import CAMRConfig, CAMREngine
from repro_torch.data.pipeline import wordcount_corpus
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    resolve_device(args.device)

    q, k, gamma = 2, 3, 2
    cfg = CAMRConfig(q=q, k=k, gamma=gamma)
    Q = cfg.num_functions()
    print(f"cluster: K={cfg.K} servers (q={q}, k={k}) | J={cfg.J} jobs | "
          f"N={cfg.N} subfiles/job | storage fraction mu="
          f"{(k - 1) / cfg.K:.3f}")

    books = wordcount_corpus(cfg.J, cfg.N, Q, chapter_len=200, seed=7)

    def count_words(job, chapter):
        # function f counts word f in the chapter -> (Q, 1) values
        return np.bincount(chapter, minlength=Q)[:, None].astype(np.int64)

    eng = CAMREngine(cfg, count_words)
    results = eng.run(books)
    eng.verify(books, results)
    print("\nreduce results (server -> word counts per job):")
    for s in (0, 3):
        for (j, f), v in sorted(results[s].items())[:2]:
            print(f"  server U{s + 1} reduced phi_{f + 1}(book {j + 1}) "
                  f"= {int(v[0])}")

    L = eng.measured_loads()
    print("\nmeasured communication load (shared-bus model, Def. 3):")
    for st in (1, 2, 3):
        print(f"  stage {st}: {L[f'L_stage{st}_bus']:.4f}")
    print(f"  total  : {L['L_total_bus']:.4f} "
          f"(paper closed form: {loads.camr_load(q, k):.4f})")
    print(f"\nCCDC at the same mu would need J = "
          f"{loads.ccdc_min_jobs(1 / 3, 6)} jobs; CAMR used {cfg.J}.")
    print("OK")


if __name__ == "__main__":
    main()
