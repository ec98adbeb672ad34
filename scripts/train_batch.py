"""Granite's train step at 4,096 tokens and larger batches on the card:
``chip_smoke.dryrun_cell`` (the dry run's trace, then the same step on
the card at the config's ``remat``, its FLOPs and peak held to the
trace's) at each batch given.

Run from the root of a checkout, on a machine with a card::

    python3 scripts/train_batch.py --batch 16 32

A batch the card cannot hold prints the allocator's error and the script
goes on to the next. Prints the allocator's setting
(``PYTORCH_CUDA_ALLOC_CONF``) first and the card's name and power limit
last.
"""

from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    import torch
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_batch: no CUDA device", file=sys.stderr)
        return 2
    print(f"allocator: {os.environ.get('PYTORCH_CUDA_ALLOC_CONF', 'default')}",
          flush=True)
    for b in args.batch:
        try:
            chip_smoke.dryrun_cell("granite_3_2b",
                                   (f"train_4k_b{b}", 4096, b, "train"))
        except torch.OutOfMemoryError as e:
            print(f"granite_3_2b train_4k_b{b}: out of memory on the card: "
                  f"{str(e).splitlines()[0]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
