"""Training launcher of the port: the paper's multi-model setting.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --multi-model --grad-sync camr_spmd --q 2 --k 3 --steps 2 \\
        --n-layers 2 --seq-len 512 --batch 1 [--grad-sync-dtype bfloat16] \\
        [--codec multipass]

runs ``MultiModelCAMRTrainer.train_steps(mode="camr_spmd")`` on the
current CUDA device (``--device cpu`` runs the plain versions on the
CPU, best with ``--reduced``); ``--arch`` takes any ported config: the
dense ones, ``mamba2_1p3b`` (SSM) and ``zamba2_2p7b`` (hybrid), e.g.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_2p7b \\
        --reduced --multi-model --grad-sync camr_spmd --steps 2 \\
        --seq-len 8 --batch 2 --device cpu

(training takes the plain differentiable SSD scan; no kernel has a
backward); ``--grad-sync-dtype bfloat16`` syncs the
gradients on the packed 16-bit wire lane, ``--codec multipass`` through
the multipass XOR codec (the fused codec's oracle). Only ``--multi-model
--grad-sync camr_spmd`` is ported; the single-model trainer and the
camr/uncoded modes exit with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.runtime import MultiModelCAMRTrainer

_LATER = "is not ported yet (ROADMAP.md, Queue 1 item 4)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (width stays)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-sync",
                    choices=["allreduce", "camr", "camr_spmd", "uncoded"],
                    default="allreduce")
    ap.add_argument("--multi-model", action="store_true")
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--router", choices=["all_to_all", "ppermute"],
                    default="all_to_all")
    ap.add_argument("--grad-sync-dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="shuffle payload dtype (default: the config's); "
                         "bfloat16 = mixed-precision grad sync at half "
                         "the wire bytes")
    ap.add_argument("--codec", choices=["fused", "multipass"],
                    default="fused",
                    help="the shuffle's XOR codec (multipass = the fused "
                         "codec's oracle)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    if not args.multi_model:
        raise SystemExit(f"the single-model Trainer {_LATER}; pass "
                         "--multi-model --grad-sync camr_spmd")
    if args.grad_sync != "camr_spmd":
        raise SystemExit(f"--grad-sync {args.grad_sync} {_LATER}; the "
                         "ported wire is camr_spmd")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=args.seq_len,
                                global_batch=args.batch)
    tr = MultiModelCAMRTrainer(cfg, q=args.q, k=args.k, lr=args.lr,
                               seed=args.seed, router=args.router,
                               device=args.device,
                               grad_sync_dtype=args.grad_sync_dtype,
                               codec=args.codec)
    t0 = time.time()
    rep = tr.train_steps(pipe, args.steps, mode="camr_spmd")
    dt = time.time() - t0
    for step, (losses, ms) in enumerate(zip(rep.losses, rep.phase_ms)):
        print(json.dumps({"step": step + 1, "losses": losses,
                          "phase_ms": ms}))
    print(json.dumps({"mode": rep.mode, "bytes_total": rep.bytes_total,
                      "grad_sync_dtype": rep.grad_sync_dtype,
                      "loads": rep.loads, "sync": rep.sync,
                      "device": str(tr.device)}))
    print(f"# {args.steps} steps x {tr.J} models in {dt:.1f}s")


if __name__ == "__main__":
    main()
