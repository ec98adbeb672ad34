"""Training launcher of the port.

The paper's multi-model setting (``--multi-model``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --multi-model --grad-sync camr_spmd --q 2 --k 3 --steps 2 \\
        --n-layers 2 --seq-len 512 --batch 1 [--grad-sync-dtype bfloat16] \\
        [--codec multipass]

runs ``MultiModelCAMRTrainer.train_steps(mode=...)`` on the current CUDA
device (``--device cpu`` runs the plain versions on the CPU, best with
``--reduced``). ``--grad-sync camr_spmd`` is the stacked coded shuffle
on the device, ``camr`` the numpy engine interpreter and ``uncoded`` the
paper's unicast baseline (both on the host, fed from the device's map):
all three give bitwise the same parameters. ``--arch`` takes the
dense configs, ``mixtral_8x7b`` and ``moonshot_v1_16b_a3b`` (MoE: the
loss holds the load-balancing term), ``mamba2_1p3b`` (SSM) and
``zamba2_2p7b`` (hybrid); ``seamless_m4t_large_v2`` and
``internvl2_26b`` are refused (the token pipeline carries no frames or
patches), e.g.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_2p7b \\
        --reduced --multi-model --grad-sync camr --steps 2 \\
        --seq-len 8 --batch 2 --device cpu

(training takes the plain differentiable SSD scan, and past ``seq_len``
1448 the chunked attention lane; no kernel has a backward);
``--grad-sync-dtype bfloat16`` syncs the gradients on the packed 16-bit
wire lane, ``--codec multipass`` through the multipass XOR codec (the
fused codec's oracle). Without ``--multi-model`` the single-model
``Trainer`` runs (``--microbatches`` for gradient accumulation):

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --reduced --steps 4 --seq-len 64 --batch 4 --microbatches 2 \\
        --device cpu

``--failed 2`` (comma-separated worker ids) trains the multi-model
setting with those workers silent in the shuffle: the degraded
survivor-set executor on ``camr_spmd``, the ``DegradedCAMREngine`` on
``camr`` (``uncoded`` has no degraded mode).

The single-model loop checkpoints and resumes as JAX's does:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --reduced --steps 4 --seq-len 16 --batch 4 --device cpu \\
        --ckpt-dir /tmp/ckpt --ckpt-every 2 --resume

saves every ``--ckpt-every`` steps into ``--ckpt-dir`` (the JAX package's
format: either package's ``Trainer`` resumes the other's) and, with
``--resume``, first restores the newest intact step. With
``--multi-model`` these options exit with a message (the JAX launcher
ignores them there). With ``WORLD_SIZE`` > 1 in the environment the
launcher first joins the ``torch.distributed`` group
(:func:`repro_torch.launch.mesh.init_distributed`, from ``MASTER_ADDR``,
``MASTER_PORT`` and ``RANK``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.launch.mesh import init_distributed
from repro_torch.runtime import MultiModelCAMRTrainer, Trainer


def _run_single_model(cfg, pipe, args) -> None:
    """The single-model loop: one model, one device (``--grad-sync``
    allreduce or camr names the data-parallel wire of a multi-device
    run; on one device there is none)."""
    tr = Trainer(cfg, lr=args.lr, total_steps=args.steps, seed=args.seed,
                 microbatches=args.microbatches, device=args.device,
                 ckpt_dir=args.ckpt_dir)
    if args.resume and tr.resume():
        print(f"resumed from step {tr.step}")
    t0 = time.time()
    metrics = tr.run(pipe, steps=args.steps, log_every=1,
                     ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
    dt = time.time() - t0
    for m in metrics:
        print(json.dumps(m))
    print(f"# {args.steps} steps in {dt:.1f}s on {tr.device}")


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
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation groups (single-model)")
    ap.add_argument("--failed", default=None,
                    help="comma-separated failed worker ids "
                         "(--multi-model)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (single-model)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest intact checkpoint first")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not init_distributed():
        raise SystemExit("WORLD_SIZE > 1 but the torch.distributed group "
                         "did not start (gloo, env://)")
    if args.multi_model and (args.ckpt_dir or args.resume):
        raise SystemExit("--ckpt-dir/--resume belong to the single-model "
                         "loop; the multi-model trainer does not "
                         "checkpoint")
    if args.multi_model and args.grad_sync == "allreduce":
        raise SystemExit("--multi-model needs --grad-sync "
                         "camr|camr_spmd|uncoded (allreduce is the "
                         "single-model data-parallel wire)")
    if not args.multi_model and args.grad_sync in ("camr_spmd", "uncoded"):
        raise SystemExit(f"--grad-sync {args.grad_sync} is a --multi-model "
                         "wire; the single-model loop takes allreduce|camr")
    if not args.multi_model and (args.grad_sync_dtype or args.failed or
                                 args.codec != "fused"):
        raise SystemExit("--grad-sync-dtype, --codec and --failed are "
                         "--multi-model options (the CAMR gradient "
                         "shuffle)")
    cfg = get_config(args.arch)
    if cfg.family == "encdec" or cfg.frontend:
        raise SystemExit(f"{args.arch}: the token pipeline carries no "
                         "frames or patches, so this model is served only "
                         "(the JAX trainers cannot train it either)")
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=args.seq_len,
                                global_batch=args.batch)
    if not args.multi_model:
        _run_single_model(cfg, pipe, args)
        return
    failed = ({int(s) for s in args.failed.split(",")}
              if args.failed else None)
    tr = MultiModelCAMRTrainer(cfg, q=args.q, k=args.k, lr=args.lr,
                               seed=args.seed, router=args.router,
                               device=args.device,
                               grad_sync_dtype=args.grad_sync_dtype,
                               codec=args.codec, failed=failed)
    t0 = time.time()
    rep = tr.train_steps(pipe, args.steps, mode=args.grad_sync)
    dt = time.time() - t0
    for step, (losses, ms) in enumerate(zip(rep.losses, rep.phase_ms)):
        print(json.dumps({"step": step + 1, "losses": losses,
                          "phase_ms": ms}))
    peak = (torch.cuda.max_memory_allocated(tr.device)
            if tr.device.type == "cuda" else None)
    print(json.dumps({"mode": rep.mode, "bytes_total": rep.bytes_total,
                      "grad_sync_dtype": rep.grad_sync_dtype,
                      "loads": rep.loads, "sync": rep.sync,
                      "device": str(tr.device),
                      "peak_memory_bytes": peak}))
    print(f"# {args.steps} steps x {tr.J} models in {dt:.1f}s")


if __name__ == "__main__":
    main()
