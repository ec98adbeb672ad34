"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM,
with checkpoint/restart, using the production single-model Trainer.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200 \
        [--device cpu] [--ckpt-dir DIR]

(The multi-model CAMR-shuffled variant is
examples/torch/multimodel_camr.py; this driver exercises the
single-model production loop end to end. ``--ckpt-dir`` defaults to a
directory under the temporary directory, ``$TMPDIR``; a second run
resumes from it.)
"""

import argparse
import json
import os
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.runtime import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # ~100M-param member of the granite family (12L x 768 x 3072)
    cfg = get_config("granite_3_2b").replace(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=3072, vocab=8192, dtype="float32", loss_chunk=128,
        tie_embeddings=True)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=128,
                                global_batch=8, structure=0.9)
    tr = Trainer(cfg, lr=1e-3, warmup=20, total_steps=args.steps,
                 ckpt_dir=args.ckpt_dir, device=device)
    if tr.resume():
        print(f"resumed from step {tr.step}")
    t0 = time.time()
    metrics = tr.run(pipe, steps=args.steps, log_every=20, ckpt_every=100)
    dt = time.time() - t0
    for m in metrics:
        print(json.dumps({k: round(v, 4) for k, v in m.items()}))
    first, last = metrics[0]["loss"], metrics[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({args.steps / dt:.2f} steps/s)")
    assert last < first, "training must reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
