"""The paper's deep-learning use case (§I) on the PyTorch port: train J
models simultaneously with the CAMR-coded gradient shuffle — on the
stacked device collective, the numpy engine interpreter, and the
uncoded baseline.

J = q^{k-1} = 4 small LMs on K = 6 virtual workers. Each worker maps
the microbatches it stores (redundancy k-1 = 2), compresses per-batch
gradients with the α-combiner (the paper's aggregation step), and the
3-stage coded shuffle delivers every worker the summed shard it
reduces. All three wires produce BIT-identical parameters and losses
(asserted below — the engine is the bit-identity oracle of the device
path); the coded shuffle just ships fewer bytes, and ``camr_spmd`` runs
it on the device through the codec kernels, its executor reused across
steps.

    PYTHONPATH=src python examples/torch/multimodel_camr.py --steps 3
    PYTHONPATH=src python examples/torch/multimodel_camr.py --steps 3 \
        --modes camr,camr_spmd --device cpu   # parity: device vs engine
"""

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import loads
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.runtime.train_loop import MultiModelCAMRTrainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--modes", default="camr,uncoded,camr_spmd",
                    help="comma-separated grad-sync modes to run and "
                         "compare (first one is the reference)")
    ap.add_argument("--grad-sync-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="shuffle payload dtype — bfloat16 rides the "
                         "packed 16-bit codec lane; the bit-identity "
                         "assertions hold per lane")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args()
    modes = args.modes.split(",")
    device = resolve_device(args.device)

    cfg = reduced(get_config("granite_3_2b")).replace(
        n_layers=2, vocab=256, d_model=64, d_ff=128, loss_chunk=16)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=16,
                                global_batch=4, structure=0.9)

    reports, trainers = {}, {}
    for mode in modes:
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, lr=1e-3, seed=0,
                                   spmd_oracle=(mode == "camr_spmd"),
                                   grad_sync_dtype=args.grad_sync_dtype,
                                   device=device)
        reports[mode] = tr.train_steps(pipe, args.steps, mode=mode)
        trainers[mode] = tr
        extra = (f" sync={reports[mode].sync}" if reports[mode].sync
                 else "")
        print(f"{mode:9s}: bytes/run={reports[mode].bytes_total:,} "
              f"L={reports[mode].loads.get('L_total_bus', 0):.4f} "
              f"final losses={np.round(reports[mode].losses[-1], 4)}"
              f"{extra}")

    ref = modes[0]
    for mode in modes[1:]:
        np.testing.assert_array_equal(
            trainers[mode].flat.cpu().numpy(),
            trainers[ref].flat.cpu().numpy(),
            err_msg=f"{mode} parameters diverged from {ref}")
        np.testing.assert_array_equal(
            np.asarray(reports[mode].losses),
            np.asarray(reports[ref].losses),
            err_msg=f"{mode} losses diverged from {ref}")
    print(f"\n{' vs '.join(modes)}: parameters and losses BIT-IDENTICAL")

    if "camr" in reports and "uncoded" in reports:
        camr, unc = reports["camr"], reports["uncoded"]
        print(f"coded shuffle shipped "
              f"{1 - camr.bytes_total / unc.bytes_total:.1%} fewer bytes "
              f"(analytic: 1 - {loads.camr_load(2, 3):.2f}/"
              f"{loads.uncoded_aggregated_load(2, 3):.2f} = "
              f"{1 - loads.camr_load(2, 3) / loads.uncoded_aggregated_load(2, 3):.1%})")
    print("OK")


if __name__ == "__main__":
    main()
