#!/usr/bin/env python3
"""Time one checkout's fused XOR gathers at the training step's tables,
and show what ``ptxas`` makes of their kernels.

    python3 scripts/xor_bench.py [--src DIR] [--tag NAME] [--ptxas]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and builds stage 1's tables of the training cell (``launch/cell.py``:
granite_3_2b at 2 layers, q=2, k=3, so ``make_plan(2, 3, d_shard)``
with ``d_shard`` from the model's parameter count), as ``chip_smoke.py``
does. Then, for the u32 word lane (``xor_encode_gather`` /
``xor_decode_gather``) and the packed 16-bit lane
(``xor_encode_gather16`` / ``xor_decode_gather16``), at two packet
rows: the step's own (``row: "step"``; at the cell 18,547,542 f32 words,
8 mod 16 bytes, or 18,547,542 u16 lanes, 37,095,084 bytes, 12 mod 16)
and an aligned control cut to a multiple of 16 bytes (``"aligned"``:
every row starts on a 16-byte boundary), it prints one JSON line a
kernel with the times of ``kernel_tools.times`` (``ms``,
``device_ms``, ``host_us``) and the byte bound (each valid source row
and each selected recv row read once, each output row written once, at
3.35 TB/s). ``--ptxas`` first compiles ``DIR``'s ``csrc/xor_gather.cu``
with the port's ``nvcc`` flags plus ``-Xptxas -v`` and prints registers,
spills and shared memory per kernel instantiation. To compare two
versions of the kernels on one card, run both checkouts in one call, in
turns (parent, change, change, parent). Needs one CUDA card
(``--ptxas`` alone needs only ``nvcc``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import kernel_tools


def ptxas(build, tag: str) -> None:
    src = os.path.join(os.path.dirname(build.__file__), "csrc",
                       "xor_gather.cu")
    rows, _, notes = kernel_tools.ptxas(build, src)
    for row in rows:
        print(f"xor_gather [{tag}] {row['name']}: {row['registers']} "
              f"registers, spill stores {row['spill_stores']} B, spill "
              f"loads {row['spill_loads']} B, static smem "
              f"{row['static_smem']} B", flush=True)
    for line in notes:
        print("ptxas:", line)


def cell_d_shard(torch) -> int:
    """The training cell's ``d_shard``: its model's parameter count over
    K workers, padded as ``MultiModelCAMRTrainer`` pads it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cell
    from repro_torch.models import lm
    from repro_torch.weights import flat_spec
    cfg = get_config(cell.ARCH).replace(n_layers=cell.N_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    D = flat_spec(lm.init_params(cfg, gen)).size
    K = cell.Q * cell.K
    d = -(-D // K)
    return d + (-d) % (cell.K - 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(kernel_tools.ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    if args.ptxas:
        from repro_torch.kernels import _build
        ptxas(_build, args.tag)
    import torch
    if not torch.cuda.is_available():
        if args.ptxas:
            return 0
        print("xor_bench: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.collective import _device_tables, make_plan
    from repro_torch.core.schedule import payload_words
    from repro_torch.launch import cell
    smoke = kernel_tools.chip_smoke()
    print(kernel_tools.card())
    q, k = cell.Q, cell.K
    d_shard = cell_d_shard(torch)
    torch.cuda.empty_cache()
    plan = make_plan(q, k, d_shard)
    K = plan.K
    st = _device_tables(plan, torch.device("cuda"), "all_to_all")["stages"][1]
    P = plan.J_own * (k - 1) * K * (k - 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for half in (False, True):
        enc_fn, dec_fn, _, _, dtype = smoke._lane(half)
        esize = 2 if half else 4
        step = (2 * (payload_words(d_shard, 2, k) // (k - 1)) if half
                else d_shard // (k - 1))
        for kind, row in (("step", step),
                          ("aligned", step - step % (16 // esize))):
            chunks = smoke._rand_bits((K, P, row), gen, dtype)
            rows = st["dec_recv"].shape[1]
            recv = smoke._rand_bits((K, rows, row), gen, dtype)
            eargs = (chunks, st["enc_src"], st["src_ok"])
            dargs = (recv, chunks, st["dec_recv"], st["dec_src"],
                     st["dec_mask"])
            rb = row * esize
            bound = {enc_fn: smoke._gather_bytes(eargs[1], eargs[2], rb,
                                                 K * st["n"]),
                     dec_fn: smoke._gather_bytes(st["dec_src"],
                                                 st["dec_mask"], rb,
                                                 K * rows, recv_rows=K * rows)
                     + st["dec_recv"].numel() * 4}
            for fn, fargs in ((enc_fn, eargs), (dec_fn, dargs)):
                out = dict(tag=args.tag, src=args.src, kernel=fn.__name__,
                           row=kind, row_elems=row, row_bytes=rb,
                           row_phase=rb % 16, d_shard=d_shard,
                           bound_ms=bound[fn] / smoke.HBM_BYTES_PER_S * 1e3,
                           **kernel_tools.times(smoke,
                                                lambda: fn(*fargs)))
                print(json.dumps(out), flush=True)
            del chunks, recv, eargs, dargs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
