"""Roofline of each dry-run cell on H100s, the twin of
``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds per step of one
device:

    compute    = FLOPs / PEAK_FLOPS            (bf16 dense tensor cores)
    memory     = bytes / HBM_BW                (HBM3)
    collective = NVLink wire bytes / NVLINK_BW + network wire bytes / NET_BW

The FLOPs and bytes are the eager trace's of
:mod:`repro_torch.launch.dryrun` (every layer counted as it runs; the
hand-written kernels by their formulas), the collective bytes the
collective ledger's: none on one card (mesh ``"card"``); on JAX's
meshes (``"single"``, ``"multipod"``) every number is one device's (rank
0's trace), as JAX's SPMD module's are, and each collective's bytes go
to NVLink when its group's ranks share an 8-card HGX node
(:data:`GPUS_PER_NODE`), else to the network. On the (16, 16) and (2,
16, 16) meshes every axis spans nodes (16 cards), so every collective
crosses the network. ``mfu`` divides the model FLOPs by ``devices x
PEAK_FLOPS x step_time``, as JAX's does. The step's memory is the
trace's peak live bytes (arguments included), against
:data:`HBM_BYTES`.

The constants are data sheets', not measurements: the NVIDIA H100 SXM5
sheet's 989e12 FLOP/s dense bf16 on the tensor cores (f32 on the CUDA
cores 67e12, :data:`PEAK_FLOPS_F32`), 3.35e12 B/s of HBM3, 450e9 B/s of
NVLink 4 a direction and 80 GB of device memory; the NVIDIA ConnectX-7
sheet's 400 Gb/s NDR InfiniBand port, one per GPU in a DGX H100 (50e9
B/s a direction).

Usage: ``PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh
{card,single,multipod}] [--markdown]`` after ``python -m
repro_torch.launch.dryrun --all [--mesh ...]``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..configs import SHAPES, ShapeSpec, get_config
from .dryrun import RESULTS_DIR

__all__ = ["Roofline", "model_flops", "load_cell", "roofline_from_cell",
           "table", "markdown", "main", "PEAK_FLOPS", "PEAK_FLOPS_F32",
           "HBM_BW", "NVLINK_BW", "NET_BW", "GPUS_PER_NODE", "HBM_BYTES"]

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores (H100 SXM5 sheet)
PEAK_FLOPS_F32 = 67e12     # f32, CUDA cores (H100 SXM5 sheet)
HBM_BW = 3.35e12           # B/s, HBM3 (H100 SXM5 sheet)
NVLINK_BW = 450e9          # B/s a direction, NVLink 4 (H100 SXM5 sheet)
NET_BW = 50e9              # B/s a direction: ConnectX-7 NDR 400 Gb/s
#                            InfiniBand (ConnectX-7 sheet), one per GPU
GPUS_PER_NODE = 8          # an HGX H100 8-GPU board, all-to-all NVLink
HBM_BYTES = 80e9           # device memory (H100 SXM5 sheet: 80 GB)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # 6*N*D (active params for MoE)
    hlo_flops_dev: float        # the trace's FLOPs (JAX: the HLO's)
    hbm_gib: float              # peak live GiB, arguments included

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Max-term model (perfect overlap of the other two)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / the step's FLOPs: below 1 by the remat
        recompute of a train step (JAX's "remat/redundancy waste")."""
        total = self.hlo_flops_dev * self.devices
        return self.model_flops / total if total else float("nan")

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        if self.step_time_s == 0:
            return float("nan")
        return (self.model_flops
                / (self.devices * PEAK_FLOPS * self.step_time_s))

    @property
    def roofline_fraction(self) -> float:
        """compute_term / step_time — 1.0 when compute-bound."""
        return self.compute_s / self.step_time_s if self.step_time_s else 0


def model_flops(arch: str, shape_name) -> float:
    """6*N*D for train (fwd+bwd); 2*N*D for inference steps.
    ``shape_name``: a key of ``SHAPES`` or a ``ShapeSpec``."""
    cfg = get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def load_cell(arch: str, shape: str, mesh: str = "card",
              suffix: str = "") -> dict:
    fn = os.path.join(RESULTS_DIR, f"{arch}_{shape}_{mesh}{suffix}.json")
    with open(fn) as f:
        return json.load(f)


def roofline_from_cell(cell: dict, cost_cell: dict | None = None
                       ) -> Roofline:
    """``cell``: a dry-run record (memory, and the counts); ``cost_cell``:
    a cost-pass record (the same counts; falls back to ``cell``). A cell
    of a reduced batch carries its ``seq_len``, ``global_batch`` and
    ``kind``, which size its model FLOPs."""
    cc = cost_cell or cell
    dev = cell["devices"]
    flops_dev = cc["cost"]["flops"]
    bytes_dev = cc["cost"]["bytes_accessed"]
    coll = cc["collectives"]
    links = coll.get("wire_bytes_by_link") or {
        "nvlink": coll["wire_bytes"]}
    coll_s = (links.get("nvlink", 0) / NVLINK_BW
              + links.get("network", 0) / NET_BW)
    mem = cell["memory"]
    shape = cell["shape"]
    if shape not in SHAPES:
        shape = ShapeSpec(shape, cell["seq_len"], cell["global_batch"],
                          cell["kind"])
    return Roofline(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
        devices=dev,
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll_s,
        model_flops=model_flops(cell["arch"], shape),
        hlo_flops_dev=flops_dev,
        hbm_gib=(mem["argument_bytes"] + mem["temp_bytes"]) / 2 ** 30,
    )


def table(mesh: str = "card") -> list[Roofline]:
    out = []
    if not os.path.isdir(RESULTS_DIR):
        return out
    for fn in sorted(os.listdir(RESULTS_DIR)):
        if not fn.endswith(f"_{mesh}.json"):
            continue
        with open(os.path.join(RESULTS_DIR, fn)) as f:
            cell = json.load(f)
        if cell.get("status") != "ok":
            continue
        cost = None
        cfn = os.path.join(RESULTS_DIR, fn.replace(".json", "_cost.json"))
        if os.path.exists(cfn):
            with open(cfn) as f:
                cost = json.load(f)
            if cost.get("status") != "ok":
                cost = None
        out.append(roofline_from_cell(cell, cost))
    return out


def markdown(mesh: str = "card") -> str:
    """Every dry-run record of ``mesh`` as one Markdown table: status,
    argument and peak GB, whether the peak fits :data:`HBM_BYTES`,
    FLOPs, bytes, the three terms, ``dominant`` and ``mfu`` (a skipped
    or failed cell: its status and reason)."""
    out = ["| Arch | Shape | Status | Args GB | Peak GB | Fits 80 GB | FLOPs "
           "| Bytes | Compute s | Memory s | Coll. s | Dominant | MFU |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for fn in sorted(os.listdir(RESULTS_DIR)):
        if not fn.endswith(f"_{mesh}.json"):
            continue
        with open(os.path.join(RESULTS_DIR, fn)) as f:
            cell = json.load(f)
        head = f"| {cell['arch']} | {cell['shape']} | {cell['status']}"
        if cell["status"] != "ok":
            why = cell.get("reason") or cell.get("error", "")
            out.append(head + f": {why.split(' (')[0]} |" + " |" * 10)
            continue
        r = roofline_from_cell(cell)
        mem = cell["memory"]
        out.append(
            head + f" | {mem['argument_bytes'] / 1e9:.1f} | "
            f"{mem['peak_bytes'] / 1e9:.1f} | "
            f"{'yes' if cell['fits'] else 'no'} | "
            f"{cell['cost']['flops']:.4g} | "
            f"{cell['cost']['bytes_accessed']:.4g} | {r.compute_s:.4g} | "
            f"{r.memory_s:.4g} | {r.collective_s:.3g} | {r.dominant} | "
            f"{r.mfu:.1%} |")
    return "\n".join(out)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Roofline of the dry-run "
                                             "cells on H100s")
    ap.add_argument("--mesh", choices=["card", "single", "multipod"],
                    default="card")
    ap.add_argument("--markdown", action="store_true",
                    help="every cell (skipped ones too) as a Markdown "
                         "table")
    args = ap.parse_args(argv)
    if args.markdown:
        print(markdown(args.mesh))
        return
    rows = table(args.mesh)
    hdr = (f"{'arch':24s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
           f"{'coll_s':>8s} {'dom':>10s} {'MFU':>6s} {'useful':>7s} "
           f"{'HBM':>8s}")
    print(hdr)
    for r in rows:
        print(f"{r.arch:24s} {r.shape:12s} {r.compute_s:9.4f} "
              f"{r.memory_s:9.4f} {r.collective_s:8.4f} {r.dominant:>10s} "
              f"{r.mfu:6.1%} {r.useful_flops_ratio:7.2f} "
              f"{r.hbm_gib:7.1f}G")


if __name__ == "__main__":
    main()
