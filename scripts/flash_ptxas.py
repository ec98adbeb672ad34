#!/usr/bin/env python3
"""Registers, spills and shared memory of each ``flash_attention`` body,
as ``ptxas -v`` reports them.

    python3 scripts/flash_ptxas.py        # from the root of a checkout

Compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` with the
port's own ``nvcc`` flags plus ``-Xptxas -v`` (``kernel_tools.ptxas``)
and prints one line per kernel instantiation: the body (``tc``: bf16 on
the tensor cores; ``simt``: f32 on the CUDA cores; ``merge``: the f32
body's merge of its key splits), the head dim, registers a thread,
spill stores and loads, static shared memory and the dynamic shared
memory it launches with (``TcShape<D>::kSmem``, ``F32Shape<D>::kSmem``).
Needs ``nvcc``; no card.
"""

from __future__ import annotations

import re
import sys

import kernel_tools

sys.path.insert(0, f"{kernel_tools.ROOT}/src")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402


def main() -> int:
    rows, smem, notes = kernel_tools.ptxas(
        _build, _build.CSRC / "flash_attention.cu",
        [f"{shape}<{d}>::kSmem" for shape in ("TcShape", "F32Shape")
         for d in HEAD_DIMS])
    for row in rows:
        body = re.search(r"flash_(tc|simt)ILi(\d+)E", row["name"])
        if "flash_simt_merge" in row["name"]:
            kind, d, dyn = "merge", "any", 0
        elif body:
            kind, d = body.group(1), int(body.group(2))
            dyn = smem[HEAD_DIMS.index(d) + (kind == "simt") * len(HEAD_DIMS)]
        else:
            continue
        print(f"flash_attention {kind} D={d}: {row['registers']} registers, "
              f"spill stores {row['spill_stores']} B, spill loads "
              f"{row['spill_loads']} B, static smem {row['static_smem']} B, "
              f"dynamic smem {dyn} B")
    for line in notes:
        print("ptxas:", line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
