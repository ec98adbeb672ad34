#!/usr/bin/env python3
"""Registers, spills and shared memory of each ``flash_attention`` body,
as ``ptxas -v`` reports them.

    python3 scripts/flash_ptxas.py        # from the root of a checkout

Compiles ``src/repro_torch/kernels/csrc/flash_attention.cu`` with the
port's own ``nvcc`` flags plus ``-Xptxas -v`` into a temporary file and
prints one line per kernel instantiation: the body (``tc``: bf16 on the
tensor cores; ``simt``: f32 on the CUDA cores), the head dim, registers
a thread, spill stores and loads, static shared memory and, for the bf16
body, the dynamic shared memory it launches with (``TcShape<D>::kSmem``).
Needs ``nvcc``; no card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402


def tc_smem(d: int) -> int:
    """``TcShape<D>::kSmem``: a Q tile and ``kStages`` K and V tiles of
    ceil(D/64) 8 KB panels, plus 1 KB for alignment."""
    stages = 4 if d <= 64 else 2 if d <= 128 else 3
    return -(-d // 64) * 64 * 128 * (1 + 2 * stages) + 1024


def main() -> int:
    src = _build.CSRC / "flash_attention.cu"
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), str(src)],
            capture_output=True, text=True)
    log = out.stdout + out.stderr
    if out.returncode != 0:
        print(log)
        return out.returncode
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = m.groups()
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        body = name and re.search(r"flash_(tc|kernel)If?Li(\d+)E", name)
        if m and body:
            kind = "tc" if body.group(1) == "tc" else "simt"
            d = int(body.group(2))
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            print(f"flash_attention {kind} D={d}: {m.group(1)} registers, "
                  f"spill stores {spills[0]} B, spill loads {spills[1]} B, "
                  f"static smem {smem.group(1) if smem else 0} B"
                  + (f", dynamic smem {tc_smem(d)} B" if kind == "tc"
                     else ""))
            name = None
    for line in log.splitlines():
        if "C7518" in line or "warning" in line.lower():
            print("ptxas:", line.strip()[:200])
    return 0


if __name__ == "__main__":
    sys.exit(main())
