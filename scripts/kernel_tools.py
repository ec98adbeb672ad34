"""What the kernel scripts of ``scripts/`` share: ``chip_smoke.py`` as a
module, the times of one call, the card's name and power limit, and what
``ptxas -v`` makes of a kernel source. Imported by
``scripts/flash_bench.py``, ``scripts/flash_ptxas.py`` and
``scripts/ssd_bench.py``."""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def host_us(fn, calls=20) -> float:
    """Host microseconds to enqueue one call (no synchronisation between
    calls)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def times(smoke, fn) -> dict:
    """The median CUDA-event time of a call (``ms``, host launch
    included, as ``chip_smoke.time_ms``), the device time of its kernels
    in a ``torch.profiler`` trace (``device_ms``, as
    ``chip_smoke.device_ms``) and the host time to enqueue it
    (``host_us``)."""
    return dict(ms=smoke.time_ms(fn), device_ms=smoke.device_ms(fn),
                host_us=host_us(fn))


def ptxas(build, src, consts=()):
    """Compile ``src`` with the port's ``nvcc`` flags plus ``-Xptxas -v``
    into a program that prints the value of each C++ expression in
    ``consts`` (constants of the source, such as a kernel's dynamic shared
    memory), and run it (host code only: no card). Returns ``(rows,
    values, notes)``: per kernel instantiation its mangled ``name``,
    ``registers``, ``spill_stores``, ``spill_loads`` and ``static_smem``
    (bytes); the values of ``consts``; and ptxas's warnings and
    performance notes (a serialized ``wgmma`` shows there). Raises if the
    build fails."""
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    prints = "".join(f'  std::printf("%lld\\n", (long long)({e}));\n'
                     for e in consts)
    with tempfile.TemporaryDirectory() as tmp:
        main = os.path.join(tmp, "main.cu")
        with open(main, "w") as f:
            f.write(f'#include "{os.path.abspath(src)}"\n#include <cstdio>\n'
                    f"int main() {{\n{prints}  return 0;\n}}\n")
        exe = os.path.join(tmp, "consts")
        out = subprocess.run([build._nvcc(), *flags, "-Xptxas", "-v", "-o",
                              exe, main], capture_output=True, text=True)
        log = out.stdout + out.stderr
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        values = [int(v) for v in subprocess.run(
            [exe], capture_output=True, text=True, check=True).stdout.split()]
    rows, name, spills = [], None, None
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
        if m and name and spills:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows.append(dict(name=name, registers=int(m.group(1)),
                             spill_stores=int(spills[0]),
                             spill_loads=int(spills[1]),
                             static_smem=int(smem.group(1)) if smem else 0))
            name = spills = None
    notes = [line.strip()[:300] for line in log.splitlines()
             if "Performance" in line or "warning" in line.lower()]
    return rows, values, notes
