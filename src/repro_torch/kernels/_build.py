"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
named by a hash of its source and placed in ``<checkout>/build/kernels``
(listed in ``.gitignore``). Nothing here runs at import time: the first
launch of a kernel builds its library, and :func:`build_all` builds
every library at once, one ``nvcc`` process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

__all__ = ["SOURCES", "BUILD_COUNTS", "build_all", "load", "check",
           "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel library name -> its C entry points (argtypes, in order)
_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F32 = ctypes.c_float
#: q, k, v, o; B, Hq, Hkv, Tq, Tk, D; the 12 strides; scale, softcap,
#: causal, window; the stream
_FLASH = [_VP] * 4 + [_LL] * 6 + [_VP, _F32, _F32, _INT, _LL, _VP]
#: the same with, before the stream, the f32 body's split plan, its
#: number of splits and the f32 workspace (partial sums; m and l)
_FLASH_F32 = _FLASH[:-1] + [_VP, _LL, _VP, _VP, _VP]
#: x, a, b, c, y; B, T, H, P, S; the 12 strides; the stream
_SSD = [_VP] * 5 + [_LL] * 5 + [_VP, _VP]
#: the same with, before the stream, the f32 body's scratch: h_in, gram
_SSD_F32 = _SSD[:-1] + [_VP, _VP, _VP]
SOURCES = {
    "xor_gather": {
        "xor_encode_gather": [_VP] * 4 + [_LL] * 5 + [_INT, _VP],
        "xor_decode_gather": [_VP] * 6 + [_LL] * 6 + [_INT, _VP],
        "xor_encode_gather16": [_VP] * 4 + [_LL] * 5 + [_INT, _VP],
        "xor_decode_gather16": [_VP] * 6 + [_LL] * 6 + [_INT, _VP],
    },
    "xor_fold": {
        "xor_fold": [_VP] * 2 + [_LL] * 3 + [_INT, _VP],
        "xor_decode": [_VP] * 4 + [_LL] * 3 + [_INT, _VP],
    },
    "aggregate": {
        "aggregate_f32": [_VP] * 3 + [_LL] * 3 + [_INT, _VP],
        "aggregate_bf16": [_VP] * 3 + [_LL] * 3 + [_INT, _VP],
    },
    "flash_attention": {
        "flash_attention_f32": _FLASH_F32,
        "flash_attention_bf16": _FLASH,
    },
    "ssd_scan": {
        "ssd_scan_f32": _SSD_F32,
        "ssd_scan_bf16": _SSD,
    },
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the port compiles or loads at run time, by ``("nvcc" | "load",
#: library)``: one ``nvcc`` run per library built, one load per library
#: bound. The port has no jit; these are its counterpart of the JAX
#: package's trace counts (``repro_torch.runtime.serve.trace_total``).
BUILD_COUNTS: Counter = Counter()


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built from source on "
                       "the machine with the card")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_COUNTS["nvcc", name] += 1


def build_all() -> list[Path]:
    """Compile every kernel source in parallel (a no-op for libraries
    already built); returns the library paths."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        for name, job in jobs.items():
            _finish(name, job)
    return [_target(name) for name in SOURCES]


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SOURCES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.camr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.camr_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            BUILD_COUNTS["load", name] += 1
    return _libs[name]


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.camr_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn}: CUDA launch failed ({code}: {msg})")
