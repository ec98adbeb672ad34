"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/`` holds the CUDA C++ sources, built by :mod:`._build` on first
use; :mod:`.ref` holds the plain-PyTorch version of each kernel.
"""

from __future__ import annotations

from .aggregate import aggregate
from .xor_code import xor_decode_gather, xor_encode_gather

__all__ = ["KERNELS", "aggregate", "xor_encode_gather", "xor_decode_gather",
           "launch_counts", "reset_launch_counts"]

#: every kernel wrapper of the port, by kernel name
KERNELS = {"xor_encode_gather": xor_encode_gather,
           "xor_decode_gather": xor_decode_gather,
           "aggregate": aggregate}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
