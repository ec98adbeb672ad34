"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/`` holds the CUDA C++ sources, built by :mod:`._build` on first
use; :mod:`.ref` holds the plain-PyTorch version of each kernel;
:mod:`.ops` is the dispatch layer the JAX package's models call.
"""

from __future__ import annotations

from .aggregate import aggregate, aggregate_bf16
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan
from .xor_code import (xor_decode, xor_decode_gather, xor_decode_gather16,
                       xor_encode, xor_encode_gather, xor_encode_gather16,
                       xor_fold)

__all__ = ["KERNELS", "aggregate", "aggregate_bf16", "xor_encode_gather",
           "xor_decode_gather", "xor_encode_gather16", "xor_decode_gather16",
           "xor_fold", "xor_decode", "xor_encode", "flash_attention",
           "ssd_scan", "launch_counts", "reset_launch_counts"]

#: every kernel wrapper of the port, by kernel name (``aggregate`` counts
#: the f32 combiner, ``aggregate_bf16`` the bf16 one)
KERNELS = {"xor_encode_gather": xor_encode_gather,
           "xor_decode_gather": xor_decode_gather,
           "aggregate": aggregate,
           "xor_encode_gather16": xor_encode_gather16,
           "xor_decode_gather16": xor_decode_gather16,
           "aggregate_bf16": aggregate_bf16,
           "xor_fold": xor_fold,
           "xor_decode": xor_decode,
           "xor_encode": xor_encode,
           "flash_attention": flash_attention,
           "ssd_scan": ssd_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (flash_attention, ssd_scan):
        fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)
