"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's H100 SXM5 data sheet:
dense bf16 on the tensor cores, HBM3 bandwidth; at the full 700 W power
limit)."""

from __future__ import annotations

__all__ = ["PEAKS", "peaks_of"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(kind: str) -> dict:
    """The card's peaks, or ``{}`` for a device the table lacks (the
    shares of a peak are then not read)."""
    return PEAKS.get(kind, {})
