"""Device choice of the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none.
    A CUDA device without an index gets the current one, so tensors and
    the devices they are checked against compare equal.

    The port never falls back to the CPU on its own: a caller that wants
    the plain CPU versions (the tests) passes ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless told otherwise, "
                "and torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
