"""Model code of the port: the layer primitives and the LMs of every
family (``layers``, ``lm``), the names of JAX's ``repro.models``."""

from . import layers, lm

__all__ = ["layers", "lm"]
