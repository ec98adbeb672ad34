"""The plain float32 reference of the benchmark's cells: ``common`` for
what every model family shares, one module per family (named by a
configuration's ``family``) for its parameter layout, forward pass and
FLOPs. Imports nothing of the program."""

from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of the model family ``name``."""
    return importlib.import_module(f"{__name__}.{name}")
