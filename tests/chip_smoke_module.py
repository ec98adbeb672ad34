"""``chip_smoke.py`` loaded as a module, for the tests that read its
serving shapes and limits."""

from __future__ import annotations

import functools
import importlib.util
import os


@functools.cache
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke
