"""Core CAMR library of the port: the numpy schedule and engines (copies
of the JAX package's numpy-only modules) and the stacked-device shuffle
executor. The package names are JAX's ``repro.core``'s."""

from .designs import ResolvableDesign, make_design, factorize_cluster
from .placement import Placement, make_placement
from .schedule import ShuffleProgram, lower_program, lower_degraded
from .engine import CAMRConfig, CAMREngine, run_wordcount_example
from . import loads, shuffle, baselines

__all__ = ["ResolvableDesign", "make_design", "factorize_cluster",
           "Placement", "make_placement", "ShuffleProgram", "lower_program",
           "lower_degraded", "CAMRConfig", "CAMREngine",
           "run_wordcount_example", "loads", "shuffle", "baselines"]
