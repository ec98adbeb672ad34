"""Runtime of the port: the multi-model CAMR trainer and the serving
engine."""

from .serve import (DecodeEngine, Request, ServeResult, ServeStream,
                    generate, serve_legacy)
from .train_loop import CAMRTrainReport, MultiModelCAMRTrainer

__all__ = ["CAMRTrainReport", "MultiModelCAMRTrainer", "DecodeEngine",
           "Request", "ServeResult", "ServeStream", "generate",
           "serve_legacy"]
