"""Runtime of the port: the multi-model CAMR trainer, the single-model
trainer, the serving engine, and the numpy JobStream runtime (a copy of
the JAX package's)."""

from .serve import (DecodeEngine, Request, ServeResult, ServeStream,
                    generate, serve_legacy)
from .train_loop import CAMRTrainReport, MultiModelCAMRTrainer, Trainer

__all__ = ["CAMRTrainReport", "MultiModelCAMRTrainer", "Trainer",
           "DecodeEngine",
           "Request", "ServeResult", "ServeStream", "generate",
           "serve_legacy"]
