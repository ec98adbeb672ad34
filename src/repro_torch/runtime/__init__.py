"""Runtime of the port: the multi-model CAMR trainer, the single-model
trainer, the serving engine, fault tolerance, and the numpy JobStream
runtime (a copy of the JAX package's). The package names are JAX's
``repro.runtime``'s, and the port's own beside them."""

from .train_loop import CAMRTrainReport, MultiModelCAMRTrainer, Trainer
from .jobstream import JobSpec, JobStream, StreamReport
from .serve import (DecodeEngine, GenerationResult, PagePool, Request,
                    ServeResult, ServeStream, ServeReport, generate,
                    serve_legacy)
from . import fault, serve

__all__ = ["CAMRTrainReport", "MultiModelCAMRTrainer", "Trainer",
           "JobSpec", "JobStream", "StreamReport", "fault", "serve",
           "generate", "serve_legacy", "GenerationResult", "Request",
           "ServeResult", "PagePool", "DecodeEngine", "ServeStream",
           "ServeReport"]
