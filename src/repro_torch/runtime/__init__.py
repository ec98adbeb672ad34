"""Runtime of the port: the multi-model CAMR trainer."""

from .train_loop import CAMRTrainReport, MultiModelCAMRTrainer

__all__ = ["CAMRTrainReport", "MultiModelCAMRTrainer"]
