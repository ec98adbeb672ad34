"""Deterministic sharded data pipeline (a copy of ``repro.data.pipeline``)."""

from .pipeline import ShardedTokenPipeline, make_camr_job_datasets, wordcount_corpus

__all__ = ["ShardedTokenPipeline", "make_camr_job_datasets",
           "wordcount_corpus"]
