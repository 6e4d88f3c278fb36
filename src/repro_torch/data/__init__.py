"""Deterministic synthetic training data with merge-path length packing."""

from .pipeline import PipelineConfig, SyntheticLMPipeline, make_batch_specs

__all__ = ["PipelineConfig", "SyntheticLMPipeline", "make_batch_specs"]
