"""Optimizer: AdamW with a cosine schedule and a global-norm clip."""

from .adamw import adamw_update, clip_by_global_norm, cosine_schedule, global_norm, init_opt_state

__all__ = ["adamw_update", "clip_by_global_norm", "cosine_schedule", "global_norm", "init_opt_state"]
