"""Step builders: the serve steps so far; training comes with its slice."""

from .steps import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
