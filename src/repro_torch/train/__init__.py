"""Step builders: the train step with its loss, and the serve steps."""

from .steps import (
    abstract_train_state,
    cross_entropy_loss,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = ["abstract_train_state", "cross_entropy_loss", "init_train_state", "make_decode_step", "make_prefill_step",
           "make_train_step"]
