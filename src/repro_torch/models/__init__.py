from .model import (
    abstract_caches,
    abstract_params,
    encoder_forward,
    forward_decode,
    forward_prefill,
    forward_train,
    init_caches,
    init_params,
)
from .moe import aux_load_balance_loss, capacity, moe_apply, moe_init

__all__ = ["abstract_caches", "abstract_params", "aux_load_balance_loss", "capacity", "encoder_forward",
           "forward_decode", "forward_prefill", "forward_train", "init_caches", "init_params", "moe_apply", "moe_init"]
