from .model import forward_decode, forward_prefill, forward_train, init_caches, init_params
from .moe import aux_load_balance_loss, capacity, moe_apply, moe_init

__all__ = ["aux_load_balance_loss", "capacity", "forward_decode", "forward_prefill", "forward_train", "init_caches",
           "init_params", "moe_apply", "moe_init"]
