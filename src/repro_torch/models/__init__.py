from .model import forward_decode, forward_prefill, forward_train, init_caches, init_params

__all__ = ["forward_decode", "forward_prefill", "forward_train", "init_caches", "init_params"]
