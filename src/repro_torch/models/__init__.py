from .model import forward_decode, init_caches, init_params

__all__ = ["forward_decode", "init_caches", "init_params"]
