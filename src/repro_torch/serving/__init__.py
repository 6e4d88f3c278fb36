from .engine import Request, ServingEngine, ServingReport
from .sampler import greedy, topk_sample, topp_sample

__all__ = ["Request", "ServingEngine", "ServingReport", "greedy", "topk_sample", "topp_sample"]
