"""Serving plane: paged KV cache, chunked prefill, continuous batching
(the port of the JAX package's ``serve/``; see README "Serving")."""
from repro_torch.serve.engine import LoopEngine, PagedEngine, latency_percentiles
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["KVPool", "LoopEngine", "PagedEngine", "Request", "Scheduler",
           "latency_percentiles"]
