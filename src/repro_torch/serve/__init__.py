"""Serving: fused prefill + continuous batching + paged KV cache.

See :mod:`repro_torch.serve.engine` and :mod:`repro_torch.serve.cache`;
the spec-level entry point is :class:`repro_torch.api.ServeSpec`.
"""
from repro_torch.serve.cache import DenseOps, PagedOps, make_ops
from repro_torch.serve.engine import Request, Result, ServeEngine

__all__ = ["DenseOps", "PagedOps", "make_ops",
           "Request", "Result", "ServeEngine"]
