"""Batched serving of the port: packed FloatSD8 / FloatSD4 weight store,
lane-state pool, admission policies, metrics, the continuous-batching
engine, the frontend (router and FP8 prefix cache) and the HTTP/SSE
service over it."""
from .engine import Lane, ServeEngine
from .frontend import AsyncRouter, PrefixCache, RequestRejected, Router, Ticket
from .http import HttpServer
from .metrics import RequestRecord, ServeMetrics, phase_summary, tenant_summary
from .scheduler import (
    ADMISSION_POLICIES, Request, Scheduler, synthetic_prompts, zipf_prefix_prompts,
)
from .state_pool import StatePool, masked_reset
from .weight_store import (
    WEIGHT_FORMATS, PackedTensor, PackedTensor4, WeightStore, pack_floatsd4, pack_tree,
    tree_nbytes, unpack_tree,
)

__all__ = [
    "ServeEngine", "Lane",
    "ServeMetrics", "RequestRecord", "tenant_summary", "phase_summary",
    "Scheduler", "Request", "ADMISSION_POLICIES", "synthetic_prompts", "zipf_prefix_prompts",
    "StatePool", "masked_reset",
    "PrefixCache", "Router", "AsyncRouter", "Ticket", "RequestRejected", "HttpServer",
    "WeightStore", "PackedTensor", "PackedTensor4", "WEIGHT_FORMATS",
    "pack_tree", "pack_floatsd4", "unpack_tree", "tree_nbytes",
]
