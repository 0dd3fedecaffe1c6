"""Batched serving of the port: packed FloatSD8 / FloatSD4 weight store, lane-state
pool, fifo/sjf admission, metrics and the continuous-batching engine."""
from .engine import Lane, ServeEngine
from .metrics import ServeMetrics
from .scheduler import ADMISSION_POLICIES, Request, Scheduler, synthetic_prompts
from .state_pool import StatePool, masked_reset
from .weight_store import (
    WEIGHT_FORMATS, PackedTensor, PackedTensor4, WeightStore, pack_floatsd4, pack_tree,
    tree_nbytes, unpack_tree,
)

__all__ = [
    "ADMISSION_POLICIES", "Lane", "PackedTensor", "PackedTensor4", "Request", "Scheduler",
    "ServeEngine", "ServeMetrics", "StatePool", "WEIGHT_FORMATS", "WeightStore",
    "masked_reset", "pack_floatsd4", "pack_tree", "synthetic_prompts", "tree_nbytes",
    "unpack_tree",
]
