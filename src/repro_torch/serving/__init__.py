"""Batched serving of the port: packed FloatSD8 weight store, lane-state
pool, fifo/sjf admission, metrics and the continuous-batching engine."""
from .engine import Lane, ServeEngine
from .metrics import ServeMetrics
from .scheduler import ADMISSION_POLICIES, Request, Scheduler, synthetic_prompts
from .state_pool import StatePool, masked_reset
from .weight_store import PackedTensor, WeightStore, pack_tree, tree_nbytes, unpack_tree

__all__ = [
    "ADMISSION_POLICIES", "Lane", "PackedTensor", "Request", "Scheduler",
    "ServeEngine", "ServeMetrics", "StatePool", "WeightStore", "masked_reset",
    "pack_tree", "synthetic_prompts", "tree_nbytes", "unpack_tree",
]
