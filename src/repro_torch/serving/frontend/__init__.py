"""repro_torch.serving.frontend — multi-tenant request routing with an FP8
LSTM-state prefix cache (counterpart of ``repro.serving.frontend``).

The batching engine (serving/engine.py) turns requests into device steps;
this package turns traffic into requests: bounded-queue admission with
deadline awareness, least-loaded dispatch across engine replicas,
streaming token callbacks, per-tenant accounting, replica health
(ejection, resubmission, probing), and a shared prefix cache that stores
per-layer (h, c) snapshots in FP8 so repeated prompt prefixes skip their
prefill.
"""
from .prefix_cache import CacheEntry, CacheHit, PrefixCache, entry_checksum
from .router import AsyncRouter, RequestRejected, Router, Ticket

__all__ = [
    "PrefixCache", "CacheEntry", "CacheHit", "entry_checksum",
    "Router", "AsyncRouter", "Ticket", "RequestRejected",
]
