"""FP8 LSTM-state prefix cache: token-trie keyed (h, c) snapshots.

Counterpart of ``repro.serving.frontend.prefix_cache``. Entries are host
trees of CPU ``torch.float8_e4m3fn`` tensors (numpy has no FP8 dtype): the
FP8 cast runs on the state's device, the CRC on the host bytes, which equal
the reference's for the same state.

The recurrent formulation gives LSTM serving a property transformer KV
caches lack: the per-layer ``(h, c)`` state after consuming a prefix is a
**constant-size** summary of that entire prefix. Caching it makes
repeated-prefix prefill free — inject the snapshot and start at the match
point — with a footprint of O(layers * hidden) bytes per entry instead of
O(prefix_len * layers * hidden).

Storage format. Snapshots are quantized to real FP8 tensors on insert
(``core.fp8.cast_fp8``, saturating) and dequantized back to the state
pool's dtypes on hit. Shin et al. and Ott et al. (PAPERS.md) show LSTM
states tolerate aggressive quantization; e4m3 (default) carries a 3-bit
mantissa, so each stored component has relative rounding error <= 2^-4
(6.25%), and the recurrent gates (sigmoid-bounded, forget-decayed)
contract the perturbation as decoding proceeds. Exactness where it
matters: a *full* hit replays the stored ``next_token`` — recorded from
the unperturbed run — so a fully cached prompt's first token is exact and
its TTFT is zero device steps.

Keying. Entries live in a token trie; ``lookup(tokens)`` walks the query
and returns the deepest stored snapshot whose key is a proper prefix of
the query (or the whole query, if that entry carries a ``next_token``).
Entries are inserted at three kinds of positions:
  * block boundaries during prefill (``wants_snapshot``: every ``block``
    tokens, only where the trie has no entry yet) — these are what make
    *shared-system-prompt* workloads hit, since two prompts sharing a
    prefix diverge at arbitrary points but agree on block boundaries
    below their divergence;
  * end of prefill (key = the whole prompt, with the first generated
    token as ``next_token``);
  * retire (key = prompt + generated[:-1], ``next_token`` = last
    generated token) — serves "continue this conversation" resubmissions.

Eviction is LRU under ``budget_bytes`` (the FP8 payload bytes); lookup
refreshes recency. The cache is a plain host-side object shared by every
engine replica behind a router.
"""
from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..._tree import tree_leaves, tree_map
from ...core import fp8
from ...faults import CACHE_CORRUPT, FAULTS
from ..state_pool import to_host_fp8

__all__ = ["PrefixCache", "CacheEntry", "CacheHit", "entry_checksum"]


def entry_checksum(states_fp8, next_token: Optional[int]) -> int:
    """CRC32 over every stored FP8 leaf plus the continuation token.
    Entries are a few KB of host bytes, so this is cheap relative to the
    dequantize a hit pays anyway — and it is the only defense between a
    silently flipped bit and a poisoned lane injection."""
    crc = zlib.crc32(b"" if next_token is None else str(next_token).encode())
    for leaf in tree_leaves(states_fp8):
        crc = zlib.crc32(leaf.contiguous().view(torch.uint8).numpy(), crc)
    return crc


@dataclasses.dataclass
class CacheEntry:
    """One stored snapshot: FP8 state + the greedy continuation token."""

    key: tuple  # the token prefix this state summarizes (the LRU key)
    states_fp8: Any  # tree of host fp8 tensors (the structure of a lane)
    dtypes: Any  # tree of original leaf dtypes (restored on hit)
    next_token: Optional[int]  # greedy argmax after this prefix, if known
    nbytes: int
    checksum: int = 0  # entry_checksum() at insert; verified on use

    @property
    def length(self) -> int:
        return len(self.key)


@dataclasses.dataclass(frozen=True)
class CacheHit:
    match_len: int
    states: Any  # dequantized host tree, ready for StatePool.inject
    next_token: Optional[int]  # set iff match_len == query length

    @property
    def full(self) -> bool:
        return self.next_token is not None


class _TrieNode:
    __slots__ = ("children", "entry")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.entry: Optional[CacheEntry] = None


class PrefixCache:
    """Token-trie keyed store of FP8 per-layer (h, c) snapshots, LRU under
    a byte budget. See the module docstring for keying/insertion/eviction
    semantics and the FP8 error bound.

    Concurrency contract: a plain host-side object with **no internal
    locking**. It is shared by every engine replica behind one Router,
    which is safe because all engine calls (admission lookups, insertions
    at prefill boundaries/retire) happen inside ``Router.pump()`` — and
    the Router serializes pumps (a single-threaded caller or the
    AsyncRouter lock). Sharing one cache across *independently driven*
    routers or threads requires external locking. ``stats()`` reads plain
    counters and is safe anywhere.
    """

    def __init__(
        self,
        budget_bytes: int = 64 * 2**20,
        state_dtype=fp8.FP8_E4M3,
        block: int = 8,
    ):
        if block < 1:
            raise ValueError("block must be >= 1")
        self.budget_bytes = int(budget_bytes)
        self.state_dtype = state_dtype
        self.block = block
        self._root = _TrieNode()
        # LRU order: key tuple -> CacheEntry, oldest first
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self.nbytes = 0
        self.hits = 0
        self.full_hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.corruptions = 0  # checksum failures caught at lookup

    def __len__(self) -> int:
        return len(self._lru)

    # -- lookup ----------------------------------------------------------
    def lookup(self, tokens) -> Optional[CacheHit]:
        """Deepest usable snapshot for this prompt, or None.

        An entry at the *full* prompt length is usable only if it carries a
        ``next_token`` (there is no way to obtain the first generated token
        from a bare state without re-feeding a prompt token, which would
        corrupt the recurrence); otherwise the deepest strictly-shorter
        entry wins.
        """
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        node = self._root
        best: Optional[tuple[int, CacheEntry]] = None
        touched: list[CacheEntry] = []  # every entry on the matched path is hot
        depth = 0
        for t in toks:
            node = node.children.get(t)
            if node is None:
                break
            depth += 1
            e = node.entry
            if e is not None:
                touched.append(e)
                if depth < len(toks) or e.next_token is not None:
                    best = (depth, e)
        for e in touched:  # refresh recency even for unusable matches
            self._lru.move_to_end(e.key)
        if best is None:
            self.misses += 1
            return None
        match_len, entry = best
        if entry_checksum(entry.states_fp8, entry.next_token) != entry.checksum:
            # corrupt-as-miss: evict the damaged entry and report a miss —
            # injecting a bit-flipped state would silently corrupt every
            # token the lane goes on to decode. The shallower entries on
            # the path stay; the next identical lookup falls back to them.
            self.corruptions += 1
            self.misses += 1
            self._evict_key(entry.key)
            return None
        self.hits += 1
        full = match_len == len(toks)
        if full:
            self.full_hits += 1
        states = tree_map(lambda q, dt: q.to(dt), entry.states_fp8, entry.dtypes)
        return CacheHit(
            match_len=match_len,
            states=states,
            next_token=entry.next_token if full else None,
        )

    def match_len(self, tokens) -> int:
        """Length of the prefix a ``lookup`` on these tokens would inject,
        with NO side effects: no hit/miss counters, no LRU refresh, no
        dequantization. This is the scheduler's remaining-work probe — the
        router calls it once per admission to stamp ``Request.work_hint``,
        and a probe that warmed the LRU would let queue *inspection*
        distort the eviction order that actual traffic earned."""
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        node = self._root
        best = 0
        depth = 0
        for t in toks:
            node = node.children.get(t)
            if node is None:
                break
            depth += 1
            e = node.entry
            if e is not None and (depth < len(toks) or e.next_token is not None):
                best = depth
        return best

    # -- insertion policy ------------------------------------------------
    def wants_snapshot(self, tokens, pos: int) -> bool:
        """Should the engine bother extracting a mid-prefill snapshot at
        position ``pos``? Block-aligned positions with no entry yet. Host
        trie walk only — cheap enough to call once per prefill chunk."""
        if pos < self.block or pos % self.block != 0:
            return False
        return self._entry_at(tokens, pos) is None

    def wants(self, tokens, pos: int) -> bool:
        """Like wants_snapshot but for semantic boundaries (end of prompt,
        retire) where any position is worth keeping — and where the caller
        knows the greedy continuation, so an existing next_token-less block
        snapshot at this key is worth upgrading (otherwise a prompt whose
        length coincides with a snapshotted block boundary could never gain
        the full-hit fast path)."""
        if pos < 1:
            return False
        e = self._entry_at(tokens, pos)
        return e is None or e.next_token is None

    def _entry_at(self, tokens, pos: int) -> Optional[CacheEntry]:
        node = self._root
        for t in np.asarray(tokens).reshape(-1)[:pos]:
            node = node.children.get(int(t))
            if node is None:
                return None
        return node.entry

    # -- insert / evict --------------------------------------------------
    def insert(self, tokens, states, next_token: Optional[int] = None) -> None:
        """Store the state reached after consuming ``tokens``.

        Quantizes to FP8 and copies to the host at once (one transfer) —
        the engine's next step replaces the pool's tensors. Re-inserting an
        existing key refreshes it (and may upgrade a block snapshot with a
        ``next_token``).
        """
        toks = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        if not toks:
            return
        states_fp8, dtypes = to_host_fp8(states, self.state_dtype)
        nbytes = sum(
            a.nbytes for a in tree_leaves(states_fp8)
        ) + len(toks) * 4  # key tokens count against the budget too
        nt = None if next_token is None else int(next_token)
        entry = CacheEntry(
            key=toks,
            states_fp8=states_fp8,
            dtypes=dtypes,
            next_token=nt,
            nbytes=nbytes,
            checksum=entry_checksum(states_fp8, nt),
        )
        if FAULTS.enabled and FAULTS.fire(CACHE_CORRUPT) is not None:
            # flip one byte AFTER the checksum is recorded: a later lookup
            # must detect the mismatch and treat the entry as a miss. The
            # leaves share one host buffer, so flip a copy of the first.
            first = tree_leaves(entry.states_fp8)[0]
            bad = first.clone()
            bad.view(torch.uint8).reshape(-1)[0] ^= 0xFF
            entry = dataclasses.replace(
                entry,
                states_fp8=tree_map(lambda x: bad if x is first else x, entry.states_fp8),
            )
        node = self._root
        for t in toks:
            node = node.children.setdefault(t, _TrieNode())
        if node.entry is not None:  # refresh in place
            self.nbytes -= node.entry.nbytes
            self._lru.pop(toks, None)
        node.entry = entry
        self._lru[toks] = entry
        self.nbytes += nbytes
        self.insertions += 1
        while self.nbytes > self.budget_bytes and self._lru:
            self._evict_lru()

    def _evict_key(self, key: tuple) -> None:
        """Targeted eviction (corrupt entry): rotate the key to the LRU
        front and reuse the pop-and-prune path."""
        if key in self._lru:
            self._lru.move_to_end(key, last=False)
            self._evict_lru()

    def _evict_lru(self) -> None:
        key, entry = self._lru.popitem(last=False)
        self.nbytes -= entry.nbytes
        self.evictions += 1
        # detach the entry, then prune now-empty trie branches
        path = [self._root]
        node = self._root
        for t in key:
            node = node.children[t]
            path.append(node)
        node.entry = None
        for parent, child_tok, child in zip(
            reversed(path[:-1]), reversed(key), reversed(path[1:])
        ):
            if child.entry is None and not child.children:
                del parent.children[child_tok]
            else:
                break

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "entries": len(self._lru),
            "nbytes": self.nbytes,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "full_hits": self.full_hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "corruptions": self.corruptions,
        }
