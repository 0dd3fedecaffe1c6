"""ServeEngine: continuous-batching inference over packed FloatSD8 or
FloatSD4 weights.

Counterpart of ``repro.serving.engine.ServeEngine`` without the frontend
features (prefix cache, preemption, fault injection, tracer). Lifecycle per
request: queue -> admission to a free lane -> chunked prefill -> decode ->
retire. All B lanes advance in one batched step per iteration:

  * each active lane contributes a length k: a prefilling lane consumes
    ``min(remaining_prompt, chunk)`` tokens, a decoding lane exactly 1;
  * the token block is [B, S] with S in {1, chunk}; positions >= k are
    padding and the lengths-masked LSTM loop freezes that lane's state;
  * re-armed or cancelled lanes are zeroed by a masked reset at the top of
    the same step;
  * the step consuming a lane's last prompt token is also its first
    generation step; decoding is greedy (argmax of the last valid logit),
    and each token's top-2 logit gap is kept in ``Request.margins`` (how
    decisive the choice was);
  * a lane whose logits are not all finite is retired as ``numeric_error``
    instead of sampling from NaN.

The weights are packed at construction, to 1-byte FloatSD8 codes or (with
``weight_format="floatsd4"``) to nibble-packed FloatSD4 codes and group
exponents. On the card every gate matmul, the tied head and the cell run
the hand-written kernels;
``backend="ref"`` runs the plain versions instead (the cross-check).

A model whose ``decode_step`` takes no ``lengths`` (the zoo's
``CausalLM``) advances its lanes in lockstep, one token a step (``chunk``
is forced to 1), and its layer-major cache cannot be reset per lane, so
such an engine serves at most ``lanes`` requests: ``run`` refuses a larger
queue, and re-arming a used lane raises, as in the reference. An attention
model's KV cache holds ``cache_len`` positions (at most its window).
"""
from __future__ import annotations

import inspect
import time
from typing import Iterable

import numpy as np
import torch

from .._tree import tree_leaves
from ..kernels import dispatch as kd
from .metrics import ServeMetrics
from .scheduler import Request, Scheduler
from .state_pool import StatePool, masked_reset
from .weight_store import WEIGHT_FORMATS, WeightStore

__all__ = ["ServeEngine", "Lane"]


class Lane:
    """Host-side bookkeeping for one decode lane."""

    __slots__ = ("req", "pos", "next_token")

    def __init__(self, req: Request):
        self.req = req
        self.pos = 0  # prompt tokens consumed so far
        self.next_token = 0  # token to feed when decoding

    @property
    def prefilling(self) -> bool:
        return self.pos < self.req.prompt_len


class ServeEngine:
    """One instance owns ``lanes`` decode lanes, their state pool and the
    packed weights. Not thread-safe: callers serialize ``submit``,
    ``step_once``, ``run`` and ``cancel``."""

    def __init__(self, model, params, policy, lanes: int = 8, chunk: int = 8,
                 admission: str = "fifo", backend: str | None = None,
                 weight_format: str = "floatsd8", cache_len: int | None = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if weight_format not in WEIGHT_FORMATS:
            raise ValueError(
                f"weight_format must be one of {WEIGHT_FORMATS}, got {weight_format!r}"
            )
        if policy.weight_quant != "floatsd8":
            raise ValueError(
                f"the engine serves packed FloatSD8 weights, but policy {policy.name!r} "
                f"has weight_quant={policy.weight_quant!r}"
            )
        if backend not in (None, "ref"):
            raise ValueError(f"backend must be None or 'ref', got {backend!r}")
        self.model = model
        self.policy = policy
        self.lanes_n = lanes
        # a model without lengths support advances every lane one token a step
        self._supports_lengths = "lengths" in inspect.signature(model.decode_step).parameters
        self.chunk = chunk if self._supports_lengths else 1
        self.backend = backend
        self.scheduler = Scheduler(admission)
        self.metrics = ServeMetrics(lanes)
        # decode(encode(w)) == quantize(w), so serving FloatSD8 codes with the
        # weight quantizer dropped computes the trained function; FloatSD4
        # re-quantizes those values (a footprint for accuracy trade)
        self.store = WeightStore.pack(params, fmt=weight_format)
        self.serve_params = self.store.tree
        if hasattr(model, "hoist"):  # decode a stacked model's small leaves once, not every step
            self.serve_params = model.hoist(self.serve_params)
        self.serve_policy = policy.replace(weight_quant="none")
        self.device = next(
            x.codes.device for x in tree_leaves(self.serve_params, is_leaf=kd.is_any_packed)
            if kd.is_any_packed(x)
        )
        self.pool = StatePool.for_model(model, lanes, policy, self.device, cache_len)
        # Re-arming a used lane needs a per-lane reset of every cache leaf:
        # lane-major leaves, and lengths support (a layer-major stack whose
        # layer count equals ``lanes`` would pass the shape test alone).
        self._rearmable = self._supports_lengths and all(
            c.dim() >= 1 and c.shape[0] == lanes for c in tree_leaves(self.pool.caches))
        self._lane_used = [False] * lanes
        self._lanes: list[Lane | None] = [None] * lanes
        self._reset = np.zeros((lanes,), np.int32)
        self._rid = 0

    # -- request intake --------------------------------------------------
    def submit(self, prompt, max_new: int = 32) -> Request:
        req = Request(rid=self._rid, prompt=np.asarray(prompt), max_new=max_new)
        self._rid += 1
        return self.scheduler.submit(req)

    def submit_all(self, prompts: Iterable, max_new: int = 32) -> list[Request]:
        return [self.submit(p, max_new) for p in prompts]

    # -- lane lifecycle --------------------------------------------------
    def _arm_free_lanes(self) -> None:
        for i in range(self.lanes_n):
            if self._lanes[i] is None and self.scheduler:
                if self._lane_used[i] and not self._rearmable:
                    raise RuntimeError(
                        "cannot re-arm a used lane: this model's cache has non-lane-major leaves "
                        "that masked_reset cannot clear per lane; serve at most `lanes` requests "
                        "per engine (or use an LSTM-family model)")
                self._lane_used[i] = True
                req = self.scheduler.pop()
                req.t_admit = time.monotonic()
                self._lanes[i] = Lane(req)
                self._reset[i] = 1  # zeroed at the top of the next step

    def _retire(self, i: int, status: str = "done", reason: str | None = None) -> None:
        req = self._lanes[i].req
        now = time.monotonic()
        req.t_done = now
        req.status = status
        if status == "done":
            self.metrics.on_retire(req, now)
        else:
            req.cancel_reason = reason
            if status == "numeric_error":
                self.metrics.on_numeric_error(req)
            else:
                self.metrics.on_cancel(req, reason or "cancelled")
            self._reset[i] = 1  # the next step wipes the dead state
        self._lanes[i] = None

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Remove a request wherever it lives: from the queue, or from its
        lane (the release rides the next step's reset mask). Returns False
        for unknown or finished rids."""
        req = self.scheduler.remove(rid)
        if req is not None:
            req.status, req.cancel_reason = "cancelled", reason
            req.t_done = time.monotonic()
            self.metrics.on_cancel(req, reason)
            return True
        for i, lane in enumerate(self._lanes):
            if lane is not None and lane.req.rid == rid:
                self._retire(i, status="cancelled", reason=reason)
                return True
        return False

    # -- the batched step ------------------------------------------------
    @torch.no_grad()
    def _step(self, tokens: np.ndarray, lengths: np.ndarray, reset: np.ndarray):
        dev = self.device
        toks = torch.as_tensor(tokens, device=dev)
        lens = torch.as_tensor(lengths, device=dev)
        caches = masked_reset(self.pool.caches, torch.as_tensor(reset, device=dev))
        with kd.use_backend(self.backend):
            if self._supports_lengths:
                logits, caches = self.model.decode_step(
                    self.serve_params, toks, caches, self.serve_policy, lengths=lens
                )
                idx = torch.clamp(lens.long() - 1, 0, toks.shape[1] - 1)
                last = logits[torch.arange(toks.shape[0], device=dev), idx]
            else:
                logits, caches = self.model.decode_step(
                    self.serve_params, toks, caches, self.serve_policy
                )
                last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1)
        top2 = torch.topk(last, 2, dim=-1).values
        ok = torch.isfinite(last).all(dim=-1)
        return (nxt.cpu().numpy(), (top2[:, 0] - top2[:, 1]).cpu().numpy(),
                ok.cpu().numpy(), caches)

    def step_once(self) -> bool:
        """Advance every active lane one scheduling quantum. Returns False
        when there is nothing left to do."""
        self._arm_free_lanes()
        active = [i for i, l in enumerate(self._lanes) if l is not None]
        if not active:
            return False
        B, chunk = self.lanes_n, self.chunk
        ks = np.zeros((B,), np.int32)
        for i in active:
            lane = self._lanes[i]
            ks[i] = min(lane.req.prompt_len - lane.pos, chunk) if lane.prefilling else 1
        any_prefill = bool((ks > 1).any())
        S = chunk if any_prefill else 1
        tokens = np.zeros((B, S), np.int32)
        for i in active:
            lane = self._lanes[i]
            if lane.prefilling:
                tokens[i, : ks[i]] = lane.req.prompt[lane.pos : lane.pos + ks[i]]
            else:
                tokens[i, 0] = lane.next_token
        reset, self._reset = self._reset, np.zeros((B,), np.int32)
        nxt, margin, ok, caches = self._step(tokens, ks, reset)
        self.pool.swap(caches)
        self.metrics.on_step(width=S, active=len(active), useful=int(ks.sum()),
                             any_prefill=any_prefill)
        now = time.monotonic()
        for i in active:
            lane = self._lanes[i]
            if not ok[i]:
                self._retire(i, status="numeric_error", reason="nonfinite_logits")
                continue
            if lane.prefilling:
                lane.pos += int(ks[i])
                self.metrics.prompt_tokens += int(ks[i])
                if not lane.prefilling:  # last prompt chunk: first generated token
                    self._emit(lane, int(nxt[i]), float(margin[i]), now, first=True)
            else:
                self._emit(lane, int(nxt[i]), float(margin[i]), now)
            if lane.req.done:
                self._retire(i)
        return True

    def _emit(self, lane: Lane, tok: int, margin: float, now: float,
              first: bool = False) -> None:
        if first and lane.req.t_first is None:
            lane.req.t_first = now
        lane.req.out.append(tok)
        lane.req.margins.append(margin)
        lane.next_token = tok
        self.metrics.emitted += 1

    def run(self) -> ServeMetrics:
        """Serve until the queue and every lane are drained."""
        outstanding = len(self.scheduler) + sum(l is not None for l in self._lanes)
        if not self._rearmable and outstanding > self.lanes_n:
            raise ValueError(
                f"{outstanding} requests queued but this model's cache cannot be reset per lane "
                f"(non-lane-major leaves); submit at most lanes={self.lanes_n} requests per "
                f"engine, or use an LSTM-family model for continuous batching")
        self.metrics.start()
        while self.step_once():
            pass
        self.metrics.stop()
        return self.metrics
