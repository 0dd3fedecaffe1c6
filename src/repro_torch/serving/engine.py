"""ServeEngine: continuous-batching inference over packed FloatSD8 or
FloatSD4 weights.

Counterpart of ``repro.serving.engine.ServeEngine``. Lifecycle per request:
queue -> admission to a free lane -> chunked prefill -> decode -> retire.
All B lanes advance in one batched step per iteration:

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
    instead of sampling from NaN, and its state never reaches the prefix
    cache.

The weights are packed at construction, to 1-byte FloatSD8 codes or (with
``weight_format="floatsd4"``) to nibble-packed FloatSD4 codes and group
exponents (a zoo model's stacked leaves along the layer axis, as the
reference packs them; each layer's weight sites then read their code and
exponent planes in place, where the reference's engine decodes the whole
tree every step). On the card every gate matmul, the tied head and the cell run
the hand-written kernels; ``backend="ref"`` runs the plain versions
instead (the cross-check). ``packed=False`` serves the dense weights
through the model's fake-quant-at-use path, as the reference does (f32
einsums for the products, the cell on its kernel), and takes any policy.

The frontend's features, as the reference's:

  * a prefix cache (``serving/frontend/prefix_cache.py``, shared by every
    replica behind a router): admission looks the prompt up; a hit injects
    the cached FP8 state into the lane (``StatePool.inject``, in place of
    the masked reset) and prefill starts at the match point; a full hit
    replays the stored ``next_token``, so the first token costs no device
    step. Prefill inserts block-boundary snapshots, the end of prefill the
    whole prompt with its first token, and retire the final state keyed by
    prompt + generated[:-1];
  * preemption (``preempt=True``): when every lane is busy and the queue
    head owes much less work than some decoding lane, that lane's state is
    snapshotted to host FP8, its request requeued, and the snapshot
    restored when it is admitted again;
  * ``admit_pace``: at most that many admissions a step;
  * fault injection (``faults.FAULTS``): a replica crash (sticky), slow or
    failing steps, and host-side poisoned logits; ``evacuate`` hands every
    live request back to the router;
  * the request-lifecycle tracer (``obs.trace.TRACER``): ``engine.*`` and
    ``cache.*`` spans and instants.

A model whose ``decode_step`` takes no ``lengths`` (the zoo's
``CausalLM``: the ssm, dense, moe and hybrid families) advances its lanes
in lockstep, one token a step (``chunk`` is forced to 1), and its
group-major cache cannot be reset per lane, so
such an engine serves at most ``lanes`` requests (``run`` refuses a larger
queue, re-arming a used lane raises) and takes no prefix cache and no
preemption, as in the reference. An attention model's KV cache holds
``cache_len`` positions (at most its window).
"""
from __future__ import annotations

import contextlib
import inspect
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .._tree import tree_leaves
from ..faults import (
    ENGINE_STEP_RAISE, ENGINE_STEP_SLOW, FAULTS, NONFINITE_LOGITS, REPLICA_CRASH, InjectedFault,
    ReplicaCrash,
)
from ..kernels import dispatch as kd
from ..obs.trace import TRACER
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
    (packed) weights.

    Not thread-safe: callers serialize ``submit``/``enqueue``/``step_once``/
    ``run``/``cancel`` (the Router calls them from its pump; AsyncRouter
    runs pumps one at a time under its lock, in a worker thread). Every
    tensor of a step is made on ``self.device``, and the step runs under
    ``torch.cuda.device(self.device)``, so the thread that calls it does
    not matter. ``free_lanes``/``load``/``has_work`` read host state only.
    """

    def __init__(self, model, params, policy, lanes: int = 8, chunk: int = 8,
                 admission: str = "fifo", backend: str | None = None,
                 weight_format: str = "floatsd8", cache_len: int | None = None,
                 packed: bool = True, prefix_cache=None, preempt: bool = False,
                 preempt_margin: int = 8, preempt_max: int = 2,
                 admit_pace: int | None = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if admit_pace is not None and admit_pace < 1:
            raise ValueError("admit_pace must be >= 1 (or None to disable)")
        if weight_format not in WEIGHT_FORMATS:
            raise ValueError(
                f"weight_format must be one of {WEIGHT_FORMATS}, got {weight_format!r}"
            )
        if packed and policy.weight_quant != "floatsd8":
            raise ValueError(
                f"packed=True serves FloatSD8-quantized weights, but policy {policy.name!r} "
                f"has weight_quant={policy.weight_quant!r}; pass packed=False (CLI: --dense) "
                f"for unquantized policies"
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
        self.weight_format = weight_format
        if packed:
            # decode(encode(w)) == quantize(w), so serving FloatSD8 codes with
            # the weight quantizer dropped computes the trained function;
            # FloatSD4 re-quantizes those values (a footprint for accuracy trade)
            self.store: Optional[WeightStore] = WeightStore.pack(params, fmt=weight_format)
            self.serve_params = self.store.tree
            if hasattr(model, "hoist"):  # decode a stacked model's small leaves once, not every step
                self.serve_params = model.hoist(self.serve_params)
            self.serve_policy = policy.replace(weight_quant="none")
            self.device = next(
                x.codes.device for x in tree_leaves(self.serve_params, is_leaf=kd.is_any_packed)
                if kd.is_any_packed(x)
            )
        else:
            self.store = None
            self.serve_params = params
            self.serve_policy = policy
            self.device = next(x.device for x in tree_leaves(params) if isinstance(x, torch.Tensor))
        self.pool = StatePool.for_model(model, lanes, policy, self.device, cache_len)
        # Re-arming a used lane needs a per-lane reset of every cache leaf:
        # lane-major leaves, and lengths support (a layer-major stack whose
        # layer count equals ``lanes`` would pass the shape test alone).
        self._rearmable = self._supports_lengths and all(
            c.dim() >= 1 and c.shape[0] == lanes for c in tree_leaves(self.pool.caches))
        # Injection (a cache hit, a resumed preemption) overwrites a lane's
        # whole state slice, which needs the same lane-major pool.
        if prefix_cache is not None and not self._rearmable:
            raise ValueError(
                "prefix caching requires a per-lane resettable (lane-major) state pool — an "
                "LSTM-family model with lengths support")
        if preempt and not self._rearmable:
            raise ValueError(
                "preempt=True requires a per-lane resettable (lane-major) state pool — an "
                "LSTM-family model with lengths support")
        self.prefix_cache = prefix_cache
        self.preempt = preempt
        self.preempt_margin = preempt_margin
        self.preempt_max = preempt_max
        self.admit_pace = admit_pace
        # rid -> (fp8 snapshot, dtypes, next_token, pos) of requests preempted
        # off a lane and waiting in the scheduler to resume
        self._preempted: dict[int, tuple] = {}
        self._lane_used = [False] * lanes
        self._lanes: list[Lane | None] = [None] * lanes
        self._reset = np.zeros((lanes,), np.int32)
        self._rid = 0
        # the router stamps ``replica`` (fault rules and traces key on it);
        # ``_crashed`` is the sticky replica_crash state
        self.replica: int | None = None
        self._crashed = False

    # -- request intake --------------------------------------------------
    def submit(self, prompt, max_new: int = 32, tenant: str = "default",
               deadline: float | None = None) -> Request:
        req = Request(rid=self._rid, prompt=np.asarray(prompt), max_new=max_new, tenant=tenant,
                      deadline=deadline)
        self._rid += 1
        return self.enqueue(req)

    def enqueue(self, req: Request) -> Request:
        """Queue a Request built elsewhere (the router's path: the frontend
        owns rids, tenants and deadlines)."""
        return self.scheduler.submit(req)

    def submit_all(self, prompts: Iterable, max_new: int = 32) -> list[Request]:
        return [self.submit(p, max_new) for p in prompts]

    # -- router-facing load introspection --------------------------------
    @property
    def free_lanes(self) -> int:
        return sum(l is None for l in self._lanes)

    @property
    def active_lanes(self) -> int:
        return self.lanes_n - self.free_lanes

    def has_work(self) -> bool:
        return self.active_lanes > 0 or bool(self.scheduler)

    @property
    def load(self) -> float:
        """Active lanes + backlog, per lane: the router's least-loaded key."""
        return (self.active_lanes + len(self.scheduler)) / self.lanes_n

    # -- lane lifecycle --------------------------------------------------
    def _arm_free_lanes(self) -> None:
        armed = 0
        for i in range(self.lanes_n):
            # `while`: a full cache hit with max_new == 1 retires at admission
            # without a device step, so one lane can drain several requests
            while self._lanes[i] is None and self.scheduler:
                if self.admit_pace is not None and armed >= self.admit_pace:
                    return
                if self._lane_used[i] and not self._rearmable:
                    raise RuntimeError(
                        "cannot re-arm a used lane: this model's cache has non-lane-major leaves "
                        "that masked_reset cannot clear per lane; serve at most `lanes` requests "
                        "per engine (or use an LSTM-family model)")
                req = self.scheduler.pop()
                armed += 1
                now = time.monotonic()  # per admission: a slow lookup bills its own lane
                if req.t_admit is None:
                    req.t_admit = now
                lane = Lane(req)
                self._lanes[i] = lane
                self._lane_used[i] = True
                stash = self._preempted.pop(req.rid, None)
                if stash is not None:
                    # a preempted decode resumes from its FP8 snapshot, keeping
                    # its t_admit and t_first
                    snap, dtypes, next_token, pos = stash
                    self.pool.inject_fp8(i, snap, dtypes)
                    self._reset[i] = 0
                    lane.pos = pos
                    lane.next_token = next_token
                    self.metrics.resumes += 1
                    if TRACER.enabled:
                        TRACER.instant("engine.resume", cat="engine", rid=req.rid, lane=i,
                                       decoded=len(req.out))
                    break
                hit = None
                if self.prefix_cache is not None:
                    with TRACER.span("cache.lookup", cat="cache", rid=req.rid):
                        hit = self.prefix_cache.lookup(req.prompt)
                    self.metrics.on_cache_lookup(
                        hit=hit is not None, full=hit is not None and hit.full,
                        saved=hit.match_len if hit is not None else 0)
                    if hit is not None:
                        req.cache_hit = True
                        req.cache_saved_tokens = hit.match_len
                        # whole prefill steps the injection replaced; a
                        # residual partial chunk merges into the suffix step
                        req.cache_saved_steps = hit.match_len // self.chunk
                if TRACER.enabled:
                    TRACER.instant(
                        "engine.admit", cat="engine", rid=req.rid, lane=i,
                        prompt_len=req.prompt_len,
                        cache=("full" if hit is not None and hit.full
                               else "hit" if hit is not None else "miss"),
                        saved_tokens=req.cache_saved_tokens)
                if hit is None:
                    self._reset[i] = 1  # zeroed at the top of the next step
                    break
                # the snapshot overwrites the lane's whole state in place; a
                # masked reset afterwards would zero it, so none is asked for
                self.pool.inject(i, hit.states)
                self._reset[i] = 0
                lane.pos = hit.match_len
                if hit.full:
                    # the stored greedy continuation is the first token:
                    # prefill is skipped and TTFT costs no device step
                    self._emit(lane, hit.next_token, float("inf"), now, first=True)
                    if req.done:
                        self._retire(i)
                        continue
                break

    def _retire(self, i: int, status: str = "done", reason: str | None = None) -> None:
        """Unbind lane ``i``: ``done``, ``cancelled`` or ``numeric_error``."""
        lane = self._lanes[i]
        req = lane.req
        now = time.monotonic()
        req.t_done = now
        req.status = status
        if status != "done":
            req.cancel_reason = reason
        if (self.prefix_cache is not None and status != "numeric_error"  # never cache a poisoned state
                and len(req.out) >= 2 and not lane.prefilling):
            # the lane's state summarizes prompt + out[:-1] (the last token was
            # emitted, never fed back); out[-1] is its greedy continuation
            key = np.concatenate([req.prompt, np.asarray(req.out[:-1], np.int32)])
            if self.prefix_cache.wants(key, len(key)):
                with TRACER.span("cache.insert", cat="cache", rid=req.rid):
                    self.prefix_cache.insert(key, self.pool.extract(i), next_token=req.out[-1])
        if status == "done":
            self.metrics.on_retire(req, now)
        else:
            if status == "numeric_error":
                self.metrics.on_numeric_error(req)
            else:
                self.metrics.on_cancel(req, reason or "cancelled")
            self._reset[i] = 1  # the next step wipes the dead state
        if TRACER.enabled:
            if status == "done":
                TRACER.instant("engine.retire", cat="engine", rid=req.rid, lane=i,
                               new_tokens=len(req.out))
            elif status == "numeric_error":
                TRACER.instant("engine.numeric_error", cat="engine", rid=req.rid, lane=i,
                               new_tokens=len(req.out), reason=reason or "nonfinite_logits")
            else:
                TRACER.instant("engine.cancel", cat="engine", rid=req.rid, lane=i,
                               new_tokens=len(req.out), reason=reason or "cancelled")
        self._lanes[i] = None

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Remove a request wherever it lives: from the queue, or from its
        lane (the release rides the next step's reset mask). Returns False
        for unknown or finished rids."""
        req = self.scheduler.remove(rid)
        if req is not None:
            self._preempted.pop(rid, None)
            req.status, req.cancel_reason = "cancelled", reason
            req.t_done = time.monotonic()
            self.metrics.on_cancel(req, reason)
            if TRACER.enabled:
                TRACER.instant("engine.cancel", cat="engine", rid=rid, new_tokens=len(req.out),
                               reason=reason)
            return True
        for i, lane in enumerate(self._lanes):
            if lane is not None and lane.req.rid == rid:
                self._retire(i, status="cancelled", reason=reason)
                return True
        return False

    # -- preemption ------------------------------------------------------
    def _maybe_preempt(self) -> None:
        """If every lane is busy and the queue head owes far less work than
        some decoding lane, snapshot that lane to host FP8 and hand it over.
        Only lanes that have emitted a token are candidates (their TTFT is
        banked), each request at most ``preempt_max`` times."""
        if not self.preempt or self.free_lanes > 0 or not self.scheduler:
            return
        cand = self.scheduler.peek()
        if cand is None:
            return
        if cand.work_hint is None and self.prefix_cache is not None:
            # the router stamps work_hint at submission; a direct submission
            # gets the same side-effect-free probe here
            cand.work_hint = self.prefix_cache.match_len(cand.prompt)
        cand_work = cand.remaining_work()
        victim, victim_rem = None, -1
        for i, lane in enumerate(self._lanes):
            if lane is None or lane.prefilling or not lane.req.out:
                continue
            if lane.req.preempt_count >= self.preempt_max:
                continue
            rem = lane.req.max_new - len(lane.req.out)
            if rem > victim_rem:
                victim, victim_rem = i, rem
        if victim is None or victim_rem < cand_work + self.preempt_margin:
            return
        self._preempt_lane(victim)

    def _preempt_lane(self, i: int) -> None:
        lane = self._lanes[i]
        req = lane.req
        snap, dtypes = self.pool.snapshot_fp8(i)
        self._preempted[req.rid] = (snap, dtypes, lane.next_token, lane.pos)
        req.preempt_count += 1
        self.metrics.preemptions += 1
        if TRACER.enabled:
            TRACER.instant("engine.preempt", cat="engine", rid=req.rid, lane=i,
                           decoded=len(req.out), remaining=req.max_new - len(req.out))
        self._lanes[i] = None
        self._reset[i] = 1  # the next step wipes the freed state
        self.scheduler.submit(req)  # t_submit kept; resumes from the stash

    # -- replica failure -------------------------------------------------
    def _check_faults(self) -> None:
        """The injection points at the top of ``step_once``, which the
        router's health layer watches (reached only with a plan armed)."""
        if FAULTS.fire(REPLICA_CRASH, key=self.replica) is not None:
            self._crashed = True  # sticky: dead until the process restarts
        if self._crashed:
            raise ReplicaCrash(f"replica {self.replica} crashed")
        f = FAULTS.fire(ENGINE_STEP_SLOW, key=self.replica)
        if f is not None:
            time.sleep(float(f.get("ms", 50)) / 1000.0)
        if FAULTS.fire(ENGINE_STEP_RAISE, key=self.replica) is not None:
            raise InjectedFault(f"injected step error on replica {self.replica}")

    def evacuate(self) -> list[Request]:
        """Strip every live request off this replica (the router's ejection
        path). Requests are rewound to their pre-admission state (greedy
        decoding regenerates the same stream elsewhere; the ticket's
        ``sent`` cursor deduplicates delivery) and keep ``t_submit`` and
        ``t_first``."""
        out: list[Request] = []
        while self.scheduler:
            out.append(self.scheduler.pop())
        for i, lane in enumerate(self._lanes):
            if lane is not None:
                out.append(lane.req)
                self._lanes[i] = None
        self._preempted.clear()
        for req in out:
            req.out.clear()
            req.margins.clear()
            req.status = "active"
            req.preempt_count = 0
        return out

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

    def _on_device(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def step_once(self) -> bool:
        """Advance every active lane one scheduling quantum. Returns False
        when there is nothing left to do. Raises ``ReplicaCrash`` /
        ``InjectedFault`` under an armed fault plan (the router's health
        layer catches them)."""
        if self._crashed:
            raise ReplicaCrash(f"replica {self.replica} crashed")
        if FAULTS.enabled:
            self._check_faults()
        with self._on_device():
            self._maybe_preempt()
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
            # one span a batched step (the engine's unit of device work), with
            # the lane -> rid map; its args are built only while tracing
            step_span = (
                TRACER.span(
                    "engine.step", cat="engine", kind="prefill" if any_prefill else "decode",
                    width=S, useful=int(ks.sum()),
                    lanes={str(i): {"rid": self._lanes[i].req.rid, "k": int(ks[i])} for i in active})
                if TRACER.enabled else TRACER.span("engine.step")
            )
            with step_span:
                nxt, margin, ok, caches = self._step(tokens, ks, reset)
            self.pool.swap(caches)
            if FAULTS.enabled and FAULTS.fire(NONFINITE_LOGITS, key=self.replica):
                # poison one active lane's health flag on the host: the
                # recovery below is the one a real NaN takes
                ok = ok.copy()
                ok[active[0]] = False
            self.metrics.on_step(width=S, active=len(active), useful=int(ks.sum()),
                                 any_prefill=any_prefill)
            now = time.monotonic()
            cache = self.prefix_cache
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
                        if cache is not None and cache.wants(lane.req.prompt, lane.req.prompt_len):
                            # the state after the whole prompt and its greedy
                            # continuation: an identical prompt skips prefill
                            cache.insert(lane.req.prompt, self.pool.extract(i),
                                         next_token=int(nxt[i]))
                    elif cache is not None and cache.wants_snapshot(lane.req.prompt, lane.pos):
                        # a block-boundary snapshot mid-prefill: what makes
                        # shared-prefix (not only identical) prompts hit
                        cache.insert(lane.req.prompt[: lane.pos], self.pool.extract(i))
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
