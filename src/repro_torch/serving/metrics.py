"""Serving metrics: per-request latency plus aggregate throughput/utilization.

Counterpart of ``repro.serving.metrics`` (numpy only).

Tracked per batched step (the engine's unit of device work):
  * steps / prefill_steps / decode_steps — a prefill step is any step whose
    token block is wider than one position;
  * token-slot accounting — each step offers B*S token slots; ``useful``
    slots actually advanced a lane (prompt tokens consumed or tokens
    generated), the rest were padding or idle lanes. ``slot_util`` is the
    fraction of device work that was useful — the number chunked prefill
    exists to raise;
  * lane occupancy — fraction of lanes bound to a request per step.

Per retired request: time-to-first-token (submit -> first generated token)
and total latency (submit -> retire), tagged with the request's tenant so
the frontend can report per-tenant percentiles.

Prefix-cache accounting (populated when the engine is given a cache):
  * cache_lookups / cache_hits / cache_full_hits — admission-time trie
    lookups and their outcomes (a full hit skips prefill entirely);
  * prefill_tokens_saved — prompt tokens NOT consumed because a cached
    state was injected at the match point.

All summary properties are total functions: with zero steps and zero
retired requests they return 0.0 (or empty aggregates), never raise.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

__all__ = [
    "RequestRecord",
    "ServeMetrics",
    "LatencyHistogram",
    "tenant_summary",
    "phase_summary",
    "RECORD_WINDOW",
    "LATENCY_BUCKETS_MS",
]

# Per-request records feed percentile summaries only, so they are kept in
# a sliding window: a long-lived server retires requests forever, and an
# unbounded list would grow without limit while every report paid
# O(history) percentile math under the router pump lock. Totals
# ("requests" etc.) come from plain counters, not the
# window, so counter metrics stay monotonic after the window wraps.
RECORD_WINDOW = 4096

# Histogram bucket upper bounds (milliseconds) for TTFT and TPOT. Unlike the
# percentile summaries above these feed *cumulative* counters — they must
# never decrease, so they live outside the sliding record window (a
# scraper can take rates and quantiles of them).
LATENCY_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0, 2000.0, 5000.0)


@dataclasses.dataclass
class LatencyHistogram:
    """Monotonic latency histogram: per-bucket counts (last bucket is the
    +Inf overflow), running sum and count. ``report()`` is a plain dict so
    replica histograms can be summed elementwise by the router."""
    bounds: tuple = LATENCY_BUCKETS_MS
    counts: list = dataclasses.field(
        default_factory=lambda: [0] * (len(LATENCY_BUCKETS_MS) + 1)
    )
    sum_ms: float = 0.0
    count: int = 0

    def observe(self, ms: float) -> None:
        i = 0
        while i < len(self.bounds) and ms > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.sum_ms += ms
        self.count += 1

    def report(self) -> dict:
        return {
            "buckets_ms": list(self.bounds),
            "counts": list(self.counts),
            "sum_ms": self.sum_ms,
            "count": self.count,
        }

    @staticmethod
    def merge_reports(reports) -> dict:
        """Elementwise sum of ``report()`` dicts (replica aggregation).
        Empty input yields an all-zero histogram with the default bounds."""
        out = LatencyHistogram().report()
        for r in reports:
            if not r or r.get("buckets_ms") != out["buckets_ms"]:
                continue  # bounds mismatch: skip rather than mis-sum
            out["counts"] = [a + b for a, b in zip(out["counts"], r["counts"])]
            out["sum_ms"] += r["sum_ms"]
            out["count"] += r["count"]
        return out


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    rid: int
    prompt_len: int
    new_tokens: int
    ttft: float  # submit -> first generated token (seconds)
    latency: float  # submit -> done (seconds)
    tenant: str = "default"
    # phase decomposition (seconds): queue_s + prefill_s == ttft and
    # queue_s + prefill_s + decode_s == latency, up to clock-read clamping
    queue_s: float = 0.0  # submit -> lane admission
    prefill_s: float = 0.0  # admission -> first generated token
    decode_s: float = 0.0  # first token -> retire
    cache_saved_tokens: int = 0  # prompt tokens skipped via prefix cache


def _pct(xs: np.ndarray, q: float) -> float:
    return float(np.percentile(xs, q)) if xs.size else 0.0


def phase_summary(records) -> dict:
    """Per-phase latency aggregates over RequestRecords: for each of
    queue/prefill/decode, mean/p50/p95 seconds — the warm-tail attribution
    the tracer exists for, as scrapeable numbers. Empty-safe."""
    out = {}
    for phase in ("queue", "prefill", "decode"):
        xs = np.array([getattr(r, phase + "_s") for r in records])
        out[phase] = {
            "mean_s": float(xs.mean()) if xs.size else 0.0,
            "p50_s": _pct(xs, 50),
            "p95_s": _pct(xs, 95),
        }
    return out


def tenant_summary(records) -> dict:
    """Group RequestRecords by tenant -> {tenant: ttft/latency percentiles}.
    Well-defined (empty dict) when no requests have retired."""
    by_tenant: dict = {}
    for r in records:
        by_tenant.setdefault(r.tenant, []).append(r)
    out = {}
    for tenant, rs in sorted(by_tenant.items()):
        ttfts = np.array([r.ttft for r in rs])
        lats = np.array([r.latency for r in rs])
        out[tenant] = {
            "requests": len(rs),
            "new_tokens": sum(r.new_tokens for r in rs),
            "ttft_mean_s": float(ttfts.mean()),
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p95_s": _pct(ttfts, 95),
            "latency_mean_s": float(lats.mean()),
            "latency_p50_s": _pct(lats, 50),
            "latency_p95_s": _pct(lats, 95),
        }
    return out


@dataclasses.dataclass
class ServeMetrics:
    lanes: int
    steps: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    emitted: int = 0  # generated tokens
    prompt_tokens: int = 0  # prompt tokens consumed by prefill
    token_slots: int = 0  # sum over steps of B * S
    useful_slots: int = 0  # slots that advanced some lane
    lane_slots: int = 0  # sum over steps of B
    active_lane_slots: int = 0  # sum over steps of #active lanes
    cache_lookups: int = 0  # prefix-cache admission lookups
    cache_hits: int = 0  # ... that injected a cached state
    cache_full_hits: int = 0  # ... that skipped prefill entirely
    prefill_tokens_saved: int = 0  # prompt tokens not consumed due to hits
    retired: int = 0  # total retired requests (records is only a window)
    cancelled: int = 0  # requests cancelled before completing
    cancelled_by_reason: dict = dataclasses.field(default_factory=dict)
    numeric_errors: int = 0  # lanes retired on nonfinite logits
    preemptions: int = 0  # lanes snapshotted + requeued for shorter work
    resumes: int = 0  # preempted requests restored onto a lane
    records: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=RECORD_WINDOW)
    )
    # cumulative latency histograms (monotonic, unlike the record window)
    ttft_hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram
    )
    tpot_hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram
    )
    t_start: Optional[float] = None
    t_stop: Optional[float] = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self.t_start = time.monotonic()

    def stop(self) -> None:
        self.t_stop = time.monotonic()

    @property
    def elapsed(self) -> float:
        if self.t_start is None:
            return 0.0  # never started; rate summaries report 0, not junk
        end = self.t_stop if self.t_stop is not None else time.monotonic()
        return max(end - self.t_start, 1e-9)

    # -- per-step / per-request hooks -----------------------------------
    def on_step(self, width: int, active: int, useful: int, any_prefill: bool) -> None:
        self.steps += 1
        if any_prefill:
            self.prefill_steps += 1
        else:
            self.decode_steps += 1
        self.token_slots += self.lanes * width
        self.useful_slots += useful
        self.lane_slots += self.lanes
        self.active_lane_slots += active

    def on_retire(self, req, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.retired += 1
        t0 = req.t_submit if req.t_submit is not None else now
        t1 = req.t_first if req.t_first is not None else now
        t_admit = getattr(req, "t_admit", None)
        if t_admit is None:
            t_admit = t0  # admission never stamped: attribute all to prefill
        self.records.append(
            RequestRecord(
                rid=req.rid,
                prompt_len=req.prompt_len,
                new_tokens=len(req.out),
                ttft=t1 - t0,
                latency=now - t0,
                tenant=getattr(req, "tenant", "default"),
                queue_s=max(t_admit - t0, 0.0),
                prefill_s=max(t1 - t_admit, 0.0),
                decode_s=max(now - t1, 0.0),
                cache_saved_tokens=getattr(req, "cache_saved_tokens", 0),
            )
        )
        ttft = t1 - t0
        self.ttft_hist.observe(max(ttft, 0.0) * 1e3)
        new_tokens = len(req.out)
        if new_tokens >= 2:
            # time-per-output-token over the decode stretch: (latency -
            # ttft) spans the new_tokens - 1 inter-token gaps
            self.tpot_hist.observe(
                max(now - t1, 0.0) * 1e3 / (new_tokens - 1)
            )

    def on_cancel(self, req, reason: str) -> None:
        """A request left the engine without completing (client cancel,
        abandoned stream, mid-flight deadline). Counted separately from
        ``retired`` and kept OUT of the latency record window: a cancelled
        request has no honest TTFT/latency sample, and an abandoned one
        would otherwise poison the percentiles with its wall-clock age."""
        del req  # counters only; per-request data stays with the caller
        self.cancelled += 1
        self.cancelled_by_reason[reason] = (
            self.cancelled_by_reason.get(reason, 0) + 1
        )

    def on_numeric_error(self, req) -> None:
        """A lane hit nonfinite logits and was retired defensively. Like
        cancels, these carry no honest latency sample, so they are kept
        out of the percentile window — which also pins the empty-window
        safety property: a window where *every* request errored must
        still produce all-zero summaries, never a ZeroDivisionError."""
        del req
        self.numeric_errors += 1

    def on_cache_lookup(self, hit: bool, full: bool, saved: int) -> None:
        self.cache_lookups += 1
        if hit:
            self.cache_hits += 1
            self.prefill_tokens_saved += saved
        if full:
            self.cache_full_hits += 1

    # -- aggregation (all total: safe at steps == 0 / no requests) -------
    @property
    def slot_util(self) -> float:
        return self.useful_slots / self.token_slots if self.token_slots else 0.0

    @property
    def lane_occupancy(self) -> float:
        return self.active_lane_slots / self.lane_slots if self.lane_slots else 0.0

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.cache_lookups if self.cache_lookups else 0.0

    def per_tenant(self) -> dict:
        return tenant_summary(self.records)

    def report(self) -> dict:
        dt = self.elapsed
        ttfts = np.array([r.ttft for r in self.records])
        lats = np.array([r.latency for r in self.records])
        return {
            "requests": self.retired,
            "cancelled": self.cancelled,
            "cancelled_by_reason": dict(self.cancelled_by_reason),
            "numeric_errors": self.numeric_errors,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "steps": self.steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "emitted_tokens": self.emitted,
            "prompt_tokens": self.prompt_tokens,
            "elapsed_s": dt,
            "gen_tok_per_s": self.emitted / dt if dt > 0 else 0.0,
            "total_tok_per_s": (
                (self.emitted + self.prompt_tokens) / dt if dt > 0 else 0.0
            ),
            "lane_occupancy": self.lane_occupancy,
            "slot_util": self.slot_util,
            "cache_lookups": self.cache_lookups,
            "cache_hits": self.cache_hits,
            "cache_full_hits": self.cache_full_hits,
            "cache_hit_rate": self.cache_hit_rate,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "ttft_mean_s": float(ttfts.mean()) if ttfts.size else 0.0,
            "ttft_p95_s": _pct(ttfts, 95),
            "latency_mean_s": float(lats.mean()) if lats.size else 0.0,
            "latency_p95_s": _pct(lats, 95),
            "phases": phase_summary(self.records),
            "ttft_hist_ms": self.ttft_hist.report(),
            "tpot_hist_ms": self.tpot_hist.report(),
        }

    def format(self) -> str:
        r = self.report()
        line = (
            f"served {r['requests']} requests, {r['emitted_tokens']} tokens "
            f"(+{r['prompt_tokens']} prompt) in {r['elapsed_s']:.1f}s | "
            f"{r['gen_tok_per_s']:.1f} gen tok/s, {r['total_tok_per_s']:.1f} total tok/s | "
            f"{r['steps']} steps ({r['prefill_steps']} prefill / {r['decode_steps']} decode) | "
            f"lane occupancy {r['lane_occupancy']:.0%}, slot util {r['slot_util']:.0%} | "
            f"ttft mean {r['ttft_mean_s']*1e3:.0f}ms p95 {r['ttft_p95_s']*1e3:.0f}ms"
        )
        if r["cache_lookups"]:
            line += (
                f" | prefix cache {r['cache_hit_rate']:.0%} hit "
                f"({r['cache_full_hits']} full), "
                f"{r['prefill_tokens_saved']} prefill tok saved"
            )
        return line
