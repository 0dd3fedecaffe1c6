"""Serving metrics: per-request latency plus aggregate throughput and
utilization.

Counterpart of the part of ``repro.serving.metrics.ServeMetrics`` the
engine calls. Per batched step (the engine's unit of device work): steps,
prefill/decode split (a prefill step has a token block wider than one
position), token-slot accounting (``slot_util`` = useful slots / B*S) and
lane occupancy. Per retired request: time to first token and latency.
All summaries are total: with zero steps or requests they return 0.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

__all__ = ["RequestRecord", "ServeMetrics", "RECORD_WINDOW"]

RECORD_WINDOW = 4096  # per-request records kept for percentiles


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    rid: int
    prompt_len: int
    new_tokens: int
    ttft: float  # submit -> first generated token (seconds)
    latency: float  # submit -> done (seconds)


def _pct(xs: np.ndarray, q: float) -> float:
    return float(np.percentile(xs, q)) if xs.size else 0.0


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
    retired: int = 0
    cancelled: int = 0
    numeric_errors: int = 0  # lanes retired on nonfinite logits
    records: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=RECORD_WINDOW)
    )
    t_start: Optional[float] = None
    t_stop: Optional[float] = None

    def start(self) -> None:
        self.t_start = time.monotonic()

    def stop(self) -> None:
        self.t_stop = time.monotonic()

    @property
    def elapsed(self) -> float:
        if self.t_start is None:
            return 0.0
        end = self.t_stop if self.t_stop is not None else time.monotonic()
        return max(end - self.t_start, 1e-9)

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
        self.records.append(RequestRecord(
            rid=req.rid, prompt_len=req.prompt_len, new_tokens=len(req.out),
            ttft=t1 - t0, latency=now - t0,
        ))

    def on_cancel(self, req, reason: str) -> None:
        """Counted apart from ``retired`` and kept out of the latency window."""
        del req, reason
        self.cancelled += 1

    def on_numeric_error(self, req) -> None:
        del req
        self.numeric_errors += 1

    @property
    def slot_util(self) -> float:
        return self.useful_slots / self.token_slots if self.token_slots else 0.0

    @property
    def lane_occupancy(self) -> float:
        return self.active_lane_slots / self.lane_slots if self.lane_slots else 0.0

    def report(self) -> dict:
        dt = self.elapsed
        ttfts = np.array([r.ttft for r in self.records])
        lats = np.array([r.latency for r in self.records])
        return {
            "requests": self.retired,
            "cancelled": self.cancelled,
            "numeric_errors": self.numeric_errors,
            "steps": self.steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "emitted_tokens": self.emitted,
            "prompt_tokens": self.prompt_tokens,
            "elapsed_s": dt,
            "gen_tok_per_s": self.emitted / dt if dt > 0 else 0.0,
            "total_tok_per_s": (self.emitted + self.prompt_tokens) / dt if dt > 0 else 0.0,
            "lane_occupancy": self.lane_occupancy,
            "slot_util": self.slot_util,
            "ttft_mean_s": float(ttfts.mean()) if ttfts.size else 0.0,
            "ttft_p95_s": _pct(ttfts, 95),
            "latency_mean_s": float(lats.mean()) if lats.size else 0.0,
            "latency_p95_s": _pct(lats, 95),
        }

    def format(self) -> str:
        r = self.report()
        return (
            f"served {r['requests']} requests, {r['emitted_tokens']} tokens "
            f"(+{r['prompt_tokens']} prompt) in {r['elapsed_s']:.1f}s | "
            f"{r['gen_tok_per_s']:.1f} gen tok/s, {r['total_tok_per_s']:.1f} total tok/s | "
            f"{r['steps']} steps ({r['prefill_steps']} prefill / {r['decode_steps']} decode) | "
            f"lane occupancy {r['lane_occupancy']:.0%}, slot util {r['slot_util']:.0%} | "
            f"ttft mean {r['ttft_mean_s']*1e3:.0f}ms p95 {r['ttft_p95_s']*1e3:.0f}ms"
        )
