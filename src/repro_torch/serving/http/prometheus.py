"""Prometheus text exposition (version 0.0.4) for the serving stack.

Counterpart of ``repro.serving.http.prometheus`` (stdlib only; the port
keeps its own copy), the same text on the same inputs except three lines:
the cost ledger's shared-memory gauge ``repro_cost_smem_bytes`` (the
reference's ``repro_cost_vmem_bytes``), and the HELP lines of the
predicted-read counter and of ``repro_dispatch_decisions_total``, which
name the port's backends (``ref``, ``cuda``).

Renders one scrape from host-side dicts; no device work happens on the
scrape path:

* ``Router.report()``: aggregate engine counters (requests, steps,
  tokens, cache hit/saved) and per-tenant TTFT/latency percentiles;
* ``Router.stats()``: instantaneous gauges (free lanes, queue depth,
  in-flight) plus rejection counters by reason;
* ``PrefixCache.stats()``: entry/byte occupancy and hit/eviction
  counters for the shared FP8 LSTM-state prefix cache;
* ``kernels.dispatch.STATS.snapshot()``: per-(op, backend) kernel
  dispatch calls, so a call on the plain version where the kernel was
  expected shows up in the scrape;
* ``kernels.dispatch.LEDGER.rows()``: the cost model's predicted FLOPs,
  MACs and bytes per (op, backend), beside the bytes really handed over;
* ``obs.trace.TRACER.stats()``: tracer health (enabled, event/drop
  totals) and per-span-name counts and cumulative durations.

Percentiles are exported summary-style (``quantile`` label) because they
are computed router-side over retired-request records; counters follow
the ``_total`` naming convention. Everything is prefixed ``repro_`` so a
shared Prometheus can scrape several services without collisions.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["render_metrics", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Writer:
    def __init__(self):
        self.lines: list[str] = []

    def metric(self, name: str, mtype: str, help_: str) -> None:
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, value, labels: Optional[dict] = None) -> None:
        label_s = ""
        if labels:
            inner = ",".join(
                f'{k}="{_escape(str(v))}"' for k, v in labels.items()
            )
            label_s = "{" + inner + "}"
        # integral values render as exact integers: '%g' would round
        # counters to 6 significant digits (1234567 -> 1.23457e+06),
        # corrupting rate() and scrape-diff arithmetic on busy servers
        v = float(value)
        rendered = str(int(v)) if v.is_integer() and abs(v) < 2**53 else repr(v)
        self.lines.append(f"{name}{label_s} {rendered}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def _le(bound: float) -> str:
    """Prometheus `le` label: integral bounds render bare ("100"), the
    rest as repr — matching the sample-value convention above."""
    v = float(bound)
    return str(int(v)) if v.is_integer() else repr(v)


def _histogram(w: _Writer, name: str, help_: str, hist: Optional[dict]) -> None:
    """Render a LatencyHistogram.report() dict as a Prometheus histogram:
    cumulative `_bucket{le=...}` series (last per-bucket count is the +Inf
    overflow), plus `_sum` and `_count`."""
    if not hist or not hist.get("buckets_ms"):
        return
    w.metric(name, "histogram", help_)
    cum = 0
    for bound, n in zip(hist["buckets_ms"], hist["counts"]):
        cum += n
        w.sample(name + "_bucket", cum, {"le": _le(bound)})
    cum += hist["counts"][-1]
    w.sample(name + "_bucket", cum, {"le": "+Inf"})
    w.sample(name + "_sum", hist["sum_ms"])
    w.sample(name + "_count", hist["count"])


def render_metrics(
    report: dict,
    stats: dict,
    cache_stats: Optional[dict] = None,
    draining: bool = False,
    uptime_s: float = 0.0,
    http_requests: int = 0,
    dispatch_counts: Optional[dict] = None,
    trace_stats: Optional[dict] = None,
    cost_rows: Optional[list] = None,
) -> str:
    w = _Writer()

    # -- service-level gauges -------------------------------------------
    w.metric("repro_up", "gauge", "1 while the server accepts requests, 0 while draining.")
    w.sample("repro_up", 0.0 if draining else 1.0)
    w.metric("repro_uptime_seconds", "gauge", "Seconds since the HTTP server started.")
    w.sample("repro_uptime_seconds", uptime_s)
    w.metric("repro_replicas", "gauge", "Engine replicas behind the router.")
    w.sample("repro_replicas", stats["replicas"])
    w.metric("repro_lanes", "gauge", "Total decode lanes across replicas.")
    w.sample("repro_lanes", stats["lanes"])
    w.metric("repro_free_lanes", "gauge", "Currently unbound decode lanes.")
    w.sample("repro_free_lanes", stats["free_lanes"])
    w.metric("repro_queue_depth", "gauge", "Requests waiting in the router queue.")
    w.sample("repro_queue_depth", stats["queued"])
    w.metric("repro_inflight_requests", "gauge", "Requests admitted but not yet retired.")
    w.sample("repro_inflight_requests", stats["inflight"])
    w.metric("repro_http_requests_total", "counter",
             "HTTP requests handled across ALL endpoints (scrapes and "
             "rejections included) — distinguishes wire traffic from "
             "router admissions.")
    w.sample("repro_http_requests_total", http_requests)

    # -- engine counters -------------------------------------------------
    counters = (
        ("repro_requests_total", "requests", "Requests retired across all replicas."),
        ("repro_steps_total", "steps", "Batched device steps across all replicas."),
        ("repro_prefill_steps_total", "prefill_steps", "Steps whose token block was wider than one position."),
        ("repro_decode_steps_total", "decode_steps", "One-token decode steps."),
        ("repro_emitted_tokens_total", "emitted_tokens", "Generated tokens delivered to clients."),
        ("repro_prompt_tokens_total", "prompt_tokens", "Prompt tokens consumed by prefill."),
    )
    for name, key, help_ in counters:
        w.metric(name, "counter", help_)
        w.sample(name, report[key])

    w.metric("repro_rejections_total", "counter",
             "Admission rejections by reason (queue_full | tenant_quota | bad_request | deadline_expired).")
    for reason, n in sorted(stats["rejections"].items()):
        w.sample("repro_rejections_total", n, {"reason": reason})

    # -- cancellation / preemption --------------------------------------
    w.metric("repro_cancelled_total", "counter",
             "Post-admission cancellations by reason (client_cancel | "
             "abandoned | deadline_expired) — each one released its lane "
             "or queue slot instead of decoding to max_new.")
    for reason, n in sorted(stats.get("cancellations", {}).items()):
        w.sample("repro_cancelled_total", n, {"reason": reason})
    w.metric("repro_preemptions_total", "counter",
             "Decoding lanes snapshotted to host FP8 and requeued so "
             "shorter queued work could run first.")
    w.sample("repro_preemptions_total", report.get("preemptions", 0))
    w.metric("repro_resumes_total", "counter",
             "Preempted requests restored onto a lane from their FP8 snapshot.")
    w.sample("repro_resumes_total", report.get("resumes", 0))

    # -- replica health / fault injection --------------------------------
    w.metric("repro_healthy_replicas", "gauge",
             "Replicas currently in rotation (ejected replicas excluded). "
             "0 means the admission circuit breaker is open.")
    w.sample("repro_healthy_replicas", stats.get("healthy_replicas",
                                                 stats["replicas"]))
    w.metric("repro_replica_ejections_total", "counter",
             "Replicas taken out of rotation after a crash or repeated "
             "step failures; their live requests were resubmitted.")
    w.sample("repro_replica_ejections_total", stats.get("ejections", 0))
    w.metric("repro_replica_reinstatements_total", "counter",
             "Ejected replicas returned to rotation by a successful probe.")
    w.sample("repro_replica_reinstatements_total",
             stats.get("reinstatements", 0))
    w.metric("repro_resubmits_total", "counter",
             "In-flight requests moved off a dead replica back into the "
             "router queue (t_submit preserved, delivery deduplicated).")
    w.sample("repro_resubmits_total", stats.get("resubmits", 0))
    w.metric("repro_retries_total", "counter",
             "Admission retries performed by the HTTP layer's backoff loop "
             "on transient queue_full rejections.")
    w.sample("repro_retries_total", stats.get("retries", 0))
    w.metric("repro_numeric_errors_total", "counter",
             "Requests retired with nonfinite logits (status "
             "numeric_error): the lane was reset instead of sampling "
             "garbage from NaN.")
    w.sample("repro_numeric_errors_total", report.get("numeric_errors", 0))
    faults = stats.get("faults") or {}
    if faults.get("injected") or faults.get("enabled"):
        w.metric("repro_faults_injected_total", "counter",
                 "Deliberate fault injections fired by the armed "
                 "REPRO_FAULTS plan, by injection point (absent when the "
                 "fault layer has never been armed).")
        for point, n in sorted(faults.get("injected", {}).items()):
            w.sample("repro_faults_injected_total", n, {"point": point})

    # -- prefix cache ----------------------------------------------------
    w.metric("repro_cache_lookups_total", "counter", "Prefix-cache admission lookups.")
    w.sample("repro_cache_lookups_total", report["cache_lookups"])
    w.metric("repro_cache_hits_total", "counter", "Lookups that injected a cached FP8 state.")
    w.sample("repro_cache_hits_total", report["cache_hits"])
    w.metric("repro_cache_full_hits_total", "counter", "Hits that skipped prefill entirely.")
    w.sample("repro_cache_full_hits_total", report["cache_full_hits"])
    w.metric("repro_prefill_tokens_saved_total", "counter",
             "Prompt tokens never sent to the device thanks to cache injection.")
    w.sample("repro_prefill_tokens_saved_total", report["prefill_tokens_saved"])
    if cache_stats is not None:
        w.metric("repro_cache_entries", "gauge", "Live prefix-cache entries.")
        w.sample("repro_cache_entries", cache_stats["entries"])
        w.metric("repro_cache_bytes", "gauge", "FP8 payload bytes resident in the prefix cache.")
        w.sample("repro_cache_bytes", cache_stats["nbytes"])
        w.metric("repro_cache_budget_bytes", "gauge", "Prefix-cache byte budget (--cache-mb).")
        w.sample("repro_cache_budget_bytes", cache_stats["budget_bytes"])
        w.metric("repro_cache_evictions_total", "counter", "LRU evictions under the byte budget.")
        w.sample("repro_cache_evictions_total", cache_stats["evictions"])
        w.metric("repro_cache_corruptions_total", "counter",
                 "Entries whose stored checksum failed verification at "
                 "lookup — served as a miss and evicted, never injected.")
        w.sample("repro_cache_corruptions_total",
                 cache_stats.get("corruptions", 0))

    # -- request phase breakdown ----------------------------------------
    # queue + prefill == TTFT and queue + prefill + decode == latency, so
    # these decompose the tail metrics above into attributable phases.
    phases = report.get("phases")
    if phases:
        w.metric("repro_request_phase_seconds", "summary",
                 "Per-request latency by phase (queue | prefill | decode), "
                 "summary over the retired-request record window.")
        for phase, agg in phases.items():
            for q, key in (("0.5", "p50_s"), ("0.95", "p95_s")):
                w.sample(
                    "repro_request_phase_seconds",
                    agg[key],
                    {"phase": phase, "quantile": q},
                )
        w.metric("repro_request_phase_seconds_mean", "gauge",
                 "Mean per-request phase latency over the record window.")
        for phase, agg in phases.items():
            w.sample(
                "repro_request_phase_seconds_mean",
                agg["mean_s"],
                {"phase": phase},
            )

    # -- latency histograms ----------------------------------------------
    # cumulative across the server's lifetime (NOT the record window), so
    # rate() and histogram_quantile() are well-defined over scrape diffs
    _histogram(
        w, "repro_ttft_ms",
        "Time to first token in milliseconds (cumulative histogram over "
        "all retired requests).",
        report.get("ttft_hist_ms"),
    )
    _histogram(
        w, "repro_tpot_ms",
        "Time per output token in milliseconds — decode stretch divided "
        "by inter-token gaps, requests with >= 2 generated tokens "
        "(cumulative histogram).",
        report.get("tpot_hist_ms"),
    )

    # -- kernel cost ledger ----------------------------------------------
    if cost_rows:
        cost_counters = (
            ("repro_cost_calls_total", "calls",
             "Dispatch decisions accumulated into the cost ledger."),
            ("repro_cost_flops_total", "flops",
             "Predicted FLOPs from the analytical kernel cost model "
             "(2/MAC + documented per-element constants)."),
            ("repro_cost_macs_total", "macs",
             "Predicted multiply-accumulates (the paper's Table-7 unit)."),
            ("repro_cost_hbm_read_bytes_total", "hbm_read_bytes",
             "Predicted device-memory operand traffic incl. a CUDA kernel's per-block refetches."),
            ("repro_cost_hbm_write_bytes_total", "hbm_write_bytes",
             "Predicted HBM result traffic."),
            ("repro_cost_pad_waste_bytes_total", "pad_waste_bytes",
             "Predicted bytes spent on tile-alignment padding."),
            ("repro_cost_touched_bytes_total", "touched_bytes",
             "Measured unique ndarray bytes the dispatch actually handed "
             "to the backend (the ref-exactness cross-check)."),
        )
        for name, key, help_ in cost_counters:
            w.metric(name, "counter", help_)
            for r in cost_rows:
                w.sample(name, r[key], {"op": r["op"], "backend": r["backend"]})
        w.metric("repro_cost_arithmetic_intensity", "gauge",
                 "Predicted FLOPs per HBM byte (roofline x-coordinate).")
        for r in cost_rows:
            w.sample("repro_cost_arithmetic_intensity",
                     r["arithmetic_intensity"],
                     {"op": r["op"], "backend": r["backend"]})
        w.metric("repro_cost_smem_bytes", "gauge",
                 "Predicted peak shared memory of a CUDA block, static + dynamic (0 on ref).")
        for r in cost_rows:
            w.sample("repro_cost_smem_bytes", r["smem_bytes"],
                     {"op": r["op"], "backend": r["backend"]})
        w.metric("repro_cost_bytes_rel_err", "gauge",
                 "(predicted - touched) / touched HBM bytes on the ref "
                 "backend — nonzero means the analytical model drifted "
                 "from the arrays actually moved.")
        for r in cost_rows:
            if r.get("bytes_rel_err") is not None:
                w.sample("repro_cost_bytes_rel_err", r["bytes_rel_err"],
                         {"op": r["op"], "backend": r["backend"]})

    # -- kernel dispatch decisions --------------------------------------
    if dispatch_counts is not None:
        w.metric("repro_dispatch_decisions_total", "counter",
                 "Kernel dispatch-layer backend decisions by (op, backend) "
                 "— a nonzero ref count where cuda was expected is a "
                 "silent-fallback alarm.")
        for (op, backend), n in sorted(dispatch_counts.items()):
            w.sample(
                "repro_dispatch_decisions_total",
                n,
                {"op": op, "backend": backend},
            )

    # -- tracer ----------------------------------------------------------
    if trace_stats is not None:
        w.metric("repro_trace_enabled", "gauge",
                 "1 while the request-lifecycle tracer is recording.")
        w.sample("repro_trace_enabled", 1.0 if trace_stats["enabled"] else 0.0)
        w.metric("repro_trace_events_total", "counter",
                 "Trace events emitted since the tracer was last cleared.")
        w.sample("repro_trace_events_total", trace_stats["emitted"])
        w.metric("repro_trace_dropped_total", "counter",
                 "Trace events evicted by the bounded ring buffer.")
        w.sample("repro_trace_dropped_total", trace_stats["dropped"])
        if trace_stats.get("spans"):
            w.metric("repro_trace_spans_total", "counter",
                     "Completed spans (and instants) by name.")
            w.metric("repro_trace_span_seconds_total", "counter",
                     "Cumulative duration inside each span name.")
            for name, agg in trace_stats["spans"].items():
                w.sample("repro_trace_spans_total", agg["count"], {"name": name})
                w.sample(
                    "repro_trace_span_seconds_total",
                    agg["total_s"],
                    {"name": name},
                )

    # -- per-tenant summaries -------------------------------------------
    w.metric("repro_tenant_requests_total", "counter", "Submissions by tenant.")
    w.metric("repro_tenant_completed_total", "counter", "Completed requests by tenant.")
    w.metric("repro_tenant_rejected_total", "counter", "Rejected submissions by tenant.")
    w.metric("repro_tenant_tokens_total", "counter", "Generated tokens by tenant.")
    for tenant, t in report.get("tenants", {}).items():
        lbl = {"tenant": tenant}
        w.sample("repro_tenant_requests_total", t.get("submitted", 0), lbl)
        w.sample("repro_tenant_completed_total", t.get("completed", 0), lbl)
        w.sample("repro_tenant_rejected_total", t.get("rejected", 0), lbl)
        w.sample("repro_tenant_tokens_total", t.get("tokens", 0), lbl)
    w.metric("repro_tenant_ttft_seconds", "summary",
             "Time to first token by tenant (summary over retired requests).")
    w.metric("repro_tenant_latency_seconds", "summary",
             "Submit-to-done latency by tenant (summary over retired requests).")
    for tenant, t in report.get("tenants", {}).items():
        for metric, stem in (
            ("repro_tenant_ttft_seconds", "ttft"),
            ("repro_tenant_latency_seconds", "latency"),
        ):
            for q, key in (("0.5", "p50"), ("0.95", "p95")):
                if f"{stem}_{key}_s" in t:
                    w.sample(
                        metric,
                        t[f"{stem}_{key}_s"],
                        {"tenant": tenant, "quantile": q},
                    )
    return w.render()
