"""Bounded ring-buffer span tracer with Chrome trace-event export.

Counterpart of ``repro.obs.trace``. Stdlib-only on purpose: the serving
hot path (the engine, the router, the fault switchboard, the asyncio
router's worker thread) imports this module, so it pulls in nothing of
torch.

Design points:

  * **Bounded**: events land in a ``collections.deque(maxlen=capacity)``;
    when the ring wraps, the oldest events are dropped (and counted in
    ``dropped``). A long-lived server can leave tracing on forever and the
    buffer stays O(capacity).
  * **Thread/async-safe**: one ``threading.Lock`` guards the ring and the
    aggregate table. Events record ``threading.get_ident()`` as their
    ``tid``, so spans emitted concurrently from the engine worker thread
    and the asyncio event loop land on separate tracks and never pair
    against each other.
  * **Monotonic clock**: timestamps are ``time.monotonic_ns() // 1000``
    (microseconds) — the unit Chrome trace-event JSON expects — so traces
    are immune to wall-clock steps.
  * **~zero cost when disabled**: every emitting entry point checks
    ``self._enabled`` first and returns a cached no-op context manager, so
    a disabled tracer costs one attribute load, one branch, and whatever
    the caller spent building kwargs (callers on hot paths guard arg
    construction with ``TRACER.enabled``).
  * **Export-time sanitization**: ``chrome_trace()`` drops orphan ``E``
    events (whose ``B`` was evicted by the ring) and unterminated ``B``
    events (spans still open at export), so every exported trace has
    matched B/E pairs and loads cleanly in Perfetto / chrome://tracing.

A module-level ``TRACER`` is the instance the whole stack shares; the
``REPRO_TRACE=1`` environment variable enables it at import time.
"""
from __future__ import annotations

import collections
import os
import threading
import time

__all__ = ["Tracer", "TRACER", "span", "instant", "counter"]

_DEFAULT_CAPACITY = 65536


class _NullSpan:
    """Reused no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: emits a matched B/E pair and feeds the aggregate table."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.monotonic_ns() // 1000
        self._tr._push(
            {
                "name": self._name,
                "cat": self._cat,
                "ph": "B",
                "ts": self._t0,
                "pid": self._tr.pid,
                "tid": threading.get_ident(),
                "args": self._args,
            }
        )
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns() // 1000
        tr = self._tr
        tr._push(
            {
                "name": self._name,
                "cat": self._cat,
                "ph": "E",
                "ts": t1,
                "pid": tr.pid,
                "tid": threading.get_ident(),
            }
        )
        with tr._lock:
            cnt, tot = tr._agg.get(self._name, (0, 0))
            tr._agg[self._name] = (cnt + 1, tot + (t1 - self._t0))
        return False


class Tracer:
    """Thread-safe bounded tracer. See module docstring for semantics."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, pid: int = 0):
        if capacity < 2:
            raise ValueError("capacity must hold at least one B/E pair")
        self.capacity = capacity
        self.pid = pid
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._enabled = False
        self.emitted = 0  # total events pushed since last clear()
        self.dropped = 0  # ... of which the ring evicted
        # per-span-name aggregates survive ring eviction: name -> (count,
        # total duration in us), what ``stats()`` reports.
        self._agg: dict = {}

    # -- switches --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._agg = {}
            self.emitted = 0
            self.dropped = 0

    # -- emission --------------------------------------------------------
    def _push(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
            self.emitted += 1

    def span(self, name: str, cat: str = "repro", **args):
        """Context manager emitting a matched B/E pair around the body."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def complete(
        self, name: str, ts_us: int, dur_us: int, cat: str = "repro", **args
    ) -> None:
        """Retroactive complete event (``ph: "X"``) for scopes that await:
        a ``span()`` on the asyncio event loop would interleave its B/E
        with other coroutines on the same thread and break nesting, so
        async scopes take a start stamp (``time.monotonic_ns() // 1000``)
        and emit one X event with an explicit duration at completion —
        X events need no pairing and tolerate same-tid overlap."""
        if not self._enabled:
            return
        self._push(
            {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": ts_us,
                "dur": max(int(dur_us), 0),
                "pid": self.pid,
                "tid": threading.get_ident(),
                "args": args,
            }
        )
        with self._lock:
            cnt, tot = self._agg.get(name, (0, 0))
            self._agg[name] = (cnt + 1, tot + max(int(dur_us), 0))

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Point event (``ph: "i"``) — admissions, retires, flushes."""
        if not self._enabled:
            return
        self._push(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": time.monotonic_ns() // 1000,
                "pid": self.pid,
                "tid": threading.get_ident(),
                "args": args,
            }
        )
        with self._lock:
            cnt, tot = self._agg.get(name, (0, 0))
            self._agg[name] = (cnt + 1, tot)

    def counter(self, name: str, cat: str = "repro", **values) -> None:
        """Counter-track sample (``ph: "C"``) — queue depth over time."""
        if not self._enabled:
            return
        self._push(
            {
                "name": name,
                "cat": cat,
                "ph": "C",
                "ts": time.monotonic_ns() // 1000,
                "pid": self.pid,
                "tid": threading.get_ident(),
                "args": values,
            }
        )

    # -- export / introspection -----------------------------------------
    def events(self) -> list:
        """Raw snapshot of the ring (unsanitized), oldest first."""
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON document, sanitized so every B has a
        matching E on the same tid (ring eviction can orphan either end;
        see module docstring)."""
        events = self.events()
        # X events are pushed at completion but stamped with their start
        # ts; a stable sort restores global ts order (ties keep push
        # order, so a B still precedes its same-microsecond E).
        events.sort(key=lambda e: e["ts"])
        keep = [True] * len(events)
        open_b: dict = {}  # tid -> stack of indices of open B events
        for i, ev in enumerate(events):
            ph = ev["ph"]
            if ph == "B":
                open_b.setdefault(ev["tid"], []).append(i)
            elif ph == "E":
                stack = open_b.get(ev["tid"])
                if stack:
                    stack.pop()
                else:
                    keep[i] = False  # orphan E: its B was evicted
        for stack in open_b.values():
            for i in stack:
                keep[i] = False  # span still open at export time
        return {
            "traceEvents": [ev for i, ev in enumerate(events) if keep[i]],
            "displayTimeUnit": "ms",
        }

    def stats(self) -> dict:
        """Totals plus per-span-name counts and cumulative durations
        (seconds). Cheap; safe to call while tracing."""
        with self._lock:
            agg = dict(self._agg)
            return {
                "enabled": self._enabled,
                "emitted": self.emitted,
                "dropped": self.dropped,
                "buffered": len(self._events),
                "spans": {
                    name: {"count": cnt, "total_s": tot / 1e6}
                    for name, (cnt, tot) in sorted(agg.items())
                },
            }


#: Process-wide tracer shared by every layer of the stack.
TRACER = Tracer()

if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    TRACER.enable()


def span(name: str, cat: str = "repro", **args):
    return TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    TRACER.instant(name, cat, **args)


def counter(name: str, cat: str = "repro", **values) -> None:
    TRACER.counter(name, cat, **values)
