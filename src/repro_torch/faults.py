"""Seeded, deterministic fault injection for the serve/train stack.

Counterpart of ``repro.faults``: the same points, plan grammar and seeded
draws, so one plan string fires on the same arrivals in both packages.

Robustness work is untestable without a way to *cause* the failures on
demand, reproducibly. This module is the single switchboard: every layer
that can fail declares a **named injection point** and asks the process-
wide :data:`FAULTS` registry whether a fault fires at this arrival. When
no plan is armed the check is one attribute read (``FAULTS.enabled`` —
the same zero-overhead pattern as ``obs.trace.TRACER``), so production
paths pay nothing.

Injection points (the stable names callers and plans use):

=====================  ======================================================
``engine_step_raise``  ``ServeEngine.step_once`` raises ``InjectedFault``
                       before touching the device (transient replica error).
``engine_step_slow``   ``step_once`` sleeps ``ms`` before stepping
                       (straggling replica).
``replica_crash``      the engine marks itself crashed; every subsequent
                       step raises ``ReplicaCrash`` (sticky until the
                       process restarts — models a dead replica).
``cache_corrupt``      ``PrefixCache.insert`` flips one byte of the stored
                       FP8 snapshot *after* the checksum is computed, so a
                       later lookup must detect the corruption.
``nonfinite_logits``   ``step_once`` poisons one active lane's logits with
                       NaN on the host copy, exercising the engine's
                       nonfinite guard end to end.
``socket_drop``        the HTTP server aborts the connection mid-response
                       (a point of the grammar; the port's HTTP layer,
                       which fires it, is not ported yet).
``ckpt_torn_write``    ``checkpointing.save`` dies after writing arrays but
                       before publishing the manifest (torn checkpoint).
=====================  ======================================================

Plans are strings — CLI- and env-friendly (``REPRO_FAULTS=...``)::

    seed=42;replica_crash@6:key=1;cache_corrupt@2;engine_step_slow%0.1:ms=40:n=3

``;``-separated rules, each ``point`` plus modifiers:

  * ``@N``      fire on the Nth matching arrival (1-based), once.
  * ``%p``      fire each arrival with probability ``p`` (seeded, and
                deterministic given the arrival order).
  * ``:key=X``  only arrivals whose caller-supplied ``key`` equals ``X``
                count toward / trigger this rule (e.g. a replica index).
  * ``:n=K``    fire at most K times (default 1 for ``@``, unlimited
                for ``%``).
  * ``:<k>=<v>`` any other modifier is carried as a payload arg returned
                to the caller (e.g. ``ms=40`` for the slow fault).

Every fire increments ``injected[point]`` and emits a ``fault.inject``
trace instant, so a chaos run's injections are visible in the same
Perfetto timeline as the recoveries they provoke.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Optional

from .obs.trace import TRACER

__all__ = [
    "InjectedFault",
    "ReplicaCrash",
    "FaultRule",
    "FaultPlan",
    "Faults",
    "FAULTS",
    "ENGINE_STEP_RAISE",
    "ENGINE_STEP_SLOW",
    "REPLICA_CRASH",
    "CACHE_CORRUPT",
    "NONFINITE_LOGITS",
    "SOCKET_DROP",
    "CKPT_TORN_WRITE",
    "POINTS",
]

ENGINE_STEP_RAISE = "engine_step_raise"
ENGINE_STEP_SLOW = "engine_step_slow"
REPLICA_CRASH = "replica_crash"
CACHE_CORRUPT = "cache_corrupt"
NONFINITE_LOGITS = "nonfinite_logits"
SOCKET_DROP = "socket_drop"
CKPT_TORN_WRITE = "ckpt_torn_write"

#: Every known injection point; plans naming anything else are rejected
#: eagerly (a typo'd point would otherwise silently never fire).
POINTS = frozenset({
    ENGINE_STEP_RAISE,
    ENGINE_STEP_SLOW,
    REPLICA_CRASH,
    CACHE_CORRUPT,
    NONFINITE_LOGITS,
    SOCKET_DROP,
    CKPT_TORN_WRITE,
})


class InjectedFault(RuntimeError):
    """A deliberately injected, *recoverable* fault."""


class ReplicaCrash(InjectedFault):
    """The replica is gone for good — callers must eject, not retry."""


class FaultRule:
    """One parsed plan rule; tracks its own matching-arrival count."""

    def __init__(self, point: str, at: Optional[int] = None,
                 prob: Optional[float] = None, key: Optional[str] = None,
                 max_fires: Optional[int] = None, args: Optional[dict] = None):
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(known: {', '.join(sorted(POINTS))})")
        if (at is None) == (prob is None):
            raise ValueError(f"rule for {point!r} needs exactly one of "
                             "@N (arrival) or %p (probability)")
        self.point = point
        self.at = at
        self.prob = prob
        self.key = key
        self.max_fires = max_fires if max_fires is not None else (
            1 if at is not None else None)
        self.args = dict(args or {})
        self.arrivals = 0
        self.fires = 0
        self._rng: Optional[random.Random] = None

    def seed(self, seed: int) -> None:
        # Per-rule stream: rules never perturb each other's draws, so
        # adding a rule to a plan does not reshuffle the others.
        self._rng = random.Random(f"{seed}:{self.point}:{self.key}")

    def matches(self, key) -> bool:
        return self.key is None or str(key) == self.key

    def check(self) -> bool:
        """Count one matching arrival; True iff the fault fires on it."""
        self.arrivals += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.at is not None:
            hit = self.arrivals == self.at
        else:
            rng = self._rng or random.Random(f"0:{self.point}:{self.key}")
            self._rng = rng
            hit = rng.random() < (self.prob or 0.0)
        if hit:
            self.fires += 1
        return hit


def _parse_rule(text: str) -> FaultRule:
    head, *mods = text.split(":")
    at = prob = None
    if "@" in head:
        point, _, n = head.partition("@")
        at = int(n)
    elif "%" in head:
        point, _, p = head.partition("%")
        prob = float(p)
    else:
        raise ValueError(f"fault rule {text!r}: expected point@N or point%p")
    key = max_fires = None
    args: dict = {}
    for mod in mods:
        k, _, v = mod.partition("=")
        if not _ or not k:
            raise ValueError(f"fault rule {text!r}: bad modifier {mod!r}")
        if k == "key":
            key = v
        elif k == "n":
            max_fires = int(v)
        else:
            try:
                args[k] = float(v) if "." in v else int(v)
            except ValueError:
                args[k] = v
    return FaultRule(point.strip(), at=at, prob=prob, key=key,
                     max_fires=max_fires, args=args)


class FaultPlan:
    """A parsed, seeded set of rules. Immutable once built."""

    def __init__(self, rules, seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        for r in self.rules:
            r.seed(seed)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed = 0
        rules = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if part.startswith("seed="):
                seed = int(part[5:])
            else:
                rules.append(_parse_rule(part))
        return cls(rules, seed=seed)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan(seed={self.seed}, rules={len(self.rules)})"


class Faults:
    """Process-wide fault switchboard.

    ``enabled`` is a plain bool attribute so the disabled fast path in hot
    loops is a single attribute read — identical to ``TRACER``'s contract.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self._plan: Optional[FaultPlan] = None
        self.injected: dict = {}  # point -> fire count
        self.arrivals: dict = {}  # point -> matching-arrival count

    def arm(self, plan) -> None:
        """Arm a plan (a :class:`FaultPlan` or a spec string)."""
        if isinstance(plan, str):
            plan = FaultPlan.parse(plan)
        with self._lock:
            self._plan = plan
            self.injected = {}
            self.arrivals = {}
            self.enabled = bool(plan.rules)

    def disarm(self) -> None:
        with self._lock:
            self.enabled = False
            self._plan = None

    def fire(self, point: str, key=None, **ctx) -> Optional[dict]:
        """One arrival at ``point``. Returns the rule's payload args (a
        dict, never empty — it always carries ``point``) when a fault
        fires here, else ``None``. Callers gate on ``FAULTS.enabled``
        first so this is never reached with the layer off."""
        if not self.enabled:
            return None
        with self._lock:
            plan = self._plan
            if plan is None:
                return None
            fired = None
            for rule in plan.rules:
                if rule.point != point or not rule.matches(key):
                    continue
                self.arrivals[point] = self.arrivals.get(point, 0) + 1
                if rule.check():
                    fired = dict(rule.args, point=point)
                    self.injected[point] = self.injected.get(point, 0) + 1
                    break
        if fired is not None:
            TRACER.instant("fault.inject", cat="fault", point=point,
                           key=key, **ctx)
        return fired

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "injected": dict(self.injected),
                "arrivals": dict(self.arrivals),
            }


#: Process-wide switchboard, armed from ``REPRO_FAULTS`` at import so any
#: entry point (the serve CLI, the smoke script) can inject via env alone.
FAULTS = Faults()

_env_plan = os.environ.get("REPRO_FAULTS", "")
if _env_plan and _env_plan != "0":
    FAULTS.arm(_env_plan)
