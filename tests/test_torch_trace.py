"""The port's span tracer (``repro_torch.obs.trace``), the cases of
tests/test_obs.py's tracer section, and the serving stack's trace: a
router over two engine replicas with a prefix cache, a preemption, a
cancel and an injected fault, run with the tracer on, exports a Chrome
trace that scripts/check_trace.py accepts in full (its predicted-cost
counter tracks included, which the router's pumps emit from the kernel cost
ledger) and that carries every lifecycle event the reference's engine and
router emit.
"""
import asyncio
import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.faults import FAULTS  # noqa: E402
from repro_torch.models import WikiText2LM  # noqa: E402
from repro_torch.obs import TRACER, Tracer  # noqa: E402
from repro_torch.serving import PrefixCache, Router  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "check_trace", Path(__file__).parent.parent / "scripts" / "check_trace.py")
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)
validate_trace = check_trace.validate_trace


def test_span_emits_matched_pair_and_aggregates():
    t = Tracer()
    t.enable()
    with t.span("work", cat="test", rid=7):
        t.instant("tick", cat="test")
    evs = t.events()
    assert [e["ph"] for e in evs] == ["B", "i", "E"]
    assert evs[0]["name"] == evs[2]["name"] == "work"
    assert evs[0]["args"] == {"rid": 7}
    s = t.stats()
    assert s["spans"]["work"]["count"] == 1 and s["spans"]["work"]["total_s"] >= 0
    assert s["spans"]["tick"]["count"] == 1
    assert validate_trace(t.chrome_trace()) == []


def test_disabled_tracer_emits_nothing_and_reuses_null_span():
    t = Tracer()
    assert not t.enabled
    s1, s2 = t.span("a", rid=1), t.span("b")
    assert s1 is s2
    with s1:
        pass
    t.instant("x")
    t.counter("c", v=1)
    t.complete("y", 0, 5)
    assert t.events() == [] and t.stats()["emitted"] == 0


def test_ring_bound_counts_drops_but_keeps_aggregates():
    t = Tracer(capacity=8)
    t.enable()
    for _ in range(20):
        with t.span("w"):
            pass
    assert len(t.events()) == 8
    s = t.stats()
    assert s["dropped"] == 40 - 8 and s["emitted"] == 40
    assert s["spans"]["w"]["count"] == 20
    with pytest.raises(ValueError):
        Tracer(capacity=1)


def test_complete_events_resort_monotone_and_validate():
    t = Tracer()
    t.enable()
    t0 = time.monotonic_ns() // 1000
    with t.span("inner"):
        pass
    t.complete("outer", t0, (time.monotonic_ns() // 1000) - t0, cat="http")
    raw = t.events()
    assert raw[-1]["ph"] == "X" and raw[-1]["ts"] <= raw[0]["ts"]
    exported = t.chrome_trace()["traceEvents"]
    assert validate_trace({"traceEvents": exported}) == []
    assert [e["ts"] for e in exported] == sorted(e["ts"] for e in exported)
    assert t.stats()["spans"]["outer"]["count"] == 1


def test_export_sanitizes_orphan_E_and_unterminated_B():
    t = Tracer(capacity=3)
    t.enable()
    with t.span("evicted"):
        with t.span("kept"):
            pass
    assert [e["ph"] for e in t.events()] == ["B", "E", "E"]
    exported = t.chrome_trace()["traceEvents"]
    assert validate_trace({"traceEvents": exported}) == []
    assert [e["name"] for e in exported] == ["kept", "kept"]
    t2 = Tracer()
    t2.enable()
    t2.span("open").__enter__()  # never exited: the unterminated B is dropped
    with t2.span("closed"):
        pass
    exported = t2.chrome_trace()["traceEvents"]
    assert validate_trace({"traceEvents": exported}) == []
    assert [e["name"] for e in exported] == ["closed", "closed"]


def test_clear_resets_buffer_and_counters():
    t = Tracer()
    t.enable()
    with t.span("w"):
        pass
    t.clear()
    s = t.stats()
    assert t.events() == [] and s["emitted"] == 0 and s["spans"] == {}


def test_tracer_thread_and_asyncio_interleave_stays_consistent():
    t = Tracer(capacity=100_000)
    t.enable()
    N, WORKERS, COROS = 200, 4, 8

    def worker(w):
        for i in range(N):
            with t.span("step", worker=w, i=i):
                with t.span("inner"):
                    pass

    async def coro(c):
        for i in range(N):
            t0 = time.monotonic_ns() // 1000
            await asyncio.sleep(0)
            t.complete("request", t0, (time.monotonic_ns() // 1000) - t0, coro=c, i=i)

    async def main():
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(WORKERS)]
        for th in threads:
            th.start()
        await asyncio.gather(*(coro(c) for c in range(COROS)))
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)

    asyncio.run(main())
    s = t.stats()
    assert s["dropped"] == 0
    assert s["spans"]["step"]["count"] == s["spans"]["inner"]["count"] == WORKERS * N
    assert s["spans"]["request"]["count"] == COROS * N
    exported = t.chrome_trace()
    assert validate_trace(exported) == []
    assert len(exported["traceEvents"]) == 4 * WORKERS * N + COROS * N


def test_disabled_tracer_overhead_is_negligible():
    t = Tracer()
    calls = 20_000
    t0 = time.perf_counter()
    for _ in range(calls):
        with t.span("hot"):
            pass
    per_call = (time.perf_counter() - t0) / calls
    assert per_call < 50e-6, f"disabled span cost {per_call*1e6:.1f}us/call"
    assert t.events() == []


def test_serving_stack_trace_has_every_lifecycle_event():
    """A router's pumps (a cancel, a fault, cache hits), then a preemption
    on one replica driven directly: behind the router an engine's queue
    only holds what its free lanes can take, so it never preempts."""
    model = WikiText2LM(vocab=300, emb=32, hidden=32, n_layers=2)
    params = model.init(torch.Generator().manual_seed(0))
    cache = PrefixCache(block=4)
    router = Router.build(model, params, get_policy("floatsd8_table6"), replicas=2,
                          prefix_cache=cache, lanes=1, chunk=4, admission="sjf_work",
                          preempt=True, preempt_margin=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 300, 8).astype(np.int32)
    TRACER.clear()
    TRACER.enable()
    FAULTS.arm("seed=1;nonfinite_logits@9")
    try:
        long = [router.submit(prompt, max_new=12) for _ in range(2)]
        queued = router.submit(rng.integers(0, 300, 6).astype(np.int32), max_new=4)
        for _ in range(3):
            router.pump()
        assert router.cancel(long[1].rid)  # bound to a lane: the engine cancels
        router.drain()
        again = router.submit(prompt, max_new=2)  # a full hit
        router.drain()
        eng = router.engines[0]
        big = eng.submit(rng.integers(0, 300, 5).astype(np.int32), max_new=12)
        while not big.out:
            eng.step_once()
        short = eng.submit(prompt[:4], max_new=2)  # preempts the long decode
        eng.run()
    finally:
        FAULTS.disarm()
        TRACER.disable()
    trace = TRACER.chrome_trace()
    TRACER.clear()
    assert short.status == big.status == again.status == "done"
    assert eng.metrics.preemptions == eng.metrics.resumes == 1
    assert long[1].status == "cancelled"
    assert {long[0].status, queued.status} <= {"done", "numeric_error"}
    names = {e["name"] for e in trace["traceEvents"]}
    for name in ("router.pump", "router.submit", "router.dispatch", "router.cancel",
                 "engine.step", "engine.admit", "engine.retire", "engine.preempt",
                 "engine.resume", "engine.cancel", "engine.numeric_error", "cache.lookup",
                 "cache.insert", "fault.inject"):
        assert name in names, name
    steps = [e for e in trace["traceEvents"] if e["name"] == "engine.step" and e["ph"] == "B"]
    assert all(e["args"]["kind"] in ("prefill", "decode") and e["args"]["lanes"] for e in steps)
    # the validator passes in full: the pumps emit the cost ledger's
    # cost.floatsd_matmul and cost.lstm_cell counter tracks
    problems = validate_trace(trace)
    assert problems == [], problems
