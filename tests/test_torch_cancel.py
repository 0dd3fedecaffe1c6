"""Cancellation, preemption and scheduler v2 of the port against the JAX
package, at a tiny size: engine-level cancel in every request state, lane
reuse after a cancel, the four admission policies' order on one request
stream, preempt -> resume and ``admit_pace`` against the JAX engine on the
same workload, and router-level cancellation (explicit, abandoned stream,
mid-flight deadline, drain with cancelled work in flight). The HTTP cases
of tests/test_cancel.py wait for the port's HTTP layer.

Model: WikiText2LM with vocab 512, emb = hidden = 64, 2 layers,
floatsd8_table6, numpy parameters from a seed (as test_torch_frontend.py).
Tokens are held to the JAX engine's over each request's margin-decisive
prefix (top-2 gap above 1e-4); admissions, preemptions and resumes
exactly.
"""
import asyncio
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ADMISSION_POLICIES, AsyncRouter, PrefixCache, Request, Router, Scheduler, ServeEngine,
)

V, D = 512, 64
MARGIN_FLOOR = 1e-4
JPOL = jget_policy("floatsd8_table6")
TPOL = tget_policy("floatsd8_table6")


def np_params(seed=0):
    rng = np.random.default_rng(seed)
    s = 3.0 / np.sqrt(D)
    p = {"embed": {"table": (rng.standard_normal((V, D)) * 0.5).astype(np.float32)}}
    for i in range(2):
        b = np.zeros(4 * D, np.float32)
        b[D:2 * D] = 1.0
        p[f"lstm{i}"] = {
            "wx": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
            "wh": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
            "b": b,
        }
    return p


_PORT_PARAMS = bridge.from_jax_params(np_params(), "cpu")


def make_engine(**kw):
    return ServeEngine(TLM(vocab=V, emb=D, hidden=D), _PORT_PARAMS, TPOL, **kw)


def prompt_of(length, seed=0):
    return np.random.default_rng(seed).integers(0, V, length).astype(np.int32)


def _decisive(req) -> int:
    return next((i for i, g in enumerate(req.margins) if g <= MARGIN_FLOOR), len(req.out))


# ---------------------------------------------------------------------------
# engine-level cancel matrix
# ---------------------------------------------------------------------------


def test_cancel_queued_unknown_and_done_are_idempotent():
    eng = make_engine(lanes=1, chunk=4)
    a = eng.submit(prompt_of(6, 1), max_new=3)
    b = eng.submit(prompt_of(6, 2), max_new=3)
    assert eng.cancel(b.rid) is True
    assert b.status == "cancelled" and b.cancel_reason == "cancelled"
    assert eng.cancel(b.rid) is False and eng.cancel(12345) is False
    m = eng.run()
    assert a.status == "done" and len(a.out) == 3
    assert eng.cancel(a.rid) is False
    assert m.cancelled == 1 and m.cancelled_by_reason == {"cancelled": 1} and m.retired == 1


def test_cancel_mid_decode_frees_lane_with_zero_extra_steps():
    eng = make_engine(lanes=1, chunk=4)
    a = eng.submit(prompt_of(6, 3), max_new=64)
    while len(a.out) < 3:
        assert eng.step_once()
    steps0 = eng.metrics.steps
    assert eng.cancel(a.rid) is True
    assert eng.free_lanes == 1
    eng.run()
    assert eng.metrics.steps == steps0
    assert a.status == "cancelled" and 3 <= len(a.out) < 64


def test_cancel_mid_prefill_releases_lane_without_cache_insert():
    cache = PrefixCache(block=4)
    eng = make_engine(lanes=1, chunk=4, prefix_cache=cache)
    a = eng.submit(prompt_of(24, 4), max_new=8)
    assert eng.step_once() and a.out == []
    inserts_before = cache.stats()["entries"]
    assert eng.cancel(a.rid) is True
    assert eng.free_lanes == 1 and a.status == "cancelled"
    assert cache.stats()["entries"] == inserts_before


def test_cancel_after_full_cache_hit_retire_returns_false():
    cache = PrefixCache(block=4)
    warm = make_engine(lanes=1, chunk=4, prefix_cache=cache)
    p = prompt_of(8, 5)
    w = warm.submit(p, max_new=4)
    warm.run()
    eng = make_engine(lanes=1, chunk=4, prefix_cache=cache)
    r = eng.submit(p, max_new=1)
    assert eng.step_once() is False  # retired at admission, nothing ran
    assert r.status == "done" and r.out == w.out[:1]
    assert eng.cancel(r.rid) is False


def test_lane_reuse_after_cancel_has_no_state_bleed():
    pC = prompt_of(10, 7)
    eng = make_engine(lanes=1, chunk=4)
    a = eng.submit(prompt_of(12, 6), max_new=48)
    while len(a.out) < 4:
        eng.step_once()
    assert eng.cancel(a.rid) is True
    c = eng.submit(pC, max_new=16)
    eng.run()
    ref_eng = make_engine(lanes=1, chunk=4)
    ref = ref_eng.submit(pC, max_new=16)
    ref_eng.run()
    assert c.status == "done" and c.out == ref.out and len(c.out) == 16


# ---------------------------------------------------------------------------
# admission order on one request stream, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ADMISSION_POLICIES)
def test_scheduler_pops_in_the_reference_order(policy):
    """Deadlines (some missing), prompt lengths, cache work hints and
    partial outputs drawn from a seed; pops interleaved with submissions
    and a removal."""
    r = np.random.default_rng(11)
    now = 100.0
    specs = []
    for i in range(40):
        specs.append(dict(
            rid=i, prompt=np.arange(int(r.integers(1, 30)), dtype=np.int32),
            max_new=int(r.integers(1, 20)),
            deadline=None if r.random() < 0.3 else now + float(r.integers(0, 8)),
            work_hint=None if r.random() < 0.5 else int(r.integers(0, 10)),
            out=list(range(int(r.integers(0, 3)))),
        ))
    got, want = Scheduler(policy), JScheduler(policy)
    order_t, order_j = [], []
    for i, sp in enumerate(specs):
        for sched, cls, order in ((got, Request, order_t), (want, JRequest, order_j)):
            kw = {k: v for k, v in sp.items() if k not in ("work_hint", "out")}
            req = cls(**kw)
            req.work_hint, req.out = sp["work_hint"], list(sp["out"])
            sched.submit(req, now=now + i)
            if i % 5 == 4:
                order.append(sched.peek().rid)
                order.append(sched.pop().rid)
            if i == 20:
                order.append(getattr(sched.remove(3), "rid", None))
    for sched, order in ((got, order_t), (want, order_j)):
        while sched:
            order.append(sched.pop().rid)
    assert order_t == order_j
    assert got.pop() is None and got.peek() is None


def _admissions(eng):
    """Step to the end, recording each step's (lane -> rid) binding."""
    seen = []
    while eng.step_once():
        seen.append(tuple(None if l is None else l.req.rid for l in eng._lanes))
    return seen


def _workload():
    return [prompt_of(int(n), 20 + i) for i, n in enumerate((9, 3, 14, 5, 7, 2, 11, 4))]


@pytest.fixture(scope="module")
def jax_engine_runs():
    """The JAX engine on the preemption and pacing workloads."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    model = JLM(vocab=V, emb=D, hidden=D)
    out = {}
    for name, kw in _SCENARIOS.items():
        eng = JEngine(model, params, JPOL, **kw)
        out[name] = _run_scenario(eng, name)
    eng = JEngine(model, params, JPOL, lanes=1, chunk=4)
    out["undisturbed"] = eng.submit(prompt_of(8, 8), max_new=LONG_NEW)
    eng.run()
    return out


# the preempted stream's length: within it the two frameworks' streams
# agree; past ~20 steps an ulp difference that flips an FP8 activation
# cascades through the recurrence of these random weights (ROADMAP.md,
# Gotchas)
LONG_NEW = 16
_SCENARIOS = {
    "preempt": dict(lanes=1, chunk=4, admission="sjf_work", preempt=True, preempt_margin=2,
                    preempt_max=2),
    "pace": dict(lanes=4, chunk=4, admit_pace=1, admission="edf"),
    "sjf_work": dict(lanes=2, chunk=4, admission="sjf_work", preempt=True),
}


def _run_scenario(eng, name):
    if name == "preempt":
        long = eng.submit(prompt_of(8, 8), max_new=LONG_NEW)
        while not long.out:  # TTFT banked: the lane is now a preemption candidate
            eng.step_once()
        reqs = [long, eng.submit(prompt_of(4, 9), max_new=2)]
    else:
        deadlines = [None, 5.0, 1.0, None, 3.0, 2.0, 9.0, 4.0]
        reqs = [eng.submit(p, max_new=3 + 2 * (i % 4),
                           deadline=None if deadlines[i] is None else 1e9 + deadlines[i])
                for i, p in enumerate(_workload())]
    seen = _admissions(eng)
    return dict(seen=seen, preemptions=eng.metrics.preemptions, resumes=eng.metrics.resumes,
                steps=eng.metrics.steps, reqs=reqs)


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_preempt_pace_and_policies_admit_as_the_jax_engine(jax_engine_runs, name):
    """The same stream through both engines: the lane bindings after every
    step, the preemptions and resumes and the step count equal the JAX
    engine's, and the tokens over the decisive prefix."""
    want = jax_engine_runs[name]
    got = _run_scenario(make_engine(**_SCENARIOS[name]), name)
    assert got["seen"] == want["seen"]
    for key in ("preemptions", "resumes", "steps"):
        assert got[key] == want[key], key
    for t, j in zip(got["reqs"], want["reqs"]):
        n = _decisive(t)
        assert t.status == j.status == "done" and t.out[:n] == j.out[:n], (t.rid, t.out, j.out)
        assert t.preempt_count == j.preempt_count
    if name == "preempt":
        assert got["preemptions"] >= 1 and got["preemptions"] == got["resumes"]
    if name == "pace":
        # one admission a step despite 4 free lanes
        assert [sum(x is not None for x in s) for s in got["seen"][:3]] == [1, 2, 3]


def test_preempt_resume_token_agreement_and_bounded_displacement(jax_engine_runs):
    """A long decode preempted for a short arrival resumes from its FP8
    snapshot (the same bytes as the JAX engine's), displaced at most
    preempt_max times. On these random weights the snapshot's rounding
    flips a later token of the stream, as it does in the reference: the
    preempted stream agrees with an undisturbed run up to the same token
    in both packages (reported, and held equal to the reference's)."""
    eng = make_engine(**_SCENARIOS["preempt"])
    long = eng.submit(prompt_of(8, 8), max_new=LONG_NEW)
    while not long.out:
        eng.step_once()
    short = eng.submit(prompt_of(4, 9), max_new=2)
    eng.run()
    assert eng.metrics.preemptions >= 1 and eng.metrics.resumes == eng.metrics.preemptions
    assert 1 <= long.preempt_count <= 2
    assert short.status == "done" and len(short.out) == 2
    assert long.status == "done" and len(long.out) == LONG_NEW
    ref_eng = make_engine(lanes=1, chunk=4)
    ref = ref_eng.submit(prompt_of(8, 8), max_new=LONG_NEW)
    ref_eng.run()
    jlong, jref = jax_engine_runs["preempt"]["reqs"][0], jax_engine_runs["undisturbed"]

    def first_diff(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))

    n = _decisive(ref)
    assert ref.out[:n] == jref.out[:n]
    got, want = first_diff(long.out, ref.out), first_diff(jlong.out, jref.out)
    print(f"preempted vs undisturbed: equal through token {got} of {LONG_NEW} "
          f"(reference: {want})")
    assert got == want


def test_admit_pace_rejects_zero():
    with pytest.raises(ValueError):
        make_engine(lanes=2, admit_pace=0)


# ---------------------------------------------------------------------------
# router-level cancellation
# ---------------------------------------------------------------------------


def test_router_explicit_cancel_stops_decode_and_is_idempotent():
    router = Router([make_engine(lanes=1, chunk=4)])
    t = router.submit(prompt_of(6, 11), max_new=64)
    while len(t.req.out) < 3:
        router.pump()
    steps0 = router.engines[0].metrics.steps
    assert router.cancel(t.rid) is True
    assert t.status == "cancelled" and t.reason == "client_cancel" and t.tokens
    while router.pump():
        pass
    assert router.engines[0].metrics.steps == steps0
    assert router.cancel(t.rid) is False
    assert router.cancellations == {"client_cancel": 1}
    assert router.stats()["cancellations"] == {"client_cancel": 1}
    assert router.report()["cancellations"] == {"client_cancel": 1}


def test_router_cancels_expired_deadline_mid_flight():
    router = Router([make_engine(lanes=1, chunk=4)])
    t = router.submit(prompt_of(6, 12), max_new=4096, deadline=time.monotonic() + 0.05)
    wall = time.monotonic() + 30.0
    while t.status not in ("done", "cancelled", "rejected"):
        assert time.monotonic() < wall, "pump never cancelled"
        router.pump()
    assert t.status == "cancelled" and t.reason == "deadline_expired"
    assert len(t.tokens) < 4096
    assert router.cancellations == {"deadline_expired": 1}


def test_abandoned_stream_is_cancelled_inside_the_engine():
    router = Router([make_engine(lanes=2, chunk=4)])
    ar = AsyncRouter(router)

    async def main():
        async for _ in ar.stream(prompt_of(6, 13), max_new=64):
            break
        return await ar.generate(prompt_of(6, 14), max_new=2)

    t = asyncio.run(main())
    assert t.status == "done" and len(t.tokens) == 2
    assert router.cancellations == {"abandoned": 1}
    assert router.idle


def test_drain_completes_with_abandoned_and_cancelled_work_in_flight():
    router = Router([make_engine(lanes=2, chunk=4)])
    t1 = router.submit(prompt_of(6, 15), max_new=64)
    t2 = router.submit(prompt_of(6, 16), max_new=64)
    t3 = router.submit(prompt_of(6, 17), max_new=4)
    while len(t1.req.out) < 1:
        router.pump()
    assert router.cancel(t1.rid) is True
    t2.abandoned = True
    router.drain()
    assert router.idle
    assert t1.status == "cancelled" and t2.status == "cancelled"
    assert t3.status == "done" and len(t3.tokens) == 4
    assert router.cancellations == {"client_cancel": 1, "abandoned": 1}
