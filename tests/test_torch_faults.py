"""The port's fault-injection layer and its recovery paths against the JAX
package, at a tiny size.

  * ``repro_torch.faults``: the plan grammar and the seeded firing, arrival
    for arrival against the reference's ``Faults`` on the same plans;
  * the engine's nonfinite guard: by an injected fault, and by a real NaN
    state injected through a full prefix-cache hit;
  * the prefix cache: a corrupted entry is a miss and is evicted;
  * the router: a crashed replica is ejected and its work resubmitted with
    the fault-free run's tokens; transient failures eject, and a probe
    reinstates; the combined plan gives both packages' routers the same
    outcome (fired arrivals, ejected replica, numeric_error requests,
    corruptions, hits) and tokens over the margin-decisive prefix;
  * checkpointing: a torn write stays invisible and can be saved over.

Model: WikiText2LM with vocab 512, emb = hidden = 64, 2 layers,
floatsd8_table6, numpy parameters from a seed (as test_torch_frontend.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.faults import FAULTS as JFAULTS  # noqa: E402
from repro.faults import Faults as JFaults  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving import Router as JRouter  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.distributed import checkpointing as ckpt  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    FAULTS, POINTS, FaultPlan, FaultRule, Faults, InjectedFault,
)
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.nn.lstm import LSTMState  # noqa: E402
from repro_torch.obs.trace import TRACER  # noqa: E402
from repro_torch.serving import PrefixCache, Router  # noqa: E402
from repro_torch.serving.metrics import ServeMetrics  # noqa: E402

V, D = 512, 64
MARGIN_FLOOR = 1e-4
JPOL = jget_policy("floatsd8_table6")
TPOL = tget_policy("floatsd8_table6")
CHAOS = "seed=1;replica_crash@2:key=1;cache_corrupt@2;nonfinite_logits@3"


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


@pytest.fixture(autouse=True)
def _disarm():
    """No test leaks an armed plan (of either package) into the next."""
    yield
    FAULTS.disarm()
    JFAULTS.disarm()


def port_router(replicas=1, prefix_cache=None, router_kw=None, lanes=2, chunk=4):
    return Router.build(TLM(vocab=V, emb=D, hidden=D), _PORT_PARAMS, TPOL, replicas=replicas,
                        prefix_cache=prefix_cache, router_kw=router_kw, lanes=lanes, chunk=chunk)


def prompts_for(n, seed=0, lo=4, hi=10):
    r = np.random.default_rng(seed)
    return [r.integers(0, V, size=int(r.integers(lo, hi))).astype(np.int32) for _ in range(n)]


# ---------------------------------------------------------------------------
# plan grammar and firing, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [
    "seed=1;engine_step_raise@3",
    "seed=1;replica_crash@2:key=1",
    "seed=42;engine_step_slow%0.3:n=1000",
    "seed=43;engine_step_slow%0.3:n=1000;engine_step_raise%0.05:key=0",
    "seed=1;engine_step_slow%1.0:ms=40:n=2",
    "seed=7;nonfinite_logits%0.2:key=1:n=3;cache_corrupt@2;replica_crash@6:key=1",
    "cache_corrupt%0.5:tag=x:ms=2.5",
])
def test_plans_fire_on_the_reference_arrivals(plan):
    """The same plan and the same arrival sequence (points and keys drawn
    from a seed) fire the same arrivals with the same payloads, and leave
    the same counters."""
    got, want = Faults(), JFaults()
    got.arm(plan)
    want.arm(plan)
    r = np.random.default_rng(0)
    points = sorted(POINTS)
    for _ in range(400):
        point, key = points[r.integers(len(points))], int(r.integers(3))
        assert got.fire(point, key=key) == want.fire(point, key=key), (point, key)
    assert got.stats() == want.stats()


def test_plan_grammar_errors_and_disarm():
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultPlan.parse("seed=1;bogus_point@1")
    with pytest.raises(ValueError, match="expected point@N or point%p"):
        FaultPlan.parse("replica_crash")
    with pytest.raises(ValueError, match="exactly one"):
        FaultRule("replica_crash")
    with pytest.raises(ValueError, match="bad modifier"):
        FaultPlan.parse("replica_crash@1:key")
    f = Faults()
    assert not f.enabled and f.fire("engine_step_raise") is None
    f.arm("seed=1;engine_step_raise@1")
    assert f.enabled
    f.disarm()
    assert not f.enabled and f.fire("engine_step_raise") is None


def test_fire_emits_a_trace_instant():
    TRACER.enable()
    TRACER.clear()
    try:
        f = Faults()
        f.arm("seed=1;cache_corrupt@1")
        assert f.fire("cache_corrupt", key=3) == {"point": "cache_corrupt"}
        [ev] = [e for e in TRACER.events() if e["name"] == "fault.inject"]
        assert ev["ph"] == "i" and ev["args"] == {"point": "cache_corrupt", "key": 3}
    finally:
        TRACER.disable()
        TRACER.clear()


# ---------------------------------------------------------------------------
# engine: the nonfinite guard
# ---------------------------------------------------------------------------


def test_injected_nonfinite_logits_retire_numeric_error():
    router = port_router()
    FAULTS.arm("seed=1;nonfinite_logits@1")
    tickets = [router.submit(p, max_new=6) for p in prompts_for(4)]
    router.drain()
    statuses = [t.status for t in tickets]
    assert statuses == ["numeric_error", "done", "done", "done"], statuses
    assert tickets[0].reason == "nonfinite_logits" and tickets[0].tokens == []
    assert router.report()["numeric_errors"] == 1


def test_real_nan_state_trips_the_isfinite_guard():
    """A full-hit entry whose stored FP8 state is NaN is injected into a
    lane; the next step's logits are NaN and the request retires as
    numeric_error, its partial tokens valid and its state never cached."""
    cache = PrefixCache(block=4)
    router = port_router(prefix_cache=cache)
    prompt = np.arange(1, 9, dtype=np.int32)
    warm = router.submit(prompt, max_new=4)
    router.drain()
    assert warm.status == "done"
    entry = cache._entry_at(prompt, len(prompt))
    assert entry is not None and entry.next_token is not None
    nan_states = tree_map(lambda a: torch.full_like(a.float(), float("nan")), entry.states_fp8)
    cache.insert(prompt, nan_states, next_token=entry.next_token)
    inserts = cache.insertions
    poisoned = router.submit(prompt, max_new=4)
    router.drain()
    assert poisoned.status == "numeric_error"
    assert poisoned.tokens == [entry.next_token]  # the replayed first token only
    assert router.report()["numeric_errors"] == 1
    assert cache.insertions == inserts


# ---------------------------------------------------------------------------
# prefix cache: corrupt-as-miss
# ---------------------------------------------------------------------------


def test_cache_corruption_detected_as_miss_and_evicted():
    cache = PrefixCache(block=4)
    key = np.arange(8, dtype=np.int32)
    states = [LSTMState(torch.ones(4), torch.ones(4, dtype=torch.float16))]
    FAULTS.arm("seed=1;cache_corrupt%1.0")
    cache.insert(key, states, next_token=7)
    FAULTS.disarm()
    assert cache.lookup(key) is None
    s = cache.stats()
    assert s["corruptions"] == 1 and s["misses"] == 1 and s["hits"] == 0
    assert len(cache) == 0
    cache.lookup(key)
    assert cache.stats()["corruptions"] == 1
    cache.insert(key, states, next_token=7)  # disarmed: a clean insert hits
    hit = cache.lookup(key)
    assert hit is not None and hit.next_token == 7 and cache.stats()["corruptions"] == 1


# ---------------------------------------------------------------------------
# router: ejection, resubmission, reinstatement
# ---------------------------------------------------------------------------


def _serve(plan, ps, cache=False, **kw):
    router = port_router(replicas=2, prefix_cache=PrefixCache(block=4) if cache else None, **kw)
    if plan:
        FAULTS.arm(plan)
    try:
        ts = [router.submit(p, max_new=6) for p in ps]
        router.drain()
        return ts, router.stats(), router
    finally:
        FAULTS.disarm()


def test_replica_crash_ejects_resubmits_and_matches_fault_free_tokens():
    ps = prompts_for(8, seed=3)
    ref, _, _ = _serve(None, ps)
    got, stats, router = _serve("seed=1;replica_crash@2:key=1", ps)
    assert [t.status for t in got] == ["done"] * 8
    assert stats["ejections"] == 1 and stats["healthy_replicas"] == 1
    assert stats["replica_health"][1]["healthy"] is False
    assert stats["faults"]["injected"] == {"replica_crash": 1}
    assert stats["resubmits"] > 0
    assert router.engines[1].metrics.retired == 0  # its work finished on replica 0
    for a, b in zip(ref, got):
        assert a.tokens == b.tokens


def test_transient_failures_eject_then_probe_reinstates():
    router = port_router(replicas=2, router_kw={"eject_after": 2, "probe_every": 3})
    FAULTS.arm("seed=1;engine_step_raise%1.0:key=1:n=2")
    tickets = [router.submit(p, max_new=6) for p in prompts_for(8, seed=5)]
    router.drain()
    FAULTS.disarm()
    assert [t.status for t in tickets] == ["done"] * 8
    assert router.stats()["ejections"] == 1
    more = [router.submit(p, max_new=6) for p in prompts_for(4, seed=6)]
    router.drain()
    assert [t.status for t in more] == ["done"] * 4
    stats = router.stats()
    assert stats["reinstatements"] >= 1 and stats["healthy_replicas"] == 2


def test_no_healthy_replicas_rejects_at_intake():
    router = port_router(replicas=1)
    FAULTS.arm("seed=1;replica_crash@1")
    t = router.submit(prompts_for(1)[0], max_new=3)
    router.drain()  # ejected on the crash; the resubmitted request has nowhere to go
    assert t.status == "rejected" and t.reason == "no_healthy_replicas"
    assert router.stats()["healthy_replicas"] == 0
    late = router.submit(prompts_for(1, seed=1)[0], max_new=3)
    assert late.status == "rejected" and late.reason == "no_healthy_replicas"


@pytest.fixture(scope="module")
def chaos_jax():
    """The combined chaos plan through the JAX package's router."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    router = JRouter.build(JLM(vocab=V, emb=D, hidden=D), params, JPOL, replicas=2,
                           prefix_cache=JPrefixCache(block=4), lanes=2, chunk=4)
    JFAULTS.arm(CHAOS)
    try:
        ts = [router.submit(p, max_new=6) for p in _chaos_prompts()]
        router.drain()
        faults = JFAULTS.stats()
    finally:
        JFAULTS.disarm()
    return ts, router.stats(), router.report(), router.prefix_cache.stats(), faults


def _chaos_prompts():
    # three prompts of one chunk, each served four times: every insert at
    # the end of a prefill is a full entry that the repeats look up, so the
    # corrupted second insert is read
    base = prompts_for(3, seed=9, lo=4, hi=5)
    return [base[i % 3].copy() for i in range(12)]


def test_chaos_plan_outcome_equals_the_reference(chaos_jax):
    jts, jstats, jrep, jcache, jfaults = chaos_jax
    ts, stats, router = _serve(CHAOS, _chaos_prompts(), cache=True)
    faults = stats["faults"]
    assert faults["injected"] == jfaults["injected"] == {
        "replica_crash": 1, "cache_corrupt": 1, "nonfinite_logits": 1}
    assert faults["arrivals"] == jfaults["arrivals"]
    assert [h["healthy"] for h in stats["replica_health"]] == \
        [h["healthy"] for h in jstats["replica_health"]] == [True, False]
    for key in ("ejections", "resubmits", "healthy_replicas"):
        assert stats[key] == jstats[key], key
    assert [t.status for t in ts] == [t.status for t in jts]
    assert [t.status for t in ts].count("numeric_error") == 1
    cstats = router.prefix_cache.stats()
    for key in ("corruptions", "hits", "full_hits", "misses", "insertions"):
        assert cstats[key] == jcache[key], key
    assert cstats["corruptions"] == 1
    rep = router.report()
    for key in ("requests", "steps", "prefill_steps", "cache_hits", "numeric_errors"):
        assert rep[key] == jrep[key], key
    for t, j in zip(ts, jts):
        n = next((i for i, g in enumerate(t.req.margins) if g <= MARGIN_FLOOR), len(t.tokens))
        assert t.tokens[:n] == j.tokens[:n], (t.rid, t.tokens, j.tokens)
    assert not FAULTS.enabled


# ---------------------------------------------------------------------------
# checkpointing: the torn write
# ---------------------------------------------------------------------------


def test_torn_checkpoint_invisible_and_resavable(tmp_path):
    path = str(tmp_path)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    ckpt.save(path, tree, step=1)
    FAULTS.arm("seed=1;ckpt_torn_write@1")
    with pytest.raises(InjectedFault):
        ckpt.save(path, {"w": torch.arange(6, dtype=torch.float32) * 2}, step=2)
    FAULTS.disarm()
    assert (tmp_path / "step_00000002.tmp").is_dir()
    assert ckpt.latest_step(path) == 1
    out, step = ckpt.restore(path, tree)
    assert step == 1 and torch.equal(out["w"], torch.arange(6, dtype=torch.float32))
    ckpt.save(path, {"w": torch.arange(6, dtype=torch.float32) * 2}, step=2)
    assert ckpt.latest_step(path) == 2
    out, _ = ckpt.restore(path, tree)
    assert torch.equal(out["w"], torch.arange(6, dtype=torch.float32) * 2)


def test_metrics_report_safe_when_every_request_errored():
    m = ServeMetrics(lanes=2)
    m.start()
    m.on_step(width=1, active=2, useful=2, any_prefill=False)
    for _ in range(3):
        m.on_numeric_error(req=None)
    m.stop()
    rep = m.report()
    assert rep["numeric_errors"] == 3 and rep["requests"] == 0
    assert m.per_tenant() == {} and rep["gen_tok_per_s"] >= 0.0
    assert 0.0 <= m.slot_util <= 1.0
