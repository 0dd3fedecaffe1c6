"""The port's serving frontend against the JAX package, at a tiny size: the
FP8 prefix cache (trie, LRU, upgrade, snapshot bytes and CRC), the state
pool's FP8 snapshots, the zipf-prefix workload generator, the router
(rejections, deadlines, least-loaded dispatch, streaming callbacks, the
per-tenant report, the asyncio facade) and the warm-cache acceptance run.

Model: WikiText2LM with vocab 512, emb = hidden = 64, 2 layers, policy
floatsd8_table6; parameters made with numpy from a seed (weights scaled so
that greedy margins are decisive) and handed to both packages.

Tolerances:
  * FP8 snapshot bytes and ``entry_checksum``: equal to the reference's;
  * the FP8 round trip: within e4m3's 2^-4 relative step (+ 2^-10
    absolute for the subnormals), the pool dtypes restored;
  * greedy tokens: equal to the JAX engine's over each request's
    margin-decisive prefix (the port's top-2 gap above 1e-4, as in
    tests/test_torch_serve.py); prefill steps, hits and full hits equal.
  * The reference's own warm-equals-cold assertion fails (one FP8-rounded
    state flips a narrow-margin token), so warm-against-cold agreement is
    reported by both packages and the port's must equal the reference's.
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
from repro.nn.lstm import LSTMState as JState  # noqa: E402
from repro.serving import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import StatePool as JStatePool  # noqa: E402
from repro.serving import synthetic_prompts as j_synthetic_prompts  # noqa: E402
from repro.serving import zipf_prefix_prompts as j_zipf_prefix_prompts  # noqa: E402
from repro.serving.frontend.prefix_cache import entry_checksum as j_entry_checksum  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.nn.lstm import LSTMState  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncRouter, PrefixCache, Router, ServeEngine, StatePool, synthetic_prompts,
    zipf_prefix_prompts,
)
from repro_torch.serving.frontend import entry_checksum  # noqa: E402

V, D = 512, 64
MARGIN_FLOOR = 1e-4
JPOL = jget_policy("floatsd8_table6")
TPOL = tget_policy("floatsd8_table6")
ZIPF = dict(n_prefixes=3, prefix_len=16, suffix_lo=2, suffix_hi=6, prefix_seed=7)
LANES, CHUNK, MAX_NEW = 4, 8, 6


def np_params(seed=0):
    """Seeded numpy parameters in the reference layout; weights scaled up
    from the init so that greedy margins are decisive."""
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


def port_engine(policy=TPOL, **kw):
    return ServeEngine(TLM(vocab=V, emb=D, hidden=D), _PORT_PARAMS, policy, **kw)


def fake_states(seed=0, hidden=4):
    """A lane-snapshot-shaped tree: two layers of (h f32, c f16)."""
    r = np.random.default_rng(seed)
    return [LSTMState(torch.from_numpy(r.normal(size=hidden).astype(np.float32)),
                      torch.from_numpy(r.normal(size=hidden).astype(np.float16)))
            for _ in range(2)]


def edge_states(hidden=64, seed=0):
    """numpy (h f32, c f16) per layer with e4m3's edges: ties between two
    FP8 values, saturation past 448, subnormals and signed zero."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        h = (r.standard_normal(hidden) * 4).astype(np.float32)
        h[:8] = [1.0625, 1.1875, 500.0, -1e4, 2.0**-9, -2.0**-10, -0.0, 448.0]
        c = (r.standard_normal(hidden) * 2).astype(np.float16)
        c[:4] = [np.float16(3.25), np.float16(-600.0), np.float16(2.0**-8), np.float16(0.0)]
        out.append((h, c))
    return out


# ---------------------------------------------------------------------------
# prefix cache: trie, LRU, upgrade (the cases of tests/test_frontend.py)
# ---------------------------------------------------------------------------


def test_prefix_cache_longest_prefix_lookup():
    cache = PrefixCache(block=4)
    seq = np.arange(20, dtype=np.int32)
    cache.insert(seq[:8], fake_states(1))
    cache.insert(seq[:16], fake_states(2))
    hit = cache.lookup(seq)
    assert hit is not None and hit.match_len == 16 and hit.next_token is None
    div = seq.copy()
    div[12] += 1
    assert cache.lookup(div).match_len == 8
    assert cache.lookup(np.arange(5, 25, dtype=np.int32)) is None
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 2
    # the remaining-work probe has no side effects
    before = cache.stats()
    assert cache.match_len(seq) == 16 and cache.match_len(div) == 8
    assert cache.stats() == before


def test_prefix_cache_full_hit_requires_next_token():
    cache = PrefixCache(block=4)
    seq = np.arange(12, dtype=np.int32)
    cache.insert(seq[:8], fake_states(1))
    cache.insert(seq, fake_states(2))
    hit = cache.lookup(seq)
    assert hit.match_len == 8 and not hit.full
    cache.insert(seq, fake_states(2), next_token=42)
    hit = cache.lookup(seq)
    assert hit.match_len == 12 and hit.full and hit.next_token == 42
    hit = cache.lookup(np.concatenate([seq, np.asarray([7], np.int32)]))
    assert hit.match_len == 12 and hit.next_token is None


def test_prefix_cache_fp8_storage_and_dtype_restore():
    cache = PrefixCache(block=4)
    states = fake_states(3)
    cache.insert(np.arange(8, dtype=np.int32), states)
    entry = next(iter(cache._lru.values()))
    for leaf in tree_leaves(entry.states_fp8):
        assert leaf.dtype == torch.float8_e4m3fn and leaf.device.type == "cpu"
    hit = cache.lookup(np.arange(9, dtype=np.int32))
    assert hit.match_len == 8
    for got, want in zip(tree_leaves(hit.states), tree_leaves(states)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2**-4,
                                   atol=2**-10)


def test_prefix_cache_lru_eviction_under_byte_budget():
    per_entry = 2 * (64 + 64) + 8 * 4  # fp8 payload + key tokens

    def ext(k):
        return np.concatenate([k, np.asarray([9999], np.int32)])

    cache = PrefixCache(budget_bytes=3 * per_entry, block=4)
    keys = [np.arange(i * 100, i * 100 + 8, dtype=np.int32) for i in range(5)]
    for i, k in enumerate(keys[:3]):
        cache.insert(k, fake_states(i, hidden=64))
    assert len(cache) == 3 and cache.nbytes == 3 * per_entry
    cache.lookup(ext(keys[0]))
    cache.insert(keys[3], fake_states(3, hidden=64))
    assert cache.stats()["evictions"] == 1
    assert cache.lookup(ext(keys[1])) is None
    assert cache.lookup(ext(keys[0])) is not None
    assert cache.nbytes <= cache.budget_bytes


def test_prefix_cache_upgrades_block_snapshot_with_next_token():
    cache = PrefixCache(block=8)
    seq = np.arange(16, dtype=np.int32)
    cache.insert(seq[:8], fake_states(0))
    assert cache.lookup(seq[:8]) is None
    assert cache.wants(seq[:8], 8)
    cache.insert(seq[:8], fake_states(0), next_token=5)
    hit = cache.lookup(seq[:8])
    assert hit.full and hit.next_token == 5
    assert not cache.wants(seq[:8], 8) and len(cache) == 1


def test_prefix_cache_wants_snapshot_block_alignment():
    cache = PrefixCache(block=8)
    seq = np.arange(24, dtype=np.int32)
    assert not cache.wants_snapshot(seq, 4)
    assert not cache.wants_snapshot(seq, 0)
    assert cache.wants_snapshot(seq, 8) and cache.wants_snapshot(seq, 16)
    cache.insert(seq[:8], fake_states(0))
    assert not cache.wants_snapshot(seq, 8)
    assert cache.wants(seq, 24) and not cache.wants(seq, 0)


# ---------------------------------------------------------------------------
# FP8 bytes and CRC against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("next_token", [None, 0, 4321])
def test_entry_bytes_and_checksum_equal_the_reference(next_token):
    """The same state inserted into both packages' caches: the FP8 leaves
    hold the same bytes (ties, saturation, subnormals included), and
    ``entry_checksum`` gives the reference's number."""
    st = edge_states()
    key = np.arange(10, dtype=np.int32)
    jc, tc = JPrefixCache(block=4), PrefixCache(block=4)
    jc.insert(key, [JState(jnp.asarray(h), jnp.asarray(c)) for h, c in st],
              next_token=next_token)
    tc.insert(key, [LSTMState(torch.from_numpy(h), torch.from_numpy(c)) for h, c in st],
              next_token=next_token)
    je, te = next(iter(jc._lru.values())), next(iter(tc._lru.values()))
    jl = jax.tree_util.tree_leaves(je.states_fp8)
    tl = tree_leaves(te.states_fp8)
    assert len(jl) == len(tl) == 4
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                      b.view(torch.uint8).numpy())
    assert te.checksum == je.checksum == j_entry_checksum(je.states_fp8, next_token)
    assert entry_checksum(te.states_fp8, next_token) == te.checksum
    assert te.nbytes == je.nbytes
    # the dequantized hit equals the reference's value for value
    jh, th = jc.lookup(np.arange(11)), tc.lookup(np.arange(11))
    for a, b in zip(jax.tree_util.tree_leaves(jh.states), tree_leaves(th.states)):
        assert str(b.dtype).endswith(str(a.dtype))
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_state_pool_snapshot_fp8_bytes_equal_the_reference():
    st = edge_states(seed=1)
    lanes = 3
    r = np.random.default_rng(2)
    full = [(np.stack([r.standard_normal(64).astype(np.float32), h, h * 0.5]),
             np.stack([r.standard_normal(64).astype(np.float16), c, c])) for h, c in st]
    jpool = JStatePool([JState(jnp.asarray(h), jnp.asarray(c)) for h, c in full], lanes)
    tpool = StatePool([LSTMState(torch.from_numpy(h), torch.from_numpy(c)) for h, c in full], lanes)
    jsnap, jdt = jpool.snapshot_fp8(1)
    tsnap, tdt = tpool.snapshot_fp8(1)
    for a, b in zip(jax.tree_util.tree_leaves(jsnap), tree_leaves(tsnap)):
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                      b.view(torch.uint8).numpy())
    assert [str(d) for d in tree_leaves(tdt)] == ["torch.float32", "torch.float16"] * 2
    assert [str(d) for d in jax.tree_util.tree_leaves(jdt)] == ["float32", "float16"] * 2


def test_snapshot_fp8_inject_fp8_round_trip():
    lanes, hidden = 3, 64
    r = np.random.default_rng(4)
    caches = [LSTMState(torch.from_numpy(r.standard_normal((lanes, hidden)).astype(np.float32)),
                        torch.from_numpy(r.standard_normal((lanes, hidden)).astype(np.float16)))
              for _ in range(2)]
    pool = StatePool([LSTMState(s.h.clone(), s.c.clone()) for s in caches], lanes)
    snap, dtypes = pool.snapshot_fp8(1)
    assert all(x.dtype == torch.float8_e4m3fn and x.shape == (hidden,) for x in tree_leaves(snap))
    pool.reset(np.array([0, 1, 0]))
    assert float(pool.caches[0].h[1].abs().sum()) == 0
    pool.inject_fp8(1, snap, dtypes)
    for got, want in zip(pool.caches, caches):
        for g, w in ((got.h, want.h), (got.c, want.c)):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g[1].float().numpy(), w[1].float().numpy(), rtol=2**-4,
                                       atol=2**-10)
            # the lane equals the FP8 value exactly, and the neighbours are untouched
            assert torch.equal(g[1], w[1].to(torch.float8_e4m3fn).to(w.dtype))
            assert torch.equal(g[0], w[0]) and torch.equal(g[2], w[2])
    with pytest.raises(ValueError, match="out of range"):
        pool.inject_fp8(3, snap, dtypes)


# ---------------------------------------------------------------------------
# workload generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), ZIPF, dict(n_prefixes=5, prefix_len=24, alpha=1.5)])
def test_zipf_prefix_prompts_identical_to_the_reference(kw):
    got = zipf_prefix_prompts(20, V, np.random.default_rng(3), **kw)
    want = j_zipf_prefix_prompts(20, V, np.random.default_rng(3), **kw)
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    a = synthetic_prompts(7, V, np.random.default_rng(5))
    b = j_synthetic_prompts(7, V, np.random.default_rng(5))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


def test_router_backpressure_and_rejection_reasons():
    eng = port_engine(lanes=2)
    router = Router([eng], max_queue=2, tenant_quota=2)
    ok1 = router.submit(np.ones(3, np.int32), max_new=1, tenant="a")
    ok2 = router.submit(np.ones(3, np.int32), max_new=1, tenant="b")
    full = router.submit(np.ones(3, np.int32), max_new=1, tenant="a")
    assert ok1.ok and ok2.ok
    assert full.status == "rejected" and full.reason == "queue_full"
    bad = Router([eng], max_queue=8).submit(np.zeros(0, np.int32), max_new=1)
    assert bad.status == "rejected" and bad.reason == "bad_request"
    r2 = Router([port_engine(lanes=2)], max_queue=8, tenant_quota=1)
    a1 = r2.submit(np.ones(3, np.int32), max_new=1, tenant="a")
    a2 = r2.submit(np.ones(3, np.int32), max_new=1, tenant="a")
    b1 = r2.submit(np.ones(3, np.int32), max_new=1, tenant="b")
    assert a1.ok and b1.ok
    assert a2.status == "rejected" and a2.reason == "tenant_quota"
    assert r2.tenants["a"]["rejected"] == 1 and r2.tenants["b"]["rejected"] == 0


def test_router_deadline_expired_rejected_at_dispatch():
    router = Router([port_engine(lanes=2)], admission="edf")
    dead = router.submit(np.ones(3, np.int32), max_new=1, deadline=time.monotonic() - 1.0)
    live = router.submit(np.ones(3, np.int32), max_new=2)
    router.drain()
    assert dead.status == "rejected" and dead.reason == "deadline_expired"
    assert live.status == "done" and len(live.tokens) == 2
    assert router.rejections == {"deadline_expired": 1}


def test_router_queue_pressure_purges_expired_before_rejecting():
    router = Router([port_engine(lanes=2)], max_queue=2, admission="edf")
    far = time.monotonic() + 1e3
    t1 = router.submit(np.ones(3, np.int32), max_new=1, deadline=far)
    t2 = router.submit(np.ones(3, np.int32), max_new=1)
    t2.req.deadline = time.monotonic() - 1.0  # expired while queued
    t3 = router.submit(np.ones(3, np.int32), max_new=1, deadline=far)
    assert t1.ok and t3.ok
    assert t2.status == "rejected" and t2.reason == "deadline_expired"
    doa = router.submit(np.ones(3, np.int32), max_new=1, deadline=time.monotonic() - 1.0)
    assert doa.status == "rejected" and doa.reason == "deadline_expired"
    router.drain()
    assert t1.status == "done" and t3.status == "done"


def test_router_streaming_callbacks_and_per_tenant_report():
    router = Router([port_engine(lanes=2, chunk=4)])
    rng = np.random.default_rng(0)
    streamed, tickets = {}, []
    for i in range(5):
        streamed[i] = []
        tickets.append(router.submit(rng.integers(0, V, 6).astype(np.int32), max_new=4,
                                     tenant=("a", "b")[i % 2], on_token=streamed[i].append))
    router.drain()
    for i, t in enumerate(tickets):
        assert t.status == "done" and streamed[i] == t.tokens and len(t.tokens) == 4
    rep = router.report()
    assert rep["requests"] == 5 and rep["replicas"] == 1
    assert rep["tenants"]["a"]["completed"] == 3 and rep["tenants"]["b"]["completed"] == 2
    assert rep["tenants"]["a"]["tokens"] == 12
    assert all(rep["tenants"][t]["ttft_p95_s"] <= rep["tenants"][t]["latency_p95_s"]
               for t in ("a", "b"))
    assert rep["ttft_hist_ms"]["count"] == 5 and sum(rep["ttft_hist_ms"]["counts"]) == 5
    assert set(rep["phases"]) == {"queue", "prefill", "decode"}
    assert router.stats()["free_lanes"] == 2 and router.idle


def test_router_least_loaded_across_replicas():
    engines = [port_engine(lanes=2, chunk=4) for _ in range(2)]
    router = Router(engines)
    rng = np.random.default_rng(1)
    for _ in range(6):
        router.submit(rng.integers(0, V, 6).astype(np.int32), max_new=3)
    router._dispatch()
    # least-loaded, ties to the lowest index: two requests each, the rest queued
    assert [len(e.scheduler) for e in engines] == [2, 2] and len(router._queue) == 2
    router.drain()
    done = [len(e.metrics.records) for e in engines]
    assert sum(done) == 6 and all(n >= 2 for n in done), done


def test_async_router_concurrent_generate_and_stream():
    router = Router([port_engine(lanes=2, chunk=4)])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, 5).astype(np.int32) for _ in range(3)]

    async def main():
        ar = AsyncRouter(router)

        async def consume_stream():
            return [tok async for tok in ar.stream(prompts[2], max_new=3)]

        t1, t2, toks = await asyncio.gather(ar.generate(prompts[0], max_new=3),
                                            ar.generate(prompts[1], max_new=3), consume_stream())
        first = None
        async for tok in ar.stream(prompts[0], max_new=8):
            first = tok
            break
        await ar.join()
        return t1, t2, toks, first

    t1, t2, toks, first = asyncio.run(main())
    assert t1.status == "done" and len(t1.tokens) == 3
    assert t2.status == "done" and len(t2.tokens) == 3
    assert len(toks) == 3 and first == t1.tokens[0]
    assert router.idle and router.cancellations == {"abandoned": 1}


# ---------------------------------------------------------------------------
# acceptance: the zipf-prefix workload, warm against cold, port against JAX
# ---------------------------------------------------------------------------


def _zipf_runs(make_engine, make_cache):
    warmup = zipf_prefix_prompts(16, V, np.random.default_rng(1), **ZIPF)
    measure = zipf_prefix_prompts(16, V, np.random.default_rng(2), **ZIPF)

    def serve(prompts, cache):
        eng = make_engine(cache)
        reqs = eng.submit_all([p.copy() for p in prompts], max_new=MAX_NEW)
        m = eng.run()
        return sorted(reqs, key=lambda r: r.rid), m

    cold = serve(measure, None)
    cache = make_cache()
    serve(warmup, cache)
    warm = serve(measure, cache)
    return cold, warm


@pytest.fixture(scope="module")
def zipf_jax():
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    model = JLM(vocab=V, emb=D, hidden=D)
    return _zipf_runs(
        lambda cache: JEngine(model, params, JPOL, lanes=LANES, chunk=CHUNK, prefix_cache=cache),
        lambda: JPrefixCache(block=CHUNK))


def _decisive(req) -> int:
    return next((i for i, g in enumerate(req.margins) if g <= MARGIN_FLOOR), len(req.out))


def test_zipf_warm_cache_matches_the_jax_engine(zipf_jax):
    (jcold, jcm), (jwarm, jwm) = zipf_jax
    (tcold, tcm), (twarm, twm) = _zipf_runs(
        lambda cache: port_engine(lanes=LANES, chunk=CHUNK, prefix_cache=cache),
        lambda: PrefixCache(block=CHUNK))
    # the acceptance bar's step and hit criteria, in both packages
    for cm, wm in ((tcm, twm), (jcm, jwm)):
        assert wm.prefill_steps <= 0.7 * cm.prefill_steps, (wm.prefill_steps, cm.prefill_steps)
        assert wm.prefill_tokens_saved > 0 and wm.cache_hit_rate > 0.5
    # the same schedule: steps, hits and full hits
    for key in ("steps", "prefill_steps", "decode_steps", "cache_lookups", "cache_hits",
                "cache_full_hits", "prefill_tokens_saved", "prompt_tokens", "emitted"):
        assert getattr(twm, key) == getattr(jwm, key), key
        assert getattr(tcm, key) == getattr(jcm, key), key
    # the tokens over each request's margin-decisive prefix, cold and warm
    decisive = 0
    for treqs, jreqs in ((tcold, jcold), (twarm, jwarm)):
        for t, j in zip(treqs, jreqs):
            n = _decisive(t)
            assert t.out[:n] == j.out[:n], (t.rid, t.out, j.out, n)
            assert t.cache_saved_tokens == j.cache_saved_tokens
            decisive += n
    assert decisive >= 2 * 16 * MAX_NEW * 3 // 4
    # warm against cold: reported by both packages, never more agreement
    # claimed for the port than the reference shows
    t_agree = sum(a.out == b.out for a, b in zip(tcold, twarm))
    j_agree = sum(a.out == b.out for a, b in zip(jcold, jwarm))
    print(f"warm-vs-cold streams equal: port {t_agree}/16, reference {j_agree}/16")
    assert t_agree == j_agree


# ---------------------------------------------------------------------------
# dense (packed=False) serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["floatsd8_table6", "fp32"])
def test_dense_serving_matches_the_jax_engine(policy):
    """packed=False serves the dense weights through the fake-quant-at-use
    path, under the FloatSD8 policy and under one without FloatSD8 weights
    (which the packed engine refuses, in both packages)."""
    prompts = synthetic_prompts(4, V, np.random.default_rng(8), lo=2, hi=11)
    jpol, tpol = jget_policy(policy), tget_policy(policy)
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    jeng = JEngine(JLM(vocab=V, emb=D, hidden=D), params, jpol, lanes=2, chunk=4, packed=False)
    jreqs = jeng.submit_all([p.copy() for p in prompts], max_new=MAX_NEW)
    jm = jeng.run()
    eng = port_engine(policy=tpol, lanes=2, chunk=4, packed=False)
    reqs = eng.submit_all([p.copy() for p in prompts], max_new=MAX_NEW)
    m = eng.run()
    assert eng.store is None and m.steps == jm.steps and m.prefill_steps == jm.prefill_steps
    decisive = 0
    for t, j in zip(reqs, jreqs):
        n = _decisive(t)
        assert t.status == "done" and t.out[:n] == j.out[:n], (t.rid, t.out, j.out)
        decisive += n
    assert decisive >= len(prompts) * MAX_NEW // 2
    if policy == "fp32":
        with pytest.raises(ValueError, match="packed=True"):
            port_engine(policy=tpol, lanes=2)


def test_cli_frontend_and_dense_on_cpu(capsys):
    from repro_torch.launch import serve as tserve

    tserve.main(["--device", "cpu", "--frontend", "--replicas", "2", "--workload", "zipf-prefix",
                 "--requests", "6", "--max-new", "2", "--chunk", "4", "--tenants", "3",
                 "--admission", "sjf_work", "--preempt", "--admit-pace", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("frontend: 6 requests over 2 replica(s)") and "cache hit rate" in out[0]
    assert [line.split(":")[0].strip() for line in out[1:]] == ["tenant0", "tenant1", "tenant2"]
    tserve.main(["--device", "cpu", "--dense", "--policy", "fp32", "--requests", "2",
                 "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("served 2 requests, 4 tokens")
    with pytest.raises(SystemExit, match="--frontend serves LSTM-family models"):
        tserve.main(["--device", "cpu", "--frontend", "--arch", "rwkv6_3b"])


def test_cli_frontend_exits_1_when_every_replica_is_ejected(monkeypatch, capsys):
    """A step that keeps failing (a kernel that does not launch, say) ejects
    every replica; the CLI then exits 1 with each replica's last error
    instead of reporting the rejected backlog as load shedding."""
    from repro_torch.launch import serve as tserve

    def broken_step(self):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ServeEngine, "step_once", broken_step)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--frontend", "--replicas", "2", "--requests", "3",
                     "--max-new", "2"])
    assert exc.value.code == 1
    cap = capsys.readouterr()
    assert "ejections 2" in cap.out and "'no_healthy_replicas': 3" in cap.out
    assert cap.err.splitlines() == [f"replica {i}: RuntimeError: kernel launch failed" for i in (0, 1)]


def test_cli_preempt_prints_its_counts_on_the_plain_path(capsys):
    """Every CLI request has the same --max-new, so no queue head owes less
    work than a decoding lane and preemption never fires; the CLI says so."""
    from repro_torch.launch import serve as tserve

    tserve.main(["--device", "cpu", "--admission", "sjf_work", "--preempt", "--requests", "3",
                 "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("served 3 requests, 6 tokens") and out[-1] == "preemptions 0, resumes 0"
