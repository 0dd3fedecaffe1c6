"""The port's HTTP/SSE service (``serving/http/``), the router pieces it
calls (``Router.note_retry``/``scrape``, ``AsyncRouter.cancel``/``snapshot``)
and the CLI's ``--http``, on the CPU: the cases of ``tests/test_http.py`` and
the two HTTP cases of ``tests/test_cancel.py`` on the port's engine, and:

  * tokens over the port's sockets equal the JAX ``Router``'s in-process
    tokens for the same weights (carried across by ``bridge.py``): 100%;
  * ``protocol``'s parsing and its JSON and SSE framing are byte for byte the
    reference's on the same inputs;
  * ``render_metrics`` gives the reference's text on the same dicts, but for
    the three lines ``prometheus.py`` names (the shared-memory gauge, the
    HELP of the predicted-read counter and of the dispatch counter);
  * the drain test passes with both clients still connected (the server
    closes its connections before ``wait_closed``);
  * every reject reason maps to its status, ``no_healthy_replicas`` to 503
    when every replica's step fails;
  * ``/metrics`` carries the cost ledger, ``/admin/trace`` its ``cost.<op>``
    counter tracks.

Model: WikiText2LM, vocab 300, emb = hidden = 32, 2 layers, floatsd8_table6,
parameters made with numpy from a seed (weights scaled so that greedy
margins are decisive). Every socket coroutine runs under
``asyncio.wait_for(..., 60)``, so a hang fails its test, not the suite.
"""
import asyncio
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.serving import Router as JRouter  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving.frontend import AsyncRouter as JAsyncRouter  # noqa: E402
from repro.serving.http import prometheus as j_prom  # noqa: E402
from repro.serving.http import protocol as j_protocol  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.faults import FAULTS  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.models import WikiText2LM  # noqa: E402
from repro_torch.obs.trace import TRACER  # noqa: E402
from repro_torch.serving import AsyncRouter, PrefixCache, Router, ServeEngine  # noqa: E402
from repro_torch.serving.http import REASON_STATUS, Client, HttpError, HttpServer, render_metrics  # noqa: E402
from repro_torch.serving.http import protocol  # noqa: E402
from repro_torch.serving.http.protocol import HttpRequest, ProtocolError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V, D = 300, 32
POLICY = get_policy("floatsd8_table6")
TIMEOUT = 60


def np_params(seed=0):
    """Seeded numpy parameters in the reference layout; weights scaled up
    from the init so that greedy margins are decisive."""
    rng = np.random.default_rng(seed)
    s = 3.0 / np.sqrt(D)
    p = {"embed": {"table": (rng.standard_normal((V, D)) * 0.5).astype(np.float32)}}
    for i in range(2):
        b = np.zeros(4 * D, np.float32)
        b[D:2 * D] = 1.0
        p[f"lstm{i}"] = {"wx": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
                         "wh": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32), "b": b}
    return p


PARAMS = bridge.from_jax_params(np_params(), "cpu")


def make_router(replicas=1, lanes=2, chunk=4, cache=None, **router_kw):
    engines = [ServeEngine(WikiText2LM(vocab=V, emb=D, hidden=D), PARAMS, POLICY, lanes=lanes, chunk=chunk,
                           prefix_cache=cache) for _ in range(replicas)]
    return Router(engines, **router_kw)


def prompts_for(n, length=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, length).astype(np.int32) for _ in range(n)]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


async def start_server(router, **kw):
    server = await HttpServer(router, port=0, **kw).start()
    return server, asyncio.create_task(server.serve_forever())


async def stop_server(server, task):
    server.shutdown()
    await asyncio.wait_for(task, timeout=30)


def _counter(text, name, labels=""):
    m = re.search(rf"^{re.escape(name + labels)} (\d+)$", text, re.MULTILINE)
    return int(m.group(1)) if m else 0


_SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [-+]?[0-9.e+-]+(e[+-]?\d+)?$")


def parse_prometheus(text) -> dict:
    samples = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ")), line
            continue
        assert _SAMPLE_RE.match(line), line
        name_labels, value = line.rsplit(" ", 1)
        samples[name_labels] = float(value)
    return samples


# ---------------------------------------------------------------------------
# tokens over the sockets against the JAX router in-process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX AsyncRouter's tokens for the test prompts, the same weights."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    eng = JEngine(JLM(vocab=V, emb=D, hidden=D), params, jget_policy("floatsd8_table6"), lanes=2, chunk=4)
    ar = JAsyncRouter(JRouter([eng]))

    async def go():
        return [await ar.generate(p, max_new=5) for p in prompts_for(4, seed=3)]

    return [t.tokens for t in asyncio.run(go())]


def test_generate_and_stream_over_sockets_equal_the_jax_router(jax_tokens):
    prompts = prompts_for(4, seed=3)

    async def main():
        server, task = await start_server(make_router())
        try:
            async with Client(server.host, server.port) as c:
                gen = [await c.generate(p, max_new=5) for p in prompts[:2]]
                streamed = []
                for p in prompts[2:]:
                    streamed.append([d["token"] async for e, d in c.stream(p, max_new=5) if e == "message"])
            ar = AsyncRouter(make_router())
            inproc = [(await ar.generate(p, max_new=5)).tokens for p in prompts]
            return gen, streamed, inproc
        finally:
            await stop_server(server, task)

    gen, streamed, inproc = run(main())
    socket_tokens = [r["tokens"] for r in gen] + streamed
    assert socket_tokens == jax_tokens == inproc  # 100% agreement
    assert all(len(t) == 5 for t in socket_tokens)
    for r in gen:
        assert r["n_tokens"] == 5 and 0 <= r["ttft_ms"] <= r["latency_ms"] and r["tenant"] == "default"


def test_sse_stream_framing_and_generate_consistency():
    [prompt] = prompts_for(1, seed=4)

    async def main():
        server, task = await start_server(make_router())
        try:
            async with Client(server.host, server.port) as c:
                gen = await c.generate(prompt, max_new=4)
                events = [ev async for ev in c.stream(prompt, max_new=4)]
            reader, writer = await asyncio.open_connection(server.host, server.port)
            body = json.dumps({"prompt": prompt.tolist(), "max_new": 2})
            writer.write(("POST /v1/stream HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
            await writer.drain()
            raw = await reader.read()  # the server closes after the stream
            writer.close()
            return gen, events, raw
        finally:
            await stop_server(server, task)

    gen, events, raw = run(main())
    start, *token_events, done = events
    assert start[0] == "start" and isinstance(start[1]["rid"], int)
    assert done[0] == "done" and done[1]["n_tokens"] == 4
    assert [e for e, _ in token_events] == ["message"] * 4
    assert [d["index"] for _, d in token_events] == [0, 1, 2, 3]
    assert [d["token"] for _, d in token_events] == gen["tokens"]
    head, _, payload = raw.partition(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n")[0]
    assert b"content-type: text/event-stream" in head.lower() and b"connection: close" in head.lower()
    frames = [f for f in payload.decode().split("\n\n") if f]
    assert len(frames) == 4  # start + 2 tokens + done
    assert frames[0].startswith("event: start\ndata: ") and frames[-1].startswith("event: done\ndata: ")
    for f in frames[1:-1]:
        assert f.startswith("data: ")
        json.loads(f.split("data: ", 1)[1])


# ---------------------------------------------------------------------------
# reject reasons -> statuses; a failing step is never a 200
# ---------------------------------------------------------------------------


def test_reject_reasons_map_to_distinct_status_codes():
    assert len(set(REASON_STATUS.values())) == 4 and REASON_STATUS["no_healthy_replicas"] == 503

    async def rejected(router, call, **kw):
        server, task = await start_server(router, **kw)
        try:
            async with Client(server.host, server.port) as c:
                with pytest.raises(HttpError) as ei:
                    await call(c)
                return ei.value.status, ei.value.body["error"], server
        finally:
            await stop_server(server, task)

    async def main():
        out = {}
        out["queue_full"] = await rejected(make_router(max_queue=0), lambda c: c.generate([1, 2, 3], max_new=1))
        out["tenant_quota"] = await rejected(make_router(max_queue=8, tenant_quota=0),
                                             lambda c: c.generate([1, 2, 3], max_new=1, tenant="t0"))
        out["bad_request"] = await rejected(make_router(), lambda c: c.generate([], max_new=1))
        out["deadline_expired"] = await rejected(make_router(),
                                                 lambda c: c.generate([1, 2, 3], max_new=1, deadline_ms=-1000))
        server, task = await start_server(make_router())
        try:
            async with Client(server.host, server.port) as c:
                status, _, body = await c.request("POST", "/v1/generate", {"max_new": 1})
        finally:
            await stop_server(server, task)
        return out, status, body

    out, status, body = run(main())
    for reason, (st, err, _) in out.items():
        assert st == REASON_STATUS[reason] and err == reason
    assert len({st for st, _, _ in out.values()}) == 4
    assert status == 400 and "prompt" in json.loads(body)["detail"]


def test_queue_full_is_retried_with_backoff_and_counted():
    async def main():
        server, task = await start_server(make_router(max_queue=0), admit_retries=2, retry_backoff_s=0.001)
        try:
            async with Client(server.host, server.port) as c:
                with pytest.raises(HttpError) as ei:
                    await c.generate([1, 2, 3], max_new=1)
                return ei.value.status, await c.metrics(), server.router.stats()
        finally:
            await stop_server(server, task)

    status, text, stats = run(main())
    assert status == 503 and stats["retries"] == 2 and stats["rejections"] == {"queue_full": 3}
    assert _counter(text, "repro_retries_total") == 2


def test_failing_steps_answer_503_no_healthy_replicas_never_200(monkeypatch):
    """Every replica's step raises (a kernel that cannot run): the router
    ejects both, and the waiting request, its stream and new submissions
    are answered 503 no_healthy_replicas."""
    router = make_router(replicas=2, eject_after=1)

    def broken(*a, **k):
        raise RuntimeError("floatsd_matmul launch failed: cudaError 209")

    for e in router.engines:
        monkeypatch.setattr(e, "step_once", broken)
    [p] = prompts_for(1, seed=21)

    async def main():
        server, task = await start_server(router)
        try:
            async with Client(server.host, server.port) as c:
                with pytest.raises(HttpError) as gen_err:
                    await c.generate(p, max_new=3)
                with pytest.raises(HttpError) as stream_err:
                    async for _ in c.stream(p, max_new=3):
                        pass
                health = await c.healthz()
                return gen_err.value, stream_err.value, health
        finally:
            await stop_server(server, task)

    gen_err, stream_err, health = run(main())
    for err in (gen_err, stream_err):
        assert err.status == 503 and err.reason == "no_healthy_replicas"
    assert health["healthy_replicas"] == 0
    assert all("cudaError 209" in h["last_error"] for h in health["replica_health"])


def test_stream_rejected_after_admission_sends_error_event():
    long_p, short_p = prompts_for(2, seed=9)

    async def main():
        server, task = await start_server(make_router(lanes=1))
        try:
            blocker, victim = Client(server.host, server.port), Client(server.host, server.port)
            gen = blocker.stream(long_p, max_new=64)
            await gen.__anext__()  # start
            await gen.__anext__()  # first token: the one lane is busy for ~63 pumps
            try:
                with pytest.raises(HttpError) as ei:
                    async for _ in victim.stream(short_p, max_new=1, deadline_ms=5):
                        pass
                return ei.value.status, ei.value.body["error"]
            finally:
                async for _ in gen:
                    pass
                await blocker.close()
                await victim.close()
        finally:
            await stop_server(server, task)

    assert run(main()) == (504, "deadline_expired")


def test_protocol_errors_and_unknown_routes():
    async def main():
        server, task = await start_server(make_router())
        try:
            async with Client(server.host, server.port) as c:
                s1, _, _ = await c.request("GET", "/nope")
                s2, _, _ = await c.request("GET", "/v1/generate")  # wrong verb
                s3, _, _ = await c.request("GET", "/v1/requests/3")  # DELETE only
            reader, writer = await asyncio.open_connection(server.host, server.port)
            writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 4\r\n\r\n{oop")
            await writer.drain()
            line = await reader.readline()
            writer.close()
            return s1, s2, s3, line
        finally:
            await stop_server(server, task)

    s1, s2, s3, line = run(main())
    assert (s1, s2, s3) == (404, 405, 405) and b"400" in line


def test_protocol_request_parsing_units():
    req = HttpRequest(method="POST", target="/v1/generate?x=1", headers={"x-tenant": "a", "connection": "close"},
                      body=b'{"prompt": [1]}')
    assert req.path == "/v1/generate" and not req.keep_alive and req.json() == {"prompt": [1]}
    with pytest.raises(ProtocolError) as ei:
        HttpRequest("POST", "/", {}, b"[1, 2]").json()
    assert ei.value.status == 400
    with pytest.raises(ProtocolError):
        HttpRequest("POST", "/", {}, b"{nope").json()


RAW_REQUESTS = [
    b"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: 15\r\n\r\n{\"prompt\": [1]}",
    b"GET /healthz?verbose=1 HTTP/1.1\r\nX-Tenant:  acme \r\nConnection: close\r\n\r\n",
    b"",  # a clean close between requests
    b"GET / HTTP/2\r\n\r\n",
    b"GET /\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: nine\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: -1\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n",
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n",
    b"GET / HTTP/1.1\r\nno colon here\r\n\r\n",
    b"POST / HTTP/1.1\r\nContent-Length: 10\r\n\r\nshort",
]


def _parse(module, raw):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            r = await module.read_request(reader)
        except module.ProtocolError as e:
            return ("protocol", e.status, e.detail)
        except ConnectionError as e:
            return ("connection", str(e))
        return None if r is None else (r.method, r.target, r.headers, r.body, r.path, r.keep_alive)

    return asyncio.run(go())


@pytest.mark.parametrize("i", range(len(RAW_REQUESTS)))
def test_protocol_parsing_equals_the_reference(i):
    assert _parse(protocol, RAW_REQUESTS[i]) == _parse(j_protocol, RAW_REQUESTS[i])


def test_protocol_framing_is_byte_for_byte_the_reference():
    objs = [{"rid": 3, "tokens": [1, 2, 3]}, {"error": "queue_full"}, [1, "é", None], {}]
    for obj in objs:
        for st in (200, 400, 429, 503, 504, 418):
            for ka in (True, False):
                extra = [("Retry-After", "1")] if st >= 429 else []
                assert protocol.json_response(st, obj, extra, ka) == j_protocol.json_response(st, obj, extra, ka)
        for event in (None, "start", "done", "error"):
            assert protocol.sse_event(obj, event) == j_protocol.sse_event(obj, event)
    for st in (200, 503):
        assert protocol.sse_preamble(st) == j_protocol.sse_preamble(st)
    body = b"repro_up 1\n"
    assert (protocol.render_response(200, body, "text/plain; version=0.0.4", [("X-A", "b")], False)
            == j_protocol.render_response(200, body, "text/plain; version=0.0.4", [("X-A", "b")], False))
    assert protocol.STATUS_PHRASES == j_protocol.STATUS_PHRASES


# ---------------------------------------------------------------------------
# concurrency, tenants, drain
# ---------------------------------------------------------------------------


def test_concurrent_tenants_over_http():
    prompts = prompts_for(4, seed=5)

    async def main():
        server, task = await start_server(make_router(lanes=2))
        try:
            async def one(i, p):
                async with Client(server.host, server.port, tenant=("a", "b")[i % 2]) as c:
                    return await c.generate(p, max_new=3)

            results = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
            async with Client(server.host, server.port) as c:
                health = await c.healthz()
            return results, health, await server.aroute.snapshot(lambda r: r.report())
        finally:
            await stop_server(server, task)

    results, health, report = run(main())
    assert all(len(r["tokens"]) == 3 for r in results) and {r["tenant"] for r in results} == {"a", "b"}
    assert health["status"] == "ok" and health["inflight"] == 0 and health["free_lanes"] == health["lanes"] == 2
    assert report["tenants"]["a"]["completed"] == 2 and report["tenants"]["b"]["completed"] == 2


def test_drain_stops_admission_finishes_inflight_and_exits_with_clients_connected():
    """The reference's own drain test times out: its server awaits
    ``wait_closed`` (which since Python 3.12.1 waits for every connection)
    before it closes the keep-alive connections. Here both clients stay
    open until the server has exited."""
    [prompt] = prompts_for(1, seed=6)

    async def main():
        server, task = await start_server(make_router())
        admin, streamer = Client(server.host, server.port), Client(server.host, server.port)
        try:
            gen = streamer.stream(prompt, max_new=12)
            assert (await gen.__anext__())[0] == "start"
            first = await gen.__anext__()
            assert first[0] == "message"  # in flight
            d = await admin.drain()
            assert d["status"] == "draining" and d["inflight"] == 1
            with pytest.raises(HttpError) as ei:
                await admin.generate(prompt, max_new=1)
            assert ei.value.status == 503 and ei.value.body["error"] == "draining"
            assert (await admin.healthz())["status"] == "draining"
            assert (await admin.drain())["status"] == "draining"  # idempotent
            events = [first] + [ev async for ev in gen]
            *toks, done = events
            assert done[0] == "done" and len(toks) == 12
            t0 = time.monotonic()
            await asyncio.wait_for(task, timeout=30)  # admin's keep-alive connection still open
            return time.monotonic() - t0
        finally:
            await admin.close()
            await streamer.close()
            if not task.done():
                await stop_server(server, task)

    assert run(main()) < 30


# ---------------------------------------------------------------------------
# /metrics, /admin/trace, debug
# ---------------------------------------------------------------------------


def test_metrics_scrape_parses_as_prometheus_text():
    [prompt] = prompts_for(1, seed=7)

    async def main():
        server, task = await start_server(make_router(cache=PrefixCache(block=4), max_queue=0), admit_retries=0)
        try:
            async with Client(server.host, server.port) as c:
                with pytest.raises(HttpError):
                    await c.generate(prompt, max_new=1)
                return await c.request("GET", "/metrics")
        finally:
            await stop_server(server, task)

    status, hdrs, data = run(main())
    assert status == 200 and hdrs["content-type"].startswith("text/plain; version=0.0.4")
    samples = parse_prometheus(data.decode())
    assert samples["repro_up"] == 1.0 and samples["repro_requests_total"] == 0.0
    assert samples["repro_free_lanes"] == 2.0 and samples['repro_rejections_total{reason="queue_full"}'] == 1.0
    assert "repro_cache_entries" in samples and samples["repro_cache_budget_bytes"] > 0
    assert "repro_cache_hits_total" in samples


def test_metrics_tenant_percentiles_after_traffic():
    [prompt] = prompts_for(1, seed=8)

    async def main():
        server, task = await start_server(make_router())
        try:
            async with Client(server.host, server.port, tenant="acme") as c:
                await c.generate(prompt, max_new=2)
                return await c.metrics()
        finally:
            await stop_server(server, task)

    text = run(main())
    assert 'repro_tenant_completed_total{tenant="acme"} 1' in text
    assert 'repro_tenant_ttft_seconds{tenant="acme",quantile="0.95"}' in text
    assert 'repro_tenant_latency_seconds{tenant="acme",quantile="0.5"}' in text


def test_metrics_histograms_cost_ledger_and_dispatch_counts():
    """Cumulative TTFT/TPOT histograms; the cost ledger per (op, backend),
    its calls equal to the dispatch counts and its ref bytes exact; the
    tracer's stats."""
    [prompt] = prompts_for(1, seed=9)

    async def main():
        kd.STATS.reset()
        server, task = await start_server(make_router())
        try:
            async with Client(server.host, server.port) as c:
                await c.generate(prompt, max_new=4)
                return await c.metrics(), kd.STATS.snapshot()
        finally:
            await stop_server(server, task)

    text, counts = run(main())
    samples = parse_prometheus(text)
    for name in ("repro_ttft_ms", "repro_tpot_ms"):
        buckets = [(ln.split('le="', 1)[1].split('"', 1)[0], float(ln.rsplit(" ", 1)[1]))
                   for ln in text.splitlines() if ln.startswith(f"{name}_bucket{{")]
        assert buckets and buckets[-1][0] == "+Inf"
        values = [v for _, v in buckets]
        assert values == sorted(values) and values[-1] == samples[f"{name}_count"] >= 1
    assert set(counts) == {("floatsd_matmul", "ref"), ("lstm_cell", "ref")}
    for (op, be), n in counts.items():
        lbl = f'{{op="{op}",backend="{be}"}}'
        assert samples[f"repro_dispatch_decisions_total{lbl}"] == samples[f"repro_cost_calls_total{lbl}"] == n
        assert samples[f"repro_cost_flops_total{lbl}"] > 0 and samples[f"repro_cost_smem_bytes{lbl}"] == 0
        assert (samples[f"repro_cost_hbm_read_bytes_total{lbl}"] + samples[f"repro_cost_hbm_write_bytes_total{lbl}"]
                == samples[f"repro_cost_touched_bytes_total{lbl}"])
        assert samples[f"repro_cost_bytes_rel_err{lbl}"] == 0
    assert samples["repro_trace_enabled"] == 1
    assert re.search(r'repro_trace_spans_total\{name="engine\.step"\} \d+', text)
    assert re.search(r'repro_request_phase_seconds\{phase="prefill",quantile="0\.95"\}', text)


def _validate_trace():
    spec = importlib.util.spec_from_file_location("check_trace", ROOT / "scripts" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_trace


def test_admin_trace_validates_with_lifecycle_spans_and_cost_counter_tracks():
    [prompt] = prompts_for(1, seed=11)

    async def main():
        server, task = await start_server(make_router(cache=PrefixCache(block=4)))
        TRACER.clear()
        try:
            async with Client(server.host, server.port) as c:
                await c.generate(prompt, max_new=3)
                return await c.trace()
        finally:
            await stop_server(server, task)

    trace = run(main())
    assert _validate_trace()(trace) == []
    evs = trace["traceEvents"]
    names = {e["name"] for e in evs}
    for expected in ("http.request", "router.submit", "router.dispatch", "router.pump", "engine.admit",
                     "cache.lookup", "engine.step", "engine.retire", "cost.floatsd_matmul", "cost.lstm_cell"):
        assert expected in names, expected
    counters = [e for e in evs if e["name"] == "cost.floatsd_matmul" and e["ph"] == "C"]
    flops = [e["args"]["flops"] for e in counters]
    assert flops == sorted(flops) and flops[-1] > 0  # monotone totals
    assert set(counters[-1]["args"]) == {"flops", "hbm_bytes", "calls"}


def test_debug_flag_returns_phase_breakdown():
    [prompt] = prompts_for(1, seed=12)

    async def main():
        server, task = await start_server(make_router(cache=PrefixCache(block=4)))
        try:
            async with Client(server.host, server.port) as c:
                plain = await c.generate(prompt, max_new=3)
                dbg = await c.generate(prompt, max_new=3, debug=True)
                done = {}
                async for ev, data in c.stream(prompt, max_new=3, debug=True):
                    if ev == "done":
                        done = data
                status, _, _ = await c.request("POST", "/v1/generate", {"prompt": prompt.tolist(), "debug": "yes"})
            return plain, dbg, done, status
        finally:
            await stop_server(server, task)

    plain, dbg, done, bad_status = run(main())
    assert "phases" not in plain and bad_status == 400
    for resp in (dbg, done):
        ph = resp["phases"]
        for k in ("queue_ms", "prefill_ms", "decode_ms", "total_ms"):
            assert ph[k] >= 0.0
        assert ph["queue_ms"] + ph["prefill_ms"] + ph["decode_ms"] == pytest.approx(ph["total_ms"], abs=0.1)
        assert ph["total_ms"] >= resp["ttft_ms"] - 0.1
    assert done["phases"]["cache_hit"] and done["phases"]["cache_saved_tokens"] > 0


def test_metrics_scrape_consistent_under_concurrent_load():
    prompts = prompts_for(8, seed=14)

    async def main():
        server, task = await start_server(make_router(lanes=2, cache=PrefixCache(block=4), max_queue=64))
        try:
            scrapes, done = [], asyncio.Event()

            async def scraper():
                async with Client(server.host, server.port) as c:
                    while not done.is_set():
                        scrapes.append(await c.metrics())
                        await asyncio.sleep(0.005)
                    scrapes.append(await c.metrics())

            async def one(p):
                async with Client(server.host, server.port) as c:
                    return [d["token"] async for e, d in c.stream(p, max_new=4) if e == "message"]

            scrape_task = asyncio.create_task(scraper())
            outs = await asyncio.gather(*(one(p) for p in prompts))
            done.set()
            await scrape_task
            return outs, scrapes
        finally:
            await stop_server(server, task)

    outs, scrapes = run(main())
    assert all(len(t) == 4 for t in outs) and len(scrapes) >= 2
    last = -1.0
    for text in scrapes:
        samples = parse_prometheus(text)
        assert samples["repro_up"] == 1.0 and samples["repro_requests_total"] >= last
        last = samples["repro_requests_total"]
    assert scrapes[-1].count("repro_requests_total 8") == 1


def _metrics_inputs():
    report = {
        "requests": 3, "steps": 40, "prefill_steps": 5, "decode_steps": 35, "emitted_tokens": 12,
        "prompt_tokens": 30, "cache_lookups": 3, "cache_hits": 1, "cache_full_hits": 0,
        "prefill_tokens_saved": 8, "preemptions": 1, "resumes": 1, "numeric_errors": 0,
        "phases": {"queue": {"p50_s": 0.001, "p95_s": 0.002, "mean_s": 0.0015},
                   "prefill": {"p50_s": 0.01, "p95_s": 0.02, "mean_s": 0.015}},
        "ttft_hist_ms": {"buckets_ms": [1.0, 2.5, 10.0], "counts": [1, 2, 0, 1], "sum_ms": 9.5, "count": 4},
        "tpot_hist_ms": {"buckets_ms": [1.0, 2.0], "counts": [3, 0, 0], "sum_ms": 1.2, "count": 3},
        "tenants": {"acme": {"submitted": 2, "completed": 2, "rejected": 0, "tokens": 8, "ttft_p50_s": 0.01,
                             "ttft_p95_s": 0.02, "latency_p50_s": 0.1, "latency_p95_s": 0.2},
                    'we"ird\\': {"submitted": 1, "completed": 1, "rejected": 1, "tokens": 4}},
    }
    stats = {"replicas": 2, "lanes": 16, "free_lanes": 15, "queued": 0, "inflight": 1, "healthy_replicas": 1,
             "rejections": {"queue_full": 2, "tenant_quota": 1}, "cancellations": {"client_cancel": 1},
             "ejections": 1, "reinstatements": 0, "resubmits": 3, "retries": 2,
             "faults": {"enabled": True, "injected": {"replica_crash": 1}}}
    cache = {"entries": 4, "nbytes": 1024, "budget_bytes": 2**26, "evictions": 0, "corruptions": 1}
    trace = {"enabled": True, "emitted": 120, "dropped": 0,
             "spans": {"engine.step": {"count": 40, "total_s": 0.25}}}
    dispatch = {("floatsd_matmul", "ref"): 68, ("lstm_cell", "cuda"): 30}
    return report, stats, cache, trace, dispatch


def test_render_metrics_equals_the_reference_but_the_renamed_lines():
    report, stats, cache, trace, dispatch = _metrics_inputs()
    rows = [{"op": "floatsd_matmul", "backend": "ref", "calls": 68, "flops": 1.5e6, "macs": 6e5,
             "hbm_read_bytes": 9000, "hbm_write_bytes": 3000, "pad_waste_bytes": 0, "touched_bytes": 12000,
             "arithmetic_intensity": 125.0, "bytes_rel_err": 0.0},
            {"op": "lstm_cell", "backend": "cuda", "calls": 30, "flops": 1234567, "macs": 24576,
             "hbm_read_bytes": 147456, "hbm_write_bytes": 49152, "pad_waste_bytes": 0, "touched_bytes": 196608,
             "arithmetic_intensity": 5.4, "bytes_rel_err": None}]
    kw = dict(cache_stats=cache, draining=False, uptime_s=12.5, http_requests=77, dispatch_counts=dispatch,
              trace_stats=trace)
    port = render_metrics(report, stats, cost_rows=[{**r, "smem_bytes": 1156 * i} for i, r in enumerate(rows)], **kw)
    ref = j_prom.render_metrics(report, stats, cost_rows=[{**r, "vmem_bytes": 1156 * i} for i, r in enumerate(rows)],
                                **kw)
    renamed = ("repro_cost_smem_bytes", "repro_cost_vmem_bytes", "# HELP repro_cost_hbm_read_bytes_total",
               "# HELP repro_dispatch_decisions_total")
    keep = lambda text: [ln.replace("smem", "vmem") for ln in text.splitlines()  # noqa: E731
                         if not ln.startswith(("# HELP repro_cost_smem_bytes", "# HELP repro_cost_vmem_bytes",
                                               *renamed[2:]))]
    assert keep(port) == keep(ref)
    differ = [a for a, b in zip(port.splitlines(), ref.splitlines()) if a != b]
    assert differ and all(any(r in ln for r in renamed) for ln in differ)
    assert 'repro_cost_smem_bytes{op="lstm_cell",backend="cuda"} 1156' in port
    assert render_metrics(report, stats) == j_prom.render_metrics(report, stats)  # no ledger: identical


# ---------------------------------------------------------------------------
# the two HTTP cases of tests/test_cancel.py
# ---------------------------------------------------------------------------


def test_http_delete_cancels_mid_stream_and_frees_the_lane():
    prompt = np.random.default_rng(18).integers(0, V, 6).astype(np.int32)

    async def main():
        server, task = await start_server(make_router(lanes=2, chunk=4))
        streamer, admin = Client(server.host, server.port), Client(server.host, server.port)
        try:
            gen = streamer.stream(prompt, max_new=512)
            start = await gen.__anext__()
            rid = start[1]["rid"]
            assert (await gen.__anext__())[0] == "message"
            assert await admin.cancel(rid) == {"rid": rid, "cancelled": True}
            events = [ev async for ev in gen]
            done = events[-1]
            assert done[0] == "done" and done[1]["status"] == "cancelled"
            assert done[1]["reason"] == "client_cancel" and 1 <= done[1]["n_tokens"] < 512
            for bad in (rid, 999999):  # gone now, or never existed
                with pytest.raises(HttpError) as ei:
                    await admin.cancel(bad)
                assert ei.value.status == 404
            m1 = await admin.metrics()
            d1 = _counter(m1, "repro_decode_steps_total")
            assert _counter(m1, "repro_cancelled_total", '{reason="client_cancel"}') == 1
            assert _counter(m1, "repro_free_lanes") == 2  # the lane is back
            await admin.generate(prompt, max_new=1)  # 6 prompt tokens at chunk 4: 2 prefill steps
            assert _counter(await admin.metrics(), "repro_decode_steps_total") == d1
            return True
        finally:
            await streamer.close()
            await admin.close()
            await stop_server(server, task)

    assert run(main())


def test_http_stream_mid_flight_deadline_maps_to_504_error_event():
    prompt = np.random.default_rng(19).integers(0, V, 6).astype(np.int32)

    async def main():
        server, task = await start_server(make_router(lanes=1, chunk=4))
        try:
            async with Client(server.host, server.port) as c:
                with pytest.raises(HttpError) as ei:
                    async for _ in c.stream(prompt, max_new=512, deadline_ms=150):
                        pass
                return ei.value.status, ei.value.reason
        finally:
            await stop_server(server, task)

    assert run(main()) == (504, "deadline_expired")


# ---------------------------------------------------------------------------
# the router pieces, and the CLI's --http
# ---------------------------------------------------------------------------


def test_router_note_retry_scrape_and_async_snapshot_cancel():
    router = make_router(cache=PrefixCache(block=4))
    router.note_retry()
    assert router.stats()["retries"] == router.report()["retries"] == 1
    kd.STATS.reset()

    async def main():
        ar = AsyncRouter(router)
        t1 = router.submit(prompts_for(1, seed=31)[0], max_new=40)
        await ar.snapshot(lambda r: r.pump())
        cancelled = await ar.cancel(t1.rid)
        again = await ar.cancel(t1.rid)
        return cancelled, again, await ar.snapshot(lambda r: r.scrape())

    cancelled, again, scrape = run(main())
    assert cancelled and not again
    assert set(scrape) == {"report", "stats", "cache", "cost"}
    assert scrape["stats"]["cancellations"] == {"client_cancel": 1} and scrape["cache"]["budget_bytes"] > 0
    assert {r["op"] for r in scrape["cost"]} == {"floatsd_matmul", "lstm_cell"}
    assert all(r["bytes_rel_err"] == 0 for r in scrape["cost"])


def test_cli_http_serves_until_drain_and_prints_the_report():
    # no prefix cache: a hit injects an FP8-rounded state, which may flip a
    # later token of these random weights (and the same prompt is sent twice)
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--http", "--port", "0",
           "--replicas", "2", "--batch", "2", "--max-new", "4", "--cache-mb", "0"]

    async def main():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = await asyncio.create_subprocess_exec(*cli, cwd=str(ROOT), env=env, stdout=asyncio.subprocess.PIPE,
                                                    stderr=asyncio.subprocess.PIPE)
        try:
            line = (await asyncio.wait_for(proc.stdout.readline(), 30)).decode()
            assert line.startswith("http: listening on http://127.0.0.1:"), line
            async with Client("127.0.0.1", int(line.split("http://127.0.0.1:", 1)[1].split()[0])) as c:
                assert (await c.healthz())["replicas"] == 2
                gen = await c.generate([5, 6, 7], max_new=4)
                streamed = [d["token"] async for e, d in c.stream([5, 6, 7], max_new=4) if e == "message"]
                text = await c.metrics()
                assert (await c.drain())["status"] == "draining"
            out, err = await asyncio.wait_for(proc.communicate(), 30)
            return proc.returncode, out.decode(), err.decode(), gen, streamed, text
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    rc, out, err, gen, streamed, text = run(main())
    assert rc == 0, err
    assert gen["tokens"] == streamed and len(streamed) == 4
    assert 'repro_dispatch_decisions_total{op="floatsd_matmul",backend="ref"}' in text
    assert "http: served 2 requests, 8 tokens over 2 replica(s)" in out


def test_cli_http_rejects_a_zoo_arch_with_the_frontend_message():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch", "rwkv6_3b",
                        "--http", "--port", "0"], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT)
    assert r.returncode == 1 and "--frontend serves LSTM-family models" in r.stderr


@pytest.fixture(autouse=True)
def _process_state_restored():
    """The server turns the process tracer on; leave it off for later tests."""
    yield
    TRACER.disable()
    TRACER.clear()
    assert not FAULTS.enabled
