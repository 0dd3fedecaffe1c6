"""Batched serving CLI of the port.

Builds the ``--arch`` model (default: the WikiText-2 FloatSD8 LSTM LM) with
random weights from ``--seed``, packs them to 1-byte FloatSD8 codes (or, with
``--weight-format floatsd4``, re-quantizes those to nibble-packed FloatSD4
codes; a zoo model's stacked leaves packed along the layer axis, as the
reference packs them, and served a layer's planes at a time), prints the
resident bytes, and drains a synthetic workload through ``ServeEngine`` (continuous
batching, chunked prefill, greedy decoding). On the card every weight site,
the tied head and the cell run the hand-written CUDA kernels. A model-zoo
arch (``--arch rwkv6_3b``, ``--arch h2o_danube3_4b`` or another dense
config, ``--arch jamba_v01_52b``, ``dbrx_132b``, ``kimi_k2_1t_a32b`` or
``qwen2_vl_2b``, text prompts) serves its reduced config, as the reference
CLI does: lockstep
one-token steps, each lane once, so ``--requests`` must not exceed
``--batch``, and an attention model gets a KV cache of 2048 positions; its
full width is driven from the API (``chip_smoke.py``). ``--arch
whisper_large_v3`` exits 1: the engine feeds no encoder input, so Whisper
is driven through ``encode``, ``prefill_cross`` and ``decode_step`` (the
reference CLI fails on it too).

``--frontend`` serves the LSTM LM through the multi-tenant router: engine
replicas (``--replicas``) share one FP8 LSTM-state prefix cache
(``--cache-mb``; 0 disables it), requests round-robin over ``--tenants``,
and the report has the hit rate and per-tenant latency percentiles.
``--workload zipf-prefix`` draws shared-system-prompt prompts (prefixes of
3 x ``--chunk`` tokens), what the cache is for. Scheduler v2:
``--admission sjf_work --preempt`` (and ``--admit-pace N``). Preemption
needs a queue head that owes less work than a decoding lane: behind the
router an engine is handed only what its free lanes take, and the CLI gives
every request the same ``--max-new``, so here it never fires (the printed
count says so); callers of the API with mixed ``max_new`` drive it.
``--dense`` serves the dense weights through the fake-quant-at-use path
(any ``--policy``). The ``REPRO_FAULTS`` environment variable arms a fault plan
(``faults.py``), ``REPRO_TRACE=1`` the tracer. The router ejects a replica
whose steps fail; if every replica is ejected, the backlog is rejected as
``no_healthy_replicas`` and the CLI exits 1 with each replica's last error,
so a kernel that fails on the card is not mistaken for load shedding.

``--http`` puts the router (``--frontend`` is implied) behind the HTTP/SSE
server (``serving/http/``) on ``--host``:``--port`` (0: an ephemeral port)
instead of draining a synthetic workload: it prints ``http: listening on
http://HOST:PORT``, serves /v1/generate, /v1/stream, DELETE
/v1/requests/{rid}, /healthz, /metrics and /admin/trace until POST
/admin/drain, then prints the report line. ``--no-trace`` leaves the
request-lifecycle tracer off. It exits 1, with each replica's last error,
when a request was rejected because every replica was ejected.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # reduced, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --full         # 1024-wide LM, GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --full --weight-format floatsd4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b --device cpu --requests 4 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o_danube3_4b --device cpu --requests 4 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o_danube3_4b --device cpu --weight-format floatsd4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v01_52b --device cpu --requests 2 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_2b --device cpu --requests 2 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --frontend --replicas 2 --workload zipf-prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --full --frontend --replicas 2 --workload zipf-prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --dense --policy fp32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --http --port 0 --replicas 2
  PYTHONPATH=src python -m repro_torch.launch.serve --full --http --port 0 --replicas 2
"""
from __future__ import annotations

import argparse
import asyncio
import sys

import numpy as np
import torch

from ..configs import get_config, lstm_wikitext2
from ..core.policy import get_policy
from ..device import resolve_device
from ..models import build
from ..serving import (
    ADMISSION_POLICIES, WEIGHT_FORMATS, HttpServer, PrefixCache, Router, ServeEngine,
    synthetic_prompts, zipf_prefix_prompts,
)


def _exit_on_outage(router: Router, rep: dict) -> None:
    """Every replica was ejected: report why instead of passing it off as
    load shedding, and exit 1."""
    if rep["rejections"].get("no_healthy_replicas"):
        for h in router.stats()["replica_health"]:
            print(f"replica {h['replica']}: {h['last_error']}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def _serve_http(router: Router, args) -> None:
    """Serve the router over HTTP/SSE until /admin/drain (or Ctrl-C), then
    print the report line."""

    async def run():
        server = await HttpServer(router, host=args.host, port=args.port, default_max_new=args.max_new,
                                  trace=not args.no_trace).start()
        print(f"http: listening on http://{server.host}:{server.port} ({args.replicas} replica(s) x "
              f"{args.batch} lanes, admission={args.admission}); POST /admin/drain to stop", flush=True)
        await server.serve_forever()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    rep = router.report()
    print(
        f"http: served {rep['requests']} requests, {rep['emitted_tokens']} tokens over "
        f"{rep['replicas']} replica(s) | cache hit rate {rep['cache_hit_rate']:.0%} "
        f"({rep['prefill_tokens_saved']} prefill tok saved) | rejections {rep['rejections']}",
        flush=True,
    )
    _exit_on_outage(router, rep)


def _serve_frontend(model, params, policy, prompts, engine_kw, args) -> None:
    cache = (PrefixCache(budget_bytes=int(args.cache_mb * 2**20), block=args.chunk)
             if args.cache_mb > 0 else None)
    router = Router.build(model, params, policy, replicas=args.replicas, prefix_cache=cache,
                          router_kw=dict(admission=args.admission, max_queue=args.requests),
                          **engine_kw)
    if args.http:
        _serve_http(router, args)
        return
    for i, p in enumerate(prompts):
        router.submit(p, max_new=args.max_new, tenant=f"tenant{i % args.tenants}")
    router.drain()
    rep = router.report()
    print(
        f"frontend: {rep['requests']} requests over {rep['replicas']} replica(s), "
        f"{rep['steps']} steps ({rep['prefill_steps']} prefill / {rep['decode_steps']} decode), "
        f"cache hit rate {rep['cache_hit_rate']:.0%} ({rep['prefill_tokens_saved']} prefill tok "
        f"saved), preemptions {rep['preemptions']}, ejections {rep['ejections']}, "
        f"rejections {rep['rejections']}",
        flush=True,
    )
    for tenant, t in rep["tenants"].items():
        print(
            f"  {tenant}: {t['completed']} done / {t['tokens']} tok | "
            f"ttft p95 {t.get('ttft_p95_s', 0.0)*1e3:.0f}ms | "
            f"latency p95 {t.get('latency_p95_s', 0.0)*1e3:.0f}ms",
            flush=True,
        )
    _exit_on_outage(router, rep)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm_wikitext2",
                    help="config name (repro_torch/configs); a zoo arch serves its reduced config")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale LSTM LM (hidden 1024, vocab 33278); ignored for a zoo arch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8, help="decode lanes")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=8, help="prompt tokens consumed per prefill step")
    ap.add_argument("--policy", default="floatsd8_table6",
                    help="numeric policy (core/policy.py); a policy without FloatSD8 weights "
                         "needs --dense")
    ap.add_argument("--admission", default="fifo", choices=ADMISSION_POLICIES)
    ap.add_argument("--preempt", action="store_true",
                    help="scheduler v2: an engine may preempt its longest-remaining decoding "
                         "lane (FP8 state snapshot, resumed later) when the queue head owes much "
                         "less work; pair with --admission sjf_work. It needs requests of mixed "
                         "max_new without --frontend (the router hands an engine only what its "
                         "free lanes take), so with one --max-new it never fires here")
    ap.add_argument("--admit-pace", type=int, default=None,
                    help="scheduler v2: at most this many lane admissions an engine step")
    ap.add_argument("--dense", action="store_true",
                    help="serve the dense f32 weights (fake-quant at use) instead of packed codes")
    ap.add_argument("--weight-format", choices=WEIGHT_FORMATS, default="floatsd8",
                    help="packed serving format: floatsd8 (1 byte a weight, the trained "
                         "function) or floatsd4 (2 codes a byte + group exponents, about half "
                         "the resident bytes, re-quantized from the FloatSD8 values)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frontend", action="store_true",
                    help="serve through the multi-tenant router with a shared FP8 LSTM-state "
                         "prefix cache")
    ap.add_argument("--replicas", type=int, default=1, help="frontend: engine replicas")
    ap.add_argument("--cache-mb", type=float, default=64.0,
                    help="frontend: prefix-cache byte budget (MiB); 0 disables the cache")
    ap.add_argument("--tenants", type=int, default=2,
                    help="frontend: requests round-robin over this many synthetic tenants")
    ap.add_argument("--workload", choices=("uniform", "zipf-prefix"), default="uniform",
                    help="uniform prompt lengths, or shared system prompts (zipf over a small "
                         "prefix pool)")
    ap.add_argument("--http", action="store_true",
                    help="serve the frontend router over HTTP/SSE (/v1/generate, /v1/stream, "
                         "/healthz, /metrics, /admin/drain) instead of draining a synthetic "
                         "workload; runs until POST /admin/drain")
    ap.add_argument("--host", default="127.0.0.1", help="http: bind address")
    ap.add_argument("--port", type=int, default=8000,
                    help="http: bind port (0 picks an ephemeral port, printed on startup)")
    ap.add_argument("--no-trace", action="store_true",
                    help="http: leave the request-lifecycle tracer off (GET /admin/trace then "
                         "exports an empty trace)")
    args = ap.parse_args(argv)
    if args.http:
        args.frontend = True  # the HTTP layer sits on the router

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.family == "lstm":
        cfg = cfg if args.full else lstm_wikitext2.REDUCED
    else:
        cfg = cfg.reduced()
    if args.frontend and cfg.family != "lstm":
        # a zoo cache is not lane-major: no lane re-arming, no constant-size
        # state to prefix-cache
        raise SystemExit(
            "--frontend serves LSTM-family models (continuous lane re-arming + prefix cache need "
            f"lane-major recurrent state); arch {args.arch!r} is family {cfg.family!r} — use the "
            "plain engine path instead")
    if cfg.family == "audio":
        raise SystemExit(
            f"arch {args.arch!r} is family 'audio': the serving engine feeds no encoder input; drive "
            "Whisper through its encode, prefill_cross and decode_step (repro_torch.models.Whisper)")
    policy = get_policy(args.policy)
    model = build(cfg)
    rng = np.random.default_rng(args.seed)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.workload == "zipf-prefix":
        prompts = zipf_prefix_prompts(args.requests, cfg.vocab, rng, prefix_len=3 * args.chunk,
                                      prefix_seed=args.seed)
    else:
        prompts = synthetic_prompts(args.requests, cfg.vocab, rng)
    engine_kw = dict(lanes=args.batch, chunk=args.chunk, packed=not args.dense,
                     weight_format=args.weight_format,
                     cache_len=None if cfg.family == "lstm" else 2048,
                     # the engines share the router's policy, so preemption peeks
                     # at the order the router dispatches in
                     admission=args.admission, preempt=args.preempt, admit_pace=args.admit_pace)
    if args.frontend:
        _serve_frontend(model, params, policy, prompts, engine_kw, args)
        return

    engine = ServeEngine(model, params, policy, **engine_kw)
    s = engine.store
    if s is not None:
        print(
            f"weights: {s.dense_nbytes/2**20:.1f} MiB dense -> "
            f"{s.packed_nbytes/2**20:.1f} MiB packed "
            f"{'FloatSD4' if s.fmt == 'floatsd4' else 'FloatSD8'} "
            f"({s.compression:.2f}x smaller, {s.n_packed} tensors packed, {s.packed_nbytes} B resident)",
            flush=True,
        )
    engine.submit_all(prompts, max_new=args.max_new)
    metrics = engine.run()
    print(metrics.format(), flush=True)
    if args.preempt:
        print(f"preemptions {metrics.preemptions}, resumes {metrics.resumes}", flush=True)


if __name__ == "__main__":
    main()
