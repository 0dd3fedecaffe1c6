"""Batched serving CLI of the port.

Builds the ``--arch`` model (default: the WikiText-2 FloatSD8 LSTM LM) with
random weights from ``--seed``, packs them to 1-byte FloatSD8 codes (or, with
``--weight-format floatsd4``, re-quantizes those to nibble-packed FloatSD4
codes), and drains a synthetic workload through ``ServeEngine`` (continuous
batching, chunked prefill, greedy decoding). On the card every weight site,
the tied head and the cell run the hand-written CUDA kernels. A model-zoo
arch (``--arch rwkv6_3b``, ``--arch h2o_danube3_4b`` or another dense
config) serves its reduced config, as the reference CLI does: lockstep
one-token steps, each lane once, so ``--requests`` must not exceed
``--batch``, and an attention model gets a KV cache of 2048 positions; its
full width is driven from the API (``chip_smoke.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # reduced, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --full         # 1024-wide LM, GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --full --weight-format floatsd4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b --device cpu --requests 4 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o_danube3_4b --device cpu --requests 4 --batch 4
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, lstm_wikitext2
from ..core.policy import get_policy
from ..device import resolve_device
from ..models import build
from ..serving import WEIGHT_FORMATS, ServeEngine, synthetic_prompts


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
    ap.add_argument("--weight-format", choices=WEIGHT_FORMATS, default="floatsd8",
                    help="packed serving format: floatsd8 (1 byte a weight, the trained "
                         "function) or floatsd4 (2 codes a byte + group exponents, about half "
                         "the resident bytes, re-quantized from the FloatSD8 values)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.family == "lstm":
        cfg = cfg if args.full else lstm_wikitext2.REDUCED
    else:
        cfg = cfg.reduced()
    policy = get_policy("floatsd8_table6")
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    prompts = synthetic_prompts(args.requests, cfg.vocab, np.random.default_rng(args.seed))

    engine = ServeEngine(model, params, policy, lanes=args.batch, chunk=args.chunk,
                         weight_format=args.weight_format,
                         cache_len=None if cfg.family == "lstm" else 2048)
    s = engine.store
    print(
        f"weights: {s.dense_nbytes/2**20:.1f} MiB dense -> "
        f"{s.packed_nbytes/2**20:.1f} MiB packed "
        f"{'FloatSD4' if s.fmt == 'floatsd4' else 'FloatSD8'} "
        f"({s.compression:.2f}x smaller, {s.n_packed} tensors packed)",
        flush=True,
    )
    engine.submit_all(prompts, max_new=args.max_new)
    metrics = engine.run()
    print(metrics.format(), flush=True)


if __name__ == "__main__":
    main()
