#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

  1. device     a CUDA device is present; prints nvidia-smi's name and
                power limit.
  2. build      builds every hand-written kernel from the checkout's
                sources (one nvcc per source, started together); prints
                ptxas's registers, shared memory and spills of every device
                function, and the tensor-core instructions (HGMMA) in the
                flash_attention library by cuobjdump, which must hold some.
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the serving, training, entry and zoo paths' shapes:
                error, mismatches, median time beside the plain version,
                the library call and the bound (bytes or operations over
                the card's peak rates). rwkv_wkv at the zoo's full-width
                prefill shape in three decay regimes and at a ragged S,
                two launches bit-identical; floatsd_matmul at the LSTM's
                and both zoo models' shapes, each with the route its
                `plan` takes (route A bit for bit at every serving shape,
                route B within the precise bound, where a code moved one
                mantissa step must fall outside it; two launches
                bit-identical on both); flash_attention against the oracle
                and the chunked plain version at the dense prefill's shape,
                at S 8192 under the window (and the plain version without
                the window rejected there), at a ragged S, without the
                causal mask and on bf16, two launches bit-identical, beside
                scaled_dot_product_attention where it computes the same
                function; at the prefill shape its f32 scores' precision
                control (against the chunked plain version, at most a
                quarter of the error of that version on bf16-rounded q and
                k). The element-wise kernels: lstm_cell and lstm_cell_grad
                bit for bit at the decode and train shapes, at H 1023 and
                with c_prev at an odd fp16 offset; qsigmoid bit for bit at
                the entry and zoo shapes and on every one of the 2^32 f32
                bit patterns (the seconds printed); floatsd_quantize byte
                for byte with core.floatsd.encode at the entry pass's
                shapes, at odd start offsets of a ragged length (f32 and
                fp16), at edge values of the extreme biases, on every
                finite fp16 bit pattern at biases -126, -7, 0 and 120 and
                on every finite f32 bit pattern at bias 0 (the seconds
                printed); two launches bit-identical; for each of the four,
                ptxas's registers and spills, SASS instructions an element
                (cuobjdump) and the timing floor (the same timer around a
                one-element op).
  4. main path  the full-width WikiText-2 FloatSD8 LM (vocab 33278 padded
                to 33280, 1024 wide, 2 layers, tied embeddings, seeded
                random weights) packed to 1-byte codes and served by
                ServeEngine: 8 lanes, chunk 8, 16 requests, 16 new tokens
                each. Launch counters and dispatch records are zeroed just
                before and read just after; every gate matmul, head and
                cell must have run on the kernels, none on the plain path.
  5. cross      the same requests served with backend="ref" (the plain
                versions) on the card; greedy tokens must agree over each
                request's margin-decisive prefix.
  6. serve4     the same model and requests served with
                weight_format="floatsd4" (the FloatSD8 codes re-quantized to
                nibble-packed FloatSD4 codes + int8 group exponents): the
                resident bytes exactly, every gate matmul and the tied head
                on floatsd4_matmul (its transposed mode reads the table in
                place) and every cell on lstm_cell, none on the plain path or
                the FloatSD8 matmul; the tokens against backend="ref" as in
                phase 5; tok/s and decode step beside FloatSD8's; the
                FloatSD4-vs-FloatSD8 loss of one synthetic batch (random
                weights: informative only); both formats served again in
                turns (8, 4, 4, 8) for their decode steps, and a window of
                decode steps of each under torch.profiler (device busy
                time, kernel time, operations a step).
  7. train      the same full-width model trained through the training
                CLI's entry point (`repro_torch.launch.train --full`: B 64,
                S 48, sgd(0.9), lr 0.5, floatsd8_table6, static loss scale
                1024, telemetry on as by default) for a few steps from a
                seeded init. Counters and
                dispatch records are zeroed before and read after: every
                forward matmul, cell, cell backward, matmul_dx and matmul_dw
                ran on its kernel, as often as the fused BPTT implies, and
                telemetry's floatsd_quantize twice a weight matrix a step,
                none on the plain path; every loss is finite and no step was
                skipped. Then one more step under torch.profiler: device
                time by kernel, and the device's busy share of a step; and
                pack_train's cost a step: the host's waits at its four bias
                reads in one more step, and the device time of its four
                encodes (core.floatsd.encode in torch ops) run alone.
  8. train-x    the same init and batches trained with backend="ref" on
                the card: losses within 1e-3 relative at every step, and
                each trained master leaf within 1e-3 of its change (L2)
                from a second kernel-path run, whose losses must be
                bit-identical to the first's.
  9. tasks      the paper's other three tasks at their Table III widths
                (make_task(name, full=True), seed 0, Adam, lr 1e-3,
                floatsd8_table6): UDPOS (B 64 x S 32, 2 BiLSTM layers),
                SNLI (B 128 x S 24, one BiLSTM over premise and
                hypothesis, max-pooled), Multi30K (B 128 x S 20, encoder
                to decoder). First the fused BPTT at B 128 x K 300 x H
                300: every forward z equals the backward's recompute bit
                for bit. Each trains 5 steps through the training CLI
                on the kernels: launches as the fused BPTT implies for its
                engine calls (4, 4, 2 a step, reverse scans included),
                floatsd_quantize twice a weight matrix a step (telemetry),
                every dispatch record cuda, finite losses, no step
                skipped; one more step profiled; 3 steps on
                backend="ref" and 3 on the kernels again (losses within
                1e-3 relative, masters within 1e-3 of their change, the
                two kernel runs bit-identical); the task's metric on 2
                eval batches with no gradient (the inference scans, the
                reverse one included: lstm_cell only); one FP32 step
                through autodiff (no dispatched op). The kernel phase holds
                the engine's kernels at these shapes against their plain
                versions and times each, route B beside route A at M 128.
 10. entry      dispatch.quantize on every trained fp16 master weight of
                phase 7: codes byte-identical to pack_tree's and the same
                bias; dispatch.qsigmoid on a [64,4096] gate block (layer 0's
                first-step pre-activations of 64 sequences), bit-identical
                to the plain version; both on their kernels.
 11. runtime    the training runtime on the full-width LM (B 64 x S 48,
                floatsd8_table6, seed 0): 3 steps in save-z mode and 3 in
                remat mode from one init on the same batches (losses and
                every master bit-identical; floatsd_matmul launches asserted
                at 192 and 196 a step; warm step time, a profiled step's
                device time, the zs residuals' 100,663,296 B from the shapes
                and max_memory_allocated of each); the training CLI with
                --steps 6 --save-every 3 --fail-at 4 into a fresh checkpoint
                dir (must raise SimulatedFailure), relaunched without
                --fail-at (must resume from step 3 and finish at 6, its
                masters, optimizer state and loss scale bit for bit those of
                one process fed batches 0-2 twice); a CLI run with telemetry
                and the matmul_dw flush hook on (its JSONL record has the
                reference's fields, every fraction in [0, 1]) beside one
                without (warm step times, the launches telemetry adds: 2
                floatsd_quantize per weight matrix a step; then the step
                and the CLI's metrics handling, with and without, in
                turns), and the step's
                metrics["tel"] on the kernels equal to backend="ref"'s;
                train_matmul and lstm_cell_train at the gate shapes against
                their plain versions (forward and cell bit for bit, dx and
                dw within the matmul_dx / matmul_dw bounds).
 12. zoo        the model zoo's RWKV-6 (rwkv6_3b at its published width:
                32 layers, d_model 2560, 40 heads of 64, d_ff 8960, vocab
                65536, tied, layernorm) from seed 0, packed to FloatSD8
                (2,905,722,960 resident bytes, asserted) with the f32 tree
                freed: CausalLM.prefill on 2 x 1024 synthetic tokens (every
                weight site and the head on floatsd_matmul, every receptance
                gate on qsigmoid, one rwkv_wkv a layer, none on the plain
                path; finite logits), once more timed and once under
                torch.profiler (device time by kernel); sequence 0's first
                64 tokens through decode_step one at a time, against the
                prefill's logits
                (held within the stated tolerance with no activation
                quantizer, the same codes; reported under the served
                policy); ServeEngine with 8 lanes and 8 requests (lockstep
                one-token steps), 16 new tokens each. Counters are zeroed
                before and read after each of the three.
 13. zoo-x      the same path at full width and 2 layers on the kernels
                against backend="ref" on the card: prefill logits within the
                stated tolerance with no activation quantizer (the served
                policy's gap reported: FP8 flips cascade through the state),
                greedy tokens of the engine equal over the plain path's
                margin-decisive prefix.
 14. dense      the zoo's dense family: h2o_danube3_4b at its published
                width (24 layers, d_model 3840, 32 heads of 120 over 8 KV
                heads, d_ff 10240, vocab 32000, window 4096, rmsnorm,
                SwiGLU, tied) from seed 0, after the RWKV trees are freed,
                packed to FloatSD8 (3,838,970,920 resident bytes, asserted)
                with the f32 tree freed: CausalLM.prefill on 2 x 1024 tokens
                (every weight site and the head on floatsd_matmul, 169
                launches, and every layer's attention on flash_attention,
                24; none on the plain path; finite logits), once more timed
                and once under torch.profiler; sequence 0's first 64 tokens
                through decode_step against the prefill's logits (bounded
                with no activation quantizer, reported under the served
                policy); ServeEngine with 8 lanes, 8 requests, 16 new tokens
                and a KV cache of 2048 positions (1,509,949,440 B,
                asserted). Counters are zeroed before and read after each.
 15. dense-x    the same path at full width and 2 layers on the kernels
                against backend="ref" on the card: prefill logits within the
                stated tolerance with no activation quantizer (the served
                policy's gap reported), greedy tokens of the engine equal
                over the plain path's margin-decisive prefix.
 16. frontend   the main path's full-width LM behind the multi-tenant
                router: 2 replicas of 8 lanes, chunk 8, 3 tenants, sharing
                one FP8 prefix cache (block 8). 48 zipf-prefix requests
                (system prompts of 24 tokens, prefix seed 7, 16 new tokens)
                served cold, then a warm-up set (the same prefixes, other
                suffixes) into the cache, then the 48 warm: warm prefill
                steps at most 0.7 x cold, hit rate above 0.5; printed: the
                steps, prefill tokens saved, hit rate, warm-against-cold
                agreement (reported only: the injected states are
                FP8-rounded), tok/s, the median decode pump, TTFT p50 and
                p95 per tenant. The warm run again on backend="ref" from a
                copy of the warmed cache: the same schedule, tokens equal
                over the margin-decisive prefix. One engine under sjf_work
                with preemption (8 long decodes, then 8 short arrivals): at
                least one preemption and resume, every request done, the
                preempted streams against a run without preemption
                (reported). The chaos plan replica_crash@6:key=1;
                cache_corrupt@2;nonfinite_logits@3 over repeated one-chunk
                prompts: replica 1 ejected on a crash, its resubmitted
                requests finished on replica 0 with the fault-free run's
                tokens, exactly one numeric_error, one corruption caught as
                a miss, FAULTS disarmed after. Every kernel run's
                floatsd_matmul and lstm_cell launches equal the main path's
                formula summed over the engines, every dispatch record cuda.
 17. http       the same LM behind HttpServer on 127.0.0.1 (2 replicas x 8
                lanes, chunk 8, 3 tenants, the tracer on): (a) 32 random
                prompts of 16-48 tokens, 16 new each, no prefix cache, one
                connection each, half /v1/generate and half /v1/stream:
                every request's tokens equal the same prompts in-process on
                backend="ref"; (b) a DELETE mid-stream ends it with
                done(status=cancelled) and all 16 lanes free; (d) /metrics
                parses as Prometheus text, its dispatch counts all cuda and
                equal to STATS, repro_cost_calls_total equal to the
                launches (the main path's formula over the engines), the
                launches' predicted bytes at least the plain version's
                model's for the same calls; (e) /admin/trace validates
                (scripts/check_trace.py) with the cost.<op> counter tracks;
                (f) /admin/drain ends serve_forever within 30 s with a
                client connected; (c) the frontend phase's 48 zipf-prefix
                requests over HTTP with the FP8 prefix cache: hits, and
                /metrics' cache counters equal to the cache's own stats;
                (g) `launch/serve.py --full --http --port 0 --replicas 2`
                as a subprocess: healthz, generate, stream, metrics (all
                cuda) and drain through Client, exit 0 with its report line.
                Printed: generated tok/s, TTFT p50/p95 per tenant and the
                median decode pump beside the frontend phase's, and one
                emit_counters call against the pump.
 18-24.         the zoo's hybrid, moe, audio and vlm families (hybrid,
                hybrid-x, moe, audio, audio-x, vlm, vlm-x).
 25. zoo-train-x  every zoo family's reduced config (h2o_danube3_4b,
                rwkv6_3b, dbrx_132b, jamba_v01_52b, qwen2_vl_2b with its
                16 stub patches, whisper_large_v3 with its frames; B 2 x S
                32) on the kernels against backend="ref" from the same
                params and batch: under fp32 the loss (1e-4 relative) and
                every leaf's loss-scaled gradient (2e-2 of its scale),
                under floatsd8_table6 one train step each whose
                grads_finite agree (the loss and masters reported); every
                flash, wkv and qsigmoid forward on its kernel (the remat's
                recompute included), none on the plain path; then the
                training CLI's --arch h2o_danube3_4b --steps 5 on the
                card, its dispatch line all flash_attention/cuda.
 26. zoo-train  h2o_danube3_4b at its published width, cut to 11 of 24
                layers (the most whose step peaks under about 70 GB), B 1
                x S 8192 (the 4096 window bites), floatsd8_table6, Adam,
                static scale 1024, telemetry on, 4 steps from seed 0:
                every flash forward on the kernel (2 a layer a step: the
                forward and the remat's recompute), every loss finite, the
                peak max_memory_allocated, the median step and tok/s, one
                step profiled (device busy share, the GEMMs', the top
                device operations); then 2 layers of the same width under
                fp32 on the kernels against backend="ref" (phase 25's
                bounds).
 27. dense4     FloatSD4 serving of a stacked model: h2o_danube3_4b at its
                published width and depth from its FloatSD4 store
                (2,078,169,600 resident bytes, asserted; the stacked leaves
                nibble-packed and grouped along the layer axis, as the JAX
                package packs them): phase 14's prefill, decode and engine,
                every weight site and the head on floatsd4_matmul (169 a
                prefill: each layer's code and exponent planes read in
                place), none on the FloatSD8 matmul or the plain path.
 28. dense4-x   phase 15 from the FloatSD4 store.
 29. family4-x  rwkv6_3b at 2 layers of full width, the reduced Jamba and
                DBRX, qwen2_vl_2b at 2 layers over its patches and
                whisper_large_v3 at 2 + 2 layers, each from its FloatSD4
                store on the kernels against backend="ref": fp32 logits
                within each family's bound, greedy tokens equal over the
                plain path's margin-decisive prefix.
 30. dense84    stablelm_3b and phi4_mini_3p8b in FloatSD8, granite_20b in
                FloatSD8 and FloatSD4, at their published widths and depths
                through phase 14 (16 decode steps against the prefill): the
                resident bytes asserted and the build's peak device memory;
                granite_20b's FloatSD8 store built by the two-pass streamed
                pack (its f32 tree would be 80 GB), its FloatSD4 store
                converted from it leaf by leaf.
 31. mesh       the training CLI on its device mesh: ("data", "model") of
                (world, 1) over an NCCL world of one rank (every collective
                an identity; every earlier phase's CLI runs go through it
                too). The full-width LM (phase 7's args) trains 5 steps:
                its losses and final fp16 masters bit for bit those of the
                unsharded step from the same seed and batches, the four
                LSTM kernels and floatsd_quantize counted (all cuda), the
                collectives counted (the masters' all-gathers, matmul_dw's
                and the head's row gathers, one f32 all-reduce a step) and
                one step profiled (the NCCL and copy kernels' device time
                beside the step's); --arch dbrx_132b (reduced) 2 steps
                through the CLI under fp32 (as phase 25 holds its losses)
                on the kernels and on backend="ref": every MoE call routes
                one group, the losses within 1e-4 relative; fp8_psum over the world's group bit for bit the
                saturating e5m2 round trip at the exact power-of-two scale.
 32. dryrun     the production-mesh dry run (launch/dryrun.py) and one
                rank's share of it on the card. In child processes on the
                host's CPU (no device): run_cell for the four dense archs'
                train_4k on the 16 x 16 ("data", "model") mesh over a fake
                group of 256 ranks, and h2o_danube3_4b's prefill_32k, each
                traced at full depth; each record's per-rank memory
                and roofline terms printed. Meanwhile on the card:
                flash_attention at the tensor-parallel local shapes (2 query
                heads over 1 KV head of 120, window 4096: B 16 x S 4096 of
                train_4k and B 2 x S 8192 for prefill_32k's S 32768, which
                the oracle cannot hold) against the oracle and the chunked
                plain version, timed; then rank 0 of the 16 x 16 fake group
                runs h2o_danube3_4b's rank-local programs at full width and
                depth, through build_cell: train_4k (B 16 x S 4096 a rank,
                2 of 32 query heads, a vocab piece of 2000; one cold step
                and 3 warm ones) and prefill_32k (B 2 x S 32768 a rank). A
                fake group's collectives leave their outputs as they were,
                so these runs check shapes, launches and memory, never
                values: every flash_attention launch on the kernel at the
                local shapes (its Decision's cost that of q [B, S, 2, 120]
                over one KV head), the warm step time, and
                max_memory_allocated (less what was allocated before)
                beside the dry run's argument + temp bytes for the same
                cell, with the ratio.

The kernel phase's floatsd4_matmul layer-plane rows: a [24, K, N] leaf of
each dense site shape, layers 22 and 23 bit for bit against the plain
version on FP8 and FP16 activations at M 1, 8 and 2048, timed beside the
plain version, torch.matmul on the decoded layer and the bound, the tied
head beside them; an odd L (the pad nibble), L 40 (the second exponent
plane, subnormal weights) and N 1000, every layer bit for bit.

The kernel phase's flash_attention training rows (the dense prefill's
shape and [1,8192,32,120] under the window): the kernel's log-sum-exp
output against the plain version's (1e-4 + 1e-5 |lse|), o bit-identical
with and without it, the kernel's time with and without it, and the plain
backward flash_bwd's time beside scaled_dot_product_attention's forward +
backward.

Phase 3 ends with the cost ledger: every timed kernel row's launch cost
model recorded with its measured time (STATS.add_time), LEDGER.table()
printed with each row's achieved GB/s and GFLOP/s, and each row's bound from
the plain version's cost model (device-memory bytes over 3.35 TB/s or 2 x
MACs over the operands' peak) held within 1% of its hand bound, or the
reason printed (the f32 flash rows: the hand bound counts the kernel's
six-piece bf16 QK^T); then the cost models' mirrors against the libraries:
the scratch of rwkv_wkv and flash_attention, each launcher's dynamic shared
memory, and every kernel function's static shared memory against ptxas's.
Phase 4 adds the ledger's host cost: one decode-shape floatsd_matmul call's
bookkeeping over 10,000 calls, x 7 calls a step, under 2% of the main
path's median decode step.

The second-to-last line is nvidia-smi's name/power-limit line, the line
before it the kernels' JSON record, and the last line the result JSON.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
LANES, CHUNK, REQUESTS, MAX_NEW = 8, 8, 16, 16
MARGIN_FLOOR = 1e-5  # top-2 logit gap below which a greedy choice is a near-tie
TRAIN_STEPS, XCHECK_STEPS = 5, 3  # the first train step is the warm-up
TRAIN_ARGS = ["--task", "wikitext2", "--full", "--log-every", "1", "--seed", str(SEED)]
LOSS_RTOL = 1e-3  # kernel vs plain losses: the JAX package's kernel-vs-reference bound
PARAM_RTOL = 1e-3  # kernel vs plain masters, per leaf, relative to the plain run's change
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, the FP32 rate outside the tensor cores, and the TF32 and 16-bit
# (bf16, fp16) tensor-core rates, which a matmul's bound uses when every
# operand value is a value of that type (the card could then form the exact
# products on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# Operations the functions need, per element. A count against a sorted grid
# of midpoints needs only a bisection: 6 compares for 64 midpoints (or 42).
# A quantized sigmoid gate: exp, add, divide, 6 compares, the grid lookup
GATE_OPS = 10
# one (b, j) of the cell: 3 gates + 2 tanh + 2 e5m2 conversions + 3
# multiplies + 1 add
CELL_OPS = 3 * GATE_OPS + 8
# the backward recomputes that, adds 3 smooth sigmoids and a tanh (10) and
# 22 multiplies and adds of the derivative products
CELL_BWD_OPS = CELL_OPS + 10 + 22
# the quantize kernel: scale multiply, clamp, 6 compares, the code lookup,
# the sign select
QUANT_OPS = 10
# qsigmoid: the negated |x|, a gate, the mirror's subtract and select
QSIG_OPS = GATE_OPS + 3
F32_SWEEP_LOG2_CHUNK = 26  # the all-f32 sweeps' chunk: the plain versions hold ~40 B an element at once
# FloatSD4 store of the full-width model: per 2-D leaf ceil(K/2)*N code bytes +
# ceil(K/32)*N exponent bytes (embedding [33280,1024], four [1024,4096] gate
# weights), plus the two f32 [4096] biases
FLOATSD4_BYTES = (16640 * 1024 + 1040 * 1024) + 4 * (512 * 4096 + 32 * 4096) + 2 * 4096 * 4
assert FLOATSD4_BYTES == 27_049_984
SPIN_CYCLES = 40_000_000  # ~20 ms of device time: longer than the host needs to enqueue a timing loop


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


#: every timed kernel row of phase 3 with its dispatch op, its shape's cost
#: models (the plain version's and the launch's) and the peak the cost
#: model's bound uses: (op, what, row, ref Cost, cuda Cost, peak)
COSTED: list = []


def costed(row: dict, op: str, what: str, *dims, peak: str | None = None, cuda_kw=None, **kw) -> dict:
    """Attach ``op``'s cost models at ``dims`` to a kernel row (for the
    ledger phase); ``peak`` defaults to the row's bound's single type."""
    from repro_torch.kernels.dispatch import COST_SPECS

    fn = COST_SPECS[op].fn
    peak = peak or (row["ops_peak"] if "+" not in row["ops_peak"] else "fp32")
    COSTED.append((op, what, row, fn(*dims, backend="ref", **kw), fn(*dims, backend="cuda", **kw, **(cuda_kw or {})),
                   peak))
    return row


def bound(nbytes: float, ops, peak: str = "fp32") -> dict:
    """The least time for the work: bytes moved over the HBM rate, or the
    operations over the peak rate for their type, whichever is larger (ms).
    ``ops`` is a count at ``peak``, or a list of (count, peak) pairs for
    work of several types, whose times add."""
    parts = ops if isinstance(ops, list) else [(ops, peak)]
    rate = {"fp32": FP32_OPS_PER_S, "tf32": TF32_OPS_PER_S, "bf16": BF16_OPS_PER_S}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / rate[pk] for n, pk in parts) * 1e3
    return dict(bytes_ms=t_bytes, ops_ms=t_ops, ops_peak="+".join(dict.fromkeys(pk for _, pk in parts)),
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def matmul_peak(*operands) -> str:
    """The fastest tensor-core type that holds every operand value, so that
    the card could form the exact products there: "bf16" (the 16-bit peak)
    when every operand holds bf16 values only (an f32 whose low 16 bits are
    0), or every operand fp16 values only: FP8 activations are both, FP16
    ones fp16, and a decoded FloatSD8 weight without its power-of-two bias
    both (pass it so: ``floatsd.decode(codes, 0)``). "tf32" when every value
    is a TF32 value (low 13 bits 0). Else "fp32"."""
    import torch

    def low_zero(t, bits):
        return bool(((t.float().contiguous().view(torch.int32) & ((1 << bits) - 1)) == 0).all())

    def fp16(t):
        t = t.float()
        return bool((t.half().float() == t).all())

    if all(low_zero(t, 16) for t in operands) or all(fp16(t) for t in operands):
        return "bf16"
    return "tf32" if all(low_zero(t, 13) for t in operands) else "fp32"


def matmul_vs_plain(torch, x, codes, bias, tr, served: bool, what: str, ordered: bool = False):
    """floatsd_matmul against its plain version on the card: within the
    precise bound (1e-5 of |x| @ |W|) on either route; on route A with served
    activations (FP8/FP16: every product exact, the same sum order) bit for
    bit; two launches bit-identical. Returns (kernel's y, max error, outputs
    not bit-identical, route)."""
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, plan
    from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref

    m, k = x.shape
    route = plan(m, codes.shape[0] if tr else codes.shape[1], k, ordered).route
    y = floatsd_matmul(x, codes, bias, transposed=tr, ordered=ordered)
    y2 = floatsd_matmul(x, codes, bias, transposed=tr, ordered=ordered)
    y_ref = floatsd_matmul_ref(x, codes, bias, transposed=tr, ordered=ordered)
    torch.cuda.synchronize()
    err = (y.double() - y_ref.double()).abs()
    check(bool((err <= matmul_tol(torch, x, codes, bias, tr)).all()), f"{what} (route {route}) exceeds 1e-5")
    check(torch.equal(y, y2), f"{what} (route {route}): two launches differ")
    mism = int((y != y_ref).sum())
    check(route != "A" or not served or mism == 0,
          f"{what} (route A, served activations): {mism} outputs differ from the plain version")
    del y2, y_ref
    return y, float(err.max()), mism, route


def matmul_tol(torch, x, codes, bias, tr):
    """The precise contract's bound, 1e-5 * (|x| @ |W|) + 1e-30, in f64."""
    from repro_torch.core import floatsd

    wd = floatsd.decode(codes, bias).double().abs()
    return 1e-5 * (x.double().abs() @ (wd.t() if tr else wd)) + 1e-30


def moved_code_control(torch, x, codes, bias, tr, y) -> int:
    """Negative control: the plain version on the codes with one code moved
    one mantissa step (the first with a positive mantissa below the top)
    must differ from the kernel's y by more than the bound on some output;
    returns how many it does."""
    from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref

    flat = codes.reshape(-1)
    mant = (flat & 31).long()
    i = int(((mant > 15) & (mant < 30)).nonzero()[0])
    moved = flat.clone()
    moved[i] += 1
    y_moved = floatsd_matmul_ref(x, moved.reshape(codes.shape), bias, transposed=tr)
    beyond = int(((y.double() - y_moved.double()).abs() > matmul_tol(torch, x, codes, bias, tr)).sum())
    check(beyond > 0, "floatsd_matmul: the bound does not reject a code moved one mantissa step")
    return beyond


def fmt_bound(bd: dict) -> str:
    return (f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}; bytes {bd['bytes_ms']:.5f} ms, operations "
            f"{bd['ops_ms']:.5f} ms at the {bd['ops_peak'].upper().replace('+', ' + ')} peak)")


def ptxas_report(log: str) -> list[str]:
    """ptxas's per-function lines of a build log, one string each: the
    function (its name without the mangling), registers, shared memory,
    spills."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((part for part in ("flash_split_kv", "flash_fwd_kernel", "wkv_chunk_prep", "rwkv_wkv_kernel",
                                           "split_pieces", "add_partials") if part in mangled), mangled[-48:])
            name += "<f32>" if "IfLi" in mangled or "IfEE" in mangled else "<bf16>" if "bfloat16" in mangled else ""
            for dp in ("Li64", "Li128"):
                if dp in mangled:
                    name += f"[{dp[2:]}]"
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}" if "registers" in line else f"{name}: {line.strip()}")
    return [x for x in out if "registers" in x or "0 bytes spill stores" not in x]


def cuobjdump(build, op: str, flag: str) -> str | None:
    """cuobjdump's ``flag`` listing of ``op``'s library (the CUDA toolkit's
    tool), or None without cuobjdump."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    cands = ([str(Path(CUDA_HOME) / "bin" / "cuobjdump")] if CUDA_HOME else []) + [shutil.which("cuobjdump") or ""]
    tool = next((c for c in cands if c and Path(c).exists()), None)
    if tool is None:
        return None
    return subprocess.run([tool, flag, str(build._target(op)[0])], capture_output=True, text=True, timeout=120,
                          check=True).stdout


def sass(build, op: str) -> str | None:
    """The SASS of ``op``'s library, or None without cuobjdump."""
    return cuobjdump(build, op, "-sass")


def res_usage(build, op: str) -> list[str]:
    """Registers and local memory (where spills go) of each kernel function
    in ``op``'s library, read from the built library by cuobjdump
    -res-usage: the report for a library this process loaded from the build
    cache, whose ptxas output it never saw."""
    text = cuobjdump(build, op, "-res-usage")
    if text is None:
        return ["cached build, not reported (no ptxas log, cuobjdump not found)"]
    out = []
    for name, usage in re.findall(r"Function (\S+?):?\s*\n\s*(REG:.*)", text):
        m = re.search(r"_kernelI(.*?)EEv", name)
        fields = dict(re.findall(r"(\w+):(\d+)", usage))
        out.append(f"<{m.group(1) if m else name}>: {fields.get('REG')} registers, {fields.get('LOCAL')} bytes local "
                   "(cuobjdump -res-usage of the cached build)")
    return out or ["cached build, not reported (cuobjdump -res-usage listed no function)"]


def sass_count(build, op: str, opcodes) -> dict | None:
    """How many instructions of each opcode the SASS of ``op``'s library
    holds, or None without cuobjdump."""
    text = sass(build, op)
    if text is None:
        return None
    words = [w.split(".")[0] for line in text.splitlines() for w in line.replace(";", " ").split()]
    return {code: words.count(code) for code in opcodes}


def _stored_per_element(op: str, args: str) -> int:
    """Bytes an element of an element-wise kernel stores: qsigmoid its output
    (2 for fp16/bf16), the cell backward dz (4 f32) + dc_prev (f32), the cell
    h (f32) + c (fp16 or f32), the quantize kernel a code; ``args`` are the
    mangled template arguments (the cell's: CIn, COut, then the quantizer
    flag as ``Lb0E`` or ``Lb1E``)."""
    if op == "qsigmoid":
        return 2 if ("half" in args or "bfloat16" in args) else 4
    if op == "lstm_cell_bwd":
        return 20
    if op == "floatsd_quantize":
        return 1
    c_out = re.sub(r"Lb[01]E$", "", args)
    return 6 if (c_out.endswith("6__half") or c_out.endswith("S1_")) else 8


def sass_per_element(build, op: str) -> dict | None:
    """SASS instructions an element of each kernel function in ``op``'s
    library: the static instructions of its store loop (of the backward
    branches whose body stores, the longest) or, where no loop stores, of
    the whole function, over the elements that body stores (STG widths over
    the bytes an element stores). Keyed by the function's template
    arguments as mangled; None without cuobjdump."""
    text = sass(build, op)
    if text is None:
        return None
    widths = (("128", 16), ("64", 8), ("16", 2), ("8", 1))
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split()[0]
        m = re.search(r"_kernelI(.*?)EEv", name)
        args = m.group(1) if m else name
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        ins = [(a, t) for a, t in ins if not t.startswith("NOP")]

        def stored(body):
            ops = [re.sub(r"^@!?U?P[T0-9]+\s+", "", t).split()[0] for t in body]
            return sum(next((v for k, v in widths if o.endswith(k)), 4) for o in ops if o.startswith("STG"))

        loops = []
        for a, t in ins:
            br = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", t)
            if br and int(br.group(1), 16) < a:
                loops.append([u for b, u in ins if int(br.group(1), 16) <= b <= a])
        loops = [body for body in loops if stored(body)]
        body = max(loops, key=len) if loops else [t for _, t in ins]
        out[args] = dict(instructions=len(ins), body=len(body), loop=bool(loops),
                         per_element=len(body) * _stored_per_element(op, args) / max(1, stored(body)))
    return out


def fmt_sass(per: dict | None) -> str:
    if per is None:
        return "SASS: cuobjdump not found"
    return "SASS instructions an element " + ", ".join(
        f"<{k}> {v['per_element']:.1f} ({'loop' if v['loop'] else 'kernel'} of {v['body']})" for k, v in per.items())


def element_report(build, op: str, floor_ms: float) -> str:
    """ptxas's registers and spills, SASS instructions an element and the
    timing floor, for one element-wise kernel's rows."""
    regs = ptxas_report(build.build_log(op)) or res_usage(build, op)
    return (f"  {op}: ptxas " + "; ".join(regs) + f" | {fmt_sass(sass_per_element(build, op))}"
            f" | timing floor {floor_ms:.4f} ms (the timer around a one-element torch.neg)")


def odd_view(torch, t):
    """t's values in a contiguous view one element into a larger buffer (not
    16-byte aligned)."""
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    v.copy_(t)
    return v


def timed_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of one call, by CUDA events, with L2 flushed
    before each call (the serving path meets each weight cold). A spin
    kernel first keeps the device busy while the host enqueues the loop,
    so the host's launch overhead stays out of the events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in pairs:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def mm_row(torch, flush, x, codes, bias, tr, served: bool, what: str, ordered: bool = False,
           route_b: bool = False) -> dict:
    """floatsd_matmul at one shape: ``matmul_vs_plain``'s checks, then the
    kernel, its plain version and torch.matmul timed (L2 flushed). With
    ``route_b``, where this M plans route B, also the unordered launch's
    time. Prints the row and returns it."""
    from repro_torch.core import floatsd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, plan
    from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref, no_tf32

    (m, k), n = x.shape, codes.shape[0] if tr else codes.shape[1]
    y, err, mism, route = matmul_vs_plain(torch, x, codes, bias, tr, served, f"floatsd_matmul {what} {m}x{k}x{n}",
                                          ordered)
    del y
    wd = floatsd.decode(codes, bias)
    wk = wd.t() if tr else wd
    with no_tf32():
        t = timed_ms(torch, lambda: floatsd_matmul(x, codes, bias, transposed=tr, ordered=ordered), 20, flush)
        t_plain = timed_ms(torch, lambda: floatsd_matmul_ref(x, codes, bias, transposed=tr, ordered=ordered),
                           3, flush)
        t_lib = timed_ms(torch, lambda: torch.matmul(x, wk), 20, flush)
    row = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=err, route=route,
               **bound(x.numel() * 4 + codes.numel() + 4 + m * n * 4, 2.0 * m * n * k,
                       matmul_peak(x, floatsd.decode(codes, 0))))
    extra = ""
    if route_b and plan(m, n, k).route == "B":
        row["route_b_ms"] = timed_ms(torch, lambda: floatsd_matmul(x, codes, bias, transposed=tr), 20, flush)
        extra = f"; route B (unordered) {row['route_b_ms']:.4f} ms"
    print(f"  {what:6s} [{m},{k}] x {'[N,K]^T' if tr else '[K,N]'} N={n}, route {route}"
          f"{' (ordered)' if ordered else ''}: max_abs_err {err:.3e}, {mism} of {m * n} not bit-identical, "
          f"two launches bit-identical | kernel {t:.4f} ms{extra}, plain {t_plain:.3f} ms, torch.matmul "
          f"{t_lib:.4f} ms, {fmt_bound(row)}", flush=True)
    return costed(row, "floatsd_matmul", f"{what} [{m},{k}]x[{k},{n}]", m, k, n, cuda_kw=dict(ordered=ordered))


def dx_row(torch, flush, gr, codes, bias, ordered: bool) -> dict:
    """matmul_dx (g [M, N] @ codes [K, N]^T) at one shape against its plain
    version (|err| <= 1e-5 * (|g| @ |W|^T)), two launches bit-identical,
    then timed beside the plain version and torch.matmul. Prints the row
    and returns it."""
    from repro_torch.core import floatsd
    from repro_torch.kernels.floatsd_matmul.ops import matmul_dx, plan
    from repro_torch.kernels.floatsd_matmul.ref import matmul_dx_ref, no_tf32

    (m, n), k = gr.shape, codes.shape[0]
    wd = floatsd.decode(codes, bias)
    y, y2 = matmul_dx(gr, codes, bias, ordered=ordered), matmul_dx(gr, codes, bias, ordered=ordered)
    y_ref = matmul_dx_ref(gr, codes, bias, ordered=ordered)
    torch.cuda.synchronize()
    err = (y.double() - y_ref.double()).abs()
    route = plan(m, k, n, ordered).route
    check(bool((err <= 1e-5 * (gr.double().abs() @ wd.double().abs().t()) + 1e-30).all()),
          f"matmul_dx {m}x{n} -> {k} (route {route}) exceeds 1e-5")
    check(torch.equal(y, y2), f"matmul_dx {m}x{n} -> {k} (route {route}): two launches differ")
    mism = int((y != y_ref).sum())
    with no_tf32():
        t = timed_ms(torch, lambda: matmul_dx(gr, codes, bias, ordered=ordered), 20, flush)
        t_plain = timed_ms(torch, lambda: matmul_dx_ref(gr, codes, bias, ordered=ordered), 3, flush)
        t_lib = timed_ms(torch, lambda: torch.matmul(gr, wd.t()), 20, flush)
    row = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=float(err.max()), route=route,
               **bound(gr.numel() * 4 + codes.numel() + 4 + m * k * 4, 2.0 * m * n * k,
                       matmul_peak(gr, floatsd.decode(codes, 0))))
    print(f"  [{m},{n}] x codes[{k},{n}]^T, route {route}{' (ordered)' if ordered else ''}: max_abs_err "
          f"{row['err']:.3e}, {mism} of {m * k} not bit-identical, two launches bit-identical | kernel {t:.4f} ms, "
          f"plain {t_plain:.3f} ms, torch.matmul {t_lib:.4f} ms, {fmt_bound(row)}", flush=True)
    return costed(row, "floatsd_matmul_dx", f"[{m},{n}]xcodes[{k},{n}]^T", m, n, k, cuda_kw=dict(ordered=ordered))


def dw_row(torch, flush, x, gr, quant: bool) -> dict:
    """matmul_dw (x [M, K]^T @ g [M, N]) at one shape against its plain
    version (quant=False: |err| <= 1e-5 * (|x|^T @ |g|); quant=True: at most
    0.1% of outputs differ, each by at most one e5m2 step), two launches
    bit-identical, then timed beside the plain version and torch.matmul
    (no snap). Prints the row and returns it."""
    from repro_torch.kernels.floatsd_matmul.ops import matmul_dw
    from repro_torch.kernels.floatsd_matmul.ref import matmul_dw_ref, no_tf32

    (m, k), n = x.shape, gr.shape[1]
    y, y2, y_ref = matmul_dw(x, gr, quant=quant), matmul_dw(x, gr, quant=quant), matmul_dw_ref(x, gr, quant)
    torch.cuda.synchronize()
    err = (y.double() - y_ref.double()).abs()
    off = y != y_ref
    if quant:
        step = torch.exp2(torch.floor(torch.log2(torch.maximum(y.abs(), y_ref.abs()).clamp(min=2.0**-14))) - 2)
        check(int(off.sum()) <= 1e-3 * y.numel() and bool((err[off] <= step[off]).all()),
              f"matmul_dw quant {m}x{k}x{n}: {int(off.sum())} outputs differ")
    else:
        check(bool((err <= 1e-5 * (x.double().abs().t() @ gr.double().abs()) + 1e-30).all()),
              f"matmul_dw {m}x{k}x{n} exceeds 1e-5")
    check(torch.equal(y, y2), f"matmul_dw quant={quant} {m}x{k}x{n}: two launches differ")
    with no_tf32():
        t = timed_ms(torch, lambda: matmul_dw(x, gr, quant=quant), 10, flush)
        t_plain = timed_ms(torch, lambda: matmul_dw_ref(x, gr, quant), 3, flush)
        t_lib = timed_ms(torch, lambda: torch.matmul(x.t(), gr), 10, flush)
    row = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=float(err.max()),
               **bound(4.0 * (m * k + m * n + k * n), 2.0 * m * k * n, matmul_peak(x, gr)))
    print(f"  quant={quant} [{m},{k}]^T x [{m},{n}]: max_abs_err {row['err']:.3e}, {int(off.sum())} of "
          f"{k * n} not bit-identical, two launches bit-identical | kernel {t:.4f} ms "
          f"({2.0 * m * k * n / t / 1e9:.1f} TFLOP/s, {t / row['bound_ms']:.2f}x the bound, {t / t_lib:.2f}x "
          f"torch.matmul), plain {t_plain:.3f} ms, torch.matmul(x.t(), g) (no FP8 snap) {t_lib:.4f} ms, "
          f"{fmt_bound(row)}", flush=True)
    return costed(row, "floatsd_matmul_dw", f"quant={quant} [{m},{k}]^Tx[{m},{n}]", k, m, n, quant=quant)


def cell_row(torch, flush, z, c, what: str = "") -> dict:
    """lstm_cell at one shape against its plain version, bit for bit, two
    launches bit-identical, then timed. Prints the row and returns it."""
    from repro_torch.kernels.lstm_cell.ops import lstm_cell
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    b, h = c.shape
    h_k, c_k = lstm_cell(z, c)
    h_2, c_2 = lstm_cell(z, c)
    h_r, c_r = lstm_cell_ref(z, c)
    torch.cuda.synchronize()
    flips = int(((h_k != h_r) | (c_k != c_r)).sum())
    err = max(float((h_k - h_r).abs().max()), float((c_k.float() - c_r.float()).abs().max()))
    check(flips == 0, f"lstm_cell {b}x{h}{what}: {flips} outputs differ, max err {err}")
    check(torch.equal(h_k, h_2) and torch.equal(c_k, c_2), f"lstm_cell {b}x{h}{what}: two launches differ")
    t = timed_ms(torch, lambda: lstm_cell(z, c), 50, flush)
    t_plain = timed_ms(torch, lambda: lstm_cell_ref(z, c), 10, flush)
    row = dict(ms=t, plain_ms=t_plain, err=err,
               **bound(b * 4 * h * 4 + b * h * 2 + b * h * 4 + b * h * 2, float(b * h * CELL_OPS)))
    print(f"  [{b},{4 * h}] -> h,c [{b},{h}]{what}: max_abs_err {err:.3e}, {flips} of {b * h} differ, two "
          f"launches bit-identical | kernel {t:.4f} ms, plain {t_plain:.3f} ms, {fmt_bound(row)}", flush=True)
    return costed(row, "lstm_cell", f"[{b},{4 * h}]{what}", b, h, peak="fp32")


def cell_grad_row(torch, flush, z, c, dh, dc, what: str = "") -> dict:
    """lstm_cell_grad at one shape against its plain version, bit for bit,
    two launches bit-identical, then timed. Prints the row and returns it."""
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_grad
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_bwd_ref

    b, h = c.shape
    dz, dcp = lstm_cell_grad(z, c, dh, dc)
    dz2, dcp2 = lstm_cell_grad(z, c, dh, dc)
    dz_r, dcp_r = lstm_cell_bwd_ref(z, c.float(), dh, dc)
    torch.cuda.synchronize()
    flips = int((dz != dz_r).sum()) + int((dcp != dcp_r).sum())
    err = max(float((dz - dz_r).abs().max()), float((dcp - dcp_r).abs().max()))
    check(flips == 0, f"lstm_cell_grad {b}x{h}{what}: {flips} outputs differ, max err {err}")
    check(torch.equal(dz, dz2) and torch.equal(dcp, dcp2), f"lstm_cell_grad {b}x{h}{what}: two launches differ")
    t = timed_ms(torch, lambda: lstm_cell_grad(z, c, dh, dc), 50, flush)
    t_plain = timed_ms(torch, lambda: lstm_cell_bwd_ref(z, c.float(), dh, dc), 10, flush)
    row = dict(ms=t, plain_ms=t_plain, err=err, **bound(46.0 * b * h, float(b * h * CELL_BWD_OPS)))
    print(f"  [{b},{4 * h}] + 3 x [{b},{h}] -> dz, dc_prev{what}: max_abs_err {err:.3e}, {flips} differ, two "
          f"launches bit-identical | kernel {t:.4f} ms, plain {t_plain:.3f} ms, {fmt_bound(row)}", flush=True)
    return costed(row, "lstm_cell_grad", f"[{b},{4 * h}]{what}", b, h, peak="fp32")


def kernel_phase(torch, dev, flush, floor_ms):
    from repro_torch.core import floatsd
    from repro_torch.core.fp8 import FP16, quantize_fp8
    from repro_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(SEED)
    mm = {}
    # (site, M, K, N, codes stored [N, K], activation quantizer, ordered):
    # the gate matmul (M = lanes, every time step; and at 64 rows, the
    # training batch), the tied head at decode (M = lanes) and prefill (M =
    # lanes * chunk), the training backward's recompute of all zs (M = S * B,
    # on the ordered route, as the fused BPTT asks), and a ragged shape
    shapes = [
        ("gate", 8, 1024, 4096, False, "fp8", False),
        ("gate", 64, 1024, 4096, False, "fp8", False),
        ("head", 8, 1024, 33280, True, "fp16", False),
        ("head", 64, 1024, 33280, True, "fp16", False),
        ("remat", 3072, 1024, 4096, False, "fp8", True),
        ("ragged", 3, 100, 130, False, None, False),
    ]
    print("kernels: floatsd_matmul vs plain version (both routes |err| <= 1e-5 * (|x| @ |W|) and two launches "
          "bit-identical; route A on FP8/FP16 activations bit for bit)")
    for site, m, k, n, tr, act, ordered in shapes:
        x = torch.randn((m, k), device=dev, generator=g)
        if act == "fp8":
            x = quantize_fp8(x)
        elif act == "fp16":
            x = quantize_fp8(x, FP16)
        w = torch.randn((n, k) if tr else (k, n), device=dev, generator=g) * (0.02 if tr else 0.03)
        codes, bias = floatsd.encode(w)
        mm[(site, m)] = mm_row(torch, flush, x, codes, int(bias), tr, act is not None, site, ordered)

    print("kernels: lstm_cell vs plain version (bit for bit; two launches bit-identical)")
    print(element_report(_build, "lstm_cell", floor_ms))
    cell = {}
    # the decode and train shapes, a ragged one, H = 1023 (no vector width
    # divides it), and the train shape with c_prev at an odd fp16 offset
    for b, h, odd in [(8, 1024, False), (64, 1024, False), (5, 200, False), (64, 1023, False), (64, 1024, True)]:
        z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
        c = torch.randn((b, h), device=dev, generator=g).to(torch.float16)
        if odd:
            c = odd_view(torch, c)
        cell[(b, h, odd) if odd else (b, h)] = cell_row(torch, flush, z, c,
                                                        ", c_prev at an odd fp16 offset" if odd else "")

    print("kernels: matmul_dx (floatsd_matmul.cu on codes [K,N] read as [out, contraction]) vs plain "
          "version (tolerance |err| <= 1e-5 * (|g| @ |W|^T); two launches bit-identical)")
    dx = {}
    # g [M, N], codes [K, N]: the recurrence's per-step dh, and the batched dXs
    # (on the ordered route, as the fused BPTT asks)
    for m, k, n in [(64, 1024, 4096), (3072, 1024, 4096)]:
        gr = torch.randn((m, n), device=dev, generator=g) * 1e-2
        codes, bias = floatsd.encode(torch.randn((k, n), device=dev, generator=g) * 0.03)
        dx[m] = dx_row(torch, flush, gr, codes, int(bias), ordered=m > 64)

    print("kernels: matmul_dw vs plain version (quant=False: |err| <= 1e-5 * (|x|^T @ |g|); quant=True: "
          "at most 0.1% of outputs differ, each by at most one e5m2 step; two launches bit-identical)")
    m, k, n = 3072, 1024, 4096  # S*B rows; dWx and dWh at the full width
    x = quantize_fp8(torch.randn((m, k), device=dev, generator=g))
    gr = torch.randn((m, n), device=dev, generator=g) * 1e-2
    dw = {quant: dw_row(torch, flush, x, gr, quant) for quant in (True, False)}

    print("kernels: lstm_cell_grad vs plain version (bit for bit; two launches bit-identical)")
    print(element_report(_build, "lstm_cell_bwd", floor_ms))
    cell_bwd = {}
    # the train shape, a ragged one, H = 1023, and the train shape with
    # c_prev at an odd fp16 offset (cs_prev[t] when B * H % 8 != 0)
    for b, h, odd in [(64, 1024, False), (5, 200, False), (64, 1023, False), (64, 1024, True)]:
        z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
        c = torch.randn((b, h), device=dev, generator=g).to(torch.float16)  # fp16 storage, as trained
        if odd:
            c = odd_view(torch, c)
        dh, dc = (torch.randn((b, h), device=dev, generator=g) for _ in range(2))
        cell_bwd[(b, h, odd) if odd else (b, h)] = cell_grad_row(
            torch, flush, z, c, dh, dc, ", c_prev at an odd fp16 offset" if odd else "")
    return mm, cell, dx, dw, cell_bwd


def kernel_phase4(torch, dev, flush, floor_ms):
    """Phase 3, continued: floatsd4_matmul, the quantize kernel and the
    qsigmoid kernel against their plain versions."""
    from repro_torch.core import floatsd, floatsd4
    from repro_torch.core.fp8 import FP16, quantize_fp8
    from repro_torch.core.qsigmoid import qsigmoid_raw
    from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul
    from repro_torch.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref
    from repro_torch.kernels.floatsd_matmul.ref import no_tf32, plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.qsigmoid.ops import qsigmoid

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    mm4 = {}
    # (site, M, K, N, table stored [N, K], activation quantizer): the gate
    # matmul at decode (M = lanes) and prefill (M = lanes * chunk), the
    # tied head at both, and an odd K (999, K % 32 != 0) in both layouts,
    # the transposed one with an odd number of table rows
    shapes = [
        ("gate", 8, 1024, 4096, False, "fp8"),
        ("gate", 64, 1024, 4096, False, "fp8"),
        ("head", 8, 1024, 33280, True, "fp16"),
        ("head", 64, 1024, 33280, True, "fp16"),
        ("ragged", 5, 999, 300, False, "fp8"),
        ("ragged-t", 5, 999, 301, True, "fp8"),
    ]
    print("kernels: floatsd4_matmul vs plain version (bit for bit: FP8/FP16 activations times FloatSD4 "
          "weights are exact in f32)")
    for site, m, k, n, tr, act in shapes:
        x = torch.randn((m, k), device=dev, generator=g)
        x = quantize_fp8(x, FP16) if act == "fp16" else quantize_fp8(x)
        rows = n if tr else k
        w = torch.randn((rows, k if tr else n), device=dev, generator=g) * (0.02 if tr else 0.03)
        c4, exps = floatsd4.encode(w)
        codes = floatsd4.pack_nibbles(c4)
        wd = floatsd4.decode_packed(codes, exps, rows)
        wk = wd.t() if tr else wd
        y = floatsd4_matmul(x, codes, exps, rows, transposed=tr)
        y_ref = floatsd4_matmul_ref(x, codes, exps, rows, transposed=tr)
        torch.cuda.synchronize()
        err = float((y.double() - y_ref.double()).abs().max())
        mism = int((y != y_ref).sum())
        check(mism == 0, f"floatsd4_matmul {site} {m}x{k}x{n}: {mism} outputs differ (max err {err})")
        with no_tf32():
            t = timed_ms(torch, lambda: floatsd4_matmul(x, codes, exps, rows, transposed=tr), 20, flush)
            t_plain = timed_ms(torch, lambda: floatsd4_matmul_ref(x, codes, exps, rows, transposed=tr), 3,
                               flush)
            t_lib = timed_ms(torch, lambda: torch.matmul(x, wk), 20, flush)
        bd = bound(x.numel() * 4 + codes.numel() + exps.numel() + m * n * 4, 2.0 * m * n * k, matmul_peak(x, wd))
        p = plan(m, n, k, ordered=True)
        mm4[(site, m)] = costed(dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=err, route=p.route, **bd),
                                "floatsd4_matmul", f"{site} [{m},{k}]x[{k},{n}]", m, k, n,
                                wt_nbytes=codes.numel() + exps.numel())
        print(f"  {site:8s} [{m},{k}] x {'table[N,K]^T' if tr else '[K,N]'} N={n}, route {p.route} (ordered, "
              f"{p.splits} chunks of {p.chunk} k): max_abs_err {err:.3e}, {mism} of {m * n} differ | kernel "
              f"{t:.4f} ms ({t / t_lib:.2f}x torch.matmul), plain {t_plain:.3f} ms, torch.matmul on the decoded f32 "
              f"weight {t_lib:.4f} ms, {fmt_bound(bd)}")

    print("kernels: floatsd_quantize vs core.floatsd.encode (byte for byte; two launches bit-identical)")
    print(element_report(_build, "floatsd_quantize", floor_ms))
    quant = {}
    grid = torch.as_tensor(floatsd._GRID_POS, dtype=torch.float32, device=dev)
    mids = torch.as_tensor(floatsd._GRID_MID, dtype=torch.float32, device=dev)
    edge = torch.cat([grid, mids, torch.nextafter(mids, torch.full_like(mids, 1e9)),
                      torch.tensor([600.0, 1e4], device=dev)])
    edge = torch.cat([torch.tensor([0.0, -0.0], device=dev), edge, -edge])
    # the entry pass's shapes (the gate weights, the tied embedding), a
    # ragged length, and views at an odd start offset of a ragged length
    cases = [("weight", (1024, 4096), torch.float32, 0), ("table", (33280, 1024), torch.float32, 0),
             ("flat", (1_000_003,), torch.float32, 0), ("weight16", (1024, 4096), torch.float16, 0),
             ("table16", (33280, 1024), torch.float16, 0), ("odd", (1_000_003,), torch.float32, 3),
             ("odd16", (1_000_003,), torch.float16, 7)]
    for name, shape, dt, offset in cases:
        x = (torch.randn(shape, device=dev, generator=g) * 0.03).to(dt)
        if offset:
            x = torch.empty(x.numel() + offset, dtype=dt, device=dev)[offset:].view(shape).copy_(x)
        bias = floatsd.fit_bias(x)
        codes, again = floatsd_quantize(x, bias), floatsd_quantize(x, bias)
        want = floatsd.encode(x, bias)[0]
        torch.cuda.synchronize()
        mism = int((codes != want).sum())
        check(mism == 0, f"quantize {name} {shape}: {mism} codes differ")
        check(torch.equal(codes, again), f"quantize {name} {shape}: two launches differ")
        t = timed_ms(torch, lambda: floatsd_quantize(x, bias), 20, flush)
        t_plain = timed_ms(torch, lambda: floatsd.encode(x, bias), 5, flush)
        bd = bound(x.numel() * (x.element_size() + 1) + 4, float(x.numel() * QUANT_OPS))
        quant[name] = costed(dict(ms=t, plain_ms=t_plain, library_ms=None, err=0.0, **bd), "floatsd_quantize",
                             f"{name} {list(shape)}", x.numel(), x_bytes=x.element_size())
        print(f"  {name:8s} {list(shape)} {str(dt)[6:]}{f', {offset} elements past a 16-element boundary' if offset else ''}: "
              f"{mism} of {x.numel()} codes differ, two launches bit-identical | kernel {t:.4f} ms, "
              f"plain {t_plain:.3f} ms, {fmt_bound(bd)}; no library call")
    for bias in (-126, 127):
        n_vals = 0
        for dt in (torch.float32, torch.float16):
            x = (edge * 2.0 ** max(-126, min(120, bias))).to(dt)
            x = x[torch.isfinite(x)]  # no code for inf
            mism = int((floatsd_quantize(x, bias) != floatsd.encode(x, bias)[0]).sum())
            check(mism == 0, f"quantize edge values at bias {bias} ({dt}): {mism} codes differ")
            n_vals += x.numel()
        print(f"  edge values (±0, grid points, midpoints and their neighbours, above the top) at bias {bias}, "
              f"f32 and fp16: 0 of {n_vals} codes differ")
    # every finite fp16 bit pattern at four biases, and every finite f32 bit
    # pattern at bias 0, in chunks, against the plain version
    t0 = time.perf_counter()
    x16 = torch.arange(-2**15, 2**15, dtype=torch.int32, device=dev).to(torch.int16).view(torch.float16)
    x16 = x16[torch.isfinite(x16)]
    for bias in (-126, -7, 0, 120):
        mism = int((floatsd_quantize(x16, bias) != floatsd.encode(x16, bias)[0]).sum())
        check(mism == 0, f"quantize: {mism} of the finite fp16 bit patterns differ at bias {bias}")
    sweep16_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunk, differ, finite = 1 << F32_SWEEP_LOG2_CHUNK, 0, 0
    bias0 = torch.zeros((), dtype=torch.int32, device=dev)
    for start in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(start, start + chunk, dtype=torch.int64, device=dev).to(torch.int32).view(torch.float32)
        ok = torch.isfinite(x)
        differ += int(((floatsd_quantize(x, bias0) != floatsd.encode(x, bias0)[0]) & ok).sum())
        finite += int(ok.sum())
    sweep_s = time.perf_counter() - t0
    check(differ == 0, f"quantize: {differ} of the finite f32 bit patterns differ from encode at bias 0")
    check(finite == (1 << 32) - (1 << 24), f"quantize sweep saw {finite} finite f32 patterns")
    print(f"  every finite fp16 bit pattern ({x16.numel()}) at biases -126, -7, 0 and 120: 0 differ, in "
          f"{sweep16_s:.2f} s; every finite f32 bit pattern ({finite}, {(1 << 32) // chunk} chunks of "
          f"2^{F32_SWEEP_LOG2_CHUNK}) at bias 0: 0 differ from encode, in {sweep_s:.1f} s")

    print("kernels: qsigmoid vs core.qsigmoid.qsigmoid_raw (bit for bit on f32; bf16 counted; two launches "
          "bit-identical)")
    print(element_report(_build, "qsigmoid", floor_ms))
    qsig = {}
    for shape in [(64, 4096), (1_000_003,), (2, 1024, 2560)]:  # the last: a zoo prefill gate
        x = torch.randn(shape, device=dev, generator=g) * 4
        y, y2, y_ref = qsigmoid(x), qsigmoid(x), qsigmoid_raw(x)
        torch.cuda.synchronize()
        mism = int((y != y_ref).sum())
        err = float((y - y_ref).abs().max())
        check(mism == 0, f"qsigmoid {shape}: {mism} outputs differ (max err {err})")
        check(torch.equal(y, y2), f"qsigmoid {shape}: two launches differ")
        xb = x.to(torch.bfloat16)
        yb, yb_ref = qsigmoid(xb), qsigmoid_raw(xb)
        torch.cuda.synchronize()
        n_bf = int((yb != yb_ref).sum())
        err_bf = float((yb.float() - yb_ref.float()).abs().max())
        t = timed_ms(torch, lambda: qsigmoid(x), 50, flush)
        t_plain = timed_ms(torch, lambda: qsigmoid_raw(x), 10, flush)
        bd = bound(x.numel() * 8, float(x.numel() * QSIG_OPS))
        qsig[shape] = costed(dict(ms=t, plain_ms=t_plain, library_ms=None, err=err, bf16_differ=n_bf, **bd),
                             "qsigmoid", f"{list(shape)} f32", x.numel())
        print(f"  {list(shape)} f32: max_abs_err {err:.3e}, {mism} of {x.numel()} differ, two launches bit-identical | bf16 input: {n_bf} of "
              f"{x.numel()} differ (kernel sigma in f32, plain in bf16), max {err_bf:.3e} | kernel {t:.4f} ms, "
              f"plain {t_plain:.3f} ms, {fmt_bound(bd)}; no library call")
    # every f32 bit pattern, in chunks, against the plain version
    t0 = time.perf_counter()
    chunk, differ = 1 << F32_SWEEP_LOG2_CHUNK, 0
    for start in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(start, start + chunk, dtype=torch.int64, device=dev).to(torch.int32).view(torch.float32)
        differ += int((qsigmoid(x) != qsigmoid_raw(x)).sum())
    sweep_s = time.perf_counter() - t0
    check(differ == 0, f"qsigmoid: {differ} of the 2^32 f32 bit patterns differ from the plain version")
    print(f"  every f32 bit pattern (2^32, {(1 << 32) // chunk} chunks of 2^{F32_SWEEP_LOG2_CHUNK}): 0 differ from the "
          f"plain version, in {sweep_s:.1f} s")
    return mm4, quant, qsig


# a stacked FloatSD4 leaf's layer (the JAX package packs a scanned stack along
# its layer axis): floatsd4_matmul's layout 2 on a layer's code-byte and
# exponent planes, at the dense family's four site shapes (h2o_danube3_4b's
# seven weight sites) at decode (M 1, 8 lanes) and prefill (M 2048), beside
# the tied head's transposed table at the same M
PLANE_SITES = [("wq-wo", 3840, 3840), ("wk-wv", 3840, 960), ("wi-wg", 3840, 10240), ("ffn-wo", 10240, 3840)]
PLANE_MS = (1, 8, 2048)
PLANE_HEAD = ("head", 3840, 32000)  # the tied head: [M, 3840] @ table[32000, 3840]^T
PLANE_EDGES = [(3, 1024, 1000), (40, 512, 384), (1, 3840, 1000)]  # (L, K, N)


def plane_phase(torch, dev, flush):
    """Phase 3, continued: floatsd4_matmul's layer-plane layout against its
    plain version: a [24, K, N] FloatSD4 leaf of each dense site shape
    (from FloatSD8 codes, as the store packs it), its layers 22 (nibble 0)
    and 23 (nibble 1) bit for bit on FP8 and FP16 activations at M 1, 8 and
    2048 (FP8 alone at 2048) and two launches bit-identical, timed beside
    the plain version, torch.matmul on the decoded f32 layer and the bound;
    the tied head (the transposed table) at the same M; then an odd L (the
    last layer's pad nibble), L 40 (layers 32-39 on the second exponent
    plane, at exponent -126 there) and an N that is not a multiple of 16,
    every layer bit for bit, the last one timed."""
    from repro_torch.core import floatsd4
    from repro_torch.core.fp8 import FP16, quantize_fp8
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul
    from repro_torch.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref
    from repro_torch.kernels.floatsd_matmul.ref import no_tf32, plan

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    rows = {}
    print("kernels: floatsd4_matmul's layer planes (layout 2: a stacked leaf packed along its layer axis, "
          "codes[l >> 1] and exps[l >> 5] [K, N], nibble l & 1; 2 bytes a weight) vs plain version, bit for bit "
          "on FP8/FP16 activations", flush=True)
    cases = [(site, k, n, False) for site, k, n in PLANE_SITES] + [(*PLANE_HEAD, True)]
    for site, k, n, tr in cases:
        if tr:  # the tied head: the [N, K] table packed along N, read in place
            w4 = kd.pack4(torch.randn((n, k), device=dev, generator=g) * 0.02)
            views = [w4]
        else:
            w4 = kd.pack4(kd.PackedTensor(*floatsd_codes(torch, (24, k, n), dev, g)))
            views = [kd.layer_view4(w4, 22), kd.layer_view4(w4, 23)]
        for m in PLANE_MS:
            x = torch.randn((m, k), device=dev, generator=g)
            acts = (quantize_fp8(x), quantize_fp8(x, FP16)) if m < 2048 else (quantize_fp8(x),)
            for v in views:
                nib = None if tr else v.nibble
                for xq in acts:
                    y = floatsd4_matmul(xq, v.codes, v.exps, n if tr else k, transposed=tr, nibble=nib)
                    y2 = floatsd4_matmul(xq, v.codes, v.exps, n if tr else k, transposed=tr, nibble=nib)
                    want = floatsd4_matmul_ref(xq, v.codes, v.exps, n if tr else k, transposed=tr, nibble=nib)
                    torch.cuda.synchronize()
                    mism = int((y != want).sum())
                    check(mism == 0 and torch.equal(y, y2), f"floatsd4_matmul planes {site} M {m}: {mism} of {m * n} "
                                                             f"outputs differ from the plain version, or two launches")
                    del y, y2, want
            v, xq = views[-1], acts[0]
            nib = None if tr else v.nibble
            wd = kd.unpack4(v) if tr else floatsd4.decode_plane(v.codes, v.exps, v.nibble)
            wk = wd.t() if tr else wd
            run = lambda: floatsd4_matmul(xq, v.codes, v.exps, n if tr else k, transposed=tr, nibble=nib)  # noqa: E731
            with no_tf32():
                t = timed_ms(torch, run, 20 if m < 2048 else 5, flush)
                t_plain = timed_ms(torch, lambda: floatsd4_matmul_ref(xq, v.codes, v.exps, n if tr else k,
                                                                      transposed=tr, nibble=nib),
                                   3 if m < 2048 else 1, flush)
                t_lib = timed_ms(torch, lambda: torch.matmul(xq, wk), 20 if m < 2048 else 5, flush)
            wt = v.codes.numel() + v.exps.numel()
            bd = bound(xq.numel() * 4 + wt + m * n * 4, 2.0 * m * n * k, matmul_peak(xq, wd))
            p = plan(m, n, k, ordered=True)
            key = dict(wt_nbytes=wt) if tr else dict(plane=True)
            rows[(site, m)] = costed(dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=0.0, **bd),
                                     "floatsd4_matmul", f"{'head' if tr else 'plane'} {site} [{m},{k}]x[{k},{n}]",
                                     m, k, n, **key)
            print(f"  {site:7s} [{m},{k}] x {'table[N,K]^T' if tr else 'planes [K,N]'} N={n}"
                  f"{'' if tr else ', layers 22 and 23 of 24'}, route A (ordered, {p.splits} chunks of {p.chunk} k): "
                  f"0 of {m * n} differ on {'FP8 and FP16' if m < 2048 else 'FP8'} activations, two launches "
                  f"bit-identical | kernel {t:.4f} ms ({t / t_lib:.2f}x torch.matmul), plain {t_plain:.3f} ms, "
                  f"torch.matmul on the decoded f32 weight {t_lib:.4f} ms, {fmt_bound(bd)}", flush=True)
            del x, acts
        del w4, views
    # the edges: an odd L (layer L - 1's byte carries the pad nibble), L 40
    # (layers 32.. on the second exponent plane, the last group at exponent
    # -126), N not a multiple of 16 (the bytewise loads, unaligned planes)
    for layers, k, n in PLANE_EDGES:
        w = torch.randn((layers, k, n), device=dev, generator=g) * 0.05
        if layers > 32 or layers == 1:
            w[32 * ((layers - 1) // 32):] *= 2.0 ** -126
        w4 = kd.pack4(w)
        dense = kd.unpack4(w4)
        sub = int(((dense != 0) & (dense.abs() < torch.finfo(torch.float32).tiny)).sum())
        check(sub > 0 or layers == 3, f"floatsd4 planes L {layers}: no subnormal weights")
        x = quantize_fp8(torch.randn((8, k), device=dev, generator=g))
        for l in range(layers):
            v = kd.layer_view4(w4, l)
            check(torch.equal(floatsd4.decode_plane(v.codes, v.exps, v.nibble), dense[l]),
                  f"floatsd4 planes L {layers}: layer {l}'s decode")
            y = floatsd4_matmul(x, v.codes, v.exps, k, nibble=v.nibble)
            want = floatsd4_matmul_ref(x, v.codes, v.exps, k, nibble=v.nibble)
            torch.cuda.synchronize()
            check(torch.equal(y, want), f"floatsd4 planes L {layers} layer {l}: {int((y != want).sum())} differ")
        # the last layer (the pad nibble's byte, the last exponent plane) timed
        v, wl = kd.layer_view4(w4, layers - 1), dense[layers - 1]
        with no_tf32():
            t = timed_ms(torch, lambda: floatsd4_matmul(x, v.codes, v.exps, k, nibble=v.nibble), 20, flush)
            t_plain = timed_ms(torch, lambda: floatsd4_matmul_ref(x, v.codes, v.exps, k, nibble=v.nibble), 3, flush)
            t_lib = timed_ms(torch, lambda: torch.matmul(x, wl), 20, flush)
        bd = bound(x.numel() * 4 + 2 * k * n + 8 * n * 4, 2.0 * 8 * n * k, matmul_peak(x, wl))
        rows[(f"L{layers}", 8)] = costed(dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=0.0, **bd),
                                         "floatsd4_matmul", f"plane L {layers} [8,{k}]x[{k},{n}]", 8, k, n,
                                         plane=True)
        print(f"  L {layers} x [{k},{n}]{' (odd L: the pad nibble)' if layers % 2 else ''}"
              f"{' (two exponent planes)' if layers > 32 else ''}{' (N % 16 != 0)' if n % 16 else ''}: every layer "
              f"bit for bit at M 8 on FP8 activations, {sub} subnormal weights | layer {layers - 1}: kernel "
              f"{t:.4f} ms, plain {t_plain:.3f} ms, torch.matmul on the decoded f32 layer {t_lib:.4f} ms, "
              f"{fmt_bound(bd)}", flush=True)
        del w, w4, dense, wl
    return rows


def floatsd_codes(torch, shape, dev, g):
    """FloatSD8 codes of a random [*shape] weight scaled by its fan-in, and
    their bias: a stacked leaf as the store packs it, drawn layer by layer."""
    from repro_torch.core import floatsd

    codes = torch.empty(shape, dtype=torch.uint8, device=dev)
    bias = None
    for l in range(shape[0]):
        w = torch.randn(shape[1:], device=dev, generator=g) / shape[1] ** 0.5
        if bias is None:  # layer 0's, with room: the others saturate past it
            bias = int(floatsd.fit_bias(w * 1.25))
        codes[l] = floatsd.encode(w, bias)[0]
    return codes, bias


BOUND_RTOL = 0.01  # the cost model's bound against the hand bound of the same row


def model_bound_ms(cost, peak: str) -> float:
    """The least time by the plain version's cost model: its device-memory
    bytes over the HBM rate, or 2 x its MACs over the peak of the operands'
    type, whichever is larger (ms)."""
    rate = {"fp32": FP32_OPS_PER_S, "tf32": TF32_OPS_PER_S, "bf16": BF16_OPS_PER_S}[peak]
    return max(cost.hbm_bytes / HBM_BYTES_PER_S, 2.0 * cost.macs / rate) * 1e3


def ledger_phase(smi: str) -> dict:
    """Phase 3, continued: every timed kernel row through the dispatch
    layer's cost ledger. Each row's launch cost model is recorded with its
    measured time (STATS.add_time), the ledger's table printed with each
    (op, cuda) row's achieved GB/s and GFLOP/s, and each row's bound from the
    plain version's cost model held within 1% of the row's hand bound (or
    the reason it differs printed). Returns the model bounds by row."""
    from repro_torch.kernels import dispatch as kd

    kd.STATS.reset()
    print(f"ledger: the cost model of each kernel row ({len(COSTED)} rows; bound = max(ref bytes / 3.35 TB/s, "
          f"2 x ref MACs / the operands' peak), within {BOUND_RTOL:.0%} of the hand bound; {smi})", flush=True)
    agree, kept = 0, []
    for op, what, row, ref, cuda, peak in COSTED:
        kd.STATS.record(kd.Decision(op, "cuda", "kernel phase row", cuda))
        kd.STATS.add_time(op, "cuda", row["ms"] / 1e3)
        mb, hand = model_bound_ms(ref, peak), row["bound_ms"]
        rel = abs(mb - hand) / hand
        row["model_bound_ms"] = mb
        note = ""
        if rel > BOUND_RTOL:
            # the one stated exception: the hand bound of an f32 flash row
            # counts QK^T as six exact-piece bf16 products at the 16-bit peak
            # (the kernel's method), the model the function's MACs at FP32
            check(op == "flash_attention" and peak == "fp32",
                  f"ledger: {op} {what}: the cost model's bound {mb:.5f} ms is {rel:.2%} from the hand bound "
                  f"{hand:.5f} ms")
            kept.append(what)
            note = (" (hand bound kept: it counts the f32 QK^T as six exact-piece bf16 products on the tensor "
                    "cores, the kernel's method; the model counts the function's MACs at the FP32 peak)")
        else:
            agree += 1
        print(f"  {op} {what}: hand bound {hand:.5f} ms, cost-model bound {mb:.5f} ms ({rel:.3%}){note}; cuda model "
              f"{cuda.hbm_bytes / 1e6:.3f} MB, {cuda.flops / 1e9:.4f} GFLOP, smem {cuda.smem_bytes} B; kernel "
              f"{row['ms']:.4f} ms: {cuda.hbm_bytes / row['ms'] / 1e6:.1f} GB/s, "
              f"{cuda.flops / row['ms'] / 1e6:.1f} GFLOP/s", flush=True)
    print(kd.LEDGER.table(), flush=True)
    for r in kd.LEDGER.rows():
        print(f"  {r['op']}/{r['backend']}: {r['calls']} rows, measured {r['measured_bytes_per_s'] / 1e9:.1f} GB/s "
              f"and {r['measured_flops_per_s'] / 1e9:.1f} GFLOP/s of the model's bytes and FLOPs", flush=True)
    print(f"ledger: {agree} of {len(COSTED)} cost-model bounds within {BOUND_RTOL:.0%} of the hand bound; "
          f"hand bound kept for {kept}", flush=True)
    kd.STATS.reset()
    return {"rows": len(COSTED), "agree": agree, "kept": kept}


def ptxas_static_smem(log: str) -> dict:
    """{mangled entry function: static shared memory bytes} from a ptxas -v
    log (a function without "bytes smem" has none)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = 0
        elif name and "registers" in line and "Used" in line:
            m = re.search(r"(\d+) bytes smem", line)
            out[name] = int(m.group(1)) if m else 0
    return out


def mirror_phase(torch, build) -> None:
    """Phase 3, continued: the cost model's mirrors of the kernels' sizes
    against the libraries: the scratch of rwkv_wkv and flash_attention at
    the kernel phase's shapes, each launcher's dynamic shared memory, and
    each kernel function's static shared memory against ptxas's."""
    from repro_torch.kernels.flash_attention import cost as fa_cost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.floatsd4_matmul import cost as fm4_cost
    from repro_torch.kernels.floatsd4_matmul import ops as fm4_ops
    from repro_torch.kernels.floatsd_matmul import cost as fm_cost
    from repro_torch.kernels.floatsd_matmul import ops as fm_ops
    from repro_torch.kernels.floatsd_quantize import cost as fq_cost
    from repro_torch.kernels.lstm_cell import cost as lc_cost
    from repro_torch.kernels.rwkv_wkv import cost as rw_cost
    from repro_torch.kernels.rwkv_wkv import ops as rw_ops

    n = 0
    for b, h, s, k in [(ZOO_B, 40, ZOO_S, 64), (ZOO_B, 40, 1000, 64), (1, 3, 17, 100), (2, 1, 33, 128)]:
        check(rw_ops.library_scratch_bytes(b, h, s, k) == rw_cost.scratch_bytes(b, h, s, k),
              f"rwkv_wkv scratch mirror at {(b, h, s, k)}")
        n += 1
    for k in (1, 64, 65, 128):
        for walk in (False, True):
            want = rw_cost.walk_smem(k) if walk else rw_cost.prep_smem(k)
            check(rw_ops.library_smem_bytes(k, walk) == want, f"rwkv_wkv smem mirror at K {k}, walk {walk}")
            n += 1
    for dt in (torch.float32, torch.bfloat16):
        e = torch.tensor([], dtype=dt).element_size()
        for b, skv, kh, d in [(ZOO_B, ZOO_S, 8, 120), (1, 8192, 8, 120), (ZOO_B, 1000, 8, 120), (1, 17, 1, 8)]:
            check(fa_ops.library_scratch_bytes(b, skv, kh, d, dt) == fa_cost.scratch_bytes(b, skv, kh, d, e),
                  f"flash_attention scratch mirror at {(b, skv, kh, d, dt)}")
            n += 1
        for d in (8, 64, 65, 120, 128):
            check(fa_ops.library_smem_bytes(d, dt) == fa_cost.fwd_smem(d, e), f"flash smem mirror at D {d}, {dt}")
            n += 1
    for m in (1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 3072):
        want = fm_cost.a_smem(fm_cost.a_row_tile(m))
        check(fm_ops.library_smem_bytes(m, "A") == want == fm4_ops.library_smem_bytes(m),
              f"route A smem mirror at M {m}")
        n += 2
    check(fm_ops.library_smem_bytes(128, "B") == fm_cost.B_SMEM, "route B smem mirror")
    check(fm_ops.library_dw_smem_bytes() == fm_cost.DW_SMEM, "matmul_dw smem mirror")
    n += 2
    static = {
        "floatsd_matmul": fm_cost.STATIC_SMEM, "floatsd_matmul_dw": fm_cost.STATIC_SMEM,
        "floatsd4_matmul": {**fm4_cost.STATIC_SMEM, "split_pieces": fm_cost.STATIC_SMEM["split_pieces"]},
        "lstm_cell": {"lstm_cell_kernel": None}, "lstm_cell_bwd": {"lstm_cell_bwd_kernel": None},
        "qsigmoid": {"qsigmoid_kernel": lc_cost.static_smem(True)},
        "floatsd_quantize": {"quantize_kernel": fq_cost.STATIC_SMEM},
        "rwkv_wkv": rw_cost.STATIC_SMEM, "flash_attention": fa_cost.STATIC_SMEM,
    }
    seen = 0
    for op, table in static.items():
        funcs = ptxas_static_smem(build.build_log(op))
        if not funcs:  # a library loaded from the build cache: cuobjdump reads the same field
            usage = cuobjdump(build, op, "-res-usage") or ""
            funcs = {name: int(dict(re.findall(r"(\w+):(\d+)", u)).get("SHARED", -1))
                     for name, u in re.findall(r"Function (\S+?):?\s*\n\s*(REG:.*)", usage)}
        check(funcs, f"{op}: neither a ptxas report nor cuobjdump -res-usage")
        for mangled, got in funcs.items():
            name = next((f for f in table if f in mangled), None)
            check(name is not None, f"{op}: kernel function {mangled} has no static shared memory mirror")
            # the cells' table is quantized-only: table[Q ? kSigTable : 1] (Q mangled as Lb1E / Lb0E)
            want = table[name] if table[name] is not None else lc_cost.static_smem("Lb1E" in mangled)
            check(got == want, f"{op}: {name} ({mangled}) static shared memory {got} B, the mirror {want} B")
            seen += 1
    print(f"mirrors: {n} scratch and dynamic shared-memory sizes equal the libraries' own; the static shared memory "
          f"of {seen} kernel functions (9 libraries) equals ptxas's", flush=True)


def serve(torch, model, params, policy, prompts, backend=None, step_times=None, weight_format="floatsd8"):
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, params, policy, lanes=LANES, chunk=CHUNK, backend=backend,
                      weight_format=weight_format)
    reqs = eng.submit_all([p.copy() for p in prompts], max_new=MAX_NEW)
    eng.metrics.start()
    while True:
        decode_before = eng.metrics.decode_steps
        t0 = time.perf_counter()
        if not eng.step_once():  # ends in a device->host copy: synchronised
            break
        if step_times is not None and eng.metrics.decode_steps > decode_before:
            step_times.append(time.perf_counter() - t0)
    eng.metrics.stop()
    return eng, sorted(reqs, key=lambda r: r.rid)


def composite(parts) -> dict:
    """Times and bound of a sequence of launches, from (count, row) pairs:
    the sums of count x each row's time, and the larger of the summed byte
    and operation bounds."""
    tot = lambda key: sum(n * r[key] for n, r in parts)  # noqa: E731
    lib = [r.get("library_ms") for _, r in parts]
    b, o = tot("bytes_ms"), tot("ops_ms")
    return {"ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": max(b, o),
            "bound_by": "bytes" if b >= o else "operations", "bytes_ms": b, "ops_ms": o,
            "ops_peak": "+".join(sorted({pk for _, r in parts for pk in r["ops_peak"].split("+")})),
            "library_ms": None if None in lib else tot("library_ms")}


def train_counts(calls: int, seq: int) -> dict:
    """Kernel calls per training step of the fused BPTT, per the code: per
    engine call (one per LSTM layer, direction and input sequence), 2 gate
    matmuls a time step + the backward's recompute pair, a cell and a cell
    backward a step, a matmul_dx a step + the batched dXs, and dWx + dWh."""
    L, S = calls, seq
    return {"floatsd_matmul": 2 * L * S + 2 * L, "lstm_cell": L * S, "lstm_cell_grad": L * S,
            "floatsd_matmul_dx": L * S + L, "floatsd_matmul_dw": 2 * L}


TRAIN_GROUPS = ("floatsd_matmul", "floatsd_matmul_dx", "floatsd_matmul_dw", "lstm_cell", "lstm_cell_grad")
# and the kernel of the CLI's telemetry (on by default)
TRAIN_OPS = (*TRAIN_GROUPS, "floatsd_quantize")


def profile_step(torch, step_fn, state, batch, gemm="library GEMM (tied head)", require=None, extra=()):
    """One train step under torch.profiler: device time (ms) and launches
    by kernel group, and the step's wall time (ms) in the same window.
    ``require``: the groups that must have run (default: all of them);
    ``extra``: (name substring, group) pairs matched before the others."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: tracing every host op would lengthen the window timed here
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])  # a device->host copy: synchronised
        wall = (time.perf_counter() - t0) * 1e3
    # floatsd_matmul.cu's kernels take the codes as [K, N] (<false: the
    # forward) or [N, K] (<true: matmul_dx); its second pass, which adds the
    # chunks' sums of a split K, serves both
    names = [*extra, ("floatsd_matmul_ordered_kernel<false", "floatsd_matmul"),
             ("floatsd_matmul_mma_kernel<false", "floatsd_matmul"),
             ("floatsd_matmul_ordered_kernel<true", "floatsd_matmul_dx"),
             ("floatsd_matmul_mma_kernel<true", "floatsd_matmul_dx"),
             ("add_partials", "floatsd_matmul(_dx) chunk sums"),
             ("matmul_dw_kernel", "floatsd_matmul_dw"), ("lstm_cell_bwd_kernel", "lstm_cell_grad"),
             ("lstm_cell_kernel", "lstm_cell"), ("gemm", gemm)]
    groups = {g: [0.0, 0] for _, g in names + [("", "other torch ops")]}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        g = next((g for k, g in names if k in e.key.lower()), "other torch ops")
        groups[g][0] += e.self_device_time_total / 1e3
        groups[g][1] += e.count
    # a kernel renamed out of its group would be filed elsewhere: every group runs in a step
    check(all(n > 0 for g, (_, n) in groups.items() if require is None or g in require),
          f"a kernel group of the train step saw no launch: {groups}")
    return groups, wall


def pack_train_cost(torch, step_fn, state, batch) -> dict:
    """pack_train's share of a train step: the host's waits at its four bias
    reads inside one more warm step (pack_train replaced, for that step, by
    the same encode with each read timed), and the device time of those four
    encodes run alone under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import floatsd
    from repro_torch.kernels import dispatch as kd

    real, waits, packed = kd.pack_train, [], []

    def timed(w):
        codes, bias = floatsd.encode(w.detach())
        t0 = time.perf_counter()
        b = int(bias)  # the read pack_train makes: the host waits for the device
        waits.append((time.perf_counter() - t0) * 1e3)
        packed.append((w.detach(), kd.PackedTensor(codes, b)))
        return packed[-1][1]

    kd.pack_train = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        kd.pack_train = real
    check(len(packed) == 4, f"pack_train ran {len(packed)} times in a step, not 4")
    for w, got in packed:
        want = real(w)
        check(torch.equal(want.codes, got.codes) and want.bias == got.bias,
              "the timed pack_train differs from pack_train")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for w, _ in packed:
            real(w)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return dict(waits_ms=waits, wait_ms=sum(waits), step_ms=wall,
                device_ms=sum(e.self_device_time_total for e in events) / 1e3, kernels=sum(e.count for e in events))


def train_phase(torch, smi):
    """Phases 7 and 8: the full-width model through the training CLI."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.launch import train
    from repro_torch.models.task_zoo import make_task
    from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step

    wrappers = dict(zip(TRAIN_OPS, (floatsd_matmul, matmul_dx, matmul_dw, lstm_cell, lstm_cell_grad,
                                      floatsd_quantize)))
    kd.STATS.reset()
    for w in wrappers.values():
        w.launches = 0
    out = train.main([*TRAIN_ARGS, "--steps", str(TRAIN_STEPS)])
    launches = {op: w.launches for op, w in wrappers.items()}
    stats = kd.STATS.snapshot()
    model, data, opt, lr, _ = make_task("wikitext2", full=True)
    batch = next(data.batches)
    # the fused BPTT's kernels, and the CLI's telemetry (on by default): two
    # quantizes of each weight matrix a step
    mats = sum(p.ndim >= 2 for p in tree_leaves(out["state"].params))
    want = {op: TRAIN_STEPS * n
            for op, n in train_counts(model.n_layers, batch["tokens"].shape[1]).items()}
    want["floatsd_quantize"] = TRAIN_STEPS * 2 * mats
    check(launches == want, f"train launches {launches} != expected {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items()}, f"train dispatch records {stats}")
    check(all(math.isfinite(v) for v in out["losses"]), f"nonfinite train loss {out['losses']}")
    check(all(out["finite"]), f"a train step was skipped: grads_finite {out['finite']}")
    warm = out["step_s"][1:]
    step_ms = statistics.median(warm) * 1e3
    tok_s = out["tokens_per_step"] / statistics.median(warm)
    print(f"train: {TRAIN_STEPS} steps (first excluded as warm-up): median step {step_ms:.2f} ms, "
          f"{tok_s:.0f} tok/s ({smi}); losses {out['losses']}; launches {launches}", flush=True)

    # one more step under the profiler: where the device time goes
    step_fn = make_train_step(model.loss, opt, get_policy("floatsd8_table6"), lr=lr)
    groups, wall = profile_step(torch, step_fn, out["state"], batch_to_device(batch, "cuda"))
    busy = sum(ms for ms, _ in groups.values())
    print(f"train step device time (torch.profiler, one warm step): busy {busy:.2f} ms of that step's "
          f"{wall:.2f} ms wall time under the profiler (idle share {max(0.0, 1 - busy / wall):.1%}; the "
          f"unprofiled median step is {step_ms:.2f} ms) in "
          f"{sum(n for _, n in groups.values())} device operations; "
          + ", ".join(f"{k} {ms:.3f} ms ({n})" for k, (ms, n) in groups.items()), flush=True)
    enc = pack_train_cost(torch, step_fn, out["state"], batch_to_device(batch, "cuda"))
    print(f"train step pack_train (core.floatsd.encode on the 4 masters, each bias read to the host): "
          f"device {enc['device_ms']:.3f} ms in {enc['kernels']} kernels (the four encodes alone, "
          f"torch.profiler); host waits at the bias reads {enc['wait_ms']:.3f} ms ("
          + ", ".join(f"{w:.3f}" for w in enc["waits_ms"]) + f") in a step of {enc['step_ms']:.2f} ms wall", flush=True)

    # 8. the same init and batches on the plain versions, then the kernels again
    with kd.use_backend("ref"):
        ref = train.main([*TRAIN_ARGS, "--steps", str(XCHECK_STEPS)])
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"])]
    check(max(rel) <= LOSS_RTOL, f"kernel vs plain losses differ by {rel} relative")
    again = train.main([*TRAIN_ARGS, "--steps", str(XCHECK_STEPS)])
    check(again["losses"] == out["losses"][:XCHECK_STEPS],
          f"two kernel runs differ: {again['losses']} vs {out['losses'][:XCHECK_STEPS]}")
    # the loss barely moves in a few steps, so the trained masters are held
    # too: each leaf's kernel-vs-plain distance against its plain change
    init = init_state(model.init(torch.Generator(device="cuda").manual_seed(SEED)), opt,
                      get_policy("floatsd8_table6")).params
    drift = {}
    for mod, leaves in ref["state"].params.items():
        for name, p_ref in leaves.items():
            p_ref, p_k = p_ref.float(), again["state"].params[mod][name].float()
            moved = float(torch.linalg.vector_norm(p_ref - init[mod][name].float()))
            drift[f"{mod}/{name}"] = float(torch.linalg.vector_norm(p_k - p_ref)) / max(moved, 1e-30)
            check(moved > 0 and drift[f"{mod}/{name}"] <= PARAM_RTOL,
                  f"{mod}/{name}: kernel vs plain masters {drift[f'{mod}/{name}']:.3e} of their change "
                  f"{moved:.3e} (bound {PARAM_RTOL})")
    print(f"train cross-check: {XCHECK_STEPS} steps, kernel vs plain losses within {max(rel):.3e} relative "
          f"(bound {LOSS_RTOL}); plain {ref['losses']}; masters within {max(drift.values()):.3e} of their "
          f"change (bound {PARAM_RTOL}; per leaf {drift}); a second kernel run bit-identical; plain step "
          f"{statistics.median(ref['step_s']):.2f} s", flush=True)
    return dict(launches=launches, step_ms=step_ms, tok_s=tok_s, groups=groups, busy_ms=busy, wall_ms=wall,
                params=out["state"].params, batch=batch)


# the paper's other three tasks at their Table III widths (make_task(name,
# full=True), seed 0): UDPOS (B 64, S 32, 2 BiLSTM layers: 4 engine calls a
# step), SNLI (B 128, S 24, one BiLSTM over premise and hypothesis: 4),
# Multi30K (B 128, S 20, encoder and decoder: 2); Adam, lr 1e-3
TASK_NAMES = ("udpos", "snli", "multi30k")
TASK_STEPS, TASK_XCHECK_STEPS, TASK_EVAL_BATCHES = 5, 3, 2


def task_engines(name: str, model) -> list:
    """(K, H) of each fused-engine call in one of the task's train steps."""
    if name == "udpos":
        return [(model.emb, model.hidden)] * 2 + [(2 * model.hidden, model.hidden)] * 2
    if name == "snli":
        return [(model.proj, model.hidden)] * 4
    return [(model.emb, model.hidden)] * 2


def task_batch_dims(data) -> tuple:
    """(B, S) of a task's batch: its first token input's shape."""
    return next(data.batches)[data.token_keys[0]].shape


def task_kernel_phase(torch, dev, flush):
    """Phase 3, continued: the fused BPTT's kernels at the three tasks'
    shapes, through the kernel phase's row builders (each against its plain
    version, two launches bit-identical, timed with L2 flushed): the
    per-step gate products [B, K] and [B, H] on the ordered route (route A,
    FP8 activations: bit for bit), beside route B's time at M 128; the
    recompute pair over S x B rows; matmul_dx for the recurrence and the
    batched dXs; matmul_dw; the cell and its backward (bit for bit).
    Returns the rows by shape and each task's per-step composite by op."""
    from repro_torch.core import floatsd
    from repro_torch.core.fp8 import quantize_fp8
    from repro_torch.models.task_zoo import make_task

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows, steps = {}, {}

    def weight(k, n):
        codes, bias = floatsd.encode((torch.rand((k, n), device=dev, generator=g) * 2 - 1) / n ** 0.5 * 2)
        return codes, int(bias)

    def row(op, *shape):
        key = (op, *shape)
        if key not in rows:
            if op == "floatsd_matmul":
                m, k, n = shape
                rows[key] = mm_row(torch, flush, quantize_fp8(torch.randn((m, k), device=dev, generator=g)),
                                   *weight(k, n), False, True, "task", ordered=True, route_b=True)
            elif op == "floatsd_matmul_dx":
                m, k, n = shape
                rows[key] = dx_row(torch, flush, torch.randn((m, n), device=dev, generator=g) * 1e-2,
                                   *weight(k, n), ordered=True)
            elif op == "floatsd_matmul_dw":
                m, k, n = shape
                rows[key] = dw_row(torch, flush, quantize_fp8(torch.randn((m, k), device=dev, generator=g)),
                                   torch.randn((m, n), device=dev, generator=g) * 1e-2, True)
            else:
                b, h = shape
                z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
                c = torch.randn((b, h), device=dev, generator=g).to(torch.float16)
                if op == "lstm_cell":
                    rows[key] = cell_row(torch, flush, z, c)
                else:
                    dh, dc = (torch.randn((b, h), device=dev, generator=g) for _ in range(2))
                    rows[key] = cell_grad_row(torch, flush, z, c, dh, dc)
        return rows[key]

    print("kernels: the fused BPTT's kernels at the tasks' shapes (FP8 activations; every product on the "
          "ordered route, as the engine asks: bit for bit with the plain version; matmul_dx within 1e-5, "
          "matmul_dw within one e5m2 step on at most 0.1%; two launches bit-identical)", flush=True)
    for name in TASK_NAMES:
        model, data, *_ = make_task(name, full=True)
        b, s = task_batch_dims(data)
        engines = task_engines(name, model)
        parts = {op: [] for op in TRAIN_GROUPS}
        for (k, h) in dict.fromkeys(engines):
            n = engines.count((k, h))
            parts["floatsd_matmul"] += [(n * s, row("floatsd_matmul", b, k, 4 * h)),
                                        (n * s, row("floatsd_matmul", b, h, 4 * h)),
                                        (n, row("floatsd_matmul", s * b, k, 4 * h)),
                                        (n, row("floatsd_matmul", s * b, h, 4 * h))]
            parts["floatsd_matmul_dx"] += [(n * s, row("floatsd_matmul_dx", b, h, 4 * h)),
                                           (n, row("floatsd_matmul_dx", s * b, k, 4 * h))]
            parts["floatsd_matmul_dw"] += [(n, row("floatsd_matmul_dw", s * b, k, 4 * h)),
                                           (n, row("floatsd_matmul_dw", s * b, h, 4 * h))]
            parts["lstm_cell"].append((n * s, row("lstm_cell", b, h)))
            parts["lstm_cell_grad"].append((n * s, row("lstm_cell_grad", b, h)))
        steps[name] = {op: composite(p) for op, p in parts.items()}
        print(f"  {name} train step (B {b}, S {s}, engine calls {engines}), from these rows: "
              + ", ".join(f"{op} {c['ms']:.3f} ms (bound {c['bound_ms']:.4f})" for op, c in steps[name].items()),
              flush=True)
    return rows, steps


def recompute_check(torch, dev, b=128, k=300, h=300, s=4) -> int:
    """The fused BPTT at SNLI's B 128 x K 300 x H 300: every z a forward
    cell gets must equal the z the backward recomputes for that step, bit
    for bit (every product of the engine on the ordered route). Returns
    the number of z elements compared."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.nn.lstm import LSTMLayer

    fwd, bwd = [], []
    cell, grad = kd.lstm_cell, kd.lstm_cell_grad
    kd.lstm_cell = lambda z, c, **kw: (fwd.append(z.clone()), cell(z, c, **kw))[1]
    kd.lstm_cell_grad = lambda z, *a, **kw: (bwd.append(z.clone()), grad(z, *a, **kw))[1]
    try:
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        layer = LSTMLayer(k, h)
        p = {n: t.to(torch.float16).requires_grad_() for n, t in layer.init(g).items()}
        xs = torch.randn((b, s, k), device=dev, generator=g)
        hs, fin = layer.apply(p, xs, get_policy("floatsd8_table6").replace(grad_quant="fp8_kernel"))
        (hs.square().sum() + fin.c.float().square().sum()).backward()
    finally:
        kd.lstm_cell, kd.lstm_cell_grad = cell, grad
    check(len(fwd) == len(bwd) == s, f"recompute check: {len(fwd)} forward, {len(bwd)} backward cells")
    for t, z in enumerate(fwd):  # the backward walks the steps in reverse
        diff = int((z != bwd[s - 1 - t]).sum())
        check(diff == 0, f"recompute check: step {t}: {diff} of {z.numel()} z differ between forward and backward")
    return sum(z.numel() for z in fwd)


def flat_leaves(tree, prefix: str = "") -> dict:
    """Nested dicts of tensors -> {"a/b/c": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def tasks_phase(torch, smi):
    """Phase 9: UDPOS, SNLI and Multi30K at their paper widths through the
    training CLI on the kernels, each cross-checked against the plain
    versions, evaluated with no gradient, and one FP32 step on autodiff."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.launch import train
    from repro_torch.models.task_zoo import make_task
    from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step

    n = recompute_check(torch, "cuda")
    print(f"tasks: the fused BPTT at B 128 x K 300 x H 300: the forward's {n} gate pre-activations equal the "
          f"backward's recompute bit for bit", flush=True)
    wrappers = dict(zip(TRAIN_OPS, (floatsd_matmul, matmul_dx, matmul_dw, lstm_cell, lstm_cell_grad,
                                      floatsd_quantize)))
    policy = get_policy("floatsd8_table6")
    total = {op: 0 for op in TRAIN_OPS}
    out = {}
    for name in TASK_NAMES:
        t0 = time.perf_counter()
        args = ["--task", name, "--full", "--log-every", "1", "--seed", str(SEED)]
        model, data, opt, lr, metric = make_task(name, full=True)
        b, s = task_batch_dims(data)
        calls = len(task_engines(name, model))
        kd.STATS.reset()
        for w in wrappers.values():
            w.launches = 0
        run = train.main([*args, "--steps", str(TASK_STEPS)])
        launches = {op: w.launches for op, w in wrappers.items()}
        stats = kd.STATS.snapshot()
        # the fused BPTT's kernels, and the CLI's telemetry (on by default):
        # two quantizes of each weight matrix a step
        mats = sum(p.ndim >= 2 for p in tree_leaves(run["state"].params))
        want = {op: TASK_STEPS * n for op, n in train_counts(calls, s).items()}
        want["floatsd_quantize"] = TASK_STEPS * 2 * mats
        check(launches == want, f"{name}: launches {launches} != expected {want}")
        check(stats == {(op, "cuda"): n for op, n in want.items()}, f"{name}: dispatch records {stats}")
        check(all(math.isfinite(v) for v in run["losses"]) and all(run["finite"]),
              f"{name}: losses {run['losses']}, grads_finite {run['finite']}")
        for op, n in launches.items():
            total[op] += n
        warm = run["step_s"][1:]
        step_ms = statistics.median(warm) * 1e3
        tok_s = run["tokens_per_step"] / statistics.median(warm)
        print(f"tasks: {name}: {TASK_STEPS} steps (first excluded as warm-up): median step {step_ms:.2f} ms, "
              f"{tok_s:.0f} tok/s ({smi}); losses {run['losses']}; launches {launches}", flush=True)

        # one more step under the profiler: device time by kernel
        step_fn = make_train_step(model.loss, opt, policy, lr=lr)
        batch = next(data.batches)
        groups, wall = profile_step(torch, step_fn, run["state"], batch_to_device(batch, "cuda"),
                                    gemm="library GEMM (dense heads)", require=TRAIN_GROUPS)
        busy = sum(ms for ms, _ in groups.values())
        print(f"tasks: {name} step device time (torch.profiler, one warm step): busy {busy:.2f} ms of "
              f"{wall:.2f} ms wall (idle share {max(0.0, 1 - busy / wall):.1%}); "
              + ", ".join(f"{k} {ms:.3f} ms ({n})" for k, (ms, n) in groups.items()), flush=True)

        # the same init and batches on the plain versions, then the kernels again
        with kd.use_backend("ref"):
            ref = train.main([*args, "--steps", str(TASK_XCHECK_STEPS)])
        again = train.main([*args, "--steps", str(TASK_XCHECK_STEPS)])
        rel = [abs(a - r) / abs(r) for a, r in zip(run["losses"], ref["losses"])]
        check(max(rel) <= LOSS_RTOL, f"{name}: kernel vs plain losses differ by {rel} relative")
        check(again["losses"] == run["losses"][:TASK_XCHECK_STEPS],
              f"{name}: two kernel runs differ: {again['losses']} vs {run['losses'][:TASK_XCHECK_STEPS]}")
        init = flat_leaves(init_state(model.init(torch.Generator(device="cuda").manual_seed(SEED)), opt,
                                      policy).params)
        p_ref, p_k = flat_leaves(ref["state"].params), flat_leaves(again["state"].params)
        drift = {}
        for key, w_ref in p_ref.items():
            moved = float(torch.linalg.vector_norm(w_ref.float() - init[key].float()))
            drift[key] = float(torch.linalg.vector_norm(p_k[key].float() - w_ref.float())) / max(moved, 1e-30)
            check(moved > 0 and drift[key] <= PARAM_RTOL,
                  f"{name} {key}: kernel vs plain masters {drift[key]:.3e} of their change {moved:.3e} "
                  f"(bound {PARAM_RTOL})")
        print(f"tasks: {name} cross-check: {TASK_XCHECK_STEPS} steps, kernel vs plain losses within "
              f"{max(rel):.3e} relative (bound {LOSS_RTOL}); masters within {max(drift.values()):.3e} of their "
              f"change (bound {PARAM_RTOL}, {len(drift)} leaves); a second kernel run bit-identical; plain step "
              f"{statistics.median(ref['step_s']):.2f} s", flush=True)

        # the task's metric with no gradient: the inference scans (reverse too)
        kd.STATS.reset()
        with torch.no_grad():
            vals = [float(getattr(model, metric)(run["state"].params, batch_to_device(next(data.eval_batches), "cuda"),
                                                 policy)) for _ in range(TASK_EVAL_BATCHES)]
        ev = kd.STATS.snapshot()
        check(all(math.isfinite(v) for v in vals) and ev == {("lstm_cell", "cuda"): TASK_EVAL_BATCHES * calls * s},
              f"{name}: eval {metric} {vals}, dispatch {ev}")

        # the FP32 baseline: one step through autodiff, no kernel of the engine
        kd.STATS.reset()
        fp32 = train.main([*args, "--steps", "1", "--policy", "fp32"])
        check(math.isfinite(fp32["losses"][0]) and fp32["finite"] == [True]
              and kd.STATS.count() == kd.STATS.count("floatsd_quantize"),
              f"{name}: fp32 step loss {fp32['losses']}, dispatch {kd.STATS.snapshot()}")
        print(f"tasks: {name} eval {metric} over {TASK_EVAL_BATCHES} batches {vals} (no gradient; "
              f"{sum(ev.values())} lstm_cell launches); fp32 step on autodiff loss {fp32['losses'][0]:.4f}; "
              f"phase {time.perf_counter() - t0:.1f} s", flush=True)
        out[name] = dict(step_ms=step_ms, tok_s=tok_s, launches=launches, groups=groups, busy_ms=busy,
                         wall_ms=wall, b=b, s=s, calls=calls)
    return dict(launches=total, tasks=out)


def cross_check(reqs, refs, what: str, n_requests: int = REQUESTS) -> None:
    """Greedy tokens of the kernel path against the plain path, over each
    request's margin-decisive prefix (phases 5, 6 and 16; a token replayed
    from a full prefix-cache hit counts as decisive)."""
    import numpy as np

    decisive = agree = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(ref.margins) if g <= MARGIN_FLOOR), MAX_NEW)
        check(r.out[:n] == ref.out[:n], f"{what}: request {r.rid}: {r.out} vs plain {ref.out} (decisive {n})")
        decisive += n
        agree += r.out == ref.out
    check(decisive >= n_requests * MAX_NEW // 2, f"{what}: only {decisive} decisive tokens")
    margins = np.array([g for ref in refs for g in ref.margins])
    print(f"{what}: {decisive} of {n_requests * MAX_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) "
          f"and equal; {agree} of {n_requests} streams equal in full; top-2 margin median "
          f"{np.median(margins):.3e}, min {margins.min():.3e}", flush=True)


def serve4_phase(torch, model, params, policy, prompts, serve8, smi):
    """Phase 6: the same requests on the FloatSD4 store."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.lstm_cell.ops import lstm_cell

    wrappers = {"floatsd4_matmul": floatsd4_matmul, "floatsd_matmul": floatsd_matmul, "lstm_cell": lstm_cell}
    kd.STATS.reset()
    for w in wrappers.values():
        w.launches = 0
    times: list[float] = []
    eng, reqs = serve(torch, model, params, policy, prompts, step_times=times, weight_format="floatsd4")
    launches = {op: w.launches for op, w in wrappers.items()}
    stats = kd.STATS.snapshot()
    m, s = eng.metrics, eng.store
    print(f"serve4: weights {s.dense_nbytes / 2**20:.1f} MiB dense -> {s.packed_nbytes} B = "
          f"{s.packed_nbytes / 2**20:.2f} MiB packed FloatSD4 ({s.n_packed} tensors; FloatSD8 "
          f"{serve8['packed_nbytes'] / 2**20:.2f} MiB); {m.format()}", flush=True)
    check(s.fmt == "floatsd4" and s.packed_nbytes == FLOATSD4_BYTES,
          f"FloatSD4 resident bytes {s.packed_nbytes} != {FLOATSD4_BYTES}")
    check(all(r.status == "done" and len(r.out) == MAX_NEW for r in reqs), "serve4: requests not all done")
    check(m.numeric_errors == 0, "serve4: nonfinite logits")
    L = model.n_layers
    positions = CHUNK * m.prefill_steps + m.decode_steps
    want = {"floatsd4_matmul": 2 * L * positions + m.steps, "floatsd_matmul": 0, "lstm_cell": L * positions}
    check(launches == want, f"serve4 launches {launches} != expected {want}")
    check(stats.get(("floatsd4_matmul", "cuda"), 0) == want["floatsd4_matmul"]
          and stats.get(("lstm_cell", "cuda"), 0) == want["lstm_cell"]
          and sum(n for (o, b), n in stats.items() if b == "ref" or o == "floatsd_matmul") == 0,
          f"serve4 dispatch records {stats}")
    step_ms = statistics.median(times) * 1e3
    rep = m.report()
    print(f"serve4: {rep['gen_tok_per_s']:.1f} generated tok/s, {rep['total_tok_per_s']:.1f} total tok/s, median "
          f"decode step {step_ms:.3f} ms over {len(times)} steps (FloatSD8: {serve8['gen_tok_s']:.1f} generated "
          f"tok/s, {serve8['step_ms']:.3f} ms; {LANES} lanes; {smi}); launches {launches}; dispatch "
          f"{dict((f'{o}/{b}', n) for (o, b), n in stats.items())}", flush=True)

    _, refs = serve(torch, model, params, policy, prompts, backend="ref", weight_format="floatsd4")
    cross_check(reqs, refs, "serve4 cross-check")

    # the loss of one synthetic batch on both stores (random weights: the
    # difference says how far FloatSD4 moves this model, nothing of accuracy)
    batch = next(synthetic.wikitext2(batch=LANES, seq=48, vocab=model.vocab, seed=SEED).batches)
    b = {k: torch.as_tensor(v, device=eng.device) for k, v in batch.items()}
    pol = eng.serve_policy
    with torch.no_grad():
        loss4 = float(model.loss(s.tree, b, pol))
        loss8 = float(model.loss(serve8["tree"], b, pol))
    check(math.isfinite(loss4) and math.isfinite(loss8), f"nonfinite eval loss {loss4}, {loss8}")
    print(f"serve4: eval loss of one synthetic batch [{LANES},48]: FloatSD4 {loss4:.6f}, FloatSD8 {loss8:.6f}, "
          f"difference {loss4 - loss8:+.6f} (random weights: informative only)", flush=True)

    # the two formats in turns (8, 4, 4, 8: the first serve of a process
    # is not favoured), then a profiled window of decode steps each
    turns: dict[str, list[float]] = {"floatsd8": [], "floatsd4": []}
    for fmt in ("floatsd8", "floatsd4", "floatsd4", "floatsd8"):
        serve(torch, model, params, policy, prompts, step_times=turns[fmt], weight_format=fmt)
    prof = {fmt: profile_decode(torch, model, params, policy, fmt) for fmt in turns}
    for fmt, t in turns.items():
        med = statistics.median(t) * 1e3
        busy, kern, n_ops, wall = prof[fmt]
        print(f"serve4 in turns ({fmt}): median decode step {med:.3f} ms over {len(t)} steps of two runs; "
              f"torch.profiler over {PROFILE_STEPS} decode steps: {wall:.3f} ms wall a step under the profiler, "
              f"device busy {busy:.3f} ms a step (idle share {max(0.0, 1 - busy / wall):.1%} of that window), "
              f"of which kernels {kern:.3f} ms, {n_ops / PROFILE_STEPS:.0f} device operations a step", flush=True)
    return dict(launches=launches, step_ms=step_ms, gen_tok_s=rep["gen_tok_per_s"], loss4=loss4, loss8=loss8)


PROFILE_STEPS = 8


def profile_decode(torch, model, params, policy, fmt):
    """Device time of a decode step at 8 lanes under torch.profiler:
    (busy ms a step, of which the port's kernels, device operations, wall
    ms a step of the same window)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, params, policy, lanes=LANES, chunk=CHUNK, weight_format=fmt)
    eng.submit_all([np.arange(5, 8) for _ in range(LANES)], max_new=PROFILE_STEPS + 4)
    for _ in range(3):  # prefill (which emits the first token) and two decode steps
        eng.step_once()
    torch.cuda.synchronize()
    # device activity only: tracing every host op would lengthen the window timed here
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step_once()  # ends in a device->host copy: synchronised
        wall = (time.perf_counter() - t0) * 1e3
    check(eng.metrics.prefill_steps == 1 and eng.metrics.decode_steps == PROFILE_STEPS + 2,
          f"profiled window: {eng.metrics.format()}")
    busy = 0.0
    n_ops = 0
    # the port's kernels of a decode step: the format's matmul (gates and
    # head), its split K's chunk sums, the cell
    matmul = "floatsd4_matmul_ordered_kernel" if fmt == "floatsd4" else "floatsd_matmul_ordered_kernel"
    kern = {matmul: [0.0, 0], "add_partials": [0.0, 0], "lstm_cell_kernel": [0.0, 0]}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        busy += e.self_device_time_total / 1e3
        n_ops += e.count
        key = next((k for k in kern if k in e.key), None)
        if key:
            kern[key][0] += e.self_device_time_total / 1e3
            kern[key][1] += e.count
    check(all(n > 0 for _, n in kern.values()), f"a kernel of the {fmt} decode steps saw no launch: {kern}")
    return busy / PROFILE_STEPS, sum(ms for ms, _ in kern.values()) / PROFILE_STEPS, n_ops, wall / PROFILE_STEPS


def entry_phase(torch, params, batch):
    """Phase 10: dispatch.quantize on the trained masters, dispatch.qsigmoid
    on a gate block."""
    from repro_torch.core import floatsd
    from repro_torch.core.qsigmoid import qsigmoid_raw
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.qsigmoid.ops import qsigmoid
    from repro_torch.serving import pack_tree

    packed = pack_tree(params)  # core.floatsd.encode, the serving packer
    masters = [(mod, name, w) for mod, leaves in params.items() for name, w in leaves.items() if w.dim() >= 2]
    # layer 0's gate pre-activations at the first time step of 64 sequences
    # (h0 = 0, so z = x @ Wx + b)
    table, wx = packed["embed"]["table"], packed["lstm0"]["wx"]
    toks = torch.as_tensor(batch["tokens"][:, 0], device=table.codes.device).long()
    x = floatsd.decode(table.codes[toks], table.bias)
    z = (kd.matmul(x, wx.codes, wx.bias) + params["lstm0"]["b"].float()).contiguous()
    check(tuple(z.shape) == (64, 4096), f"gate block {tuple(z.shape)}")
    torch.cuda.synchronize()

    kd.STATS.reset()
    floatsd_quantize.launches = qsigmoid.launches = 0
    out = [(mod, name, w, *kd.quantize(w)) for mod, name, w in masters]
    y = kd.qsigmoid(z)
    launches = {"floatsd_quantize": floatsd_quantize.launches, "qsigmoid": qsigmoid.launches}
    stats = kd.STATS.snapshot()
    check(launches == {"floatsd_quantize": len(masters), "qsigmoid": 1}, f"entry launches {launches}")
    check(stats == {("floatsd_quantize", "cuda"): len(masters), ("qsigmoid", "cuda"): 1},
          f"entry dispatch records {stats}")
    for mod, name, w, codes, bias in out:
        p = packed[mod][name]
        check(w.dtype == torch.float16, f"{mod}/{name}: master dtype {w.dtype}")
        check(torch.equal(codes, p.codes) and int(bias) == p.bias,
              f"{mod}/{name}: dispatch.quantize differs from pack_tree ({int((codes != p.codes).sum())} codes, "
              f"bias {int(bias)} vs {p.bias})")
    mism = int((y != qsigmoid_raw(z)).sum())
    check(mism == 0, f"entry qsigmoid: {mism} of {z.numel()} differ from the plain version")
    print(f"entry: dispatch.quantize on {len(masters)} trained fp16 masters "
          f"({', '.join(f'{m}/{n} {list(w.shape)}' for m, n, w in masters)}): codes and biases equal pack_tree's; "
          f"dispatch.qsigmoid on gate block [64,4096]: 0 differ from the plain version; launches {launches}; "
          f"dispatch {dict((f'{o}/{b}', n) for (o, b), n in stats.items())}", flush=True)
    return dict(launches=launches)


# the training runtime (phase 11): the full-width LM (B 64 x S 48,
# floatsd8_table6, sgd(0.9), lr 0.5, seed 0)
RUNTIME_STEPS = 3  # steps of each residual mode from one init
TEL_TURNS = 8  # steps with and without telemetry, in turns
ZS_BYTES = 100_663_296  # save-z's residuals: 2 layers x S 48 x B 64 x 4H 4096 x 4 B


def same_state(a, b, what: str) -> None:
    """Two TrainStates' masters, optimizer state and loss scale bit for bit."""
    from repro_torch.distributed.checkpointing import flatten

    fa, fb = flatten(a), flatten(b)
    check(fa.keys() == fb.keys(), f"{what}: the states' keys differ")
    diff = [k for k in fa if fa[k].dtype != fb[k].dtype or fa[k].tobytes() != fb[k].tobytes()]
    check(not diff, f"{what}: not bit-identical at {diff}")


def runtime_phase(torch, smi):
    """Phase 11: save-z against remat, a crash and its resume through the
    training CLI, telemetry on the kernels against the plain path, and the
    training ops against their plain versions."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch._tree import tree_leaves
    from repro_torch.core.fp8 import quantize_fp8
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed.fault_tolerance import SimulatedFailure
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.launch import train
    from repro_torch.models.task_zoo import make_task
    from repro_torch.nn import lstm
    from repro_torch.obs import telemetry
    from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step

    t_phase = time.perf_counter()
    wrappers = dict(zip(TRAIN_OPS, (floatsd_matmul, matmul_dx, matmul_dw, lstm_cell, lstm_cell_grad,
                                      floatsd_quantize)))
    policy = get_policy("floatsd8_table6")
    model, data, opt, lr, _ = make_task("wikitext2", full=True)
    host = [next(data.batches) for _ in range(RUNTIME_STEPS)]
    batches = [batch_to_device(b, "cuda") for b in host]
    (b, s), h = host[0]["tokens"].shape, model.hidden
    zs_bytes = model.n_layers * s * b * 4 * h * 4
    check(zs_bytes == ZS_BYTES, f"save-z residuals {zs_bytes} B from the shapes, not {ZS_BYTES}")

    def init():
        return init_state(model.init(torch.Generator(device="cuda").manual_seed(SEED)), opt, policy)

    # save-z against remat: the same init and batches, each mode its own run
    step_fn = make_train_step(model.loss, opt, policy, lr=lr)
    modes, old = {}, lstm.BPTT_REMAT
    try:
        for remat in (True, False):
            lstm.BPTT_REMAT = remat
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()  # what the other mode's run still holds
            torch.cuda.reset_peak_memory_stats()
            state = init()
            n0, losses, times = floatsd_matmul.launches, [], []
            for batch in batches:
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
            mm = (floatsd_matmul.launches - n0) / RUNTIME_STEPS
            peak = torch.cuda.max_memory_allocated() - base
            groups, wall = profile_step(torch, step_fn, state, batches[0], require=TRAIN_GROUPS)
            modes[remat] = dict(state=state, losses=losses, step_ms=statistics.median(times[1:]) * 1e3, mm=mm,
                                peak=peak, busy_ms=sum(ms for ms, _ in groups.values()), wall_ms=wall,
                                mm_ms=groups["floatsd_matmul"][0])
    finally:
        lstm.BPTT_REMAT = old
    want_mm = {True: model.n_layers * (2 * s + 2), False: model.n_layers * 2 * s}
    for remat, r in modes.items():
        check(r["mm"] == want_mm[remat] == (196 if remat else 192),
              f"{'remat' if remat else 'save-z'}: {r['mm']} floatsd_matmul launches a step, not {want_mm[remat]}")
    check(modes[False]["losses"] == modes[True]["losses"],
          f"save-z losses {modes[False]['losses']} != remat {modes[True]['losses']}")
    same_state(modes[False]["state"], modes[True]["state"], "save-z vs remat masters")
    r, z = modes[True], modes[False]
    print(f"runtime: save-z vs remat, {RUNTIME_STEPS} steps each from seed {SEED}: losses and every master, "
          f"optimizer buffer and scale bit-identical; floatsd_matmul {r['mm']:.0f} / {z['mm']:.0f} launches a step; "
          f"warm step {r['step_ms']:.2f} / {z['step_ms']:.2f} ms; profiled step device busy {r['busy_ms']:.2f} / "
          f"{z['busy_ms']:.2f} ms of {r['wall_ms']:.2f} / {z['wall_ms']:.2f} ms wall, floatsd_matmul "
          f"{r['mm_ms']:.3f} / {z['mm_ms']:.3f} ms; zs residuals {ZS_BYTES:,} B (from the shapes); "
          f"max_memory_allocated over the run's start {r['peak']:,} / {z['peak']:,} B (difference "
          f"{z['peak'] - r['peak']:,}) ({smi})",
          flush=True)
    del modes, r, z

    # a crash at step 4 and the relaunch, through the CLI
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="runtime_ckpt_", dir=ROOT / "build")
    try:
        args = [*TRAIN_ARGS, "--steps", "6", "--save-every", "3", "--log-every", "3", "--ckpt-dir", ckdir]
        try:
            train.main([*args, "--fail-at", "4"])
            check(False, "--fail-at 4 did not raise SimulatedFailure")
        except SimulatedFailure as e:
            print(f"runtime: the first launch raised SimulatedFailure ({e})", flush=True)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            out = train.main(args)
        print(log.getvalue(), end="", flush=True)
        check("resumed from step 3" in log.getvalue() and out["start_step"] == 3 and int(out["state"].step) == 6,
              f"the relaunch did not resume from step 3 and finish at 6: start {out['start_step']}, "
              f"step {int(out['state'].step)}")
        state = init()
        step_tel = make_train_step(model.loss, opt, policy, lr=lr, telemetry=True)  # the CLI's step
        for batch in batches + batches:  # the relaunch's fresh stream replays batches 0-2
            state, _ = step_tel(state, batch)
        same_state(out["state"], state, "resumed run vs one process")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print("runtime: resume: --fail-at 4 raised, the relaunch resumed from step 3 and finished at 6; its masters, "
          "optimizer state and loss scale equal one process fed batches 0-2, 0-2 bit for bit", flush=True)

    # telemetry: one CLI run with it (and the matmul_dw hook) on, one without
    tel_path = ROOT / "build" / "runtime_telemetry.jsonl"
    tel_path.unlink(missing_ok=True)
    runs, counts = {}, {}
    telemetry.KERNEL_STATS.reset()
    for on in (False, True):
        kd.STATS.reset()
        for w in wrappers.values():
            w.launches = 0
        if on:
            telemetry.KERNEL_STATS.enable()
        try:
            runs[on] = train.main([*TRAIN_ARGS, "--steps", "4", "--log-every", "4"]
                                  + (["--telemetry-out", str(tel_path)] if on else ["--no-telemetry"]))
        finally:
            telemetry.KERNEL_STATS.disable()
        counts[on] = {op: w.launches for op, w in wrappers.items()}
        check(all(n == 0 for (_, be), n in kd.STATS.snapshot().items() if be == "ref"),
              f"telemetry run: a plain-path dispatch {kd.STATS.snapshot()}")
    check(runs[True]["losses"] == runs[False]["losses"], "telemetry changed the losses")
    [rec] = [json.loads(x) for x in tel_path.read_text().splitlines()]
    tel_path.unlink()
    fields = ["step", "window_steps", "loss_mean", "loss_scale", "scale_ups", "scale_downs", "nonfinite_steps",
              "fp8_sat_frac", "fp8_underflow_frac", "fp8_zero_frac", "sd_carry_frac", "sd_clamp_frac",
              "grad_norms", "kernel"]
    check(list(rec) == fields, f"telemetry record fields {list(rec)}")
    fracs = {k: rec[k] for k in fields if k.endswith("_frac")}
    kern = rec["kernel"].get("floatsd_matmul_dw", {})
    check(all(0.0 <= v <= 1.0 for v in fracs.values()) and rec["window_steps"] == 4
          and kern.get("calls") == 4 * 2 * model.n_layers and 0.0 <= kern.get("zero_frac", -1) <= 1.0,
          f"telemetry record {rec}")
    n_mats = sum(p.ndim >= 2 for p in tree_leaves(state.params))
    added = {op: (counts[True][op] - counts[False][op]) / 4 for op in TRAIN_OPS}
    check(added["floatsd_quantize"] == 2 * n_mats and added["floatsd_matmul_dw"] == 0,
          f"telemetry's launches a step {added}")
    t_on, t_off = (statistics.median(runs[on]["step_s"][1:]) * 1e3 for on in (True, False))
    # the step with and without telemetry in turns on one state (the CLI's few
    # steps above each sit in the host's spread), each followed by the CLI's
    # own handling of its metrics (the loss read, and telemetry's copy of its
    # scalars to the host), and one profiled step of each
    step_fns = {False: make_train_step(model.loss, opt, policy, lr=lr), True: step_tel}
    sinks = {on: train.metrics_sink({"losses": [], "finite": []}, telemetry.TelemetryLogger() if on else None,
                                    log_every=10**9, n_steps=0) for on in (False, True)}
    turns, prof = {False: [], True: []}, {}
    for i in range(TEL_TURNS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step_fns[on](runs[True]["state"], batches[i % RUNTIME_STEPS])
            sinks[on](i + 1, m)
            turns[on].append((time.perf_counter() - t0) * 1e3)
    for on in (False, True):
        groups, wall = profile_step(torch, step_fns[on], runs[True]["state"], batches[0], require=TRAIN_GROUPS)
        prof[on] = (sum(ms for ms, _ in groups.values()), sum(n for _, n in groups.values()), wall)
    t_turn = {on: statistics.median(v[1:]) for on, v in turns.items()}
    # the kernels' telemetry against the plain path's, on one state and batch
    tel = {}
    for backend in (None, "ref"):
        with kd.use_backend(backend):
            tel[backend] = step_tel(runs[True]["state"], batches[0])[1]["tel"]
    for k in fracs:
        check(float(tel[None][k]) == float(tel["ref"][k]), f"telemetry {k}: kernels {float(tel[None][k])} vs "
              f"plain {float(tel['ref'][k])}")
    for k, v in tel["ref"]["grad_norm"].items():
        check(float(tel[None]["grad_norm"][k]) == float(v), f"telemetry grad_norm {k} differs")
    print(f"runtime: telemetry: the record's fields are the reference's, fractions {fracs}, matmul_dw hook "
          f"{kern}; warm step {t_on:.2f} ms with it, {t_off:.2f} ms without (the CLI's 3 warm steps); the step "
          f"and the CLI's metrics handling in {TEL_TURNS} turns each {t_turn[True]:.2f} / {t_turn[False]:.2f} ms "
          f"(medians, the first left out), "
          f"profiled device busy {prof[True][0]:.2f} / {prof[False][0]:.2f} ms in {prof[True][1]} / {prof[False][1]} "
          f"device operations, {prof[True][2]:.2f} / {prof[False][2]:.2f} ms wall ({smi}); launches a step it adds "
          f"{added}; metrics['tel'] on the kernels equals the plain path's (backend='ref') on the same state and batch "
          f"({ {k: float(v) for k, v in tel[None].items() if k != 'grad_norm'} })", flush=True)
    launches = counts[True]

    # the training ops at the LM's gate shapes, against their plain versions
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    x = quantize_fp8(torch.randn((b, 1024), device="cuda", generator=g))
    w = (torch.randn((1024, 4 * h), device="cuda", generator=g) * 0.03).to(torch.float16).requires_grad_()
    mm = {}
    for backend in (None, "ref"):
        xr = x.clone().requires_grad_()
        w.grad = None
        with kd.use_backend(backend):
            y = kd.train_matmul(xr, w, kd.hoist_train(w))
        (y * 1e-2).square().sum().backward()
        mm[backend] = (y.detach(), xr.grad, w.grad.clone())
    torch.cuda.synchronize()
    check(torch.equal(mm[None][0], mm["ref"][0]), "train_matmul forward (route A, FP8 x) not bit-identical")
    wd = kd.hoist_train(w.detach(), backend="ref").dense
    gy = 2e-4 * mm["ref"][0]
    dx_err = (mm[None][1].double() - mm["ref"][1].double()).abs()
    check(bool((dx_err <= 1e-5 * (gy.double().abs() @ wd.double().abs().t()) + 1e-30).all()),
          "train_matmul dx exceeds 1e-5")
    dw_off = int((mm[None][2] != mm["ref"][2]).sum())
    dw_step = torch.exp2(torch.floor(torch.log2(mm["ref"][2].float().abs().clamp(min=2.0**-14))) - 2)
    check(dw_off <= 1e-3 * w.numel() and bool(((mm[None][2].float() - mm["ref"][2].float()).abs()
                                                 <= dw_step).all()), f"train_matmul dw: {dw_off} differ")
    zc = torch.randn((b, 4 * h), device="cuda", generator=g) * 2
    c = torch.randn((b, h), device="cuda", generator=g).to(torch.float16)
    a1, a2 = torch.randn((2, b, h), device="cuda", generator=g)
    cell = {}
    for backend in (None, "ref"):
        zr, cr = zc.clone().requires_grad_(), c.clone().requires_grad_()
        hh, c2 = kd.lstm_cell_train(zr, cr, backend=backend)
        ((hh * a1).sum() + (c2.float() * a2).sum()).backward()
        cell[backend] = (hh.detach(), c2.detach(), zr.grad, cr.grad)
    torch.cuda.synchronize()
    check(all(torch.equal(p, q) for p, q in zip(cell[None], cell["ref"])), "lstm_cell_train not bit-identical")
    print(f"runtime: train_matmul [{b},1024] x [1024,{4 * h}] fp16 master: forward bit-identical (route A), dx "
          f"within 1e-5 ({int((dx_err > 0).sum())} of {dx_err.numel()} not bit-identical), dw {dw_off} of "
          f"{w.numel()} one e5m2 step apart; lstm_cell_train z [{b},{4 * h}], c [{b},{h}] fp16: h, c, dz, dc_prev "
          f"bit-identical; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches)


# the zoo: rwkv6_3b at its published width (32 layers, d_model 2560, 40 heads
# of 64, d_ff 8960, vocab 65536, tied, layernorm), served in FloatSD8
ZOO_B, ZOO_S = 2, 1024  # prefill: 2 sequences of 1024 synthetic tokens
ZOO_DECODE = 64  # tokens of sequence 0 fed one at a time through decode_step
ZOO_LANES, ZOO_MAX_NEW = 8, 16
ZOO_BYTES = 2_905_722_960  # tree_nbytes of the packed store: 20 stacked leaves + the dense final norm
ZOO_SITES = 8  # weight sites a layer: wr, wk, wv, wg, wo of the time mix, wk, wv, wr of the channel mix
ZOO_X_LAYERS = 2  # the plain-version cross-check's depth (its floatsd_matmul is ~1.3 ms per M weights)
# prefill against decode (the chunked kernel against the per-token
# recurrence) through all 32 layers: |err| <= ZOO_TOL * max(1, max |logit|)
# with no activation quantizer (policy fp32 on the same codes; measured
# 1e-4). Under floatsd8_table6 a 1-ulp difference that flips an FP8
# activation moves every later position through 32 layers (up to 28% of the
# scale, measured, between two evaluations that share the plain wkv too), so
# that gap is reported, not bounded.
ZOO_TOL = 2e-4
# kernels against the plain versions at ZOO_X_LAYERS layers, prefill logits
# with no activation quantizer (measured 3.1e-6 of the scale); the served
# policy's gap is reported, as above
ZOO_X_TOL = 1e-5
WKV_TOL = 2e-4  # rtol and atol, the JAX package's chunked-vs-recurrence bound; or, where a value
WKV_TERMS_TOL = 1e-5  # cancels far below its terms, this share of the sum of the terms' magnitudes
WKV_L = 16


def wkv_ops(b, s, h, k, v) -> float:
    """Operations of the chunked form: per (sequence, head, chunk of 16)
    the MACs of y's inter-chunk term and of the state update (2 L K V), of
    the tile and of A v (L L (K + V)), counted 2 each, plus the exps (the
    [L, L, K] pairwise decay, the decayed r and k, e^{b_last}) and the logs."""
    chunks = b * h * -(-s // WKV_L)
    macs = 2 * WKV_L * k * v + WKV_L * WKV_L * (k + v)
    exps = WKV_L * WKV_L * k + 2 * WKV_L * k + k
    return float(chunks * (2 * macs + exps + WKV_L * k))


def wkv_phase(torch, dev, flush):
    """Phase 3, continued: the chunked rwkv_wkv kernel against its plain
    version (the per-token recurrence) at the full-width prefill shape
    (three decay regimes) and a ragged S; two launches bit-identical."""
    from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
    from repro_torch.kernels.rwkv_wkv.ref import wkv_ref

    def rejected(got, want, terms):
        """Elements of (y, final state) beyond both rules of the bound."""
        d = [(a - e).abs() for a, e in zip(got, want)]
        return sum(int(((x > WKV_TOL + WKV_TOL * e.abs()) & (x > WKV_TERMS_TOL * t)).sum())
                   for x, e, t in zip(d, want, terms))

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, caught = {}, {}
    print(f"kernels: rwkv_wkv vs the per-token recurrence (rtol = atol = {WKV_TOL}, or {WKV_TERMS_TOL} of the "
          f"sum of the terms' magnitudes where a value cancels far below them; outputs and final states)")
    for s, w0 in [(ZOO_S, -6.0), (ZOO_S, -2.0), (ZOO_S, 1.0), (1000, -2.0)]:
        b, h, k = ZOO_B, 40, 64
        r, kk, vv = (torch.randn((b, s, h, k), device=dev, generator=g) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((b, s, h, k), device=dev, generator=g) * 0.3 + w0))
        u = torch.randn((h, k), device=dev, generator=g) * 0.1
        y, s_fin = rwkv_wkv(r, kk, vv, w, u)
        y_r, s_r = wkv_ref(r, kk, vv, w, u)
        y_t, s_t = wkv_ref(r.abs(), kk.abs(), vv.abs(), w, u.abs())  # the sums of the terms' magnitudes
        y2, s2 = rwkv_wkv(r, kk, vv, w, u)
        torch.cuda.synchronize()
        err = max(float((y - y_r).abs().max()), float((s_fin - s_r).abs().max()))
        n_rel = n_terms = 0
        for a, e, t in ((y, y_r, y_t), (s_fin, s_r, s_t)):
            d = (a - e).abs()
            rel, terms = d <= WKV_TOL + WKV_TOL * e.abs(), d <= WKV_TERMS_TOL * t
            n_rel += int((~rel).sum())
            n_terms = max(n_terms, float((d / t.clamp(min=1e-30)).max()))
            check(bool((rel | terms).all()), f"rwkv_wkv S={s} w0={w0}: max err {err:.3e} beyond rtol = atol = "
                                             f"{WKV_TOL} and beyond {WKV_TERMS_TOL} of the terms")
        check(torch.equal(y, y2) and torch.equal(s_fin, s2), f"rwkv_wkv S={s} w0={w0}: two launches differ")
        # negative control: the recurrence with the bonus u dropped, held to
        # the same bound, must be rejected in every regime (the terms' rule
        # is loosest where w0 = -6 keeps the state large)
        caught[(s, w0)] = rejected(wkv_ref(r, kk, vv, w, torch.zeros_like(u)), (y_r, s_r), (y_t, s_t))
        t = timed_ms(torch, lambda: rwkv_wkv(r, kk, vv, w, u), 20, flush)
        t_plain = timed_ms(torch, lambda: wkv_ref(r, kk, vv, w, u), 3, flush)
        nbytes = 4.0 * (b * s * h * (3 * k + k) + h * k + b * s * h * k + b * h * k * k)
        bd = bound(nbytes, wkv_ops(b, s, h, k, k))
        rows[(s, w0)] = costed(dict(ms=t, plain_ms=t_plain, library_ms=None, err=err, **bd), "rwkv_wkv",
                               f"[{b},{s},{h},{k}] w0 {w0}", b, s, h, k, k, peak="fp32")
        print(f"  [B {b}, S {s}, H {h}, K = V = {k}] w0 {w0}: max_abs_err {err:.3e} (|y| max "
              f"{float(y_r.abs().max()):.3e}); {n_rel} of {y.numel() + s_fin.numel()} beyond rtol = atol = "
              f"{WKV_TOL}, the worst {n_terms:.2e} of its terms' magnitudes; two launches bit-identical | kernel {t:.4f} ms, plain "
              f"{t_plain:.3f} ms, {fmt_bound(bd)}; library call: none (no one PyTorch call computes wkv); "
              f"with u dropped {caught[(s, w0)]} beyond the bound")
    check(all(n > 0 for n in caught.values()),
          f"rwkv_wkv: the bound does not reject the recurrence without u in every regime: {caught}")
    return rows


#: (site, K, N, table stored [N, K]) of each zoo model's weight sites and head
ZOO_MM_SITES = [("dd", 2560, 2560, False), ("cmix-k", 2560, 8960, False), ("cmix-v", 8960, 2560, False),
                ("head", 2560, 65536, True)]
DENSE_MM_SITES = [("wq-wo", 3840, 3840, False), ("wk-wv", 3840, 960, False), ("wi-wg", 3840, 10240, False),
                  ("ffn-wo", 10240, 3840, False), ("head", 3840, 32000, True)]


def zoo_matmul_phase(torch, dev, flush, model="rwkv6_3b", sites=ZOO_MM_SITES, seed=SEED + 3):
    """floatsd_matmul at a zoo model's shapes: its prefill (M = B S = 2048)
    and its decode step at 8 lanes, every weight site and the tied head."""
    from repro_torch.core import floatsd
    from repro_torch.core.fp8 import FP16, quantize_fp8
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref, no_tf32

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    print(f"kernels: floatsd_matmul at {model}'s shapes (both routes |err| <= 1e-5 * (|x| @ |W|) and two "
          "launches bit-identical; route A, the decode step's M, bit for bit on these FP8/FP16 activations)")
    for site, k, n, tr in sites:
        w = torch.randn((n, k) if tr else (k, n), device=dev, generator=g) * (0.02 if tr else k ** -0.5)
        codes, bias = floatsd.encode(w)
        bias = int(bias)
        wd = floatsd.decode(codes, bias)
        wk = wd.t() if tr else wd
        for m in (ZOO_B * ZOO_S, ZOO_LANES):
            x = torch.randn((m, k), device=dev, generator=g)
            x = quantize_fp8(x, FP16) if tr else quantize_fp8(x)
            y, err, mism, route = matmul_vs_plain(torch, x, codes, bias, tr, True,
                                                  f"floatsd_matmul {model} {site} {m}x{k}x{n}")
            # route B's bound against the plain version with one code moved
            first = (site, m) == (sites[0][0], ZOO_B * ZOO_S)
            control = moved_code_control(torch, x, codes, bias, tr, y) if first else None
            del y
            with no_tf32():
                t = timed_ms(torch, lambda: floatsd_matmul(x, codes, bias, transposed=tr), 10, flush)
                t_plain = timed_ms(torch, lambda: floatsd_matmul_ref(x, codes, bias, transposed=tr), 1, flush)
                t_lib = timed_ms(torch, lambda: torch.matmul(x, wk), 10, flush)
            bd = bound(x.numel() * 4 + codes.numel() + 4 + m * n * 4, 2.0 * m * n * k,
                       matmul_peak(x, floatsd.decode(codes, 0)))
            rows[(site, m)] = costed(dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=err, route=route, **bd),
                                     "floatsd_matmul", f"{model} {site} [{m},{k}]x[{k},{n}]", m, k, n)
            print(f"  {site:6s} [{m},{k}] x {'[N,K]^T' if tr else '[K,N]'} N={n}, route {route}: max_abs_err "
                  f"{err:.3e}, {mism} of {m * n} not bit-identical, two launches bit-identical"
                  + ("" if control is None else f", a code moved one mantissa step {control} beyond the bound")
                  + f" | kernel {t:.4f} ms, plain {t_plain:.3f} ms, torch.matmul {t_lib:.4f} ms, {fmt_bound(bd)}",
                  flush=True)
        del codes, wd, wk, w
    return rows


def torch_ops(torch, fn) -> int:
    """The ATen operations that ``fn()`` dispatches: the host's work, which
    sets a host-bound step (each costs microseconds of host time)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def zoo_decode(torch, model, tree, toks, policy, late: int = 0, n: int = ZOO_DECODE):
    """Sequence 0's first ``n`` tokens through decode_step one at a time (an
    attention model's KV cache holds them all): (logits [n, vocab], wall
    time of each step). ``late`` > 0 starts an attention model's cache that
    many positions late, a negative control: its unwritten slots then count
    as keys."""
    out, times = [], []
    with torch.no_grad():
        cache = model.init_cache(1, policy, toks.device, cache_len=n)
        if late:
            kv = cache["stack"]["b0"]
            cache = {**cache, "stack": {"b0": kv._replace(pos=kv.pos + late)}}
        for t in range(n):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(tree, toks[:1, t:t + 1], cache, policy)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            out.append(lg[0, 0])
    return torch.stack(out), times


def positions_gap(torch, got, want, tol=None) -> dict:
    """Per-position gaps of [positions, vocab] logits, over scale = max(1,
    max |want|): the largest, the last position's, the first position
    beyond ``tol`` (default ZOO_TOL), and the positions whose argmax
    agrees."""
    scale = max(1.0, float(want.abs().max()))
    per = (got.float() - want.float()).abs().amax(dim=-1) / scale
    beyond = (per > (ZOO_TOL if tol is None else tol)).nonzero()
    return {"scale": scale, "max": float(per.max()), "last": float(per[-1]),
            "first": int(beyond[0]) if beyond.numel() else got.shape[0],
            "argmax": int((got.argmax(-1) == want.argmax(-1)).sum())}


def zoo_counters(reset: bool = False, fmt: str = "floatsd8") -> dict:
    """Launch counts of the zoo paths' kernels (zeroed when ``reset``); a
    FloatSD4 store's paths count floatsd4_matmul too."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.qsigmoid.ops import qsigmoid
    from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv

    wrappers = {"floatsd_matmul": floatsd_matmul, "qsigmoid": qsigmoid, "rwkv_wkv": rwkv_wkv,
                "flash_attention": flash_attention}
    if fmt == "floatsd4":
        wrappers["floatsd4_matmul"] = floatsd4_matmul
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {op: w.launches for op, w in wrappers.items()}


def zoo_build(torch, dev, n_layers=None, arch="rwkv6_3b", fmt="floatsd8", **over):
    """``arch`` (or its first ``n_layers``; ``over`` replaces other config
    fields) from seed 0, packed to ``fmt`` (FloatSD8 or FloatSD4); the f32
    tree is freed before anything is served."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import WeightStore

    cfg = get_config(arch)
    if n_layers is not None:
        over["n_layers"] = n_layers
    cfg = dataclasses.replace(cfg, **over)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    store = WeightStore.pack(params, fmt=fmt)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, model, store, time.perf_counter() - t0


def zoo_serve(torch, model, tree, policy, prompts, backend=None, cache_len=None, max_new=ZOO_MAX_NEW,
              weight_format="floatsd8"):
    """ServeEngine over the packed store: lanes in lockstep, one token a
    step; returns (engine, requests by rid, decode-step wall times)."""
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, tree, policy, lanes=ZOO_LANES, backend=backend, cache_len=cache_len,
                      weight_format=weight_format)
    reqs = eng.submit_all([p.copy() for p in prompts], max_new=max_new)
    times = []
    eng.metrics.start()
    while True:
        t0 = time.perf_counter()
        if not eng.step_once():  # ends in a device->host copy: synchronised
            break
        times.append(time.perf_counter() - t0)
    eng.metrics.stop()
    return eng, sorted(reqs, key=lambda r: r.rid), times


def decisive_tokens(reqs, refs, what: str) -> tuple[int, int]:
    """Greedy streams of the kernels against the plain path's, equal over
    each request's margin-decisive prefix (the plain run's top-2 gap above
    MARGIN_FLOOR), at least half the tokens decisive: (decisive tokens,
    streams equal in full)."""
    decisive = agree = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(ref.margins) if g <= MARGIN_FLOOR), len(ref.out))
        check(r.out[:n] == ref.out[:n], f"{what}: request {r.rid}: {r.out} vs plain {ref.out} (decisive {n})")
        decisive += n
        agree += r.out == ref.out
    check(decisive >= sum(len(ref.out) for ref in refs) // 2, f"{what}: only {decisive} decisive tokens")
    return decisive, agree


def zoo_phase(torch, dev, smi):
    """Phase 12: full-width rwkv6_3b, packed, prefilled, decoded and served."""
    import numpy as np

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.serving import synthetic_prompts

    cfg, model, store, t_build = zoo_build(torch, dev)
    L = cfg.n_layers
    print(f"zoo: {cfg.name} ({L} layers, d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) from seed {SEED}: {store.dense_nbytes} B f32 "
          f"-> {store.packed_nbytes} B packed FloatSD8 ({store.n_packed} stacked leaves) in {t_build:.1f} s", flush=True)
    check(store.packed_nbytes == ZOO_BYTES and store.n_packed == 20,
          f"zoo resident bytes {store.packed_nbytes} != {ZOO_BYTES} ({store.n_packed} leaves packed)")
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")  # the codes are the quantized weights
    tree = model.hoist(store.tree)  # the small stacked leaves decoded once, as the engine does
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    n_sites = ZOO_SITES * L + 1
    out = {}

    # prefill: counters zeroed just before, read just after
    kd.STATS.reset()
    zoo_counters(reset=True)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = model.prefill(tree, {"tokens": toks}, pol)
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    want = {"floatsd_matmul": n_sites, "qsigmoid": 2 * L, "rwkv_wkv": L, "flash_attention": 0}
    check(launches == want, f"zoo prefill launches {launches} != {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items() if n}, f"zoo prefill dispatch records {stats}")
    check(tuple(logits.shape) == (ZOO_B, ZOO_S, cfg.vocab_padded()) and bool(torch.isfinite(logits).all()),
          f"zoo prefill logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with torch.no_grad():
        t0 = time.perf_counter()
        model.prefill(tree, {"tokens": toks}, pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, wall_prof = profile_prefill(torch, lambda: model.prefill(tree, {"tokens": toks}, pol))
    busy = sum(ms for ms, _ in groups.values())
    out["prefill"] = dict(launches=launches, wall_s=wall, tok_s=ZOO_B * ZOO_S / wall, profile=groups)
    print(f"zoo prefill: B {ZOO_B} x S {ZOO_S}: {wall * 1e3:.1f} ms wall ({wall_first * 1e3:.1f} ms the first, "
          f"with warm-up), {ZOO_B * ZOO_S / wall:.0f} tok/s ({smi}); launches {launches} (per layer "
          f"{ZOO_SITES} weight sites, 2 receptance gates, 1 wkv; + the head); dispatch "
          f"{dict((f'{o}/{b}', n) for (o, b), n in stats.items())}; logits finite, |max| "
          f"{float(logits.abs().max()):.3f}. Profiled prefill: {wall_prof:.1f} ms wall, device busy {busy:.1f} ms: "
          + ", ".join(f"{grp} {ms:.1f} ms ({n} kernels)" for grp, (ms, n) in groups.items()), flush=True)

    # token-by-token decode of sequence 0 against the prefill's logits
    kd.STATS.reset()
    zoo_counters(reset=True)
    dec, times = zoo_decode(torch, model, tree, toks, pol)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    with torch.no_grad():  # one more step, after the counters are read: its host work
        cache = model.init_cache(1, pol, dev)
        n_ops = torch_ops(torch, lambda: model.decode_step(tree, toks[:1, :1], cache, pol))
    want = {"floatsd_matmul": n_sites * ZOO_DECODE, "qsigmoid": 2 * L * ZOO_DECODE, "rwkv_wkv": 0,
            "flash_attention": 0}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"zoo decode launches {launches} != {want}; dispatch {stats}")
    check(bool(torch.isfinite(dec).all()), "zoo decode: nonfinite logits")
    served = positions_gap(torch, dec, logits[0, :ZOO_DECODE])
    # the same first tokens prefilled on the plain versions (the plain wkv;
    # at M = 64 the matmul's plain version sums in its route A's order, as
    # the decode's kernels do, and the qsigmoid kernel equals its plain
    # version bit for bit, while the kernels' prefill at M = 2048 ran route
    # B, within the precise bound of it), against the decode and against the
    # kernels' prefill
    with torch.no_grad(), kd.use_backend("ref"):
        plain_pre = model.prefill(tree, {"tokens": toks[:1, :ZOO_DECODE]}, pol)[0]
    dec_vs_plain = positions_gap(torch, dec, plain_pre)
    kernel_vs_plain = positions_gap(torch, logits[0, :ZOO_DECODE], plain_pre)
    # the same codes with no activation quantizer (policy fp32): the chunked
    # kernel against the per-token recurrence through all 32 layers
    fp32 = get_policy("fp32")
    with torch.no_grad():
        ref32 = model.prefill(tree, {"tokens": toks[:1, :ZOO_DECODE]}, fp32)[0]
    dec32, _ = zoo_decode(torch, model, tree, toks, fp32)
    plain = positions_gap(torch, dec32, ref32)
    check(plain["max"] <= ZOO_TOL, f"zoo decode vs prefill, no activation quantizer: max err {plain['max']:.3e} "
                                   f"of the scale {plain['scale']:.3f} (bound {ZOO_TOL})")
    step = statistics.median(times[1:])
    out["decode"] = dict(launches=launches, step_ms=step * 1e3, tok_s=1 / step, aten_ops=n_ops, served=served,
                         plain=plain)
    print(f"zoo decode: {ZOO_DECODE} steps of sequence 0 (B 1): median step {step * 1e3:.2f} ms, {1 / step:.1f} "
          f"tok/s ({smi}), {n_ops} ATen operations a step; launches {launches}. Against the prefill's logits at positions 0-{ZOO_DECODE - 1}: "
          f"with no activation quantizer (policy fp32, the same codes) max err {plain['max']:.3e} of the scale "
          f"{plain['scale']:.3f} (bound {ZOO_TOL}), argmax equal at {plain['argmax']} of {ZOO_DECODE}; under "
          f"floatsd8_table6 (reported: an FP8 flip of an activation moves everything after it through 32 "
          f"layers) bit-equal or within {ZOO_TOL} of the scale {served['scale']:.3f} up to position "
          f"{served['first'] - 1}, then up to {served['max']:.3e} of it (position {ZOO_DECODE - 1}: "
          f"{served['last']:.3e}), argmax equal at {served['argmax']} of {ZOO_DECODE}. The same under "
          f"floatsd8_table6 against a prefill of those tokens on the plain versions: decode up to "
          f"{dec_vs_plain['max']:.3e} of the scale (position {ZOO_DECODE - 1}: {dec_vs_plain['last']:.3e}; "
          f"within {ZOO_TOL} up to position {dec_vs_plain['first'] - 1}), the kernels' prefill up to "
          f"{kernel_vs_plain['max']:.3e} (within {ZOO_TOL} up to position {kernel_vs_plain['first'] - 1})",
          flush=True)
    out["decode"].update(dec_vs_plain=dec_vs_plain, kernel_vs_plain=kernel_vs_plain)
    del logits, ref32, dec, dec32, plain_pre

    # ServeEngine: 8 lanes, 8 requests, lockstep one-token steps
    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    kd.STATS.reset()
    zoo_counters(reset=True)
    eng, reqs, times = zoo_serve(torch, model, store.tree, get_policy("floatsd8_table6"), prompts)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    m = eng.metrics
    check(eng.chunk == 1 and eng.store.packed_nbytes == ZOO_BYTES, "zoo engine: chunk or store")
    check(all(r.status == "done" and len(r.out) == ZOO_MAX_NEW for r in reqs) and m.numeric_errors == 0,
          f"zoo engine: {[r.status for r in reqs]}, {m.numeric_errors} nonfinite")
    want = {"floatsd_matmul": n_sites * m.steps, "qsigmoid": 2 * L * m.steps, "rwkv_wkv": 0,
            "flash_attention": 0}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"zoo engine launches {launches} != {want}; dispatch {stats}")
    step = statistics.median(times)
    rep = m.report()
    out["engine"] = dict(launches=launches, step_ms=step * 1e3, gen_tok_s=rep["gen_tok_per_s"],
                         lane_tok_s=ZOO_LANES / step)
    print(f"zoo engine: {m.format()}; median step {step * 1e3:.2f} ms over {len(times)} steps at "
          f"{ZOO_LANES} lanes = {ZOO_LANES / step:.1f} tok/s ({smi}); launches {launches}", flush=True)
    out["launches"] = {op: sum(out[p]["launches"][op] for p in ("prefill", "decode", "engine"))
                       for op in want}
    del eng, store, tree
    torch.cuda.empty_cache()
    return out


def zoo_x_phase(torch, dev, smi):
    """Phase 13: the zoo's path at full width and ZOO_X_LAYERS layers on
    the kernels against backend="ref" (the plain versions) on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.serving import synthetic_prompts

    cfg, model, store, _ = zoo_build(torch, dev, ZOO_X_LAYERS)
    tree = model.hoist(store.tree)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    gaps = {}
    for name in ("fp32", "floatsd8_table6"):
        pol = get_policy(name).replace(weight_quant="none")
        with torch.no_grad():
            got = model.prefill(tree, {"tokens": toks}, pol)
            t0 = time.perf_counter()
            with kd.use_backend("ref"):
                want = model.prefill(tree, {"tokens": toks}, pol)
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t0
        gaps[name] = positions_gap(torch, got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
        gaps[name]["bit_equal"] = float((got == want).float().mean())
        del got, want
    g32, g8 = gaps["fp32"], gaps["floatsd8_table6"]
    check(g32["max"] <= ZOO_X_TOL, f"zoo-x prefill logits, no activation quantizer: max err {g32['max']:.3e} of "
                                   f"the scale {g32['scale']:.3f} (bound {ZOO_X_TOL})")
    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    pol8 = get_policy("floatsd8_table6")
    _, reqs, _ = zoo_serve(torch, model, store.tree, pol8, prompts)
    _, refs, ref_times = zoo_serve(torch, model, store.tree, pol8, prompts, backend="ref")
    decisive, agree = decisive_tokens(reqs, refs, "zoo-x")
    print(f"zoo-x ({ZOO_X_LAYERS} of {get_config('rwkv6_3b').n_layers} layers at full width, kernels vs "
          f"backend='ref' on the card): prefill logits [{ZOO_B},{ZOO_S}] with no activation quantizer (policy "
          f"fp32, the same codes) max err {g32['max']:.3e} of the scale {g32['scale']:.3f} (bound {ZOO_X_TOL}), "
          f"{g32['bit_equal']:.2%} bit-equal; under floatsd8_table6 (reported) max err {g8['max']:.3e} of the "
          f"scale {g8['scale']:.3f}, {g8['bit_equal']:.2%} bit-equal, every position within {ZOO_TOL} up to "
          f"{g8['first']} of {ZOO_B * ZOO_S} (flattened), argmax equal at {g8['argmax']}; plain prefill "
          f"{t_ref:.2f} s; engine ({ZOO_LANES} lanes, {ZOO_MAX_NEW} new tokens, floatsd8_table6): {decisive} of "
          f"{ZOO_LANES * ZOO_MAX_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) and equal, {agree} of "
          f"{ZOO_LANES} streams equal in full; plain decode step {statistics.median(ref_times) * 1e3:.1f} ms",
          flush=True)
    del store, tree
    torch.cuda.empty_cache()
    return gaps


# the dense family: h2o_danube3_4b at its published width (24 layers, d_model
# 3840, 32 heads of 120 over 8 KV heads, d_ff 10240, vocab 32000, window 4096,
# RoPE, rmsnorm, SwiGLU, tied), served in FloatSD8
DENSE_ARCH = "h2o_danube3_4b"
DENSE_BYTES = 3_838_970_920  # tree_nbytes of the packed store: 9 stacked leaves + the table + the final norm
DENSE4_BYTES = 2_078_169_600  # the FloatSD4 store: ceil(k/2) code bytes + ceil(k/32) exponents a column
DENSE_KV_BYTES = 1_509_949_440  # the engine's bf16 KV cache: 24 layers x 2 x 8 lanes x 2048 x 8 x 120 x 2 B
DENSE_CACHE_LEN = 2048  # the engine's KV cache positions (the serve CLI's)
DENSE_SITES = 7  # weight sites a layer: wq, wk, wv, wo of the attention, wi, wg, wo of the FFN
DENSE_X_LAYERS = 2
# prefill against decode through all 24 layers with no activation quantizer
# (policy fp32 on the same codes): prefill rounds p and v to bf16, decode
# reads k and v from a bf16 cache. The full-width reading from seed 0 is
# 2.112e-3 of the logit scale in every run on the H100 (the JAX package's
# own gap at the reduced config, 2 layers: 3.1e-3 to 3.9e-3 over three
# seeds); the bound leaves 2.4x of headroom. A decode whose cache starts one
# position late (an unwritten slot counted as a key) must exceed it.
DENSE_TOL = 5e-3
# the same check on h2o_danube3_4b's FloatSD4 store (dense4): its sound
# reading is 2.980e-5 of the scale and a cache one position late 4.837e-3,
# under DENSE_TOL (an H100 80GB HBM3 at 700 W); a bound between the two,
# 17x above the first and 10x below the second
DENSE4_TOL = 5e-4
# kernels against the plain versions at DENSE_X_LAYERS layers, prefill logits
# with no activation quantizer: one bf16 step (2^-8) of the logit scale. The
# two attentions round p to bf16 from scores that differ in their last bits,
# so a p on a rounding boundary lands one bf16 step apart and moves its row
# by up to 2^-8 p |v| / l; a gap of more than one bf16 step of the logits
# is more than those roundings (the reduced model on the card: 1.1e-3 of
# its scale, tests/test_torch_cuda.py)
DENSE_X_TOL = 2.0 ** -8
# flash_attention against its plain versions: the JAX package's
# kernel-vs-oracle bounds (tests/test_flash_kernel.py), |err| <= atol + rtol
# |want|, f32 and bf16 inputs
FLASH_TOL = {"float32": (6e-3, 2e-2), "bfloat16": (2e-2, 3e-2)}
# rows held against the oracle as the plain version is: no more outputs
# beyond the JAX package's bound than the plain version (the kernel's
# function: p and v rounded to bf16, an error of up to 2^-8 sum p |v| from the
# f32 oracle) has there; every row is held to the bound against the plain
# version
FLASH_AS_PLAIN = ("jamba",)
FLASH_Q_SCALE = 2.0  # q ~ N(0, 4): scores of std 2 (a peaked attention, as a trained model's)
# (name, B, Sq, Skv, H, Kh, D, causal, window, dtype, prefix): the dense
# prefill (the window of 4096 inactive at S 1024), the window biting, a
# ragged S, no causal mask, bf16, the hybrid's prefill (head size 128, the
# kernel's D_MAX, no window); Whisper's encoder (no causal mask, S 1500, 20
# heads of 64) and cross-attention (64 queries over the 1500 encoder states),
# and Qwen2-VL's prefill (12 heads of 128 over 2, causal with its 256
# patches as the prefix)
FLASH_CASES = [("prefill", ZOO_B, ZOO_S, ZOO_S, 32, 8, 120, True, 4096, "float32", 0),
               ("window", 1, 8192, 8192, 32, 8, 120, True, 4096, "float32", 0),
               ("ragged", ZOO_B, 1000, 1000, 32, 8, 120, True, 4096, "float32", 0),
               ("full", ZOO_B, ZOO_S, ZOO_S, 32, 8, 120, False, None, "float32", 0),
               ("bf16", ZOO_B, ZOO_S, ZOO_S, 32, 8, 120, True, 4096, "bfloat16", 0),
               ("jamba", ZOO_B, ZOO_S, ZOO_S, 32, 8, 128, True, None, "float32", 0),
               ("whisper-enc", ZOO_B, 1500, 1500, 20, 20, 64, False, None, "float32", 0),
               ("whisper-cross", ZOO_B, 64, 1500, 20, 20, 64, False, None, "float32", 0),
               ("qwen2-vl", ZOO_B, ZOO_S, ZOO_S, 12, 2, 128, True, None, "float32", 256)]


def attend_pairs(sq: int, skv: int, causal: bool, window, prefix: int = 0) -> int:
    """The (query, key) pairs the masks admit, positions from 0 (causal:
    key j <= max(i, prefix - 1))."""
    total = 0
    for i in range(sq):
        hi = min(skv - 1, max(i, prefix - 1)) if causal else skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_ops(pair_d: float, q, k) -> list:
    """The operations of flash attention over ``pair_d`` = admitted (query,
    key) pairs x D, at the peak of the fastest tensor-core type that holds
    every operand value (matmul_peak's rule): PV at the 16-bit peak (p and
    v are rounded to bf16); QK^T at the 16-bit peak on bf16 operands, and on
    f32 ones at the cheaper of the FP32 peak and six exact-piece bf16
    products (the pieces whose weight reaches 2^-16) at the 16-bit peak."""
    qk = 2.0 * pair_d
    if matmul_peak(q, k) == "bf16":
        qk_part = (qk, "bf16")
    else:
        rate = {"fp32": FP32_OPS_PER_S, "bf16": BF16_OPS_PER_S}
        qk_part = min([(qk, "fp32"), (6 * qk, "bf16")], key=lambda part: part[0] / rate[part[1]])
    return [qk_part, (2.0 * pair_d, "bf16")]


def flash_oracle(torch, q, k, v, causal, window, prefix=0, heads_per_call=4):
    """``flash_attention_ref`` (the [BH, S, D] oracle, f32 scores and PV) on
    the model layout, K and V expanded to the query heads, a few heads at a
    time (the scores of all 32 heads at S 8192 would take 8.6 GB)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    for h0 in range(0, h, heads_per_call):
        hs = range(h0, min(h, h0 + heads_per_call))
        kv = [t[:, :, [j // g for j in hs]].permute(0, 2, 1, 3).reshape(-1, skv, d) for t in (k, v)]
        o = flash_attention_ref(q[:, :, h0:h0 + len(hs)].permute(0, 2, 1, 3).reshape(-1, sq, d), *kv,
                                causal, window, prefix)
        out[:, :, h0:h0 + len(hs)] = o.reshape(b, len(hs), sq, d).permute(0, 2, 1, 3)
    return out


def flash_phase(torch, dev, flush, cases=None):
    """Phase 3, continued: the flash_attention kernel against its plain
    versions (the oracle and the model's chunked online softmax) at the
    dense prefill's shape, where the window bites, at a ragged S, without
    the causal mask, on bf16, and at the hybrid's, Whisper's (encoder,
    cross-attention) and Qwen2-VL's (the causal prefix) prefill shapes; two
    launches bit-identical; the oracle without the window, at the window's
    shape, rejected."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import _mask, flash_attention_gqa
    from repro_torch.kernels.floatsd_matmul.ref import no_tf32

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = {}
    print(f"kernels: flash_attention vs the oracle and the chunked plain version (|err| <= atol + rtol |want|: "
          f"f32 {FLASH_TOL['float32']}, bf16 {FLASH_TOL['bfloat16']}; q ~ N(0, {FLASH_Q_SCALE ** 2:g}))")
    for name, b, s, skv, h, kh, d, causal, window, dt, prefix in cases or FLASH_CASES:
        dt = getattr(torch, dt)
        q = (torch.randn((b, s, h, d), device=dev, generator=g) * FLASH_Q_SCALE).to(dt)
        k, v = (torch.randn((b, skv, kh, d), device=dev, generator=g).to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window, prefix=prefix)
        o = flash_attention(q, k, v, **kw)
        o2 = flash_attention(q, k, v, **kw)
        oracle = flash_oracle(torch, q, k, v, causal, window, prefix)
        plain = flash_attention_gqa(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(o, o2), f"flash_attention {name}: two launches differ")
        atol, rtol = FLASH_TOL[str(dt).split(".")[-1]]
        errs = {}
        # the plain version's own outputs beyond the oracle's bound: where it
        # has some, the kernel may have no more than it (FLASH_AS_PLAIN)
        plain_beyond = int(((plain.float() - oracle.float()).abs()
                            > atol + rtol * oracle.float().abs()).sum())
        for ref_name, want in (("oracle", oracle), ("plain", plain)):
            e = (o.float() - want.float()).abs()
            beyond = int((e > atol + rtol * want.float().abs()).sum())
            allowed = plain_beyond if ref_name == "oracle" and name in FLASH_AS_PLAIN else 0
            check(beyond <= allowed, f"flash_attention {name}: {beyond} outputs beyond the bound against the "
                                     f"{ref_name} (max err {float(e.max()):.3e}; the plain version {plain_beyond})")
            errs[ref_name] = (float(e.max()), int((o != want).sum()), beyond)
        caught = None
        if name == "prefill":  # the f32 scores' precision control
            one_piece = flash_attention_gqa(q.bfloat16().float(), k.bfloat16().float(), v, causal=causal, window=window)
            ratio = float((o - plain).abs().max()) / float((one_piece - plain).abs().max())
            check(ratio <= 0.25, f"flash_attention: f32 scores less precise than a quarter of one bf16 pass ({ratio:.3f})")
            precision = ratio
            del one_piece
        if name == "window":  # negative control: the plain version without the window
            nowin = flash_attention_gqa(q, k, v, causal=causal, window=None)
            e = (nowin.float() - oracle.float()).abs()
            caught = float((e > atol + rtol * oracle.float().abs()).float().mean())
            check(caught > 0.01, f"flash_attention: the bound does not reject attention without the window "
                                 f"({caught:.2%} beyond)")
            del nowin
        t = timed_ms(torch, lambda: flash_attention(q, k, v, **kw), 10, flush)
        with no_tf32():
            t_plain = timed_ms(torch, lambda: flash_attention_gqa(q, k, v, **kw), 3, flush)
            # the library yardstick: SDPA on the heads-major layout; where the
            # window bites or a prefix widens the causal mask, the mask as a
            # boolean attn_mask
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            if prefix:
                pos = torch.arange(s, device=dev)
                lib_kw, lib_call = dict(attn_mask=_mask(pos, pos, causal, None, prefix)), f"attn_mask=prefix {prefix}"
            elif window is None or window >= s:
                lib_kw, lib_call = dict(is_causal=causal), f"is_causal={causal}"
            else:
                pos = torch.arange(s, device=dev)
                lib_kw, lib_call = dict(attn_mask=_mask(pos, pos, causal, window)), "attn_mask=band"
            lib = sdpa(qt, kt, vt, enable_gqa=True, **lib_kw).transpose(1, 2)
            e = (lib.float() - oracle.float()).abs()
            lib_beyond = int((e > atol + rtol * oracle.float().abs()).sum())
            check(lib_beyond == 0, f"flash_attention {name}: SDPA ({lib_call}) is {lib_beyond} outputs beyond the "
                                   f"bound of the oracle: not the same function")
            t_lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw), 10, flush)
            del qt, kt, vt, lib, lib_kw
        pairs = b * h * attend_pairs(s, skv, causal, window, prefix)
        bd = bound(q.element_size() * (2 * q.numel() + k.numel() + v.numel()), flash_ops(pairs * d, q, k))
        rows[name] = costed(dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=max(v[0] for v in errs.values()), **bd),
                            "flash_attention", f"{name} q [{b},{s},{h},{d}] {str(dt)[6:]}", b, s, skv, h, kh, d,
                            peak="bf16" if dt == torch.bfloat16 else "fp32", causal=causal, window=window,
                            elem_bytes=q.element_size(), prefix=prefix)
        print(f"  {name:8s} q [{b},{s},{h},{d}], k, v [{b},{skv},{kh},{d}] {str(dt)[6:]}, causal {causal}, window "
              f"{window}, prefix {prefix}: vs oracle max_abs_err {errs['oracle'][0]:.3e} ({errs['oracle'][1]} of {o.numel()} not "
              f"bit-identical), vs plain {errs['plain'][0]:.3e} ({errs['plain'][1]} not bit-identical); |o| max "
              f"{float(oracle.float().abs().max()):.3f}; outputs beyond the bound of the oracle: the kernel "
              f"{errs['oracle'][2]}, the plain version {plain_beyond}; two launches bit-identical"
              + (f"; without the window {caught:.2%} beyond the bound" if caught is not None else "")
              + (f"; vs plain {precision:.3f} of the error of one bf16 pass of the scores (bound 0.25)"
                 if name == "prefill" else "")
              + f" | kernel {t:.4f} ms, plain {t_plain:.3f} ms, "
              + f"SDPA ({lib_call}, enable_gqa; 0 beyond the bound of the oracle) {t_lib:.4f} ms"
              + f", {pairs * d * 4 / 1e9:.2f} GFLOP, {fmt_bound(bd)}", flush=True)
        del q, k, v, o, o2, oracle, plain
    torch.cuda.empty_cache()
    return rows


def profile_prefill(torch, run, mm: str = "floatsd_matmul"):
    """One prefill (``run()``) under torch.profiler: device time (ms) and
    launches by kernel group, and the wall time (ms) of the same call;
    ``mm`` names the matmul whose partial sums add_partials adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = [("flash_fwd_kernel", "flash_attention"), ("flash_split_kv", "flash_attention"),
             ("rwkv_wkv_kernel", "rwkv_wkv"), ("wkv_chunk_prep", "rwkv_wkv"), ("qsigmoid_kernel", "qsigmoid"),
             ("floatsd4_matmul_", "floatsd4_matmul"), ("floatsd_matmul_", "floatsd_matmul"), ("add_partials", mm),
             ("split_pieces", "floatsd_matmul")]
    groups = {g: [0.0, 0] for _, g in names + [("", "other torch ops")]}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        grp = next((grp for key, grp in names if key in e.key), "other torch ops")
        groups[grp][0] += e.self_device_time_total / 1e3
        groups[grp][1] += e.count
    return {grp: v for grp, v in groups.items() if v[1]}, wall


def site_count(store) -> int:
    """Weight sites a layer of a packed store's stack (a matmul launch each)."""
    from repro_torch.nn.transformer import WEIGHT_SITES

    return sum(key.split("/")[-1] in WEIGHT_SITES for key in flat_leaves(store.tree["stack"]))


def fmt_want(fmt: str, mm: int, flash: int) -> dict:
    """zoo_counters(fmt)'s launches of a dense-block path: ``mm`` on the
    format's matmul, none on the other."""
    want = {"floatsd_matmul": 0, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": flash}
    if fmt == "floatsd4":
        want["floatsd4_matmul"] = 0
    want[MM_OP[fmt]] = mm
    return want


MM_OP = {"floatsd8": "floatsd_matmul", "floatsd4": "floatsd4_matmul"}
FMT_NAME = {"floatsd8": "FloatSD8", "floatsd4": "FloatSD4"}


def dense_phase(torch, dev, smi, arch=DENSE_ARCH, what="dense", resident=DENSE_BYTES, leaves=10,
                kv_want=DENSE_KV_BYTES, fmt="floatsd8", built=None, decode_n=ZOO_DECODE, tol=DENSE_TOL):
    """Phase 14 (and 23, for ``VLM_ARCH``; 27 and 30 in FloatSD4 and for the
    other dense configs): a dense-block model at full width, packed to
    ``fmt``, prefilled (a vlm over its stub patches, the attention's causal
    prefix), decoded ``decode_n`` tokens and served. ``built``: (cfg, model,
    store, build seconds, peak bytes) of a store built by the caller (a
    streamed one), else the model is drawn and packed here. ``tol``: the
    bound of the decode-vs-prefill check with no activation quantizer,
    which a cache one position late must exceed."""
    import numpy as np

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.flash_attention import cost as fa_cost
    from repro_torch.serving import synthetic_prompts

    held = torch.cuda.memory_allocated()
    if built is None:
        torch.cuda.reset_peak_memory_stats()
        cfg, model, store, t_build = zoo_build(torch, dev, arch=arch, fmt=fmt)
        peak = torch.cuda.max_memory_allocated()
    else:
        cfg, model, store, t_build, peak = built
    check(store.fmt == fmt, f"{what}: a {store.fmt} store for a {fmt} phase")
    L, mm = cfg.n_layers, MM_OP[fmt]
    sites = site_count(store)
    print(f"{what}: {cfg.name} ({L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} over "
          f"{cfg.kv_heads} KV heads, d_ff {cfg.d_ff} {cfg.ffn_kind}, {cfg.norm}, vocab {cfg.vocab}, window {cfg.window}"
          + (f", M-RoPE sections {cfg.mrope_sections}, {cfg.n_patches} stub patches" if cfg.n_patches else "")
          + f") from seed {SEED}: {store.dense_nbytes} B f32 -> {store.packed_nbytes} B packed {FMT_NAME[fmt]} "
          f"({store.n_packed} leaves) in {t_build:.1f} s, peak device memory {peak} B; {held} B held on the card "
          f"before the build", flush=True)
    check(store.packed_nbytes == resident and store.n_packed == leaves,
          f"{what} resident bytes {store.packed_nbytes} != {resident} ({store.n_packed} leaves packed)")
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")
    tree = model.hoist(store.tree)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    batch = {"tokens": toks}
    if cfg.n_patches:
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        batch["patch_embeds"] = torch.randn((ZOO_B, cfg.n_patches, cfg.d_model), device=dev, generator=g)
    n_sites = sites * L + 1
    out = {"resident": store.packed_nbytes, "peak": peak, "build_s": t_build}

    kd.STATS.reset()
    zoo_counters(reset=True, fmt=fmt)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = model.prefill(tree, batch, pol)
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
    launches, stats = zoo_counters(fmt=fmt), kd.STATS.snapshot()
    want = fmt_want(fmt, n_sites, L)
    check(launches == want, f"{what} prefill launches {launches} != {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items() if n}, f"{what} prefill dispatch records {stats}")
    # the attention's calls carried the patches as the causal prefix
    flash_cost = fa_cost.flash_attention_cost(ZOO_B, ZOO_S, ZOO_S, cfg.n_heads, cfg.kv_heads, cfg.hd, backend="cuda",
                                              window=cfg.window, prefix=cfg.n_patches)
    check(kd.STATS.last["flash_attention"].cost == flash_cost, f"{what} prefill: the attention's mask is not "
                                                               f"causal with the prefix {cfg.n_patches}")
    check(tuple(logits.shape) == (ZOO_B, ZOO_S, cfg.vocab_padded()) and bool(torch.isfinite(logits).all()),
          f"{what} prefill logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with torch.no_grad():
        t0 = time.perf_counter()
        model.prefill(tree, batch, pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, wall_prof = profile_prefill(torch, lambda: model.prefill(tree, batch, pol), mm)
    busy = sum(ms for ms, _ in groups.values())
    out["prefill"] = dict(launches=launches, wall_s=wall, tok_s=ZOO_B * ZOO_S / wall, profile=groups)
    print(f"{what} prefill: B {ZOO_B} x S {ZOO_S}"
          + (f" ({cfg.n_patches} patch embeddings first, the attention's causal prefix)" if cfg.n_patches else "")
          + f": {wall * 1e3:.1f} ms wall ({wall_first * 1e3:.1f} ms the first), {ZOO_B * ZOO_S / wall:.0f} tok/s "
          f"({smi}); launches {launches} (per layer {sites} weight sites, 1 attention; + the head); dispatch "
          f"{dict((f'{o}/{b}', n) for (o, b), n in stats.items())}; logits finite, |max| "
          f"{float(logits.abs().max()):.3f}. Profiled prefill: {wall_prof:.1f} ms wall, device busy {busy:.1f} ms: "
          + ", ".join(f"{grp} {ms:.1f} ms ({n} kernels)" for grp, (ms, n) in groups.items()), flush=True)
    if cfg.n_patches:  # decode continues a text prompt: the text-only prefill is its reference
        with torch.no_grad():
            logits = model.prefill(tree, {"tokens": toks}, pol)

    kd.STATS.reset()
    zoo_counters(reset=True, fmt=fmt)
    dec, times = zoo_decode(torch, model, tree, toks, pol, n=decode_n)
    launches, stats = zoo_counters(fmt=fmt), kd.STATS.snapshot()
    with torch.no_grad():
        cache = model.init_cache(1, pol, dev, cache_len=decode_n)
        n_ops = torch_ops(torch, lambda: model.decode_step(tree, toks[:1, :1], cache, pol))
        del cache
    want = fmt_want(fmt, n_sites * decode_n, 0)
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"{what} decode launches {launches} != {want}; dispatch {stats}")
    check(bool(torch.isfinite(dec).all()), f"{what} decode: nonfinite logits")
    served = positions_gap(torch, dec, logits[0, :decode_n], tol)
    fp32 = get_policy("fp32")
    with torch.no_grad():
        ref32 = model.prefill(tree, {"tokens": toks[:1, :decode_n]}, fp32)[0]
    dec32, _ = zoo_decode(torch, model, tree, toks, fp32, n=decode_n)
    plain = positions_gap(torch, dec32, ref32, tol)
    late, _ = zoo_decode(torch, model, tree, toks, fp32, late=1, n=decode_n)
    control = positions_gap(torch, late, ref32, tol)
    step = statistics.median(times[1:])
    out["decode"] = dict(launches=launches, step_ms=step * 1e3, tok_s=1 / step, aten_ops=n_ops, served=served,
                         plain=plain, late_control=control)
    print(f"{what} decode: {decode_n} steps of sequence 0 (B 1): median step {step * 1e3:.2f} ms, {1 / step:.1f} "
          f"tok/s ({smi}), {n_ops} ATen operations a step; launches {launches}. Against the "
          + ("text-only " if cfg.n_patches else "") + f"prefill's logits at positions 0-{decode_n - 1}: with no "
          f"activation quantizer (policy fp32, the same codes) max err {plain['max']:.3e} of the scale "
          f"{plain['scale']:.3f} (bound {tol}; position {decode_n - 1}: {plain['last']:.3e}), argmax equal "
          f"at {plain['argmax']} of {decode_n}; negative control, the cache 1 position late: max err "
          f"{control['max']:.3e}, beyond the bound from position {control['first']}; under floatsd8_table6 "
          f"(reported) max err {served['max']:.3e} of the scale {served['scale']:.3f}, within {tol} up to "
          f"position {served['first'] - 1}, argmax equal at {served['argmax']} of {decode_n}", flush=True)
    check(plain["max"] <= tol, f"{what} decode vs prefill, no activation quantizer: max err "
                               f"{plain['max']:.3e} of the scale {plain['scale']:.3f} (bound {tol})")
    check(control["max"] > tol, f"{what} decode: the bound {tol} does not reject a cache 1 position late "
                                f"(max err {control['max']:.3e} of the scale)")
    del logits, ref32, dec, dec32, late

    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    kd.STATS.reset()
    zoo_counters(reset=True, fmt=fmt)
    eng, reqs, times = zoo_serve(torch, model, store.tree, get_policy("floatsd8_table6"), prompts,
                                 cache_len=DENSE_CACHE_LEN, weight_format=fmt)
    launches, stats = zoo_counters(fmt=fmt), kd.STATS.snapshot()
    m = eng.metrics
    kv = eng.pool.caches["stack"]["b0"]
    kv_bytes = kv.k.numel() * kv.k.element_size() + kv.v.numel() * kv.v.element_size()
    check(eng.chunk == 1 and eng.store.packed_nbytes == resident and kv_bytes == kv_want,
          f"{what} engine: chunk {eng.chunk}, store {eng.store.packed_nbytes}, KV cache {kv_bytes} B")
    check(all(r.status == "done" and len(r.out) == ZOO_MAX_NEW for r in reqs) and m.numeric_errors == 0,
          f"{what} engine: {[r.status for r in reqs]}, {m.numeric_errors} nonfinite")
    want = fmt_want(fmt, n_sites * m.steps, 0)
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"{what} engine launches {launches} != {want}; dispatch {stats}")
    step = statistics.median(times)
    out["engine"] = dict(launches=launches, step_ms=step * 1e3, gen_tok_s=m.report()["gen_tok_per_s"],
                         lane_tok_s=ZOO_LANES / step)
    print(f"{what} engine: {m.format()}; KV cache {kv_bytes} B ({DENSE_CACHE_LEN} positions); median step "
          f"{step * 1e3:.2f} ms over {len(times)} steps at {ZOO_LANES} lanes = {ZOO_LANES / step:.1f} tok/s ({smi}); "
          f"launches {launches}", flush=True)
    out["launches"] = {op: sum(out[p]["launches"][op] for p in ("prefill", "decode", "engine")) for op in want}
    del eng, store, tree, kv
    torch.cuda.empty_cache()
    return out


def dense_x_phase(torch, dev, smi, arch=DENSE_ARCH, what="dense-x", fmt="floatsd8"):
    """Phase 15 (and 24, for ``VLM_ARCH``; 28 in FloatSD4): the dense path
    at full width and DENSE_X_LAYERS layers on the kernels against
    backend="ref" (the plain versions) on the card: the prefill's logits (a
    vlm's over its stub patches) and the engine's greedy tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.serving import synthetic_prompts

    cfg, model, store, _ = zoo_build(torch, dev, DENSE_X_LAYERS, arch=arch, fmt=fmt)
    tree = model.hoist(store.tree)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    batch = {"tokens": toks}
    if cfg.n_patches:
        g = torch.Generator(device=dev).manual_seed(SEED + 11)
        batch["patch_embeds"] = torch.randn((ZOO_B, cfg.n_patches, cfg.d_model), device=dev, generator=g)
    gaps = {}
    for name in ("fp32", "floatsd8_table6"):
        pol = get_policy(name).replace(weight_quant="none")
        kd.STATS.reset()
        with torch.no_grad():
            got = model.prefill(tree, batch, pol)
            stats = kd.STATS.snapshot()
            t0 = time.perf_counter()
            with kd.use_backend("ref"):
                want = model.prefill(tree, batch, pol)
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t0
        check(set(stats) == {(MM_OP[fmt], "cuda"), ("flash_attention", "cuda")},
              f"{what} prefill on the kernels: dispatch {stats}")
        gaps[name] = positions_gap(torch, got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]),
                                   DENSE_X_TOL)
        gaps[name]["bit_equal"] = float((got == want).float().mean())
        del got, want
    g32, g8 = gaps["fp32"], gaps["floatsd8_table6"]
    check(g32["max"] <= DENSE_X_TOL, f"{what} prefill logits, no activation quantizer: max err {g32['max']:.3e} "
                                     f"of the scale {g32['scale']:.3f} (bound {DENSE_X_TOL})")
    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    pol8 = get_policy("floatsd8_table6")
    _, reqs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, cache_len=DENSE_CACHE_LEN, weight_format=fmt)
    _, refs, ref_times = zoo_serve(torch, model, store.tree, pol8, prompts, backend="ref", cache_len=DENSE_CACHE_LEN,
                                   weight_format=fmt)
    decisive, agree = decisive_tokens(reqs, refs, what)
    print(f"{what} ({DENSE_X_LAYERS} of {get_config(arch).n_layers} layers at full width in {FMT_NAME[fmt]}, "
          f"kernels vs backend='ref' on the card): prefill logits [{ZOO_B},{ZOO_S}]"
          + (f" over {cfg.n_patches} patches" if cfg.n_patches else "")
          + f" with no activation quantizer (policy fp32, the same codes) max err {g32['max']:.3e} of the scale "
          f"{g32['scale']:.3f} (bound {DENSE_X_TOL}), {g32['bit_equal']:.2%} bit-equal; under floatsd8_table6 "
          f"(reported) max err {g8['max']:.3e} of the scale {g8['scale']:.3f}, {g8['bit_equal']:.2%} bit-equal, "
          f"every position within {DENSE_X_TOL} up to {g8['first']} of {ZOO_B * ZOO_S} (flattened), argmax equal "
          f"at {g8['argmax']}; plain prefill {t_ref:.2f} s; engine ({ZOO_LANES} lanes, {ZOO_MAX_NEW} new tokens, "
          f"floatsd8_table6): {decisive} of {ZOO_LANES * ZOO_MAX_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) "
          f"and equal, {agree} of {ZOO_LANES} streams equal in full; plain decode step "
          f"{statistics.median(ref_times) * 1e3:.1f} ms ({smi})", flush=True)
    del store, tree
    torch.cuda.empty_cache()
    return gaps


# phase 29: every other family from its FloatSD4 store at small depth, on the
# kernels against backend="ref": (what, arch, config overrides, reduced, bound
# on the fp32 logits against the plain path)
# the RWKV-6 stack's bound is the card tests' model-level one (the reduced
# RWKV-6 on the kernels against its plain versions within 1e-4 of the logit
# scale): from FloatSD4 weights with f32 activations the products are not
# exact, the kernel's fused multiply-adds round apart from the plain
# version's, and 2 layers at full width moved the logits 2.668e-5 of the
# scale (an H100 80GB HBM3 at 700 W), past ZOO_X_TOL, which holds the
# FloatSD8 stack at 3x its measured gap
ZOO4_X_TOL = 1e-4
FAMILY4_X = [("ssm", "rwkv6_3b", dict(n_layers=2), False, ZOO4_X_TOL),
             ("hybrid", "jamba_v01_52b", {}, True, DENSE_X_TOL),
             ("moe", "dbrx_132b", {}, True, DENSE_X_TOL),
             ("vlm", "qwen2_vl_2b", dict(n_layers=2), False, DENSE_X_TOL),
             ("audio", "whisper_large_v3", dict(n_layers=2, enc_layers=2), False, DENSE_X_TOL)]


def family4_x_phase(torch, dev, smi):
    """Phase 29: rwkv6_3b at 2 layers of full width, the reduced Jamba
    period and DBRX, qwen2_vl_2b at 2 layers (over its stub patches) and
    whisper_large_v3 at 2 + 2 layers, each from its FloatSD4 store (the
    stacked leaves packed along the layer axis), on the kernels against
    backend="ref" on the card: the teacher-forced logits under fp32 (every
    weight site on floatsd4_matmul, none on the FloatSD8 matmul or the
    plain path), then greedy tokens over the plain path's margin-decisive
    prefix: the engine's under floatsd8_table6, Whisper's through
    prefill_cross and decode_step under fp32 (as audio-x holds them)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.models import build
    from repro_torch.serving import WeightStore, synthetic_prompts

    out = {"launches": {}}
    fp32 = get_policy("fp32")
    for what, arch, over, reduced, tol in FAMILY4_X:
        cfg = get_config(arch).reduced() if reduced else dataclasses.replace(get_config(arch), **over)
        model = build(cfg)
        store = WeightStore.pack(model.init(torch.Generator(device=dev).manual_seed(SEED)), fmt="floatsd4")
        torch.cuda.empty_cache()
        tree = model.hoist(store.tree)
        audio = cfg.family == "audio"
        s = MOE_S if reduced else ZOO_S
        rng = np.random.default_rng(SEED)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (ZOO_B, AUDIO_DEC if audio else s)), device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 13)
        batch = {"tokens": toks}
        if cfg.n_patches:
            batch["patch_embeds"] = torch.randn((ZOO_B, cfg.n_patches, cfg.d_model), device=dev, generator=g)
        frames = torch.randn((ZOO_B, cfg.enc_seq, cfg.d_model), device=dev, generator=g) if audio else None

        def logits():
            if audio:
                return model.decode_seq(tree, toks, model.encode(tree, frames, fp32), fp32)
            return model.prefill(tree, batch, fp32)

        kd.STATS.reset()
        zoo_counters(reset=True, fmt="floatsd4")
        with torch.no_grad():
            got = logits()
            launches, stats = zoo_counters(fmt="floatsd4"), kd.STATS.snapshot()
            t0 = time.perf_counter()
            with kd.use_backend("ref"):
                want = logits()
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t0
        check(launches["floatsd4_matmul"] > 0 and launches["floatsd_matmul"] == 0
              and not any(b == "ref" for _, b in stats) and ("floatsd4_matmul", "cuda") in stats,
              f"family4-x {what}: launches {launches}, dispatch {stats}")
        if not audio:
            sites = ZOO_SITES * cfg.n_layers + 1 if cfg.family == "ssm" else mm_sites(model)
            check(launches["floatsd4_matmul"] == sites, f"family4-x {what}: {launches['floatsd4_matmul']} "
                                                        f"floatsd4_matmul launches, {sites} sites")
        gap = positions_gap(torch, got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]), tol)
        check(gap["max"] <= tol, f"family4-x {what}: fp32 logits max err {gap['max']:.3e} of the scale "
                                 f"{gap['scale']:.3f} (bound {tol})")
        zoo_counters(reset=True, fmt="floatsd4")
        if audio:
            frames8 = torch.randn((ZOO_LANES, cfg.enc_seq, cfg.d_model), device=dev, generator=g)
            reqs, *_ = whisper_greedy(torch, model, tree, frames8, fp32, AUDIO_NEW)
            refs, *_ = whisper_greedy(torch, model, tree, frames8, fp32, AUDIO_NEW, backend="ref")
            served = f"{ZOO_LANES} lanes x {AUDIO_NEW} greedy tokens under fp32 (prefill_cross, decode_step)"
        else:
            prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
            pol8 = get_policy("floatsd8_table6")
            cl = None if cfg.family == "ssm" else DENSE_CACHE_LEN
            _, reqs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, cache_len=cl, weight_format="floatsd4")
            _, refs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, backend="ref", cache_len=cl,
                                   weight_format="floatsd4")
            served = f"engine, {ZOO_LANES} lanes x {ZOO_MAX_NEW} new tokens under floatsd8_table6"
        served_launches = zoo_counters(fmt="floatsd4")
        decisive, agree = decisive_tokens(reqs, refs, f"family4-x {what}")
        for op, n in launches.items():
            out["launches"][op] = out["launches"].get(op, 0) + n + served_launches[op]
        print(f"family4-x {what}: {arch} {'reduced' if reduced else f'at full width, {over}'} in FloatSD4 "
              f"({store.n_packed} leaves, {store.packed_nbytes} B), kernels vs backend='ref' on the card ({smi}): "
              f"{'encode + decode_seq' if audio else 'prefill'} launches {launches}; logits under fp32 max err "
              f"{gap['max']:.3e} of the scale {gap['scale']:.3f} (bound {tol}), argmax equal at {gap['argmax']} of "
              f"{got.reshape(-1, got.shape[-1]).shape[0]}; plain pass {t_ref:.2f} s; {served}: {decisive} tokens "
              f"margin-decisive and equal, {agree} of {len(refs)} streams equal in full", flush=True)
        del store, tree, got, want
        torch.cuda.empty_cache()
    return out


# phase 30: the dense configs never served at their published widths before,
# at full depth: (arch, FloatSD8 resident bytes, FloatSD4 resident bytes,
# packed leaves, the engine's bf16 KV cache at 8 lanes x 2048 positions). The
# FloatSD8 bytes are the codes + a 4-byte bias a packed leaf + the f32 1-D
# leaves; FloatSD4 ceil(k/2) code bytes + ceil(k/32) exponents a column
DENSE84 = [("stablelm_3b", 2_667_253_820, 1_416_988_160, 15, 5_368_709_120),
           ("phi4_mini_3p8b", 3_836_424_232, 2_038_106_112, 10, 2_147_483_648),
           ("granite_20b", 20_014_781_496, 10_775_034_880, 14, 436_207_616)]
DENSE84_DECODE = 16  # decode steps held against the prefill (64 for h2o_danube3_4b)
STREAMED = ("granite_20b",)  # its 80 GB f32 tree never exists: the two-pass streamed pack


def dense84_phase(torch, dev, smi):
    """Phase 30: stablelm_3b (head size 80, MHA, layernorm, qkv bias) and
    phi4_mini_3p8b (a 200,064-token tied head) in FloatSD8, granite_20b (MQA
    48:1, GELU) in FloatSD8 and FloatSD4, each at its published width and
    depth through dense_phase: the resident bytes, the peak device memory of
    the build, a 2 x 1024 prefill on the kernels, decode steps against it
    and the 8-lane engine. granite_20b's FloatSD8 store is built by the
    two-pass streamed pack (its f32 tree would be 80 GB), its FloatSD4
    store converted from it leaf by leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import WeightStore

    out = {}
    for arch, bytes8, bytes4, leaves, kv in DENSE84:
        torch.cuda.empty_cache()
        if arch not in STREAMED:
            out[arch] = dense_phase(torch, dev, smi, arch, arch, bytes8, leaves, kv, decode_n=DENSE84_DECODE)
            continue
        cfg = get_config(arch)
        model = build(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        store = WeightStore.pack_streamed(model.init, SEED, dev)
        torch.cuda.synchronize()
        built = (cfg, model, store, time.perf_counter() - t0, torch.cuda.max_memory_allocated())
        out[arch] = dense_phase(torch, dev, smi, arch, arch, bytes8, leaves, kv, built=built,
                                decode_n=DENSE84_DECODE)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        store4 = WeightStore.requantized4(store)
        del store, built
        torch.cuda.synchronize()
        built4 = (cfg, model, store4, time.perf_counter() - t0, torch.cuda.max_memory_allocated())
        del store4
        out[f"{arch}/floatsd4"] = dense_phase(torch, dev, smi, arch, f"{arch} floatsd4", bytes4, leaves, kv,
                                              fmt="floatsd4", built=built4, decode_n=DENSE84_DECODE)
        del built4
    torch.cuda.empty_cache()
    return out


# the serving frontend (phase 16): the main path's full-width LM behind the
# multi-tenant router, two replicas sharing one FP8 prefix cache
FRONT_REPLICAS, FRONT_TENANTS = 2, 3
FRONT_REQUESTS, FRONT_PREFIX, FRONT_PREFIX_SEED = 48, 3 * CHUNK, 7
FRONT_CHAOS = "replica_crash@6:key=1;cache_corrupt@2;nonfinite_logits@3"
FRONT_CHAOS_PROMPTS, FRONT_CHAOS_REQUESTS = 6, 32  # prompts of one chunk, each served repeatedly
FRONT_LONG_NEW, FRONT_SHORT_NEW = 48, 2  # the preemption run's long decodes and short arrivals


def front_launches(run):
    """Launch counters and dispatch records zeroed before ``run()`` (which
    returns its result and the engines it stepped) and read after: every
    gate matmul, head and cell of every engine's steps on its kernel, as
    often as the main path's formula gives, summed over the engines; no
    record on the plain path."""
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.lstm_cell.ops import lstm_cell

    kd.STATS.reset()
    floatsd_matmul.launches = lstm_cell.launches = 0
    out, engines = run()
    launches = {"floatsd_matmul": floatsd_matmul.launches, "lstm_cell": lstm_cell.launches}
    stats = kd.STATS.snapshot()
    L = engines[0].model.n_layers
    want = {"floatsd_matmul": 0, "lstm_cell": 0}
    for e in engines:
        positions = CHUNK * e.metrics.prefill_steps + e.metrics.decode_steps
        want["floatsd_matmul"] += 2 * L * positions + e.metrics.steps
        want["lstm_cell"] += L * positions
    check(launches == want, f"frontend launches {launches} != expected {want}")
    check(stats.get(("floatsd_matmul", "cuda"), 0) == want["floatsd_matmul"]
          and stats.get(("lstm_cell", "cuda"), 0) == want["lstm_cell"]
          and sum(n for (_, b), n in stats.items() if b != "cuda") == 0, f"frontend dispatch records {stats}")
    return out, launches


def front_serve(torch, model, params, policy, prompts, cache, backend=None, admission="edf",
                max_new=MAX_NEW):
    """The prompts through a router over FRONT_REPLICAS engines sharing
    ``cache``, tenants round-robin; returns (router, tickets by rid, wall
    seconds, host times of the pumps in which no replica prefilled)."""
    from repro_torch.serving import Router

    router = Router.build(model, params, policy, replicas=FRONT_REPLICAS, prefix_cache=cache,
                          router_kw=dict(admission=admission, max_queue=len(prompts)), lanes=LANES,
                          chunk=CHUNK, backend=backend)
    tickets = [router.submit(p.copy(), max_new=max_new, tenant=f"tenant{i % FRONT_TENANTS}")
               for i, p in enumerate(prompts)]
    decode_pumps: list[float] = []
    t0 = time.perf_counter()
    while True:
        pre = sum(e.metrics.prefill_steps for e in router.engines)
        t = time.perf_counter()
        if not router.pump():  # each replica's step ends in a device->host copy: synchronised
            break
        if sum(e.metrics.prefill_steps for e in router.engines) == pre:
            decode_pumps.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    for e in router.engines:
        e.metrics.stop()
    return router, tickets, wall, decode_pumps


def front_agree(a, b) -> tuple[int, int]:
    """(streams equal in full, tokens equal up to each stream's first difference)."""
    full = sum(x.tokens == y.tokens for x, y in zip(a, b))
    prefix = sum(next((i for i, (p, q) in enumerate(zip(x.tokens, y.tokens)) if p != q), len(x.tokens))
                 for x, y in zip(a, b))
    return full, prefix


def frontend_phase(torch, model, params, policy, smi):
    """Phase 16: the serving frontend at full width (cold and warm prefix
    cache, the warm run on the plain versions, preemption, the chaos plan)."""
    import copy

    import numpy as np

    from repro_torch.faults import FAULTS
    from repro_torch.obs.trace import TRACER
    from repro_torch.serving import PrefixCache, ServeEngine, zipf_prefix_prompts

    t_phase = time.perf_counter()
    V = model.vocab
    zipf = dict(prefix_len=FRONT_PREFIX, prefix_seed=FRONT_PREFIX_SEED)
    measure = zipf_prefix_prompts(FRONT_REQUESTS, V, np.random.default_rng(SEED + 21), **zipf)
    warmup = zipf_prefix_prompts(FRONT_REQUESTS, V, np.random.default_rng(SEED + 22), **zipf)
    launches = {"floatsd_matmul": 0, "lstm_cell": 0}

    def counted(run):
        out, n = front_launches(run)
        for k in launches:
            launches[k] += n[k]
        return out

    def serve_counted(prompts, cache):
        def run():
            out = front_serve(torch, model, params, policy, prompts, cache)
            return out, out[0].engines

        return counted(run)

    # 1. cold, then warm
    cold, cold_t, cold_wall, cold_pumps = serve_counted(measure, None)
    cache = PrefixCache(block=CHUNK)
    serve_counted(warmup, cache)
    cache_ref = copy.deepcopy(cache)  # the same warm state for the plain-version run
    warm, warm_t, warm_wall, warm_pumps = serve_counted(measure, cache)
    rc, rw = cold.report(), warm.report()
    for name, r, t in (("cold", rc, cold_t), ("warm", rw, warm_t)):
        check(r["requests"] == FRONT_REQUESTS and all(x.status == "done" and len(x.tokens) == MAX_NEW for x in t),
              f"frontend {name}: not every request done")
    check(rw["prefill_steps"] <= 0.7 * rc["prefill_steps"],
          f"frontend: warm prefill steps {rw['prefill_steps']} > 0.7 x cold {rc['prefill_steps']}")
    check(rw["cache_hit_rate"] > 0.5 and rw["prefill_tokens_saved"] > 0,
          f"frontend: warm hit rate {rw['cache_hit_rate']:.3f}, saved {rw['prefill_tokens_saved']}")
    full, prefix = front_agree(warm_t, cold_t)
    perf = {}
    for name, r, wall, pumps in (("cold", rc, cold_wall, cold_pumps), ("warm", rw, warm_wall, warm_pumps)):
        perf[name] = dict(tok_s=r["emitted_tokens"] / wall, pump_ms=statistics.median(pumps) * 1e3,
                          ttft_ms={k: (v["ttft_p50_s"] * 1e3, v["ttft_p95_s"] * 1e3) for k, v in r["tenants"].items()})
        tenants = "; ".join(f"{k} TTFT p50 {v['ttft_p50_s'] * 1e3:.3f} ms p95 {v['ttft_p95_s'] * 1e3:.3f} ms"
                            for k, v in r["tenants"].items())
        print(f"frontend {name}: {FRONT_REQUESTS} zipf-prefix requests (prefix {FRONT_PREFIX}, seed "
              f"{FRONT_PREFIX_SEED}), {FRONT_REPLICAS} replicas x {LANES} lanes, chunk {CHUNK}: {r['steps']} steps "
              f"({r['prefill_steps']} prefill / {r['decode_steps']} decode), {r['prompt_tokens']} prompt tokens, "
              f"{r['prefill_tokens_saved']} prefill tokens saved, hit rate {r['cache_hit_rate']:.4f} "
              f"({r['cache_full_hits']} full); {r['emitted_tokens'] / wall:.1f} generated tok/s over {wall:.3f} s; "
              f"median decode pump (one step a replica) {statistics.median(pumps) * 1e3:.3f} ms over "
              f"{len(pumps)}; {tenants} ({smi})", flush=True)
    print(f"frontend: warm/cold prefill steps {rw['prefill_steps']}/{rc['prefill_steps']} = "
          f"{rw['prefill_steps'] / rc['prefill_steps']:.3f} (bound 0.7); warm against cold (reported, not "
          f"asserted: FP8-rounded injected states): {full} of {FRONT_REQUESTS} streams equal, {prefix} of "
          f"{FRONT_REQUESTS * MAX_NEW} tokens before each stream's first difference", flush=True)

    # 2. the warm run on the plain versions, from a copy of the same cache
    plain, plain_t, _, _ = front_serve(torch, model, params, policy, measure, cache_ref, backend="ref")
    refs = [t.req for t in plain_t]
    check(plain.report()["prefill_steps"] == rw["prefill_steps"] and plain.report()["cache_hits"] == rw["cache_hits"],
          "frontend: the plain versions' warm schedule differs")
    cross_check([t.req for t in warm_t], refs, "frontend warm cross-check", n_requests=FRONT_REQUESTS)

    # 3. preemption: one engine, sjf_work, long decodes displaced by short arrivals
    rng = np.random.default_rng(SEED + 23)
    longs = [rng.integers(0, V, 16).astype(np.int32) for _ in range(LANES)]
    shorts = [rng.integers(0, V, 6).astype(np.int32) for _ in range(LANES)]
    runs = {}
    for preempt in (True, False):
        eng = ServeEngine(model, params, policy, lanes=LANES, chunk=CHUNK, admission="sjf_work", preempt=preempt)

        def run(eng=eng):
            lr = eng.submit_all([p.copy() for p in longs], max_new=FRONT_LONG_NEW)
            while not all(r.out for r in lr):
                eng.step_once()
            sr = eng.submit_all([p.copy() for p in shorts], max_new=FRONT_SHORT_NEW)
            eng.run()
            return (lr, sr), [eng]

        runs[preempt] = (counted(run), eng.metrics)
    (lr, sr), m = runs[True]
    (lr0, _), m0 = runs[False]
    check(m.preemptions >= 1 and m.resumes >= 1 and m.preemptions == m.resumes and m0.preemptions == 0,
          f"frontend: preemptions {m.preemptions}, resumes {m.resumes}")
    check(all(r.status == "done" for r in (*lr, *sr)), "frontend: a preempted run's request not done")
    moved = [(a, b) for a, b in zip(lr, lr0) if a.preempt_count]
    eq = sum(a.out == b.out for a, b in moved)
    first = [next((i for i, (p, q) in enumerate(zip(a.out, b.out)) if p != q), len(a.out)) for a, b in moved]
    ttft = lambda rs: statistics.median(r.t_first - r.t_submit for r in rs) * 1e3  # noqa: E731
    print(f"frontend preempt: sjf_work, {LANES} lanes, {LANES} decodes of {FRONT_LONG_NEW} then {LANES} arrivals of "
          f"{FRONT_SHORT_NEW}: {m.preemptions} preemptions, {m.resumes} resumes, {m.steps} steps (without: "
          f"{m0.steps}); short arrivals' median TTFT {ttft(sr):.3f} ms (without preemption "
          f"{ttft(runs[False][0][1]):.3f} ms); preempted streams against the run without preemption (reported): "
          f"{eq} of {len(moved)} equal, first differences at {first}", flush=True)

    # 4. the chaos plan: a replica crash, a corrupted cache entry, a poisoned
    # lane. Prompts of one chunk, each served repeatedly (replica 0 takes the
    # even requests, replica 1 the odd ones); the cache starts warm with the
    # odd prompts, so replica 1's requests are full hits in the fault-free
    # run and again after their resubmission to replica 0 (the same entry
    # bytes), while the even prompts' first inserts give the corrupted entry
    # that a later even request reads
    base = [rng.integers(0, V, CHUNK).astype(np.int32) for _ in range(FRONT_CHAOS_PROMPTS)]
    chaos = [base[i % FRONT_CHAOS_PROMPTS] for i in range(FRONT_CHAOS_REQUESTS)]

    def warm_cache():
        c = PrefixCache(block=CHUNK)
        eng = ServeEngine(model, params, policy, lanes=LANES, chunk=CHUNK, prefix_cache=c)
        eng.submit_all([p.copy() for p in base[1::2]], max_new=2)
        eng.run()
        return c

    clean = front_serve(torch, model, params, policy, chaos, warm_cache())
    cache = warm_cache()
    TRACER.clear()
    TRACER.enable()
    FAULTS.arm(FRONT_CHAOS)
    try:
        router, tickets, _, _ = serve_counted(chaos, cache)
        faults = FAULTS.stats()
    finally:
        FAULTS.disarm()
        TRACER.disable()
    resubmitted = sorted({e["args"]["rid"] for e in TRACER.events() if e["name"] == "router.resubmit"})
    ejected = [e["args"] for e in TRACER.events() if e["name"] == "router.eject"]
    TRACER.clear()
    st = router.stats()
    cst = router.prefix_cache.stats()
    statuses = [t.status for t in tickets]
    check(faults["injected"] == {"replica_crash": 1, "cache_corrupt": 1, "nonfinite_logits": 1},
          f"frontend chaos: injected {faults['injected']}")
    check(st["ejections"] == 1 and [h["healthy"] for h in st["replica_health"]] == [True, False]
          and ejected == [{"replica": 1, "reason": "crash"}] and st["resubmits"] == len(resubmitted) > 0,
          f"frontend chaos: replica health {st}, ejections traced {ejected}")
    check(statuses.count("numeric_error") == 1 and statuses.count("done") == FRONT_CHAOS_REQUESTS - 1,
          f"frontend chaos: statuses {statuses}")
    check(cst["corruptions"] == 1, f"frontend chaos: corruptions {cst['corruptions']}")
    differ = [r for r in resubmitted if tickets[r].tokens != clean[1][r].tokens]
    check(not differ, f"frontend chaos: resubmitted requests {differ} differ from the fault-free run")
    others = [t for t in tickets if t.status == "done" and t.rid not in resubmitted]
    same = sum(t.tokens == clean[1][t.rid].tokens for t in others)
    check(not FAULTS.enabled, "frontend chaos: FAULTS still armed")
    print(f"frontend chaos: plan {FRONT_CHAOS!r} on {FRONT_CHAOS_REQUESTS} requests over {FRONT_CHAOS_PROMPTS} "
          f"prompts of one chunk: injected {faults['injected']}, arrivals {faults['arrivals']}; replica 1 ejected "
          f"(crash), {len(resubmitted)} requests resubmitted and finished on replica 0, each equal to the "
          f"fault-free run ({router.engines[1].metrics.retired} retired on replica 1 before the crash); "
          f"1 numeric_error; {cst['corruptions']} corruption caught as a miss; the other done requests: {same} of "
          f"{len(others)} equal to the fault-free run (a corruption miss prefills from the exact state where the "
          f"fault-free run injected the FP8 one); FAULTS disarmed", flush=True)
    print(f"frontend: launches {launches} (every record cuda); phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(launches=launches, perf=perf)


# the HTTP/SSE service (phase 17): the main path's full-width LM behind
# HttpServer on 127.0.0.1, the frontend phase's router shape (2 replicas x 8
# lanes, chunk 8, 3 tenants)
HTTP_REQUESTS, HTTP_PROMPT_LEN = 32, (16, 48)  # random prompts of 16-48 tokens, no prefix cache
HTTP_TIMEOUT = 120  # seconds: a hung socket fails the phase, not the whole call
HTTP_DRAIN_S = 30  # /admin/drain must end serve_forever within this, clients connected
LEDGER_CALLS = 10_000  # decode-shape bookkeeping calls timed on the host
STEP_CALLS = 7  # dispatch calls a decode step: 2 layers x (2 gate matmuls + a cell) + the head
HTTP_CLI = ["--full", "--http", "--port", "0", "--replicas", str(FRONT_REPLICAS)]  # phase 17 (g)


def parse_prometheus(text: str) -> dict:
    """{name{labels}: value} of a Prometheus text exposition; fails on a
    line that is neither a comment (HELP/TYPE) nor a sample."""
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [-+]?[0-9.e+-]+(e[+-]?\d+)?$")
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            check(line.startswith(("# HELP ", "# TYPE ")), f"http: /metrics comment line {line!r}")
            continue
        check(bool(sample.match(line)), f"http: /metrics line {line!r} is not Prometheus text")
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def timed_pumps(router) -> list:
    """Wrap ``router.pump`` (which the server's worker thread calls) to
    record the host time of each pump in which no replica prefilled."""
    pumps, pump = [], router.pump

    def timed():
        pre = sum(e.metrics.prefill_steps for e in router.engines)
        t = time.perf_counter()
        more = pump()
        if sum(e.metrics.prefill_steps for e in router.engines) == pre:
            pumps.append(time.perf_counter() - t)
        return more

    router.pump = timed
    return pumps


def validate_trace(trace: dict) -> list:
    """scripts/check_trace.py's checks of a Chrome trace export (a stdlib
    script beside the JAX package, loaded by path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("check_trace", ROOT / "scripts" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_trace(trace)


def http_phase(torch, model, params, policy, smi, front) -> dict:
    """Phase 17: the HTTP/SSE service at full width on the kernels."""
    import asyncio
    import os

    import numpy as np

    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul import cost as fm_cost
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.lstm_cell import cost as lc_cost
    from repro_torch.kernels.lstm_cell.ops import lstm_cell
    from repro_torch.obs.trace import TRACER
    from repro_torch.serving import PrefixCache, Router, zipf_prefix_prompts
    from repro_torch.serving.http import Client, HttpError, HttpServer

    t_phase = time.perf_counter()
    V = model.vocab
    rng = np.random.default_rng(SEED + 31)
    prompts = [rng.integers(0, V, int(rng.integers(HTTP_PROMPT_LEN[0], HTTP_PROMPT_LEN[1] + 1))).astype(np.int32)
               for _ in range(HTTP_REQUESTS)]
    tenant = lambda i: f"tenant{i % FRONT_TENANTS}"  # noqa: E731

    def build(cache=None, backend=None):
        return Router.build(model, params, policy, replicas=FRONT_REPLICAS, prefix_cache=cache,
                            router_kw=dict(max_queue=4 * FRONT_REQUESTS), lanes=LANES, chunk=CHUNK, backend=backend)

    def want_launches(engines) -> dict:
        L, want = engines[0].model.n_layers, {"floatsd_matmul": 0, "lstm_cell": 0}
        for e in engines:
            positions = CHUNK * e.metrics.prefill_steps + e.metrics.decode_steps
            want["floatsd_matmul"] += 2 * L * positions + e.metrics.steps
            want["lstm_cell"] += L * positions
        return want

    async def one(host, port, i, p, stream, max_new=MAX_NEW):
        async with Client(host, port, tenant=tenant(i), timeout_s=HTTP_TIMEOUT) as c:
            if not stream:
                return (await c.generate(p, max_new=max_new))["tokens"]
            return [d["token"] async for ev, d in c.stream(p, max_new=max_new) if ev == "message"]

    # (a) no prefix cache: concurrent clients, half /v1/generate, half /v1/stream;
    # (b) a DELETE mid-stream; (d) /metrics; (e) /admin/trace; (f) /admin/drain
    router = build()
    pumps = timed_pumps(router)
    kd.STATS.reset()
    floatsd_matmul.launches = lstm_cell.launches = 0

    async def run_a():
        server = await HttpServer(router, port=0).start()
        task = asyncio.create_task(server.serve_forever())
        admin = Client(server.host, server.port, timeout_s=HTTP_TIMEOUT)
        try:
            TRACER.clear()
            t0 = time.perf_counter()
            toks = await asyncio.gather(*(one(server.host, server.port, i, p, i % 2 == 1)
                                          for i, p in enumerate(prompts)))
            wall = time.perf_counter() - t0
            streamer = Client(server.host, server.port, timeout_s=HTTP_TIMEOUT)
            gen = streamer.stream(prompts[0], max_new=512)
            rid = (await gen.__anext__())[1]["rid"]
            check((await gen.__anext__())[0] == "message", "http: the stream to cancel sent no token")
            check(await admin.cancel(rid) == {"rid": rid, "cancelled": True}, "http: DELETE refused")
            done = [ev async for ev in gen][-1]
            await streamer.close()
            health = await admin.healthz()
            text = await admin.metrics()
            snapshot = kd.STATS.snapshot()
            launches = {"floatsd_matmul": floatsd_matmul.launches, "lstm_cell": lstm_cell.launches}
            trace = await admin.trace()
            t_drain = time.perf_counter()
            drained = await admin.drain()  # the admin connection stays open
            await asyncio.wait_for(task, HTTP_DRAIN_S)
            drain_s = time.perf_counter() - t_drain
            return toks, wall, done, health, text, snapshot, launches, trace, drained, drain_s
        finally:
            await admin.close()
            if not task.done():
                server.shutdown()
                await asyncio.wait_for(task, HTTP_DRAIN_S)

    toks, wall, done, health, text, snapshot, launches, trace, drained, drain_s = asyncio.run(
        asyncio.wait_for(run_a(), 4 * HTTP_TIMEOUT))
    rep = router.report()
    TRACER.disable()
    TRACER.clear()
    check(all(len(t) == MAX_NEW for t in toks), "http: a request did not get its tokens")
    check(done[0] == "done" and done[1].get("status") == "cancelled" and done[1].get("reason") == "client_cancel",
          f"http: the cancelled stream ended with {done}")
    check(health["free_lanes"] == health["lanes"] == FRONT_REPLICAS * LANES, f"http: lanes after DELETE {health}")
    # the same prompts in-process on the plain versions (route A is bit for
    # bit and a row's sum does not depend on the rows beside it, so arrival
    # order does not matter)
    plain = build(backend="ref")
    tickets = [plain.submit(p.copy(), max_new=MAX_NEW, tenant=tenant(i)) for i, p in enumerate(prompts)]
    plain.drain()
    differ = [i for i, (a, t) in enumerate(zip(toks, tickets)) if a != t.tokens]
    check(not differ, f"http: requests {differ} differ from the in-process run on backend=\"ref\"")
    # (d) the scrape against the counters, the launches and the ref cost model
    m = parse_prometheus(text)
    want = want_launches(router.engines)
    check(launches == want, f"http: launches {launches} != the formula's {want}")
    check(all(be == "cuda" for _, be in snapshot), f"http: dispatch records {snapshot}")
    for (op, be), n in snapshot.items():
        lbl = f'{{op="{op}",backend="{be}"}}'
        check(m[f"repro_dispatch_decisions_total{lbl}"] == n, f"http: /metrics dispatch {op} against STATS {n}")
    for op in ("floatsd_matmul", "lstm_cell"):
        lbl = f'{{op="{op}",backend="cuda"}}'
        check(m[f"repro_cost_calls_total{lbl}"] == launches[op] == snapshot[(op, "cuda")],
              f"http: repro_cost_calls_total {op} {m[f'repro_cost_calls_total{lbl}']} != launches {launches[op]}")
    shapes = {id(d): key for key, d in kd._DECISIONS.items()}
    ref_bytes = {"floatsd_matmul": 0, "lstm_cell": 0}
    for d, n, _ in kd.STATS._entries():
        if d.backend != "cuda":  # the plain run above
            continue
        op, _, _, sh = shapes[id(d)]
        ref = (fm_cost.matmul_fwd_cost(*sh[:3], backend="ref") if op == "floatsd_matmul" else
               lc_cost.lstm_cell_cost(*sh[:2], backend="ref", z_bytes=sh[2], c_in_bytes=sh[3], h_out_bytes=sh[4],
                                      c_out_bytes=sh[5], quantized=sh[6]))
        ref_bytes[op] += n * ref.hbm_bytes
    cuda_bytes = {op: m[f'repro_cost_hbm_read_bytes_total{{op="{op}",backend="cuda"}}']
                  + m[f'repro_cost_hbm_write_bytes_total{{op="{op}",backend="cuda"}}'] for op in ref_bytes}
    check(all(cuda_bytes[op] >= ref_bytes[op] > 0 for op in ref_bytes),
          f"http: the launches' predicted bytes {cuda_bytes} below the ref model's {ref_bytes}")
    # (e) the trace
    problems = validate_trace(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    check(not problems, f"http: /admin/trace: {problems[:5]}")
    check({"cost.floatsd_matmul", "cost.lstm_cell", "http.request", "router.pump"} <= names,
          f"http: /admin/trace lacks tracks: {sorted(names)[:20]}")
    check(drained["status"] == "draining" and drain_s < HTTP_DRAIN_S, f"http: drain {drained} in {drain_s:.1f} s")
    tenants = "; ".join(f"{k} TTFT p50 {v['ttft_p50_s'] * 1e3:.3f} ms p95 {v['ttft_p95_s'] * 1e3:.3f} ms"
                        for k, v in rep["tenants"].items() if "ttft_p50_s" in v)  # not the cancelled stream's
    pump_ms = statistics.median(pumps) * 1e3
    tok_s = HTTP_REQUESTS * MAX_NEW / wall
    cold = front["perf"]["cold"]
    print(f"http (a): {HTTP_REQUESTS} requests (prompts of {HTTP_PROMPT_LEN[0]}-{HTTP_PROMPT_LEN[1]} tokens, "
          f"{MAX_NEW} new; half /v1/generate, half /v1/stream; {FRONT_TENANTS} tenants, one connection each), "
          f"{FRONT_REPLICAS} replicas x {LANES} lanes, chunk {CHUNK}, no prefix cache: every request's tokens equal "
          f"the in-process run on backend=\"ref\"; {tok_s:.1f} generated tok/s over {wall:.3f} s; median decode pump "
          f"{pump_ms:.3f} ms over {len(pumps)}; {tenants} | the in-process frontend phase (cold, 48 zipf-prefix "
          f"requests): {cold['tok_s']:.1f} tok/s, pump {cold['pump_ms']:.3f} ms ({smi})", flush=True)
    print(f"http (b, d-f): DELETE mid-stream -> done(status=cancelled) and {health['free_lanes']} free lanes; "
          f"/metrics parses ({len(m)} samples), dispatch {dict((f'{o}/{b}', n) for (o, b), n in snapshot.items())} "
          f"= STATS, repro_cost_calls_total = launches {launches}, the launches' predicted bytes {cuda_bytes} >= the "
          f"ref model's {ref_bytes}; /admin/trace valid ({len(trace['traceEvents'])} events, cost.floatsd_matmul and "
          f"cost.lstm_cell tracks); /admin/drain ended serve_forever in {drain_s:.2f} s with a client connected",
          flush=True)

    # (c) the frontend phase's 48 zipf-prefix requests over HTTP with the FP8 prefix cache
    cache = PrefixCache(block=CHUNK)
    router_c = build(cache)
    zipf = zipf_prefix_prompts(FRONT_REQUESTS, V, np.random.default_rng(SEED + 21), prefix_len=FRONT_PREFIX,
                               prefix_seed=FRONT_PREFIX_SEED)
    kd.STATS.reset()
    floatsd_matmul.launches = lstm_cell.launches = 0

    async def run_c():
        server = await HttpServer(router_c, port=0, trace=False).start()
        task = asyncio.create_task(server.serve_forever())
        try:
            out = await asyncio.gather(*(one(server.host, server.port, i, p, i % 2 == 1) for i, p in enumerate(zipf)))
            async with Client(server.host, server.port, timeout_s=HTTP_TIMEOUT) as c:
                text = await c.metrics()
                await c.drain()
            await asyncio.wait_for(task, HTTP_DRAIN_S)
            return out, text
        finally:
            if not task.done():
                server.shutdown()
                await asyncio.wait_for(task, HTTP_DRAIN_S)

    out_c, text_c = asyncio.run(asyncio.wait_for(run_c(), 4 * HTTP_TIMEOUT))
    mc, cst = parse_prometheus(text_c), cache.stats()
    launches_c = {"floatsd_matmul": floatsd_matmul.launches, "lstm_cell": lstm_cell.launches}
    check(launches_c == want_launches(router_c.engines), f"http (c): launches {launches_c}")
    check(all(len(t) == MAX_NEW for t in out_c), "http (c): a request did not get its tokens")
    pairs = {"repro_cache_hits_total": cst["hits"], "repro_cache_lookups_total": cst["hits"] + cst["misses"],
             "repro_cache_entries": cst["entries"], "repro_cache_bytes": cst["nbytes"],
             "repro_cache_evictions_total": cst["evictions"], "repro_cache_corruptions_total": cst["corruptions"]}
    check(all(mc[k] == v for k, v in pairs.items()), f"http (c): /metrics {[(k, mc[k], v) for k, v in pairs.items()]}")
    check(cst["hits"] > 0, f"http (c): no prefix-cache hit: {cst}")
    print(f"http (c): {FRONT_REQUESTS} zipf-prefix requests over HTTP with the FP8 prefix cache: hit rate "
          f"{cst['hits'] / (cst['hits'] + cst['misses']):.4f}, {router_c.report()['prefill_tokens_saved']} prefill "
          f"tokens saved; /metrics' cache counters equal the cache's own stats {pairs}; launches {launches_c}",
          flush=True)

    # (g) the CLI as a subprocess
    cli = [sys.executable, "-m", "repro_torch.launch.serve", *HTTP_CLI]

    async def run_g():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = await asyncio.create_subprocess_exec(*cli, cwd=str(ROOT), env=env, stdout=asyncio.subprocess.PIPE,
                                                    stderr=asyncio.subprocess.PIPE)
        try:
            line = (await asyncio.wait_for(proc.stdout.readline(), 4 * HTTP_TIMEOUT)).decode()
            check(line.startswith("http: listening on http://"), f"http (g): the CLI printed {line!r}")
            host, port = line.split("http://", 1)[1].split()[0].rsplit(":", 1)
            async with Client(host, int(port), timeout_s=HTTP_TIMEOUT) as c:
                health = await c.healthz()
                gen = await c.generate(prompts[1], max_new=MAX_NEW)
                streamed = [d["token"] async for ev, d in c.stream(prompts[2], max_new=MAX_NEW) if ev == "message"]
                text = await c.metrics()
                drained = await c.drain()
            out, err = await asyncio.wait_for(proc.communicate(), HTTP_TIMEOUT)
            return health, gen, streamed, text, drained, proc.returncode, out.decode(), err.decode()
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    health, gen, streamed, text_g, drained, rc, out_g, err_g = asyncio.run(run_g())
    mg = parse_prometheus(text_g)
    dispatch_g = {k: v for k, v in mg.items() if k.startswith("repro_dispatch_decisions_total")}
    check(rc == 0, f"http (g): the CLI exited {rc}: {err_g[-2000:]}")
    check(health["replicas"] == FRONT_REPLICAS and len(gen["tokens"]) == len(streamed) == MAX_NEW,
          "http (g): healthz, generate or stream")
    check(dispatch_g and all('backend="cuda"' in k for k in dispatch_g), f"http (g): dispatch {dispatch_g}")
    check(f"http: served 2 requests, {2 * MAX_NEW} tokens over {FRONT_REPLICAS} replica(s)" in out_g,
          f"http (g): report line missing: {out_g[-500:]}")
    print(f"http (g): {' '.join(cli[1:])}: healthz, generate, stream, metrics ({dispatch_g}), drain "
          f"({drained['status']}); exit 0; {out_g.strip().splitlines()[-1]}", flush=True)

    # the ledger's host cost against the pump: one emit_counters, as the pump
    # calls it while tracing, with the (a) run's rows
    from repro_torch.obs.trace import Tracer

    tr = Tracer()
    tr.enable()
    t0 = time.perf_counter()
    for _ in range(1000):
        kd.LEDGER.emit_counters(tr)
    emit_ms = (time.perf_counter() - t0) / 1000 * 1e3
    print(f"http: emit_counters {emit_ms:.4f} ms a call (over 1000) = {emit_ms / pump_ms:.3%} of the HTTP decode pump "
          f"{pump_ms:.3f} ms", flush=True)
    print(f"http: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches_all = {k: launches[k] + launches_c[k] for k in launches}
    return dict(launches=launches_all, tok_s=tok_s, pump_ms=pump_ms, emit_ms=emit_ms, drain_s=drain_s)


# the hybrid family (phases 18-19): jamba_v01_52b at its published width, one
# period of its 32 layers, and the moe family's reduced configs (phase 20)
HYBRID_ARCH = "jamba_v01_52b"
# one period of Jamba's 32 layers (7 Mamba + 1 attention sub-layer, 4 FFN + 4
# MoE MLPs): the 32 layers' f32 init is 205 GB and a period's 52.1 GB, so the
# store is drawn and packed one block at a time; the peak is the codes plus one
# MoE block's f32 (11.3 GB)
HYBRID_LAYERS = 8
HYBRID_CODE_BYTES = 13_026_795_520  # the FloatSD8 codes of the period, from the shapes
HYBRID_BYTES = 13_026_812_352  # tree_nbytes: + 4 B of bias a packed leaf (112) + the f32 final norm
HYBRID_LEAVES = 112
HYBRID_MM = 237  # floatsd_matmul a prefill or decode step: 7 x 4 Mamba + 4 attention + 4 x 3 FFN + 4 x 3 x 16 experts + head
HYBRID_KV_BYTES = 67_108_864  # the engine's bf16 KV cache: 1 attention layer x 2 x 8 lanes x 2048 x 8 x 128 x 2 B
# one Mamba layer and one MoE layer at full width, kernels against the plain
# versions with no activation quantizer: each product's route B (M > 64) is
# within 1e-5 of |x| @ |W| (floatsd_matmul's stated bound); four products in
# a chain and the scan's exp and softplus carry that forward, so a layer's
# output is held to ten times it, 1e-4 of its scale
HYBRID_X_TOL = 1e-4
HYBRID_X_NEW = 8  # the engine cross-check's new tokens (the plain decode step takes seconds at this width)
MOE_ARCHS = ("dbrx_132b", "kimi_k2_1t_a32b")
MOE_S = 64  # the reduced models' prefill: 2 x 64 tokens, 8 tokens a dispatch group


def hybrid_cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)


def mm_sites(model) -> int:
    """floatsd_matmul launches of one prefill or decode step of a zoo
    CausalLM: 4 a Mamba or attention mixer, 3 an FFN, 3 an expert, + the
    head."""
    def block(b):
        return 4 + 3 * (b.moe_mod.n_experts if b.mlp == "moe" else 1)

    return (sum(block(b) for b in model._period()) * model._stack().n_groups
            + sum(block(b) for b in model._head_blocks()) + 1)


def attn_layers(model) -> int:
    return (sum(b.mixer == "attn" for b in model._period()) * model._stack().n_groups
            + len(model._head_blocks()))


def hybrid_phase(torch, dev, smi, cfg=None):
    """Phase 18: jamba_v01_52b at full width, one period, built block by
    block, prefilled, decoded and served. Returns (results, model, store)
    for phase 19. ``cfg`` replaces the period's config (a reduced one
    rehearses the phase on the CPU); the full-width byte and launch counts
    are asserted at d_model 4096 only."""
    import numpy as np

    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.models import build
    from repro_torch.serving import WeightStore, synthetic_prompts

    cfg = cfg or hybrid_cfg()
    full = cfg.d_model == 4096
    model = build(cfg)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = WeightStore.pack_streamed(model.init, SEED, dev)
    torch.cuda.synchronize()
    t_build, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    codes = sum(x.codes.numel() for x in tree_leaves(store.tree, is_leaf=kd.is_packed) if kd.is_packed(x))
    print(f"hybrid: {cfg.name} at d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} over {cfg.kv_heads} KV "
          f"heads, d_ff {cfg.d_ff}, {cfg.n_experts} experts top-{cfg.top_k}, vocab {cfg.vocab}, Mamba d_state "
          f"{cfg.mamba_state}, {cfg.n_layers} of its {get_config(cfg.name).n_layers} layers (one period: "
          + ", ".join(f"{b.mixer}+{b.mlp}" for b in model._period()) + f") from seed {SEED}, drawn and packed "
          f"block by block: {store.dense_nbytes} B f32 -> {store.packed_nbytes} B packed FloatSD8 ({codes} B of "
          f"codes, {store.n_packed} leaves) in {t_build:.1f} s, peak {peak} B on the card ({held} B held before)",
          flush=True)
    if full:
        check(store.packed_nbytes == HYBRID_BYTES and codes == HYBRID_CODE_BYTES and store.n_packed == HYBRID_LEAVES,
              f"hybrid resident bytes {store.packed_nbytes} != {HYBRID_BYTES} (codes {codes}, {store.n_packed} "
              "leaves)")
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")
    tree = model.hoist(store.tree)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    n_mm, n_attn = mm_sites(model), attn_layers(model)
    if full:
        check(n_mm == HYBRID_MM, f"hybrid: {n_mm} weight sites, not {HYBRID_MM}")
    out = {}

    kd.STATS.reset()
    zoo_counters(reset=True)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = model.prefill(tree, {"tokens": toks}, pol)
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    want = {"floatsd_matmul": n_mm, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": n_attn}
    check(launches == want, f"hybrid prefill launches {launches} != {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items() if n}, f"hybrid prefill dispatch records {stats}")
    check(tuple(logits.shape) == (ZOO_B, ZOO_S, cfg.vocab_padded()) and bool(torch.isfinite(logits).all()),
          f"hybrid prefill logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with torch.no_grad():
        t0 = time.perf_counter()
        model.prefill(tree, {"tokens": toks}, pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, wall_prof = profile_prefill(torch, lambda: model.prefill(tree, {"tokens": toks}, pol))
    busy = sum(ms for ms, _ in groups.values())
    # the selective scan alone (plain torch ops), at one Mamba layer's prefill
    # inputs, CUDA events: its share of the "other torch ops"
    m = next(b.mamba_mod for b in model._period() if b.mixer == "mamba")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn((ZOO_B, ZOO_S, m.d_inner), device=dev, generator=g)
    dt = torch.rand((ZOO_B, ZOO_S, m.d_inner), device=dev, generator=g) * 0.1
    bm, cm = (torch.randn((ZOO_B, ZOO_S, m.d_state), device=dev, generator=g) for _ in range(2))
    a = -torch.arange(1, m.d_state + 1, device=dev, dtype=torch.float32).repeat(m.d_inner, 1)
    h0 = torch.zeros((ZOO_B, m.d_inner, m.d_state), device=dev)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    scan_ms = timed_ms(torch, lambda: m._scan(h0, x, dt, bm, cm, a), 3, flush)
    n_mamba = sum(b.mixer == "mamba" for b in model._period()) * model._stack().n_groups
    del x, dt, bm, cm, h0, flush
    out["prefill"] = dict(launches=launches, wall_s=wall, tok_s=ZOO_B * ZOO_S / wall, profile=groups,
                          scan_ms=scan_ms, n_mamba=n_mamba)
    print(f"hybrid prefill: B {ZOO_B} x S {ZOO_S}: {wall * 1e3:.1f} ms wall ({wall_first * 1e3:.1f} ms the first), "
          f"{ZOO_B * ZOO_S / wall:.0f} tok/s ({smi}); launches {launches}; dispatch "
          f"{dict((f'{o}/{b}', n) for (o, b), n in stats.items())}; logits finite, |max| "
          f"{float(logits.abs().max()):.3f}. Profiled prefill: {wall_prof:.1f} ms wall, device busy {busy:.1f} ms: "
          + ", ".join(f"{grp} {ms:.1f} ms ({n} kernels)" for grp, (ms, n) in groups.items())
          + f"; the selective scan alone (one layer's, plain torch ops, {ZOO_S} steps) {scan_ms:.2f} ms, x "
          f"{n_mamba} layers = {scan_ms * n_mamba:.1f} ms", flush=True)

    kd.STATS.reset()
    zoo_counters(reset=True)
    dec, times = zoo_decode(torch, model, tree, toks, pol)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    with torch.no_grad():  # one more step, after the counters are read: its host work
        cache = model.init_cache(1, pol, dev, cache_len=ZOO_DECODE)
        n_ops = torch_ops(torch, lambda: model.decode_step(tree, toks[:1, :1], cache, pol))
        del cache
    want = {"floatsd_matmul": n_mm * ZOO_DECODE, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": 0}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"hybrid decode launches {launches} != {want}; dispatch {stats}")
    check(bool(torch.isfinite(dec).all()), "hybrid decode: nonfinite logits")
    served = positions_gap(torch, dec, logits[0, :ZOO_DECODE], DENSE_TOL)
    fp32 = get_policy("fp32")
    with torch.no_grad():
        ref32 = model.prefill(tree, {"tokens": toks[:1, :ZOO_DECODE]}, fp32)[0]
    dec32, _ = zoo_decode(torch, model, tree, toks, fp32)
    plain = positions_gap(torch, dec32, ref32, DENSE_TOL)
    check(plain["max"] <= DENSE_TOL, f"hybrid decode vs prefill, no activation quantizer: max err {plain['max']:.3e} "
                                     f"of the scale {plain['scale']:.3f} (bound {DENSE_TOL})")
    step = statistics.median(times[1:])
    out["decode"] = dict(launches=launches, step_ms=step * 1e3, aten_ops=n_ops, served=served, plain=plain)
    print(f"hybrid decode: {ZOO_DECODE} steps of sequence 0 (B 1): median step {step * 1e3:.2f} ms, "
          f"{1 / step:.1f} tok/s ({smi}), {n_ops} ATen operations a step; launches {launches}. Against the prefill's logits at positions "
          f"0-{ZOO_DECODE - 1}: with no activation quantizer (policy fp32, the same codes) max err {plain['max']:.3e} "
          f"of the scale {plain['scale']:.3f} (bound {DENSE_TOL}), argmax equal at {plain['argmax']} of {ZOO_DECODE}; "
          f"under floatsd8_table6 (reported) max err {served['max']:.3e} of the scale {served['scale']:.3f}, within "
          f"{DENSE_TOL} up to position {served['first'] - 1}, argmax equal at {served['argmax']}", flush=True)
    del logits, ref32, dec, dec32

    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    kd.STATS.reset()
    zoo_counters(reset=True)
    eng, reqs, times = zoo_serve(torch, model, store.tree, get_policy("floatsd8_table6"), prompts,
                                 cache_len=DENSE_CACHE_LEN)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    me = eng.metrics
    kv = [c for c in eng.pool.caches["stack"].values() if hasattr(c, "pos")]
    kv_bytes = sum(c.k.numel() * c.k.element_size() + c.v.numel() * c.v.element_size() for c in kv)
    state_bytes = sum(t.numel() * t.element_size() for c in eng.pool.caches["stack"].values()
                      if not hasattr(c, "pos") for t in c)
    check(all(r.status == "done" and len(r.out) == ZOO_MAX_NEW for r in reqs) and me.numeric_errors == 0,
          f"hybrid engine: {[r.status for r in reqs]}, {me.numeric_errors} nonfinite")
    want = {"floatsd_matmul": n_mm * me.steps, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": 0}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"hybrid engine launches {launches} != {want}; dispatch {stats}")
    if full:
        check(kv_bytes == HYBRID_KV_BYTES, f"hybrid engine KV cache {kv_bytes} B != {HYBRID_KV_BYTES}")
    step = statistics.median(times)
    out["engine"] = dict(launches=launches, step_ms=step * 1e3, gen_tok_s=me.report()["gen_tok_per_s"],
                         lane_tok_s=ZOO_LANES / step)
    print(f"hybrid engine: {me.format()}; KV cache {kv_bytes} B ({DENSE_CACHE_LEN} positions), Mamba states "
          f"{state_bytes} B; median step {step * 1e3:.2f} ms over {len(times)} steps at {ZOO_LANES} lanes = "
          f"{ZOO_LANES / step:.1f} tok/s ({smi}); launches {launches}", flush=True)
    out["launches"] = {op: sum(out[p]["launches"][op] for p in ("prefill", "decode", "engine")) for op in want}
    del eng, tree
    torch.cuda.empty_cache()
    return out, model, store


def hybrid_x_phase(torch, dev, smi, model, store):
    """Phase 19: phase 18's model on the kernels against backend="ref" on
    the card: one Mamba and one MoE layer at full width on one input, then
    the period's prefill and the engine's greedy tokens."""
    import numpy as np

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.nn.moe import record_routes
    from repro_torch.nn.transformer import _layer
    from repro_torch.serving import synthetic_prompts

    cfg = model.cfg
    tree = model.hoist(store.tree)
    lp = _layer(tree["stack"], 0)
    period = model._period()
    fp32 = get_policy("fp32")
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    h = torch.randn((ZOO_B, ZOO_S, cfg.d_model), device=dev, generator=g)
    layers = {}
    with torch.no_grad():
        i = next(i for i, b in enumerate(period) if b.mixer == "mamba")
        got = period[i].mamba_mod.apply(lp[f"b{i}"]["mixer"], h, fp32)
        with kd.use_backend("ref"):
            want = period[i].mamba_mod.apply(lp[f"b{i}"]["mixer"], h, fp32)
        layers["mamba"] = positions_gap(torch, got.reshape(-1, cfg.d_model), want.reshape(-1, cfg.d_model),
                                        HYBRID_X_TOL)
        i = next(i for i, b in enumerate(period) if b.mlp == "moe")
        with record_routes() as r_got:
            got, _ = period[i].moe_mod.apply(lp[f"b{i}"]["mlp"], h, fp32)
        with record_routes() as r_want, kd.use_backend("ref"):
            want, _ = period[i].moe_mod.apply(lp[f"b{i}"]["mlp"], h, fp32)
        same = all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in zip(r_got, r_want)
                   for f in ("expert_idx", "slot_e", "slot_c", "keep", "gate"))
        check(same, "hybrid-x: the MoE layer's routing differs between the kernels and the plain versions")
        kept = int(r_got[0].keep.sum())
        layers["moe"] = positions_gap(torch, got.reshape(-1, cfg.d_model), want.reshape(-1, cfg.d_model),
                                      HYBRID_X_TOL)
    del got, want, h
    for name, gap in layers.items():
        check(gap["max"] <= HYBRID_X_TOL, f"hybrid-x {name} layer: max err {gap['max']:.3e} of the scale "
                                          f"{gap['scale']:.3f} (bound {HYBRID_X_TOL})")

    # the period's prefill with no activation quantizer: routing counted
    # against the plain path's; the logits held over the flattened positions
    # before the first token routed differently (a moved token changes its
    # own row, later tokens of its sequence and later ranks of its group)
    with torch.no_grad():
        with record_routes() as r_got:
            got = model.prefill(tree, {"tokens": toks}, fp32)
        t0 = time.perf_counter()
        with record_routes() as r_want, kd.use_backend("ref"):
            want = model.prefill(tree, {"tokens": toks}, fp32)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
    differ = torch.zeros(ZOO_B * ZOO_S, dtype=torch.bool, device=dev)
    for a, b in zip(r_got, r_want):
        differ |= (a.expert_idx.sort(-1).values != b.expert_idx.sort(-1).values).any(-1).reshape(-1)
    moved = int(differ.sum())
    first = int(differ.nonzero()[0]) if moved else ZOO_B * ZOO_S
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    gap = positions_gap(torch, flat(got)[:first], flat(want)[:first], DENSE_X_TOL)
    gap_all = positions_gap(torch, flat(got), flat(want), DENSE_X_TOL)
    check(first > 0, "hybrid-x: the first token of the prefill is routed differently")
    check(gap["max"] <= DENSE_X_TOL, f"hybrid-x prefill logits before the first token routed differently "
                                     f"({first} positions), no activation quantizer: max err {gap['max']:.3e} of the "
                                     f"scale {gap['scale']:.3f} (bound {DENSE_X_TOL})")
    del got, want
    # the engine, kernels against the plain path: a shorter run than zoo-x's,
    # since the plain versions' decode step at this width takes seconds
    # (route A's plain version sums each product's k in order, one launch a k)
    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED), lo=4, hi=8)
    pol8 = get_policy("floatsd8_table6")
    _, reqs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, cache_len=DENSE_CACHE_LEN,
                           max_new=HYBRID_X_NEW)
    _, refs, ref_times = zoo_serve(torch, model, store.tree, pol8, prompts, backend="ref",
                                   cache_len=DENSE_CACHE_LEN, max_new=HYBRID_X_NEW)
    decisive, agree = decisive_tokens(reqs, refs, "hybrid-x")
    print(f"hybrid-x (kernels vs backend='ref' on the card, {smi}): one Mamba layer at full width on one input "
          f"[{ZOO_B},{ZOO_S},{cfg.d_model}], policy fp32: max err {layers['mamba']['max']:.3e} of the scale "
          f"{layers['mamba']['scale']:.3f} (bound {HYBRID_X_TOL}); one MoE layer: routing equal (expert indices, "
          f"slots, keep mask, gates; {kept} of {r_got[0].keep.numel()} assignments kept), max err "
          f"{layers['moe']['max']:.3e} of the scale {layers['moe']['scale']:.3f} (bound {HYBRID_X_TOL}). The period's "
          f"prefill [{ZOO_B},{ZOO_S}], policy fp32: {moved} tokens whose top-{cfg.top_k} set differs at some MoE "
          f"layer, the first at flattened position {first}; logits before it max err {gap['max']:.3e} of the scale "
          f"{gap['scale']:.3f} (bound {DENSE_X_TOL}), over all positions {gap_all['max']:.3e}, argmax equal at "
          f"{gap_all['argmax']} of {ZOO_B * ZOO_S}; plain prefill {t_ref:.2f} s; engine ({ZOO_LANES} lanes, prompts "
          f"of 4-7 tokens, {HYBRID_X_NEW} new, floatsd8_table6): {decisive} of {ZOO_LANES * HYBRID_X_NEW} tokens "
          f"margin-decisive (floor {MARGIN_FLOOR}) and equal, {agree} of {ZOO_LANES} streams equal in full; plain "
          f"decode step {statistics.median(ref_times) * 1e3:.1f} ms", flush=True)
    del tree
    torch.cuda.empty_cache()
    return dict(layers=layers, moved=moved, first=first, gap=gap, decisive=decisive)


def moe_phase(torch, dev, smi):
    """Phase 20: the moe family's reduced dbrx_132b and kimi_k2_1t_a32b on
    the kernels against backend="ref" on the card: prefill logits and
    greedy tokens. Their published widths need 132 GB and over 1 TB of
    codes."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.models import build
    from repro_torch.serving import WeightStore, synthetic_prompts

    out = {"launches": {}}
    for arch in MOE_ARCHS:
        cfg = get_config(arch).reduced()
        model = build(cfg)
        store = WeightStore.pack(model.init(torch.Generator(device=dev).manual_seed(SEED)))
        tree = model.hoist(store.tree)
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, MOE_S)), device=dev)
        fp32 = get_policy("fp32")
        kd.STATS.reset()
        zoo_counters(reset=True)
        with torch.no_grad():
            got = model.prefill(tree, {"tokens": toks}, fp32)
        launches, stats = zoo_counters(), kd.STATS.snapshot()
        want = {"floatsd_matmul": mm_sites(model), "qsigmoid": 0, "rwkv_wkv": 0,
                "flash_attention": attn_layers(model)}
        check(launches == want and stats == {(op, "cuda"): n for op, n in want.items() if n},
              f"moe {arch} prefill launches {launches} != {want}; dispatch {stats}")
        with torch.no_grad(), kd.use_backend("ref"):
            ref = model.prefill(tree, {"tokens": toks}, fp32)
        gap = positions_gap(torch, got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1]), DENSE_X_TOL)
        check(gap["max"] <= DENSE_X_TOL, f"moe {arch}: prefill logits max err {gap['max']:.3e} of the scale "
                                         f"{gap['scale']:.3f} (bound {DENSE_X_TOL})")
        prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
        pol8 = get_policy("floatsd8_table6")
        zoo_counters(reset=True)
        eng, reqs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, cache_len=DENSE_CACHE_LEN)
        eng_launches = zoo_counters()
        check(eng_launches["floatsd_matmul"] == mm_sites(model) * eng.metrics.steps,
              f"moe {arch} engine launches {eng_launches}")
        _, refs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, backend="ref", cache_len=DENSE_CACHE_LEN)
        decisive, agree = decisive_tokens(reqs, refs, f"moe {arch}")
        for op in want:
            out["launches"][op] = out["launches"].get(op, 0) + launches[op] + eng_launches[op]
        print(f"moe: {arch} reduced (d_model {cfg.d_model}, {cfg.n_layers} layers, {cfg.n_experts} experts "
              f"top-{cfg.top_k}, first_k_dense {cfg.first_k_dense}; {store.n_packed} leaves, {store.packed_nbytes} B) "
              f"on the card ({smi}): prefill [{ZOO_B},{MOE_S}] launches {launches}; logits under fp32 max err "
              f"{gap['max']:.3e} of the scale {gap['scale']:.3f} (bound {DENSE_X_TOL}) against backend='ref'; engine "
              f"({ZOO_LANES} lanes, {ZOO_MAX_NEW} new): launches {eng_launches}, {decisive} of "
              f"{ZOO_LANES * ZOO_MAX_NEW} tokens margin-decisive and equal to the plain path's, {agree} of "
              f"{ZOO_LANES} streams equal in full", flush=True)
        del store, tree, got, ref
    torch.cuda.empty_cache()
    return out


# the audio family (phases 21-22): whisper_large_v3 at its published width
# (32 encoder + 32 decoder layers, d_model 1280, 20 heads of 64, d_ff 5120
# GELU, LayerNorm, qkv bias, vocab 51866 padded to 51968, tied; 1500 stub
# frames: the conv frontend is a stub in the reference too), served in
# FloatSD8 through the model's own entry points (the engine feeds no encoder
# input)
AUDIO_ARCH = "whisper_large_v3"
AUDIO_CODE_BYTES = 1_542_466_560  # the FloatSD8 codes, from the shapes
AUDIO_BYTES = AUDIO_CODE_BYTES + 38 * 4 + 4 * 1280 * 4  # + a 4-byte bias a packed leaf + the f32 ln_enc, ln_dec
AUDIO_LEAVES = 38
AUDIO_ENC_SITES, AUDIO_DEC_SITES = 6, 10  # weight sites a layer: q, k, v, o, wi, wo; the decoder's + cross q, k, v, o
AUDIO_DEC = 64  # the teacher-forced decoder tokens, and sequence 0's through decode_step
AUDIO_NEW = 16  # the greedy transcription batch's new tokens, at ZOO_LANES lanes
AUDIO_CROSS_BYTES = 1_966_080_000  # 32 layers x 8 lanes x 1500 frames x 1280 x (K, V) x 2 B, bf16
AUDIO_START = 50258  # Whisper's start-of-transcript token
# decode_seq against prefill_cross + decode_step through all 64 layers with no
# activation quantizer: the reference's own gap at the reduced config is
# 1.67e-3 of the scale (its bf16 cross and self caches against decode_seq's
# f32 K and V), the dense family's bound holds it
AUDIO_TOL = DENSE_TOL
AUDIO_X_LAYERS = 2  # encoder and decoder layers of the kernel-vs-plain cross-check
# the vlm family (phases 23-24): qwen2_vl_2b at its published width (28
# layers, d_model 1536, 12 heads of 128 over 2 KV heads, d_ff 8960 SwiGLU,
# rmsnorm, qkv bias, M-RoPE sections (16, 24, 24), vocab 151936 padded to
# 152064, tied; 256 stub patch embeddings), served in FloatSD8
VLM_ARCH = "qwen2_vl_2b"
VLM_CODE_BYTES = 1_546_268_672
VLM_BYTES = VLM_CODE_BYTES + 14 * 4 + 1536 * 4  # + a 4-byte bias a packed leaf + the f32 final norm
VLM_LEAVES = 14
VLM_KV_BYTES = 469_762_048  # 28 layers x 2 x 8 lanes x 2048 x 2 KV heads x 128 x 2 B


def whisper_greedy(torch, model, tree, frames, policy, n_new, backend=None, cache_len=DENSE_CACHE_LEN,
                   cache=None):
    """A greedy transcription batch through Whisper's entry points:
    prefill_cross on ``frames`` [B, 1500, d] (unless ``cache`` is one
    already filled), then ``n_new`` decode steps from AUDIO_START. Returns
    (requests with .rid, .out, .margins, the cache, prefill_cross's wall
    time, each step's wall time)."""
    import types

    from repro_torch.kernels import dispatch as kd

    b, vocab = frames.shape[0], model.cfg.vocab
    reqs = [types.SimpleNamespace(rid=i, out=[], margins=[]) for i in range(b)]
    times = []
    with torch.no_grad(), kd.use_backend(backend):
        t0 = time.perf_counter()
        if cache is None:
            cache = model.prefill_cross(tree, frames, model.init_cache(b, policy, frames.device,
                                                                       cache_len=cache_len), policy)
        torch.cuda.synchronize()
        t_cross = time.perf_counter() - t0
        tok = torch.full((b, 1), AUDIO_START, dtype=torch.int32, device=frames.device)
        for _ in range(n_new):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(tree, tok, cache, policy)
            last = lg[:, -1, :vocab]
            top2 = torch.topk(last, 2, dim=-1).values
            tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            nxt, margin = tok[:, 0].tolist(), (top2[:, 0] - top2[:, 1]).tolist()  # a device-to-host copy: synchronised
            times.append(time.perf_counter() - t0)
            for r, t, m in zip(reqs, nxt, margin):
                r.out.append(t)
                r.margins.append(m)
    return reqs, cache, t_cross, times


def audio_phase(torch, dev, smi):
    """Phase 21: full-width whisper_large_v3, packed, its encoder and
    teacher-forced decoder run, its incremental decode held against them,
    and a greedy transcription batch."""
    import numpy as np

    from repro_torch._tree import tree_leaves
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd

    cfg, model, store, t_build = zoo_build(torch, dev, arch=AUDIO_ARCH)
    L, LE = cfg.n_layers, cfg.enc_layers
    codes = sum(x.codes.numel() for x in tree_leaves(store.tree, is_leaf=kd.is_packed) if kd.is_packed(x))
    print(f"audio: {cfg.name} ({LE} encoder + {L} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff} {cfg.ffn_kind}, vocab {cfg.vocab} padded to {cfg.vocab_padded()}, "
          f"{cfg.enc_seq} stub frames) from seed {SEED}: {store.dense_nbytes} B f32 -> {store.packed_nbytes} B packed "
          f"FloatSD8 ({codes} B of codes, {store.n_packed} leaves) in {t_build:.1f} s", flush=True)
    check(store.packed_nbytes == AUDIO_BYTES and codes == AUDIO_CODE_BYTES and store.n_packed == AUDIO_LEAVES,
          f"audio resident bytes {store.packed_nbytes} != {AUDIO_BYTES} (codes {codes}, {store.n_packed} leaves)")
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")
    fp32 = get_policy("fp32")
    tree = model.hoist(store.tree)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    frames = torch.randn((ZOO_B, cfg.enc_seq, cfg.d_model), device=dev, generator=g)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, AUDIO_DEC)), device=dev)
    enc_mm, dec_mm = AUDIO_ENC_SITES * LE, AUDIO_DEC_SITES * L + 1
    step_mm = (AUDIO_DEC_SITES - 2) * L + 1  # a decode step: the cross K and V are cached
    cross_mm = enc_mm + 2 * L  # prefill_cross: the encoder, then each layer's cross K and V
    out = {}

    def prefill(policy, b=ZOO_B):
        return model.decode_seq(tree, toks[:b], model.encode(tree, frames[:b], policy), policy)

    kd.STATS.reset()
    zoo_counters(reset=True)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = prefill(pol)
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    want = {"floatsd_matmul": enc_mm + dec_mm, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": LE + 2 * L}
    check(launches == want, f"audio encode + decode_seq launches {launches} != {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items() if n}, f"audio dispatch records {stats}")
    check(tuple(logits.shape) == (ZOO_B, AUDIO_DEC, cfg.vocab_padded()) and bool(torch.isfinite(logits).all()),
          f"audio logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with torch.no_grad():
        t0 = time.perf_counter()
        prefill(pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, wall_prof = profile_prefill(torch, lambda: prefill(pol))
    busy = sum(ms for ms, _ in groups.values())
    out["prefill"] = dict(launches=launches, wall_s=wall, profile=groups)
    print(f"audio encode + decode_seq: B {ZOO_B} x {cfg.enc_seq} frames, {AUDIO_DEC} tokens: {wall * 1e3:.1f} ms wall "
          f"({wall_first * 1e3:.1f} ms the first; {ZOO_B * cfg.enc_seq / wall:.0f} frames/s; {smi}); launches "
          f"{launches} ({LE} x {AUDIO_ENC_SITES} encoder and {L} x {AUDIO_DEC_SITES} decoder weight sites + the head; "
          f"{LE} encoder, {L} causal and {L} cross attentions); dispatch "
          f"{dict((f'{o}/{b}', n) for (o, b), n in stats.items())}; logits finite, |max| "
          f"{float(logits.abs().max()):.3f}. Profiled: {wall_prof:.1f} ms wall, device busy {busy:.1f} ms: "
          + ", ".join(f"{grp} {ms:.1f} ms ({n} kernels)" for grp, (ms, n) in groups.items()), flush=True)

    def decode(policy):
        """Sequence 0's AUDIO_DEC tokens through prefill_cross and
        decode_step: (logits [AUDIO_DEC, vocab], each step's wall time)."""
        rows, times = [], []
        with torch.no_grad():
            cache = model.prefill_cross(tree, frames[:1], model.init_cache(1, policy, dev, cache_len=AUDIO_DEC),
                                        policy)
            for t in range(AUDIO_DEC):
                t0 = time.perf_counter()
                lg, cache = model.decode_step(tree, toks[:1, t:t + 1], cache, policy)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                rows.append(lg[0, 0])
        return torch.stack(rows), times

    kd.STATS.reset()
    zoo_counters(reset=True)
    dec, times = decode(pol)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    with torch.no_grad():  # one more step, after the counters are read: its host work
        cache = model.init_cache(1, pol, dev, cache_len=AUDIO_DEC)
        n_ops = torch_ops(torch, lambda: model.decode_step(tree, toks[:1, :1], cache, pol))
        del cache
    want = {"floatsd_matmul": cross_mm + step_mm * AUDIO_DEC, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": LE}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"audio decode launches {launches} != {want}; dispatch {stats}")
    check(bool(torch.isfinite(dec).all()), "audio decode: nonfinite logits")
    served = positions_gap(torch, dec, logits[0], AUDIO_TOL)
    with torch.no_grad():
        ref32 = prefill(fp32, b=1)[0]
    dec32, _ = decode(fp32)
    plain = positions_gap(torch, dec32, ref32, AUDIO_TOL)
    check(plain["max"] <= AUDIO_TOL, f"audio decode vs decode_seq, no activation quantizer: max err "
                                     f"{plain['max']:.3e} of the scale {plain['scale']:.3f} (bound {AUDIO_TOL})")
    step = statistics.median(times[1:])
    out["decode"] = dict(launches=launches, step_ms=step * 1e3, aten_ops=n_ops, served=served, plain=plain)
    print(f"audio decode: prefill_cross of sequence 0, then its {AUDIO_DEC} tokens through decode_step (B 1): median "
          f"step {step * 1e3:.2f} ms, {1 / step:.1f} tok/s ({smi}), {n_ops} ATen operations a step; launches "
          f"{launches}. Against decode_seq's logits: with no activation quantizer (policy fp32, the same codes) max "
          f"err {plain['max']:.3e} of the scale {plain['scale']:.3f} (bound {AUDIO_TOL}; position {AUDIO_DEC - 1}: "
          f"{plain['last']:.3e}), argmax equal at {plain['argmax']} of {AUDIO_DEC}; under floatsd8_table6 (reported) "
          f"max err {served['max']:.3e} of the scale {served['scale']:.3f}, within {AUDIO_TOL} up to position "
          f"{served['first'] - 1}, argmax equal at {served['argmax']} of {AUDIO_DEC}", flush=True)
    del logits, ref32, dec, dec32

    frames8 = torch.randn((ZOO_LANES, cfg.enc_seq, cfg.d_model), device=dev, generator=g)
    kd.STATS.reset()
    zoo_counters(reset=True)
    reqs, cache, t_cross, times = whisper_greedy(torch, model, tree, frames8, pol, AUDIO_NEW)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    cross_bytes = sum(cache[k].numel() * cache[k].element_size() for k in ("cross_k", "cross_v"))
    self_bytes = sum(t.numel() * t.element_size() for t in cache["self"][:2])
    check(cross_bytes == AUDIO_CROSS_BYTES, f"audio cross-KV cache {cross_bytes} B != {AUDIO_CROSS_BYTES}")
    want = {"floatsd_matmul": cross_mm + step_mm * AUDIO_NEW, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": LE}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"audio greedy batch launches {launches} != {want}; dispatch {stats}")
    check(all(len(r.out) == AUDIO_NEW and all(0 <= t < cfg.vocab for t in r.out) for r in reqs),
          "audio greedy batch: tokens outside the vocab")
    step = statistics.median(times)
    out["greedy"] = dict(launches=launches, step_ms=step * 1e3, tok_s=ZOO_LANES / step, cross_s=t_cross,
                         cross_bytes=cross_bytes)
    print(f"audio greedy batch: {ZOO_LANES} lanes, each its own {cfg.enc_seq} seeded frames, from token "
          f"{AUDIO_START}, {AUDIO_NEW} new tokens: prefill_cross {t_cross * 1e3:.1f} ms, cross-KV cache {cross_bytes} "
          f"B, self cache {self_bytes} B ({DENSE_CACHE_LEN} positions); median step {step * 1e3:.2f} ms = "
          f"{ZOO_LANES / step:.1f} tok/s ({smi}); launches {launches}; lane 0's tokens {reqs[0].out}", flush=True)
    out["launches"] = {op: sum(out[p]["launches"][op] for p in ("prefill", "decode", "greedy")) for op in want}
    del store, tree, cache, frames, frames8
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def fp8_inputs(torch, calls: list):
    """Record, in call order, every activation the weight sites quantize to
    FP8 (``nn.linear.act_quant``'s input, before rounding)."""
    from repro_torch.nn import linear

    act_quant = linear.act_quant

    def recorded(x, fwd, bwd):
        if fwd in (torch.float8_e5m2, torch.float8_e4m3fn):
            calls.append((x.detach().clone(), fwd))
        return act_quant(x, fwd, bwd)

    linear.act_quant = recorded
    try:
        yield calls
    finally:
        linear.act_quant = act_quant


def fp8_flips(torch, got: list, want: list) -> list:
    """Two runs' recorded FP8 inputs (``fp8_inputs``: the kernels', the
    plain path's), batch-major. For each lane: its first site whose FP8
    values differ (None if none), how many differ there, the inputs' largest
    |a - b| there over the lane's largest |b| ("err"), the same over
    FLASH_TOL's f32 atol + rtol |b| ("bound"), and how many FP8 values of
    the lane differ over every site ("total")."""
    from repro_torch.core.fp8 import cast_fp8

    check(len(got) == len(want) and all(a.shape == b.shape for (a, _), (b, _) in zip(got, want)),
          f"fp8 flips: the two runs quantized different activations ({len(got)} vs {len(want)} sites)")
    atol, rtol = FLASH_TOL["float32"]
    lanes = [dict(site=None, n=0, err=0.0, bound=0.0, total=0) for _ in range(got[0][0].shape[0])]
    for i, ((a, dt), (b, _)) in enumerate(zip(got, want)):
        differ = (cast_fp8(a, dt).float() != cast_fp8(b, dt).float()).flatten(1).sum(1).tolist()
        for lane, (d, n) in enumerate(zip(lanes, differ)):
            d["total"] += n
            if n and d["site"] is None:
                diff = (a[lane] - b[lane]).abs()
                d.update(site=i, n=n, err=float(diff.max() / b[lane].abs().max()),
                         bound=float((diff / (atol + rtol * b[lane].abs())).max()))
    return lanes


def audio_x_phase(torch, dev, smi):
    """Phase 22: the audio path at full width and AUDIO_X_LAYERS encoder
    and decoder layers on the kernels against backend="ref" (the plain
    versions) on the card: B 1 over all 1500 frames, then a greedy batch:
    with no activation quantizer end to end; under the served policy, where
    each lane's encoder FP8 codes first differ and why, and the decode
    steps from one cross cache."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd

    cfg, model, store, _ = zoo_build(torch, dev, AUDIO_X_LAYERS, arch=AUDIO_ARCH, enc_layers=AUDIO_X_LAYERS)
    tree = model.hoist(store.tree)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    frames = torch.randn((1, cfg.enc_seq, cfg.d_model), device=dev, generator=g)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (1, AUDIO_DEC)), device=dev)
    gaps = {}
    for name in ("fp32", "floatsd8_table6"):
        pol = get_policy(name).replace(weight_quant="none")
        with torch.no_grad():
            enc = model.encode(tree, frames, pol)
            got = model.decode_seq(tree, toks, enc, pol)
            t0 = time.perf_counter()
            with kd.use_backend("ref"):
                enc_ref = model.encode(tree, frames, pol)
                want = model.decode_seq(tree, toks, enc_ref, pol)
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t0
        gaps[name] = positions_gap(torch, got[0], want[0], DENSE_X_TOL)
        gaps[name]["enc"] = positions_gap(torch, enc[0], enc_ref[0], DENSE_X_TOL)["max"]
        gaps[name]["bit_equal"] = float((got == want).float().mean())
        del got, want, enc, enc_ref
    g32, g8 = gaps["fp32"], gaps["floatsd8_table6"]
    check(g32["max"] <= DENSE_X_TOL, f"audio-x decode_seq logits, no activation quantizer: max err {g32['max']:.3e} "
                                     f"of the scale {g32['scale']:.3f} (bound {DENSE_X_TOL})")
    # the greedy batch's tokens held with no activation quantizer
    frames8 = torch.randn((ZOO_LANES, cfg.enc_seq, cfg.d_model), device=dev, generator=g)
    fp32 = get_policy("fp32")
    reqs, *_ = whisper_greedy(torch, model, tree, frames8, fp32, AUDIO_NEW)
    refs, _, _, ref_times = whisper_greedy(torch, model, tree, frames8, fp32, AUDIO_NEW, backend="ref")
    decisive, agree = decisive_tokens(reqs, refs, "audio-x")
    # under the served policy: prefill_cross on the kernels, on the plain
    # path, and on the kernels with the flash on its plain version (route B
    # alone), every FP8 input recorded. Each lane's first FP8 difference is
    # at encoder layer 0's attention output, the first site downstream of a
    # product that is not bit-exact (its q, k, v inputs are equal), within the
    # flash kernel's bound, and the flash kernel, not route B, makes most of
    # them. Then the decode steps from one cross cache, token for token
    pol8 = get_policy("floatsd8_table6").replace(weight_quant="none")
    init = model.init_cache(ZOO_LANES, pol8, dev, cache_len=DENSE_CACHE_LEN)
    sites = [f"encoder layer {i // 6} {w}" for i in range(6 * cfg.enc_layers)
             for w in [("wq", "wk", "wv", "wo", "ffn wi", "ffn wo")[i % 6]]]
    sites += [f"decoder layer {i} cross {w}" for i in range(cfg.n_layers) for w in ("wk", "wv")]
    flash = kd.flash_attention
    with torch.no_grad():
        with fp8_inputs(torch, []) as want, kd.use_backend("ref"):
            model.prefill_cross(tree, frames8, init, pol8)
        with fp8_inputs(torch, []) as got:
            cache = model.prefill_cross(tree, frames8, init, pol8)
        check(len(got) == len(sites), f"audio-x: {len(got)} FP8 sites in prefill_cross, {len(sites)} expected")
        flips = fp8_flips(torch, got, want)
        del got
        kd.flash_attention = functools.partial(flash, backend="ref")
        try:
            with fp8_inputs(torch, []) as got:
                model.prefill_cross(tree, frames8, init, pol8)
        finally:
            kd.flash_attention = flash
        flips_b = fp8_flips(torch, got, want)
        del got, want
    wo = sites.index("encoder layer 0 wo")

    def name(i):
        return "none" if i is None else sites[i]

    for lane, (d, e) in enumerate(zip(flips, flips_b)):
        check(d["site"] == wo and d["bound"] <= 1.0,
              f"audio-x served prefill_cross, lane {lane}: first FP8 difference at "
              f"{name(d['site'])}, {d['bound']:.3f} of the flash bound")
        check(e["n"] < d["n"] if e["site"] == wo else e["site"] is None or e["site"] > wo,
              f"audio-x served prefill_cross, lane {lane}: route B alone flips {e['n']} FP8 values at "
              f"{name(e['site'])}, the flash kernel {d['n']} at {sites[wo]}")
    reqs8, *_ = whisper_greedy(torch, model, tree, frames8, pol8, AUDIO_NEW, cache=cache)
    refs8, *_ = whisper_greedy(torch, model, tree, frames8, pol8, AUDIO_NEW, backend="ref", cache=cache)
    decisive8, agree8 = decisive_tokens(reqs8, refs8, "audio-x served decode")
    firsts = "; ".join(f"{d['n']} ({d['err']:.2e} of the scale, {d['bound']:.3f} of the bound) vs {e['n']} "
                       f"({e['err']:.2e})" for d, e in zip(flips, flips_b))
    print(f"audio-x ({AUDIO_X_LAYERS} of {get_config(AUDIO_ARCH).enc_layers} encoder and {AUDIO_X_LAYERS} of "
          f"{get_config(AUDIO_ARCH).n_layers} decoder layers at full width, kernels vs backend='ref' on the card, "
          f"{smi}): B 1 x {cfg.enc_seq} frames, {AUDIO_DEC} tokens, with no activation quantizer (policy fp32, the "
          f"same codes): encoder states max err {g32['enc']:.3e} of their scale, logits max err {g32['max']:.3e} of "
          f"the scale {g32['scale']:.3f} (bound {DENSE_X_TOL}), {g32['bit_equal']:.2%} bit-equal; under "
          f"floatsd8_table6 (reported) encoder {g8['enc']:.3e}, logits max err {g8['max']:.3e} of the scale "
          f"{g8['scale']:.3f}, within {DENSE_X_TOL} up to position {g8['first'] - 1}, argmax equal at {g8['argmax']} "
          f"of {AUDIO_DEC}; plain encode + decode_seq {t_ref:.2f} s; greedy batch ({ZOO_LANES} lanes, {AUDIO_NEW} "
          f"new, policy fp32): {decisive} of {ZOO_LANES * AUDIO_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) "
          f"and equal, {agree} of {ZOO_LANES} streams equal in full; under floatsd8_table6, prefill_cross: "
          f"{sum(d['total'] for d in flips)} FP8 values of the kernels differ from the plain path's over its "
          f"{len(sites)} sites ({sum(d['total'] for d in flips_b)} with the flash on its plain version), each "
          f"lane's first at {sites[wo]} (of {frames8.shape[1] * cfg.d_model} a lane; the flash kernel vs route B alone): "
          f"{firsts}; decode from the kernels' cross cache: {decisive8} of {ZOO_LANES * AUDIO_NEW} tokens "
          f"margin-decisive and equal, "
          f"{agree8} of {ZOO_LANES} streams equal in full; plain decode step "
          f"{statistics.median(ref_times) * 1e3:.1f} ms", flush=True)
    del store, tree, frames, frames8, cache, init
    torch.cuda.empty_cache()
    return gaps


# ---------------------------------------------------------------------------
# the zoo's training on the card (phases 25-26, and the kernel phase's
# training rows of flash_attention)
# ---------------------------------------------------------------------------

# the flash kernel's lse against the chunked plain version's: the kernel's
# scores carry f32 accuracy up to their sum order, so its log-sum-exp stays
# within 1e-4 + 1e-5 |lse| (tests/test_torch_cuda.py's bound)
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# (name, B, S, H, Kh, D, window): the dense prefill's shape (the window
# inactive) and the full-width training shape, where the window bites
FLASH_TRAIN_CASES = [("train-prefill", ZOO_B, ZOO_S, 32, 8, 120, 4096), ("train-window", 1, 8192, 32, 8, 120, 4096)]
ZOO_TRAIN_ARCHS = ("h2o_danube3_4b", "rwkv6_3b", "dbrx_132b", "jamba_v01_52b", "qwen2_vl_2b", "whisper_large_v3")
ZOO_TRAIN_X_B, ZOO_TRAIN_X_S = 2, 32  # S a multiple of 16: the RWKV prefill runs the wkv kernel
# kernels against backend="ref" under fp32, the same params and batch: the
# loss within 1e-4 relative; each leaf's loss-scaled gradient within
# ZOO_GRAD_TOL of its scale max(max |want|, 1e-2 G), G the largest |want| of
# any leaf (a key bias's exact gradient is 0: noise on both paths). The
# attention's forward rounds p to bf16 from scores that differ in their last
# bits between the kernel and the plain version (their outputs agree within
# FLASH_TOL), and the backward reads o and lse; the bound is FLASH_TOL's rtol
ZOO_LOSS_RTOL = 1e-4
ZOO_GRAD_TOL = 2e-2
ZOO_CLI_STEPS = 5
TRAIN_ARCH = "h2o_danube3_4b"
# full-width h2o_danube3_4b trained at B 1 x S 8192: the depth whose
# measured peak (max_memory_allocated) stays under about 70 GB (PERF.md: ~40
# B a parameter, the fp16 master, Adam's f32 moments, the gradient trees
# and the skip-select copies)
TRAIN_LAYERS = 11
TRAIN_B, TRAIN_S, TRAIN_STEPS_FULL = 1, 8192, 4
TRAIN_X_LAYERS = 2
TRAIN_PEAK_MAX = 72e9  # bytes: the depth's reason; a larger peak fails the phase


def flash_train_phase(torch, dev, flush):
    """Phase 3, continued: the flash kernel's training forward (o with each
    row's log-sum-exp) against the plain version's at the dense prefill's
    shape and the full-width training shape (the window biting): lse
    within its bound, o bit-identical with and without the lse, the
    kernel's time with and without it; the plain backward ``flash_bwd``
    timed beside scaled_dot_product_attention's forward + backward (the
    library call for the same gradient, for information)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import _mask, flash_attention_gqa, flash_bwd
    from repro_torch.kernels.floatsd_matmul.ref import no_tf32

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    rows = {}
    for name, b, s, h, kh, d, window in FLASH_TRAIN_CASES:
        q = torch.randn((b, s, h, d), device=dev, generator=g) * FLASH_Q_SCALE
        k, v = (torch.randn((b, s, kh, d), device=dev, generator=g) for _ in range(2))
        do = torch.randn((b, s, h, d), device=dev, generator=g)
        kw = dict(causal=True, window=window)
        o = flash_attention(q, k, v, **kw)
        o2, lse = flash_attention(q, k, v, **kw, return_lse=True)
        plain_o, plain_lse = flash_attention_gqa(q, k, v, **kw, return_lse=True)
        torch.cuda.synchronize()
        check(torch.equal(o, o2), f"flash_attention {name}: o differs with the lse")
        lse_err = (lse - plain_lse).abs()
        check(bool((lse_err <= LSE_ATOL + LSE_RTOL * plain_lse.abs()).all()),
              f"flash_attention {name}: lse beyond its bound (max err {float(lse_err.max()):.3e})")
        atol, rtol = FLASH_TOL["float32"]
        o_err = (o - plain_o).abs()
        check(bool((o_err <= atol + rtol * plain_o.abs()).all()), f"flash_attention {name}: o beyond the bound")
        t_no = timed_ms(torch, lambda: flash_attention(q, k, v, **kw), 10, flush)
        t_lse = timed_ms(torch, lambda: flash_attention(q, k, v, **kw, return_lse=True), 10, flush)
        with no_tf32():
            t_plain = timed_ms(torch, lambda: flash_attention_gqa(q, k, v, **kw, return_lse=True), 3, flush)
            t_bwd = timed_ms(torch, lambda: flash_bwd(q, k, v, o, lse, do, **kw, chunk=min(1024, s)), 3, flush)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            lib_kw = (dict(is_causal=True) if window >= s else
                      dict(attn_mask=_mask(torch.arange(s, device=dev), torch.arange(s, device=dev), True, window)))

            def lib_fwd_bwd():
                out = sdpa(qt, kt, vt, enable_gqa=True, **lib_kw)
                torch.autograd.grad(out, (qt, kt, vt), dot)

            t_lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw), 10, flush)
            t_lib_bwd = timed_ms(torch, lib_fwd_bwd, 5, flush)
        pairs = b * h * attend_pairs(s, s, True, window)
        # the training forward moves q, k, v and o once and writes 4 B of lse a (batch, head, row)
        bd = bound(q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
                   flash_ops(pairs * d, q, k))
        rows[name] = dict(ms=t_lse, ms_no_lse=t_no, plain_ms=t_plain, library_ms=t_lib, bwd_plain_ms=t_bwd,
                          library_fwd_bwd_ms=t_lib_bwd, err=max(float(o_err.max()), float(lse_err.max())), **bd)
        print(f"  {name} q [{b},{s},{h},{d}], k, v [{b},{s},{kh},{d}] f32, causal, window {window}: lse vs the plain "
              f"version max_abs_err {float(lse_err.max()):.3e} (bound {LSE_ATOL} + {LSE_RTOL} |lse|), o bit-identical "
              f"with and without the lse | kernel {t_lse:.4f} ms with the lse, {t_no:.4f} ms without; plain forward "
              f"{t_plain:.3f} ms; plain backward flash_bwd {t_bwd:.3f} ms; SDPA forward {t_lib:.4f} ms, forward + "
              f"backward {t_lib_bwd:.4f} ms ({'is_causal' if window >= s else 'attn_mask=band'}, enable_gqa); "
              f"{fmt_bound(bd)}", flush=True)
        del q, k, v, do, o, o2, lse, plain_o, plain_lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rows


def wkv_train_phase(torch, dev, flush) -> dict:
    """Phase 3, continued: the wkv's training backward at the full-width
    prefill shape ([2,1024,40,64], w0 = -2): the gradient through
    dispatch.rwkv_wkv with the kernel's forward equal bit for bit to the
    same with the plain forward (the backward reads only the inputs), and
    the backward's time (the reference model's chunked scan recomputed
    under autograd, wkv_chunked_scan) beside the kernel's forward."""
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
    from repro_torch.kernels.rwkv_wkv.ref import wkv_chunked_scan
    from repro_torch.kernels.floatsd_matmul.ref import no_tf32

    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    b, s, h, k = ZOO_B, ZOO_S, 40, 64
    r, kk, vv = (torch.randn((b, s, h, k), device=dev, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, s, h, k), device=dev, generator=g) * 0.3 - 2.0))
    u = torch.randn((h, k), device=dev, generator=g) * 0.1
    cy, cs = torch.randn((b, s, h, k), device=dev, generator=g), torch.randn((b, h, k, k), device=dev, generator=g)

    def grads(backend=None):
        xs = [t.detach().requires_grad_() for t in (r, kk, vv, w, u)]
        with kd.use_backend(backend):
            y, st = kd.rwkv_wkv(*xs)
            return torch.autograd.grad((y, st), xs, (cy, cs))

    n0 = rwkv_wkv.launches
    got = grads()
    check(rwkv_wkv.launches == n0 + 1, "rwkv_wkv: the trained forward did not launch the kernel")
    check(all(torch.equal(a, e) for a, e in zip(got, grads("ref"))),
          "rwkv_wkv: the gradient differs between the kernel's forward and the plain one")

    def backward():
        xs = [t.detach().requires_grad_() for t in (r, kk, vv, w, u)]
        with no_tf32():
            y, st = wkv_chunked_scan(*xs)
            torch.autograd.grad((y, st), xs, (cy, cs))

    t_fwd = timed_ms(torch, lambda: rwkv_wkv(r, kk, vv, w, u), 10, flush)
    t_bwd = timed_ms(torch, backward, 3, flush)
    print(f"  rwkv_wkv training backward r, k, w, v [{b},{s},{h},{k}]: the gradient with the kernel's forward equal "
          f"bit for bit to the plain forward's | kernel forward {t_fwd:.4f} ms; plain backward (the chunked scan "
          f"recomputed under autograd) {t_bwd:.3f} ms", flush=True)
    return dict(ms=t_fwd, bwd_plain_ms=t_bwd)


def zoo_train_counters(reset: bool = False) -> dict:
    """Launch counts of the zoo training path's kernels (zeroed when ``reset``)."""
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize

    counts = zoo_counters(reset)
    if reset:
        floatsd_quantize.launches = 0
    return {**counts, "floatsd_quantize": floatsd_quantize.launches}


def _train_batch(torch, dev, cfg, b: int, s: int, seed: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), device=dev, generator=g),
             "labels": torch.randint(0, cfg.vocab, (b, s), device=dev, generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), device=dev, generator=g)
    if cfg.n_patches:
        batch["patch_embeds"] = torch.randn((b, cfg.n_patches, cfg.d_model), device=dev, generator=g)
    return batch


def loss_and_grads(torch, model, params, batch, policy, backend=None):
    """The loss-scaled loss and every leaf's loss-scaled gradient (the train
    step's run policy), on the kernels or, with backend="ref", the plain
    versions: (loss, {leaf: gradient})."""
    from repro_torch._tree import tree_map
    from repro_torch.core import loss_scaling as ls
    from repro_torch.kernels import dispatch as kd

    run = policy.replace(grad_quant="fp8_kernel") if policy.grad_quant == "fp8" else policy
    tree = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = flat_leaves(tree)
    scale = ls.static_init(policy.loss_scale, device=batch["tokens"].device)
    with kd.use_backend(backend):  # the backward's remat recomputes the forward: inside the block too
        loss = ls.scale_loss(model.loss(tree, batch, run).to(torch.float32), scale)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss), {k: (torch.zeros_like(v) if gr is None else gr) for (k, v), gr in zip(leaves.items(), grads)}


def grad_gaps(torch, got: dict, want: dict) -> dict:
    """Per leaf: the largest |got - want| over max(max |want|, 1e-2 G), G the
    largest |want| of any leaf; nonfinite elements must sit in the same
    places."""
    g = max(float(w[torch.isfinite(w)].abs().max()) if bool(torch.isfinite(w).any()) else 0.0 for w in want.values())
    out = {}
    for k, w in want.items():
        a = got[k]
        fin_w, fin_a = torch.isfinite(w), torch.isfinite(a)
        scale = max(float(w[fin_w].abs().max()) if bool(fin_w.any()) else 0.0, 1e-2 * g, 1e-30)
        err = torch.where(fin_w & fin_a, (a.float() - w.float()).abs(), 0.0)
        out[k] = (float(err.max()) / scale, bool(torch.equal(fin_w, fin_a)))
    return out


def zoo_train_x_phase(torch, dev, smi):
    """Phase 25: every zoo family's reduced config trained on the card, on
    the kernels against backend="ref" from the same params and batch (B 2 x
    S 32; Qwen2-VL with its 16 stub patches, Whisper with its frames):
    under fp32 the loss and every leaf's loss-scaled gradient within the
    stated bounds, under floatsd8_table6 one make_train_step step each
    whose grads_finite agree (the differences reported); every flash,
    wkv and qsigmoid forward on its kernel on the first path, none on the
    second; then the training CLI's --arch on the card."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.launch import train as tl
    from repro_torch.models import build
    from repro_torch.optim import adam
    from repro_torch.optim.train_state import init_state, make_train_step

    launches, rows = {}, {}
    fp32, pol, opt = get_policy("fp32"), get_policy("floatsd8_table6"), adam()
    for arch in ZOO_TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        model = build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        batch = _train_batch(torch, dev, cfg, ZOO_TRAIN_X_B, ZOO_TRAIN_X_S, SEED + 31)
        # fp32: the loss and every leaf's gradient; floatsd8_table6: one train
        # step from the same init; on the kernels, then on the plain path
        res = {}
        zoo_train_counters(reset=True)
        kd.STATS.reset()
        for backend in (None, "ref"):
            loss, grads = loss_and_grads(torch, model, params, batch, fp32, backend)
            with kd.use_backend(backend):
                new, m = make_train_step(model.loss, opt, pol, lr=1e-3)(init_state(params, opt, pol), batch)
            res[backend] = (loss, grads, bool(m["grads_finite"]), float(m["loss"]), flat_leaves(new.params))
            if backend is None:
                n_kernel, stats = zoo_train_counters(), kd.STATS.snapshot()
        check(zoo_train_counters() == n_kernel, f"{arch}: a kernel launched on backend='ref'")
        want_ops = {"flash_attention"} if cfg.family != "ssm" else {"rwkv_wkv", "qsigmoid"}
        check(all(n_kernel[op] > 0 for op in want_ops)
              and all(stats.get((op, "ref"), 0) == 0 for op in ("flash_attention", "rwkv_wkv", "qsigmoid")),
              f"{arch}: the forwards did not all run on the kernels: launches {n_kernel}, dispatch {stats}")
        (loss, grads, finite, step_loss, masters), (loss_ref, grads_ref, finite_ref, step_loss_ref, masters_ref) = (
            res[None], res["ref"])
        check(abs(loss - loss_ref) <= ZOO_LOSS_RTOL * abs(loss_ref), f"{arch}: loss {loss} vs plain {loss_ref}")
        gaps = grad_gaps(torch, grads, grads_ref)
        worst = max((v[0], k) for k, v in gaps.items() if not k.endswith("wk/b"))  # a key bias's exact gradient is 0
        check(all(v[1] for v in gaps.values()) and worst[0] <= ZOO_GRAD_TOL,
              f"{arch}: gradient {worst[1]} {worst[0]:.3e} of its scale (bound {ZOO_GRAD_TOL})")
        check(finite == finite_ref, f"{arch}: grads_finite {finite} on the kernels, {finite_ref} on the plain path")
        moved = max(float((masters[k].float() - masters_ref[k].float()).abs().max()) for k in masters)
        launches[arch] = n_kernel
        rows[arch] = dict(loss=loss, loss_ref=loss_ref, grad_gap=worst, finite=finite)
        print(f"zoo-train-x {arch} ({cfg.family}, reduced, B {ZOO_TRAIN_X_B} x S {ZOO_TRAIN_X_S}): fp32 loss-scaled "
              f"loss {loss:.6f} vs plain {loss_ref:.6f}; largest leaf gradient gap {worst[0]:.3e} of its scale "
              f"({worst[1]}; bound {ZOO_GRAD_TOL}; key biases, whose exact gradient is 0, not held); "
              f"floatsd8_table6 step: grads_finite {finite} on both paths, loss {step_loss:.6f} vs "
              f"{step_loss_ref:.6f}, masters at most {moved:.3e} apart; kernel launches {n_kernel} "
              f"(forwards and the remat's recompute)", flush=True)
        del model, params, res, grads, grads_ref, masters, masters_ref
    torch.cuda.empty_cache()
    # the training CLI on the card: every attention forward on the kernel
    kd.STATS.reset()
    zoo_train_counters(reset=True)
    out_text = io.StringIO()
    with contextlib.redirect_stdout(out_text):
        out = tl.main(["--arch", TRAIN_ARCH, "--steps", str(ZOO_CLI_STEPS), "--log-every", str(ZOO_CLI_STEPS)])
    text = out_text.getvalue()
    print("\n".join("  cli: " + line for line in text.splitlines()), flush=True)
    cli = zoo_train_counters()
    cfg = get_config(TRAIN_ARCH).reduced()
    want_flash = 2 * cfg.n_layers * ZOO_CLI_STEPS  # each layer's forward and its recompute, each step
    dispatch_line = next(line for line in text.splitlines() if line.startswith("dispatch:"))
    check(cli["flash_attention"] == want_flash and f"flash_attention/cuda={want_flash}" in dispatch_line
          and "/ref=" not in dispatch_line, f"training CLI --arch {TRAIN_ARCH}: launches {cli}, {dispatch_line}")
    check(all(math.isfinite(x) for x in out["losses"]), f"training CLI: losses {out['losses']}")
    launches["cli"] = cli
    total = {op: sum(c[op] for c in launches.values()) for op in cli}
    return {"launches": total, "rows": rows}


def device_share(torch, run):
    """One ``run()`` under torch.profiler: (wall ms, device busy ms, the
    top device operations by time as (name, ms, launches))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return wall, sum(ms for _, ms, _ in ops), sorted(ops, key=lambda o: -o[1])


def zoo_train_phase(torch, dev, smi, flash_rows):
    """Phase 26: h2o_danube3_4b at its published width (d 3840, 32 heads of
    120 over 8, d_ff 10240, vocab 32000, window 4096), TRAIN_LAYERS layers,
    trained TRAIN_STEPS_FULL steps at B 1 x S 8192 under floatsd8_table6
    (Adam, lr 1e-3, static scale 1024, telemetry on, as the CLI) from a
    seeded init: every flash forward on the kernel (2 a layer a step: the
    forward and the remat's recompute), none on the plain path; every loss
    finite; the peak memory; one step profiled. Then TRAIN_X_LAYERS layers
    of the same width under fp32 on the kernels against backend="ref": the
    loss and every leaf's gradient within the bounds of phase 25."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.models import build
    from repro_torch.optim import adam
    from repro_torch.optim.train_state import init_state, make_train_step

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_ff, cfg.vocab, cfg.window)
          == (3840, 32, 8, 120, 10240, 32000, 4096), f"{TRAIN_ARCH}: not the published width")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    model = build(cfg)
    pol, opt = get_policy("floatsd8_table6"), adam()
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(SEED)), opt, pol)
    n_params = sum(v.numel() for v in flat_leaves(state.params).values())
    step = make_train_step(model.loss, opt, pol, lr=1e-3, telemetry=True)
    batch = _train_batch(torch, dev, cfg, TRAIN_B, TRAIN_S, SEED + 41)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    zoo_train_counters(reset=True)
    kd.STATS.reset()
    losses, times = [], []
    for _ in range(TRAIN_STEPS_FULL):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # a device->host copy: synchronised
        times.append(time.perf_counter() - t0)
        check(bool(m["grads_finite"]), f"{TRAIN_ARCH} at full width: a nonfinite step")
    counts = zoo_train_counters()
    stats = kd.STATS.snapshot()
    peak = torch.cuda.max_memory_allocated() - base
    want_flash = 2 * TRAIN_LAYERS * TRAIN_STEPS_FULL
    check(counts["flash_attention"] == want_flash and stats.get(("flash_attention", "cuda"), 0) == want_flash
          and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"{TRAIN_ARCH} at full width: launches {counts}, dispatch {stats} (want {want_flash} flash_attention)")
    check(all(math.isfinite(x) for x in losses), f"{TRAIN_ARCH} at full width: losses {losses}")
    check(peak <= TRAIN_PEAK_MAX, f"{TRAIN_ARCH} at full width: peak {peak} B above {TRAIN_PEAK_MAX:.0f}")
    warm = statistics.median(times[1:])
    holder = {"state": state}

    def one_step():
        holder["state"], mm = step(holder["state"], batch)
        float(mm["loss"])

    wall, busy, ops = device_share(torch, one_step)
    # the flash backward's own einsums are GEMMs too: its share overlaps the GEMM group's
    groups = {"flash_attention kernel": 0.0, "GEMM (the f32 einsums, TF32 off)": 0.0, "other": 0.0}
    for name, ms, _ in ops:
        low = name.lower()
        key = ("flash_attention kernel" if "flash_fwd_kernel" in low or "flash_split_kv" in low else
               "GEMM (the f32 einsums, TF32 off)" if "gemm" in low or "cutlass" in low else "other")
        groups[key] += ms
    bwd_ms = TRAIN_LAYERS * flash_rows["train-window"]["bwd_plain_ms"]
    print(f"zoo-train {TRAIN_ARCH} at full width (d_model 3840, 32/8 heads of 120, d_ff 10240, vocab 32000, window "
          f"4096), {TRAIN_LAYERS} of {full.n_layers} layers ({n_params:,} parameters), B {TRAIN_B} x S {TRAIN_S}, "
          f"floatsd8_table6, Adam lr 1e-3, static scale 1024, telemetry on: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step times {', '.join(f'{t:.3f}' for t in times)} s, median warm "
          f"{warm:.3f} s ({TRAIN_B * TRAIN_S / warm:.0f} tok/s); state {state_bytes:,} B, peak "
          f"max_memory_allocated {peak:,} B above the {base:,} B earlier phases hold ({peak / n_params:.1f} B a "
          f"parameter); launches {counts} "
          f"({want_flash} flash_attention: forward + recompute, every one on the kernel) | one step profiled: wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms ({busy / wall:.1%}); by group "
          + ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in groups.items())
          + f"; the plain flash backward, {TRAIN_LAYERS} x {flash_rows['train-window']['bwd_plain_ms']:.2f} ms "
          f"(the kernel phase's train-window row, its einsums among the GEMMs) = {bwd_ms:.1f} ms, "
          f"{bwd_ms / busy:.1%} of the busy time; top "
          f"device operations: " + "; ".join(f"{n[:60]} {ms:.1f} ms x{c}" for n, ms, c in ops[:8]) + f" ({smi})",
          flush=True)
    del state, holder, step, model
    torch.cuda.empty_cache()
    # kernels against the plain versions at TRAIN_X_LAYERS layers of the same width, fp32
    xcfg = dataclasses.replace(full, n_layers=TRAIN_X_LAYERS)
    xmodel = build(xcfg)
    params = xmodel.init(torch.Generator(device=dev).manual_seed(SEED))
    fp32 = get_policy("fp32")
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(torch, xmodel, params, batch, fp32)
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_ref, grads_ref = loss_and_grads(torch, xmodel, params, batch, fp32, backend="ref")
    t_ref = time.perf_counter() - t0
    gaps = grad_gaps(torch, grads, grads_ref)
    worst = max((v[0], k) for k, v in gaps.items() if not k.endswith("wk/b"))
    check(abs(loss - loss_ref) <= ZOO_LOSS_RTOL * abs(loss_ref), f"zoo-train x: loss {loss} vs plain {loss_ref}")
    check(all(v[1] for v in gaps.values()) and worst[0] <= ZOO_GRAD_TOL,
          f"zoo-train x: gradient {worst[1]} {worst[0]:.3e} of its scale (bound {ZOO_GRAD_TOL})")
    print(f"zoo-train x ({TRAIN_X_LAYERS} layers at full width, B {TRAIN_B} x S {TRAIN_S}, fp32, kernels vs "
          f"backend='ref'): loss {loss:.6f} vs {loss_ref:.6f} (bound {ZOO_LOSS_RTOL} relative); largest leaf gradient "
          f"gap {worst[0]:.3e} of its scale ({worst[1]}; bound {ZOO_GRAD_TOL}); loss and gradients {t_kernel:.2f} s on "
          f"the kernels, {t_ref:.2f} s on the plain path", flush=True)
    del xmodel, params, grads, grads_ref
    torch.cuda.empty_cache()
    return {"launches": counts, "steps": TRAIN_STEPS_FULL, "layers": TRAIN_LAYERS, "step_s": warm, "peak": peak,
            "busy_ms": busy, "wall_ms": wall, "groups": groups, "flash_profiled": groups["flash_attention kernel"]}



def ledger_host_cost(torch, dev, step_ms: float) -> float:
    """The dispatch ledger's bookkeeping of one decode-shape floatsd_matmul
    call (its Decision lookup, the record and the touched bytes), timed
    over LEDGER_CALLS calls on the host, times the STEP_CALLS calls of a
    decode step, against the main path's median decode step."""
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul import cost as fm_cost

    x = torch.empty((LANES, 1024), device=dev)
    codes = torch.empty((1024, 4096), dtype=torch.uint8, device=dev)
    y = torch.empty((LANES, 4096), device=dev)
    shape = (LANES, 1024, 4096, False, False)
    stats, kd.STATS = kd.STATS, kd.DispatchStats()  # the main path's records stay as they were
    try:
        t0 = time.perf_counter()
        for _ in range(LEDGER_CALLS):
            kd._record("floatsd_matmul", "cuda", "cuda tensor", shape,
                       lambda: fm_cost.matmul_fwd_cost(*shape[:3], backend="cuda"), kd._nbytes(x, codes, y))
        per_ms = (time.perf_counter() - t0) / LEDGER_CALLS * 1e3
    finally:
        kd.STATS = stats
    share = STEP_CALLS * per_ms / step_ms
    print(f"ledger: bookkeeping {per_ms * 1e3:.3f} us a call (over {LEDGER_CALLS}); x {STEP_CALLS} calls a decode step "
          f"= {STEP_CALLS * per_ms * 1e3:.2f} us, {share:.3%} of the main path's median decode step {step_ms:.3f} ms "
          f"(bound 2%)", flush=True)
    check(share < 0.02, f"ledger: the bookkeeping takes {share:.2%} of a decode step")
    return per_ms



MESH_STEPS = 5  # phase 31: the LM's steps through the CLI's mesh (as phase 7's)
MESH_ARCH, MESH_ARCH_STEPS = "dbrx_132b", 2
MESH_PSUM_AMAX = (1e-3, 0.02, 3.5, 7.0, 1000.0)
MESH_PAIRS = 8  # warm steps of the meshed and the unsharded step, in turns


def mesh_phase(torch, dev, smi):
    """Phase 31 (module docstring)."""
    import contextlib
    import io

    import numpy as np

    from repro_torch._tree import tree_leaves
    from repro_torch.core.fp8 import cast_fp8
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.launch import train
    from repro_torch.models.task_zoo import make_task
    from repro_torch.nn.moe import record_routes
    from repro_torch.optim.grad_compress import fp8_psum
    from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step, state_shardings

    t_phase = time.perf_counter()
    wrappers = dict(zip(TRAIN_OPS, (floatsd_matmul, matmul_dx, matmul_dw, lstm_cell, lstm_cell_grad,
                                      floatsd_quantize)))
    # the LM through the CLI on its world-1 NCCL mesh
    kd.STATS.reset()
    shd.COLLECTIVES.clear()
    for w in wrappers.values():
        w.launches = 0
    out = train.main([*TRAIN_ARGS, "--steps", str(MESH_STEPS), "--log-every", str(MESH_STEPS)])
    launches = {op: w.launches for op, w in wrappers.items()}
    stats, coll = kd.STATS.snapshot(), dict(shd.COLLECTIVES)
    model, data, opt, lr, _ = make_task("wikitext2", full=True)
    L, S = model.n_layers, next(data.batches)["tokens"].shape[1]
    mats = sum(p.ndim >= 2 for p in tree_leaves(out["state"].params))
    want = {op: MESH_STEPS * n for op, n in train_counts(L, S).items()}
    want["floatsd_quantize"] = MESH_STEPS * 2 * mats
    check(launches == want, f"mesh: train launches {launches} != expected {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items()}, f"mesh: dispatch records {stats}")
    # a step: each master leaf gathered over every mesh axis its spec names (and
    # again for telemetry's update statistics), matmul_dw's x and g rows (2 a
    # layer), the tied head's x and g rows, and one f32 all-reduce
    axes = sum(len(ax) if isinstance(ax, tuple) else 1
               for s in tree_leaves(out["shardings"].params) for ax in s.spec if ax is not None)
    per_step = {"all_gather": 2 * axes + 2 * 2 * L + 2, "all_reduce": 1}
    check(coll == {k: MESH_STEPS * n for k, n in per_step.items()}, f"mesh: collectives {coll}, a step {per_step}")
    # the unsharded step from the same seed and batches, on the kernels
    policy = get_policy("floatsd8_table6")
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(SEED)), opt, policy)
    step = make_train_step(model.loss, opt, policy, lr=lr, telemetry=True)
    _, data, _, _, _ = make_task("wikitext2", full=True)
    losses = []
    for _ in range(MESH_STEPS):
        state, m = step(state, batch_to_device(next(data.batches), dev))
        losses.append(float(m["loss"]))
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(out["state"].params), tree_leaves(state.params))]
    check(losses == out["losses"] and all(same),
          f"mesh: the world-1 mesh step is not the unsharded one: losses {out['losses']} vs {losses}, "
          f"masters equal {same}")
    # one step of each profiled, on the same state and batch
    batch = batch_to_device(next(data.batches), dev)
    extra = (("nccl", "NCCL kernels"), ("memcpy", "device copies (Memcpy)"))

    def step_ms(fn, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(fn(st, batch)[1]["loss"])  # a device->host copy: synchronised
        return (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with train.process_group("cuda"):
        mesh = train.make_mesh_for_host()
        sh = state_shardings(model.specs(), state, mesh)
        mstep = make_train_step(model.loss, opt, policy, lr=lr, telemetry=True, shardings=sh)
        mstate = shd.shard_tree(state, sh)
        first_ms = step_ms(mstep, mstate)  # the new group's communicators start here
        open_s = time.perf_counter() - t0
        # warm steps of the two, in alternating order (mesh first in even pairs)
        pairs = []
        for i in range(MESH_PAIRS):
            if i % 2 == 0:
                pairs.append((step_ms(mstep, mstate), step_ms(step, state)))
            else:
                u = step_ms(step, state)
                pairs.append((step_ms(mstep, mstate), u))
        shd.COLLECTIVES.clear()
        mgroups, mwall = profile_step(torch, mstep, mstate, batch, require=TRAIN_GROUPS, extra=extra)
        one_step = dict(shd.COLLECTIVES)
        # fp8_psum over the world's group against the exact formula on the CPU
        psum = []
        for amax in MESH_PSUM_AMAX:
            x = torch.randn(1 << 16, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 41))
            x = x / x.abs().max() * amax
            got = fp8_psum(x).cpu()
            xc = x.cpu()
            s = float(np.float32(2.0 ** np.floor(np.log2(np.float64(np.float32(28672.0)
                                                                    / np.float32(float(xc.abs().max())))))))
            psum.append((amax, s, torch.equal(got.view(torch.int32),
                                              (cast_fp8(xc * s).to(torch.float32) / s).view(torch.int32))))
    check(one_step == per_step, f"mesh: a profiled step's collectives {one_step} != {per_step}")
    check(all(ok for *_, ok in psum), f"mesh: fp8_psum over the world of one rank {psum}")
    groups, wall = profile_step(torch, step, state, batch, require=TRAIN_GROUPS, extra=extra)
    busy, mbusy = (sum(ms for ms, _ in g.values()) for g in (groups, mgroups))
    comm = {k: mgroups[k] for _, k in extra}
    m_ms, u_ms = (statistics.median(p[i] for p in pairs) for i in (0, 1))
    diff_ms = statistics.median(a - b for a, b in pairs)
    # --arch dbrx_132b through the CLI on the mesh, under fp32 as phase 25
    # holds its losses (under floatsd8_table6 an FP8 flip moves them): one
    # routing group a rank
    zoo_train_counters(reset=True)
    runs = {}
    for backend in (None, "ref"):
        with kd.use_backend(backend), record_routes() as routes, contextlib.redirect_stdout(io.StringIO()):
            r = train.main(["--arch", MESH_ARCH, "--steps", str(MESH_ARCH_STEPS), "--log-every", "1",
                            "--policy", "fp32"])
        runs[backend] = (r["losses"], sorted({int(x.expert_idx.shape[0]) for x in routes}), len(routes))
        if backend is None:
            flash = zoo_train_counters()["flash_attention"]
    (lk, gk, nk), (lr_, gr, nr) = runs[None], runs["ref"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lr_))
    check(gk == gr == [1] and nk == nr > 0, f"mesh: --arch {MESH_ARCH} routing groups {gk} / {gr} in {nk} / {nr} calls")
    check(rel <= ZOO_LOSS_RTOL, f"mesh: --arch {MESH_ARCH} losses {lk} vs plain {lr_} ({rel:.3e} relative)")
    check(flash > 0, f"mesh: --arch {MESH_ARCH} ran no flash_attention launch")
    dt = time.perf_counter() - t_phase
    print(f"mesh: the LM through the CLI on an NCCL world of 1 (mesh data 1 x model 1), {MESH_STEPS} steps: losses "
          f"{out['losses']} bit for bit the unsharded step's, every master leaf equal; launches {launches} (all "
          f"cuda); collectives a step {per_step}; warm steps in {MESH_PAIRS} alternating pairs: mesh median "
          f"{m_ms:.2f} ms, unsharded {u_ms:.2f} ms, median pair difference {diff_ms:+.2f} ms (pairs "
          + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in pairs)
          + f"); the group's opening, the mesh and its first step {open_s:.2f} s (first step {first_ms:.1f} ms); "
          f"a profiled step: mesh {mbusy:.3f} ms busy of {mwall:.2f} ms wall "
          f"(NCCL kernels {comm['NCCL kernels'][0]:.3f} ms in {comm['NCCL kernels'][1]}, device copies "
          f"{comm['device copies (Memcpy)'][0]:.3f} ms in {comm['device copies (Memcpy)'][1]}), unsharded "
          f"{busy:.3f} ms busy of {wall:.2f} ms wall; by group (mesh) "
          + ", ".join(f"{k} {ms:.3f} ms ({n})" for k, (ms, n) in mgroups.items())
          + f"; --arch {MESH_ARCH} reduced {MESH_ARCH_STEPS} steps under fp32: losses {lk} vs plain {lr_} ({rel:.3e} "
          f"relative, bound {ZOO_LOSS_RTOL}), {nk} MoE calls each of {gk[0]} group, {flash} flash_attention "
          f"launches; fp8_psum (amax, scale, bit for bit) {psum}; {smi}; phase {dt:.1f} s", flush=True)
    return {"launches": {**launches, "flash_attention": flash}, "collectives": per_step, "mesh_busy_ms": mbusy,
            "busy_ms": busy, "comm": comm, "step_ms": (m_ms, u_ms, diff_ms), "seconds": dt}


DRYRUN_ARCH = "h2o_danube3_4b"
DRYRUN_ARCHS = ("h2o_danube3_4b", "stablelm_3b", "phi4_mini_3p8b", "granite_20b")
DRYRUN_WARM = 3  # warm steps of the rank-local train_4k after its cold one
# the card's peak over the dry run's argument + temp bytes, each cell's
# band around the H100 readings of this phase (1.129 and 1.001): the trace
# misses some 13% of train_4k's peak, so a drift of the analyzer's memory
# accounting shows here
DRYRUN_PEAK_BANDS = {"train_4k": (1.10, 1.16), "prefill_32k": (0.98, 1.02)}
# (name, B, Sq, Skv, H, Kh, D, causal, window, dtype, prefix): flash_attention
# at h2o_danube3_4b's tensor-parallel local shapes on the 16 x 16 mesh
DRYRUN_FLASH_CASES = [("tp-train", 16, 4096, 4096, 2, 1, 120, True, 4096, "bfloat16", 0),
                      ("tp-prefill", 2, 8192, 8192, 2, 1, 120, True, 4096, "bfloat16", 0)]
# one dry-run record in a child process: python -c DRYRUN_CHILD arch shape
# out; the fake group of 256 ranks needs a process of its own
DRYRUN_CHILD = (
    "import json, sys, torch; torch.set_num_threads(1); "
    "from repro_torch.launch.dryrun import run_cell; "
    "arch, shape, out = sys.argv[1:4]; "
    "json.dump(run_cell(arch, shape, verbose=False), open(out, 'w'))")


class _FlashShapes:
    """A dispatch observer: the Decision of every flash_attention call."""

    def __init__(self):
        self.decisions = []

    def enter(self):
        pass

    def exit(self):
        pass

    def record(self, d):
        if d.op == "flash_attention":
            self.decisions.append(d)


def dryrun_phase(torch, dev, smi):
    """Phase 32 (module docstring)."""
    import os
    import tempfile

    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.flash_attention import cost as fa_cost
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.launch.specs import build_cell, piece_shape
    from repro_torch.optim import adam
    from repro_torch.optim.train_state import init_state

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    jobs = [(a, "train_4k") for a in DRYRUN_ARCHS] + [(DRYRUN_ARCH, "prefill_32k")]
    children = [(a, sh, tmp / f"{a}__{sh}.json",
                 subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, a, sh, str(tmp / f"{a}__{sh}.json")],
                                  env=env, cwd=str(ROOT)))
                for a, sh in jobs]
    try:
        # flash_attention at the local shapes, against its plain versions
        flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
        rows = flash_phase(torch, dev, flush, DRYRUN_FLASH_CASES)
        del flush
        torch.cuda.empty_cache()
        # rank 0's programs under the fake 16 x 16 group, at full width and depth
        seen = _FlashShapes()
        out = {}
        g = torch.Generator(device=dev).manual_seed(SEED + 61)
        kd.STATS.reset()
        flash_attention.launches = 0
        kd.OBSERVERS.append(seen)
        try:
            with fake_group(256):
                mesh = make_production_mesh()
                for shape in ("train_4k", "prefill_32k"):
                    cell = build_cell(DRYRUN_ARCH, shape, mesh)
                    psh, pmeta = ((cell.in_shardings[0].params, cell.args[0].params) if cell.kind == "train"
                                  else (cell.in_shardings[0], cell.args[0]))
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    params = tree_map(lambda sh, x: torch.randn(piece_shape(sh, x.shape), generator=g, device=dev)
                                      * 0.02, psh, pmeta, is_leaf=lambda v: isinstance(v, shd.NamedSharding))
                    bshape = piece_shape(cell.in_shardings[1]["tokens"], cell.args[1]["tokens"].shape)
                    batch = {k: torch.randint(0, cell.cfg.vocab, bshape, generator=g, device=dev)
                             for k in ("tokens", "labels")}
                    first = init_state(params, adam(), cell.policy) if cell.kind == "train" else params
                    del params
                    times = []
                    for i in range(1 + DRYRUN_WARM if cell.kind == "train" else 2):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = cell.fn(first, batch)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        if cell.kind == "train":
                            first = res[0]
                        del res
                    out[shape] = {"s": times, "peak": torch.cuda.max_memory_allocated() - base,
                                  "b": bshape[0], "seq": bshape[1]}
                    del first, batch, cell
                    torch.cuda.empty_cache()
        finally:
            kd.OBSERVERS.remove(seen)
        launches = {"flash_attention": flash_attention.launches}
        stats = kd.STATS.snapshot()
    finally:
        for *_, proc in children:
            try:
                proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    recs = {}
    for a, sh, path, proc in children:
        check(proc.returncode == 0, f"dryrun: the {a} {sh} record's child exited {proc.returncode}")
        recs[(a, sh)] = json.loads(path.read_text())
        check(recs[(a, sh)]["status"] == "ok", f"dryrun: {a} {sh}: {recs[(a, sh)].get('error')}")
    # every flash launch on the kernel at the local shapes: 2 query heads over 1 KV head of 120
    L = recs[(DRYRUN_ARCH, "train_4k")]["kernel_sites"]["flash_attention/ref"] // 2
    want = {"train_4k": 2 * L * (1 + DRYRUN_WARM), "prefill_32k": 2 * L}
    check(launches["flash_attention"] == sum(want.values()) and stats == {("flash_attention", "cuda"): sum(want.values())},
          f"dryrun: flash_attention launches {launches}, dispatch {stats}, want {want}")
    costs = {fa_cost.flash_attention_cost(out[sh]["b"], out[sh]["seq"], out[sh]["seq"], 2, 1, 120, backend="cuda",
                                          causal=True, window=4096, elem_bytes=2, lse=lse)
             for sh, lse in (("train_4k", True), ("prefill_32k", False))}
    check(all(d.backend == "cuda" and d.cost in costs for d in seen.decisions) and len(seen.decisions) == sum(want.values()),
          f"dryrun: a flash_attention Decision not at the local shapes: {set(seen.decisions)}")
    print(f"dryrun: records from child processes on the host (a fake group of 256 ranks each, 16 x 16 mesh):")
    for (a, sh), r in recs.items():
        m, rf = r["memory"], r["roofline"]
        print(f"  {a} {sh} (traced in {r['compile_s']:.1f} s): per rank argument {m['argument_size_in_bytes']:,} B, "
              f"output {m['output_size_in_bytes']:,} B, temp {m['temp_size_in_bytes']:,} B; roofline (H100 datasheet "
              f"constants) compute {rf['compute_s'] * 1e3:.2f} ms, memory {rf['memory_s'] * 1e3:.2f} ms, collective "
              f"{rf['collective_s'] * 1e3:.2f} ms, dominant {rf['dominant']}; useful FLOP ratio "
              f"{r['useful_flops_ratio']}; {r['collective_count']} collectives, {r['collective_wire_bytes']:,.0f} wire B",
              flush=True)
    mem = {}
    for sh in ("train_4k", "prefill_32k"):
        m = recs[(DRYRUN_ARCH, sh)]["memory"]
        pred = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        mem[sh] = (out[sh]["peak"], pred, out[sh]["peak"] / pred)
        lo, hi = DRYRUN_PEAK_BANDS[sh]
        check(lo <= mem[sh][2] <= hi, f"dryrun: {sh} peak {out[sh]['peak']:,} B over the dry run's argument + temp "
                                      f"{pred:,} B is {mem[sh][2]:.3f}, outside [{lo}, {hi}]")
    warm = statistics.median(out["train_4k"]["s"][1:])
    dt = time.perf_counter() - t_phase
    print(f"dryrun: rank 0 of the fake 16 x 16 group on the card, {DRYRUN_ARCH} at full width and depth: train_4k "
          f"B {out['train_4k']['b']} x S {out['train_4k']['seq']} a rank, cold step {out['train_4k']['s'][0]:.2f} s, "
          f"warm steps {', '.join(f'{t:.2f}' for t in out['train_4k']['s'][1:])} s (median {warm:.3f} s); "
          f"prefill_32k B {out['prefill_32k']['b']} x S {out['prefill_32k']['seq']} a rank: "
          f"{', '.join(f'{t:.2f}' for t in out['prefill_32k']['s'])} s; max_memory_allocated vs the dry run's "
          f"argument + temp: " + "; ".join(f"{sh} {p:,} B vs {q:,} B (ratio {r:.3f})" for sh, (p, q, r) in mem.items())
          + f"; flash_attention launches {launches['flash_attention']} (all cuda, q [B, S, 2, 120] over 1 KV head; "
          f"want {want}); {smi}; phase {dt:.1f} s (children {max(r.get('compile_s', 0) for r in recs.values()):.1f} s "
          f"of trace at most)", flush=True)
    return {"launches": launches, "rows": rows, "records": recs, "memory": mem, "warm_s": warm, "seconds": dt}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository (src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import lstm_wikitext2
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.lstm_cell.ops import lstm_cell
    from repro_torch.models import build
    from repro_torch.serving import synthetic_prompts

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()} | {smi} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s (sm_90a)", flush=True)
    for op in _build.KERNELS:
        print(f"  {op}: " + "; ".join(ptxas_report(_build.build_log(op))))
    tensor_ops = sass_count(_build, "flash_attention", ("HGMMA", "HMMA"))
    if tensor_ops is not None:
        check(tensor_ops["HGMMA"] > 0, f"flash_attention: no wgmma (HGMMA) in its SASS: {tensor_ops}")
    print(f"  flash_attention SASS (cuobjdump): {tensor_ops if tensor_ops is not None else 'cuobjdump not found'}")

    # 3. kernels against their plain versions
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    one = torch.zeros(1, device=dev)
    floor_ms = timed_ms(torch, lambda: torch.neg(one), 50, flush)
    print(f"kernels: timing floor {floor_ms:.4f} ms (the timer below around a one-element torch.neg)", flush=True)
    mm, cell, dx, dw, cell_bwd = kernel_phase(torch, dev, flush, floor_ms)
    mm4, quant, qsig = kernel_phase4(torch, dev, flush, floor_ms)
    t0 = time.perf_counter()
    plane = plane_phase(torch, dev, flush)
    print(f"kernels: floatsd4_matmul's layer planes in {time.perf_counter() - t0:.1f} s", flush=True)
    wkv = wkv_phase(torch, dev, flush)
    zmm = zoo_matmul_phase(torch, dev, flush)
    dmm = zoo_matmul_phase(torch, dev, flush, DENSE_ARCH, DENSE_MM_SITES, SEED + 5)
    fa = flash_phase(torch, dev, flush)
    t0 = time.perf_counter()
    fa_train = flash_train_phase(torch, dev, flush)
    wkv_train = wkv_train_phase(torch, dev, flush)
    print(f"kernels: flash_attention's and rwkv_wkv's training rows in {time.perf_counter() - t0:.1f} s", flush=True)
    task_rows, task_steps = task_kernel_phase(torch, dev, flush)
    del flush
    ledger_phase(smi)
    mirror_phase(torch, _build)

    # 4. the main path at full width
    cfg = lstm_wikitext2.CONFIG
    model = build(cfg)
    policy = get_policy("floatsd8_table6")
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = synthetic_prompts(REQUESTS, cfg.vocab, np.random.default_rng(SEED))
    check(model._vp() == 33280 and params["embed"]["table"].shape == (33280, 1024), "model width")
    kd.STATS.reset()
    floatsd_matmul.launches = 0
    lstm_cell.launches = 0
    decode_times: list[float] = []
    eng, reqs = serve(torch, model, params, policy, prompts, step_times=decode_times)
    launches = {"floatsd_matmul": floatsd_matmul.launches, "lstm_cell": lstm_cell.launches}
    stats = kd.STATS.snapshot()
    m = eng.metrics
    s = eng.store
    print(f"main path: weights {s.dense_nbytes / 2**20:.1f} MiB dense -> {s.packed_nbytes / 2**20:.1f} MiB "
          f"packed FloatSD8 ({s.n_packed} tensors); {m.format()}", flush=True)
    check(all(r.status == "done" and len(r.out) == MAX_NEW for r in reqs), "requests not all done")
    check(m.numeric_errors == 0, "nonfinite logits on the main path")
    positions = CHUNK * m.prefill_steps + m.decode_steps  # block width S, summed over steps
    want = {"floatsd_matmul": 2 * cfg.n_layers * positions + m.steps,
            "lstm_cell": cfg.n_layers * positions}
    check(launches == want, f"launches {launches} != expected {want}")
    check(stats.get(("floatsd_matmul", "cuda"), 0) == want["floatsd_matmul"]
          and stats.get(("lstm_cell", "cuda"), 0) == want["lstm_cell"]
          and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"dispatch records {stats}")
    step_ms = statistics.median(decode_times) * 1e3
    print(f"main path: {m.report()['gen_tok_per_s']:.1f} generated tok/s, "
          f"{m.report()['total_tok_per_s']:.1f} total tok/s, median decode step {step_ms:.3f} ms "
          f"over {len(decode_times)} steps ({LANES} lanes; {smi}); launches {launches}; "
          f"dispatch {dict((f'{o}/{b}', n) for (o, b), n in stats.items())}", flush=True)
    ledger_host_cost(torch, dev, step_ms)

    # 5. cross-check against the plain versions on the card
    _, refs = serve(torch, model, params, policy, prompts, backend="ref")
    cross_check(reqs, refs, "cross-check")

    # 6. the FloatSD4 store
    serve8 = dict(packed_nbytes=s.packed_nbytes, step_ms=step_ms, gen_tok_s=m.report()["gen_tok_per_s"],
                  tree=eng.store.tree)
    s4 = serve4_phase(torch, model, params, policy, prompts, serve8, smi)
    del serve8, eng

    # 7-8. training
    tr = train_phase(torch, smi)
    tr_launches = tr["launches"]

    # 9. the paper's other three tasks
    tasks = tasks_phase(torch, smi)

    # 10. the element-wise entry points on the trained masters
    ent = entry_phase(torch, tr["params"], tr["batch"])
    del tr

    # 11. the training runtime: save-z, resume, telemetry, the training ops
    rt = runtime_phase(torch, smi)

    # 12-13. the model zoo: rwkv6_3b at full width, then its kernel-vs-plain cross-check
    torch.cuda.empty_cache()
    zoo = zoo_phase(torch, dev, smi)
    zoo_x_phase(torch, dev, smi)

    # 14-15. the dense family: h2o_danube3_4b at full width (the RWKV trees
    # are freed), then its kernel-vs-plain cross-check
    torch.cuda.empty_cache()
    dense = dense_phase(torch, dev, smi)
    dense_x_phase(torch, dev, smi)

    # 16. the serving frontend: the main path's model behind the router
    torch.cuda.empty_cache()
    front = frontend_phase(torch, model, params, policy, smi)

    # 17. the HTTP/SSE service over the router, and the CLI's --http
    http = http_phase(torch, model, params, policy, smi, front)

    # 18-19. the hybrid family: jamba_v01_52b at full width, one period (the
    # main path's model freed), then its kernel-vs-plain cross-check
    del model, params, s
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hybrid, hmodel, hstore = hybrid_phase(torch, dev, smi)
    print(f"hybrid: phase 18 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    hybrid_x_phase(torch, dev, smi, hmodel, hstore)
    del hstore
    torch.cuda.empty_cache()
    print(f"hybrid-x: phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 20. the moe family's reduced configs against the plain path
    t0 = time.perf_counter()
    moe = moe_phase(torch, dev, smi)
    print(f"moe: phase 20 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 21-22. the audio family: whisper_large_v3 at full width through its own
    # entry points, then its kernel-vs-plain cross-check
    t0 = time.perf_counter()
    audio = audio_phase(torch, dev, smi)
    print(f"audio: phase 21 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    audio_x_phase(torch, dev, smi)
    print(f"audio-x: phase 22 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 23-24. the vlm family: qwen2_vl_2b at full width, then its kernel-vs-plain cross-check
    t0 = time.perf_counter()
    vlm = dense_phase(torch, dev, smi, VLM_ARCH, "vlm", VLM_BYTES, VLM_LEAVES, VLM_KV_BYTES)
    print(f"vlm: phase 23 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dense_x_phase(torch, dev, smi, VLM_ARCH, "vlm-x")
    print(f"vlm-x: phase 24 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 25-26. the zoo's training: every family's reduced config against the
    # plain path and through the CLI, then h2o_danube3_4b at full width
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ztx = zoo_train_x_phase(torch, dev, smi)
    print(f"zoo-train-x: phase 25 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    zt = zoo_train_phase(torch, dev, smi, fa_train)
    print(f"zoo-train: phase 26 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 27-28. FloatSD4 serving of a stacked model: h2o_danube3_4b at full width
    # and depth from its FloatSD4 store (the layer planes), then 2 layers
    # against the plain path
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dense4 = dense_phase(torch, dev, smi, DENSE_ARCH, "dense4", DENSE4_BYTES, 10, DENSE_KV_BYTES, fmt="floatsd4",
                         tol=DENSE4_TOL)
    print(f"dense4: phase 27 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dense_x_phase(torch, dev, smi, DENSE_ARCH, "dense4-x", fmt="floatsd4")
    print(f"dense4-x: phase 28 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 29. every other family from its FloatSD4 store against the plain path
    t0 = time.perf_counter()
    f4x = family4_x_phase(torch, dev, smi)
    print(f"family4-x: phase 29 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 30. stablelm_3b, phi4_mini_3p8b and granite_20b (both formats) at their
    # published widths and depths
    t0 = time.perf_counter()
    d84 = dense84_phase(torch, dev, smi)
    print(f"dense84: phase 30 in {time.perf_counter() - t0:.1f} s", flush=True)

    # 31. the training CLI on its device mesh (an NCCL world of one rank)
    torch.cuda.empty_cache()
    mesh = mesh_phase(torch, dev, smi)

    # 32. the production-mesh dry run, and rank 0's share of it on the card
    torch.cuda.empty_cache()
    dry = dryrun_phase(torch, dev, smi)

    # result lines: each kernel's time per decode step (serving), per train
    # step, or per entry-point pass, from the kernel phase's per-launch times
    # and the launch counts of each path
    L, S = cfg.n_layers, 48
    ZL = zoo["prefill"]["launches"]["rwkv_wkv"]  # the zoo's layers
    DL = dense["prefill"]["launches"]["flash_attention"]  # the dense model's layers
    serve_mm = [(2 * L, mm[("gate", 8)]), (1, mm[("head", 8)])]
    train_mm = [(2 * L * S, mm[("gate", 64)]), (2 * L, mm[("remat", 3072)])]
    entries = [
        ("floatsd_matmul", "floatsd_matmul/floatsd_matmul.cu", "floatsd_matmul/kernel.py:34",
         mm.values(), serve_mm,
         "decode step at 8 lanes: 4 x [8,1024]@[1024,4096] + [8,1024]@[33280,1024]^T",
         train_mm, "train step: 192 x [64,1024]@[1024,4096] + 4 x [3072,1024]@[1024,4096]"),
        ("lstm_cell", "lstm_cell/lstm_cell.cu", "lstm_cell/kernel.py:45", cell.values(),
         [(L, cell[(8, 1024)])], "decode step at 8 lanes: 2 x z [8,4096], c [8,1024] fp16",
         [(L * S, cell[(64, 1024)])], "train step: 96 x z [64,4096], c [64,1024] fp16"),
        ("floatsd_matmul_dx", "floatsd_matmul/floatsd_matmul.cu", "floatsd_matmul/bwd.py:48",
         dx.values(), None, None, [(L * S, dx[64]), (L, dx[3072])],
         "train step: 96 x [64,4096]@codes[1024,4096]^T + 2 x [3072,4096]@codes[1024,4096]^T"),
        ("floatsd_matmul_dw", "floatsd_matmul/floatsd_matmul_dw.cu", "floatsd_matmul/bwd.py:74",
         dw.values(), None, None, [(2 * L, dw[True])],
         "train step: 4 x e5m2([3072,1024]^T @ [3072,4096]); library: torch.matmul(x.t(), g), no snap"),
        ("lstm_cell_grad", "lstm_cell/lstm_cell_bwd.cu", "lstm_cell/bwd.py:75", cell_bwd.values(),
         None, None, [(L * S, cell_bwd[(64, 1024)])],
         "train step: 96 x z [64,4096], c_prev/dh/dc [64,1024] -> dz, dc_prev"),
        ("floatsd4_matmul", "floatsd4_matmul/floatsd4_matmul.cu", "floatsd4_matmul/kernel.py:29",
         [*mm4.values(), *plane.values()], [(2 * L, mm4[("gate", 8)]), (1, mm4[("head", 8)])],
         "FloatSD4 decode step at 8 lanes: 4 x [8,1024]@[1024,4096] + [8,1024]@table[33280,1024]^T "
         "(transposed mode)", None, None),
        ("floatsd_quantize", "floatsd_quantize/floatsd_quantize.cu", "floatsd_quantize/kernel.py:32",
         quant.values(), [(1, quant["table16"]), (2 * L, quant["weight16"])],
         "entry: dispatch.quantize on the 5 trained fp16 masters, [33280,1024] + 4 x [1024,4096]",
         [(2, quant["table16"]), (2 * 2 * L, quant["weight16"])],
         "train step's telemetry: 2 x ([33280,1024] + 4 x [1024,4096]) fp16, the old and new masters"),
        ("qsigmoid", "qsigmoid/qsigmoid.cu", "qsigmoid/kernel.py:28", qsig.values(),
         [(1, qsig[(64, 4096)])], "entry: dispatch.qsigmoid on a [64,4096] f32 gate block", None, None),
        ("rwkv_wkv", "rwkv_wkv/rwkv_wkv.cu", "rwkv_wkv/kernel.py:27", wkv.values(),
         [(ZL, wkv[(ZOO_S, -2.0)])], f"zoo prefill at B {ZOO_B} x S {ZOO_S}: {ZL} x r, k, w [2,1024,40,64], "
         "v [2,1024,40,64] -> y, final state; library call: none", None, None),
        ("flash_attention", "flash_attention/flash_attention.cu", "flash_attention/kernel.py:27",
         [*fa.values(), *fa_train.values(), *dry["rows"].values()],
         [(DL, fa["prefill"])], f"dense prefill at B {ZOO_B} x S {ZOO_S}: {DL} x q [2,1024,32,120], k, v "
         "[2,1024,8,120] f32, causal (window 4096 inactive); library: scaled_dot_product_attention(is_causal=True, "
         "enable_gqa=True)", None, None),
    ]
    paths = {"serve": launches, "train": tr_launches, "tasks": tasks["launches"], "serve4": s4["launches"],
             "entry": ent["launches"], "runtime": rt["launches"], "zoo": zoo["launches"],
             "dense": dense["launches"], "frontend": front["launches"], "http": http["launches"],
             "hybrid": hybrid["launches"], "moe": moe["launches"], "audio": audio["launches"],
             "vlm": vlm["launches"], "zoo_train_x": ztx["launches"], "zoo_train": zt["launches"],
             "dense4": dense4["launches"], "family4_x": f4x["launches"], "mesh": mesh["launches"],
             "dryrun": dry["launches"],
             **{arch: r["launches"] for arch, r in d84.items()}}
    # the zoo prefill's share of the kernels it shares with the LSTM paths
    zoo_prefill = {
        "floatsd_matmul": ([(6 * ZL, zmm[("dd", ZOO_B * ZOO_S)]), (ZL, zmm[("cmix-k", ZOO_B * ZOO_S)]),
                            (ZL, zmm[("cmix-v", ZOO_B * ZOO_S)]), (1, zmm[("head", ZOO_B * ZOO_S)])],
                           f"zoo prefill: {6 * ZL} x [2048,2560]@[2560,2560] + {ZL} x [2048,2560]@[2560,8960] "
                           f"+ {ZL} x [2048,8960]@[8960,2560] + [2048,2560]@[65536,2560]^T"),
        "qsigmoid": ([(2 * ZL, qsig[(2, 1024, 2560)])], f"zoo prefill: {2 * ZL} x [2,1024,2560] f32 gates"),
    }
    zoo_decode = ([(6 * ZL, zmm[("dd", ZOO_LANES)]), (ZL, zmm[("cmix-k", ZOO_LANES)]),
                   (ZL, zmm[("cmix-v", ZOO_LANES)]), (1, zmm[("head", ZOO_LANES)])],
                  f"zoo decode step at {ZOO_LANES} lanes: the same {ZOO_SITES * ZL + 1} sites at M = {ZOO_LANES}")
    record = {"kernels": []}
    for name, src, repl, rows, parts, per, train_parts, train_per in entries:
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        parts, per = (parts, per) if parts else (train_parts, train_per)
        shapes = [r for (op, *_), r in task_rows.items() if op == name]
        rec = {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{src}",
               "replaces": f"src/repro/kernels/{repl}", "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": max(v["err"] for v in [*rows, *shapes]), **composite(parts), "per": per}
        if name in TRAIN_GROUPS:
            # a train step of each task: the per-launch rows at its shapes
            # times its launches, and the profiled step's device time
            rec["task_steps"] = {
                t: {**task_steps[t][name], "launches": tasks["tasks"][t]["launches"][name] // TASK_STEPS,
                    "profiled_ms": tasks["tasks"][t]["groups"][name][0],
                    "per": f"{t} train step, B {tasks['tasks'][t]['b']} x S {tasks['tasks'][t]['s']}, "
                           f"{tasks['tasks'][t]['calls']} engine calls"}
                for t in TASK_NAMES}
        if name == "floatsd_matmul":
            rec["route_a_vs_b"] = [
                {"shape": list(key[1:]), "route_a_ms": r["ms"], "route_b_ms": r["route_b_ms"]}
                for key, r in task_rows.items() if key[0] == name and "route_b_ms" in r]
        if train_parts and parts is not train_parts:
            rec["train_step"] = {**composite(train_parts), "per": train_per}
        if name == "floatsd_matmul":
            rec["train_step_save_z"] = {**composite(train_mm[:1]),
                                        "per": "train step, --save-z: 192 x [64,1024]@[1024,4096]"}
        if name in zoo_prefill:
            z_parts, z_per = zoo_prefill[name]
            rec["zoo_prefill"] = {**composite(z_parts), "per": z_per}
        if name == "floatsd_matmul":
            rec["zoo_decode_step"] = {**composite(zoo_decode[0]), "per": zoo_decode[1]}
            for key, m, what in (("dense_prefill", ZOO_B * ZOO_S, f"dense prefill at B {ZOO_B} x S {ZOO_S}"),
                                 ("dense_decode_step", ZOO_LANES, f"dense decode step at {ZOO_LANES} lanes")):
                parts = [(2 * DL, dmm[("wq-wo", m)]), (2 * DL, dmm[("wk-wv", m)]), (2 * DL, dmm[("wi-wg", m)]),
                         (DL, dmm[("ffn-wo", m)]), (1, dmm[("head", m)])]
                rec[key] = {**composite(parts), "per": f"{what}: {DENSE_SITES * DL + 1} sites at M = {m}"}
        if name == "floatsd4_matmul":
            # the layer planes of the dense family's stacked leaves, at its prefill and its 8-lane decode step
            for key, m, what in (("dense4_prefill", ZOO_B * ZOO_S, f"dense4 prefill at B {ZOO_B} x S {ZOO_S}"),
                                 ("dense4_decode_step", ZOO_LANES, f"dense4 decode step at {ZOO_LANES} lanes")):
                parts = [(2 * DL, plane[("wq-wo", m)]), (2 * DL, plane[("wk-wv", m)]),
                         (2 * DL, plane[("wi-wg", m)]), (DL, plane[("ffn-wo", m)]), (1, plane[("head", m)])]
                rec[key] = {**composite(parts), "per": f"{what}: {DENSE_SITES * DL} layer-plane sites + the head "
                                                      f"(the transposed table) at M = {m}"}
        if name == "rwkv_wkv":
            rec["train_backward_plain_ms"] = wkv_train["bwd_plain_ms"]
        if name == "flash_attention":
            rec["zoo_train_step"] = {
                **composite([(2 * TRAIN_LAYERS, fa_train["train-window"])]), "profiled_ms": zt["flash_profiled"],
                "per": f"full-width {TRAIN_ARCH} train step at {TRAIN_LAYERS} layers, B {TRAIN_B} x S {TRAIN_S}: "
                       f"{2 * TRAIN_LAYERS} x q [1,8192,32,120] with lse (forward + remat recompute), window 4096; "
                       f"the backward plain PyTorch ({fa_train['train-window']['bwd_plain_ms']:.2f} ms a layer); "
                       "library: SDPA's forward (attn_mask=band)"}
        for key, path in (("zoo_prefill_profiled", zoo), ("dense_prefill_profiled", dense),
                          ("hybrid_prefill_profiled", hybrid), ("audio_prefill_profiled", audio),
                          ("vlm_prefill_profiled", vlm), ("dense4_prefill_profiled", dense4),
                          *((f"{arch}_prefill_profiled", r) for arch, r in d84.items())):
            ms, n = path["prefill"]["profile"].get(name, (0.0, 0))
            if n:
                rec[key] = {"device_ms": ms, "kernels": n}
        record["kernels"].append(rec)
    check(all(k["launches"] > 0 for k in record["kernels"]), "a kernel never launched on the main path")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
