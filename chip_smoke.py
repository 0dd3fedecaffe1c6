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

The second-to-last line is nvidia-smi's name/power-limit line, the line
before it the kernels' JSON record, and the last line the result JSON.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

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
    return row


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
    return row


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
    return row


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
    return row


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
    return row


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
        mm4[(site, m)] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=err, route=p.route, **bd)
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
        quant[name] = dict(ms=t, plain_ms=t_plain, library_ms=None, err=0.0, **bd)
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
        qsig[shape] = dict(ms=t, plain_ms=t_plain, library_ms=None, err=err, bf16_differ=n_bf, **bd)
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


def profile_step(torch, step_fn, state, batch, gemm="library GEMM (tied head)", require=None):
    """One train step under torch.profiler: device time (ms) and launches
    by kernel group, and the step's wall time (ms) in the same window.
    ``require``: the groups that must have run (default: all of them)."""
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
    names = [("floatsd_matmul_ordered_kernel<false", "floatsd_matmul"),
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


def cross_check(reqs, refs, what: str) -> None:
    """Greedy tokens of the kernel path against the plain path, over each
    request's margin-decisive prefix (phases 5 and 6)."""
    import numpy as np

    decisive = agree = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(ref.margins) if g <= MARGIN_FLOOR), MAX_NEW)
        check(r.out[:n] == ref.out[:n], f"{what}: request {r.rid}: {r.out} vs plain {ref.out} (decisive {n})")
        decisive += n
        agree += r.out == ref.out
    check(decisive >= REQUESTS * MAX_NEW // 2, f"{what}: only {decisive} decisive tokens")
    margins = np.array([g for ref in refs for g in ref.margins])
    print(f"{what}: {decisive} of {REQUESTS * MAX_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) "
          f"and equal; {agree} of {REQUESTS} streams equal in full; top-2 margin median "
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
        rows[(s, w0)] = dict(ms=t, plain_ms=t_plain, library_ms=None, err=err, **bd)
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
            rows[(site, m)] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=err, route=route, **bd)
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


def zoo_decode(torch, model, tree, toks, policy, late: int = 0):
    """Sequence 0's first ZOO_DECODE tokens through decode_step one at a
    time (an attention model's KV cache holds them all): (logits
    [ZOO_DECODE, vocab], wall time of each step). ``late`` > 0 starts an
    attention model's cache that many positions late, a negative control:
    its unwritten slots then count as keys."""
    out, times = [], []
    with torch.no_grad():
        cache = model.init_cache(1, policy, toks.device, cache_len=ZOO_DECODE)
        if late:
            kv = cache["stack"]["b0"]
            cache = {**cache, "stack": {"b0": kv._replace(pos=kv.pos + late)}}
        for t in range(ZOO_DECODE):
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


def zoo_counters(reset: bool = False) -> dict:
    """Launch counts of the zoo paths' kernels (zeroed when ``reset``)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.qsigmoid.ops import qsigmoid
    from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv

    wrappers = {"floatsd_matmul": floatsd_matmul, "qsigmoid": qsigmoid, "rwkv_wkv": rwkv_wkv,
                "flash_attention": flash_attention}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {op: w.launches for op, w in wrappers.items()}


def zoo_build(torch, dev, n_layers=None, arch="rwkv6_3b"):
    """``arch`` (or its first ``n_layers``) from seed 0, packed to FloatSD8;
    the f32 tree is freed before anything is served."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import WeightStore

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    store = WeightStore.pack(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, model, store, time.perf_counter() - t0


def zoo_serve(torch, model, tree, policy, prompts, backend=None, cache_len=None):
    """ServeEngine over the packed store: lanes in lockstep, one token a
    step; returns (engine, requests by rid, decode-step wall times)."""
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, tree, policy, lanes=ZOO_LANES, backend=backend, cache_len=cache_len)
    reqs = eng.submit_all([p.copy() for p in prompts], max_new=ZOO_MAX_NEW)
    times = []
    eng.metrics.start()
    while True:
        t0 = time.perf_counter()
        if not eng.step_once():  # ends in a device->host copy: synchronised
            break
        times.append(time.perf_counter() - t0)
    eng.metrics.stop()
    return eng, sorted(reqs, key=lambda r: r.rid), times


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
    groups, wall_prof = profile_prefill(torch, model, tree, toks, pol)
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
    decisive = agree = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(ref.margins) if g <= MARGIN_FLOOR), ZOO_MAX_NEW)
        check(r.out[:n] == ref.out[:n], f"zoo-x: request {r.rid}: {r.out} vs plain {ref.out} (decisive {n})")
        decisive += n
        agree += r.out == ref.out
    check(decisive >= ZOO_LANES * ZOO_MAX_NEW // 2, f"zoo-x: only {decisive} decisive tokens")
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
FLASH_Q_SCALE = 2.0  # q ~ N(0, 4): scores of std 2 (a peaked attention, as a trained model's)
# (name, B, S, H, Kh, D, causal, window, dtype): the dense prefill (the
# window of 4096 inactive at S 1024), the window biting, a ragged S, no
# causal mask, bf16
FLASH_CASES = [("prefill", ZOO_B, ZOO_S, 32, 8, 120, True, 4096, "float32"),
               ("window", 1, 8192, 32, 8, 120, True, 4096, "float32"),
               ("ragged", ZOO_B, 1000, 32, 8, 120, True, 4096, "float32"),
               ("full", ZOO_B, ZOO_S, 32, 8, 120, False, None, "float32"),
               ("bf16", ZOO_B, ZOO_S, 32, 8, 120, True, 4096, "bfloat16")]


def attend_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks admit, positions from 0."""
    total = 0
    for i in range(sq):
        hi = min(skv - 1, i) if causal else skv - 1
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


def flash_oracle(torch, q, k, v, causal, window, heads_per_call=4):
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
                                causal, window)
        out[:, :, h0:h0 + len(hs)] = o.reshape(b, len(hs), sq, d).permute(0, 2, 1, 3)
    return out


def flash_phase(torch, dev, flush):
    """Phase 3, continued: the flash_attention kernel against its plain
    versions (the oracle and the model's chunked online softmax) at the
    dense prefill's shape, where the window bites, at a ragged S, without
    the causal mask and on bf16; two launches bit-identical; the oracle
    without the window, at the window's shape, rejected."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import _mask, flash_attention_gqa
    from repro_torch.kernels.floatsd_matmul.ref import no_tf32

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = {}
    print(f"kernels: flash_attention vs the oracle and the chunked plain version (|err| <= atol + rtol |want|: "
          f"f32 {FLASH_TOL['float32']}, bf16 {FLASH_TOL['bfloat16']}; q ~ N(0, {FLASH_Q_SCALE ** 2:g}))")
    for name, b, s, h, kh, d, causal, window, dt in FLASH_CASES:
        dt = getattr(torch, dt)
        q = (torch.randn((b, s, h, d), device=dev, generator=g) * FLASH_Q_SCALE).to(dt)
        k, v = (torch.randn((b, s, kh, d), device=dev, generator=g).to(dt) for _ in range(2))
        o = flash_attention(q, k, v, causal=causal, window=window)
        o2 = flash_attention(q, k, v, causal=causal, window=window)
        oracle = flash_oracle(torch, q, k, v, causal, window)
        plain = flash_attention_gqa(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(torch.equal(o, o2), f"flash_attention {name}: two launches differ")
        atol, rtol = FLASH_TOL[str(dt).split(".")[-1]]
        errs = {}
        for ref_name, want in (("oracle", oracle), ("plain", plain)):
            e = (o.float() - want.float()).abs()
            beyond = int((e > atol + rtol * want.float().abs()).sum())
            check(beyond == 0, f"flash_attention {name}: {beyond} outputs beyond the bound against the {ref_name} "
                               f"(max err {float(e.max()):.3e})")
            errs[ref_name] = (float(e.max()), int((o != want).sum()))
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
        t = timed_ms(torch, lambda: flash_attention(q, k, v, causal=causal, window=window), 10, flush)
        with no_tf32():
            t_plain = timed_ms(torch, lambda: flash_attention_gqa(q, k, v, causal=causal, window=window), 3, flush)
            # the library yardstick: SDPA on the heads-major layout; where the
            # window bites, its band as a boolean mask
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            if window is None or window >= s:
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
        pairs = b * h * attend_pairs(s, s, causal, window)
        bd = bound(q.element_size() * (2 * q.numel() + k.numel() + v.numel()), flash_ops(pairs * d, q, k))
        rows[name] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=max(e for e, _ in errs.values()), **bd)
        print(f"  {name:8s} q [{b},{s},{h},{d}], k, v [{b},{s},{kh},{d}] {str(dt)[6:]}, causal {causal}, window "
              f"{window}: vs oracle max_abs_err {errs['oracle'][0]:.3e} ({errs['oracle'][1]} of {o.numel()} not "
              f"bit-identical), vs plain {errs['plain'][0]:.3e} ({errs['plain'][1]} not bit-identical); |o| max "
              f"{float(oracle.float().abs().max()):.3f}; two launches bit-identical"
              + (f"; without the window {caught:.2%} beyond the bound" if caught is not None else "")
              + (f"; vs plain {precision:.3f} of the error of one bf16 pass of the scores (bound 0.25)"
                 if name == "prefill" else "")
              + f" | kernel {t:.4f} ms, plain {t_plain:.3f} ms, "
              + f"SDPA ({lib_call}, enable_gqa; 0 beyond the bound of the oracle) {t_lib:.4f} ms"
              + f", {pairs * d * 4 / 1e9:.2f} GFLOP, {fmt_bound(bd)}", flush=True)
        del q, k, v, o, o2, oracle, plain
    torch.cuda.empty_cache()
    return rows


def profile_prefill(torch, model, tree, toks, policy):
    """One prefill under torch.profiler: device time (ms) and launches by
    kernel group, and the wall time (ms) of the same call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(tree, {"tokens": toks}, policy)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = [("flash_fwd_kernel", "flash_attention"), ("flash_split_kv", "flash_attention"),
             ("rwkv_wkv_kernel", "rwkv_wkv"), ("wkv_chunk_prep", "rwkv_wkv"), ("qsigmoid_kernel", "qsigmoid"),
             ("floatsd_matmul_", "floatsd_matmul"), ("add_partials", "floatsd_matmul"),
             ("split_pieces", "floatsd_matmul")]
    groups = {g: [0.0, 0] for _, g in names + [("", "other torch ops")]}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        grp = next((grp for key, grp in names if key in e.key), "other torch ops")
        groups[grp][0] += e.self_device_time_total / 1e3
        groups[grp][1] += e.count
    return {grp: v for grp, v in groups.items() if v[1]}, wall


def dense_phase(torch, dev, smi):
    """Phase 14: full-width h2o_danube3_4b, packed, prefilled, decoded and
    served."""
    import numpy as np

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.serving import synthetic_prompts

    held = torch.cuda.memory_allocated()
    cfg, model, store, t_build = zoo_build(torch, dev, arch=DENSE_ARCH)
    L = cfg.n_layers
    print(f"dense: {cfg.name} ({L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} over "
          f"{cfg.kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}) from seed {SEED}: "
          f"{store.dense_nbytes} B f32 -> {store.packed_nbytes} B packed FloatSD8 ({store.n_packed} leaves) in "
          f"{t_build:.1f} s; {held} B held on the card before the build (the RWKV trees freed)", flush=True)
    check(store.packed_nbytes == DENSE_BYTES and store.n_packed == 10,
          f"dense resident bytes {store.packed_nbytes} != {DENSE_BYTES} ({store.n_packed} leaves packed)")
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")
    tree = model.hoist(store.tree)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (ZOO_B, ZOO_S)), device=dev)
    n_sites = DENSE_SITES * L + 1
    out = {}

    kd.STATS.reset()
    zoo_counters(reset=True)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = model.prefill(tree, {"tokens": toks}, pol)
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    want = {"floatsd_matmul": n_sites, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": L}
    check(launches == want, f"dense prefill launches {launches} != {want}")
    check(stats == {(op, "cuda"): n for op, n in want.items() if n}, f"dense prefill dispatch records {stats}")
    check(tuple(logits.shape) == (ZOO_B, ZOO_S, cfg.vocab_padded()) and bool(torch.isfinite(logits).all()),
          f"dense prefill logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    with torch.no_grad():
        t0 = time.perf_counter()
        model.prefill(tree, {"tokens": toks}, pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, wall_prof = profile_prefill(torch, model, tree, toks, pol)
    busy = sum(ms for ms, _ in groups.values())
    out["prefill"] = dict(launches=launches, wall_s=wall, tok_s=ZOO_B * ZOO_S / wall, profile=groups)
    print(f"dense prefill: B {ZOO_B} x S {ZOO_S}: {wall * 1e3:.1f} ms wall ({wall_first * 1e3:.1f} ms the first), "
          f"{ZOO_B * ZOO_S / wall:.0f} tok/s ({smi}); launches {launches} (per layer {DENSE_SITES} weight sites, "
          f"1 attention; + the head); dispatch {dict((f'{o}/{b}', n) for (o, b), n in stats.items())}; logits "
          f"finite, |max| {float(logits.abs().max()):.3f}. Profiled prefill: {wall_prof:.1f} ms wall, device busy "
          f"{busy:.1f} ms: " + ", ".join(f"{grp} {ms:.1f} ms ({n} kernels)" for grp, (ms, n) in groups.items()),
          flush=True)

    kd.STATS.reset()
    zoo_counters(reset=True)
    dec, times = zoo_decode(torch, model, tree, toks, pol)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    with torch.no_grad():
        cache = model.init_cache(1, pol, dev, cache_len=ZOO_DECODE)
        n_ops = torch_ops(torch, lambda: model.decode_step(tree, toks[:1, :1], cache, pol))
        del cache
    want = {"floatsd_matmul": n_sites * ZOO_DECODE, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": 0}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"dense decode launches {launches} != {want}; dispatch {stats}")
    check(bool(torch.isfinite(dec).all()), "dense decode: nonfinite logits")
    served = positions_gap(torch, dec, logits[0, :ZOO_DECODE], DENSE_TOL)
    fp32 = get_policy("fp32")
    with torch.no_grad():
        ref32 = model.prefill(tree, {"tokens": toks[:1, :ZOO_DECODE]}, fp32)[0]
    dec32, _ = zoo_decode(torch, model, tree, toks, fp32)
    plain = positions_gap(torch, dec32, ref32, DENSE_TOL)
    check(plain["max"] <= DENSE_TOL, f"dense decode vs prefill, no activation quantizer: max err {plain['max']:.3e} "
                                     f"of the scale {plain['scale']:.3f} (bound {DENSE_TOL})")
    late, _ = zoo_decode(torch, model, tree, toks, fp32, late=1)
    control = positions_gap(torch, late, ref32, DENSE_TOL)
    check(control["max"] > DENSE_TOL, f"dense decode: the bound {DENSE_TOL} does not reject a cache one position "
                                      f"late (max err {control['max']:.3e} of the scale)")
    step = statistics.median(times[1:])
    out["decode"] = dict(launches=launches, step_ms=step * 1e3, tok_s=1 / step, aten_ops=n_ops, served=served,
                         plain=plain, late_control=control)
    print(f"dense decode: {ZOO_DECODE} steps of sequence 0 (B 1): median step {step * 1e3:.2f} ms, {1 / step:.1f} "
          f"tok/s ({smi}), {n_ops} ATen operations a step; launches {launches}. Against the prefill's logits at "
          f"positions 0-{ZOO_DECODE - 1}: with no activation quantizer (policy fp32, the same codes) max err "
          f"{plain['max']:.3e} of the scale {plain['scale']:.3f} (bound {DENSE_TOL}; position {ZOO_DECODE - 1}: "
          f"{plain['last']:.3e}), argmax equal at {plain['argmax']} of {ZOO_DECODE}; negative control, the cache one "
          f"position late: max err {control['max']:.3e}, beyond the bound from position {control['first']}; under "
          f"floatsd8_table6 "
          f"(reported) max err {served['max']:.3e} of the scale {served['scale']:.3f}, within {DENSE_TOL} up to "
          f"position {served['first'] - 1}, argmax equal at {served['argmax']} of {ZOO_DECODE}", flush=True)
    del logits, ref32, dec, dec32, late

    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    kd.STATS.reset()
    zoo_counters(reset=True)
    eng, reqs, times = zoo_serve(torch, model, store.tree, get_policy("floatsd8_table6"), prompts,
                                 cache_len=DENSE_CACHE_LEN)
    launches, stats = zoo_counters(), kd.STATS.snapshot()
    m = eng.metrics
    kv = eng.pool.caches["stack"]["b0"]
    kv_bytes = kv.k.numel() * kv.k.element_size() + kv.v.numel() * kv.v.element_size()
    check(eng.chunk == 1 and eng.store.packed_nbytes == DENSE_BYTES and kv_bytes == DENSE_KV_BYTES,
          f"dense engine: chunk {eng.chunk}, store {eng.store.packed_nbytes}, KV cache {kv_bytes} B")
    check(all(r.status == "done" and len(r.out) == ZOO_MAX_NEW for r in reqs) and m.numeric_errors == 0,
          f"dense engine: {[r.status for r in reqs]}, {m.numeric_errors} nonfinite")
    want = {"floatsd_matmul": n_sites * m.steps, "qsigmoid": 0, "rwkv_wkv": 0, "flash_attention": 0}
    check(launches == want and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"dense engine launches {launches} != {want}; dispatch {stats}")
    step = statistics.median(times)
    out["engine"] = dict(launches=launches, step_ms=step * 1e3, gen_tok_s=m.report()["gen_tok_per_s"],
                         lane_tok_s=ZOO_LANES / step)
    print(f"dense engine: {m.format()}; KV cache {kv_bytes} B ({DENSE_CACHE_LEN} positions); median step "
          f"{step * 1e3:.2f} ms over {len(times)} steps at {ZOO_LANES} lanes = {ZOO_LANES / step:.1f} tok/s ({smi}); "
          f"launches {launches}", flush=True)
    out["launches"] = {op: sum(out[p]["launches"][op] for p in ("prefill", "decode", "engine")) for op in want}
    del eng, store, tree, kv
    torch.cuda.empty_cache()
    return out


def dense_x_phase(torch, dev, smi):
    """Phase 15: the dense path at full width and DENSE_X_LAYERS layers on
    the kernels against backend="ref" (the plain versions) on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.serving import synthetic_prompts

    cfg, model, store, _ = zoo_build(torch, dev, DENSE_X_LAYERS, arch=DENSE_ARCH)
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
        gaps[name] = positions_gap(torch, got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]),
                                   DENSE_X_TOL)
        gaps[name]["bit_equal"] = float((got == want).float().mean())
        del got, want
    g32, g8 = gaps["fp32"], gaps["floatsd8_table6"]
    check(g32["max"] <= DENSE_X_TOL, f"dense-x prefill logits, no activation quantizer: max err {g32['max']:.3e} "
                                     f"of the scale {g32['scale']:.3f} (bound {DENSE_X_TOL})")
    prompts = synthetic_prompts(ZOO_LANES, cfg.vocab, np.random.default_rng(SEED))
    pol8 = get_policy("floatsd8_table6")
    _, reqs, _ = zoo_serve(torch, model, store.tree, pol8, prompts, cache_len=DENSE_CACHE_LEN)
    _, refs, ref_times = zoo_serve(torch, model, store.tree, pol8, prompts, backend="ref", cache_len=DENSE_CACHE_LEN)
    decisive = agree = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(ref.margins) if g <= MARGIN_FLOOR), ZOO_MAX_NEW)
        check(r.out[:n] == ref.out[:n], f"dense-x: request {r.rid}: {r.out} vs plain {ref.out} (decisive {n})")
        decisive += n
        agree += r.out == ref.out
    check(decisive >= ZOO_LANES * ZOO_MAX_NEW // 2, f"dense-x: only {decisive} decisive tokens")
    print(f"dense-x ({DENSE_X_LAYERS} of {get_config(DENSE_ARCH).n_layers} layers at full width, kernels vs "
          f"backend='ref' on the card): prefill logits [{ZOO_B},{ZOO_S}] with no activation quantizer (policy "
          f"fp32, the same codes) max err {g32['max']:.3e} of the scale {g32['scale']:.3f} (bound {DENSE_X_TOL}), "
          f"{g32['bit_equal']:.2%} bit-equal; under floatsd8_table6 (reported) max err {g8['max']:.3e} of the "
          f"scale {g8['scale']:.3f}, {g8['bit_equal']:.2%} bit-equal, every position within {DENSE_X_TOL} up to "
          f"{g8['first']} of {ZOO_B * ZOO_S} (flattened), argmax equal at {g8['argmax']}; plain prefill "
          f"{t_ref:.2f} s; engine ({ZOO_LANES} lanes, {ZOO_MAX_NEW} new tokens, floatsd8_table6): {decisive} of "
          f"{ZOO_LANES * ZOO_MAX_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) and equal, {agree} of "
          f"{ZOO_LANES} streams equal in full; plain decode step {statistics.median(ref_times) * 1e3:.1f} ms",
          flush=True)
    del store, tree
    torch.cuda.empty_cache()
    return gaps


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
    wkv = wkv_phase(torch, dev, flush)
    zmm = zoo_matmul_phase(torch, dev, flush)
    dmm = zoo_matmul_phase(torch, dev, flush, DENSE_ARCH, DENSE_MM_SITES, SEED + 5)
    fa = flash_phase(torch, dev, flush)
    task_rows, task_steps = task_kernel_phase(torch, dev, flush)
    del flush

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
         mm4.values(), [(2 * L, mm4[("gate", 8)]), (1, mm4[("head", 8)])],
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
        ("flash_attention", "flash_attention/flash_attention.cu", "flash_attention/kernel.py:27", fa.values(),
         [(DL, fa["prefill"])], f"dense prefill at B {ZOO_B} x S {ZOO_S}: {DL} x q [2,1024,32,120], k, v "
         "[2,1024,8,120] f32, causal (window 4096 inactive); library: scaled_dot_product_attention(is_causal=True, "
         "enable_gqa=True)", None, None),
    ]
    paths = {"serve": launches, "train": tr_launches, "tasks": tasks["launches"], "serve4": s4["launches"],
             "entry": ent["launches"], "runtime": rt["launches"], "zoo": zoo["launches"],
             "dense": dense["launches"]}
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
        for key, path in (("zoo_prefill_profiled", zoo), ("dense_prefill_profiled", dense)):
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
