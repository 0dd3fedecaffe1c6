"""Training CLI of the port: one of the paper's four tasks (the WikiText-2
LM by default; UDPOS, SNLI, Multi30K), or with ``--arch`` a zoo config's
reduced model on the causal-LM objective, under FloatSD8 weights, FP8
activations and gradients and an FP16 master copy, through the fused
quantized BPTT, with the reference's runtime (counterpart of
``repro.launch.train``): a prefetching input pipeline, async keep-3
checkpoints and resume from the newest, preemption (SIGTERM: checkpoint
and stop), straggler flags and quantization-health telemetry (on by
default). ``--policy fp32`` trains the FP32 baseline through autodiff. On
the card every LSTM gate matmul, cell, cell backward, ``matmul_dx`` and
``matmul_dw`` of the fused path runs a hand-written CUDA kernel, and so do
telemetry's FloatSD8 quantizes.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5               # reduced, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --task snli --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 20                    # paper width, GPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6 --save-every 3 \\
      --fail-at 4 --ckpt-dir /tmp/x      # crashes after step 4; without --fail-at it resumes from 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o_danube3_4b --device cpu --steps 2 \\
      --batch 2 --seq 16                 # a zoo config, reduced (the reference's build_task)

``--arch`` builds ``get_config(arch).reduced()`` and draws its batches from
``synthetic.wikitext2(batch, seq, vocab)`` (``--batch`` 16 and ``--seq``
128 by default), trained by Adam at lr 1e-3 unless ``--lr`` is given, as
the reference's ``build_task``; on the card every attention's forward runs
the flash-attention kernel, RWKV's wkv and receptance gates theirs, and
their backwards are plain PyTorch. The ``audio`` family exits 1: the
batch has no encoder ``frames`` (the reference's CLI fails on it too);
Whisper trains through ``make_train_step`` with frames in the batch.

Prints the reference's ``step N  loss L  scale S  finite F`` lines (and a
``tel:`` line) every ``--log-every`` steps and at the last, ``resumed from
step N`` on a resume, a closing ``trained N steps in ...`` line with the
warm steps/s and tokens/s (the first step left out), the stragglers flagged
and the steps skipped, and the dispatch record.

Like the reference, it trains on a ("data", "model") device mesh of every
rank (``make_mesh_for_host``: (world, 1)), under ``use_mesh``: the state
stored sharded by the model's logical specs, each rank on its rows of the
global batch, the gradients summed over the ranks (``optim.train_state``).
Launched plainly it opens a world of one rank on an in-memory store (no
files, no network); under ``torchrun --nproc-per-node N`` it joins
torchrun's world, one rank a device (``cuda:LOCAL_RANK``). NCCL on
``--device cuda``, gloo on ``--device cpu``. Rank 0 alone prints, writes
checkpoints and writes telemetry:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --steps 20       # 4 GPUs
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu --steps 3

Two recorded deviations from the reference's flags: ``--ckpt-dir`` has no
default (no checkpoints and no resume without one, where the reference
writes to and resumes from a shared ``/tmp`` directory), and the telemetry
JSONL is written only to ``--telemetry-out`` (the reference's default is
``<ckpt-dir>/telemetry.jsonl``). ``--save-z`` is the reference's
``REPRO_BPTT_REMAT=0``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..core.policy import get_policy
from ..data import synthetic
from ..data.pipeline import ShardedPipeline
from ..device import resolve_device
from ..distributed import sharding as shd
from ..distributed.checkpointing import CheckpointManager
from ..distributed.fault_tolerance import PreemptionSignal, RestartableLoop, StragglerMonitor
from ..kernels import dispatch as kd
from ..models import build
from ..models.task_zoo import TASKS, make_task
from ..nn import lstm
from ..obs.telemetry import TelemetryLogger
from ..optim import adam
from ..optim.train_state import init_state, make_train_step, state_shardings
from .mesh import make_host_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="wikitext2", choices=TASKS)
    ap.add_argument("--arch", default=None, help="a zoo config id: train its reduced config on the "
                    "causal-LM objective instead of --task")
    ap.add_argument("--batch", type=int, default=16, help="--arch's batch size")
    ap.add_argument("--seq", type=int, default=128, help="--arch's sequence length")
    ap.add_argument("--full", action="store_true", help="the paper's width (Table III)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--policy", default="floatsd8_table6")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=None, help="default: the task's")
    ap.add_argument("--seed", type=int, default=0, help="seeds the parameter init")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write checkpoints here and resume from them (default: none)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="raise SimulatedFailure after this step (the relaunch resumes)")
    ap.add_argument("--resume", default="auto", choices=["auto", "never"],
                    help="auto: restore the newest valid checkpoint under --ckpt-dir at startup; "
                    "never: always start fresh")
    ap.add_argument("--dynamic-scale", action="store_true",
                    help="dynamic loss scaling: a nonfinite step skips the update and halves "
                    "the scale, 2000 finite steps double it (default: the static 1024)")
    ap.add_argument("--no-fused", action="store_true",
                    help="train through autodiff and the grad_quant tree pass instead of the "
                    "fused quantized BPTT")
    ap.add_argument("--save-z", action="store_true",
                    help="the fused BPTT saves its per-step gate pre-activations instead of "
                    "recomputing them in the backward (the reference's REPRO_BPTT_REMAT=0)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="drop the quantization-health telemetry from the step")
    ap.add_argument("--telemetry-out", default=None,
                    help="append the telemetry records to this JSONL file (default: none)")
    return ap.parse_args(argv)


def describe(model) -> str:
    """The model's widths, from its fields (a zoo model's from its config)."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None:
        return (f"family {cfg.family}, n_layers {cfg.n_layers}, d_model {cfg.d_model}, heads {cfg.n_heads}/"
                f"{cfg.kv_heads} of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    return ", ".join(f"{f.name} {getattr(model, f.name)}" for f in dataclasses.fields(model))


def make_mesh_for_host():
    """Every rank of the default process group as a ("data", "model") mesh
    of (world, 1), as the reference's ``make_mesh_for_host``."""
    return make_host_mesh((dist.get_world_size(), 1), ("data", "model"))


@contextlib.contextmanager
def process_group(device_arg: str):
    """The default process group the CLI trains in, and this rank's device:
    the group already initialised (its caller's), torchrun's (``RANK`` and
    ``WORLD_SIZE`` in the environment), or else a world of one rank on an
    in-memory ``HashStore``. NCCL for ``cuda`` (device ``cuda:LOCAL_RANK``),
    gloo for ``cpu``. A group this opened is destroyed on exit."""
    cuda = device_arg == "cuda"
    device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
    opened = not dist.is_initialized()
    if opened:
        backend = "nccl" if cuda else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, device_id=device if cuda else None)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    device_id=device if cuda else None)
    try:
        yield device
    finally:
        if opened:
            dist.destroy_process_group()


def build_task(args):
    """(name, model, data, optimizer, lr): the zoo config ``--arch``
    reduced, on ``synthetic.wikitext2`` batches of ``--batch`` x ``--seq``,
    Adam at lr 1e-3 (the reference's ``build_task``), or ``--task``."""
    if args.arch:
        cfg = get_config(args.arch).reduced()
        if cfg.family == "audio":
            raise SystemExit(
                f"arch {args.arch!r} is family 'audio': its loss needs encoder frames, which the CLI's "
                "batches do not have; train Whisper through optim.make_train_step with 'frames' in the batch")
        data = synthetic.wikitext2(batch=args.batch, seq=args.seq, vocab=cfg.vocab)
        return args.arch, build(cfg), data, adam(), args.lr or 1e-3
    model, data, opt, lr, _ = make_task(args.task, full=args.full)
    return args.task, model, data, opt, args.lr or lr


@contextlib.contextmanager
def _remat(on: bool):
    """``nn.lstm.BPTT_REMAT`` set for the run, and put back after it."""
    old, lstm.BPTT_REMAT = lstm.BPTT_REMAT, on
    try:
        yield
    finally:
        lstm.BPTT_REMAT = old


def metrics_sink(out: dict, telemetry: TelemetryLogger | None, log_every: int, n_steps: int,
                 say=print):
    """The CLI's ``on_metrics``: after each step, read its loss (the step has
    finished), append it and its finite flag to ``out["losses"]`` and
    ``out["finite"]``, feed ``telemetry``, and ``say`` the step line (and
    the telemetry line) every ``log_every`` steps and at step ``n_steps``."""
    hist = collections.deque(maxlen=max(log_every, 1))

    def on_metrics(step, m):
        loss = float(m["loss"])  # reads the device: the step has finished
        out["losses"].append(loss)
        out["finite"].append(bool(m["grads_finite"]))
        hist.append(loss)
        if telemetry is not None:
            telemetry.update(step, m)
        if step % log_every == 0 or step == n_steps:
            say(f"step {step:5d}  loss {np.mean(hist):.4f}  scale {float(m['loss_scale']):.0f}  "
                f"finite {out['finite'][-1]}", flush=True)
            if telemetry is not None:
                say(telemetry.format(telemetry.emit(step)), flush=True)

    return on_metrics


def main(argv=None) -> dict:
    """Train; returns the per-step losses, finite flags and step times (s)
    of this launch, the step it started from, the final state (this
    rank's pieces) and its ``shardings``."""
    args = parse_args(argv)
    with process_group(args.device) as device:
        mesh = make_mesh_for_host()
        with shd.use_mesh(mesh):
            return _train(args, device, mesh)


def _train(args, device, mesh) -> dict:
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    policy = get_policy(args.policy)
    name, model, data, opt, lr = build_task(args)
    # the state is drawn whole on every rank from the seed, then cut
    full = [init_state(model.init(torch.Generator(device=device).manual_seed(args.seed)), opt, policy,
                       dynamic_scale=args.dynamic_scale)]
    shardings = state_shardings(model.specs(), full[0], mesh)
    step_fn = make_train_step(model.loss, opt, policy, lr=lr, fused=False if args.no_fused else None,
                              telemetry=not args.no_telemetry, shardings=shardings)

    def init_fn():
        state = full.pop() if full else init_state(
            model.init(torch.Generator(device=device).manual_seed(args.seed)), opt, policy,
            dynamic_scale=args.dynamic_scale)
        return shd.shard_tree(state, shardings)

    first = next(data.batches)
    keys = data.token_keys
    tokens = sum(first[k].size for k in keys)
    shape = " + ".join(f"{k} {first[k].shape[0]} x {first[k].shape[1]}" for k in keys)
    say(f"model: {name} {type(model).__name__} ({describe(model)}) | policy {policy.name} | "
        f"{opt.name} lr {lr} | batch {shape} | {device} | mesh {dict(shd.axis_sizes(mesh))} "
        f"{dist.get_backend()}", flush=True)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    preemption = PreemptionSignal(install_sigterm=True)
    loop = RestartableLoop(ckpt, init_fn, save_every=args.save_every, preemption=preemption,
                           straggler=StragglerMonitor(), resume=args.resume, shardings=shardings)
    full.clear()
    if loop.resumed:
        say(f"resumed from step {loop.start_step}", flush=True)
    telemetry = None
    if not args.no_telemetry and lead:
        if args.telemetry_out:
            os.makedirs(os.path.dirname(args.telemetry_out) or ".", exist_ok=True)
            print(f"telemetry -> {args.telemetry_out}", flush=True)
        telemetry = TelemetryLogger(path=args.telemetry_out)

    out = {"losses": [], "finite": [], "tokens_per_step": tokens, "start_step": loop.start_step}
    on_metrics = metrics_sink(out, telemetry, args.log_every, args.steps, say)
    pipeline = ShardedPipeline(itertools.chain([first], data.batches), device, mesh=mesh)
    t_start = time.perf_counter()
    try:
        with _remat(not args.save_z):
            state, last = loop.run(step_fn, pipeline, args.steps, fail_at=args.fail_at,
                                   on_metrics=on_metrics)
    finally:
        pipeline.close()
        loop.wait()
        preemption.uninstall()
    dt = time.perf_counter() - t_start
    done = last - loop.start_step
    out["step_s"] = loop.straggler.times
    warm = out["step_s"][1:]
    rate = (f"first step {out['step_s'][0]:.2f}s + {np.mean(warm):.4f}s/step warm "
            f"({len(warm) / sum(warm):.2f} steps/s, {tokens * len(warm) / sum(warm):.0f} tok/s)"
            if warm else f"{dt / max(done, 1):.2f}s/step")
    say(f"trained {done} steps in {dt:.1f}s ({rate}); stragglers flagged: "
        f"{len(loop.straggler.flagged)}; nonfinite steps skipped: {out['finite'].count(False)}",
        flush=True)
    say("dispatch: " + ", ".join(f"{o}/{b}={n}" for (o, b), n in sorted(kd.STATS.snapshot().items())),
        flush=True)
    out["state"], out["shardings"] = state, shardings
    return out


if __name__ == "__main__":
    main()
