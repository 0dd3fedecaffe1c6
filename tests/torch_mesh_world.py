"""Worlds of CPU ranks for the port's mesh tests, and the jobs they run.

``run_worlds({n: [(job, kwargs), ...]}, tmp)`` starts, for each world size
n, n spawned processes at once, joins each world's ranks by gloo over a
``FileStore`` under ``tmp``, runs the jobs in order on every rank and
returns ``{n: [rank 0's results, rank 1's, ...]}``: one process group per
world, all worlds concurrently. Each rank runs one PyTorch thread. This
module imports torch and the port only, so a rank starts in seconds; the
jobs below are the rank-side halves of ``tests/test_torch_mesh_*.py``.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.core.policy import get_policy
from repro_torch.data import synthetic
from repro_torch.data.pipeline import to_global
from repro_torch.distributed import checkpointing
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpointing import CheckpointManager, latest_step
from repro_torch.distributed.fault_tolerance import RestartableLoop
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import WikiText2LM
from repro_torch.optim import sgd
from repro_torch.optim.grad_compress import fp8_psum
from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step, state_shardings

#: the small LM of ``tests/test_torch_train.py``'s trajectory
V, W, B, S = 128, 16, 8, 16
POLICY = "floatsd8_table6"


def _rank(rank: int, world: int, tmp: str, jobs: list) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        results = [globals()[name](**kw) for name, kw in jobs]
        torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_worlds(worlds: dict, tmp: Path) -> dict:
    ctxs = {}
    for n, jobs in worlds.items():
        d = Path(tmp) / f"world{n}"
        d.mkdir(parents=True, exist_ok=True)
        ctxs[n] = (d, mp.start_processes(_rank, args=(n, str(d), jobs), nprocs=n, join=False,
                                         start_method="spawn"))
    for _, ctx in ctxs.values():
        while not ctx.join():
            pass
    return {n: [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
            for n, (d, _) in ctxs.items()}


def _mesh():
    return make_host_mesh((dist.get_world_size(), 1), ("data", "model"))


def _flat(tree) -> dict:
    return checkpointing.flatten(tree)


def _lm_setup(params_path: str, dynamic: bool = False):
    """The LM, its SGD, the sharded state from the npz's parameters (with
    the dynamic loss scale if ``dynamic``) and the state's shardings, on
    this world's mesh."""
    mesh = _mesh()
    model = WikiText2LM(vocab=V, emb=W, hidden=W, n_layers=2)
    opt, pol = sgd(0.9), get_policy(POLICY)
    with np.load(params_path) as f:
        params = bridge.from_jax_params({k: f[k] for k in f.files}, "cpu")
    full = init_state(params, opt, pol, dynamic_scale=dynamic)
    sh = state_shardings(model.specs(), full, mesh)
    return mesh, model, opt, pol, shd.shard_tree(full, sh), sh


def lm_steps(params_path: str, steps: int, nan_rank: int | None = None, dynamic: bool = False) -> dict:
    """The LM trained ``steps`` steps on this world's mesh from the npz's
    parameters on ``synthetic.wikitext2`` (seed 0) global batches of B x S,
    each rank on its rows. ``nan_rank``: that rank's loss share is NaN at
    the first step; ``dynamic``: the dynamic loss scale. Returns the global losses, finite flags and loss
    scales, the full masters, this rank's piece shapes, the sharded leaves'
    specs and the collective launches."""
    mesh, model, opt, pol, state, sh = _lm_setup(params_path, dynamic)
    rank = dist.get_rank()

    def loss_fn(p, batch, policy):
        loss = model.loss(p, batch, policy)
        return loss * float("nan") if rank == nan_rank and not loss_fn.done else loss

    loss_fn.done = False
    step = make_train_step(loss_fn, opt, pol, lr=0.5, shardings=sh)
    data = synthetic.wikitext2(batch=B, seq=S, vocab=V, seed=0)
    out = {"losses": [], "finite": [], "scale": []}
    shd.COLLECTIVES.clear()
    for _ in range(steps):
        batch = batch_to_device(to_global(next(data.batches), mesh), "cpu")
        state, m = step(state, batch)
        loss_fn.done = True
        out["losses"].append(float(m["loss"]))
        out["finite"].append(bool(m["grads_finite"]))
        out["scale"].append(float(m["loss_scale"]))
    out["collectives"] = dict(shd.COLLECTIVES)
    out["pieces"] = {k: tuple(v.shape) for k, v in _flat(state.params).items()}
    out["specs"] = _specs(sh.params)
    out["masters"] = _flat(shd.gather_tree(state.params, sh.params))
    return out


def udpos_step(lengths: list) -> dict:
    """The reduced UDPOS tagger, from the port's seed-0 init, one Adam step
    on its first synthetic batch with each row's mask cut at ``lengths``
    (so the ranks' rows hold unequal token counts), the second half's tags
    all 0 and the tagger's bias of tag 0 raised by 4 (so those rows' mean
    loss is far below the first half's). Returns the global loss, this rank's token count and loss
    share, and the full masters."""
    from repro_torch.models.task_zoo import make_task

    mesh = _mesh()
    model, data, opt, lr, _ = make_task("udpos")
    pol = get_policy(POLICY)
    params = model.init(torch.Generator().manual_seed(0))
    params["out"]["b"][0] += 4.0
    full = init_state(params, opt, pol)
    sh = state_shardings(model.specs(), full, mesh)
    batch = dict(next(data.batches))
    batch["labels"] = batch["labels"].copy()
    batch["labels"][len(lengths) // 2:] = 0
    batch["mask"] = (np.arange(batch["mask"].shape[1])[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    local = batch_to_device(to_global(batch, mesh), "cpu")
    with shd.use_mesh(mesh):
        share = float(model.loss(full.params, local, pol))
    state, m = make_train_step(model.loss, opt, pol, lr=lr, shardings=sh)(shd.shard_tree(full, sh), local)
    return {"loss": float(m["loss"]), "share": share, "tokens": int(local["mask"].sum()),
            "masters": _flat(shd.gather_tree(state.params, sh.params))}


def ckpt_write(params_path: str, path: str) -> dict:
    """Two LM steps through ``RestartableLoop`` on this world's mesh, saved
    at step 2 (gathered; rank 0 writes). Returns the full state saved."""
    mesh, model, opt, pol, state, sh = _lm_setup(params_path)
    data = synthetic.wikitext2(batch=B, seq=S, vocab=V, seed=0)
    batches = (batch_to_device(to_global(b, mesh), "cpu") for b in data.batches)
    loop = RestartableLoop(CheckpointManager(path), lambda: state, save_every=2, shardings=sh)
    final, _ = loop.run(make_train_step(model.loss, opt, pol, lr=0.5, shardings=sh), batches, 2)
    return _flat(shd.gather_tree(final, sh))


def ckpt_restore(params_path: str, path: str, wait_s: float = 120.0) -> dict:
    """The newest checkpoint under ``path`` (waiting up to ``wait_s`` for
    one, which another world may still be writing) restored onto this
    world's mesh through ``RestartableLoop`` (each rank's pieces), then
    gathered whole. Returns the full state, its step and the pieces'
    shapes."""
    mesh, model, opt, pol, state, sh = _lm_setup(params_path)
    t0 = time.monotonic()
    while latest_step(path) is None and time.monotonic() - t0 < wait_s:
        time.sleep(0.1)
    loop = RestartableLoop(CheckpointManager(path), lambda: state, shardings=sh)
    return {"step": loop.start_step, "pieces": {k: tuple(v.shape) for k, v in _flat(loop.state).items()},
            "state": _flat(shd.gather_tree(loop.state, sh))}


def psum(payload_path: str) -> dict:
    """``fp8_psum`` over the default group of rank r's row of each payload
    [world, ...] in the npz: {name: result}."""
    r = dist.get_rank()
    with np.load(payload_path) as f:
        return {k: fp8_psum(torch.from_numpy(f[k][r])).numpy() for k in f.files}


def pod_mean(payload_path: str) -> dict:
    """``pod_compressed_mean`` on a ("pod", "data", "model") (2, 2, 1) mesh
    of rank r's row of each payload [4, ...]: {name: this rank's result},
    and this rank's pod and data coordinates under "coords"."""
    from repro_torch.optim.grad_compress import pod_compressed_mean

    mesh = make_host_mesh((2, 2, 1), ("pod", "data", "model"))
    r = dist.get_rank()
    with np.load(payload_path) as f:
        grads = {k: torch.from_numpy(f[k][r]) for k in f.files}
    out = {k: v.numpy() for k, v in pod_compressed_mean(grads, mesh).items()}
    out["coords"] = (mesh.get_local_rank("pod"), mesh.get_local_rank("data"))
    return out


def moe_loss(arch: str, batch: int, seq: int, params_path: str) -> dict:
    """The training CLI's model and first batch for ``--arch arch --batch
    batch --seq seq`` (seed 0) with the npz's parameters: the global loss
    (this world's shares summed) under this world's mesh, and the routing
    groups of every MoE call."""
    from repro_torch.launch import train
    from repro_torch.nn.moe import record_routes

    args = train.parse_args(["--arch", arch, "--batch", str(batch), "--seq", str(seq), "--device", "cpu"])
    _, model, data, _, _ = train.build_task(args)
    with np.load(params_path) as f:
        params = bridge.from_jax_params({k: f[k] for k in f.files}, "cpu")
    mesh = _mesh()
    local = batch_to_device(to_global(next(data.batches), mesh), "cpu")
    with shd.use_mesh(mesh), record_routes() as routes, torch.no_grad():
        share = model.loss(params, local, get_policy(POLICY))
    total = shd.all_reduce(share.reshape(1), shd.batch_axes(mesh), mesh)
    return {"loss": float(total[0]), "groups": [int(r.expert_idx.shape[0]) for r in routes]}


def _specs(tree, prefix: str = "") -> dict:
    """{"a/b": spec} of a nested dict of ``NamedSharding``s."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.spec}
