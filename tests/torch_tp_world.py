"""Worlds of CPU ranks for the port's tensor-parallel tests, and the jobs
they run.

``run_worlds({n: [(job, kwargs), ...]}, tmp)`` starts, for each world size
n, n spawned processes at once, joins each world's ranks by gloo over a
``FileStore`` under ``tmp``, runs the jobs (functions of this module) in
order on every rank and returns ``{n: [rank 0's results, rank 1's, ...]}``,
as ``tests/torch_mesh_world.py`` does for the distributed runtime's tests.
This module imports torch and the port only; the jobs are the rank-side
halves of ``tests/test_torch_tp.py``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.core.policy import get_policy
from repro_torch.data.pipeline import to_global
from repro_torch.distributed import checkpointing
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import sgd
from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step, state_shardings


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


def _flat(tree) -> dict:
    return checkpointing.flatten(tree)


def _mesh():
    return make_host_mesh((dist.get_world_size(), 1), ("data", "model"))


def _specs(tree, prefix: str = "") -> dict:
    """{"a/b": spec} of a nested dict of ``NamedSharding``s."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.spec}


def _tp_model(arch: str, over: dict):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM

    return CausalLM(dataclasses.replace(get_config(arch).reduced(), **over))


def tp_run(arch: str, over: dict, params_path: str, batch_path: str, shape: tuple, policy: str,
           lr: float = 0.5, policy_over: dict | None = None) -> dict:
    """The reduced ``arch`` (fields ``over`` replaced) with the npz's
    parameters on a ("data", "model") ``shape`` mesh (tensor parallelism
    over "model"): the global loss of the npz's batch (tokens, labels), its
    prefill logits gathered whole, and one SGD step's masters gathered
    whole, each rank on its rows; and the same three unsharded, on the whole
    batch with no mesh. Also the collective launches of the step.
    ``policy_over``: fields of the policy replaced."""
    model = _tp_model(arch, over)
    pol = get_policy(policy, **(policy_over or {}))
    with np.load(params_path) as f:
        params = bridge.from_jax_params({k: f[k] for k in f.files}, "cpu")
    with np.load(batch_path) as f:
        gbatch = {k: f[k] for k in f.files}
    full_batch = batch_to_device(gbatch, "cpu")
    mesh = make_host_mesh(shape, ("data", "model"))
    psh = shd.tree_shardings(model.specs(), params, mesh)
    pieces = shd.shard_tree(params, shd.model_only(psh))
    local = batch_to_device(to_global(gbatch, mesh), "cpu")
    out = {}
    with torch.no_grad():
        with shd.use_mesh(mesh):
            share = model.loss(pieces, local, pol)
            logits = model.prefill(pieces, {"tokens": local["tokens"]}, pol)
        out["loss"] = float(shd.all_reduce(share.reshape(1), shd.batch_axes(mesh), mesh)[0])
        logits = shd.all_gather(logits, 2, ("model",), mesh)
        out["logits"] = shd.all_gather(logits, 0, shd.batch_axes(mesh), mesh).float().numpy()
        out["loss_whole"] = float(model.loss(params, full_batch, pol))
        out["logits_whole"] = model.prefill(params, {"tokens": full_batch["tokens"]}, pol).float().numpy()
    opt = sgd(0.9)
    state = init_state(params, opt, pol)
    sh = state_shardings(model.specs(), state, mesh)
    shd.COLLECTIVES.clear()
    new, m = make_train_step(model.loss, opt, pol, lr=lr, shardings=sh)(shd.shard_tree(state, sh), local)
    out["collectives"] = dict(shd.COLLECTIVES)
    out["step_loss"], out["finite"] = float(m["loss"]), bool(m["grads_finite"])
    out["masters"] = _flat(shd.gather_tree(new.params, sh.params))
    whole, mw = make_train_step(model.loss, opt, pol, lr=lr)(state, full_batch)
    out["step_loss_whole"] = float(mw["loss"])
    out["masters_whole"] = _flat(whole.params)
    out["pieces"] = {k: tuple(v.shape) for k, v in _flat(pieces).items()}
    return out


def tp_pieces(seed: int = 0) -> dict:
    """On a (1, world) ("data", "model") mesh: the FloatSD8 quantization of
    a column piece and a row piece of one weight (the largest |w| in the
    last rank's columns) against the whole weight's, and the train step's
    clip-norm sum of squares of a tree holding a piece and a whole leaf
    against the whole tree's; a column-parallel and a row-parallel
    ``QuantDense`` against the whole weight's, under fp32 and
    floatsd8_tpu."""
    from repro_torch.nn.linear import QuantDense, quant_weight
    from repro_torch.optim.train_state import _square_sum

    n = dist.get_world_size()
    mesh = make_host_mesh((1, n), ("data", "model"))
    r = mesh.get_local_rank("model")
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(8 * n, 6 * n, generator=g)
    w[3, -1] = 40.0  # in the last rank's columns and in the first rank's rows
    pol = get_policy("floatsd8_tpu")
    whole = quant_weight(w, pol)
    cols, rows = w[:, r * 6:(r + 1) * 6], w[r * 8:(r + 1) * 8]
    with shd.use_mesh(mesh):
        qc, qr = quant_weight(cols, pol, piece=True), quant_weight(rows, pol, piece=True)
        grads = {"cut": cols.clone(), "whole": torch.randn(5, generator=g) + 1.0}
        got = float(_square_sum(grads, {"cut": True, "whole": False}, mesh))
    want = float(torch.sum(w ** 2) + torch.sum(grads["whole"] ** 2))
    # a column-parallel and a row-parallel site against the whole weight's
    x, wd = torch.randn(16, 8 * n, generator=g), torch.randn(8 * n, 6 * n, generator=g) * 0.1
    site = {"col": QuantDense(8 * n, 6 * n, use_bias=False, in_axis="embed", out_axis="mlp"),
            "row": QuantDense(8 * n, 6 * n, use_bias=False, in_axis="mlp", out_axis="embed")}
    sites = {}
    for name in ("fp32", "floatsd8_tpu"):
        sp = get_policy(name)
        y = site["col"].apply({"w": wd}, x, sp)
        with shd.use_mesh(mesh), shd.tp_scope("dense"):
            yc = site["col"].apply({"w": wd[:, r * 6:(r + 1) * 6]}, x, sp)
            yr = site["row"].apply({"w": wd[r * 8:(r + 1) * 8]}, x[:, r * 8:(r + 1) * 8], sp)
        sites[name] = {"col_equal": torch.equal(yc, y[:, r * 6:(r + 1) * 6]), "row_equal": torch.equal(yr, y),
                       "row_err": float(((yr.float() - y.float()).abs() / (x.abs() @ wd.abs())).max())}
    return {"cols": torch.equal(qc, whole[:, r * 6:(r + 1) * 6]), "rows": torch.equal(qr, whole[r * 8:(r + 1) * 8]),
            "local_max": float(cols.abs().max()), "square_sum": got, "want": want,
            "twice_whole": want + float(torch.sum(grads["whole"] ** 2)) * (n - 1), "sites": sites}


def tp_world1(arch: str, over: dict, params_path: str, batch_path: str, policy: str, steps: int = 2) -> dict:
    """On a (1, 1) mesh (every tensor-parallel branch off): the reduced
    ``arch``'s Adam steps with shardings against the unsharded steps from
    the same parameters and batch, losses and masters; and the collective
    launches a step."""
    from repro_torch.optim import adam

    model = _tp_model(arch, over)
    pol, opt = get_policy(policy), adam()
    with np.load(params_path) as f:
        params = bridge.from_jax_params({k: f[k] for k in f.files}, "cpu")
    with np.load(batch_path) as f:
        batch = batch_to_device({k: f[k] for k in f.files}, "cpu")
    mesh = _mesh()
    state = init_state(params, opt, pol)
    sh = state_shardings(model.specs(), state, mesh)
    mstep = make_train_step(model.loss, opt, pol, lr=1e-2, shardings=sh)
    step = make_train_step(model.loss, opt, pol, lr=1e-2)
    mstate, out = shd.shard_tree(state, sh), {"losses": [], "mlosses": []}
    shd.COLLECTIVES.clear()
    for _ in range(steps):
        mstate, m = mstep(mstate, batch)
        state, u = step(state, batch)
        out["mlosses"].append(float(m["loss"]))
        out["losses"].append(float(u["loss"]))
    out["collectives"] = {k: v // steps for k, v in shd.COLLECTIVES.items()}
    out["axes"] = sum(ax is not None for s in _specs(sh.params).values() for ax in s)
    out["same"] = all(np.array_equal(a, b) for a, b in zip(_flat(mstate.params).values(), _flat(state.params).values()))
    return out

