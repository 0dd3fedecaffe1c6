"""Training the port's UDPOS tagger, SNLI classifier and Multi30K seq2seq
against the JAX package's ``make_train_step``, on the CPU, at a tiny size
(vocab 64, width 16, B 4, S 6), from one JAX init carried over by
``repro_torch.bridge``; and Adam TrainState checkpoints both ways.
``test_torch_task_autodiff.py`` holds the autodiff paths to the same
bounds with these helpers.

Tolerances:
  * 5 steps of Adam (lr 1e-3) on three paths: Table VI on the fused
    quantized BPTT (JAX's ``fused=True``, here), and, on autodiff through
    the per-step cell, the FP32 baseline and Table II with ``fused=False``.
    Losses within 1e-3 relative at every step (the JAX package's
    ref-vs-kernel trajectory bound), and every trained master leaf within
    1e-3 of JAX's change to it (relative L2). Adam divides each moment by
    the root of its own second moment, so an element whose gradient
    differs by one FP8 step, or is 0 on one side only, moves by up to a
    whole lr: the masters are bounded relative to the change, as the SGD
    trajectory's are, with the same bound;
  * checkpoints both ways: arrays equal, keys and dtypes the reference's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import checkpointing  # noqa: E402
from repro.models import lstm_models as JM  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import train_state as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import checkpointing as tckpt  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.models import lstm_models as TM  # noqa: E402
from repro_torch.optim import AdamState  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import train_state as tts  # noqa: E402

STEPS, LR = 5, 1e-3
DATA = dict(batch=4, seq=6, vocab=64)
# task -> (model class name, widths, fused engine calls a step)
TASKS = {
    "udpos": ("UDPOSTagger", dict(vocab=64, emb=12, hidden=16), 4),
    "snli": ("SNLIClassifier", dict(vocab=64, emb=12, proj=10, hidden=16), 4),
    "multi30k": ("Multi30KSeq2Seq", dict(src_vocab=64, tgt_vocab=64, emb=12, hidden=16), 2),
}
# the train step's path: (policy, fused)
PATHS = {"table6": ("floatsd8_table6", True), "fp32": ("fp32", None), "table2-autodiff": ("floatsd8_table2", False)}


def _models(task):
    name, kw, _ = TASKS[task]
    return getattr(JM, name)(**kw), getattr(TM, name)(**kw)


@functools.lru_cache(maxsize=None)
def _jax_run(task, path="table6"):
    """JAX's train step from its own init: (init params as numpy, losses,
    final state, the state after 3 steps)."""
    pol, fused = PATHS[path]
    jm, _ = _models(task)
    params = jm.init(jax.random.PRNGKey(0))
    state = jts.init_state(params, jadam(), jget_policy(pol))
    step = jax.jit(jts.make_train_step(jm.loss, jadam(), jget_policy(pol), lr=LR, fused=fused))
    data = getattr(jsyn, task)(**DATA)
    losses, kept = [], None
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in next(data.batches).items()})
        losses.append(float(m["loss"]))
        if i + 1 == 3:
            kept = state
    return jax.tree_util.tree_map(np.asarray, params), losses, state, kept


def _flat_j(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_run(task, params_np, steps, state=None, skip=0, path="table6"):
    pol, fused = PATHS[path]
    _, tm = _models(task)
    data = getattr(tsyn, task)(**DATA)
    for _ in range(skip):
        next(data.batches)
    if state is None:
        state = tts.init_state(bridge.from_jax_params(params_np, "cpu"), tadam(), tget_policy(pol))
    step = tts.make_train_step(tm.loss, tadam(), tget_policy(pol), lr=LR, fused=fused)
    losses = []
    for _ in range(steps):
        state, m = step(state, tts.batch_to_device(next(data.batches), "cpu"))
        losses.append(float(m["loss"]))
        assert bool(m["grads_finite"])
    return losses, state


def _held_to_jax(task, path):
    params_np, losses_j, state_j, _ = _jax_run(task, path)
    tkd.STATS.reset()
    losses_t, state_t = _port_run(task, params_np, STEPS, path=path)
    rel = np.abs(np.array(losses_t) - losses_j) / np.abs(losses_j)
    assert rel.max() <= 1e-3, rel
    assert isinstance(state_t.opt_state, AdamState) and int(state_t.opt_state.count) == STEPS
    flat_t = tckpt.flatten(state_t)
    mdt = np.dtype(jnp.dtype(jget_policy(PATHS[path][0]).mdt()))
    init = _flat_j(jax.tree_util.tree_map(lambda a: a.astype(mdt), params_np))
    for key, want in _flat_j(state_j.params).items():
        got = flat_t[".params/" + key]
        assert got.dtype == want.dtype == mdt, key
        moved = np.linalg.norm(want.astype(np.float32) - init[key].astype(np.float32))
        assert moved > 0, key
        assert np.linalg.norm(got.astype(np.float32) - want.astype(np.float32)) <= 1e-3 * moved, key


@pytest.mark.parametrize("task", list(TASKS))
def test_table6_trajectory_matches_jax(task):
    _held_to_jax(task, "table6")
    # every LSTM on the fused engine: per call 2S + 2 matmuls, S cells and
    # cell backwards, S + 1 dx, 2 dw
    s, calls = DATA["seq"], TASKS[task][2]
    want = {"floatsd_matmul": 2 * s + 2, "lstm_cell": s, "lstm_cell_grad": s,
            "floatsd_matmul_dx": s + 1, "floatsd_matmul_dw": 2}
    assert tkd.STATS.snapshot() == {(op, "ref"): STEPS * calls * n for op, n in want.items()}


def test_jax_adam_checkpoint_continues_in_port(tmp_path):
    """JAX's Adam state after 3 steps, saved by JAX: the port reads it as an
    AdamState (the moments f32, the count int32) and continues."""
    params_np, losses_j, _, state3 = _jax_run("multi30k")
    checkpointing.save(str(tmp_path), state3, 3)
    template = tts.init_state(bridge.from_jax_params(params_np, "cpu"), tadam(), tget_policy("floatsd8_table6"))
    state_t, step = tckpt.restore(str(tmp_path), template)
    assert step == 3
    opt = state_t.opt_state
    assert isinstance(opt, AdamState) and opt.count.dtype == torch.int32 and int(opt.count) == 3
    assert opt.mu["dec"]["wx"].dtype == opt.nu["out"]["w"].dtype == torch.float32
    assert state_t.params["enc"]["wh"].dtype == torch.float16 and int(state_t.step) == 3
    losses_t, state_t = _port_run("multi30k", None, 2, state=state_t, skip=3)
    for got, want in zip(losses_t, losses_j[3:]):
        assert abs(got - want) <= 1e-3 * abs(want)
    assert int(state_t.step) == 5 and int(state_t.opt_state.count) == 5


def test_port_adam_checkpoint_restores_in_jax(tmp_path):
    params_np = _jax_run("multi30k")[0]
    _, state_t = _port_run("multi30k", params_np, 2)
    tckpt.save(str(tmp_path), state_t, 2)
    flat_t = tckpt.flatten(state_t)
    assert {".opt_state/.count", ".opt_state/.mu/out/w", ".opt_state/.nu/enc/b"} <= flat_t.keys()
    target = jts.init_state(jax.tree_util.tree_map(jnp.asarray, params_np), jadam(),
                            jget_policy("floatsd8_table6"))
    restored, step = checkpointing.restore(str(tmp_path), target)
    assert step == 2
    flat_r = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert flat_r.keys() == flat_t.keys()
    for k, v in flat_t.items():
        assert flat_r[k].dtype == v.dtype, k
        np.testing.assert_array_equal(flat_r[k], v, err_msg=k)
    # and back: the port reads its own checkpoint as it wrote it
    again = tckpt.flatten(tckpt.restore(str(tmp_path), state_t)[0])
    assert again.keys() == flat_t.keys()
    for k, v in flat_t.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
