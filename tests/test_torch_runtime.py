"""The port's training runtime against the JAX package, on the CPU: the
fused engine's save-z mode, ``train_matmul`` and ``lstm_cell_train``,
checkpoints (both packages read each other's; atomicity, keep-N, the
content hash, the async write), ``RestartableLoop`` (crash and bitwise
resume, the preemption checkpoint, stragglers), the prefetch pipeline, the
training CLI's runtime flags and the Table V runner.

Tolerances:
  * save-z against remat in the port: bit for bit (every product of the
    engine is ordered, so the saved zs are the recomputed ones); against
    the JAX engine under ``repro.nn.lstm.BPTT_REMAT = False``, and the
    (fp16, fp16, fp16) activation engine: rtol 2e-3, atol 1e-5 (the
    JAX package's kernel-vs-reference bound, as ``test_torch_tasks.py``);
  * ``train_matmul``: y and dx within 1e-5 relative (f32 sums in another
    order), dw on the FP8 grid equal except where the f32 sums straddle a
    grid midpoint (at most 0.5%, one e5m2 step); ``lstm_cell_train``: the
    cell backward's budget of ``test_torch_train.py`` (at most 0.5% of
    elements past rtol 1e-5, atol 1e-6: sigmoid/tanh ulps across a LUT
    step);
  * checkpoints, resumes and the CLI's relaunch: bit for bit.
"""
import importlib.util
import os
import signal
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.distributed import checkpointing as jckpt  # noqa: E402
from repro.kernels import dispatch as jkd  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.nn import lstm as jlstm  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim import train_state as jts  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.core import floatsd as tfsd  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.pipeline import ShardedPipeline  # noqa: E402
from repro_torch.distributed import checkpointing as tckpt  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    PreemptionSignal, RestartableLoop, SimulatedFailure, StragglerMonitor)
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.nn import lstm as tlstm  # noqa: E402
from repro_torch.nn.lstm import LSTMLayer as TLayer  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.optim import train_state as tts  # noqa: E402

JT2 = jget_policy("floatsd8_table2").replace(grad_quant="fp8_kernel")
TT2 = tget_policy("floatsd8_table2").replace(grad_quant="fp8_kernel")
TT6 = tget_policy("floatsd8_table6").replace(grad_quant="fp8_kernel")
LENGTHS = [3, 9, 5, 7]
V, W, B, S = 64, 16, 4, 6  # the tiny LM of the CLI and runner tests


@pytest.fixture
def remat_mode():
    """Restores both packages' BPTT_REMAT after a test that sets them."""
    old = (jlstm.BPTT_REMAT, tlstm.BPTT_REMAT)
    yield
    jlstm.BPTT_REMAT, tlstm.BPTT_REMAT = old


# ---------------------------------------------------------------------------
# the engine's save-z mode
# ---------------------------------------------------------------------------


def _port_grads(remat, variant, hidden=16, policy=TT2, seed=0):
    """One fused layer's h, final state and gradients (xs, wx, wh, b) under
    ``BPTT_REMAT = remat``, and the dispatch records of the call."""
    tlstm.BPTT_REMAT = remat
    gen = torch.Generator().manual_seed(seed)
    layer = TLayer(12, hidden, reverse=variant == "reverse")
    p = {k: v.to(policy.mdt()).requires_grad_() for k, v in layer.init(gen).items()}
    xs = torch.randn((4, 9, 12), generator=gen).requires_grad_()
    lens = torch.tensor(LENGTHS) if variant == "masked" else None
    tkd.STATS.reset()
    h, fin = layer.apply(p, xs, policy, lengths=lens)
    (h.float().square().sum() + fin.c.float().square().sum() + fin.h.float().sum()).backward()
    return [h, fin.h, fin.c, xs.grad, *(p[k].grad for k in ("wx", "wh", "b"))], tkd.STATS.snapshot()


@pytest.mark.parametrize("variant,policy", [("plain", TT2), ("reverse", TT2), ("masked", TT2),
                                            ("fp16-cell", TT6)])
def test_save_z_gives_remat_gradients_bit_for_bit(remat_mode, variant, policy):
    got, st_z = _port_grads(False, variant, policy=policy)
    want, st_r = _port_grads(True, variant, policy=policy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    # the recompute pair is gone: two matmul launches fewer per engine call
    assert st_r[("floatsd_matmul", "ref")] - st_z[("floatsd_matmul", "ref")] == 2
    assert {k: v for k, v in st_z.items() if k[0] != "floatsd_matmul"} == {
        k: v for k, v in st_r.items() if k[0] != "floatsd_matmul"}


def test_save_z_matches_the_jax_engine(remat_mode):
    jlstm.BPTT_REMAT = False  # set at runtime, as tests/test_train_grad_parity.py does
    layer = jlstm.LSTMLayer(12, 16)
    pj = layer.init(jax.random.PRNGKey(0))
    xs = np.random.default_rng(1).standard_normal((4, 9, 12)).astype(np.float32)

    def loss(p):
        h, fin = layer.apply(p, jnp.asarray(xs), JT2)
        return jnp.sum(h ** 2) + jnp.sum(fin.c.astype(jnp.float32) ** 2), h

    (_, h_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(pj)
    tlstm.BPTT_REMAT = False
    p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in pj.items()}
    h, fin = TLayer(12, 16).apply(p, torch.from_numpy(xs), TT2)
    (h.square().sum() + fin.c.float().square().sum()).backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), rtol=2e-3, atol=1e-5)
    for k in ("wx", "wh", "b"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_j[k]), rtol=2e-3, atol=1e-5, err_msg=k)


def test_save_z_residuals_grow_by_s_b_4h_4_bytes(remat_mode):
    def saved_bytes(remat):
        tlstm.BPTT_REMAT = remat
        gen = torch.Generator().manual_seed(2)
        p = {k: v.requires_grad_() for k, v in TLayer(12, 16).init(gen).items()}
        xs = torch.randn((4, 9, 12), generator=gen)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            h, _ = TLayer(12, 16).apply(p, xs, TT2)
        return total[0]

    s, b, h4 = 9, 4, 4 * 16
    assert saved_bytes(False) - saved_bytes(True) == s * b * h4 * 4


# ---------------------------------------------------------------------------
# the training ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (6, 20, 28)])
@pytest.mark.parametrize("hoist", ["packed", "dense"])
def test_train_matmul_matches_jax(m, k, n, hoist):
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)

    def f_j(x, w):
        with jkd.use_backend("ref"):
            y = jkd.train_matmul(x, w, jkd.hoist_train(w))
        return jnp.sum(y ** 2), y

    (_, y_j), (gx_j, gw_j) = jax.jit(jax.value_and_grad(f_j, (0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    wq = tkd.hoist_train(wt) if hoist == "packed" else tfsd.quantize_ste(wt, tfsd.fit_bias(wt.detach()))
    tkd.STATS.reset()
    y = tkd.train_matmul(xt, wt, wq)
    y.square().sum().backward()
    assert y.dtype == torch.float32 and xt.grad.dtype == wt.grad.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-6)
    gw, gw_j = wt.grad.numpy(), np.asarray(gw_j)
    off = gw != gw_j
    assert off.sum() <= 0.005 * gw.size
    e = np.floor(np.log2(np.maximum(np.abs(gw_j), 2.0 ** -14)))
    assert np.all(np.abs(gw - gw_j)[off] <= 2.0 ** (e - 2)[off])
    assert tkd.STATS.snapshot() == {(op, "ref"): 1 for op in
                                    ("floatsd_matmul", "floatsd_matmul_dx", "floatsd_matmul_dw")}


@pytest.mark.parametrize("b,h,c_dtype", [(8, 32, np.float16), (6, 20, np.float32)])
def test_lstm_cell_train_matches_jax(b, h, c_dtype):
    rng = np.random.default_rng(b * h)
    z = (rng.standard_normal((b, 4 * h)) * 2).astype(np.float32)
    c = rng.standard_normal((b, h)).astype(c_dtype)
    a1, a2 = rng.standard_normal((b, h)).astype(np.float32), rng.standard_normal((b, h)).astype(np.float32)

    def f_j(z, c):
        hh, cc = jkd.lstm_cell_train(z, c, c_dtype=jnp.dtype(c_dtype), backend="ref")
        return jnp.sum(hh * a1) + jnp.sum(cc.astype(jnp.float32) * a2), (hh, cc)

    (_, (h_j, c_j)), (gz_j, gc_j) = jax.jit(jax.value_and_grad(f_j, (0, 1), has_aux=True))(jnp.asarray(z),
                                                                                    jnp.asarray(c))
    tdt = torch.float16 if c_dtype == np.float16 else torch.float32
    zt, ct = torch.from_numpy(z).requires_grad_(), torch.from_numpy(c).requires_grad_()
    tkd.STATS.reset()
    ht, c2 = tkd.lstm_cell_train(zt, ct, c_dtype=tdt)
    ((ht * torch.from_numpy(a1)).sum() + (c2.float() * torch.from_numpy(a2)).sum()).backward()
    assert tkd.STATS.snapshot() == {("lstm_cell", "ref"): 1, ("lstm_cell_grad", "ref"): 1}
    assert zt.grad.dtype == torch.float32 and ct.grad.dtype == tdt
    for got, want in [(ht.detach(), h_j), (c2.detach(), c_j), (zt.grad, gz_j), (ct.grad, gc_j)]:
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
        assert off.sum() <= 0.005 * want.size, (off.sum(), want.size)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tiny_lm():
    return TLM(vocab=V, emb=W, hidden=W, n_layers=2), tsyn.wikitext2(batch=B, seq=S, vocab=V), tsgd(0.9)


def _port_state(steps=1):
    model, data, opt = _tiny_lm()
    state = tts.init_state(model.init(torch.Generator().manual_seed(0)), opt, TT6)
    step = tts.make_train_step(model.loss, opt, TT6, lr=0.5)
    for _ in range(steps):
        state, _ = step(state, tts.batch_to_device(next(data.batches), "cpu"))
    return state


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _port_state()
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state, 1)
    mgr.wait()
    target = jts.init_state(JLM(vocab=V, emb=W, hidden=W, n_layers=2).init(jax.random.PRNGKey(0)),
                            jsgd(0.9), jget_policy("floatsd8_table6"))
    restored, step = jckpt.restore(str(tmp_path), target)
    flat_t, flat_r = tckpt.flatten(state), _jflat(restored)
    assert step == 1 and flat_r.keys() == flat_t.keys()
    for k, v in flat_t.items():
        assert flat_r[k].dtype == v.dtype and np.array_equal(flat_r[k], v), k


def test_jax_checkpoint_resumes_in_restartable_loop(tmp_path):
    jm = JLM(vocab=V, emb=W, hidden=W, n_layers=2)
    jstate = jts.init_state(jm.init(jax.random.PRNGKey(1)), jsgd(0.9), jget_policy("floatsd8_table6"))
    jstate = jstate._replace(step=jnp.int32(3))
    jckpt.CheckpointManager(str(tmp_path), keep=3, async_write=False).save(jstate, 3)
    model, data, opt = _tiny_lm()
    init_fn = lambda: tts.init_state(model.init(torch.Generator().manual_seed(0)), opt, TT6)  # noqa: E731
    loop = RestartableLoop(tckpt.CheckpointManager(str(tmp_path)), init_fn, save_every=100)
    assert loop.resumed and loop.start_step == 3
    flat_t, flat_j = tckpt.flatten(loop.state), _jflat(jstate)
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert flat_t[k].dtype == v.dtype and np.array_equal(flat_t[k], v), k
    # and it continues from there in the port, as the port's own reader would
    step = tts.make_train_step(model.loss, opt, TT6, lr=0.5)
    batches = [tts.batch_to_device(next(data.batches), "cpu") for _ in range(2)]
    state, last = loop.run(step, batches, 5)
    again = tckpt.restore(str(tmp_path), init_fn(), step=3)[0]
    for b in batches:
        again, _ = step(again, b)
    assert last == 5 and tckpt.latest_step(str(tmp_path)) == 5 and int(state.step) == 5
    _equal_states(state, again)


def test_atomicity_keep_n_and_corruption(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.tensor(2.5, dtype=torch.float16)}}
    tckpt.save(str(tmp_path), tree, 1)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed save: never visible
    os.makedirs(tmp_path / "step_00000008")  # no manifest: never visible
    assert tckpt.latest_step(str(tmp_path)) == 1
    out, step = tckpt.restore(str(tmp_path), tree)
    assert step == 1 and out["b"]["c"].dtype == torch.float16 and torch.equal(out["a"], tree["a"])
    tree["a"] = tree["a"] + 1
    tckpt.save(str(tmp_path), tree, 1)  # re-saving a step replaces it
    assert torch.equal(tckpt.restore(str(tmp_path), tree)[0]["a"], tree["a"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000008", "step_00000009.tmp"]
    mgr = tckpt.CheckpointManager(str(tmp_path / "k"), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save({"w": torch.full((2,), float(s))}, s)
    assert sorted(os.listdir(tmp_path / "k")) == ["step_00000003", "step_00000004"]
    with open(tmp_path / "k" / "step_00000004" / "arrays.npz", "r+b") as f:
        f.seek(60)
        f.write(b"\x00\x01\x02")
    with pytest.raises(tckpt.CheckpointCorrupt, match="content_hash"):
        mgr.restore({"w": torch.zeros(2)})
    assert float(mgr.restore({"w": torch.zeros(2)}, 3)[0]["w"][0]) == 3.0


def test_async_save_writes_on_a_thread_and_wait_joins(tmp_path, monkeypatch):
    gate, started = threading.Event(), threading.Event()
    real = tckpt.save

    def slow(*a, **kw):
        started.set()
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(tckpt, "save", slow)
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=3)
    mgr.save({"w": torch.ones(3)}, 7)  # returns with the write still pending
    assert started.wait(10) and tckpt.latest_step(str(tmp_path)) is None
    gate.set()
    mgr.wait()
    assert tckpt.latest_step(str(tmp_path)) == 7

    def failing(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save", failing)
    mgr.save({"w": torch.ones(3)}, 8)  # the write fails on its thread: the next wait raises it
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    assert tckpt.latest_step(str(tmp_path)) == 7


# ---------------------------------------------------------------------------
# the restartable loop, preemption and stragglers
# ---------------------------------------------------------------------------


def _loop_setup(path):
    """The reference test's setup: Adam on w against a fixed batch."""
    from repro_torch.optim import adam

    pol = tget_policy("fp32")
    opt = adam()
    step = tts.make_train_step(lambda p, b, _: torch.sum((p["w"] - b) ** 2), opt, pol, lr=0.05,
                               grad_clip=None)
    init_fn = lambda: tts.init_state({"w": torch.zeros(4)}, opt, pol)  # noqa: E731

    def batches():
        while True:
            yield torch.tensor([1.0, 2.0, 3.0, 4.0])

    return tckpt.CheckpointManager(str(path), keep=2, async_write=False), init_fn, step, batches


def test_crash_relaunch_resumes_bitwise(tmp_path):
    mgr, init_fn, step, batches = _loop_setup(tmp_path / "ck")
    with pytest.raises(SimulatedFailure):
        RestartableLoop(mgr, init_fn, save_every=5).run(step, batches(), 10, fail_at=7)
    loop = RestartableLoop(mgr, init_fn, save_every=5)
    assert loop.resumed and loop.start_step == 5
    state, last = loop.run(step, batches(), 10)
    _, init2, step2, batches2 = _loop_setup(tmp_path / "ref")
    ref, _ = RestartableLoop(None, init2).run(step2, batches2(), 10)
    assert last == 10
    for a, b in zip(tree_leaves(state), tree_leaves(ref)):
        assert torch.equal(a, b)
    assert RestartableLoop(mgr, init_fn, resume="never").start_step == 0
    with pytest.raises(ValueError):
        RestartableLoop(mgr, init_fn, resume="sometimes")


def test_preemption_checkpoints_and_returns(tmp_path):
    mgr, init_fn, step, batches = _loop_setup(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    pre = PreemptionSignal(install_sigterm=True)
    try:
        loop = RestartableLoop(mgr, init_fn, save_every=1000, preemption=pre)

        def on_metrics(s, m):
            if s == 3:
                os.kill(os.getpid(), signal.SIGTERM)  # the handler sets the flag

        _, last = loop.run(step, batches(), 100, on_metrics=on_metrics)
    finally:
        pre.uninstall()
    assert last == 3 and pre.triggered() and mgr.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_monitor_flags_an_outlier():
    mon = StragglerMonitor(window=20, threshold=4.0)
    assert not any(mon.record(i, 0.10 + 0.001 * (i % 3)) for i in range(20))
    assert mon.record(20, 0.50) and mon.flagged[-1][0] == 20


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def test_pipeline_order_errors_and_close():
    src = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(5)]
    pipe = ShardedPipeline(iter(src), "cpu")
    got = list(pipe)
    assert [int(b["tokens"][0, 0]) for b in got] == list(range(5))
    assert all(b["tokens"].dtype == torch.int64 for b in got)
    with pytest.raises(StopIteration):
        next(pipe)

    def failing():
        yield from src[:3]
        raise RuntimeError("data source failed")

    pipe = ShardedPipeline(failing(), "cpu")
    assert [int(next(pipe)["tokens"][0, 0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="data source failed"):
        next(pipe)

    def endless():
        i = 0
        while True:
            yield {"tokens": np.full((1,), i)}
            i += 1

    pipe = ShardedPipeline(endless(), "cpu", prefetch=2)
    assert int(next(pipe)["tokens"][0]) == 0
    pipe.close()
    assert not pipe._thread.is_alive()


# ---------------------------------------------------------------------------
# the CLI and the Table V runner
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch):
    monkeypatch.setattr(ttrain, "make_task", lambda name, full: (*_tiny_lm()[:2], tsgd(0.9), 0.5, "perplexity"))
    return ["--device", "cpu", "--log-every", "3"]


def _equal_states(a, b):
    fa, fb = tckpt.flatten(a), tckpt.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def test_cli_fail_at_then_relaunch_resumes_bit_for_bit(tiny_cli, tmp_path, capsys):
    args = [*tiny_cli, "--steps", "6", "--save-every", "3", "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(SimulatedFailure):
        ttrain.main([*args, "--fail-at", "4"])
    out = ttrain.main(args)
    text = capsys.readouterr().out
    assert "resumed from step 3" in text and "step     6  loss" in text and "stragglers flagged: 0" in text
    assert out["start_step"] == 3 and len(out["losses"]) == 3 and int(out["state"].step) == 6
    # one process feeding the same batch sequence: 0-2, then 0-2 again (the
    # relaunch's fresh stream)
    model, data, opt = _tiny_lm()
    first = [tts.batch_to_device(next(data.batches), "cpu") for _ in range(3)]
    state = tts.init_state(model.init(torch.Generator().manual_seed(0)), opt, tget_policy("floatsd8_table6"))
    step = tts.make_train_step(model.loss, opt, tget_policy("floatsd8_table6"), lr=0.5, telemetry=True)
    for b in first + first:
        state, _ = step(state, b)
    _equal_states(out["state"], state)
    # --resume never starts over from the init
    fresh = ttrain.main([*args, "--resume", "never", "--steps", "1"])
    assert fresh["start_step"] == 0 and "resumed" not in capsys.readouterr().out


def test_cli_save_z_no_fused_and_telemetry_flags(tiny_cli, tmp_path, capsys):
    tkd.STATS.reset()
    remat = ttrain.main([*tiny_cli, "--steps", "2", "--no-telemetry"])
    mm_remat = tkd.STATS.count("floatsd_matmul")
    tkd.STATS.reset()
    tel = tmp_path / "t" / "tel.jsonl"
    savez = ttrain.main([*tiny_cli, "--steps", "2", "--save-z", "--telemetry-out", str(tel), "--log-every", "1"])
    assert tlstm.BPTT_REMAT  # the CLI puts the mode back
    assert remat["losses"] == savez["losses"]
    _equal_states(remat["state"], savez["state"])
    assert mm_remat - tkd.STATS.count("floatsd_matmul") == 2 * 2 * 2  # 2 per engine call, 2 layers, 2 steps
    text = capsys.readouterr().out
    assert text.count("tel: sat") == 2 and len(tel.read_text().splitlines()) == 2
    tkd.STATS.reset()
    ttrain.main([*tiny_cli, "--steps", "1", "--no-fused"])
    # autodiff: no engine op; only the telemetry's quantizes (4 weight matrices + the table)
    assert tkd.STATS.snapshot() == {("floatsd_quantize", "ref"): 2 * 5}


def test_table5_runner_and_its_fp16_engine(monkeypatch, tmp_path):
    path = Path(__file__).resolve().parents[1] / "benchmarks_torch" / "table5_ablation.py"
    spec = importlib.util.spec_from_file_location("table5_ablation_torch", path)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    t4 = sys.modules["table4_accuracy"]
    monkeypatch.setattr(t4, "make_task", lambda name, full: (*_tiny_lm()[:2], tsgd(0.9), 0.5, "perplexity"))
    evaluate = t4.evaluate
    monkeypatch.setattr(t4, "evaluate", lambda *a: evaluate(*a, n_batches=1))
    rows = runner.main(["--steps", "2", "--device", "cpu", "--out", str(tmp_path / "t5.json")])
    assert [(r["first"], r["last"], r["other"]) for r in rows] == runner.SETTINGS
    assert all(r["policy"] == "floatsd8_table2*" and np.isfinite(r["value"]) for r in rows)
    # the (fp16, fp16, fp16) row's engine: FP16 hidden activations and
    # activation gradients, against the JAX engine
    over = dict(first_layer_act="fp16", last_layer_act="fp16", act_fwd="fp16", act_bwd="fp16")
    jpol, tpol = JT2.replace(**over), TT2.replace(**over)
    assert tpol.act_dtypes("hidden") == (torch.float16, torch.float16)
    layer = jlstm.LSTMLayer(12, 16)
    pj = layer.init(jax.random.PRNGKey(3))
    xs = np.random.default_rng(4).standard_normal((4, 9, 12)).astype(np.float32)

    def loss(p):
        h, fin = layer.apply(p, jnp.asarray(xs), jpol)
        return jnp.sum(h ** 2) + jnp.sum(fin.c.astype(jnp.float32) ** 2), h

    (_, h_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(pj)
    p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in pj.items()}
    h, fin = TLayer(12, 16).apply(p, torch.from_numpy(xs), tpol)
    (h.square().sum() + fin.c.float().square().sum()).backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), rtol=2e-3, atol=1e-5)
    for k in ("wx", "wh", "b"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_j[k]), rtol=2e-3, atol=1e-5, err_msg=k)
