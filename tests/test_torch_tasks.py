"""The port's pieces of the paper's other three tasks against the JAX
package, on the CPU: the fused engine's reverse and lengths-masked scans,
``BiLSTM``, the synthetic generators, the optimizers, the max-pool's and
|u - v|'s gradients at ties, the training CLI and the Table IV runner.

The same seeded numpy inputs (or JAX's own init) go through ``repro`` on
its reference path and through the port's plain versions.

Tolerances:
  * the engine's per-step gate pre-activations: the z each forward cell
    gets equals the z its backward recomputes, bit for bit, at B 128;
  * the fused layer (h and dWx / dWh / db) and ``BiLSTM``: rtol 2e-3,
    atol 1e-5 under floatsd8_table2 (the JAX package's own
    kernel-vs-reference bound);
  * the synthetic batches: element for element;
  * ``sgd``/``adam`` updates and moments: bit for bit over 5 steps (the
    bias correction's f32 power b ** count agrees between the two
    libraries at these counts; at high counts the two pows may differ by
    an ulp);
    ``adafactor``: bit for bit where every mean is exact (its first update
    on gradients on a dyadic grid, axes of 2^k, the clip inactive), and
    over 5 updates on other gradients with the clip active within 1e-6
    relative (the means reduce in each library's order);
  * the max-pool and |u - v| gradients at ties: bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.nn.lstm import BiLSTM as JBi  # noqa: E402
from repro.nn.lstm import LSTMLayer as JLayer  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ref import plan  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import SNLIClassifier  # noqa: E402
from repro_torch.models.task_zoo import TASKS, make_task  # noqa: E402
from repro_torch.nn.lstm import BiLSTM as TBi  # noqa: E402
from repro_torch.nn.lstm import LSTMLayer as TLayer  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

JT2 = jget_policy("floatsd8_table2").replace(grad_quant="fp8_kernel")
TT2 = tget_policy("floatsd8_table2").replace(grad_quant="fp8_kernel")
TT6 = tget_policy("floatsd8_table6").replace(grad_quant="fp8_kernel")
LENGTHS = [3, 9, 5, 7]


def _engine_counts(s: int, layers: int = 1) -> dict:
    """Per engine call: S steps x 2 matmuls + the recompute pair, S cells
    and cell backwards, S + 1 dx (recurrence + batched dXs), 2 dw."""
    return {("floatsd_matmul", "ref"): layers * (2 * s + 2), ("lstm_cell", "ref"): layers * s,
            ("lstm_cell_grad", "ref"): layers * s, ("floatsd_matmul_dx", "ref"): layers * (s + 1),
            ("floatsd_matmul_dw", "ref"): layers * 2}


# ---------------------------------------------------------------------------
# the fused engine
# ---------------------------------------------------------------------------


def test_engine_forward_zs_equal_backward_recompute_at_b128(monkeypatch):
    """At B 128 the engine's per-step gate products and its batched
    recompute (S x B rows) must sum in one order: every z a forward cell
    gets is the z the backward's cell gradient gets for that step. The
    matmul's unordered plan at M 128 is route B with other chunks than the
    ordered recompute's, so an unordered forward would differ here."""
    b, k, h, s = 128, 300, 300, 3
    assert plan(b, 4 * h, k) != plan(s * b, 4 * h, k, ordered=True)
    fwd, bwd = [], []
    cell, grad = tkd.lstm_cell, tkd.lstm_cell_grad
    monkeypatch.setattr(tkd, "lstm_cell", lambda z, c, **kw: (fwd.append(z.clone()), cell(z, c, **kw))[1])
    monkeypatch.setattr(tkd, "lstm_cell_grad",
                        lambda z, *a, **kw: (bwd.append(z.clone()), grad(z, *a, **kw))[1])
    gen = torch.Generator().manual_seed(0)
    p = {n: t.requires_grad_() for n, t in TLayer(k, h).init(gen).items()}
    xs = torch.randn((b, s, k), generator=gen)
    hs, fin = TLayer(k, h).apply(p, xs, TT6)
    (hs.square().sum() + fin.c.float().square().sum()).backward()
    assert len(fwd) == len(bwd) == s
    for t, z in enumerate(fwd):  # the backward walks the steps in reverse
        assert torch.equal(z, bwd[s - 1 - t]), t


def _jax_layer(layer, pj, xs, lengths):
    def loss(p):
        h, fin = layer.apply(p, jnp.asarray(xs), JT2, lengths=lengths)
        return jnp.sum(h.astype(jnp.float32) ** 2) + jnp.sum(fin.c.astype(jnp.float32) ** 2), h

    (_, h), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(pj)
    return np.asarray(h), {k: np.asarray(v, np.float32) for k, v in g.items()}


def _port_layer(layer, pj, xs, lengths):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in pj.items()}
    lens = None if lengths is None else torch.tensor(LENGTHS)
    h, fin = layer.apply(p, torch.from_numpy(xs), TT2, lengths=lens)
    (h.float().square().sum() + fin.c.float().square().sum()).backward()
    return h.detach().numpy(), {k: v.grad.float().numpy() for k, v in p.items()}


@pytest.mark.parametrize("hidden", [16, 70])
@pytest.mark.parametrize("variant", ["reverse", "masked"])
def test_fused_engine_variants_match_jax(hidden, variant):
    """The reverse scan (hs in time order, the backward recurrence running
    forward in time) and the lengths-masked one (frozen lanes pass dh and
    dc through), as ``tests/test_train_grad_parity.py``'s variants."""
    rev = variant == "reverse"
    lengths = jnp.asarray(LENGTHS, jnp.int32) if variant == "masked" else None
    layer = JLayer(12, hidden, reverse=rev)
    pj = layer.init(jax.random.PRNGKey(0))
    xs = np.random.default_rng(1).standard_normal((4, 9, 12)).astype(np.float32)
    h_j, g_j = _jax_layer(layer, pj, xs, lengths)
    tkd.STATS.reset()
    h_t, g_t = _port_layer(TLayer(12, hidden, reverse=rev), pj, xs, lengths)
    np.testing.assert_allclose(h_t, h_j, rtol=2e-3, atol=1e-5)
    for k in ("wx", "wh", "b"):
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=2e-3, atol=1e-5, err_msg=k)
    assert tkd.STATS.snapshot() == _engine_counts(xs.shape[1])


def test_bilstm_matches_jax():
    layer = JBi(12, 16)
    pj = layer.init(jax.random.PRNGKey(2))
    xs = np.random.default_rng(3).standard_normal((4, 6, 12)).astype(np.float32)

    def loss(p):
        h = layer.apply(p, jnp.asarray(xs), JT2)
        return jnp.sum(h ** 2), h

    (_, h_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(pj)
    p = {d: {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in pj[d].items()} for d in pj}
    tkd.STATS.reset()
    h_t = TBi(12, 16).apply(p, torch.from_numpy(xs), TT2)
    h_t.square().sum().backward()
    assert h_t.shape == (4, 6, 32)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), rtol=2e-3, atol=1e-5)
    for d in ("fwd", "bwd"):
        for k in ("wx", "wh", "b"):
            np.testing.assert_allclose(p[d][k].grad.numpy(), np.asarray(g_j[d][k]), rtol=2e-3,
                                       atol=1e-5, err_msg=f"{d}/{k}")
    assert tkd.STATS.snapshot() == _engine_counts(6, layers=2)


def test_inference_scan_reverse_and_masked_match_the_engine():
    """With no gradient a layer runs the inference scan; it equals the
    engine's forward bit for bit in both variants, and a reverse layer
    refuses lengths, as the reference's does."""
    gen = torch.Generator().manual_seed(4)
    p = TLayer(12, 16).init(gen)
    xs = torch.randn((4, 9, 12), generator=gen)
    lens = torch.tensor(LENGTHS)
    for rev, lengths in [(True, None), (False, lens)]:
        layer = TLayer(12, 16, reverse=rev)
        pt = {k: v.clone().requires_grad_() for k, v in p.items()}
        h_e, st_e = layer.apply(pt, xs, TT6, lengths=lengths)
        with torch.no_grad():
            h_i, st_i = layer.apply(p, xs, TT6.replace(grad_quant="fp8"), lengths=lengths)
        assert torch.equal(h_e.detach(), h_i) and torch.equal(st_e.c.detach(), st_i.c)
    with pytest.raises(ValueError):
        TLayer(12, 16, reverse=True).apply(p, xs, TT6, lengths=lens)


# ---------------------------------------------------------------------------
# data, optimizers, tie gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("udpos", dict(batch=4, seq=7, vocab=90, n_tags=18)),
    ("snli", dict(batch=5, seq=6, vocab=64)),
    ("multi30k", dict(batch=3, seq=7, vocab=50)),
])
def test_synthetic_batches_identical(name, kw):
    j, t = getattr(jsyn, name)(**kw), getattr(tsyn, name)(**kw)
    assert (t.name, t.vocab, t.n_labels) == (j.name, j.vocab, j.n_labels)
    for stream in ("batches", "eval_batches"):
        for _ in range(3):
            bj, bt = next(getattr(j, stream)), next(getattr(t, stream))
            assert bj.keys() == bt.keys()
            for k in bj:
                assert bt[k].dtype == bj[k].dtype, k
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


# keys in sorted order, the order jax.tree_util flattens a dict in; axes of
# 2^k, so a mean of dyadic values is exact
SHAPES = {"b": ((8,), np.float32), "e": ((4, 8), np.float32), "w": ((16, 4), np.float16)}


def _grads(rng, dyadic: bool):
    g = {k: rng.standard_normal(shape) for k, (shape, _) in SHAPES.items()}
    if dyadic:  # few significant bits: every square and every mean is exact
        g = {k: np.round(v * 8) / 8 for k, v in g.items()}
    return {k: g[k].astype(dt) for k, (_, dt) in SHAPES.items()}


def _run_opt(jo, to, steps, dyadic, seed=5):
    rng = np.random.default_rng(seed)
    params = {k: np.zeros(shape, dt) for k, (shape, dt) in SHAPES.items()}
    jst = jo.init({k: jnp.asarray(v) for k, v in params.items()})
    tst = to.init({k: torch.from_numpy(v) for k, v in params.items()})
    out = []
    for _ in range(steps):
        g = _grads(rng, dyadic)
        ju, jst = jo.update({k: jnp.asarray(v) for k, v in g.items()}, jst, None, 1e-3)
        tu, tst = to.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, None, 1e-3)
        out.append((ju, tu, jst, tst))
    return out


def _leaves_j(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _leaves_t(tree):
    from repro_torch._tree import tree_leaves

    return [(x.float() if x.dtype == torch.bfloat16 else x).numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("name,kw,steps", [("adam", {}, 5), ("adam", {"moment_dtype": "bf16"}, 5),
                                           ("sgd", {"momentum": 0.9}, 5), ("adafactor", {"clip": 1e3}, 1)])
def test_optimizer_updates_bit_identical(name, kw, steps):
    """Updates through ``get_optimizer`` on fp16 and f32 gradients: updates
    and every state leaf (moments, counts) equal bit for bit. Adafactor's
    first update only: from the second on its decayed moments are no
    longer dyadic, so their means round in each library's order."""
    jkw, tkw = dict(kw), dict(kw)
    if "moment_dtype" in kw:
        jkw["moment_dtype"], tkw["moment_dtype"] = jnp.bfloat16, torch.bfloat16
    for ju, tu, jst, tst in _run_opt(jopt.get_optimizer(name, **jkw), topt.get_optimizer(name, **tkw), steps,
                                     dyadic=name == "adafactor"):
        for k in ju:
            assert tu[k].dtype == torch.float32
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)
        a, b = _leaves_j(jst), _leaves_t(tst)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype or (x.dtype == jnp.bfloat16 and y.dtype == np.float32)
            np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))
    assert type(tst).__name__ == type(jst).__name__


def test_optimizer_sqrt_is_correctly_rounded_as_xla():
    """Adam's and Adafactor's f32 sqrt equals XLA's on every f32 in [1, 4)
    (both exponent parities). torch's vectorised f32 sqrt on the CPU does
    not: it is an ulp off on some of these, which moves an Adam update by
    an ulp; that is why ``_sqrt`` goes through f64 on the CPU."""
    x = (torch.arange(2**24, dtype=torch.int32) + (127 << 23)).view(torch.float32)
    got = topt._sqrt(x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.sqrt(jnp.asarray(x.numpy()))))


def test_adafactor_with_its_clip_within_1e_6():
    for ju, tu, jst, tst in _run_opt(jopt.adafactor(), topt.adafactor(), 5, dyadic=False):
        for k in ju:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=0)
        assert int(tst.count) == int(jst.count)


def test_train_step_skip_keeps_the_adam_state():
    """A nonfinite step keeps the masters and the whole AdamState, its
    int32 count included (the reference's skip-select); the next finite
    step counts from there."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import loss_scaling as tls
    from repro_torch.optim import train_state as tts

    model, data, opt, lr, _ = _tiny_snli("snli", False)
    pol = tget_policy("floatsd8_table6")
    state = tts.init_state(model.init(torch.Generator().manual_seed(0)), opt, pol, dynamic_scale=True)
    state = state._replace(scale=state.scale._replace(scale=torch.tensor(3e38)))  # overflows
    step = tts.make_train_step(model.loss, opt, pol, lr=lr)
    batch = tts.batch_to_device(next(data.batches), "cpu")
    new, m = step(state, batch)
    assert not bool(m["grads_finite"])
    assert new.opt_state.count.dtype == torch.int32 and int(new.opt_state.count) == 0
    for a, b in zip(tree_leaves((new.params, new.opt_state)), tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)
    new, m = step(new._replace(scale=tls.dynamic_init()), batch)
    assert bool(m["grads_finite"]) and int(new.opt_state.count) == 1


def test_max_pool_and_abs_gradients_at_ties_match_jax():
    """SNLI's feature [u, v, |u - v|, u * v] of max-pooled h: a max tied
    over time splits its gradient evenly (JAX's max; torch.amax, not
    max(dim=)), and |u - v| at u == v takes +g (JAX's abs; torch.abs
    gives 0). FP8-grid h values tie often."""
    from repro_torch.models.lstm_models import _Abs

    h = np.array([[[0.5, -0.0, 0.25], [0.5, 0.0, 0.25], [0.25, 0.0, -1.0]],
                  [[0.125, 0.125, 0.0], [0.125, 0.125, 0.0], [0.125, 0.125, 0.0]]], np.float32)
    w = np.random.default_rng(6).standard_normal((2, 12)).astype(np.float32)

    def jf(a, b):
        u, v = jnp.max(a, axis=1), jnp.max(b, axis=1)
        return jnp.sum(jnp.concatenate([u, v, jnp.abs(u - v), u * v], -1) * w)

    gj = jax.grad(jf, (0, 1))(jnp.asarray(h), jnp.asarray(h[::-1].copy()))
    a, b = torch.from_numpy(h).requires_grad_(), torch.from_numpy(h[::-1].copy()).requires_grad_()
    u, v = torch.amax(a, dim=1), torch.amax(b, dim=1)
    (torch.cat([u, v, _Abs.apply(u - v), u * v], -1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(gj[0]))
    np.testing.assert_array_equal(b.grad.numpy(), np.asarray(gj[1]))
    assert np.count_nonzero(np.asarray(gj[0])[1]) == 9  # the second row: ties over all of time


# ---------------------------------------------------------------------------
# the task zoo, the CLI and the Table IV runner
# ---------------------------------------------------------------------------


def test_make_task_builds_every_task():
    from repro.models.task_zoo import make_task as jmake_task

    assert TASKS == ("udpos", "snli", "multi30k", "wikitext2")
    for full in (False, True):
        for name in TASKS:
            tm, td, topt_, tlr, tmetric = make_task(name, full)
            jm, jd, _, jlr, jmetric = jmake_task(name, full)
            assert type(tm).__name__ == type(jm).__name__ and tm.__dict__ == {
                k: v for k, v in jm.__dict__.items() if k in tm.__dict__}
            assert (tlr, tmetric, topt_.name) == (jlr, jmetric, "sgd" if name == "wikitext2" else "adam")
            assert (td.name, td.vocab, td.n_labels) == (jd.name, jd.vocab, jd.n_labels)
    with pytest.raises(ValueError):
        make_task("nope")


def _tiny_snli(name, full):
    model = SNLIClassifier(vocab=64, emb=12, proj=10, hidden=16)
    return model, tsyn.snli(batch=4, seq=6, vocab=64), topt.adam(), 1e-3, "accuracy"


@pytest.mark.parametrize("policy", ["floatsd8_table6", "fp32"])
def test_cli_trains_a_tiny_snli_on_cpu(capsys, monkeypatch, policy):
    monkeypatch.setattr(ttrain, "make_task", _tiny_snli)
    tkd.STATS.reset()
    out = ttrain.main(["--task", "snli", "--device", "cpu", "--steps", "2", "--log-every", "1",
                       "--policy", policy])
    text = capsys.readouterr().out
    assert "model: snli SNLIClassifier (vocab 64, emb 12, proj 10, hidden 16, n_cls 3)" in text
    assert "adam lr 0.001 | batch premise 4 x 6 + hypothesis 4 x 6 | cpu" in text
    assert "step     2  loss" in text and "trained 2 steps in" in text and "tok/s" in text
    assert out["tokens_per_step"] == 2 * 4 * 6 and all(out["finite"]) and len(out["losses"]) == 2
    assert int(out["state"].opt_state.count) == 2
    # premise and hypothesis: two BiLSTM passes, four engine calls a step
    want = {k: 2 * n for k, n in _engine_counts(6, layers=4).items()} if policy != "fp32" else {}
    # the telemetry (on by default): two quantizes of each weight matrix a step
    from repro_torch._tree import tree_leaves

    mats = sum(p.ndim >= 2 for p in tree_leaves(_tiny_snli("snli", False)[0].init(torch.Generator())))
    want[("floatsd_quantize", "ref")] = 2 * 2 * mats
    assert tkd.STATS.snapshot() == want


def test_table4_runner_at_a_tiny_size(monkeypatch, tmp_path):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmarks_torch" / "table4_accuracy.py"
    spec = importlib.util.spec_from_file_location("table4_accuracy_torch", path)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    monkeypatch.setattr(runner, "make_task", _tiny_snli)
    evaluate = runner.evaluate
    monkeypatch.setattr(runner, "evaluate", lambda *a: evaluate(*a, n_batches=2))
    out = tmp_path / "t4.json"
    rows = runner.main(["--tasks", "snli", "--steps", "2", "--device", "cpu", "--seeds", "0", "1",
                        "--out", str(out)])
    assert [(r["policy"], r["seed"]) for r in rows] == [
        (p, s) for p in ("fp32", "floatsd8_table2", "floatsd8_table6") for s in (0, 1)]
    for r in rows:
        assert r["metric"] == "accuracy" and 0.0 <= r["value"] <= 1.0 and np.isfinite(r["loss_last10"])
    import json

    assert json.loads(out.read_text()) == rows
