"""The port's quantization-health telemetry against the JAX package's, on
the CPU: ``obs.telemetry``'s statistics on the same trees, the train step's
``metrics["tel"]``, the ``TelemetryLogger`` records and JSONL, and
``matmul_dw``'s flush hook.

Tolerances: every count and fraction is equal (the counts are integers,
summed and scaled in f32 as the reference's compiled step does: the JAX
functions run under ``jax.jit``, as they do inside that step); the gradient
norms and a window's mean loss, sums whose order differs between the two
libraries, within 1e-6 relative.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels import dispatch as jkd  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim import train_state as jts  # noqa: E402
from repro_torch.core import floatsd  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.obs import telemetry as ttel  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.optim import train_state as tts  # noqa: E402

FRACS = ("fp8_sat_frac", "fp8_underflow_frac", "fp8_zero_frac", "sd_carry_frac", "sd_clamp_frac")


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _grad_tree(seed=0):
    """Loss-scaled gradients with every event: values at and past the e5m2
    clamp, nonzeros below the underflow threshold, zeros, ordinary values;
    fp16 and f32 leaves, matrices and vectors."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((24, 16)) * 100
    w.flat[:7] = [57344.0, -60000.0, 65504.0, 2.0 ** -18, -(2.0 ** -20), 0.0, -0.0]
    b = rng.standard_normal(16) * 1e-5
    b[:3] = [7e-6, 0.0, 3e5]
    e = rng.standard_normal((10, 8)).astype(np.float32)
    e[0, :4] = [2.0 ** -17, 2.0 ** -17 * 0.999, 57343.99, 0.0]
    return {"lstm0": {"wx": w.astype(np.float16), "b": b.astype(np.float32)}, "embed": {"table": e}}


def test_fp8_grad_stats_equal_jax():
    tree = _grad_tree()
    got = ttel.fp8_grad_stats(_to_torch(tree))
    want = jax.jit(jtel.fp8_grad_stats)(_to_jax(tree))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert float(got[k]) == float(want[k]), k
    assert float(got["fp8_sat_frac"]) > 0 and float(got["fp8_underflow_frac"]) > 0


def test_layer_grad_norms_match_jax():
    tree = _grad_tree(1)
    got, want = ttel.layer_grad_norms(_to_torch(tree)), jax.jit(jtel.layer_grad_norms)(_to_jax(tree))
    assert list(got) == list(want) == ["embed", "lstm0"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert list(ttel.layer_grad_norms([torch.ones(4)])) == ["all"]


def _update_pair(seed=2):
    rng = np.random.default_rng(seed)
    old = {"a": {"w": (rng.standard_normal((32, 16)) * 0.3).astype(np.float16),
                 "b": rng.standard_normal(16).astype(np.float32)},
           "c": {"w": rng.standard_normal((8, 12)).astype(np.float32)}}
    new = {"a": {"w": (old["a"]["w"] + rng.standard_normal((32, 16)) * 0.02).astype(np.float16),
                 "b": old["a"]["b"] + 1.0},
           "c": {"w": old["c"]["w"] + (rng.standard_normal((8, 12)) * 0.05).astype(np.float32)}}
    new["c"]["w"].flat[0] = 576.0  # 4.5 * 2^7: the top of bias 0's grid, a clamped weight
    return old, new


def test_floatsd_update_stats_equal_jax():
    old, new = _update_pair()
    tkd.STATS.reset()
    got = ttel.floatsd_update_stats(_to_torch(old), _to_torch(new))
    want = jax.jit(jtel.floatsd_update_stats)(_to_jax(old), _to_jax(new))
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert 0 < float(got["sd_carry_frac"]) < 1 and float(got["sd_clamp_frac"]) > 0
    # two quantizes a weight leaf (the vector is not one); plain on the CPU
    assert tkd.STATS.snapshot() == {("floatsd_quantize", "ref"): 4}


def test_codes_differ_exactly_where_values_differ():
    """The port compares FloatSD8 codes where the reference compares the
    quantized values: at one bias the two agree on every pair, signed
    zeros, values that round to zero, ties and values past the clamp
    included."""
    rng = np.random.default_rng(3)
    grid = floatsd._GRID_POS.astype(np.float32)
    mids = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    pool = np.concatenate([grid, -grid, mids, -mids, np.nextafter(mids, 0), [0.0, -0.0, 1e-30, -1e-30],
                           [600.0, -700.0, 576.0], rng.standard_normal(2000) * 100]).astype(np.float32)
    a = torch.from_numpy(rng.choice(pool, 50_000))
    b = torch.from_numpy(rng.choice(pool, 50_000))
    b[:pool.size] = a[:pool.size]  # equal pairs too
    for bias in (0, -3, 2):
        ca, cb = tkd.quantize(a, bias)[0], tkd.quantize(b, bias)[0]
        va, vb = floatsd.quantize(a, bias)[0], floatsd.quantize(b, bias)[0]
        assert torch.equal(ca != cb, va != vb), bias
        assert bool((va != vb).any()) and bool((va == vb).any())


# ---------------------------------------------------------------------------
# the train step and the logger
# ---------------------------------------------------------------------------

LR = 0.05


def _toy_params():
    rng = np.random.default_rng(4)
    return {"a": {"b": (rng.integers(-8, 9, 6) / 8).astype(np.float32),
                  "w": (rng.integers(-8, 9, (12, 6)) / 8).astype(np.float32)},
            "c": {"w": (rng.integers(-8, 9, (5, 7)) / 8).astype(np.float32)}}


def _toy_batches(n=5):
    """The loss's coefficient per master element. Times the loss scale
    (1024) they reach the e5m2 clamp (60), underflow (2^-30) or are zero;
    step 3's holds an inf (a skipped step)."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        c = {"a": {"b": rng.integers(-4, 5, 6).astype(np.float32),
                   "w": rng.integers(-4, 5, (12, 6)).astype(np.float32)},
             "c": {"w": rng.integers(-4, 5, (5, 7)).astype(np.float32)}}
        c["a"]["w"].flat[:3] = [60.0, 2.0 ** -30, 0.0]
        if i == 2:
            c["c"]["w"].flat[0] = np.inf
        out.append(c)
    return out


def _jax_loss(p, c, policy):
    leaves = zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(c))
    return sum(jnp.sum(a.astype(jnp.float32) * k) for a, k in leaves)


def _torch_loss(p, c, policy):
    from repro_torch._tree import tree_leaves

    keys = [k for g in sorted(p) for k in sorted(p[g])]
    pairs = [(p[g][k], c[g][k]) for g in sorted(p) for k in sorted(p[g])]
    assert len(pairs) == len(keys) == len(tree_leaves(p))
    return sum(torch.sum(a.to(torch.float32) * k) for a, k in pairs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Five steps of each package's train step with telemetry on (Table VI,
    fp16 masters, SGD 0.9, no clip) from the same masters and coefficient
    batches, each fed to its TelemetryLogger (windows end at steps 2 and 5)."""
    d = tmp_path_factory.mktemp("tel")
    batches = _toy_batches()
    jpol, tpol = jget_policy("floatsd8_table6"), tget_policy("floatsd8_table6")
    jstate = jts.init_state(_to_jax(_toy_params()), jsgd(0.9), jpol)
    jstep = jax.jit(jts.make_train_step(_jax_loss, jsgd(0.9), jpol, lr=LR, grad_clip=None, telemetry=True))
    tstate = tts.init_state(_to_torch(_toy_params()), tsgd(0.9), tpol)
    tstep = tts.make_train_step(_torch_loss, tsgd(0.9), tpol, lr=LR, grad_clip=None, telemetry=True)
    jlog, tlog = jtel.TelemetryLogger(str(d / "j.jsonl")), ttel.TelemetryLogger(str(d / "t.jsonl"))
    jm, tm, jrec, trec = [], [], [], []
    tkd.STATS.reset()
    for i, c in enumerate(batches, 1):
        jstate, m = jstep(jstate, _to_jax(c))
        jm.append(jax.device_get(m))
        jlog.update(i, m)
        tstate, m = tstep(tstate, _to_torch(c))
        tm.append(m)
        tlog.update(i, m)
        if i in (2, 5):
            jrec.append(jlog.emit(i))
            trec.append(tlog.emit(i))
    return dict(jm=jm, tm=tm, jrec=jrec, trec=trec, jstate=jstate, tstate=tstate, dir=d,
                stats=tkd.STATS.snapshot())


def test_train_step_telemetry_equals_jax(runs):
    for i, (j, t) in enumerate(zip(runs["jm"], runs["tm"]), 1):
        assert t["tel"].keys() == j["tel"].keys() == {*FRACS, "grad_norm"}
        for k in FRACS:
            assert float(t["tel"][k]) == float(j["tel"][k]), (i, k)
        assert bool(t["grads_finite"]) == bool(j["grads_finite"]) == (i != 3)
        for k, v in j["tel"]["grad_norm"].items():
            np.testing.assert_allclose(float(t["tel"]["grad_norm"][k]), float(v), rtol=1e-6)
    last = runs["tm"][-1]["tel"]
    assert all(float(last[k]) > 0 for k in ("fp8_sat_frac", "fp8_underflow_frac", "fp8_zero_frac",
                                             "sd_carry_frac"))
    assert float(runs["tm"][2]["tel"]["sd_carry_frac"]) == 0.0  # the skipped step carries nothing
    # the masters the statistics describe are JAX's, bit for bit
    for g in ("a", "c"):
        assert np.array_equal(runs["tstate"].params[g]["w"].numpy(), np.asarray(runs["jstate"].params[g]["w"]))
    # carry and clamp: two quantizes of each of the two weight matrices a step
    assert runs["stats"] == {("floatsd_quantize", "ref"): 5 * 2 * 2}


def test_logger_records_equal_jax_field_for_field(runs):
    jlines = [json.loads(x) for x in (runs["dir"] / "j.jsonl").read_text().splitlines()]
    tlines = [json.loads(x) for x in (runs["dir"] / "t.jsonl").read_text().splitlines()]
    assert len(jlines) == len(tlines) == 2
    for jr, tr, jl, tl in zip(runs["jrec"], runs["trec"], jlines, tlines):
        assert tr.to_dict() == tl and jr.to_dict() == jl
        assert tl.keys() == jl.keys()
        for k in jl:
            if k == "loss_mean":
                np.testing.assert_allclose(tl[k], jl[k], rtol=1e-6)
            elif k == "grad_norms":
                assert tl[k].keys() == jl[k].keys()
                for g in jl[k]:
                    np.testing.assert_allclose(tl[k][g], jl[k][g], rtol=1e-6)
            else:
                assert tl[k] == jl[k], k
    assert tlines[1]["nonfinite_steps"] == 1 and tlines[1]["window_steps"] == 3
    assert ttel.TelemetryLogger().format(runs["trec"][1]).startswith("tel: sat ")


@pytest.fixture
def sinks():
    for s in (jtel.KERNEL_STATS, ttel.KERNEL_STATS):
        s.reset()
        s.enable()
    yield
    for s in (jtel.KERNEL_STATS, ttel.KERNEL_STATS):
        s.disable()
        s.reset()


def test_matmul_dw_flush_hook_counts_equal_jax(sinks):
    rng = np.random.default_rng(6)
    m, k, n = 6, 20, 28
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    x[:, :4], g[:, :5] = 300.0, 300.0  # 6 x 9e4: past the clamp
    x[:, 16:], g[:, 24:] = 1e-7, 1e-7  # 6e-14: below the e5m2 floor
    jkd.matmul_dw(jnp.asarray(x), jnp.asarray(g), backend="ref")
    jkd.matmul_dw(jnp.asarray(x), jnp.asarray(g), quant=False, backend="ref")  # no snap: no record
    dw = tkd.matmul_dw(torch.from_numpy(x), torch.from_numpy(g))
    tkd.matmul_dw(torch.from_numpy(x), torch.from_numpy(g), quant=False)
    jax.effects_barrier()
    want, got = jtel.KERNEL_STATS.snapshot(), ttel.KERNEL_STATS.snapshot()
    assert got == want
    d = got["floatsd_matmul_dw"]
    assert (d["calls"], d["elems"]) == (1, k * n) and d["saturated"] == 20 and d["zeros"] >= 16
    assert d["zeros"] == int((dw == 0).sum())
    ttel.KERNEL_STATS.disable()
    tkd.matmul_dw(torch.from_numpy(x), torch.from_numpy(g))
    assert ttel.KERNEL_STATS.snapshot() == got  # disabled: no record
