"""The port's FloatSD4 serving slice against the JAX package, at a tiny size.

Same seeded numpy inputs through ``repro`` and ``repro_torch``:

  * codec (``core.floatsd4``): fit_group_exp, encode, decode, nibble
    packing (odd K), decode_packed and gather_decode bit-identical, at
    several scales, exact 2.25 * 2^e group maxima and all-zero groups.
    Tolerance 0. XLA on the CPU flushes f32 subnormals; the port keeps them
    (as the card does), so at exponent -126 the four codes with |mantissa|
    < 1 decode to subnormals in the port and to signed zeros in JAX, and a
    group of subnormals fits -126 in the port and 0 in JAX: those cases are
    pinned on both sides;
  * packing: ``WeightStore.pack(fmt="floatsd4")`` codes and exponents
    byte-identical; resident bytes exactly ceil(K/2)*N + ceil(K/32)*N per
    leaf;
  * matmul: the plain ``floatsd4_matmul`` (both layouts, odd K, K % 32 !=
    0) within 1e-5 of |x| @ |W| of the JAX oracle and of JAX's
    decode + einsum for the head;
  * loss: the port's loss on its FloatSD4 store within 1e-5 relative of
    JAX's on JAX's store; |loss4 - loss8| <= 0.25 (tests/test_serving.py's
    FLOATSD4_LOSS_TOL);
  * engine: greedy tokens equal to JAX's single-lane FloatSD4 rollout over
    the margin-decisive prefix (margin floor 1e-4, as in
    test_torch_serve.py), also when the port serves a store JAX packed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import floatsd4 as J4  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref as j4_ref  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import WeightStore as JStore  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import floatsd4 as T4  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul  # noqa: E402
from repro_torch.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    WEIGHT_FORMATS, PackedTensor4, ServeEngine, WeightStore, pack_floatsd4, synthetic_prompts,
    unpack_tree,
)

V, D, LANES, CHUNK, MAX_NEW = 512, 64, 3, 4, 6
MARGIN_FLOOR = 1e-4
FLOATSD4_LOSS_TOL = 0.25
JPOL = jget_policy("floatsd8_table6")
TPOL = tget_policy("floatsd8_table6")
LEAVES = [("embed", "table"), ("lstm0", "wx"), ("lstm0", "wh"), ("lstm1", "wx"), ("lstm1", "wh")]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    bad = a != b
    assert not bad.any(), f"{bad.sum()} of {a.size} differ, e.g. {a[bad][:5]} vs {b[bad][:5]}"


def _t(a):
    return torch.from_numpy(np.array(a))


SCALES = [1e-30, 3e-7, 0.02, 1.0, 7.5, 4.5e3, 1e25]


def _weights(seed, scale, k=100, n=37):
    """[k, n] with an all-zero group, a group whose max is exactly 2.25 *
    2^e, and one whose max is just above it."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    e = int(np.floor(np.log2(scale)))
    x[:32, 0] = 0.0
    x[32:64, 1] = np.clip(x[32:64, 1], -2.0**e, 2.0**e)
    x[40, 1] = -2.25 * 2.0**e
    x[:32, 2] = np.clip(x[:32, 2], -2.0**e, 2.0**e)
    x[7, 2] = np.nextafter(np.float32(2.25 * 2.0**e), np.float32(np.inf))
    return x


def test_tables_match_reference():
    _same(T4.MANTISSA_VALUES, J4.MANTISSA_VALUES)
    _same(T4.LUT16, J4.LUT16)
    assert (T4.ZERO_CODE, T4.SPARE_CODE, T4.GROUP, T4.TOP) == (
        J4.ZERO_CODE, J4.SPARE_CODE, J4.GROUP, J4.TOP)


@pytest.mark.parametrize("scale", SCALES)
def test_codec_bit_identical(scale):
    x = _weights(int(scale * 1e3) % 97, scale)
    ej, et = J4.fit_group_exp(jnp.asarray(x)), T4.fit_group_exp(_t(x))
    _same(et.numpy(), np.asarray(ej))
    assert int(et[0, 0]) == 0  # all-zero group
    e = int(np.floor(np.log2(scale)))
    assert int(et[1, 1]) == e and int(et[0, 2]) == e + 1  # exactly at / just above 2.25 * 2^e
    cj, ej = J4.encode(jnp.asarray(x))
    ct, et = T4.encode(_t(x))
    _same(ct.numpy(), np.asarray(cj))
    _same(et.numpy(), np.asarray(ej))
    _same(T4.decode(ct, et).numpy(), np.asarray(J4.decode(cj, ej)))
    pj, pt = J4.pack_nibbles(cj), T4.pack_nibbles(ct)
    _same(pt.numpy(), np.asarray(pj))
    _same(T4.decode_packed(pt, et, x.shape[0]).numpy(), np.asarray(J4.decode_packed(pj, ej, x.shape[0])))
    tok = np.random.default_rng(1).integers(0, x.shape[0], (3, 5)).astype(np.int32)
    _same(T4.gather_decode(pt, et, _t(tok)).numpy(), np.asarray(J4.gather_decode(pj, ej, jnp.asarray(tok))))


@pytest.mark.parametrize("k", [1, 2, 33, 99, 100])
def test_nibble_packing_odd_k(k):
    codes = np.random.default_rng(k).integers(0, 15, (k, 6)).astype(np.uint8)
    pt, pj = T4.pack_nibbles(_t(codes)), J4.pack_nibbles(jnp.asarray(codes))
    _same(pt.numpy(), np.asarray(pj))
    assert pt.shape == (-(-k // 2), 6)
    if k % 2:
        assert bool((pt[-1] >> 4 == T4.ZERO_CODE).all())  # the pad nibble
    _same(T4.unpack_nibbles(pt, k).numpy(), codes)
    _same(np.asarray(J4.unpack_nibbles(pj, k)), codes)


def test_decode_at_exponent_minus_126_pinned():
    """Every code at exponent -126: the port keeps the subnormals of
    |mantissa| < 1 (0.25 and 0.75 * 2^-126), JAX on the CPU flushes them to
    signed zeros; every other code is equal."""
    codes = np.arange(16, dtype=np.uint8).reshape(16, 1)
    exps = np.full((1, 1), -126, np.int8)
    got = T4.decode(_t(codes), _t(exps)).numpy()
    want = np.asarray(J4.decode(jnp.asarray(codes), jnp.asarray(exps)))
    sub = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    assert sub.sum() == 4
    np.testing.assert_array_equal(np.abs(got[sub]) / 2.0**-126, [0.75, 0.25, 0.25, 0.75])
    assert np.all(want[sub] == 0) and np.all(np.signbit(want[sub]) == np.signbit(got[sub]))
    _same(np.where(sub, want, got), want)


def test_fit_group_exp_subnormal_group_pinned():
    """A group of f32 subnormals: the port fits the floor exponent -126,
    JAX on the CPU reads them as 0 (exponent 0). Normal groups beside it,
    one with a max of 2.25 * 2^-126, are equal."""
    x = np.zeros((32, 3), np.float32)
    x[:, 0] = np.float32(1e-39)
    x[5, 1] = np.float32(2.25 * 2.0**-126)
    x[:, 2] = np.float32(2.0**-120)
    got, want = T4.fit_group_exp(_t(x)).numpy(), np.asarray(J4.fit_group_exp(jnp.asarray(x)))
    assert got[0, 0] == -126 and want[0, 0] == 0
    _same(got[:, 1:], want[:, 1:])
    assert got[0, 1] == -126 and got[0, 2] == -121
    codes, exps = T4.encode(_t(x))
    # 1e-39 * 2^126 = 0.085 rounds to the 0.0 code; 2.25 * 2^-126 keeps its top code
    assert int(codes[5, 1]) == 14 and int(codes[0, 0]) == T4.ZERO_CODE


def np_params(seed=0):
    """Seeded numpy parameters in the reference layout (as in
    test_torch_serve.py: weights scaled up so greedy margins are
    decisive)."""
    rng = np.random.default_rng(seed)
    s = 3.0 / np.sqrt(D)
    p = {"embed": {"table": (rng.standard_normal((V, D)) * 0.5).astype(np.float32)}}
    for i in range(2):
        b = np.zeros(4 * D, np.float32)
        b[D:2 * D] = 1.0
        p[f"lstm{i}"] = {
            "wx": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
            "wh": rng.uniform(-s, s, (D, 4 * D)).astype(np.float32),
            "b": b,
        }
    return p


def test_weight_store_floatsd4_byte_identical_and_resident_bytes():
    params = np_params()
    js = JStore.pack(jax.tree_util.tree_map(jnp.asarray, params), fmt="floatsd4")
    ts = WeightStore.pack(bridge.from_jax_params(params, "cpu"), fmt="floatsd4")
    t8 = WeightStore.pack(bridge.from_jax_params(params, "cpu"))
    assert (ts.fmt, t8.fmt) == ("floatsd4", "floatsd8") and ts.n_packed == t8.n_packed == 5
    want_bytes = 0
    for name, leaf in LEAVES:
        t, j = ts.tree[name][leaf], js.tree[name][leaf]
        assert isinstance(t, PackedTensor4) and t.codes.dtype == torch.uint8 and t.exps.dtype == torch.int8
        _same(t.codes.numpy(), np.asarray(j.codes))
        _same(t.exps.numpy(), np.asarray(j.exps))
        k, n = params[name][leaf].shape
        assert t.k == j.k == k
        assert t.codes.numel() == -(-k // 2) * n and t.exps.numel() == -(-k // 32) * n
        want_bytes += -(-k // 2) * n + -(-k // 32) * n
    want_bytes += sum(params[f"lstm{i}"]["b"].nbytes for i in range(2))
    assert ts.packed_nbytes == want_bytes == js.packed_nbytes
    assert ts.packed_nbytes < t8.packed_nbytes
    # FloatSD4 re-quantizes the FloatSD8 values: pack4 of the FloatSD8 leaf
    w8 = t8.tree["lstm0"]["wx"]
    assert torch.equal(tkd.pack4(w8).codes, ts.tree["lstm0"]["wx"].codes)
    dense = unpack_tree(ts.tree)
    assert torch.equal(dense["lstm1"]["wh"], tkd.unpack4(ts.tree["lstm1"]["wh"]))
    assert set(WEIGHT_FORMATS) == {"floatsd8", "floatsd4"}
    with pytest.raises(ValueError, match="weight format must be one of"):
        WeightStore.pack(bridge.from_jax_params(params, "cpu"), fmt="int3")


def _packed4(k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    codes, exps = J4.encode(jnp.asarray(w))
    return np.asarray(J4.pack_nibbles(codes)), np.asarray(exps)


@pytest.mark.parametrize("m,k,n", [(3, 100, 130), (5, 999, 60), (8, 128, 256), (2, 33, 7)])
def test_floatsd4_matmul_plain_matches_jax_oracle(m, k, n):
    """Gate layout [K, N] (odd K, K % 32 != 0 included)."""
    codes, exps = _packed4(k, n, m * k + n)
    x = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(j4_ref(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(exps), k))
    got = floatsd4_matmul_ref(_t(x), _t(codes), _t(exps), k).numpy()
    w = np.abs(np.asarray(J4.decode_packed(jnp.asarray(codes), jnp.asarray(exps), k))).astype(np.float64)
    assert got.shape == (m, n) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(x).astype(np.float64) @ w) + 1e-30)


@pytest.mark.parametrize("m,vocab,d", [(3, 130, 100), (4, 99, 65), (8, 512, 64)])
def test_floatsd4_head_plain_matches_jax_decode_einsum(m, vocab, d):
    """The tied head: the [V, D] table packed along V, read in place."""
    codes, exps = _packed4(vocab, d, m + vocab * d)
    x = np.random.default_rng(d).standard_normal((2, m, d)).astype(np.float32)
    w = J4.decode_packed(jnp.asarray(codes), jnp.asarray(exps), vocab)
    want = np.asarray(jnp.einsum("...d,vd->...v", jnp.asarray(x), w, preferred_element_type=jnp.float32))
    w4 = tkd.PackedTensor4(_t(codes), _t(exps), vocab)
    got = tkd.packed_einsum("...d,vd->...v", _t(x), w4).numpy()
    bound = 1e-5 * np.einsum("...d,vd->...v", np.abs(x).astype(np.float64),
                             np.abs(np.asarray(w)).astype(np.float64)) + 1e-30
    assert got.shape == (2, m, vocab) and np.all(np.abs(got - want) <= bound)
    ref = floatsd4_matmul_ref(_t(x.reshape(-1, d)), _t(codes), _t(exps), vocab, transposed=True)
    np.testing.assert_array_equal(got.reshape(-1, vocab), ref.numpy())


def test_matmul4_dispatch_records_and_hoist_decodes_once():
    codes, exps = _packed4(77, 40, 3)
    x = _t(np.random.default_rng(4).standard_normal((5, 77)).astype(np.float32))
    w4 = tkd.PackedTensor4(_t(codes), _t(exps), 77)
    n0 = floatsd4_matmul.launches
    tkd.STATS.reset()
    y = tkd.packed_einsum("bd,dk->bk", x, w4)
    hw = tkd.hoist_packed(w4)
    assert torch.equal(hw.dense, T4.decode_packed(w4.codes, w4.exps, 77)) and hw.codes is w4.codes
    assert tkd.hoist_packed(hw) is hw
    assert torch.equal(tkd.packed_einsum("bd,dk->bk", x, hw), y)
    assert torch.equal(floatsd4_matmul(x, w4.codes, w4.exps, 77), y)
    assert tkd.STATS.count("floatsd4_matmul", "ref") == 2 and tkd.STATS.count(backend="cuda") == 0
    assert tkd.STATS.last["floatsd4_matmul"].reason == "cpu tensor"
    assert floatsd4_matmul.launches == n0  # no kernel runs on the CPU


def _model_pair():
    return TLM(vocab=V, emb=D, hidden=D), JLM(vocab=V, emb=D, hidden=D)


def test_loss_on_floatsd4_store_matches_jax():
    params = np_params()
    tm, jm = _model_pair()
    batch = next(synthetic.wikitext2(batch=4, seq=12, vocab=V).batches)
    jpol, tpol = JPOL.replace(weight_quant="none"), TPOL.replace(weight_quant="none")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    tp = bridge.from_jax_params(params, "cpu")
    losses = {}
    for fmt in WEIGHT_FORMATS:
        want = float(jm.loss(JStore.pack(jp, fmt=fmt).tree, jb, jpol))
        with torch.no_grad():
            got = float(tm.loss(WeightStore.pack(tp, fmt=fmt).tree, tb, tpol))
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), (fmt, got, want)
        losses[fmt] = got
    assert losses["floatsd4"] != losses["floatsd8"]
    assert abs(losses["floatsd4"] - losses["floatsd8"]) <= FLOATSD4_LOSS_TOL, losses


def prompts(seed=1, n=6):
    return synthetic_prompts(n, V, np.random.default_rng(seed), lo=2, hi=11)


def _rollout(step, init, prompt):
    """Single-lane greedy rollout -> (tokens, n_decisive), the rule of
    tests/test_serving.py::_reference_rollout."""
    states, logits = init, None
    for t in prompt:
        logits, states = step(int(t), states)
    out, n_decisive, decisive = [], 0, True
    for _ in range(MAX_NEW):
        top2 = np.sort(logits)[-2:]
        decisive = decisive and (top2[1] - top2[0]) > MARGIN_FLOOR
        nxt = int(logits.argmax())
        out.append(nxt)
        n_decisive += int(decisive)
        logits, states = step(nxt, states)
    return out, n_decisive


@pytest.fixture(scope="module")
def jax_side():
    """JAX's FloatSD4 store, its single-lane rollouts and its engine's streams."""
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    _, jm = _model_pair()
    store = JStore.pack(params, fmt="floatsd4")
    serve_pol = JPOL.replace(weight_quant="none")
    ones = jnp.ones((1,), jnp.int32)
    fn = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, serve_pol, lengths=ones))

    def step(tok, states):
        lg, st = fn(store.tree, jnp.asarray([[tok]], jnp.int32), states)
        return np.asarray(lg[0, -1, :]), st

    refs = [_rollout(step, jm.init_cache(1, JPOL), p) for p in prompts()]
    eng = JEngine(jm, params, JPOL, lanes=LANES, chunk=CHUNK, weight_format="floatsd4")
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    eng.run()
    return dict(store=store, refs=refs, streams=[r.out for r in sorted(reqs, key=lambda r: r.rid)])


def _check_streams(streams, refs):
    assert sum(n for _, n in refs) >= MAX_NEW * len(refs) // 2
    for rid, (out, (ref, n)) in enumerate(zip(streams, refs)):
        assert len(out) == MAX_NEW
        assert out[:n] == ref[:n], (rid, out, ref, n)


def _serve(params):
    tm, _ = _model_pair()
    eng = ServeEngine(tm, params, TPOL, lanes=LANES, chunk=CHUNK, weight_format="floatsd4")
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    m = eng.run()
    assert all(r.status == "done" for r in reqs) and m.emitted == MAX_NEW * len(reqs)
    return eng, [r.out for r in sorted(reqs, key=lambda r: r.rid)]


def test_engine_floatsd4_tokens_match_jax_over_decisive_prefix(jax_side):
    tkd.STATS.reset()
    eng, streams = _serve(bridge.from_jax_params(np_params(), "cpu"))
    assert eng.store.fmt == "floatsd4"
    _check_streams(streams, jax_side["refs"])
    _check_streams(jax_side["streams"], jax_side["refs"])
    # every gate and the head ran the FloatSD4 matmul (plain on the CPU); none the FloatSD8 one
    assert tkd.STATS.count("floatsd4_matmul", "ref") > 0 and tkd.STATS.count("floatsd_matmul") == 0
    assert tkd.STATS.count(backend="cuda") == 0
    with pytest.raises(ValueError, match="weight_format must be one of"):
        ServeEngine(_model_pair()[0], np_params(), TPOL, weight_format="floatsd2")


def test_engine_serves_a_jax_packed_floatsd4_store(jax_side):
    tree = bridge.from_jax_packed(jax_side["store"].tree, "cpu")
    for name, leaf in LEAVES:
        t, j = tree[name][leaf], jax_side["store"].tree[name][leaf]
        assert isinstance(t, PackedTensor4) and t.k == j.k
        _same(t.codes.numpy(), np.asarray(j.codes))
        _same(t.exps.numpy(), np.asarray(j.exps))
    assert pack_floatsd4(tree)["lstm0"]["wx"] is tree["lstm0"]["wx"]  # packed leaves pass through
    eng, streams = _serve(tree)
    assert eng.store.packed_nbytes == jax_side["store"].packed_nbytes
    _check_streams(streams, jax_side["refs"])


def test_cli_serves_floatsd4_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--requests", "3", "--batch", "2", "--max-new", "2",
                 "--weight-format", "floatsd4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("weights: ") and "MiB packed FloatSD4" in out[0]
    assert out[1].startswith("served 3 requests, 6 tokens")
