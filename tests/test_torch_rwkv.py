"""The port's RWKV-6 serving slice against the JAX package, at the reduced
``rwkv6_3b`` config (2 layers, d_model 128, head_dim 32 (4 heads), d_ff
256, vocab 512, layernorm, tied embeddings, policy floatsd8_table6).

Parameters are made with numpy from a seed in the reference layout and
handed to both packages (``repro_torch.bridge`` carries them across);
the store test also packs the JAX model's own init.

Tolerances (measured on the CPU):
  * plain wkv vs ``repro.kernels.rwkv_wkv.ref.wkv_ref``: |err| <= 1e-5 of
    the sum of the magnitudes of the terms (the recurrence run on |r|, |k|,
    |v|, |u|), the rule of the port's matmul tests: the two are the same
    recurrence with the same fused multiply-adds, and the r . S contraction
    sums in another order (worst seen 2e-6 of it; 1.9e-5 absolute at
    w0 = -6, S = 64); vs ``RWKV6TimeMix._wkv_chunked`` and
    ``wkv_pallas(interpret=True)``: rtol 2e-4, atol 2e-4, the bound of
    tests/test_rwkv_kernel.py (chunked against per-token evaluation),
    outputs and final states;
  * modules and model: |err| <= 1e-4 of the scale (max(1, the largest
    magnitude of the compared tensor)) except at most 0.5% of the
    elements, and <= 1e-3 of it everywhere: outputs, logits, states and
    caches. A value that an FP8/FP16 rounding boundary of ``quant_act`` (or
    a LUT midpoint of the quantized sigmoid) flips moves the rows it feeds:
    the time mix's output (chunked reference scan against the per-token
    recurrence) has 26 of 12288 elements beyond 1e-4 of the scale, the
    worst at 2.4e-4 of it; one fp16 flip at the head's input moves a whole
    row of decode logits by 7.6e-5 of the scale (step 7 below); the rest
    agree to 7e-6 of the scale or bit for bit. Loss within 1e-5 relative;
  * packed store: codes, biases and bytes identical to ``pack_tree``;
  * greedy tokens: equal to the JAX engine's over each request's
    margin-decisive prefix (top-2 gap of the port's logits above 1e-4), at
    least half of all tokens decisive.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels.rwkv_wkv.kernel import wkv_pallas  # noqa: E402
from repro.kernels.rwkv_wkv.ref import wkv_ref as jwkv_ref  # noqa: E402
from repro.models.lm import CausalLM as JLM  # noqa: E402
from repro.models.lm import cross_entropy as jcross_entropy  # noqa: E402
from repro.models.lm import mask_padded_vocab as jmask  # noqa: E402
from repro.nn.rwkv import RWKV6ChannelMix as JCMix  # noqa: E402
from repro.nn.rwkv import RWKV6TimeMix as JTMix  # noqa: E402
from repro.nn.rwkv import RWKVState as JState  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import pack_tree as jpack_tree  # noqa: E402
from repro.serving.weight_store import tree_nbytes as jtree_nbytes  # noqa: E402
from repro.serving.weight_store import unpack_tree as junpack_tree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import ArchConfig, get_config  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import CausalLM, build  # noqa: E402
from repro_torch.nn.rwkv import RWKV6ChannelMix, RWKV6TimeMix, RWKVState  # noqa: E402
from repro_torch.serving import ServeEngine, WeightStore, synthetic_prompts, tree_nbytes  # noqa: E402

JCFG = jget_config("rwkv6_3b").reduced()
TCFG = get_config("rwkv6_3b").reduced()
L, D, HD, DFF, V = 2, 128, 32, 256, 512
H = D // HD
B, S = 3, 32  # S % 16 == 0: the prefill runs dispatch.rwkv_wkv
LANES, MAX_NEW = 3, 8  # lanes != the 2 layers (masked_reset would read a layer as a lane)
TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
MARGIN_FLOOR = 1e-4
JPOL = jget_policy("floatsd8_table6")
TPOL = get_policy("floatsd8_table6")
JSERVE, TSERVE = JPOL.replace(weight_quant="none"), TPOL.replace(weight_quant="none")


def np_params(seed=0):
    """Seeded numpy parameters in the reference layout (every stack leaf
    stacked over the L layers), scaled so the logits have decisive
    margins and the decays span slow to fast."""
    rng = np.random.default_rng(seed)

    def n(*shape, sd=1.0):
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    def u(*shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def mat(k, m):
        return n(L, k, m, sd=1.0 / np.sqrt(k))

    def norm():
        return {"scale": u(L, D, lo=0.8, hi=1.2), "bias": n(L, D, sd=0.1)}

    mixer = {"mix": u(L, 5, D, lo=0.0, hi=1.0), "wr": mat(D, D), "wk": mat(D, D), "wv": mat(D, D),
             "wg": mat(D, D), "wo": mat(D, D), "w0": u(L, D, lo=-4.0, hi=0.5),
             "w_lora_a": n(L, D, 64, sd=0.05), "w_lora_b": n(L, 64, D, sd=0.05),
             "u": n(L, H, HD, sd=0.3), "ln_scale": u(L, D, lo=0.8, hi=1.2)}
    mlp = {"mix": u(L, 2, D, lo=0.0, hi=1.0), "wk": mat(D, DFF), "wv": mat(DFF, D), "wr": mat(D, D)}
    return {"embed": {"table": n(V, D)},
            "stack": {"b0": {"norm1": norm(), "mixer": mixer, "norm2": norm(), "mlp": mlp}},
            "final_norm": {"scale": u(D, lo=0.8, hi=1.2), "bias": n(D, sd=0.1)}}


def tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def prompts(n=LANES):
    return synthetic_prompts(n, V, np.random.default_rng(2), lo=3, hi=9)


def assert_close(got, want, what, tol=TOL):
    """|got - want| <= tol * scale except at most FLIP_SHARE of the
    elements, and <= FLIP_TOL * scale everywhere; scale = max(1, max
    |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want), max(1.0, float(np.abs(want).max()))
    assert (err > tol * scale).mean() <= FLIP_SHARE and err.max() <= FLIP_TOL * scale, (
        what, float(err.max()) / scale, int((err > tol * scale).sum()), err.size)


# ---------------------------------------------------------------------------
# the wkv recurrence: plain version against the JAX oracle, chunked scan and
# Pallas kernel
# ---------------------------------------------------------------------------


def _wkv_inputs(k, s, w0, b=2, h=2, seed=0):
    """[B, S, H, K] r, k, v, decays exp(-exp(w0 + noise)), u [H, K]."""
    rng = np.random.default_rng(seed + k + s)
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, k)) * 0.3 + w0)).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    return r, kk, v, w, u


def _to_bh(t):
    """[B, S, H, K] -> the JAX kernel layout [B * H, S, K]."""
    b, s, h, k = t.shape
    return np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(b * h, s, k))


def _port_wkv(r, kk, v, w, u):
    y, s_fin = tkd.rwkv_wkv(*(torch.from_numpy(t) for t in (r, kk, v, w, u)))
    return y.numpy(), s_fin.numpy()


@pytest.mark.parametrize("s", [16, 64, 50])
@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_wkv_plain_matches_jax_oracle(w0, k, s):
    r, kk, v, w, u = _wkv_inputs(k, s, w0)
    y, _ = _port_wkv(r, kk, v, w, u)
    bh_u = np.tile(u, (2, 1))  # row bh = b * H + h takes u[h]
    want = np.asarray(jwkv_ref(*(jnp.asarray(_to_bh(t)) for t in (r, kk, v, w)), jnp.asarray(bh_u)))
    terms, _ = _port_wkv(*(np.abs(t) for t in (r, kk, v)), w, np.abs(u))
    assert np.all(np.abs(_to_bh(y) - want) <= 1e-5 * _to_bh(terms))


@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_wkv_bounds_reject_a_recurrence_without_u(w0):
    """Negative control of both wkv bounds above: the recurrence with the
    bonus u dropped is rejected in every decay regime."""
    r, kk, v, w, u = _wkv_inputs(64, 64, w0)
    y, _ = _port_wkv(r, kk, v, w, u)
    y_m, _ = _port_wkv(r, kk, v, w, np.zeros_like(u))
    terms, _ = _port_wkv(*(np.abs(t) for t in (r, kk, v)), w, np.abs(u))
    assert (np.abs(y_m - y) > 1e-5 * terms).mean() > 0.5
    assert (np.abs(y_m - y) > 2e-4 + 2e-4 * np.abs(y)).mean() > 0.5


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_wkv_plain_matches_jax_chunked_scan_and_pallas_kernel(w0, k, s):
    r, kk, v, w, u = _wkv_inputs(k, s, w0)
    y, s_fin = _port_wkv(r, kk, v, w, u)
    tm = JTMix(dim=2 * k, head_dim=k)
    y_c, s_c = tm._wkv_chunked(*(jnp.asarray(t) for t in (r, kk, v, w, u)),
                               jnp.zeros((2, 2, k, k), jnp.float32), 16)
    np.testing.assert_allclose(y, np.asarray(y_c), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s_fin, np.asarray(s_c), rtol=2e-4, atol=2e-4)
    y_p = wkv_pallas(*(jnp.asarray(_to_bh(t)) for t in (r, kk, v, w)), jnp.asarray(np.tile(u, (2, 1))),
                     chunk=16, interpret=True)
    np.testing.assert_allclose(_to_bh(y), np.asarray(y_p), rtol=2e-4, atol=2e-4)


def test_wkv_final_state_matches_jax_sequential_from_a_carried_state():
    """The final state the model's apply returns: the port's recurrence
    from a nonzero state against ``_wkv_sequential``, and the zero-state
    entry point against it from zeros."""
    r, kk, v, w, u = _wkv_inputs(32, 24, -2.0)
    s0 = np.random.default_rng(5).standard_normal((2, 2, 32, 32)).astype(np.float32) * 0.2
    tm, ttm = JTMix(dim=64, head_dim=32), RWKV6TimeMix(dim=64, head_dim=32)
    for start in (np.zeros_like(s0), s0):
        y_j, s_j = tm._wkv_sequential(*(jnp.asarray(t) for t in (r, kk, v, w, u, start)))
        y_t, s_t = ttm._wkv_sequential(*(torch.from_numpy(t) for t in (r, kk, v, w, u, start)))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)
    _, s_fin = _port_wkv(r, kk, v, w, u)
    np.testing.assert_allclose(s_fin, np.asarray(tm._wkv_sequential(
        *(jnp.asarray(t) for t in (r, kk, v, w, u)), jnp.zeros((2, 2, 32, 32)))[1]), rtol=1e-5, atol=1e-5)


def test_wkv_wrapper_takes_plain_version_on_cpu_and_dispatch_records_it():
    r, kk, v, w, u = (torch.from_numpy(t) for t in _wkv_inputs(32, 20, -2.0))
    n0 = rwkv_wkv.launches
    tkd.STATS.reset()
    y_w, s_w = rwkv_wkv(r, kk, v, w, u)
    y_d, s_d = tkd.rwkv_wkv(r, kk, v, w, u, backend="ref")
    assert torch.equal(y_w, y_d) and torch.equal(s_w, s_d) and rwkv_wkv.launches == n0
    assert tkd.STATS.snapshot() == {("rwkv_wkv", "ref"): 1}
    assert tkd.STATS.last["rwkv_wkv"].reason == "policy:ref"
    with pytest.raises(ValueError, match="chunk"):
        tkd.rwkv_wkv(r, kk, v, w, u, chunk=8)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(with_state):
    p = _layer0(np_params()["stack"]["b0"]["mixer"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    st = (rng.standard_normal((B, H, HD, HD)).astype(np.float32) * 0.2,
          rng.standard_normal((B, D)).astype(np.float32))
    jtm, ttm = JTMix(D, HD), RWKV6TimeMix(D, HD)
    jst = JState(*map(jnp.asarray, st), jnp.zeros((B, D))) if with_state else None
    tst = RWKVState(*map(torch.from_numpy, st), torch.zeros(B, D)) if with_state else None
    yj, (sj, xj) = jax.jit(lambda p, x, s: jtm.apply(p, x, JPOL, state=s))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jst)
    tkd.STATS.reset()
    yt, (s_t, xt) = ttm.apply(bridge.from_jax_params(p, "cpu"), torch.from_numpy(x), TPOL, state=tst)
    assert_close(yt, yj, "time mix out")
    assert_close(s_t, sj, "final state")
    assert_close(xt, xj, "last token")
    # the zero-state full sequence runs the kernel entry point, a carried
    # state the sequential recurrence; the receptance gate is qsigmoid
    assert tkd.STATS.count("rwkv_wkv") == (0 if with_state else 1)
    assert tkd.STATS.count("qsigmoid", "ref") == 1


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(with_state):
    p = _layer0(np_params()["stack"]["b0"]["mlp"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    last = rng.standard_normal((B, D)).astype(np.float32) if with_state else None
    jcm, tcm = JCMix(D, DFF), RWKV6ChannelMix(D, DFF)
    yj, xj = jax.jit(lambda p, x, l: jcm.apply(p, x, JPOL, l))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), None if last is None else jnp.asarray(last))
    yt, xt = tcm.apply(bridge.from_jax_params(p, "cpu"), torch.from_numpy(x), TPOL,
                       None if last is None else torch.from_numpy(last))
    assert_close(yt, yj, "channel mix out")
    assert_close(xt, xj, "last token")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """JAX logits (dense fake-quant and the unpacked store), decode steps and
    engine streams: each JAX program compiled once for the module."""
    jm = JLM(JCFG)
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    packed = jpack_tree(params)
    toks = jnp.asarray(tokens())
    fwd = jax.jit(lambda p, t, pol: jm.forward(p, {"tokens": t}, pol)[0], static_argnums=2)
    dense_logits = fwd(params, toks, JPOL)
    served_logits = jax.jit(lambda p, t: jm.forward(junpack_tree(p), {"tokens": t}, JSERVE)[0])(packed, toks)
    step = jax.jit(lambda p, t, c: jm.decode_step(junpack_tree(p), t, c, JSERVE))
    cache = jm.init_cache(B, None)
    steps = []
    for t in range(10):
        lg, cache = step(packed, toks[:, t:t + 1], cache)
        steps.append((np.asarray(lg), jax.tree_util.tree_map(np.asarray, cache)))
    eng = JEngine(jm, params, JPOL, lanes=LANES, chunk=4, cache_len=64)
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    eng.run()
    return dict(params=params, packed=packed, dense_logits=np.asarray(dense_logits),
                served_logits=np.asarray(served_logits), steps=steps, engine=eng,
                streams=[r.out for r in sorted(reqs, key=lambda r: r.rid)])


@pytest.fixture(scope="module")
def port_params():
    return bridge.from_jax_params(np_params(), "cpu")


def test_init_shapes_match_jax():
    jp = jax.eval_shape(JLM(JCFG).init, jax.random.PRNGKey(0))
    tp = CausalLM(TCFG).init(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in _flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == want
    assert float(tp["stack"]["b0"]["mixer"]["w0"].max()) == -6.0  # the decay base, as initialised
    assert float(tp["stack"]["b0"]["mixer"]["u"].abs().max()) == 0.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_forward_loss_and_prefill_match_jax(jax_side, port_params):
    tm = CausalLM(TCFG)
    toks = torch.from_numpy(tokens())
    labels = tokens(seed=7)
    tkd.STATS.reset()
    logits, aux = tm.forward(port_params, {"tokens": toks}, TPOL)
    assert logits.shape == (B, S, TCFG.vocab_padded()) and float(aux) == 0.0
    assert_close(logits, jax_side["dense_logits"], "dense logits")
    # one rwkv_wkv per layer, two receptance gates per layer, all plain on the CPU
    assert tkd.STATS.snapshot() == {("rwkv_wkv", "ref"): L, ("qsigmoid", "ref"): 2 * L}
    loss = float(tm.loss(port_params, {"tokens": toks, "labels": torch.from_numpy(labels)}, TPOL))
    want = float(jcross_entropy(jmask(jnp.asarray(jax_side["dense_logits"]), V), jnp.asarray(labels)))
    assert abs(loss - want) <= 1e-5 * abs(want)
    store = WeightStore.pack(port_params)
    served = tm.prefill(store.tree, {"tokens": toks}, TSERVE)
    assert_close(served, jax_side["served_logits"], "served prefill logits")
    assert tkd.STATS.count("floatsd_matmul", "ref") == 8 * L + 1  # 8 weight sites a layer + the head


def test_prefill_routes_the_kernel_entry_point_only_for_full_chunks(port_params):
    tm = CausalLM(TCFG)
    for s, want in ((16, L), (24, 0), (1, 0)):
        tkd.STATS.reset()
        tm.prefill(port_params, {"tokens": torch.from_numpy(tokens(shape=(2, s)))}, TPOL)
        assert tkd.STATS.count("rwkv_wkv") == want, s


def test_decode_steps_and_caches_match_jax(jax_side, port_params):
    tm = CausalLM(TCFG)
    store = WeightStore.pack(port_params)
    cache = tm.init_cache(B, TPOL, "cpu")
    jc0 = JLM(JCFG).init_cache(B, None)
    for got, want in zip(tree_leaves(cache), jax.tree_util.tree_leaves(jc0)):
        assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[-1] == str(want.dtype)
    toks = torch.from_numpy(tokens())
    for t, (lg_j, cache_j) in enumerate(jax_side["steps"]):
        lg, cache = tm.decode_step(store.tree, toks[:, t:t + 1], cache, TSERVE)
        assert lg.shape == (B, 1, TCFG.vocab_padded())
        assert_close(lg, lg_j, f"decode logits step {t}")
        s_t = cache["stack"]["b0"]
        s_j = cache_j["stack"]["b0"]
        for name in ("s", "x_tm", "x_cm"):
            assert tuple(getattr(s_t, name).shape) == getattr(s_j, name).shape
            assert_close(getattr(s_t, name), getattr(s_j, name), f"cache {name} step {t}")


def test_prefill_logits_match_token_by_token_decode(port_params):
    """Chunked (the kernel entry point) against sequential, in the port."""
    tm = CausalLM(TCFG)
    tree = WeightStore.pack(port_params).tree
    toks = torch.from_numpy(tokens(seed=9))
    full = tm.prefill(tree, {"tokens": toks}, TSERVE)
    cache = tm.init_cache(B, TSERVE, "cpu")
    for t in range(S):
        lg, cache = tm.decode_step(tree, toks[:, t:t + 1], cache, TSERVE)
        assert_close(lg[:, 0], full[:, t], f"position {t}")


@pytest.mark.parametrize("source", ["numpy", "jax_init"])
def test_pack_tree_byte_identical_to_jax(source):
    if source == "numpy":
        jp = jax.tree_util.tree_map(jnp.asarray, np_params())
    else:
        jp = JLM(JCFG).init(jax.random.PRNGKey(3))  # constant w0 = -6, u = 0, norms 1 / 0
    want = jpack_tree(jp)
    store = WeightStore.pack(bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    got_flat, want_flat = _flat(store.tree), _flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    n_packed = 0
    for key, w in want_flat.items():
        g = got_flat[key]
        if hasattr(w, "codes"):
            n_packed += 1
            assert tkd.is_packed(g) and g.codes.dtype == torch.uint8, key
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes), err_msg=key)
            assert g.bias == int(w.bias), key
        else:
            assert key.startswith("final_norm/") and torch.equal(g, torch.from_numpy(np.array(w)))
    assert n_packed == store.n_packed == 20  # every stacked leaf, norms included; the final norm dense
    assert store.packed_nbytes == tree_nbytes(store.tree) == int(jtree_nbytes(want))


def test_full_width_store_bytes_from_the_reference_shapes():
    """The resident bytes chip_smoke.py asserts: the port's ``tree_nbytes``
    over a packed tree of the full-width reference shapes (no tensor is
    materialised: meta tensors carry the shapes)."""
    shapes = jax.eval_shape(JLM(jget_config("rwkv6_3b")).init, jax.random.PRNGKey(0))

    def meta(sds):
        if len(sds.shape) >= 2:
            return tkd.PackedTensor(torch.empty(sds.shape, dtype=torch.uint8, device="meta"), 0)
        return torch.empty(sds.shape, dtype=torch.float32, device="meta")

    tree = jax.tree_util.tree_map(meta, shapes)
    n_params = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_params == 2_905_707_520
    assert tree_nbytes(tree) == 2_905_722_960


def _decisive(streams, refs):
    """Tokens of each request up to the first near-tie of the port's own
    logits."""
    n_all = 0
    for rid, (out, ref) in enumerate(zip(streams, refs)):
        n = next((i for i, g in enumerate(out.margins) if g <= MARGIN_FLOOR), len(out.out))
        assert out.out[:n] == ref[:n], (rid, out.out, ref, n)
        n_all += n
    return n_all


def test_engine_tokens_match_jax_and_lockstep_guards(jax_side, port_params):
    eng = ServeEngine(CausalLM(TCFG), port_params, TPOL, lanes=LANES, chunk=4)
    assert eng.chunk == 1 and jax_side["engine"].chunk == 1
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    tkd.STATS.reset()
    m = eng.run()
    reqs = sorted(reqs, key=lambda r: r.rid)
    assert all(r.status == "done" and len(r.out) == MAX_NEW for r in reqs)
    assert m.prefill_steps == 0 and m.decode_steps == m.steps
    assert _decisive(reqs, jax_side["streams"]) >= LANES * MAX_NEW // 2
    assert tkd.STATS.count(backend="cuda") == 0 and tkd.STATS.count("rwkv_wkv") == 0  # S = 1: sequential
    # the lanes are used: the next request cannot re-arm one, in both packages
    for e in (eng, jax_side["engine"]):
        e.submit(prompts()[0].copy(), max_new=2)
        with pytest.raises(RuntimeError, match="cannot re-arm a used lane"):
            e.step_once()
    for e in (ServeEngine(CausalLM(TCFG), port_params, TPOL, lanes=LANES),
              JEngine(JLM(JCFG), jax_side["params"], JPOL, lanes=LANES, cache_len=64)):
        e.submit_all([p.copy() for p in prompts(LANES + 1)], max_new=2)
        with pytest.raises(ValueError, match="cannot be reset per.lane"):
            e.run()


def test_port_serves_a_store_the_jax_package_packed(jax_side, port_params):
    tree = bridge.from_jax_packed(jax_side["packed"], "cpu")
    assert tkd.is_packed(tree["stack"]["b0"]["norm1"]["scale"])
    assert tree["stack"]["b0"]["mixer"]["wr"].codes.shape == (L, D, D)
    outs = []
    for params in (tree, port_params):
        eng = ServeEngine(CausalLM(TCFG), params, TPOL, lanes=LANES)
        reqs = eng.submit_all([p.copy() for p in prompts()], max_new=4)
        eng.run()
        outs.append([r.out for r in sorted(reqs, key=lambda r: r.rid)])
    assert outs[0] == outs[1]


def test_cli_serves_the_reduced_rwkv_on_cpu(capsys):
    tserve.main(["--arch", "rwkv6_3b", "--device", "cpu", "--requests", "3", "--batch", "3",
                 "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("weights: ") and "20 tensors packed" in out[0]
    assert out[1].startswith("served 3 requests, 6 tokens")


@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirrors_jax_on_its_fields(reduced):
    import dataclasses

    jc, tc = jget_config("rwkv6_3b"), get_config("rwkv6_3b")
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.vocab_padded() == jc.vocab_padded()


def test_hoist_decodes_small_leaves_once_and_keeps_weight_sites_packed(port_params):
    from repro_torch.core import floatsd
    from repro_torch.nn.rwkv import WEIGHT_SITES

    tm = CausalLM(TCFG)
    tree = WeightStore.pack(port_params).tree
    hoisted = tm.hoist(tree)
    got, packed = _flat(hoisted["stack"]), _flat(tree["stack"])
    for key, w in packed.items():
        if key.split("/")[-1] in WEIGHT_SITES:
            assert got[key] is w, key  # codes stay for the matmul kernel
        else:
            assert torch.equal(got[key], floatsd.decode(w.codes, w.bias)), key
    assert sum(not tkd.is_packed(t) for t in got.values()) == 11
    assert hoisted["embed"]["table"] is tree["embed"]["table"]
    assert all(a is b for a, b in zip(_flat(tm.hoist(hoisted)).values(), _flat(hoisted).values()))
    toks = torch.from_numpy(tokens(shape=(2, 16)))
    assert torch.equal(tm.prefill(hoisted, {"tokens": toks}, TSERVE), tm.prefill(tree, {"tokens": toks}, TSERVE))
    eng = ServeEngine(tm, port_params, TPOL, lanes=LANES)
    assert not tkd.is_packed(eng.serve_params["stack"]["b0"]["norm1"]["scale"])
    assert tkd.is_packed(eng.serve_params["stack"]["b0"]["mixer"]["wr"])


def test_build_and_cache_contract():
    assert isinstance(build(TCFG), CausalLM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(ArchConfig(name="moe_x", family="moe", n_layers=2, d_model=64, vocab=128))
    cache = CausalLM(TCFG).init_cache(5, TPOL, "cpu")
    s = cache["stack"]["b0"]
    assert s.s.shape == (L, 5, H, HD, HD) and s.s.dtype == torch.float32
    assert s.x_tm.shape == s.x_cm.shape == (L, 5, D) and s.x_tm.dtype == torch.bfloat16
    assert all(t.abs().sum() == 0 for t in tree_leaves(tree_map(lambda t: t.float(), cache)))

