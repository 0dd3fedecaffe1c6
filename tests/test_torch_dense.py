"""The port's dense-family serving slice against the JAX package, at the
reduced ``h2o_danube3_4b`` config (2 layers, d_model 128, 4 heads of 32
over 4 KV heads, d_ff 256, vocab 512, window 64, RoPE, rmsnorm, SwiGLU,
tied embeddings, policy floatsd8_table6), tested at S 128 so that the
window bites; and the forward logits of the reduced ``stablelm_3b``
(layernorm, biased q/k/v), ``phi4_mini_3p8b`` and ``granite_20b`` (MQA,
GELU).

Parameters are made with numpy from a seed in the reference layout (every
stack leaf stacked over the layers) and handed to both packages
(``repro_torch.bridge`` carries them across); the store test also packs
the JAX model's own init.

Tolerances (measured on the CPU):
  * logits, outputs and caches: |err| <= 1e-4 of the scale (max(1, the
    largest magnitude compared)) except at most 0.5% of the elements, and
    <= 1e-3 of it everywhere, the rule of tests/test_torch_rwkv.py: a value
    on an FP8 rounding boundary of ``quant_act``, or a p on a bf16
    boundary in the attention, flips, and the rows it feeds move. Loss
    within 1e-5 relative;
  * the port's prefill against its own token-by-token decode, with no
    activation quantizer (policy fp32) on the same codes, 96 positions:
    within 2e-3 of the logit scale. Prefill rounds p and v to bf16, decode
    reads keys and values from a bf16 cache; the JAX package's own gap on
    these weights and tokens is 5.27e-4 of the scale (119), the port's the
    same; at the JAX package's default init (logits below 1) it is 3.1e-3
    to 3.9e-3 absolute over three seeds;
  * packed store: codes, biases and bytes identical to ``pack_tree``;
  * greedy tokens: equal to the JAX engine's over each request's
    margin-decisive prefix (top-2 gap of the port's logits above 1e-4), at
    least half of all tokens decisive.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models.lm import CausalLM as JLM  # noqa: E402
from repro.models.lm import cross_entropy as jcross_entropy  # noqa: E402
from repro.models.lm import mask_padded_vocab as jmask  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.core import floatsd as jfloatsd  # noqa: E402
from repro.kernels.dispatch import PackedTensor as JPackedTensor  # noqa: E402
from repro.serving.weight_store import tree_nbytes as jtree_nbytes  # noqa: E402
from repro.serving.weight_store import unpack_tree as junpack_tree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import floatsd  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import CausalLM, build  # noqa: E402
from repro_torch.nn.transformer import WEIGHT_SITES  # noqa: E402
from repro_torch.serving import ServeEngine, WeightStore, synthetic_prompts, tree_nbytes  # noqa: E402

ARCH = "h2o_danube3_4b"
DENSE_ARCHS = [ARCH, "stablelm_3b", "phi4_mini_3p8b", "granite_20b"]
JCFG = jget_config(ARCH).reduced()
TCFG = get_config(ARCH).reduced()
L, D, H, KH, HD, DFF, V, WINDOW = 2, 128, 4, 4, 32, 256, 512, 64
B, S = 3, 128  # S > WINDOW: the window bites
LANES, MAX_NEW = 3, 8  # lanes != the 2 layers (masked_reset would read a layer as a lane)
CACHE_LEN, DECODE = 128, 72  # a ring of min(128, 64) slots, wrapped after 64 steps
SITES = 7  # weight sites a layer: wq, wk, wv, wo, wi, wg, wo (FFN)
TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
GAP_TOL = 2e-3
MARGIN_FLOOR = 1e-4
JPOL = jget_policy("floatsd8_table6")
TPOL = get_policy("floatsd8_table6")
JSERVE, TSERVE = JPOL.replace(weight_quant="none"), TPOL.replace(weight_quant="none")


#: the reference's ``pack_tree``, its ``floatsd.encode`` at every leaf of two
#: or more axes, in one jitted program compiled once for the module: the same
#: codes and biases as its eager form, which compiles each leaf's ops anew
#: (12 s for the reduced RWKV-6 tree); the reference's engine, handed the
#: packed tree, packs it no more (tests/test_torch_hybrid.py packs so too)
jpack_tree = jax.jit(lambda p: jax.tree_util.tree_map(
    lambda w: JPackedTensor(*jfloatsd.encode(w)) if w.ndim >= 2 else w, p))


def np_params(jcfg=JCFG, seed=0):
    """Seeded numpy parameters in the reference layout, one array per leaf
    of the JAX model's tree: weights scaled by their fan-in, norm scales
    near 1, small biases, a unit-scale table (decisive logit margins)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name in ("bias", "b"):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        sd = 1.0 if name == "table" else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX logits (dense fake-quant and the unpacked store), decode steps and
    engine streams: each JAX program compiled once for the module."""
    jm = JLM(JCFG)
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    packed = jpack_tree(params)
    toks = jnp.asarray(tokens())
    dense_logits = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, JPOL)[0])(params, toks)
    served_logits = jax.jit(lambda p, t: jm.forward(junpack_tree(p), {"tokens": t}, JSERVE)[0])(packed, toks)
    step = jax.jit(lambda p, t, c: jm.decode_step(junpack_tree(p), t, c, JSERVE))
    cache = jm.init_cache(B, CACHE_LEN)
    steps = []
    for t in range(DECODE):
        lg, cache = step(packed, toks[:, t:t + 1], cache)
        steps.append((np.asarray(lg), jax.tree_util.tree_map(np.asarray, cache)))
    eng = JEngine(jm, packed, JPOL, lanes=LANES, chunk=4, cache_len=CACHE_LEN)
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
    assert "stack/b0/mixer/wq/w" in want and "stack/b0/mlp/wg/w" in want


def test_forward_loss_and_prefill_match_jax(jax_side, port_params):
    tm = CausalLM(TCFG)
    toks = torch.from_numpy(tokens())
    labels = tokens(seed=7)
    tkd.STATS.reset()
    logits, aux = tm.forward(port_params, {"tokens": toks}, TPOL)
    assert logits.shape == (B, S, TCFG.vocab_padded()) and float(aux) == 0.0
    assert_close(logits, jax_side["dense_logits"], "dense logits")
    assert tkd.STATS.snapshot() == {("flash_attention", "ref"): L}  # one a layer, plain on the CPU
    loss = float(tm.loss(port_params, {"tokens": toks, "labels": torch.from_numpy(labels)}, TPOL))
    want = float(jcross_entropy(jmask(jnp.asarray(jax_side["dense_logits"]), V), jnp.asarray(labels)))
    assert abs(loss - want) <= 1e-5 * abs(want)
    store = WeightStore.pack(port_params)
    tkd.STATS.reset()
    served = tm.prefill(store.tree, {"tokens": toks}, TSERVE)
    assert_close(served, jax_side["served_logits"], "served prefill logits")
    assert tkd.STATS.snapshot() == {("floatsd_matmul", "ref"): SITES * L + 1, ("flash_attention", "ref"): L}


def test_decode_steps_and_caches_match_jax_past_the_ring_wrap(jax_side, port_params):
    tm = CausalLM(TCFG)
    store = WeightStore.pack(port_params)
    cache = tm.init_cache(B, TPOL, "cpu", cache_len=CACHE_LEN)
    jc0 = JLM(JCFG).init_cache(B, CACHE_LEN)
    for got, want in zip(tree_leaves(cache), jax.tree_util.tree_leaves(jc0)):
        assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[-1] == str(want.dtype)
    assert cache["stack"]["b0"].k.shape == (L, B, WINDOW, KH, HD)
    toks = torch.from_numpy(tokens())
    for t, (lg_j, cache_j) in enumerate(jax_side["steps"]):
        lg, cache = tm.decode_step(store.tree, toks[:, t:t + 1], cache, TSERVE)
        assert lg.shape == (B, 1, TCFG.vocab_padded())
        assert_close(lg, lg_j, f"decode logits step {t}")
        c_t, c_j = cache["stack"]["b0"], cache_j["stack"]["b0"]
        for name in ("k", "v"):
            assert_close(getattr(c_t, name).float(), np.asarray(getattr(c_j, name), np.float32),
                         f"cache {name} step {t}")
        np.testing.assert_array_equal(c_t.pos.numpy(), c_j.pos)
    assert int(cache["stack"]["b0"].pos[0]) == DECODE > WINDOW


def test_prefill_logits_match_token_by_token_decode(port_params):
    """The kernel entry point's plain version (bf16 p and v) against the
    ring-buffer decode (bf16 cache), in the port, with no activation
    quantizer, past the window."""
    tm = CausalLM(TCFG)
    tree = tm.hoist(WeightStore.pack(port_params).tree)
    fp32 = get_policy("fp32")
    toks = torch.from_numpy(tokens(seed=9, shape=(2, 96)))
    full = tm.prefill(tree, {"tokens": toks}, fp32)
    cache = tm.init_cache(2, fp32, "cpu", cache_len=CACHE_LEN)
    scale = max(1.0, float(full.abs().max()))
    for t in range(toks.shape[1]):
        lg, cache = tm.decode_step(tree, toks[:, t:t + 1], cache, fp32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) <= GAP_TOL * scale, t


@pytest.mark.parametrize("source", ["numpy", "jax_init"])
def test_pack_tree_byte_identical_to_jax(source):
    if source == "numpy":
        jp = jax.tree_util.tree_map(jnp.asarray, np_params())
    else:
        jp = JLM(JCFG).init(jax.random.PRNGKey(3))
    want = jpack_tree(jp)
    store = WeightStore.pack(bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    got_flat, want_flat = _flat(store.tree), _flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    for key, w in want_flat.items():
        g = got_flat[key]
        if hasattr(w, "codes"):
            assert tkd.is_packed(g) and g.codes.dtype == torch.uint8, key
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes), err_msg=key)
            assert g.bias == int(w.bias), key
        else:
            assert key == "final_norm/scale" and torch.equal(g, torch.from_numpy(np.array(w)))
    assert store.n_packed == 10  # 9 stacked leaves (2 norms, 7 weight sites) + the table
    assert store.packed_nbytes == tree_nbytes(store.tree) == int(jtree_nbytes(want))


def test_full_width_store_bytes_from_the_reference_shapes():
    """The resident bytes chip_smoke.py asserts: the port's ``tree_nbytes``
    over a packed tree of the full-width reference shapes (meta tensors
    carry the shapes)."""
    shapes = jax.eval_shape(JLM(jget_config(ARCH)).init, jax.random.PRNGKey(0))

    def meta(sds):
        if len(sds.shape) >= 2:
            return tkd.PackedTensor(torch.empty(sds.shape, dtype=torch.uint8, device="meta"), 0)
        return torch.empty(sds.shape, dtype=torch.float32, device="meta")

    tree = jax.tree_util.tree_map(meta, shapes)
    n_params = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_params == 3_838_959_360
    assert tree_nbytes(tree) == 3_838_970_920
    # the engine's KV cache at 8 lanes and 2048 positions (+ 24 int32 positions), both packages
    jcache = jax.eval_shape(lambda: JLM(jget_config(ARCH)).init_cache(8, 2048))
    tcache = CausalLM(get_config(ARCH)).init_cache(8, TPOL, "meta", cache_len=2048)
    for c in (tcache, jcache):
        leaves = tree_leaves(c) if c is tcache else jax.tree_util.tree_leaves(c)
        assert sum(int(np.prod(t.shape)) * t.dtype.itemsize for t in leaves) == 1_509_949_440 + 24 * 4


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
    eng = ServeEngine(CausalLM(TCFG), port_params, TPOL, lanes=LANES, chunk=4, cache_len=CACHE_LEN)
    assert eng.chunk == 1 and jax_side["engine"].chunk == 1
    assert eng.pool.caches["stack"]["b0"].k.shape == (L, LANES, WINDOW, KH, HD)
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    tkd.STATS.reset()
    m = eng.run()
    reqs = sorted(reqs, key=lambda r: r.rid)
    assert all(r.status == "done" and len(r.out) == MAX_NEW for r in reqs)
    assert m.prefill_steps == 0 and m.decode_steps == m.steps
    assert _decisive(reqs, jax_side["streams"]) >= LANES * MAX_NEW // 2
    # every step decodes: the attention is the ring buffer's, not the kernel entry point
    assert tkd.STATS.count(backend="cuda") == 0 and tkd.STATS.count("flash_attention") == 0
    assert tkd.STATS.count("floatsd_matmul", "ref") == (SITES * L + 1) * m.steps
    for e in (eng, jax_side["engine"]):
        e.submit(prompts()[0].copy(), max_new=2)
        with pytest.raises(RuntimeError, match="cannot re-arm a used lane"):
            e.step_once()
    with pytest.raises(ValueError, match="cache_len"):
        ServeEngine(CausalLM(TCFG), port_params, TPOL, lanes=LANES)


def test_port_serves_a_store_the_jax_package_packed(jax_side, port_params):
    tree = bridge.from_jax_packed(jax_side["packed"], "cpu")
    assert tkd.is_packed(tree["stack"]["b0"]["norm1"]["scale"])
    assert tree["stack"]["b0"]["mixer"]["wq"]["w"].codes.shape == (L, D, H * HD)
    outs = []
    for params in (tree, port_params):
        eng = ServeEngine(CausalLM(TCFG), params, TPOL, lanes=LANES, cache_len=CACHE_LEN)
        reqs = eng.submit_all([p.copy() for p in prompts()], max_new=4)
        eng.run()
        outs.append([r.out for r in sorted(reqs, key=lambda r: r.rid)])
    assert outs[0] == outs[1]


def test_cli_serves_the_reduced_dense_model_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--batch", "3", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("weights: ") and "10 tensors packed" in out[0]
    assert out[1].startswith("served 3 requests, 6 tokens")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_config_mirrors_jax_on_its_fields(arch, reduced):
    jc, tc = jget_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.vocab_padded() == jc.vocab_padded() and tc.hd == jc.hd


def test_hoist_keeps_every_weight_site_packed(port_params):
    tm = CausalLM(get_config("stablelm_3b").reduced())  # biased q/k/v, layernorm
    params = bridge.from_jax_params(np_params(jget_config("stablelm_3b").reduced()), "cpu")
    tree = WeightStore.pack(params).tree
    hoisted = tm.hoist(tree)
    got, packed = _flat(hoisted["stack"]), _flat(tree["stack"])
    sites = [k for k in packed if k.split("/")[-1] in WEIGHT_SITES]
    assert len(sites) == SITES and all(k.endswith("/w") for k in sites)
    for key, w in packed.items():
        if key in sites:
            assert got[key] is w, key  # codes stay for the matmul kernel
        else:
            assert torch.equal(got[key], floatsd.decode(w.codes, w.bias)), key
    assert sorted(k for k in got if not tkd.is_packed(got[k])) == sorted(
        f"b0/{n}" for n in ("norm1/scale", "norm1/bias", "norm2/scale", "norm2/bias",
                            "mixer/wq/b", "mixer/wk/b", "mixer/wv/b"))
    eng = ServeEngine(tm, params, TPOL, lanes=LANES, cache_len=CACHE_LEN)
    assert tkd.is_packed(eng.serve_params["stack"]["b0"]["mlp"]["wo"]["w"])


@pytest.mark.parametrize("mods", [{}, {"attn": "attn"}, {"attn": "attn", "ffn_mod": "ffn", "rwkv_mod": "rwkv"},
                                  {"ffn_mod": "ffn", "cmix_mod": "cmix"}])
def test_block_takes_one_pair_of_modules(mods):
    """A Block is attention + FFN or RWKV time + channel mix, read from the
    modules it is given; any other set raises."""
    from repro_torch.nn.transformer import Block

    block = CausalLM(get_config(ARCH).reduced())._block()
    assert block.attn is not None and block.ffn_mod is not None and block.rwkv_mod is None
    real = {"attn": block.attn, "ffn": block.ffn_mod, "rwkv": object(), "cmix": object()}
    with pytest.raises(ValueError, match="attn and ffn_mod, or rwkv_mod and cmix_mod"):
        Block(block.dim, **{k: real[v] for k, v in mods.items()})


@pytest.mark.parametrize("arch", DENSE_ARCHS[1:])
def test_other_dense_configs_forward_logits_match_jax(arch):
    """stablelm_3b (layernorm, biased q/k/v, MHA), phi4_mini_3p8b (GQA in
    full, 4 of 4 reduced) and granite_20b (MQA, GELU) at their reduced
    configs: dense fake-quant forward logits."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    p = np_params(jcfg, seed=4)
    toks = tokens(seed=5, shape=(2, 32))
    want = jax.jit(lambda p, t: JLM(jcfg).forward(p, {"tokens": t}, JPOL)[0])(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(toks))
    got, _ = build(tcfg).forward(bridge.from_jax_params(p, "cpu"), {"tokens": torch.from_numpy(toks)}, TPOL)
    assert_close(got, want, arch)
