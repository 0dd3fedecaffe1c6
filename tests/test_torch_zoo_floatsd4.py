"""FloatSD4 serving of the zoo's stacked models, the port against the JAX
package, at each family's reduced config (dense ``h2o_danube3_4b``, ssm
``rwkv6_3b``, hybrid ``jamba_v01_52b``, moe ``dbrx_132b``, vlm
``qwen2_vl_2b``, audio ``whisper_large_v3``) and a 33-layer tiny dense
stack (layer 32 reads the second exponent plane; its store, layer planes
and streamed pack are compared, not its forward: over 33 random layers
the two frameworks' f32 sum orders part beyond the logits' rule).

The reference's FloatSD4 store nibble-packs and groups every leaf along its
axis 0, which for a stacked leaf is the layer axis: layer l's code of (k,
n) is nibble l & 1 of ``codes[l >> 1, k, n]``, its exponent ``exps[l >> 5,
k, n]``. Its engine decodes the whole tree each step; the port serves each
layer's code and exponent planes in place (``dispatch.LayerTensor4``).

Parameters are made with numpy from a seed in the reference layout and
handed to both packages. The JAX side packs each leaf of two or more axes
in a jitted program (``jpack4``: the reference's ``encode`` then
``pack4``), held to the reference's eager ``WeightStore.pack(...,
fmt="floatsd4")`` on a stacked weight site; its forward, engine step and
Whisper's prefill_cross are jitted once a family.

Tolerances (measured on the CPU):
  * the store: codes, exps and ``k`` byte-identical, leaf by leaf; the
    plane decode bit for bit the reference's ``unpack_tree`` slice of layer
    l; the plane product within 1e-6 of |x| @ |w| of it (a different sum
    order, the same products);
  * the forward on the FloatSD4 store with no activation quantizer (policy
    fp32 in both packages, the reference's on its decoded tree): |err| <=
    1e-4 of the scale (max(1, the largest magnitude compared)) except at
    most 0.5% of the elements, and <= 1e-3 of it everywhere, the rule of
    tests/test_torch_dense.py (a p on a bf16 rounding boundary in an
    attention flips, and the row it feeds moves);
  * greedy tokens: the JAX engine's (``weight_format="floatsd4"``, the
    served floatsd8_table6 policy) over each request's margin-decisive
    prefix (top-2 gap of the port's logits above 1e-4), at least half of
    them decisive; Whisper, which neither engine serves, through
    ``prefill_cross`` and ``decode_step`` in both packages;
  * the streamed two-pass pack: bytes equal to ``pack(init(None))`` in
    both formats.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import floatsd as jfloatsd  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels.dispatch import PackedTensor as JPackedTensor  # noqa: E402
from repro.kernels.dispatch import pack4 as jpack4_leaf  # noqa: E402
from repro.models.lm import CausalLM as JLM  # noqa: E402
from repro.models.whisper import Whisper as JWhisper  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving.weight_store import WeightStore as JWeightStore  # noqa: E402
from repro.serving.weight_store import tree_nbytes as jtree_nbytes  # noqa: E402
from repro.serving.weight_store import unpack_tree as junpack_tree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import floatsd4  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import CausalLM, Whisper, build  # noqa: E402
from repro_torch.serving import ServeEngine, WeightStore, synthetic_prompts, tree_nbytes  # noqa: E402
from repro_torch.serving import weight_store as tws  # noqa: E402

ARCHS = ["h2o_danube3_4b", "rwkv6_3b", "jamba_v01_52b", "dbrx_132b", "qwen2_vl_2b", "whisper_large_v3"]
SERVED = ARCHS[:-1]  # the engine serves every family but the audio one
B, S, V = 2, 32, 512
LANES, MAX_NEW, CACHE_LEN = 3, 6, 64  # lanes != 2 layers (masked_reset would read a layer as a lane)
TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
MM_TOL, MARGIN_FLOOR = 1e-6, 1e-4
JPOL, TPOL = jget_policy("floatsd8_table6"), get_policy("floatsd8_table6")
JFP32, TFP32 = jget_policy("fp32"), get_policy("fp32")
# a 33-layer dense stack at tiny widths: two exponent planes, an odd layer count
TINY = dict(n_layers=33, d_model=32, d_ff=64, n_heads=2, kv_heads=2, head_dim=16, vocab=64, window=None)


def cfgs(arch):
    if arch == "tiny":
        return (dataclasses.replace(jget_config("h2o_danube3_4b").reduced(), **TINY),
                dataclasses.replace(get_config("h2o_danube3_4b").reduced(), **TINY))
    return jget_config(arch).reduced(), get_config(arch).reduced()


def jmodel(jcfg):
    return JWhisper(jcfg) if jcfg.family == "audio" else JLM(jcfg)


def np_params(jcfg, seed=0):
    """Seeded numpy parameters in the reference layout: weights scaled by
    their fan-in, norm scales near 1, small biases and position tables, a
    unit-scale table, the RWKV mixes, decays and bonus in their ranges."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel(jcfg).init, jax.random.PRNGKey(0))

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "ln_scale"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "mix":
            return rng.uniform(0.0, 1.0, shape).astype(np.float32)
        if name == "w0":
            return rng.uniform(-4.0, 0.5, shape).astype(np.float32)
        if name in ("b", "bias", "pos_dec", "pos_enc", "u", "w_lora_a", "w_lora_b"):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        sd = 1.0 if name == "table" or len(shape) < 2 else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


#: the reference's FloatSD4 encode of one leaf (its ``pack_tree``'s encode,
#: then ``pack4``), jitted: compiled once a shape for the module
_jpack4_leaf = jax.jit(lambda w: jpack4_leaf(JPackedTensor(*jfloatsd.encode(w))))


def jpack4(params):
    """The reference's FloatSD4 store of a numpy tree: every leaf of two or
    more axes packed, the others kept. A leaf is packed as [axis 0, columns]
    with the columns padded with zeros to a power of two, so few shapes
    compile: the FloatSD8 bias reads max|w| (zeros do not raise it) and the
    FloatSD4 codes and exponents of a column depend on that column alone."""

    def pack(w):
        if w.ndim < 2:
            return jnp.asarray(w)
        cols = w[0].size
        flat = np.zeros((w.shape[0], 1 << (cols - 1).bit_length()), np.float32)
        flat[:, :cols] = w.reshape(w.shape[0], cols)
        p = _jpack4_leaf(jnp.asarray(flat))
        return type(p)(p.codes[:, :cols].reshape(-1, *w.shape[1:]), p.exps[:, :cols].reshape(-1, *w.shape[1:]),
                       w.shape[0])

    return jax.tree_util.tree_map(pack, params)


def batch(jcfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.n_patches:
        out["patch_embeds"] = rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        out["frames"] = rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    return out


def prompts(vocab):
    return synthetic_prompts(LANES, vocab, np.random.default_rng(2), lo=3, hi=9)


def jenc_logits(jm, p, bd, pol):
    """Whisper's encoder states and its teacher-forced logits over them."""
    enc = jm.encode(p, bd["frames"], pol)
    return enc, jm.decode_seq(p, bd["tokens"], enc, pol)


def jgreedy(jm, p, frames, n):
    """Whisper's greedy tokens from token 7 through prefill_cross and
    decode_step, jitted once, under the served policy on the decoded tree."""
    pol = JPOL.replace(weight_quant="none")
    cache = jax.jit(lambda p, f, c: jm.prefill_cross(junpack_tree(p), f, c, pol))(
        p, frames, jm.init_cache(frames.shape[0], CACHE_LEN))
    step = jax.jit(lambda p, t, c: jm.decode_step(junpack_tree(p), t, c, pol))
    tok, out = jnp.full((frames.shape[0], 1), 7, jnp.int32), []
    for _ in range(n):
        lg, cache = step(p, tok, cache)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok[:, 0]))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def jax_side():
    """Per arch: the parameters, the reference's FloatSD4 store, its fp32
    logits on the decoded store (Whisper's encoder states too), and its
    engine's greedy streams (Whisper's decode steps). Each JAX program is
    compiled once for the module."""
    out = {}
    for arch in ARCHS + ["tiny"]:
        jcfg, _ = cfgs(arch)
        jm = jmodel(jcfg)
        params = np_params(jcfg)
        store = jpack4(params)
        bd = {k: jnp.asarray(v) for k, v in batch(jcfg).items()}
        r = dict(params=params, store=store)
        if arch == "tiny":  # its store and layer planes only (the module docstring)
            out[arch] = r
            continue
        if jcfg.family == "audio":  # the encoder states, and the decoder on them
            enc, logits = jax.jit(lambda p, b: jenc_logits(jm, junpack_tree(p), b, JFP32))(store, bd)
        else:
            enc, logits = None, jax.jit(lambda p, b: jm.forward(junpack_tree(p), b, JFP32)[0])(store, bd)
        r.update(logits=np.asarray(logits), enc=None if enc is None else np.array(enc))
        if arch in SERVED:
            eng = JEngine(jm, store, JPOL, lanes=LANES, cache_len=CACHE_LEN, weight_format="floatsd4")
            reqs = eng.submit_all([p.copy() for p in prompts(jcfg.vocab)], max_new=MAX_NEW)
            eng.run()
            r["streams"] = [q.out for q in sorted(reqs, key=lambda q: q.rid)]
        elif arch == "whisper_large_v3":
            r["greedy"] = jgreedy(jm, store, bd["frames"], MAX_NEW)
        out[arch] = r
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want), max(1.0, float(np.abs(want).max()))
    assert (err > tol * scale).mean() <= FLIP_SHARE and err.max() <= FLIP_TOL * scale, (
        what, float(err.max()) / scale, int((err > tol * scale).sum()), err.size)


def port_store(jax_side, arch):
    return WeightStore.pack(bridge.from_jax_params(jax_side[arch]["params"], "cpu"), fmt="floatsd4")


def assert_same_store(got, want):
    """Two FloatSD4 trees, leaf by leaf: codes, exps and k byte-identical."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if hasattr(w, "codes"):
            assert tkd.is_packed4(g) and g.k == int(w.k), key
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes), err_msg=key)
            np.testing.assert_array_equal(g.exps.numpy(), np.asarray(w.exps), err_msg=key)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)


@pytest.mark.parametrize("arch", ARCHS + ["tiny"])
def test_store_is_the_reference_floatsd4_store_leaf_by_leaf(jax_side, arch):
    store = port_store(jax_side, arch)
    assert_same_store(store.tree, jax_side[arch]["store"])
    assert store.fmt == "floatsd4" and store.packed_nbytes == int(jtree_nbytes(jax_side[arch]["store"]))
    if arch == "tiny":  # layer 32 reads the second exponent plane; 33 layers pad a nibble
        w = store.tree["stack"]["b0"]["mixer"]["wq"]["w"]
        assert w.k == 33 and w.codes.shape[0] == 17 and w.exps.shape[0] == 2


def test_jitted_reference_pack_is_its_eager_weight_store(jax_side):
    """The jitted packer against the reference's own ``WeightStore.pack(...,
    fmt="floatsd4")`` on a stacked weight site of the dense family (its
    eager encode compiles each op anew: 4 s a leaf)."""
    p = jax_side["h2o_danube3_4b"]["params"]
    sub = {"wq": p["stack"]["b0"]["mixer"]["wq"]["w"]}
    eager = JWeightStore.pack(jax.tree_util.tree_map(jnp.asarray, sub), fmt="floatsd4")
    assert eager.n_packed == 1
    want = jpack4(sub)
    for key, w in _flat(want).items():
        e = _flat(eager.tree)[key]
        np.testing.assert_array_equal(np.asarray(e.codes), np.asarray(w.codes), err_msg=key)
        np.testing.assert_array_equal(np.asarray(e.exps), np.asarray(w.exps), err_msg=key)
        assert int(e.k) == int(w.k), key


@pytest.mark.parametrize("arch,site", [("h2o_danube3_4b", "stack/b0/mlp/wi/w"), ("rwkv6_3b", "stack/b0/mixer/wr"),
                                       ("dbrx_132b", "stack/b0/mlp/wo"), ("tiny", "stack/b0/mixer/wo/w")])
def test_plane_product_is_x_at_the_reference_layer_slice(jax_side, arch, site):
    """Each layer's view of a stacked weight site: its decode bit for bit the
    reference's ``unpack_tree`` slice of layer l, the plain product within
    1e-6 of |x| @ |w| of x @ that slice (an MoE's experts each)."""
    w4 = _flat(port_store(jax_side, arch).tree)[site]
    dense = np.asarray(jax.jit(junpack_tree)(_flat(jax_side[arch]["store"])[site]))
    rng = np.random.default_rng(3)
    for layer in range(w4.k):
        view = tkd.layer_view4(w4, layer)
        got_w = floatsd4.decode_plane(view.codes, view.exps, view.nibble)
        np.testing.assert_array_equal(got_w.numpy(), dense[layer], err_msg=f"{site} layer {layer}")
        k = dense.shape[-2]
        if view.codes.dim() == 3:  # the experts: x [g, E, C, K]
            x = rng.standard_normal((1, dense.shape[1], 5, k)).astype(np.float32)
            got = tkd.packed_einsum("gecd,edh->gech", torch.from_numpy(x), view).numpy()
            want = np.einsum("gecd,edh->gech", x.astype(np.float64), dense[layer])
            bound = np.einsum("gecd,edh->gech", np.abs(x), np.abs(dense[layer]).astype(np.float64))
        else:
            x = rng.standard_normal((5, k)).astype(np.float32)
            got = tkd.matmul4(torch.from_numpy(x), view).numpy()
            want = x.astype(np.float64) @ dense[layer]
            bound = np.abs(x) @ np.abs(dense[layer]).astype(np.float64)
        assert np.all(np.abs(got - want) <= MM_TOL * bound + 1e-30), (site, layer)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_the_floatsd4_store_matches_jax(jax_side, arch):
    """The port's forward on its FloatSD4 store (the weight sites on the
    plane kernel's plain version, the small leaves hoisted) against the
    reference's on the decoded store, no activation quantizer; every weight
    site a floatsd4_matmul call. Whisper's encoder states, and its decoder
    on the reference's encoder states: a difference in the encoder reaches
    every row of its sequence through the cross-attention (end to end,
    0.53% of the logits beyond 1e-4 of the scale, at most 2.5e-4 of it;
    the encoder states 0, at most 5.6e-5; the decoder on the same states
    0.03%, at most 1.2e-4)."""
    jcfg, tcfg = cfgs(arch)
    tm, tree = build(tcfg), port_store(jax_side, arch).tree
    bd = {k: torch.from_numpy(v) for k, v in batch(jcfg).items()}
    j = jax_side[arch]
    tkd.STATS.reset()
    if j["enc"] is not None:
        assert_close(tm.encode(tree, bd["frames"], TFP32), j["enc"], f"{arch} encoder states")
        got = tm.decode_seq(tree, bd["tokens"], torch.from_numpy(j["enc"]), TFP32)
    else:
        got = tm.forward(tree, bd, TFP32)[0]
    assert_close(got, j["logits"], f"{arch} logits")
    stats = tkd.STATS.snapshot()
    assert stats.get(("floatsd4_matmul", "ref"), 0) > 0 and ("floatsd_matmul", "ref") not in stats


def _decisive(reqs, refs):
    n_all = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(r.margins) if g <= MARGIN_FLOOR), len(r.out))
        assert r.out[:n] == ref[:n], (r.rid, r.out, ref, n)
        n_all += n
    assert n_all >= LANES * MAX_NEW // 2
    return n_all


@pytest.mark.parametrize("arch", SERVED)
def test_engine_tokens_match_the_jax_floatsd4_engine_and_serve_its_store(jax_side, arch):
    """The port's engine from the dense parameters (packed to FloatSD4 at
    construction) against the JAX engine's greedy streams; the port's
    engine on the store the JAX package packed gives the same first two
    tokens of each stream as on its own."""
    _, tcfg = cfgs(arch)
    tm = CausalLM(tcfg)
    streams = []
    for params, n in ((bridge.from_jax_params(jax_side[arch]["params"], "cpu"), MAX_NEW),
                      (bridge.from_jax_packed(jax_side[arch]["store"], "cpu"), 2)):
        eng = ServeEngine(tm, params, TPOL, lanes=LANES, cache_len=CACHE_LEN, weight_format="floatsd4")
        assert eng.store.fmt == "floatsd4"
        reqs = eng.submit_all([p.copy() for p in prompts(tcfg.vocab)], max_new=n)
        tkd.STATS.reset()
        eng.run()
        assert tkd.STATS.count("floatsd_matmul") == 0 and tkd.STATS.count("floatsd4_matmul", "ref") > 0
        streams.append(sorted(reqs, key=lambda r: r.rid))
    _decisive(streams[0], jax_side[arch]["streams"])
    assert [r.out[:2] for r in streams[0]] == [r.out for r in streams[1]]


def test_whisper_greedy_tokens_match_jax_on_the_floatsd4_store(jax_side):
    """Whisper from its FloatSD4 store: the encoder once (prefill_cross),
    then greedy decode steps, against the reference's on its decoded store;
    the cross K and V projections and every decoder site on the planes."""
    arch = "whisper_large_v3"
    jcfg, tcfg = cfgs(arch)
    tm = Whisper(tcfg)
    tree = tm.hoist(port_store(jax_side, arch).tree)
    pol = TPOL.replace(weight_quant="none")
    frames = torch.from_numpy(batch(jcfg)["frames"])
    cache = tm.prefill_cross(tree, frames, tm.init_cache(B, pol, "cpu", cache_len=CACHE_LEN), pol)
    tok, out, margins = torch.full((B, 1), 7, dtype=torch.long), [], []
    for _ in range(MAX_NEW):
        lg, cache = tm.decode_step(tree, tok, cache, pol)
        top = torch.topk(lg[:, -1].float(), 2).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        tok = lg[:, -1].argmax(-1)[:, None]
        out.append(tok[:, 0].numpy())
    got, want, margins = np.stack(out, 1), jax_side[arch]["greedy"], np.stack(margins, 1)
    for lane in range(B):
        n = next((i for i, g in enumerate(margins[lane]) if g <= MARGIN_FLOOR), MAX_NEW)
        assert list(got[lane, :n]) == list(want[lane, :n]), (lane, got[lane], want[lane], n)


def test_cli_serves_the_reduced_dense_model_in_floatsd4_on_cpu(capsys):
    tserve.main(["--arch", "h2o_danube3_4b", "--device", "cpu", "--weight-format", "floatsd4",
                 "--requests", "2", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    # the reference's FloatSD4 store of the reduced model holds 363,520 bytes
    assert out[0].startswith("weights: ") and "packed FloatSD4" in out[0] and "363520 B resident" in out[0]
    assert out[1].startswith("served 2 requests, 4 tokens")


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "dbrx_132b", "tiny"])
@pytest.mark.parametrize("fmt", ["floatsd8", "floatsd4"])
def test_streamed_two_pass_pack_is_the_packed_init(arch, fmt, monkeypatch):
    """``pack_streamed``: a stack of several groups drawn twice (pass 1 for
    each leaf's max|w|, pass 2 encoding group by group), FloatSD4 converted
    from the FloatSD8 codes in slabs of axis 1 (a few columns a slab here);
    the bytes of ``pack(init(None), fmt=fmt)``."""
    monkeypatch.setattr(tws, "SLAB_BYTES", 4096)
    tm = CausalLM(cfgs(arch)[1])
    whole = WeightStore.pack(tm.init(torch.Generator().manual_seed(4)), fmt=fmt)
    streamed = WeightStore.pack_streamed(tm.init, 4, "cpu", fmt=fmt)
    a, b = _flat(whole.tree), _flat(streamed.tree)
    assert list(a) == list(b)
    for key, w in a.items():
        if tkd.is_any_packed(w):
            assert type(w) is type(b[key]) and torch.equal(w.codes, b[key].codes), key
            assert (w.bias == b[key].bias) if tkd.is_packed(w) else (torch.equal(w.exps, b[key].exps)
                                                                     and w.k == b[key].k), key
        else:
            assert torch.equal(w, b[key]), key
    assert (streamed.fmt, streamed.dense_nbytes, streamed.n_packed, streamed.packed_nbytes) == (
        whole.fmt, whole.dense_nbytes, whole.n_packed, whole.packed_nbytes)


def test_streamed_pack_refuses_a_nonfinite_stacked_leaf():
    tm = CausalLM(cfgs("h2o_danube3_4b")[1])

    def init(g, pack):
        return tm.init(g, each=lambda tree, at=None: pack(
            {**tree, "norm1": {"scale": tree["norm1"]["scale"] * float("nan")}} if at and at[1] == 1 else tree, at))

    with pytest.raises(ValueError, match="nonfinite"):
        WeightStore.pack_streamed(init, 4, "cpu")


def test_streamed_pack_refuses_a_second_draw_that_is_not_the_first():
    """An ``init`` that draws from a generator of its own, not the one it is
    handed, draws other numbers in pass 2: encoding them at pass 1's biases
    would build a wrong store, so the pack raises."""
    tm = CausalLM(cfgs("dbrx_132b")[1])
    own = torch.Generator().manual_seed(4)
    with pytest.raises(ValueError, match="second draw"):
        WeightStore.pack_streamed(lambda g, pack: tm.init(own, each=pack), 4, "cpu")


# the resident bytes chip_smoke.py asserts at full width, from the reference's
# shapes: FloatSD8 codes + a 4-byte bias a packed leaf; FloatSD4 ceil(k/2)
# code bytes + ceil(k/32) exponent bytes of each column; the 1-D leaves f32
FULL_BYTES = {"h2o_danube3_4b": (3_838_970_920, 2_078_169_600), "stablelm_3b": (2_667_253_820, 1_416_988_160),
              "phi4_mini_3p8b": (3_836_424_232, 2_038_106_112), "granite_20b": (20_014_781_496, 10_775_034_880)}


@pytest.mark.parametrize("arch", sorted(FULL_BYTES))
def test_full_width_store_bytes_from_the_reference_shapes(arch):
    shapes = jax.eval_shape(JLM(jget_config(arch)).init, jax.random.PRNGKey(0))

    def meta(sds, fmt):
        shape = sds.shape
        if len(shape) < 2:
            return torch.empty(shape, dtype=torch.float32, device="meta")
        if fmt == "floatsd8":
            return tkd.PackedTensor(torch.empty(shape, dtype=torch.uint8, device="meta"), 0)
        rest = shape[1:]
        return tkd.PackedTensor4(torch.empty((-(-shape[0] // 2), *rest), dtype=torch.uint8, device="meta"),
                                 torch.empty((-(-shape[0] // 32), *rest), dtype=torch.int8, device="meta"), shape[0])

    got = tuple(tree_nbytes(jax.tree_util.tree_map(lambda s: meta(s, f), shapes)) for f in ("floatsd8", "floatsd4"))
    assert got == FULL_BYTES[arch]
