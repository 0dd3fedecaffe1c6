"""The port's ``audio`` family (``Whisper``) against the JAX package, at the
reduced ``whisper_large_v3`` config (2 encoder + 2 decoder layers, d_model
128, 4 heads of 32, d_ff 256 GELU, LayerNorm, qkv bias, vocab 512, 16 stub
frames, tied, policy floatsd8_table6): encode, decode_seq and loss, the
cross-attention caches of ``prefill_cross``, decode steps, an 8-token
greedy loop, the packed store, the CLI's refusal, and the resident and
cross-KV bytes of the full width from the reference's shapes.

Parameters and stub frames are made with numpy from a seed in the
reference layout and handed to both packages (``repro_torch.bridge``
carries them across).

Tolerances (measured on the CPU):
  * encoder states, logits and caches: |err| <= 1e-4 of the scale (max(1,
    the largest magnitude compared)) except at most 0.5% of the elements,
    and <= 1e-3 of it everywhere, the rule of tests/test_torch_dense.py (an
    FP8 rounding flip of ``quant_act`` moves the rows it feeds). Loss
    within 1e-5 relative. ``decode_seq`` and the loss are compared with the
    FloatSD8 weights and no activation quantizer (``WPOL``): under
    floatsd8_table6 one FP8 activation flip at position 3 of sequence 1
    reaches every later position of that sequence through the causal
    self-attention, by up to 1.9e-2 of the scale (the encoder states, before
    it, agree bit for bit); with no activation quantizer the logits agree
    bit for bit. The encoder and the decode steps run floatsd8_table6;
  * greedy tokens: the port's own loop equals the JAX loop over its
    margin-decisive prefix (top-2 gap of the port's logits above 1e-4), at
    least half of all tokens decisive;
  * the port's teacher-forced ``decode_seq`` against its own
    ``prefill_cross`` + token-by-token ``decode_step`` with no activation
    quantizer (policy fp32) on the same codes: within 2e-3 of the logit
    scale, tests/test_torch_dense.py's GAP_TOL (``decode_seq`` rounds the
    attentions' p and v to bf16, decode reads bf16 self and cross caches);
  * packed store: codes, biases and bytes identical to ``pack_tree``.
"""
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
from repro.models.lm import cross_entropy as jcross_entropy  # noqa: E402
from repro.models.lm import mask_padded_vocab as jmask  # noqa: E402
from repro.models.whisper import Whisper as JWhisper  # noqa: E402
from repro.serving.weight_store import tree_nbytes as jtree_nbytes  # noqa: E402
from repro.serving.weight_store import unpack_tree as junpack_tree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import Whisper, build  # noqa: E402
from repro_torch.serving import WeightStore, tree_nbytes  # noqa: E402

ARCH = "whisper_large_v3"
JCFG, TCFG = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
L, LE, D, H, HD, V, F = 2, 2, 128, 4, 32, 512, 16
B, S = 2, 12
CACHE_LEN, GREEDY, START = 32, 8, 7
SITES = 4 + 4 + 2  # decoder weight sites a layer: self q, k, v, o; cross q, k, v, o; FFN wi, wo
ENC_SITES = 4 + 2
TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
GAP_TOL, MARGIN_FLOOR = 2e-3, 1e-4
JPOL, TPOL = jget_policy("floatsd8_table6"), get_policy("floatsd8_table6")
JSERVE, TSERVE = JPOL.replace(weight_quant="none"), TPOL.replace(weight_quant="none")
_NO_ACT = dict(act_fwd="none", act_bwd="none", first_layer_act="none", last_layer_act="none")
JWPOL, WPOL = JPOL.replace(**_NO_ACT), TPOL.replace(**_NO_ACT)  # FloatSD8 weights, no activation quantizer
# the full width chip_smoke.py serves: FloatSD8 codes from the shapes, + a
# 4-byte bias a packed leaf (38) + the f32 ln_enc and ln_dec (4 x 1280 x 4)
FULL_CODE_BYTES = 1_542_466_560
FULL_BYTES = FULL_CODE_BYTES + 38 * 4 + 4 * 1280 * 4
FULL_CROSS_BYTES = 1_966_080_000  # 32 layers x 8 lanes x 1500 frames x 1280 x 2 (K, V) x 2 B


def np_params(jcfg=JCFG, seed=0):
    """Seeded numpy parameters in the reference layout: weights scaled by
    their fan-in, norm scales near 1, small biases and position tables, a
    unit-scale table."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JWhisper(jcfg).init, jax.random.PRNGKey(0))

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name in ("b", "bias", "pos_dec", "pos_enc"):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        sd = 1.0 if name == "table" else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def frames(seed=2, b=B):
    return np.random.default_rng(seed).standard_normal((b, F, D)).astype(np.float32)


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
    """{"a/b": leaf} of nested dicts and NamedTuples (the caches); a
    packed tensor is a leaf."""
    out = {}
    items = tree._asdict().items() if hasattr(tree, "_fields") else tree.items()
    for k, v in items:
        if isinstance(v, dict) or (hasattr(v, "_fields") and not hasattr(v, "codes")):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's encoder states, teacher-forced logits and loss (dense
    fake-quant; the last two with no activation quantizer), then from its packed store: prefill_cross's caches and a
    greedy loop of GREEDY decode steps from START with each step's logits
    and caches. Each JAX program is compiled once for the module."""
    jm = JWhisper(JCFG)
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    packed = jax.jit(lambda p: jax.tree_util.tree_map(
        lambda w: JPackedTensor(*jfloatsd.encode(w)) if w.ndim >= 2 else w, p))(params)
    fr, toks = jnp.asarray(frames()), jnp.asarray(tokens())
    def dense(p, f, t, labels):
        logits = jm.decode_seq(p, t, jm.encode(p, f, JWPOL), JWPOL)
        # the reference's Whisper.loss on these logits: the padded vocab masked, then the cross entropy
        return jm.encode(p, f, JPOL), logits, jcross_entropy(jmask(logits, V), labels)

    enc, logits, loss = jax.jit(dense)(params, fr, toks, jnp.asarray(tokens(seed=7)))
    cache = jax.jit(lambda p, f, c: jm.prefill_cross(junpack_tree(p), f, c, JSERVE))(
        packed, fr, jm.init_cache(B, CACHE_LEN))
    step = jax.jit(lambda p, t, c: jm.decode_step(junpack_tree(p), t, c, JSERVE))
    tok, steps = jnp.full((B, 1), START, jnp.int32), []
    for _ in range(GREEDY):
        lg, cache = step(packed, tok, cache)
        steps.append((np.asarray(tok), np.asarray(lg), jax.tree_util.tree_map(np.asarray, cache)))
        tok = jnp.argmax(lg[:, -1, :V], axis=-1).astype(jnp.int32)[:, None]
    return dict(params=params, packed=packed, enc=np.asarray(enc), logits=np.asarray(logits), loss=float(loss),
                steps=steps)


@pytest.fixture(scope="module")
def port_params():
    return bridge.from_jax_params(np_params(), "cpu")


def test_init_shapes_match_jax():
    jp = jax.eval_shape(JWhisper(JCFG).init, jax.random.PRNGKey(0))
    tm = build(TCFG)
    assert isinstance(tm, Whisper)
    tp = tm.init(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in _flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == want
    assert want["pos_dec"] == (4096, D) and want["pos_enc"] == (F, D) and want["dec/cross_attn/wk/b"] == (L, D)


def test_encode_decode_seq_and_loss_match_jax(jax_side, port_params):
    tm = Whisper(TCFG)
    fr, toks = torch.from_numpy(frames()), torch.from_numpy(tokens())
    tkd.STATS.reset()
    enc = tm.encode(port_params, fr, TPOL)
    assert_close(enc, jax_side["enc"], "encoder states")
    assert tkd.STATS.snapshot() == {("flash_attention", "ref"): LE}
    assert tkd.STATS.last["flash_attention"].cost.flops > 0
    logits = tm.decode_seq(port_params, toks, tm.encode(port_params, fr, WPOL), WPOL)
    assert logits.shape == (B, S, TCFG.vocab_padded())
    assert_close(logits, jax_side["logits"], "decode_seq logits")
    assert tkd.STATS.snapshot() == {("flash_attention", "ref"): 2 * LE + 2 * L}  # self and cross a layer
    loss = float(tm.loss(port_params, {"frames": fr, "tokens": toks, "labels": torch.from_numpy(tokens(seed=7))},
                         WPOL))
    assert abs(loss - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])
    # past 4096 positions the position table repeats, as the reference tiles it
    table = torch.arange(4096 * 2, dtype=torch.float32).reshape(4096, 2)
    assert torch.equal(table.repeat(2, 1)[:4100], torch.cat([table, table[:4]]))


def test_prefill_cross_and_decode_steps_match_jax(jax_side, port_params):
    """The JAX greedy loop's tokens fed to the port's decode_step on its own
    packed store: logits and the self and cross caches every step."""
    tm = Whisper(TCFG)
    store = WeightStore.pack(port_params)
    cache = tm.init_cache(B, TPOL, "cpu", cache_len=CACHE_LEN)
    assert cache["cross_k"].data_ptr() != cache["cross_v"].data_ptr()  # two tensors (one array in the reference)
    tkd.STATS.reset()
    cache = tm.prefill_cross(store.tree, torch.from_numpy(frames()), cache, TSERVE)
    assert tkd.STATS.count("floatsd_matmul", "ref") == LE * ENC_SITES + 2 * L
    for t, (tok, lg_j, cache_j) in enumerate(jax_side["steps"]):
        tkd.STATS.reset()
        lg, cache = tm.decode_step(store.tree, torch.from_numpy(tok.copy()), cache, TSERVE)
        assert tkd.STATS.snapshot() == {("floatsd_matmul", "ref"): (SITES - 2) * L + 1}  # cross K, V cached
        assert lg.shape == (B, 1, TCFG.vocab_padded())
        assert_close(lg, lg_j, f"decode logits step {t}")
        got, want = _flat(cache), _flat(cache_j)
        assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "self/k", "self/pos", "self/v"]
        for key in ("cross_k", "cross_v", "self/k", "self/v"):
            assert got[key].dtype == torch.bfloat16 and tuple(got[key].shape) == want[key].shape
            assert_close(got[key].float(), np.asarray(want[key], np.float32), f"{key} step {t}")
        np.testing.assert_array_equal(got["self/pos"].numpy(), want["self/pos"])


def test_greedy_loop_tokens_match_jax(jax_side, port_params):
    tm = Whisper(TCFG)
    tree = tm.hoist(WeightStore.pack(port_params).tree)
    cache = tm.prefill_cross(tree, torch.from_numpy(frames()), tm.init_cache(B, TPOL, "cpu", cache_len=CACHE_LEN),
                             TSERVE)
    tok, out, margins = torch.full((B, 1), START, dtype=torch.int32), [], []
    for _ in range(GREEDY):
        lg, cache = tm.decode_step(tree, tok, cache, TSERVE)
        top2 = torch.topk(lg[:, -1, :V], 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).numpy())
        tok = torch.argmax(lg[:, -1, :V], dim=-1).to(torch.int32)[:, None]
        out.append(tok[:, 0].numpy())
    got, margins = np.stack(out, 1), np.stack(margins, 1)
    want = np.concatenate([s[0] for s in jax_side["steps"][1:]] + [np.argmax(
        jax_side["steps"][-1][1][:, -1, :V], axis=-1)[:, None]], axis=1)
    decisive = 0
    for b in range(B):
        n = next((i for i, g in enumerate(margins[b]) if g <= MARGIN_FLOOR), GREEDY)
        assert got[b, :n].tolist() == want[b, :n].tolist(), (b, got[b], want[b], n)
        decisive += n
    assert decisive >= B * GREEDY // 2


def test_decode_seq_matches_token_by_token_decode(port_params):
    tm = Whisper(TCFG)
    tree = tm.hoist(WeightStore.pack(port_params).tree)
    fp32 = get_policy("fp32")
    fr, toks = torch.from_numpy(frames(seed=4)), torch.from_numpy(tokens(seed=9))
    full = tm.decode_seq(tree, toks, tm.encode(tree, fr, fp32), fp32)
    cache = tm.prefill_cross(tree, fr, tm.init_cache(B, fp32, "cpu", cache_len=CACHE_LEN), fp32)
    scale = max(1.0, float(full.abs().max()))
    for t in range(S):
        lg, cache = tm.decode_step(tree, toks[:, t:t + 1], cache, fp32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) <= GAP_TOL * scale, t


def test_pack_tree_byte_identical_to_jax(jax_side, port_params):
    want = jax_side["packed"]
    store = WeightStore.pack(port_params)
    got_flat, want_flat = _flat(store.tree), _flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    for key, w in want_flat.items():
        g = got_flat[key]
        if hasattr(w, "codes"):
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes), err_msg=key)
            assert g.bias == int(w.bias), key
        else:
            assert key.startswith(("ln_enc/", "ln_dec/")) and torch.equal(g, torch.from_numpy(np.array(w)))
    # 13 encoder + 22 decoder stacked leaves, the table, both position tables
    assert store.n_packed == 38
    assert store.packed_nbytes == tree_nbytes(store.tree) == int(jtree_nbytes(want))
    tree = Whisper(TCFG).hoist(bridge.from_jax_packed(want, "cpu"))
    assert tkd.is_packed(tree["embed"]["table"]) and tkd.is_packed(tree["dec"]["cross_attn"]["wk"]["w"])
    assert not tkd.is_packed(tree["pos_dec"]) and not tkd.is_packed(tree["dec"]["ln_x"]["scale"])


def test_full_width_store_and_cross_kv_bytes_from_the_reference_shapes():
    """The resident and cross-KV bytes chip_smoke.py asserts, from the
    reference's full-width shapes (meta tensors carry them)."""
    cfg = jget_config(ARCH)
    shapes = jax.eval_shape(JWhisper(cfg).init, jax.random.PRNGKey(0))

    def meta(sds):
        if len(sds.shape) >= 2:
            return tkd.PackedTensor(torch.empty(sds.shape, dtype=torch.uint8, device="meta"), 0)
        return torch.empty(sds.shape, dtype=torch.float32, device="meta")

    tree = jax.tree_util.tree_map(meta, shapes)
    packed = [x for x in tree_leaves(tree, is_leaf=tkd.is_packed) if tkd.is_packed(x)]
    assert len(packed) == 38 and sum(x.codes.numel() for x in packed) == FULL_CODE_BYTES
    assert tree_nbytes(tree) == FULL_BYTES
    jcache = jax.eval_shape(lambda: JWhisper(cfg).init_cache(8, 2048))
    tcache = Whisper(get_config(ARCH)).init_cache(8, TPOL, "meta", cache_len=2048)
    for c in (tcache, jcache):
        leaves = {k: v for k, v in _flat(c).items()}
        assert sum(int(np.prod(leaves[k].shape)) * leaves[k].dtype.itemsize
                   for k in ("cross_k", "cross_v")) == FULL_CROSS_BYTES


def test_cli_refuses_whisper_with_the_reason():
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--batch", "2"])
    assert "feeds no encoder input" in str(e.value.code) and "prefill_cross" in str(e.value.code)
