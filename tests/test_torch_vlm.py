"""The port's ``vlm`` family against the JAX package, at the reduced
``qwen2_vl_2b`` config (2 layers, d_model 128, 4 heads of 32 over 2 KV
heads, d_ff 256, vocab 512, M-RoPE sections (8, 4, 4), qkv bias, rmsnorm,
SwiGLU, 16 stub patches, tied, policy floatsd8_table6): M-RoPE, the flash
plain version's causal ``prefix`` against the reference's position mask,
forward and loss with and without patch embeddings, decode steps with their
caches, the packed store, the CLI, and the resident and KV bytes of the
full width from the reference's shapes.

Parameters are made with numpy from a seed in the reference layout and
handed to both packages (``repro_torch.bridge`` carries them across).

Tolerances (measured on the CPU):
  * M-RoPE: rtol 1e-6, atol 1e-4, as RoPE (tests/test_torch_attention.py:
    the two packages' f32 ``pow`` differ by an ulp in some frequencies);
    with t = h = w it is RoPE bit for bit;
  * the chunked plain flash with ``prefix`` against the reference's
    ``flash_attention`` on its M-RoPE t ids, and with ``prefix`` 0 against
    index positions: the flip rule below (a 1-ulp score difference can flip
    a bf16 rounding of p); the masks themselves are equal, set for set;
  * logits and decode caches: |err| <= 1e-4 of the scale (max(1, the
    largest magnitude compared)) except at most 0.5% of the elements, and
    <= 1e-3 of it everywhere, the rule of tests/test_torch_dense.py (an FP8
    rounding flip of ``quant_act`` moves the rows it feeds). Loss within
    1e-5 relative. The forward and the served prefill are compared with
    the FloatSD8 weights and no activation quantizer (``WPOL``): under
    floatsd8_table6 one FP8 activation flip (text only: sequence 1,
    position 34) moves its row by 2.6e-3 of the scale, one of 80 rows
    (1.1% of the elements); with no activation quantizer the logits agree
    within 1e-5 of the scale. The decode steps run the served policy;
  * the port's text prefill against its own token-by-token decode with no
    activation quantizer (policy fp32) on the same codes, 8 positions:
    within 2e-3 of the logit scale, tests/test_torch_dense.py's GAP_TOL
    (prefill rounds p and v to bf16, decode reads a bf16 cache; the text
    prefill turns position i by t = i + 1, the decode by t = i, the same
    relative angles);
  * packed store: codes, biases and bytes identical to ``pack_tree`` (the
    jitted encode every port file packs the JAX side with, held to the eager
    ``pack_tree`` on a leaf of each kind).
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
from repro.models.lm import CausalLM as JLM  # noqa: E402
from repro.models.lm import cross_entropy as jcross_entropy  # noqa: E402
from repro.models.lm import mask_padded_vocab as jmask  # noqa: E402
from repro.nn import rotary as jrotary  # noqa: E402
from repro.nn.attention import flash_attention as jflash_model  # noqa: E402
from repro.serving.weight_store import pack_tree as jpack_tree_eager  # noqa: E402
from repro.serving.weight_store import tree_nbytes as jtree_nbytes  # noqa: E402
from repro.serving.weight_store import unpack_tree as junpack_tree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.flash_attention import cost as fa_cost  # noqa: E402
from repro_torch.kernels.flash_attention.ref import _mask, flash_attention_gqa, flash_attention_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import CausalLM, build  # noqa: E402
from repro_torch.nn import rotary  # noqa: E402
from repro_torch.serving import WeightStore, tree_nbytes  # noqa: E402

ARCH = "qwen2_vl_2b"
JCFG, TCFG = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
L, D, H, KH, HD, V, P = 2, 128, 4, 2, 32, 512, 16
B, S = 2, 40  # 16 patches, then 24 text positions
CACHE_LEN, DECODE = 64, 8
SITES = 7  # weight sites a layer: wq, wk, wv, wo, wi, wg, wo (FFN)
TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
GAP_TOL = 2e-3
JPOL, TPOL = jget_policy("floatsd8_table6"), get_policy("floatsd8_table6")
JSERVE, TSERVE = JPOL.replace(weight_quant="none"), TPOL.replace(weight_quant="none")
_NO_ACT = dict(act_fwd="none", act_bwd="none", first_layer_act="none", last_layer_act="none")
JWPOL, WPOL = JPOL.replace(**_NO_ACT), TPOL.replace(**_NO_ACT)  # FloatSD8 weights, no activation quantizer
# the full width chip_smoke.py serves: FloatSD8 codes from the shapes, + a
# 4-byte bias a packed leaf (14) + the f32 final norm (1536 x 4)
FULL_CODE_BYTES = 1_546_268_672
FULL_BYTES = FULL_CODE_BYTES + 14 * 4 + 1536 * 4
FULL_KV_BYTES = 469_762_048  # 28 layers x 2 x 8 lanes x 2048 x 2 KV heads x 128 x 2 B


def np_params(jcfg=JCFG, seed=0):
    """Seeded numpy parameters in the reference layout: weights scaled by
    their fan-in, norm scales near 1, small biases, a unit-scale table."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "b":
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        sd = 1.0 if name == "table" else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def patches(seed=3):
    return np.random.default_rng(seed).standard_normal((B, P, D)).astype(np.float32)


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


def jpack(params):
    """The reference's ``pack_tree`` in one jitted program (the same codes
    and biases as its eager encode, which compiles each leaf's ops anew)."""
    return jax.jit(lambda p: jax.tree_util.tree_map(
        lambda w: JPackedTensor(*jfloatsd.encode(w)) if w.ndim >= 2 else w, p))(params)


def jpositions(with_patches: bool, b=B, s=S):
    """The reference's (t, h, w) ids, [B, S, 3]."""
    batch = {"patch_embeds": None} if with_patches else {}
    return np.array(JLM(JCFG)._positions(batch, b, s))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's forward logits with and without patch embeddings
    (FloatSD8 weights, no activation quantizer),
    and DECODE steps of its served store with their caches: each JAX
    program compiled once for the module."""
    jm = JLM(JCFG)
    params = jax.tree_util.tree_map(jnp.asarray, np_params())
    packed = jpack(params)
    toks = jnp.asarray(tokens())
    fwd = jax.jit(lambda p, bd: jm.forward(p, bd, JWPOL)[0])
    with_p = fwd(params, {"tokens": toks, "patch_embeds": jnp.asarray(patches())})
    text = fwd(params, {"tokens": toks})
    # served, the patch projection is the decoded FloatSD8 weight (the dense
    # forward multiplies by the f32 master: no weight quantizer there)
    served = jax.jit(lambda p, bd: jm.forward(junpack_tree(p), bd, JWPOL.replace(weight_quant="none"))[0])(
        packed, {"tokens": toks, "patch_embeds": jnp.asarray(patches())})
    step = jax.jit(lambda p, t, c: jm.decode_step(junpack_tree(p), t, c, JSERVE))
    cache, steps = jm.init_cache(B, CACHE_LEN), []
    for t in range(DECODE):
        lg, cache = step(packed, toks[:, t:t + 1], cache)
        steps.append((np.asarray(lg), jax.tree_util.tree_map(np.asarray, cache)))
    return dict(params=params, packed=packed, with_patches=np.asarray(with_p), text=np.asarray(text),
                served_with_patches=np.asarray(served), steps=steps)


@pytest.fixture(scope="module")
def port_params():
    return bridge.from_jax_params(np_params(), "cpu")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["whisper_large_v3", ARCH])
def test_config_mirrors_jax_on_its_fields(arch, reduced):
    jc, tc = jget_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.vocab_padded() == jc.vocab_padded() and tc.hd == jc.hd


@pytest.mark.parametrize("with_patches", [True, False])
def test_mrope_matches_jax(with_patches):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, HD)).astype(np.float32)
    pos3 = jpositions(with_patches)
    if with_patches:  # patches at t = 0 on a 4 x 4 grid, then text from t = h = w = 4
        assert (pos3[0, :P, 0] == 0).all() and pos3[0, P - 1, 1:].tolist() == [3, 3]
        assert pos3[0, P:].tolist() == [[i] * 3 for i in range(4, 4 + S - P)]
    jq, jk = jax.jit(lambda *a: jrotary.apply_mrope(*a, HD, (8, 4, 4)))(jnp.asarray(q), jnp.asarray(k),
                                                                       jnp.asarray(pos3))
    tq, tk = rotary.apply_mrope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos3), HD, (8, 4, 4))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-4)
    # text only, t == h == w: 1-D RoPE on t
    t = torch.from_numpy(pos3[..., 0])
    flat = torch.from_numpy(pos3[..., :1].repeat(3, axis=-1))
    rq, rk = rotary.apply_rope(torch.from_numpy(q), torch.from_numpy(k), t, HD)
    mq, mk = rotary.apply_mrope(torch.from_numpy(q), torch.from_numpy(k), flat, HD, (8, 4, 4))
    assert torch.equal(mq, rq) and torch.equal(mk, rk)
    with pytest.raises(AssertionError):
        rotary.apply_mrope(torch.from_numpy(q), torch.from_numpy(k), flat, HD, (8, 4, 8))


@pytest.mark.parametrize("prefix", [P, 0])
def test_prefix_flash_matches_the_jax_position_mask(prefix):
    """The plain flash with ``prefix`` P against the reference's
    ``flash_attention`` on its M-RoPE t ids (patches P, S 40, chunks of 8
    query rows and 16 keys), and with prefix 0 against index positions;
    the masks equal set for set, the cost model's pair count with them."""
    g, kv_chunk, chunk = H // KH, 16, 8
    rng = np.random.default_rng(prefix)
    q = (rng.standard_normal((B, S, KH, g, HD)) * 2).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KH, HD)).astype(np.float32) for _ in range(2))
    t = jpositions(True)[..., 0] if prefix else np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = np.asarray(jax.jit(lambda *a: jflash_model(*a, causal=True, chunk=chunk, kv_chunk=kv_chunk))(
        *map(jnp.asarray, (q, k, v, t, t))))
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v))
    got = flash_attention_gqa(tq.reshape(B, S, H, HD), tk, tv, prefix=prefix, chunk=chunk, kv_chunk=kv_chunk)
    assert_close(got.reshape(B, S, KH, g, HD), want, f"prefix {prefix}")
    idx = torch.arange(S)
    mask = _mask(idx, idx, True, None, prefix)
    assert torch.equal(mask, torch.from_numpy(t[0][None, :] <= t[0][:, None]))
    assert int(mask.sum()) == fa_cost.attend_pairs(S, S, True, None, prefix)
    assert torch.equal(mask[:P, :P].all(), torch.tensor(bool(prefix)))
    # the dispatch entry point and the oracle take the same prefix
    tkd.STATS.reset()
    assert torch.equal(tkd.flash_attention(tq.reshape(B, S, H, HD), tk, tv, prefix=prefix), flash_attention_gqa(
        tq.reshape(B, S, H, HD), tk, tv, prefix=prefix))
    assert tkd.STATS.snapshot() == {("flash_attention", "ref"): 1}
    assert tkd.STATS.last["flash_attention"].cost.flops > 0
    ex = lambda a: a.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).reshape(-1, S, HD)  # noqa: E731
    oracle = flash_attention_ref(tq.reshape(B, S, H, HD).permute(0, 2, 1, 3).reshape(-1, S, HD), ex(tk), ex(tv),
                                 prefix=prefix)
    np.testing.assert_allclose(got.permute(0, 2, 1, 3).reshape(-1, S, HD).numpy(), oracle.numpy(),
                               rtol=2e-2, atol=6e-3)
    with pytest.raises(ValueError, match="prefix"):
        flash_attention_gqa(tq.reshape(B, S, H, HD), tk, tv, window=8, prefix=4)


def test_init_shapes_match_jax():
    jp = jax.eval_shape(JLM(JCFG).init, jax.random.PRNGKey(0))
    tp = build(TCFG).init(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in _flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == want
    assert want["patch_proj/w"] == (D, D) and want["stack/b0/mixer/wk/b"] == (L, KH * HD)


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_loss_and_served_prefill_match_jax(jax_side, port_params, with_patches):
    tm = CausalLM(TCFG)
    batch = {"tokens": torch.from_numpy(tokens())}
    if with_patches:
        batch["patch_embeds"] = torch.from_numpy(patches())
    want = jax_side["with_patches" if with_patches else "text"]
    tkd.STATS.reset()
    logits, aux = tm.forward(port_params, batch, WPOL)
    assert logits.shape == (B, S, TCFG.vocab_padded()) and float(aux) == 0.0
    assert_close(logits, want, "logits")
    assert tkd.STATS.snapshot() == {("flash_attention", "ref"): L}
    assert tkd.STATS.last["flash_attention"].cost == fa_cost.flash_attention_cost(
        B, S, S, H, KH, HD, backend="ref", prefix=P if with_patches else 0)
    labels = tokens(seed=7)
    loss = float(tm.loss(port_params, {**batch, "labels": torch.from_numpy(labels)}, WPOL))
    ref = float(jcross_entropy(jmask(jnp.asarray(want), V), jnp.asarray(labels)))
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    if not with_patches:
        return
    # served from the codes (the stacked norms and biases FloatSD8 too, as
    # the reference serves them): every weight site on the matmul dispatch,
    # the patch projection decoded once by the hoist
    store = WeightStore.pack(port_params)
    tree = tm.hoist(store.tree)
    assert not tkd.is_packed(tree["patch_proj"]["w"]) and tkd.is_packed(store.tree["patch_proj"]["w"])
    tkd.STATS.reset()
    assert_close(tm.prefill(tree, batch, WPOL.replace(weight_quant="none")), jax_side["served_with_patches"],
                 "served prefill")
    assert tkd.STATS.snapshot() == {("floatsd_matmul", "ref"): SITES * L + 1, ("flash_attention", "ref"): L}
    with pytest.raises(ValueError, match="patch embeddings go first"):
        tm.forward(port_params, {**batch, "patch_embeds": batch["patch_embeds"][:, :4]}, TPOL)


def test_decode_steps_and_caches_match_jax(jax_side, port_params):
    tm = CausalLM(TCFG)
    store = WeightStore.pack(port_params)
    cache = tm.init_cache(B, TPOL, "cpu", cache_len=CACHE_LEN)
    toks = torch.from_numpy(tokens())
    for t, (lg_j, cache_j) in enumerate(jax_side["steps"]):
        lg, cache = tm.decode_step(store.tree, toks[:, t:t + 1], cache, TSERVE)
        assert_close(lg, lg_j, f"decode logits step {t}")
        c_t, c_j = cache["stack"]["b0"], cache_j["stack"]["b0"]
        for name in ("k", "v"):
            assert_close(getattr(c_t, name).float(), np.asarray(getattr(c_j, name), np.float32),
                         f"cache {name} step {t}")
        np.testing.assert_array_equal(c_t.pos.numpy(), c_j.pos)


def test_text_prefill_matches_token_by_token_decode(port_params):
    tm = CausalLM(TCFG)
    tree = tm.hoist(WeightStore.pack(port_params).tree)
    fp32 = get_policy("fp32")
    toks = torch.from_numpy(tokens(seed=9, shape=(2, DECODE)))
    full = tm.prefill(tree, {"tokens": toks}, fp32)
    cache = tm.init_cache(2, fp32, "cpu", cache_len=CACHE_LEN)
    scale = max(1.0, float(full.abs().max()))
    for t in range(DECODE):
        lg, cache = tm.decode_step(tree, toks[:, t:t + 1], cache, fp32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) <= GAP_TOL * scale, t


def test_pack_tree_byte_identical_to_jax(jax_side, port_params):
    want = jax_side["packed"]
    # the jitted encode (``jpack``, which the RWKV-6 and dense files use
    # too) gives the reference's eager ``pack_tree`` bytes, on a leaf of each
    # kind: the table, stacked matrices, stacked vectors, the dense 1-D norm
    # (eager JAX compiles each op anew for each shape: about 1 s a shape)
    kinds = ["embed/table", "final_norm/scale", "stack/b0/mixer/wq/w", "stack/b0/mixer/wo/w",
             "stack/b0/mixer/wq/b", "stack/b0/norm1/scale", "stack/b0/norm2/scale"]
    params, want_flat = _flat(jax_side["params"]), _flat(want)
    eager = jpack_tree_eager({k: params[k] for k in kinds})
    for key in kinds:
        w, e = want_flat[key], eager[key]
        if key == "final_norm/scale":
            np.testing.assert_array_equal(np.asarray(w), np.asarray(e), err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(w.codes), np.asarray(e.codes), err_msg=key)
            assert int(w.bias) == int(e.bias), key
    store = WeightStore.pack(port_params)
    got_flat, want_flat = _flat(store.tree), _flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    for key, w in want_flat.items():
        g = got_flat[key]
        if hasattr(w, "codes"):
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes), err_msg=key)
            assert g.bias == int(w.bias), key
        else:
            assert key == "final_norm/scale" and torch.equal(g, torch.from_numpy(np.array(w)))
    assert store.n_packed == 14  # 12 stacked leaves, the table, the patch projection
    assert store.packed_nbytes == tree_nbytes(store.tree) == int(jtree_nbytes(want))
    # the port serves a store the JAX package packed
    tree = bridge.from_jax_packed(want, "cpu")
    assert tkd.is_packed(tree["patch_proj"]["w"])
    batch = {"tokens": torch.from_numpy(tokens()), "patch_embeds": torch.from_numpy(patches())}
    assert torch.equal(CausalLM(TCFG).prefill(tree, batch, TSERVE), CausalLM(TCFG).prefill(store.tree, batch, TSERVE))


def test_full_width_store_and_kv_bytes_from_the_reference_shapes():
    """The resident and KV bytes chip_smoke.py asserts, from the reference's
    full-width shapes (meta tensors carry them)."""
    shapes = jax.eval_shape(JLM(jget_config(ARCH)).init, jax.random.PRNGKey(0))

    def meta(sds):
        if len(sds.shape) >= 2:
            return tkd.PackedTensor(torch.empty(sds.shape, dtype=torch.uint8, device="meta"), 0)
        return torch.empty(sds.shape, dtype=torch.float32, device="meta")

    tree = jax.tree_util.tree_map(meta, shapes)
    packed = [x for x in tree_leaves(tree, is_leaf=tkd.is_packed) if tkd.is_packed(x)]
    assert len(packed) == 14 and sum(x.codes.numel() for x in packed) == FULL_CODE_BYTES
    assert tree_nbytes(tree) == FULL_BYTES
    jcache = jax.eval_shape(lambda: JLM(jget_config(ARCH)).init_cache(8, 2048))
    tcache = CausalLM(get_config(ARCH)).init_cache(8, TPOL, "meta", cache_len=2048)
    for c in (tcache, jcache):
        leaves = tree_leaves(c) if c is tcache else jax.tree_util.tree_leaves(c)
        assert sum(int(np.prod(t.shape)) * t.dtype.itemsize for t in leaves) == FULL_KV_BYTES + 28 * 4


def test_cli_serves_the_reduced_vlm_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("weights: ") and "14 tensors packed" in out[0]
    assert out[1].startswith("served 2 requests, 4 tokens")
