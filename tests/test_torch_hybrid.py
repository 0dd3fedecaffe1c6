"""The port's ``moe`` and ``hybrid`` families against the JAX package, at
the reduced ``jamba_v01_52b`` (one period of 8: Mamba mixers with attention
at sub-layer 3, no RoPE, FFN and MoE MLPs in turns), ``dbrx_132b`` (2
attention + MoE layers) and ``kimi_k2_1t_a32b`` (a leading dense layer,
then 1 attention + MoE layer) configs: d_model 128, 4 heads of 32, d_ff
256, 4 experts, top-2, vocab 512, policy floatsd8_table6.

Parameters are made with numpy from a seed in the reference layout and
handed to both packages (``repro_torch.bridge`` carries them across).

Tolerances (measured on the CPU):
  * logits and decode caches: |err| <= 1e-4 of the scale (max(1, the
    largest magnitude compared)) except at most 0.5% of the elements, and
    <= 1e-3 of it everywhere, the rule of tests/test_torch_rwkv.py and
    test_torch_dense.py: a value on an FP8 rounding boundary of
    ``quant_act`` flips and moves the rows it feeds. Loss (with 0.01 x
    aux) within 1e-5 relative, aux within 1e-5 relative (its softmax and
    means round differently in the two frameworks, tests/test_torch_mamba_moe.py);
  * Jamba's forward is compared with no quantizer (policy fp32: 1.2e-5 of
    the scale seen), its decode step and its engine under floatsd8_table6.
    Under floatsd8_table6 its forward logits agree bit for bit up to
    position 19 of 32, where one FP8 rounding flip (an f32 rounding
    difference upstream, on a boundary) enters the Mamba state and moves
    every later position of that sequence, by up to 3.3% of the scale: the
    recurrence carries a flip where the attention-only models' rows absorb
    it;
  * the port's prefill against its own token-by-token decode with no
    activation quantizer (policy fp32) on the same codes, 8 positions:
    within 5e-3 of the logit scale, the dense family's bound on the card
    (``chip_smoke.py`` DENSE_TOL). Prefill rounds attention's p and v to
    bf16, decode reads keys and values from a bf16 cache; at the default
    init (logits below 1) the JAX package's own gap on the dense family is
    3.1e-3 to 3.9e-3 (tests/test_torch_dense.py); seen here: Jamba 8.6e-5,
    DBRX 1.7e-3, Kimi 1.7e-3 (over 16 positions and seeds 2 and 3 up to
    3.0e-3);
  * packed store: the block-by-block build byte for byte the packing of
    the whole init; the resident bytes of the full-width period from the
    reference's shapes;
  * greedy tokens of a store the JAX package packed, served by the port:
    equal to the JAX engine's over each request's margin-decisive prefix
    (top-2 gap of the port's logits above 1e-4), at least half decisive.
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
from repro.serving import ServeEngine as JEngine  # noqa: E402
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

ARCHS = ["jamba_v01_52b", "dbrx_132b", "kimi_k2_1t_a32b"]
B, S, V = 2, 32, 512
CACHE_LEN, LANES, MAX_NEW = 64, 2, 8
TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
AUX_RTOL, GAP_TOL, MARGIN_FLOOR = 1e-5, 5e-3, 1e-4
JPOL, TPOL = jget_policy("floatsd8_table6"), get_policy("floatsd8_table6")
TSERVE = TPOL.replace(weight_quant="none")
# the full-width period chip_smoke.py serves: jamba_v01_52b's 8 sub-layers
PERIOD_CODE_BYTES = 13_026_795_520
PERIOD_BYTES = 13_026_812_352  # + a 4-byte bias a packed leaf + the f32 final norm


def np_params(jcfg, seed=0):
    """Seeded numpy parameters in the reference layout: weights scaled by
    their fan-in, norm scales near 1, a unit-scale table."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        sd = 1.0 if name == "table" else 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * sd).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def prompts():
    return synthetic_prompts(LANES, V, np.random.default_rng(2), lo=3, hi=9)


def assert_close(got, want, what, tol=TOL):
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


def forward_policy(arch):
    """The policy the forward logits are compared under: floatsd8_table6,
    except Jamba's fp32 (see the module docstring)."""
    return "fp32" if arch == "jamba_v01_52b" else "floatsd8_table6"


def jpack(params):
    """The reference's ``pack_tree`` in one jitted program (its eager
    encode compiles each leaf's ops anew: 18 s for the reduced Jamba); the
    same codes and biases, and its ``ServeEngine`` packs the tree no more."""
    enc = jax.jit(lambda p: jax.tree_util.tree_map(
        lambda w: JPackedTensor(*jfloatsd.encode(w)) if w.ndim >= 2 else w, p))
    return enc(params)


@pytest.fixture(scope="module")
def jax_side():
    """Per arch: the JAX model's forward (logits, aux) and one decode step
    from a zero cache; for Jamba also its engine's streams from a store it
    packed. Each JAX program is compiled once for the module."""
    out = {}
    toks = jnp.asarray(tokens())
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced()
        jm = JLM(jcfg)
        params = jax.tree_util.tree_map(jnp.asarray, np_params(jcfg))
        pol = jget_policy(forward_policy(arch))
        logits, aux = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, pol))(params, toks)
        cache = jm.init_cache(B, CACHE_LEN)
        step, cache = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, JPOL))(params, toks[:, :1], cache)
        out[arch] = dict(params=params, logits=np.asarray(logits), aux=float(aux), step=np.asarray(step),
                         cache=jax.tree_util.tree_map(np.asarray, cache))
    jcfg = jget_config(ARCHS[0]).reduced()
    eng = JEngine(JLM(jcfg), jpack(out[ARCHS[0]]["params"]), JPOL, lanes=LANES, cache_len=CACHE_LEN)
    reqs = eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW)
    eng.run()
    out["engine"] = dict(store=eng.store, streams=[r.out for r in sorted(reqs, key=lambda r: r.rid)])
    return out


def port_params(jax_side, arch):
    return bridge.from_jax_params(jax.tree_util.tree_map(np.asarray, jax_side[arch]["params"]), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_config_match_jax(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for jc, tc in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    jp = jax.eval_shape(JLM(jcfg.reduced()).init, jax.random.PRNGKey(0))
    tp = CausalLM(tcfg.reduced()).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == {k: tuple(v.shape) for k, v in _flat(jp).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_decode_step_match_jax(jax_side, arch):
    tcfg, j = get_config(arch).reduced(), jax_side[arch]
    tm, p = CausalLM(tcfg), port_params(jax_side, arch)
    toks, labels = torch.from_numpy(tokens()), tokens(seed=7)
    pol = get_policy(forward_policy(arch))
    logits, aux = tm.forward(p, {"tokens": toks}, pol)
    assert_close(logits, j["logits"], f"{arch} logits")
    assert j["aux"] > 0 and abs(float(aux) - j["aux"]) <= AUX_RTOL * j["aux"]
    loss = float(tm.loss(p, {"tokens": toks, "labels": torch.from_numpy(labels)}, pol))
    want = float(jcross_entropy(jmask(jnp.asarray(j["logits"]), V), jnp.asarray(labels))) + 0.01 * j["aux"]
    assert abs(loss - want) <= 1e-5 * abs(want)
    cache = tm.init_cache(B, TPOL, "cpu", cache_len=CACHE_LEN)
    step, cache = tm.decode_step(p, toks[:, :1], cache, TPOL)
    assert_close(step, j["step"], f"{arch} decode step")
    got, want = _flat(cache), _flat(j["cache"])
    assert sorted(got) == sorted(want)
    for key, c in got.items():
        assert tuple(c.shape) == want[key].shape, key
        assert_close(c.float(), np.asarray(want[key], np.float32), f"{arch} cache {key}")


def test_jamba_period_layout_and_launches():
    cfg = get_config("jamba_v01_52b").reduced()
    tm = CausalLM(cfg)
    period = tm._period()
    assert [b.mixer for b in period] == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    assert [b.mlp for b in period] == ["ffn", "moe"] * 4
    assert period[3].attn.rope == "none" and tm._stack().n_groups == 1
    store = WeightStore.pack(tm.init(torch.Generator().manual_seed(0)))
    assert store.n_packed == 112
    tkd.STATS.reset()
    logits = tm.prefill(store.tree, {"tokens": torch.from_numpy(tokens())}, TSERVE)
    assert bool(torch.isfinite(logits).all())
    # 7 Mamba x 4 sites + 4 attention + 4 FFN x 3 + 4 MoE x 3 products x 4 experts + the head
    assert tkd.STATS.snapshot() == {("floatsd_matmul", "ref"): 28 + 4 + 12 + 48 + 1, ("flash_attention", "ref"): 1}


def test_hoist_keeps_the_mamba_and_expert_sites_packed():
    tm = CausalLM(get_config("jamba_v01_52b").reduced())
    tree = WeightStore.pack(tm.init(torch.Generator().manual_seed(1))).tree
    got, packed = _flat(tm.hoist(tree)["stack"]), _flat(tree["stack"])
    for key, w in packed.items():
        name = key.split("/")[-1]
        if name in WEIGHT_SITES:
            assert got[key] is w, key
        else:
            assert torch.equal(got[key], floatsd.decode(w.codes, w.bias)), key
    kept = {k.split("/", 1)[1] for k in packed if got[k] is packed[k]}
    assert kept == {"mixer/in_proj", "mixer/x_proj", "mixer/dt_proj", "mixer/out_proj", "mixer/wq/w", "mixer/wk/w",
                    "mixer/wv/w", "mixer/wo/w", "mlp/wi/w", "mlp/wg/w", "mlp/wo/w", "mlp/wi", "mlp/wg", "mlp/wo"}
    assert got["b1/mlp/wi"].codes.shape == (1, 4, 128, 256)
    assert not tkd.is_packed(got["b1/mlp/router"]) and not tkd.is_packed(got["b0/mixer/a_log"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_token_by_token_decode(arch):
    """The port's own prefill against its decode steps, with no activation
    quantizer, on the packed codes (no token dropped: a batch of one,
    every group within capacity)."""
    tm = CausalLM(get_config(arch).reduced())
    tree = tm.hoist(WeightStore.pack(tm.init(torch.Generator().manual_seed(2))).tree)
    fp32 = get_policy("fp32")
    toks = torch.from_numpy(tokens(seed=9, shape=(1, 8)))
    full = tm.prefill(tree, {"tokens": toks}, fp32)
    cache = tm.init_cache(1, fp32, "cpu", cache_len=CACHE_LEN)
    scale = max(1.0, float(full.abs().max()))
    for t in range(toks.shape[1]):
        lg, cache = tm.decode_step(tree, toks[:, t:t + 1], cache, fp32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) <= GAP_TOL * scale, (arch, t)


def test_port_serves_the_jax_store_with_the_jax_engine_tokens(jax_side):
    j = jax_side["engine"]
    tree = bridge.from_jax_packed(j["store"].tree, "cpu")
    assert tkd.is_packed(tree["stack"]["b1"]["mlp"]["wi"]) and tree["stack"]["b1"]["mlp"]["wi"].codes.dim() == 4
    tm = CausalLM(get_config("jamba_v01_52b").reduced())
    eng = ServeEngine(tm, tree, TPOL, lanes=LANES, cache_len=CACHE_LEN)
    assert eng.store.n_packed == j["store"].n_packed == 112
    reqs = sorted(eng.submit_all([p.copy() for p in prompts()], max_new=MAX_NEW), key=lambda r: r.rid)
    eng.run()
    assert all(r.status == "done" and len(r.out) == MAX_NEW for r in reqs)
    decisive = 0
    for r, want in zip(reqs, j["streams"]):
        n = next((i for i, g in enumerate(r.margins) if g <= MARGIN_FLOOR), MAX_NEW)
        assert r.out[:n] == want[:n], (r.rid, r.out, want, n)
        decisive += n
    assert decisive >= LANES * MAX_NEW // 2


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "dbrx_132b"])
def test_block_by_block_store_is_the_packed_init(arch):
    tm = CausalLM(get_config(arch).reduced())
    whole = WeightStore.pack(tm.init(torch.Generator().manual_seed(4)))
    # dbrx's stack has two groups: drawn twice, its bias from the first pass
    assert tm._stack().n_groups == (1 if arch == "jamba_v01_52b" else 2)
    streamed = WeightStore.pack_streamed(tm.init, 4, "cpu")
    a, b = _flat(whole.tree), _flat(streamed.tree)
    assert list(a) == list(b)
    for key, w in a.items():
        if tkd.is_packed(w):
            assert torch.equal(w.codes, b[key].codes) and w.bias == b[key].bias, key
        else:
            assert torch.equal(w, b[key]), key
    assert (streamed.dense_nbytes, streamed.n_packed, streamed.packed_nbytes) == (
        whole.dense_nbytes, whole.n_packed, whole.packed_nbytes)


def test_full_width_period_bytes_from_the_reference_shapes():
    """The resident bytes chip_smoke.py asserts for jamba_v01_52b's first
    period at full width: the port's ``tree_nbytes`` over a packed tree of
    the reference's shapes (meta tensors carry them)."""
    jcfg = dataclasses.replace(jget_config("jamba_v01_52b"), n_layers=8)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))

    def meta(sds):
        if len(sds.shape) >= 2:
            return tkd.PackedTensor(torch.empty(sds.shape, dtype=torch.uint8, device="meta"), 0)
        return torch.empty(sds.shape, dtype=torch.float32, device="meta")

    tree = jax.tree_util.tree_map(meta, shapes)
    packed = [x for x in tree_leaves(tree, is_leaf=tkd.is_packed) if tkd.is_packed(x)]
    assert len(packed) == 112
    assert sum(x.codes.numel() for x in packed) == PERIOD_CODE_BYTES
    assert tree_nbytes(tree) == PERIOD_BYTES
    tcfg = dataclasses.replace(get_config("jamba_v01_52b"), n_layers=8)
    assert CausalLM(tcfg)._stack().n_groups == 1


@pytest.mark.parametrize("arch,n_packed", [("jamba_v01_52b", 112), ("dbrx_132b", 11)])
def test_cli_serves_the_reduced_model_on_cpu(capsys, arch, n_packed):
    tserve.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--batch", "2", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("weights: ") and f"{n_packed} tensors packed" in out[0]
    assert out[1].startswith("served 2 requests, 4 tokens")


def test_audio_and_vision_families_still_raise():
    """Once a refusal, now the two families' builds: ``build`` gives
    Whisper for ``audio`` and CausalLM for ``vlm``, with the JAX package's
    parameter shapes; CausalLM still refuses ``audio``."""
    from repro.models.whisper import Whisper as JWhisper
    from repro_torch.models import Whisper

    for arch, tcls, jcls in (("whisper_large_v3", Whisper, JWhisper), ("qwen2_vl_2b", CausalLM, JLM)):
        tm = build(get_config(arch).reduced())
        assert type(tm) is tcls
        jp = jax.eval_shape(jcls(jget_config(arch).reduced()).init, jax.random.PRNGKey(0))
        tp = tm.init(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == {k: tuple(v.shape) for k, v in _flat(jp).items()}
    with pytest.raises(ValueError, match="CausalLM builds"):
        CausalLM(get_config("whisper_large_v3"))
