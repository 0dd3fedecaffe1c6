"""The port's attention modules and their kernel's plain versions against
the JAX package, on the CPU: the flash-attention oracle and the model's
chunked online softmax, RoPE, ``QuantDense``, ``FFN`` and ``Attention``
(the full-sequence path and the ring-buffer decode).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (measured on the CPU):
  * ``flash_attention_ref`` (both materialise the f32 scores and multiply
    by v in f32) against the JAX oracle: rtol = atol = 1e-5 (seen: 1.2e-6);
    against the Pallas kernel in interpret mode (bf16 PV): rtol 2e-2,
    atol 6e-3, the bound of tests/test_flash_kernel.py;
  * the chunked online softmax (bf16 p and v, the same chunks) against
    ``repro.nn.attention.flash_attention``: the flip rule below. A 1-ulp
    score difference can flip the bf16 rounding of a p, which moves the
    outputs of its row by up to 2^-8 p |v| / l: with one chunk of 100 keys
    2,340 of 192,000 outputs differ by more than 1e-6, the worst by 3.0e-4
    (8.5e-5 of the scale); with the odd chunkings 1.1e-6 at most;
  * RoPE: rtol 1e-6, atol 1e-4. The two packages' f32 ``pow`` differ by an
    ulp in some frequencies (1.9e-9), which moves the angle at position
    4100 by 7.6e-6 rad (seen: 2.6e-5 on values up to 4);
  * ``QuantDense``, ``FFN``, ``Attention``: |err| <= 1e-4 of the scale
    (max(1, the largest magnitude compared)) except at most 0.5% of the
    elements and <= 1e-3 of it everywhere, the rule of
    tests/test_torch_rwkv.py (an FP8 rounding boundary of ``quant_act``
    flips a value, and the rows it feeds move).
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention_kernel as jflash_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro.nn import rotary as jrotary  # noqa: E402
from repro.nn.attention import Attention as JAttention  # noqa: E402
from repro.nn.attention import KVCache as JKVCache  # noqa: E402
from repro.nn.attention import flash_attention as jflash_model  # noqa: E402
from repro.nn.ffn import FFN as JFFN  # noqa: E402
from repro.nn.linear import QuantDense as JQuantDense  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention as flash_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_gqa, flash_attention_ref  # noqa: E402
from repro_torch.nn import rotary  # noqa: E402
from repro_torch.nn.attention import Attention, KVCache, flash_attention  # noqa: E402
from repro_torch.nn.ffn import FFN  # noqa: E402
from repro_torch.nn.linear import QuantDense  # noqa: E402
from repro_torch.serving import pack_tree  # noqa: E402

TOL, FLIP_TOL, FLIP_SHARE = 1e-4, 1e-3, 5e-3
JPOL = jget_policy("floatsd8_table6")
TPOL = get_policy("floatsd8_table6")


def assert_close(got, want, what, tol=TOL):
    """|got - want| <= tol * scale except at most FLIP_SHARE of the
    elements, and <= FLIP_TOL * scale everywhere; scale = max(1, max
    |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want), max(1.0, float(np.abs(want).max()))
    assert (err > tol * scale).mean() <= FLIP_SHARE and err.max() <= FLIP_TOL * scale, (
        what, float(err.max()) / scale, int((err > tol * scale).sum()), err.size)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# ---------------------------------------------------------------------------
# the kernel's plain versions
# ---------------------------------------------------------------------------


def _bh_inputs(bh, s, d):
    rng = np.random.default_rng(bh + s + d)
    return [rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (4, 256, 32), (1, 512, 128)])
def test_flash_oracle_matches_jax_oracle_and_pallas_kernel(bh, s, d, causal, window):
    q, k, v = _bh_inputs(bh, s, d)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jflash_ref(jq, jk, jv, causal, window)), rtol=1e-5, atol=1e-5)
    pallas = jflash_pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-2, atol=6e-3)


def _gqa_inputs(b, sq, skv, kh, g, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kh, g, d)).astype(np.float32) * 2  # peaked attention
    k, v = (rng.standard_normal((b, skv, kh, d)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal,window,chunk,kv_chunk", [
    (True, 40, 32, 24),  # 100 rows in 2 chunks of 50, keys in 4 of 25; the window bites
    (True, None, 1024, 512),  # one chunk each
    (False, 30, 16, 48),  # 6 query chunks, 2 KV chunks
])
def test_chunked_flash_matches_the_jax_model_path(causal, window, chunk, kv_chunk):
    b, s, kh, g, d = 2, 100, 2, 4, 120
    q, k, v = _gqa_inputs(b, s, s, kh, g, d)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(causal=causal, window=window, chunk=chunk, kv_chunk=kv_chunk)
    want = np.asarray(jflash_model(*map(jnp.asarray, (q, k, v, pos, pos)), **kw))
    tq, tk, tv, tp = (torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v, pos))
    got = flash_attention(tq, tk, tv, tp, tp, **kw).numpy()
    assert_close(got, want, "chunked flash")
    # the model-layout entry point computes the same, and the oracle agrees
    # within the reference's kernel bound
    gqa = flash_attention_gqa(tq.reshape(b, s, kh * g, d), tk, tv, **kw)
    assert torch.equal(gqa, torch.from_numpy(got).reshape(b, s, kh * g, d))
    ex = lambda t: t.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).reshape(b * kh * g, s, d)  # noqa: E731
    oracle = flash_attention_ref(tq.reshape(b, s, kh * g, d).permute(0, 2, 1, 3).reshape(-1, s, d),
                                 ex(tk), ex(tv), causal=causal, window=window)
    np.testing.assert_allclose(gqa.permute(0, 2, 1, 3).reshape(-1, s, d).numpy(), oracle.numpy(),
                               rtol=2e-2, atol=6e-3)


def test_flash_dispatch_and_wrapper_take_the_plain_version_on_cpu():
    q, k, v = _gqa_inputs(1, 70, 70, 2, 3, 40, seed=3)
    tq, tk, tv = torch.from_numpy(q.reshape(1, 70, 6, 40)), torch.from_numpy(k), torch.from_numpy(v)
    n0 = flash_op.launches
    tkd.STATS.reset()
    a = flash_op(tq, tk, tv, window=20)
    c = tkd.flash_attention(tq, tk, tv, window=20, backend="ref")
    assert torch.equal(a, c) and a.shape == (1, 70, 6, 40) and flash_op.launches == n0
    assert tkd.STATS.snapshot() == {("flash_attention", "ref"): 1}
    assert tkd.STATS.last["flash_attention"].reason == "policy:ref"
    assert tkd.flash_attention(tq.to(torch.bfloat16), tk.to(torch.bfloat16),
                               tv.to(torch.bfloat16)).dtype == torch.bfloat16


def test_flash_bound_rejects_attention_without_the_window():
    """Negative control of the bound above: the oracle with the window mask
    dropped is rejected."""
    q, k, v = map(torch.from_numpy, _bh_inputs(2, 256, 64))
    want = flash_attention_ref(q * 2, k, v, window=64)
    got = flash_attention_ref(q * 2, k, v)
    assert ((got - want).abs() > 6e-3 + 2e-2 * want.abs()).float().mean() > 0.5


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_rope_matches_jax():
    rng = _rng("rope")
    q = rng.standard_normal((2, 16, 4, 120)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 120)).astype(np.float32)
    pos = (np.arange(16, dtype=np.int32)[None] + np.array([[0], [4093]], np.int32))
    jq, jk = jrotary.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 120, 10000.0)
    tq, tk = rotary.apply_rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), 120, 10000.0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tq[0].numpy(), np.asarray(jq[0]), rtol=1e-6, atol=1e-6)  # positions < 16
    np.testing.assert_allclose(rotary.rope_freqs(120).numpy(), np.asarray(jrotary.rope_freqs(120)), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rotary.apply_mrope(q, k, pos, 120)


@pytest.mark.parametrize("use_bias", [False, True])
def test_quant_dense_matches_jax(use_bias):
    rng = _rng("dense", use_bias)
    p = {"w": (rng.standard_normal((64, 96)) / 8).astype(np.float32)}
    if use_bias:
        p["b"] = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    want = JQuantDense(64, 96, use_bias=use_bias).apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), JPOL)
    tp = bridge.from_jax_params(p, "cpu")
    dense = QuantDense(64, 96, use_bias=use_bias)
    assert_close(dense.apply(tp, torch.from_numpy(x), TPOL), want, "QuantDense")
    # served: the codes (a 2-D w packs; a 1-D bias stays dense) on the kernel dispatch
    tkd.STATS.reset()
    served = dense.apply(pack_tree(tp), torch.from_numpy(x), TPOL.replace(weight_quant="none"))
    assert_close(served, want, "QuantDense packed")
    assert tkd.STATS.snapshot() == {("floatsd_matmul", "ref"): 1}
    assert set(dense.init(torch.Generator().manual_seed(0))) == ({"w", "b"} if use_bias else {"w"})


@pytest.mark.parametrize("kind,quant_silu", [("swiglu", False), ("swiglu", True), ("gelu", False),
                                             ("geglu", False)])
def test_ffn_matches_jax(kind, quant_silu):
    rng = _rng("ffn", kind, quant_silu)
    p = {"wi": {"w": (rng.standard_normal((64, 160)) / 8).astype(np.float32)},
         "wo": {"w": (rng.standard_normal((160, 64)) / 12).astype(np.float32)}}
    if kind != "gelu":
        p["wg"] = {"w": (rng.standard_normal((64, 160)) / 8).astype(np.float32)}
    x = (rng.standard_normal((2, 7, 64)) * 2).astype(np.float32)
    want = JFFN(64, 160, kind=kind, quant_silu=quant_silu).apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), JPOL)
    tkd.STATS.reset()
    ffn = FFN(64, 160, kind=kind, quant_silu=quant_silu)
    assert_close(ffn.apply(bridge.from_jax_params(p, "cpu"), torch.from_numpy(x), TPOL), want, f"FFN {kind}")
    assert tkd.STATS.count("qsigmoid") == int(quant_silu)  # the gate's two-region sigmoid
    assert set(ffn.init(torch.Generator().manual_seed(0))) == set(p)


def _attn_params(rng, dim, h, kh, d, bias):
    def qd(i, o):
        out = {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias:
            out["b"] = (rng.standard_normal(o) * 0.1).astype(np.float32)
        return out

    wo = qd(h * d, dim)
    wo.pop("b", None)
    return {"wq": qd(dim, h * d), "wk": qd(dim, kh * d), "wv": qd(dim, kh * d), "wo": wo}


@pytest.mark.parametrize("kh,window,bias", [(2, 16, True), (8, None, False)])
def test_attention_apply_and_decode_match_jax_past_the_ring_wrap(kh, window, bias):
    """GQA (8 heads over 2) with a window of 16 and biased projections, and
    MHA without a window: the full-sequence path at S 40, then 24 decode
    steps from a cache of 16 slots (window 16: min(32, 16); no window: the
    cache length 24), outputs and cache leaves every step."""
    dim, h, d, s = 96, 8, 32, 40
    rng = _rng("attn", kh, window)
    p = _attn_params(rng, dim, h, kh, d, bias)
    x = rng.standard_normal((2, s, dim)).astype(np.float32)
    kw = dict(dim=dim, heads=h, kv_heads=kh, head_dim=d, window=window, qkv_bias=bias)
    ja, ta = JAttention(**kw), Attention(**kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), bridge.from_jax_params(p, "cpu")
    tkd.STATS.reset()
    assert_close(ta.apply(tp, torch.from_numpy(x), TPOL), ja.apply(jp, jnp.asarray(x), JPOL), "apply")
    assert tkd.STATS.count("flash_attention", "ref") == 1
    s_max = min(32, window) if window else 24
    jc = JKVCache.init(2, s_max, kh, d)
    tc = KVCache.init(2, s_max, kh, d)
    step = jax.jit(lambda p, x, c: ja.decode(p, x, c, JPOL))
    for t in range(24):
        jo, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc)
        to, tc = ta.decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, TPOL)
        assert_close(to, jo, f"decode step {t}")
        for name in ("k", "v"):
            got, want = getattr(tc, name), getattr(jc, name)
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            assert_close(got.float(), np.asarray(want, np.float32), f"cache {name} step {t}")
        assert int(tc.pos) == int(jc.pos) == t + 1
    with pytest.raises(NotImplementedError, match="cross-attention"):
        ta.apply(tp, torch.from_numpy(x), TPOL, kv=torch.from_numpy(x))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Attention(dim, h, kh, rope="mrope")
