"""The backward of the zoo's three differentiable dispatch ops on the CPU,
against the JAX package.

  * ``flash_bwd`` (``kernels/flash_attention/ref.py``, the training path's
    flash-attention backward) against the reference's ``_flash_bwd``
    (``repro.nn.attention``) on the same q, k, v, do and the reference
    forward's o and lse: causal, windowed, non-causal with Sq != Skv, and
    causal with a ``prefix`` against the reference's mask on M-RoPE t ids
    (patches at t 0, text from t = side on). Chunks of 64 query rows by 32
    keys, so every case walks several of each. Bound: |err| <= 1e-5 of the
    gradient's scale (max |want|) except where a bf16 rounding of p or ds
    lands on the other side of a boundary (its term moves by 2^-8 of
    itself): at most 0.5% of the elements beyond 1e-5 and none beyond 4e-3
    of the scale. ``dispatch.flash_attention``'s own gradient (its forward
    saving o and lse) is held to the same bound against ``jax.grad`` of the
    reference's custom-VJP ``flash_attention``.
  * The same backward against f64 autograd through the oracle
    ``flash_attention_ref``, an independent check: within 2e-2 of the
    scale (p, ds, do, k and q rounded to bf16 before their products).
  * The wkv backward (``dispatch.rwkv_wkv``: recompute through
    ``wkv_chunked_scan`` under autograd) against ``jax.grad`` of the
    reference model's ``_wkv_chunked`` at S 64, and the sequential
    recurrence under plain autograd against ``jax.grad`` of
    ``_wkv_sequential`` at S 20 (not a multiple of 16): within 1e-5 of
    each gradient's scale (f32 sums in other orders), except at most 0.1%
    of the elements, within 1e-4: the subdiagonal's log-decay difference
    bprev_t - b_{t-1} is 0 only up to the cumulative sum's rounding, which
    XLA and PyTorch order differently, and its sign decides whether the
    min(., 0) passes a gradient to w (measured: 0.012% of dw). An fp16
    ``u``'s gradient overflows in both packages, but not at the same
    elements: the reference's scan carries u's gradient across its chunks
    in fp16 (each chunk's share rounded to fp16 and summed there, inf -
    inf giving NaN), the port rounds one f32 sum once. Where both are
    finite they agree within 2^-8 of the largest.
  * The qsigmoid backward (straight through, g s (1 - s) in x's dtype)
    against ``jax.grad`` of ``repro.core.qsigmoid.qsigmoid`` on f32 (the
    model's gates): within 2^-22 of the gradient's scale (the two
    libraries' f32 sigmoids differ in the last bit).
  * Under ``no_grad``, or with no input requiring a gradient, the three ops
    build no autograd node.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.qsigmoid import qsigmoid as jqsigmoid  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.rwkv import RWKV6TimeMix as JTimeMix  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, flash_bwd  # noqa: E402
from repro_torch.kernels.rwkv_wkv.ref import wkv_ref  # noqa: E402

CHUNK, KV_CHUNK = 64, 32
TOL, FLIP_TOL, FLIP_SHARE = 1e-5, 4e-3, 5e-3
F64_TOL = 2e-2
WKV_TOL, WKV_FLIP_TOL, WKV_FLIP_SHARE = 1e-5, 1e-4, 1e-3
QSIG_TOL = 2.0 ** -22

# (name, B, Sq, Skv, H, Kh, D, causal, window, prefix)
FLASH_CASES = [("causal", 2, 256, 256, 4, 2, 32, True, None, 0),
               ("window", 2, 256, 256, 4, 2, 32, True, 40, 0),
               ("cross", 2, 96, 160, 4, 4, 32, False, None, 0),
               ("prefix", 2, 256, 256, 4, 2, 32, True, None, 100)]


def _inputs(b, sq, skv, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, d)) * 2).astype(np.float32)  # peaked attention
    k, v = (rng.standard_normal((b, skv, kh, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _ref_positions(b, sq, skv, prefix):
    """The reference's positions: indices, or M-RoPE t ids with ``prefix``
    patches at t 0 and text from t = side (the causal mask reads t)."""
    qp = np.arange(sq)
    if prefix:
        side = max(1, int(prefix ** 0.5))
        qp = np.where(qp < prefix, 0, qp - prefix + side)
    kp = qp if sq == skv else np.arange(skv)
    return (jnp.asarray(np.broadcast_to(qp, (b, sq)), jnp.int32), jnp.asarray(np.broadcast_to(kp, (b, skv)), jnp.int32))


def assert_flips(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert (err > TOL * scale).mean() <= FLIP_SHARE and err.max() <= FLIP_TOL * scale, (
        what, float(err.max()) / scale, float((err > TOL * scale).mean()))


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_bwd_matches_the_reference_flash_bwd(case):
    name, b, sq, skv, h, kh, d, causal, window, prefix = case
    q, k, v, do = _inputs(b, sq, skv, h, kh, d)
    g = h // kh
    qp, kp = _ref_positions(b, sq, skv, prefix)
    q5, do5 = (jnp.asarray(t.reshape(b, sq, kh, g, d)) for t in (q, do))
    out, lse = jax.jit(jattn._flash_fwd, static_argnums=(5, 6, 7, 8))(
        q5, jnp.asarray(k), jnp.asarray(v), qp, kp, causal, window, CHUNK, KV_CHUNK)
    want = jax.jit(jattn._flash_bwd, static_argnums=(8, 9, 10, 11))(
        q5, jnp.asarray(k), jnp.asarray(v), qp, kp, out, lse, do5, causal, window, CHUNK, KV_CHUNK)
    t = torch.from_numpy
    got = flash_bwd(t(q), t(k), t(v), t(np.asarray(out).reshape(b, sq, h, d)), t(np.asarray(lse).reshape(b, h, sq)),
                    t(do), causal=causal, window=window, prefix=prefix, chunk=CHUNK, kv_chunk=KV_CHUNK)
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        assert_flips(a.numpy(), np.asarray(w).reshape(a.shape), f"{name} {what}")


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_dispatch_flash_attention_gradient_matches_jax_grad(case):
    """The whole differentiable op on the CPU (the chunked forward with its
    lse, then flash_bwd, the reference's query chunk min(1024, Skv))
    against jax.grad of the reference's custom-VJP attention."""
    name, b, sq, skv, h, kh, d, causal, window, prefix = case
    q, k, v, do = _inputs(b, sq, skv, h, kh, d, seed=1)
    g = h // kh
    qp, kp = _ref_positions(b, sq, skv, prefix)

    def jf(q, k, v):
        o = jattn.flash_attention(q.reshape(b, sq, kh, g, d), k, v, qp, kp, causal=causal, window=window,
                                  chunk=min(1024, skv))
        return jnp.sum(o.reshape(b, sq, h, d) * do)

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = kd.flash_attention(*ts, causal=causal, window=window, prefix=prefix)
    got = torch.autograd.grad(o, ts, torch.from_numpy(do))
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert_flips(a.numpy(), w, f"{name} {what}")


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_bwd_against_f64_autograd_of_the_oracle(case):
    name, b, sq, skv, h, kh, d, causal, window, prefix = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, sq, skv, h, kh, d, seed=2))
    g = h // kh
    o, lse = kd.flash_attention_gqa(q, k, v, causal=causal, window=window, prefix=prefix, return_lse=True)
    got = flash_bwd(q, k, v, o, lse, do, causal=causal, window=window, prefix=prefix, chunk=CHUNK, kv_chunk=KV_CHUNK)
    x64 = [t.double().requires_grad_() for t in (q, k, v)]
    heads = lambda t: t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], d)  # noqa: E731
    expand = lambda t: heads(t.repeat_interleave(g, dim=2))  # noqa: E731
    o64 = flash_attention_ref(heads(x64[0]), expand(x64[1]), expand(x64[2]), causal, window, prefix)
    want = torch.autograd.grad(o64, x64, heads(do.double()))
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max())
        assert float((a.double() - w).abs().max()) <= F64_TOL * scale, (name, what)


def _wkv_inputs(s, seed=3, b=2, h=4, k=16):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, k)) - 2)).astype(np.float32)  # decays in (0, 1)
    u = (rng.standard_normal((h, k)) * 0.3).astype(np.float32)
    cy = rng.standard_normal((b, s, h, k)).astype(np.float32)
    cs = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return (r, kk, v, w, u), cy, cs


@pytest.mark.parametrize("s", [64, 20])
def test_wkv_backward_matches_jax_grad_of_the_reference_scan(s):
    """S 64: dispatch.rwkv_wkv (its recompute through wkv_chunked_scan)
    against the reference's _wkv_chunked; S 20: the sequential recurrence
    under plain autograd against its _wkv_sequential."""
    ins, cy, cs = _wkv_inputs(s)
    b, _, h, k = ins[0].shape
    tm = JTimeMix(h * k, k)
    s0 = jnp.zeros((b, h, k, k), jnp.float32)

    def jf(r, kk, v, w, u):
        y, st = (tm._wkv_chunked(r, kk, v, w, u, s0, 16) if s % 16 == 0 else
                 tm._wkv_sequential(r, kk, v, w, u, s0))
        return jnp.sum(y * cy) + jnp.sum(st * cs)

    want = jax.jit(jax.grad(jf, argnums=tuple(range(5))))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(x).requires_grad_() for x in ins]
    y, st = kd.rwkv_wkv(*ts) if s % 16 == 0 else wkv_ref(*ts)
    got = torch.autograd.grad((y, st), ts, (torch.from_numpy(cy), torch.from_numpy(cs)))
    for what, a, w in zip("rkvwu", got, want):
        w = np.asarray(w)
        err, scale = np.abs(a.numpy() - w), np.abs(w).max()
        assert (err > WKV_TOL * scale).mean() <= WKV_FLIP_SHARE and err.max() <= WKV_FLIP_TOL * scale, (s, what)


def test_wkv_backward_overflows_an_fp16_bonus_as_the_reference():
    """An fp16 ``u`` (the Table VI master) through the model's cast: both
    packages' gradients overflow fp16."""
    ins, cy, cs = _wkv_inputs(64, seed=4)
    cy, cs = cy * 2e4, cs * 2e4  # some of u's gradients past fp16's 65504, not all
    b, _, h, k = ins[0].shape
    tm = JTimeMix(h * k, k)
    s0 = jnp.zeros((b, h, k, k), jnp.float32)

    def jf(u16):
        y, st = tm._wkv_chunked(*map(jnp.asarray, ins[:4]), u16, s0, 16)
        return jnp.sum(y * cy) + jnp.sum(st * cs)

    want = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(ins[4], jnp.float16)).astype(jnp.float32))
    u16 = torch.from_numpy(ins[4]).half().requires_grad_()
    y, st = kd.rwkv_wkv(*map(torch.from_numpy, ins[:4]), u16.to(torch.float32))
    (got,) = torch.autograd.grad((y, st), [u16], (torch.from_numpy(cy), torch.from_numpy(cs)))
    assert got.dtype == torch.float16
    got = got.float().numpy()
    assert not np.isfinite(want).all() and not np.isfinite(got).all()
    fin = np.isfinite(want) & np.isfinite(got)
    assert fin.any() and np.abs(got[fin] - want[fin]).max() <= 2 ** -8 * np.abs(want[fin]).max()


def test_qsigmoid_backward_is_the_reference_straight_through_gradient():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 300)) * 4).astype(np.float32)
    g = rng.standard_normal((4, 300)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(jqsigmoid(t) * jnp.asarray(g))))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(kd.qsigmoid(tx), [tx], torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= QSIG_TOL * np.abs(want).max()


def test_the_ops_build_no_autograd_node_without_grad():
    rng = np.random.default_rng(6)
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(1, 32, 32, 2, 1, 16))
    ins, _, _ = _wkv_inputs(16)
    wkv = [torch.from_numpy(t) for t in ins]
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    calls = {"flash": lambda *t: kd.flash_attention(*t), "wkv": lambda *t: kd.rwkv_wkv(*t)[0],
             "qsigmoid": lambda *t: kd.qsigmoid(*t)}
    args = {"flash": [q, k, v], "wkv": wkv, "qsigmoid": [x]}
    for name, fn in calls.items():
        assert fn(*args[name]).grad_fn is None, name  # no input requires a gradient
        leaves = [t.clone().requires_grad_() for t in args[name]]
        with torch.no_grad():
            assert fn(*leaves).grad_fn is None, name
        node = fn(*leaves).grad_fn  # trained: one node of the op's Function
        assert node is not None and name.replace("wkv", "rwkvwkv") in type(node).__name__.lower().replace("_", ""), (
            name, type(node).__name__)
