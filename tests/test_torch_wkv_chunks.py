"""The rwkv_wkv kernel's chunk decomposition in plain PyTorch
(``wkv_chunked``: the record its pre-pass forms once per chunk of 16, then
the walk over the state) against the per-token recurrence and the JAX
package's Pallas kernel in interpret mode, on the CPU. Inputs are made with
numpy from a seed.

Tolerances, the port's wkv bound (tests/test_torch_cuda.py): rtol 2e-4,
atol 2e-4 (the JAX package's chunked-vs-recurrence bound), or, where a
value cancels far below its terms, 1e-5 of the sum of the terms'
magnitudes (the recurrence on |r|, |k|, |v|, |u|), outputs and final
states; against the Pallas kernel rtol 2e-4, atol 2e-4 (both chunked).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv_wkv.kernel import wkv_pallas  # noqa: E402
from repro_torch.kernels.rwkv_wkv.ref import wkv_chunked, wkv_ref  # noqa: E402


def _inputs(k, v, s, w0, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed + 7 * k + s)
    r, kk = (rng.standard_normal((b, s, h, k)).astype(np.float32) for _ in range(2))
    vv = rng.standard_normal((b, s, h, v)).astype(np.float32)
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, k)) * 0.3 + w0)).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(t) for t in (r, kk, vv, w, u))


def _beyond(got, want, inputs):
    """Elements of (y, final state) beyond both rules of the bound."""
    r, kk, v, w, u = inputs
    terms = wkv_ref(r.abs(), kk.abs(), v.abs(), w, u.abs())
    n = 0
    for a, e, t in zip(got, want, terms):
        d = (a - e).abs()
        n += int(((d > 2e-4 + 2e-4 * e.abs()) & (d > 1e-5 * t)).sum())
    return n


@pytest.mark.parametrize("s", [1, 16, 50, 64])
@pytest.mark.parametrize("k,v", [(32, 32), (64, 40)])
@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_wkv_chunked_matches_the_recurrence(w0, k, v, s):
    inputs = _inputs(k, v, s, w0)
    got, want = wkv_chunked(*inputs), wkv_ref(*inputs)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert _beyond(got, want, inputs) == 0


@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_wkv_chunked_without_u_is_rejected(w0):
    """The bound's negative control: the bonus dropped must fail it."""
    r, kk, v, w, u = _inputs(32, 32, 64, w0)
    want = wkv_ref(r, kk, v, w, u)
    assert _beyond(wkv_chunked(r, kk, v, w, torch.zeros_like(u)), want, (r, kk, v, w, u)) > 0


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_wkv_chunked_matches_jax_pallas_kernel(w0, s):
    r, kk, v, w, u = _inputs(32, 32, s, w0)
    y, _ = wkv_chunked(r, kk, v, w, u)
    bh = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 1, 3).reshape(-1, s, t.shape[-1]))  # noqa: E731
    y_p = wkv_pallas(bh(r), bh(kk), bh(v), bh(w), jnp.asarray(np.tile(u.numpy(), (2, 1))), chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1, 3).reshape(-1, s, 32), np.asarray(y_p),
                               rtol=2e-4, atol=2e-4)
