"""The flash-attention kernel's f32 scores in plain PyTorch, against f64 and
the JAX package, on the CPU.

The kernel splits q * scale and k into three bf16 pieces each by
truncation (``split_pieces``) and sums the six products whose weight
reaches 2^-16 (``piece_scores``); ``flash_attention_pieces`` is the
oracle's attention on those scores with p and v rounded to bf16, as the
kernel forms them. Inputs are made with numpy from a seed.

Tolerances:
  * the split is exact: hi + mid + lo == x bit for bit, each piece a bf16
    value, for |x| from 2^-100 (the limit the split states) to 2^100;
  * the six-product scores are within 2^-16 of the f64 scores, relative to
    sum_d |q_d k_d| (each dropped product is below 2^-23 of its term; seen:
    about 1e-7), and hi . hi alone is not (seen: about 4e-3);
  * attention on the six-product scores against the JAX oracle and the
    Pallas kernel in interpret mode: rtol 2e-2, atol 6e-3, the f32 bound of
    tests/test_flash_kernel.py (``FLASH_TOL`` of chip_smoke.py): p and v
    are rounded to bf16 before their product.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention_kernel as jflash_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    PIECE_PRODUCTS, flash_attention_pieces, piece_scores, split_pieces,
)

RTOL, ATOL = 2e-2, 6e-3


def _low16(t):
    return t.contiguous().view(torch.int32) & 0xFFFF


@pytest.mark.parametrize("e", [-100, -64, -20, -1, 0, 12, 60, 100])
def test_split_pieces_sum_exactly(e):
    rng = np.random.default_rng(e + 200)
    x = (rng.uniform(1.0, 2.0, 4096) * rng.choice([-1.0, 1.0], 4096) * 2.0 ** e).astype(np.float32)
    x[:8] = np.float32(2.0 ** e) * np.array([1, -1, 1.5, 1.0078125, 1.99999988, -1.25, 1.00001, 1.9], np.float32)
    xt = torch.from_numpy(x)
    hi, mid, lo = split_pieces(xt)
    assert torch.equal(hi + mid + lo, xt)
    for piece in (hi, mid, lo):
        assert bool((_low16(piece) == 0).all())  # a bf16 value
    assert bool((hi.abs() >= mid.abs()).all() and (mid.abs() >= lo.abs()).all())


def test_split_pieces_keep_zeros_and_non_finite_in_hi():
    x = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan")])
    hi, mid, lo = split_pieces(x)
    assert torch.equal(hi[:4], x[:4]) and bool(torch.isnan(hi[4]))
    assert bool((mid == 0).all() and (lo == 0).all())


@pytest.mark.parametrize("d", [16, 64, 120, 128])
@pytest.mark.parametrize("q_scale", [2.0, 1e-3])
def test_six_piece_scores_within_2_pow_minus16_of_f64(d, q_scale):
    rng = np.random.default_rng(d)
    q = torch.from_numpy((rng.standard_normal((2, 40, d)) * q_scale).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 56, d)).astype(np.float32))
    exact = torch.einsum("bqd,bkd->bqk", q.double(), k.double())
    terms = torch.einsum("bqd,bkd->bqk", q.double().abs(), k.double().abs())
    six = (piece_scores(q, k).double() - exact).abs() / terms
    assert float(six.max()) <= 2.0 ** -16
    # the one-pass product of the leading pieces is a lossier function
    one = (piece_scores(q, k, PIECE_PRODUCTS[-1:]).double() - exact).abs() / terms
    assert float(one.max()) > 2.0 ** -16


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (4, 256, 32), (1, 256, 120)])
def test_flash_on_piece_scores_matches_jax_oracle_and_pallas_kernel(bh, s, d, causal, window):
    rng = np.random.default_rng(bh + s + d)
    q = (rng.standard_normal((bh, s, d)) * 2).astype(np.float32)  # peaked attention
    k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(2))
    got = flash_attention_pieces(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jflash_ref(jq, jk, jv, causal, window)), rtol=RTOL, atol=ATOL)
    pallas = jflash_pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
