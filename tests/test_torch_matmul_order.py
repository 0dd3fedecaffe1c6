"""The FloatSD8 matmul's route and sum order (``floatsd_matmul.ref.plan``),
on the CPU: which route each main path's shape takes, and that the plain
version sums in the order the CUDA kernel's route A does, exactly. The
FloatSD4 matmul runs route A at every M (``plan(..., ordered=True)``), and
its plain version sums in that order too.

``plan(M, N, K)`` picks route A (ordered split-K on CUDA cores) for M <= 64
or when the caller asks for ``ordered`` (the fused BPTT's batched recompute
and dXs), route B (bf16 tensor cores) otherwise, and cuts K into chunks of
consecutive k; the plain version sums each chunk in k order and adds the
chunk sums in chunk order. On exact products (FP8 or FP16 activations times
FloatSD8 weights) that order fixes every bit, so the plain version must
equal an explicit loop bit for bit; against the JAX oracles it stays within
the precise contract, |err| <= 1e-5 * (|x| @ |W|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.core import floatsd as jfsd  # noqa: E402
from repro.kernels.floatsd_matmul.bwd import matmul_dx_ref as jdx_ref  # noqa: E402
from repro.kernels.floatsd_matmul.ref import floatsd_matmul_ref as jmm_ref  # noqa: E402
from repro_torch.core import floatsd, floatsd4  # noqa: E402
from repro_torch.core.fp8 import FP16, quantize_fp8  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.kernels.floatsd_matmul import ops, ref  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ref import (  # noqa: E402
    Plan, floatsd_matmul_ref, matmul_dx_ref, plan, split_matmul,
)
from repro_torch.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref  # noqa: E402

# (M, N, K, ordered, route) of every floatsd_matmul launch shape on the main paths
MAIN_PATH_SHAPES = [
    (8, 4096, 1024, False, "A"),  # LSTM decode step at 8 lanes: a gate matmul
    (8, 33280, 1024, False, "A"),  # ... the tied head, codes [N, K]
    (64, 4096, 1024, False, "A"),  # LSTM prompt chunk (8 lanes x 8); the train step's per-step gates at B 64
    (64, 33280, 1024, False, "A"),  # the head over a prompt chunk
    (64, 1024, 4096, False, "A"),  # the train step's per-step matmul_dx
    (3072, 4096, 1024, True, "A"),  # the train step's recompute of all zs (S 48 x B 64)
    (3072, 1024, 4096, True, "A"),  # ... and its batched dXs
    (3072, 4096, 1024, False, "B"),  # the same shape without the request
    (2048, 2560, 2560, False, "B"),  # rwkv6_3b prefill (B 2 x S 1024): time-mix sites
    (2048, 8960, 2560, False, "B"),  # ... channel-mix key
    (2048, 2560, 8960, False, "B"),  # ... channel-mix value
    (2048, 65536, 2560, False, "B"),  # ... the tied head
    (8, 2560, 2560, False, "A"),  # rwkv6_3b decode step at 8 lanes
    (8, 65536, 2560, False, "A"),
    (2048, 3840, 3840, False, "B"),  # h2o_danube3_4b prefill: wq, wo
    (2048, 960, 3840, False, "B"),  # ... wk, wv
    (2048, 10240, 3840, False, "B"),  # ... wi, wg
    (2048, 3840, 10240, False, "B"),  # ... the FFN's wo
    (2048, 32000, 3840, False, "B"),  # ... the tied head
    (8, 960, 3840, False, "A"),  # h2o_danube3_4b decode step at 8 lanes
    (8, 3840, 10240, False, "A"),
    (64, 100, 130, False, "A"),  # the routes' boundary
    (65, 100, 130, False, "B"),
]


@pytest.mark.parametrize("m,n,k,ordered,route", MAIN_PATH_SHAPES)
def test_plan_route_and_chunks(m, n, k, ordered, route):
    p = plan(m, n, k, ordered)
    assert p.route == route and p == ops.plan(m, n, k, ordered)
    assert p.splits >= 1 and (p.splits - 1) * p.chunk < k <= p.splits * p.chunk  # no empty chunk
    if p.splits > 1:
        assert p.chunk % 64 == 0 and p.chunk >= (128 if route == "A" else 512)
    if route == "A":  # the order depends on N and K only
        assert all(plan(rows, n, k) == p for rows in (1, 3, 8, 33, 64))
        # the partials stay at most twice the code bytes at M = 64
        assert p.splits * 64 * n * 4 <= 2 * k * n


def test_plan_fills_the_card_at_the_decode_shapes():
    """Route A's grid of 128-column blocks times its chunks reaches some
    2 x 132 blocks where K allows it: [8,1024]x[1024,4096] runs 32 x 8."""
    assert plan(8, 4096, 1024) == Plan("A", 8, 128)
    assert plan(8, 960, 3840) == Plan("A", 30, 128)
    assert plan(8, 65536, 2560) == Plan("A", 1, 2560)
    assert plan(2048, 960, 3840) == Plan("B", 1, 3840)
    assert plan(130, 256, 1024) == Plan("B", 2, 512)
    assert plan(5, 40, 77) == Plan("A", 1, 77) and plan(3, 5, 0) == Plan("A", 1, 0)


def _inputs(m, k, n, act, transposed, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    x = quantize_fp8(x) if act == "fp8" else quantize_fp8(x, FP16) if act == "fp16" else x
    w = (rng.standard_normal((n, k) if transposed else (k, n)) * 0.05).astype(np.float32)
    codes, bias = floatsd.encode(torch.from_numpy(w))
    return x, codes, int(bias)


def _chunked_loop(x, w, p):
    """The kernel's order written out: each chunk summed from 0 in k order in
    f32 (exact products), then the chunk sums added in chunk order."""
    x, w = x.numpy(), w.numpy()
    y = None
    for c in range(p.splits):
        acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
        for k in range(c * p.chunk, min(x.shape[1], (c + 1) * p.chunk)):
            acc = (acc + x[:, k:k + 1] * w[k:k + 1]).astype(np.float32)
        y = acc if y is None else (y + acc).astype(np.float32)
    return y


# (M, K, N): split K with a ragged last chunk, a route B split, one chunk
ORDER_SHAPES = [(8, 1024, 300), (5, 1000, 77), (64, 2048, 40), (200, 2048, 100), (3, 100, 130)]


@pytest.mark.parametrize("m,k,n", ORDER_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("act", ["fp8", "fp16"])
def test_plain_version_is_the_chunked_loop_bit_for_bit(m, k, n, transposed, act):
    x, codes, bias = _inputs(m, k, n, act, transposed, m * k + n)
    w = floatsd.decode(codes, bias)
    want = _chunked_loop(x, w.t() if transposed else w, plan(m, n, k))
    got = floatsd_matmul_ref(x, codes, bias, transposed=transposed)
    np.testing.assert_array_equal(got.numpy(), want)
    if not transposed:  # matmul_dx reads codes [K, N] as [out, contraction]: g [M, N] -> [M, K]
        g = quantize_fp8(torch.from_numpy(np.random.default_rng(m).standard_normal((m, n)).astype(np.float32)))
        np.testing.assert_array_equal(matmul_dx_ref(g, codes, bias).numpy(),
                                      _chunked_loop(g, w.t(), plan(m, k, n)))


@pytest.mark.parametrize("splits,chunk,k", [(5, 1, 3), (4, 3, 10), (3, 64, 130)])
def test_plain_version_with_more_chunks_than_k_or_a_ragged_one(monkeypatch, splits, chunk, k):
    """Any split the rule could give sums as the loop does, including chunks
    past K (empty: their sums are +0) and a short last chunk."""
    monkeypatch.setattr(ref, "plan", lambda m, n, kk, ordered=False: Plan("A", splits, chunk))
    x, codes, bias = _inputs(6, k, 20, "fp8", False, k)
    w = floatsd.decode(codes, bias)
    np.testing.assert_array_equal(split_matmul(x, w).numpy(), _chunked_loop(x, w, Plan("A", splits, chunk)))


def _bound(x, w):
    return 1e-5 * (np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)) + 1e-30


@pytest.mark.parametrize("m,k,n", ORDER_SHAPES + [(64, 4096, 64)])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_version_within_the_jax_oracles(m, k, n, transposed):
    """f32 activations (products not exact): the split order stays within
    the precise contract of the JAX package's oracles, forward and dx."""
    x, codes, bias = _inputs(m, k, n, None, transposed, 7 * m + k)
    kn = codes.t().contiguous() if transposed else codes  # the JAX oracle takes [K, N]
    w = np.asarray(jfsd.decode(jnp.asarray(kn.numpy()), bias))
    want = np.asarray(jmm_ref(jnp.asarray(x.numpy()), jnp.asarray(kn.numpy()), bias))
    got = floatsd_matmul_ref(x, codes, bias, transposed=transposed).numpy()
    assert np.all(np.abs(got - want) <= _bound(x.numpy(), w))
    g = torch.from_numpy(np.random.default_rng(m).standard_normal((m, n)).astype(np.float32))
    want_dx = np.asarray(jdx_ref(jnp.asarray(g.numpy()), jnp.asarray(kn.numpy()), bias))
    got_dx = matmul_dx_ref(g, kn, bias).numpy()
    assert np.all(np.abs(got_dx - want_dx) <= _bound(g.numpy(), w.T))


def test_route_a_rows_do_not_depend_on_the_batch():
    """Route A's order is a function of N and K: a row's result is the same
    bits whether 1, 8, 64 or, on the ordered route, 3072 rows share the
    launch (f32 activations): the fused BPTT's batched recompute of zs
    equals its per-step forward."""
    x, codes, bias = _inputs(3072, 1024, 96, None, False, 3)
    full = floatsd_matmul_ref(x, codes, bias, ordered=True)
    assert plan(3072, 96, 1024, True) == plan(64, 96, 1024) and plan(64, 96, 1024).splits > 1
    for rows in (1, 8, 33, 64):
        assert torch.equal(floatsd_matmul_ref(x[:rows], codes, bias), full[:rows])
    assert torch.equal(floatsd_matmul_ref(x[64:128], codes, bias), full[64:128])
    g = x[:, :96].contiguous()  # g [M, 96] against codes [1024, 96] as [out, contraction]
    assert torch.equal(matmul_dx_ref(g, codes, bias, ordered=True)[:64], matmul_dx_ref(g[:64], codes, bias))


# (M, K, N) of the FloatSD4 matmul, for both layouts (transposed: N table
# rows): odd K and N, K % 32 != 0, ragged last chunks, M above route A's
# 64, one chunk
ORDER4_SHAPES = [(8, 999, 301), (65, 1000, 77), (3, 100, 131), (64, 2048, 40)]


def _inputs4(m, k, n, act, transposed, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    x = quantize_fp8(x) if act == "fp8" else quantize_fp8(x, FP16) if act == "fp16" else x
    w = torch.from_numpy((rng.standard_normal((n, k) if transposed else (k, n)) * 0.05).astype(np.float32))
    codes, exps = floatsd4.encode(w)
    return x, floatsd4.pack_nibbles(codes), exps, w.shape[0]


def test_floatsd4_shapes_split_k_on_route_a():
    """Every FloatSD4 shape takes route A, split as FloatSD8's ordered
    route: the serving gate into 8 chunks of 128, the head into 2 of 512,
    and the test shapes with ragged last chunks."""
    assert plan(8, 4096, 1024, True) == plan(64, 4096, 1024, True) == Plan("A", 8, 128)
    assert plan(8, 33280, 1024, True) == plan(64, 33280, 1024, True) == Plan("A", 2, 512)
    for m, k, n in ORDER4_SHAPES:
        p = plan(m, n, k, True)
        assert p.route == "A" and (p.splits == 1 or p.chunk % 64 == 0)
    assert plan(8, 301, 999, True) == Plan("A", 6, 192) and plan(65, 77, 1000, True) == Plan("A", 6, 192)
    assert plan(3, 131, 100, True).splits == 1


@pytest.mark.parametrize("m,k,n", ORDER4_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("act", ["fp8", "fp16", None])
def test_floatsd4_plain_version_is_the_ordered_split(m, k, n, transposed, act):
    """floatsd4_matmul_ref equals split_matmul(x, decode4, ordered=True) bit
    for bit in both layouts (any activations), and on exact products (FP8,
    FP16) the chunked loop the kernel runs."""
    x, codes, exps, rows = _inputs4(m, k, n, act, transposed, 3 * m + k + n)
    w = floatsd4.decode_packed(codes, exps, rows)
    wk = w.t() if transposed else w
    got = floatsd4_matmul_ref(x, codes, exps, rows, transposed=transposed)
    assert torch.equal(got, split_matmul(x, wk, ordered=True))
    assert torch.equal(floatsd4_matmul_ref(x, codes, exps, rows, transposed=transposed, dense=w), got)
    if act is not None:
        np.testing.assert_array_equal(got.numpy(), _chunked_loop(x, wk, plan(m, n, k, True)))


def test_dispatch_plain_paths_sum_in_the_plan_order():
    """dispatch.matmul and dispatch.matmul_dx on the plain path, with the
    decode hoisted or not, equal the plain versions bit for bit at a split
    shape (f32 activations); dispatch.matmul4 likewise on the FloatSD4
    matmul's ordered split, gate and tied head."""
    x, codes, bias = _inputs(8, 1024, 200, None, False, 11)
    assert plan(8, 200, 1024).splits > 1 and plan(8, 1024, 200).splits == 1
    dense = floatsd.decode(codes, bias)
    want = floatsd_matmul_ref(x, codes, bias)
    assert torch.equal(kd.matmul(x, codes, bias), want)
    assert torch.equal(kd.matmul(x, codes, bias, dense=dense), want)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 200)).astype(np.float32))
    want_dx = matmul_dx_ref(g, codes, bias)
    assert torch.equal(kd.matmul_dx(g, codes, bias), want_dx)
    assert torch.equal(kd.matmul_dx(g, codes, bias, dense=dense), want_dx)
    tk = codes.t().contiguous()  # the tied head's layout: [N, K] read in place
    assert torch.equal(kd.matmul(x, tk, bias, transposed=True, dense=dense.t().contiguous()),
                       floatsd_matmul_ref(x, tk, bias, transposed=True))
    w = dense.t().contiguous()  # [200, 1024]: the head's table, and transposed a [1024, 200] gate
    for transposed, w4 in ((False, kd.pack4(w.t())), (True, kd.pack4(w))):
        assert plan(8, w4.k if transposed else w4.codes.shape[1], 1024, True).splits > 1
        want4 = split_matmul(x, kd.unpack4(w4).t() if transposed else kd.unpack4(w4), ordered=True)
        assert torch.equal(kd.matmul4(x, w4, transposed=transposed), want4)
        assert torch.equal(kd.matmul4(x, kd.hoist_packed(w4), transposed=transposed), want4)
