"""The port's kernels: plain versions against the JAX package, the dispatch
rules, and the CUDA sources' constant tables.

On the CPU the wrappers run their plain versions (the CUDA kernels build
and run only on the card: tests/test_torch_cuda.py holds them against the
plain versions there). The same seeded numpy inputs go through
``repro.kernels`` (the jnp oracles, and once through the Pallas kernels in
interpret mode) and the port.

Tolerances:
  * floatsd_matmul: |y_port - y_ref| <= 1e-5 * (|x| @ |W|) elementwise —
    the precise contract, relative to the sum of term magnitudes;
  * lstm_cell, quantized: at most 0.1% of elements may flip, each by at
    most one LUT step of a gate (<= 2^-5) or one e5m2 step of a tanh
    (<= 2^-3 below 1): |dh| <= 2^-3, |dc| <= 2^-5 |c_prev| + 2^-3 + one
    fp16 ulp. (torch and XLA differ by an ulp on some tanh/sigmoid inputs;
    such a flip is a real value change at a rounding boundary.)
  * lstm_cell, unquantized: h within 1e-3 absolute (one fp16 ulp of c
    through tanh), |dc| <= 4 eps (|c_prev| + 1) + one ulp of c's dtype
    (an ulp of sigmoid/tanh in each gate, on terms bounded by |c_prev| and 1).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import floatsd as jfsd  # noqa: E402
from repro.kernels import dispatch as jkd  # noqa: E402
from repro.kernels.floatsd_matmul.ref import floatsd_matmul_ref as jmm_ref  # noqa: E402
from repro.kernels.lstm_cell.ref import lstm_cell_ref as jcell_ref  # noqa: E402
from repro_torch.core import floatsd as tfsd  # noqa: E402
from repro_torch.core import qsigmoid as tqs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import lstm_cell  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402

KERNELS_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"

MATMUL_SHAPES = [(3, 100, 130), (8, 128, 256), (24, 256, 512)]
CELL_SHAPES = [(5, 200), (8, 128)]


def _mm_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m * 7 + k * 13 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    codes, bias = jfsd.encode(jnp.asarray(w))
    return x, np.array(codes), int(bias)


def _mm_bound(x, codes, bias):
    w = np.abs(np.asarray(jfsd.decode(jnp.asarray(codes), bias))).astype(np.float64)
    return 1e-5 * (np.abs(x).astype(np.float64) @ w) + 1e-30


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_floatsd_matmul_plain_matches_jax_ref(m, k, n, transposed):
    x, codes, bias = _mm_inputs(m, k, n)
    want = np.asarray(jmm_ref(jnp.asarray(x), jnp.asarray(codes), bias))
    c = codes.T.copy() if transposed else codes
    got = floatsd_matmul_ref(torch.from_numpy(x), torch.from_numpy(c.copy()), bias,
                             transposed=transposed).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= _mm_bound(x, codes, bias))


def test_floatsd_matmul_matches_pallas_interpret():
    m, k, n = 8, 128, 256
    x, codes, bias = _mm_inputs(m, k, n, seed=5)
    want = np.asarray(jkd.matmul(jnp.asarray(x), jnp.asarray(codes), jnp.int32(bias),
                                 backend="pallas"))
    assert jkd.STATS.last["floatsd_matmul"].backend == "pallas"
    got = tkd.matmul(torch.from_numpy(x), torch.from_numpy(codes), bias).numpy()
    assert np.all(np.abs(got - want) <= _mm_bound(x, codes, bias))


def _cell_inputs(b, h, c_np, seed=0):
    rng = np.random.default_rng(seed + b * 31 + h)
    z = (rng.standard_normal((b, 4 * h)) * 2).astype(np.float32)
    c = rng.standard_normal((b, h)).astype(c_np)
    return z, c


def _check_cell(got, want, c_prev, quantized, c_dtype):
    h_t, c_t = (np.asarray(a, np.float32) for a in got)
    h_j, c_j = (np.asarray(a, np.float32) for a in want)
    assert h_t.shape == h_j.shape and c_t.shape == c_j.shape
    cp = np.abs(np.asarray(c_prev, np.float32))
    ulp_c = np.spacing(np.abs(c_j).astype(np.float16 if c_dtype == torch.float16 else np.float32))
    ulp_c = ulp_c.astype(np.float32)
    if quantized:
        flips = (h_t != h_j) | (c_t != c_j)
        assert flips.mean() <= 1e-3, flips.mean()
        assert np.all(np.abs(h_t - h_j) <= 2.0**-3)
        assert np.all(np.abs(c_t - c_j) <= 2.0**-5 * cp + 2.0**-3 + ulp_c)
    else:
        assert np.all(np.abs(h_t - h_j) <= 1e-3)
        eps = np.finfo(np.float32).eps
        assert np.all(np.abs(c_t - c_j) <= 4 * eps * (cp + 1) + ulp_c)


@pytest.mark.parametrize("b,h", CELL_SHAPES)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", ["float16", "float32"])
def test_lstm_cell_plain_matches_jax_ref(b, h, quantized, c_dtype):
    tdt, jdt = getattr(torch, c_dtype), getattr(jnp, c_dtype)
    z, c = _cell_inputs(b, h, np.dtype(c_dtype))
    want = jcell_ref(jnp.asarray(z), jnp.asarray(c), quantized, c_dtype=jdt)
    got = lstm_cell_ref(torch.from_numpy(z), torch.from_numpy(c), quantized, c_dtype=tdt)
    assert got[0].dtype == torch.float32 and got[1].dtype == tdt
    _check_cell(got, want, c, quantized, tdt)


def test_lstm_cell_matches_pallas_interpret():
    b, h = 8, 128
    z, c = _cell_inputs(b, h, np.float16, seed=9)
    want = jkd.lstm_cell(jnp.asarray(z), jnp.asarray(c), backend="pallas")
    assert jkd.STATS.last["lstm_cell"].backend == "pallas"
    got = tkd.lstm_cell(torch.from_numpy(z), torch.from_numpy(c))
    _check_cell(got, want, c, True, torch.float16)


def test_midpoint_count_equals_octave_quantizer():
    """The CUDA cell rounds sigma(-|z|) by counting the 42 LUT midpoints it
    exceeds; the plain version uses the reference's octave-folded Q. The
    two agree exactly on every sigma in (0, 0.5], ties included."""
    grid = tqs.sigmoid_lut_values().astype(np.float32)
    mids = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    s = np.concatenate([grid, mids, np.nextafter(mids, 1), np.nextafter(mids, 0),
                        np.linspace(0, 0.5, 500_001, dtype=np.float32)])
    counted = grid[(s[:, None] > mids[None, :]).sum(-1)]
    np.testing.assert_array_equal(tqs._Q(torch.from_numpy(s)).numpy(), counted)


def _c_array(src: str, name: str) -> np.ndarray:
    body = re.search(rf"{name}\[\d+\]\s*=\s*\{{(.*?)\}};", src, re.S).group(1)
    return np.array([float(v.rstrip("f")) for v in re.findall(r"[-0-9.e]+f", body)], np.float32)


def test_cuda_source_tables_match_the_port():
    mm = (KERNELS_DIR / "floatsd_matmul" / "floatsd_matmul.cu").read_text()
    lut = np.concatenate([tfsd.MANTISSA_VALUES, tfsd.MANTISSA_VALUES[30:31]])
    np.testing.assert_array_equal(_c_array(mm, "kMantissa"), lut)
    # shared by the cell's forward and backward kernels
    cell = (KERNELS_DIR / "lstm_cell" / "lstm_cell_common.cuh").read_text()
    grid = tqs.sigmoid_lut_values().astype(np.float32)
    np.testing.assert_array_equal(_c_array(cell, "kSigGrid"), grid)
    np.testing.assert_array_equal(
        _c_array(cell, "kSigMid"), ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    )


def test_build_targets_hopper_without_fast_math():
    for op in _build.KERNELS:
        lib, args = _build._target(op)
        assert Path(args[0]).exists() and lib.parent == _build.BUILD_DIR
        assert "arch=compute_90a,code=sm_90a" in args
        assert not any("fast_math" in a for a in args)
    assert "--fmad=false" in _build._target("lstm_cell")[1]
    assert "--fmad=false" in _build._target("lstm_cell_bwd")[1]
    assert _build._LIBS == {}  # nothing is built on import or on the CPU


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    x, codes, bias = _mm_inputs(3, 100, 130)
    n0, c0 = floatsd_matmul.launches, lstm_cell.launches
    y = floatsd_matmul(torch.from_numpy(x), torch.from_numpy(codes), bias)
    np.testing.assert_array_equal(
        y.numpy(), floatsd_matmul_ref(torch.from_numpy(x), torch.from_numpy(codes), bias).numpy()
    )
    z, c = _cell_inputs(5, 200, np.float16)
    h_t, c_t = lstm_cell(torch.from_numpy(z), torch.from_numpy(c))
    h_r, c_r = lstm_cell_ref(torch.from_numpy(z), torch.from_numpy(c))
    assert torch.equal(h_t, h_r) and torch.equal(c_t, c_r)
    assert (floatsd_matmul.launches, lstm_cell.launches) == (n0, c0)


def test_dispatch_records_backend_and_rejects_unknown():
    tkd.STATS.reset()
    x, codes, bias = _mm_inputs(4, 64, 32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(codes)
    tkd.matmul(xt, ct, bias)
    tkd.matmul(xt, ct, bias, backend="ref")
    with tkd.use_backend("ref"):
        tkd.matmul(xt, ct, bias)
    assert tkd.STATS.count("floatsd_matmul", "ref") == 3
    assert tkd.STATS.count("floatsd_matmul", "cuda") == 0
    assert tkd.STATS.last["floatsd_matmul"].reason == "policy:ref"
    for bad in ("pallas", "auto", "cuda"):
        with pytest.raises(ValueError):
            tkd.matmul(xt, ct, bias, backend=bad)


@pytest.mark.parametrize("eq,xshape,wshape", [
    ("...d,df->...f", (2, 3, 64), (64, 48)),
    ("bd,dk->bk", (5, 64), (64, 40)),
    ("...d,vd->...v", (2, 3, 64), (96, 64)),
])
def test_packed_einsum_matches_decoded_einsum(eq, xshape, wshape):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
    codes, bias = tfsd.encode(torch.from_numpy(rng.standard_normal(wshape).astype(np.float32)))
    got = tkd.packed_einsum(eq, x, tkd.PackedTensor(codes, int(bias)))
    w = tfsd.decode(codes, bias).double()
    want = torch.einsum(eq, x.double(), w)
    bound = 1e-5 * torch.einsum(eq, x.double().abs(), w.abs()) + 1e-30
    assert got.shape == want.shape and bool(((got.double() - want).abs() <= bound).all())
    with pytest.raises(NotImplementedError):
        tkd.packed_einsum("bd,kd->bd", x.reshape(-1, 64), tkd.PackedTensor(codes, int(bias)))


def test_hoist_packed_decodes_once_for_the_plain_version():
    """On the plain path hoist_packed carries the codes' decode beside them;
    the matmul over it is bit-identical to decode-at-use and is recorded
    all the same. Dense and already hoisted weights pass through."""
    x, codes, bias = _mm_inputs(4, 64, 32, seed=7)
    xt, w = torch.from_numpy(x), tkd.PackedTensor(torch.from_numpy(codes), bias)
    hw = tkd.hoist_packed(w)
    assert torch.equal(hw.dense, tfsd.decode(w.codes, bias)) and hw.codes is w.codes
    assert tkd.hoist_packed(hw) is hw and tkd.hoist_packed(hw.dense) is hw.dense
    tkd.STATS.reset()
    got = tkd.packed_einsum("bd,dk->bk", xt, hw)
    assert torch.equal(got, tkd.packed_einsum("bd,dk->bk", xt, w))
    assert tkd.STATS.count("floatsd_matmul", "ref") == 2


def test_plain_matmul_sums_in_kernel_order():
    """The plain version adds x[m, k] * w[k, n] for k = 0 .. K-1 in f32,
    one rounding per step: the CUDA kernel's order (compared here with a
    numpy loop, exactly), and the ZERO_CODE decodes to 0.0 at any bias."""
    x, codes, bias = _mm_inputs(5, 77, 40, seed=3)
    w = tfsd.decode(torch.from_numpy(codes), bias).numpy()
    want = np.zeros((5, 40), np.float32)
    for k in range(77):
        want = (want + x[:, k:k + 1] * w[k:k + 1]).astype(np.float32)
    got = floatsd_matmul_ref(torch.from_numpy(x), torch.from_numpy(codes), bias).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    xq = np.array(jnp.asarray(x).astype(jnp.float8_e5m2).astype(jnp.float32))
    wantq = np.zeros((5, 40), np.float32)
    for k in range(77):  # products of FP8 x FloatSD8 are exact: bit-identical
        wantq = (wantq + xq[:, k:k + 1] * w[k:k + 1]).astype(np.float32)
    gotq = floatsd_matmul_ref(torch.from_numpy(xq), torch.from_numpy(codes), bias).numpy()
    np.testing.assert_array_equal(gotq, wantq)
    assert tkd.ZERO_CODE == jkd.ZERO_CODE
    assert float(tfsd.decode(torch.tensor([tkd.ZERO_CODE], dtype=torch.uint8), 37)) == 0.0