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

# ---------------------------------------------------------------------------
# the element-wise entry points: dispatch.quantize and dispatch.qsigmoid
# ---------------------------------------------------------------------------

ELEMWISE_SHAPES = [(8, 256), (7, 33), (1000,), (2, 3, 7), (64, 512)]


def _elem(shape, scale, seed=0):
    rng = np.random.default_rng(seed + int(np.prod(shape)))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", ELEMWISE_SHAPES)
def test_quantize_entry_point_matches_jax(shape):
    x = _elem(shape, 0.7)
    tkd.STATS.reset()
    codes, bias = tkd.quantize(torch.from_numpy(x))
    want_codes, want_bias = jkd.quantize(jnp.asarray(x), backend="ref")
    assert codes.shape == x.shape and codes.dtype == torch.uint8
    assert bias.dtype == torch.int32 and int(bias) == int(want_bias)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert tkd.STATS.last["floatsd_quantize"] == tkd.Decision("floatsd_quantize", "ref", "cpu tensor")
    assert tkd.STATS.count(backend="cuda") == 0


@pytest.mark.parametrize("bias", [-126, -7, 0, 127])
def test_quantize_entry_point_edge_values_match_jax(bias):
    """±0, every grid value and midpoint (ties), values above the top, at
    an explicit bias: the returned bias is the one given, the codes use it
    clamped to [-126, 120], as in the JAX package. At bias 127 the values
    whose scaled copy overflows f32 are left out (no code for inf). f32
    subnormals (at -126 the small values, at 0 the one after 0.0) XLA on
    the CPU reads as 0 (the zero code, 15) and the port keeps:
    there the port's code is its code of the same value scaled up by
    2^126 at bias 0 (exact)."""
    grid = np.concatenate([tfsd._GRID_POS, tfsd._GRID_MID]).astype(np.float32)
    scale = np.float32(2.0 ** np.clip(bias, -126, 120))
    v = np.concatenate([grid, np.nextafter(grid, np.float32(np.inf)), [600.0, 1e4]]).astype(np.float32)
    v = np.concatenate([[0.0, -0.0], v, -v]).astype(np.float32)
    with np.errstate(over="ignore"):
        x = v * scale
    x = x[np.isfinite(x)]
    codes, got_bias = tkd.quantize(torch.from_numpy(x), bias)
    want_codes, want_bias = jkd.quantize(jnp.asarray(x), jnp.int32(bias), backend="ref")
    assert int(got_bias) == int(want_bias) == bias
    got, want = codes.numpy(), np.asarray(want_codes)
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    assert bias != -126 or sub.sum() > 20
    assert np.all(want[sub] == 15)
    np.testing.assert_array_equal(got[sub], tfsd.encode(torch.from_numpy(x[sub] * np.float32(2.0**126)), 0)[0].numpy())
    np.testing.assert_array_equal(got[~sub], want[~sub])


@pytest.mark.parametrize("shape", ELEMWISE_SHAPES)
def test_qsigmoid_entry_point_matches_jax(shape):
    x = _elem(shape, 2.0)
    tkd.STATS.reset()
    got = tkd.qsigmoid(torch.from_numpy(x))
    want = jkd.qsigmoid(jnp.asarray(x), backend="ref")
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tkd.STATS.last["qsigmoid"] == tkd.Decision("qsigmoid", "ref", "cpu tensor")


def test_new_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    from repro_torch.core.floatsd4 import encode as enc4, pack_nibbles
    from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul
    from repro_torch.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.qsigmoid.ops import qsigmoid

    before = (floatsd4_matmul.launches, floatsd_quantize.launches, qsigmoid.launches)
    x = torch.from_numpy(_elem((5, 99), 1.0))
    c4, e4 = enc4(torch.from_numpy(_elem((99, 40), 0.05)))
    p4 = pack_nibbles(c4)
    assert torch.equal(floatsd4_matmul(x, p4, e4, 99), floatsd4_matmul_ref(x, p4, e4, 99))
    assert torch.equal(floatsd_quantize(x, -3), tfsd.encode(x, -3)[0])
    assert torch.equal(qsigmoid(x), tqs.qsigmoid_raw(x))
    assert (floatsd4_matmul.launches, floatsd_quantize.launches, qsigmoid.launches) == before


def _c_ints(src: str, name: str) -> np.ndarray:
    body = re.search(rf"{name}\[\d+\]\s*=\s*\{{(.*?)\}};", src, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)])


def test_new_cuda_source_tables_match_the_port():
    from repro_torch.core import floatsd4 as tfsd4

    src4 = (KERNELS_DIR / "floatsd4_matmul" / "floatsd4_matmul.cu").read_text()
    np.testing.assert_array_equal(_c_array(src4, "kLut16"), tfsd4.LUT16)
    q = (KERNELS_DIR / "floatsd_quantize" / "floatsd_quantize.cu").read_text()
    np.testing.assert_array_equal(_c_array(q, "kMid"), tfsd._GRID_MID.astype(np.float32))
    np.testing.assert_array_equal(_c_ints(q, "kCode"), (tfsd._GRID_E << 5) | tfsd._GRID_MIDX)
    assert f"kTop = {tfsd._GRID_POS[-1]:.1f}f" in q


def test_build_hash_follows_included_headers(tmp_path, monkeypatch):
    """qsigmoid.cu includes the cell's header from another directory, both
    decode matmul kernels include the shared tile loops, and those loops,
    the flash-attention and the wkv kernels include the warp-level
    instructions (through the tile loops, a header of a header): each header
    is among its includers' sources, and an edit to it changes the library
    name of every kernel that includes it, and of no other. The weight
    gradient's source includes none."""
    common = KERNELS_DIR / "lstm_cell" / "lstm_cell_common.cuh"
    tiles = KERNELS_DIR / "routed_gemm.cuh"
    warp = KERNELS_DIR / "warp_mma.cuh"
    assert common in _build._sources("qsigmoid") and common in _build._sources("lstm_cell_bwd")
    assert _build._sources("floatsd4_matmul") == [KERNELS_DIR / "floatsd4_matmul" / "floatsd4_matmul.cu", tiles, warp]
    assert _build._sources("floatsd_matmul") == [KERNELS_DIR / "floatsd_matmul" / "floatsd_matmul.cu", tiles, warp]
    assert _build._sources("flash_attention") == [KERNELS_DIR / "flash_attention" / "flash_attention.cu", warp]
    assert _build._sources("rwkv_wkv") == [KERNELS_DIR / "rwkv_wkv" / "rwkv_wkv.cu", warp]
    assert _build._sources("floatsd_matmul_dw") == [KERNELS_DIR / "floatsd_matmul" / "floatsd_matmul_dw.cu"]
    assert not (KERNELS_DIR / "decode_gemm.cuh").exists()
    assert "--fmad=false" in _build._target("qsigmoid")[1]
    import shutil

    copy = tmp_path / "kernels"
    shutil.copytree(KERNELS_DIR, copy, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(_build, "_KERNELS_DIR", copy)
    for header, includers in [("lstm_cell/lstm_cell_common.cuh", {"lstm_cell", "lstm_cell_bwd", "qsigmoid"}),
                              ("routed_gemm.cuh", {"floatsd_matmul", "floatsd4_matmul"}),
                              ("warp_mma.cuh", {"floatsd_matmul", "floatsd4_matmul", "flash_attention", "rwkv_wkv"})]:
        before = {op: _build._target(op)[0].name for op in _build.KERNELS}
        path = copy / header
        path.write_text(path.read_text() + "\n// edited\n")
        changed = {op for op in _build.KERNELS if _build._target(op)[0].name != before[op]}
        assert changed == includers, header
