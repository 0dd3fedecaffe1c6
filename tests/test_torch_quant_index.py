"""The O(1) index of the CUDA FloatSD8 quantize kernel
(``floatsd_quantize.cu``) against the 64-midpoint count it replaces, and
against the port's and the JAX package's ``floatsd.encode``.

A numpy mirror of the kernel's ``code_of`` is built from the source itself:
it reads ``kMid``, ``kCode``, ``kTop``, ``kQuantShift``, ``kQuantBase`` and
``kQuantBuckets`` from the ``.cu`` file and builds the bucket table as its
``make_quant_buckets()`` does, so the two cannot drift; the codes of the 65
grid values are distinct, so the mirror's code equal to ``kCode`` at the
count means the index is the count. The mirror is constant on each run of
floats that share ``(bits(n) - 1) >> kQuantShift``, and the count of
midpoints below n is monotone in n, so the mirror equals the count on every
f32 in [0, 576] once it equals it at both ends of every run: that is
checked for every run, and besides at 0, the subnormals, 2^-3, 576, each
midpoint and its two neighbours, and a million random bit patterns.
Tolerance: none, every comparison is exact.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import floatsd as jfsd  # noqa: E402
from repro_torch.core import floatsd as tfsd  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "floatsd_quantize"
          / "floatsd_quantize.cu")
SRC = SOURCE.read_text()


def _array(name: str) -> list[str]:
    body = re.search(rf"{name}\[\w+\]\s*=\s*\{{(.*?)\}};", SRC, re.S).group(1)
    return [v.strip() for v in body.split(",") if v.strip()]


def _const(name: str) -> int:
    """An unsigned constant of the source: ``N``, ``Nu << M`` or ``kX + 1``."""
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", SRC).group(1)
    expr = re.sub(r"(\d+)u\b", r"\1", expr)
    expr = re.sub(r"\bk\w+", lambda m: str(_const(m.group(0))), expr)
    assert re.fullmatch(r"[\d\s<+]+", expr), expr
    return int(eval(expr))  # noqa: S307 — digits, spaces, << and + only


MID = np.array([float(v.rstrip("f")) for v in _array("kMid")], np.float32)
CODE = np.array([int(v) for v in _array("kCode")], np.uint8)
TOP = np.float32(float(re.search(r"constexpr float kTop = ([0-9.]+)f;", SRC).group(1)))
SHIFT, BASE, BUCKETS, TABLE = (_const(n) for n in ("kQuantShift", "kQuantBase", "kQuantBuckets", "kQuantTable"))


def negated(c: np.ndarray) -> np.ndarray:
    """The code with the sign folded into its mantissa index."""
    c = np.asarray(c, np.int64)
    return ((c & 0xE0) | (30 - (c & 31))).astype(np.uint8)


def quant_buckets() -> np.ndarray:
    """make_quant_buckets(): bucket k's lower edge 2^((BASE >> 5) - 127 + k // 32)
    (1 + (k % 32) / 32), kCode at the count of kMid at or below it, the
    clamp's kCode[0] last; then the same codes negated."""
    k = np.arange(BUCKETS)
    edge = ((1 + (k % 32) / 32) * 2.0 ** ((BASE >> 5) - 127 + k // 32)).astype(np.float32)
    half = np.append(CODE[(MID[None, :] <= edge[:, None]).sum(1)], CODE[0])
    return np.concatenate([half, negated(half)])


BUCKET = quant_buckets()


def key(n: np.ndarray) -> np.ndarray:
    """The bucket of the float just under n, in 32-bit unsigned arithmetic
    as the kernel forms it, clamped to the last entry."""
    bits = np.asarray(n, np.float32).view(np.uint32)
    return np.minimum(((bits - np.uint32(1)) >> np.uint32(SHIFT)) - np.uint32(BASE), np.uint32(BUCKETS))


def mirror_n(n: np.ndarray) -> np.ndarray:
    """The code of a non-negative n = min(|x| * 2^-bias, 576)."""
    return BUCKET[key(n)]


def mirror(x: np.ndarray, bias: int) -> np.ndarray:
    """code_of: n from |x| times the exact 2^-bias (bias clamped to [-126,
    120]), its bucket, and the half of the table x's sign bit picks."""
    x = np.asarray(x, np.float32)
    b = min(max(bias, -126), 120)
    inv_scale = np.array([(127 - b) << 23], np.uint32).view(np.float32)[0]
    n = np.minimum(np.abs(x) * inv_scale, TOP)
    sign = (x.view(np.uint32) >> np.uint32(31)).astype(np.int64)
    return BUCKET[key(n).astype(np.int64) + sign * TABLE]


def count64(n: np.ndarray) -> np.ndarray:
    """The pre-redesign index: the midpoints that n exceeds."""
    return (np.asarray(n, np.float32)[..., None] > MID).sum(-1)


def _bits(u) -> np.ndarray:
    return np.asarray(u, np.uint64).astype(np.uint32).view(np.float32)


def test_source_constants_describe_the_grid():
    assert MID.size == 64 and CODE.size == 65 and BUCKET.size == 2 * TABLE == 2 * (BUCKETS + 1)
    np.testing.assert_array_equal(MID, tfsd._GRID_MID.astype(np.float32))
    np.testing.assert_array_equal(CODE, ((tfsd._GRID_E << 5) | tfsd._GRID_MIDX).astype(np.uint8))
    assert TOP == np.float32(tfsd._GRID_POS[-1]) == 576
    assert np.unique(CODE).size == 65  # a code names its grid index
    # every midpoint is a bucket's lower edge, and no two share a bucket
    mb = MID.view(np.uint32)
    assert not (mb & np.uint32((1 << SHIFT) - 1)).any()
    keys = (mb >> np.uint32(SHIFT)).astype(np.int64) - BASE
    assert keys.min() == 0 and keys.max() < BUCKETS and np.unique(keys).size == 64
    assert int(TOP.view(np.uint32) - 1) >> SHIFT == BASE + 387
    # make_quant_buckets()'s arithmetic edges are the buckets' lower edges in
    # bits, so each bucket holds the code at the count of midpoints at or
    # below the float its key starts at; the clamp entry holds grid value 0's
    edges = ((np.arange(BUCKETS, dtype=np.uint64) + BASE) << SHIFT).astype(np.uint32).view(np.float32)
    k = np.arange(BUCKETS)
    np.testing.assert_array_equal(((1 + (k % 32) / 32) * 2.0 ** ((BASE >> 5) - 127 + k // 32)).astype(np.float32),
                                  edges)
    np.testing.assert_array_equal(BUCKET[:BUCKETS], CODE[(MID[None, :] <= edges[:, None]).sum(1)])
    assert BUCKET[0] == CODE[1] and BUCKET[387] == CODE[64] and BUCKET[BUCKETS] == CODE[0]
    # the negated half: -0 and +0 share grid value 0's code (mantissa index 15)
    np.testing.assert_array_equal(BUCKET[TABLE:], negated(BUCKET[:TABLE]))
    assert negated(CODE[0]) == CODE[0] == 15


def test_mirror_equals_the_count_on_every_f32_up_to_the_top():
    """Both ends of every run of floats that the index maps alike: the runs
    of keys BASE .. BASE + 387, which cover (2^-3, 576] (576 is the last
    float of the run of key BASE + 387), and the run below them, (0, 2^-3]."""
    top = int(TOP.view(np.uint32))
    keys = np.arange(BASE, (top - 1 >> SHIFT) + 1, dtype=np.uint64)
    ends = np.concatenate([(keys << SHIFT) + 1, (keys + 1) << SHIFT, [1, BASE << SHIFT]])
    n = _bits(ends)
    assert float(n.min()) > 0 and n.max() == TOP
    np.testing.assert_array_equal(mirror_n(n), CODE[count64(n)])
    # the runs tile (0, 576]: consecutive and gap-free in bit order
    lo, hi = np.sort((keys << SHIFT) + 1), np.sort((keys + 1) << SHIFT)
    assert lo[0] == (BASE << SHIFT) + 1 and (lo[1:] == hi[:-1] + 1).all() and hi[-1] == top


def test_mirror_at_zero_subnormals_the_base_the_top_and_midpoints():
    tiny = np.finfo(np.float32).tiny
    low = np.array([0.0, 1e-45, 1e-40, np.nextafter(tiny, 0, dtype=np.float32), tiny, 2.0**-4, 0.125], np.float32)
    assert (mirror_n(low) == CODE[0]).all() and (count64(low) == 0).all()
    above = np.nextafter(np.float32(0.125), np.float32(1))
    assert mirror_n(np.float32([above]))[0] == CODE[1]
    assert mirror_n(np.float32([TOP]))[0] == CODE[64] and count64(np.float32([TOP]))[0] == 64
    near = np.concatenate([MID, np.nextafter(MID, np.float32(0)), np.nextafter(MID, np.float32(1e9))])
    np.testing.assert_array_equal(mirror_n(near), CODE[count64(near)])


def test_mirror_on_a_million_random_patterns():
    rng = np.random.default_rng(0)
    top = int(TOP.view(np.uint32))
    n = rng.integers(0, top + 1, size=1_000_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(mirror_n(n), CODE[count64(n)])


def _x_edges(bias: int) -> np.ndarray:
    """Values around every grid point and midpoint at ``bias`` (16 f32 steps
    each side), +-0, values above the top, both signs, and Gaussian ones."""
    s = 2.0 ** min(max(bias, -126), 120)
    pts = np.concatenate([tfsd._GRID_POS, tfsd._GRID_MID, [600.0, 1e4]]) * s
    pts = np.minimum(pts, np.finfo(np.float32).max).astype(np.float32)
    steps = np.arange(-16, 17, dtype=np.int64)
    xs = (pts.view(np.int32)[:, None].astype(np.int64) + steps).clip(0, 0x7F7FFFFF).astype(np.int32)
    xs = xs.view(np.float32).ravel()
    rng = np.random.default_rng(bias + 200)
    g = np.minimum(np.abs(rng.standard_normal(50_000) * 40 * s), np.finfo(np.float32).max).astype(np.float32)
    g *= np.where(rng.random(50_000) < 0.5, np.float32(-1), np.float32(1))
    return np.concatenate([xs, -xs, g, np.float32([0.0, -0.0])])


@pytest.mark.parametrize("bias", [-126, -7, 0, 5, 120, 127])
def test_mirror_codes_equal_the_port_encode(bias):
    x = _x_edges(bias)
    x = x[np.isfinite(x)]
    want = tfsd.encode(torch.from_numpy(x), bias)[0].numpy()
    np.testing.assert_array_equal(mirror(x, bias), want)
    x16 = np.clip(x, -65504, 65504).astype(np.float16)
    want16 = tfsd.encode(torch.from_numpy(x16), bias)[0].numpy()
    np.testing.assert_array_equal(mirror(x16.astype(np.float32), bias), want16)


@pytest.mark.parametrize("bias", [-7, 0, 5, 120])
def test_mirror_codes_equal_the_jax_encode_where_xla_keeps_the_values(bias):
    """XLA on the CPU flushes f32 subnormals to zero (a reference caveat), so
    the JAX side sees only inputs whose |x| and |x| / 2^bias are 0 or
    normal."""
    x = _x_edges(bias)
    tiny = np.finfo(np.float32).tiny
    s = np.float32(2.0 ** min(max(bias, -126), 120))
    a = np.abs(x)
    keep = np.isfinite(x) & ((a == 0) | ((a >= tiny) & (a / s >= tiny)))
    x = x[keep]
    assert x.size > 50_000
    want = np.asarray(jfsd.encode(jnp.asarray(x), bias)[0])
    np.testing.assert_array_equal(mirror(x, bias), want)
