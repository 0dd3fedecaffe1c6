"""The O(1) LUT index of the CUDA gate function (``lstm_cell_common.cuh``)
against the 42-midpoint count it replaces, and against the JAX package.

A numpy mirror of ``sig_lut`` is built from the header itself: it reads
``kSigMid``, ``kSigGrid``, ``kSigShift``, ``kSigBase`` and ``kSigBuckets``
from the source and builds the bucket table as the header's
``make_sig_buckets()`` does, so the two cannot drift; the LUT's values are
distinct, so the mirror's value equal to ``kSigGrid`` at the count means the
index is the count. The
mirror is constant on each run of floats that share ``(bits(s) - 1) >>
kSigShift``, and the count of midpoints below s is monotone in s, so the
mirror equals the count on every f32 in (0, 0.5] once it equals it at both
ends of every run: that is checked for every run, and besides at 0, the
subnormals, 0.5, NaN, each midpoint and its two neighbours, and a million
random bit patterns.
Tolerance: none, every comparison is exact.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import qsigmoid as jqs  # noqa: E402
from repro_torch.core import qsigmoid as tqs  # noqa: E402

HEADER = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "lstm_cell" / "lstm_cell_common.cuh"
SRC = HEADER.read_text()


def _floats(name: str) -> np.ndarray:
    body = re.search(rf"{name}\[\w+\]\s*=\s*\{{(.*?)\}};", SRC, re.S).group(1)
    return np.array([float(v.rstrip("f")) for v in re.findall(r"[-0-9.e]+f", body)], np.float32)


def _const(name: str) -> int:
    """An unsigned constant of the header: ``N``, ``Nu << M`` or ``kX + 1``."""
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", SRC).group(1)
    expr = re.sub(r"(\d+)u\b", r"\1", expr)
    expr = re.sub(r"\bk\w+", lambda m: str(_const(m.group(0))), expr)
    assert re.fullmatch(r"[\d\s<+]+", expr), expr
    return int(eval(expr))  # noqa: S307 — digits, spaces, << and + only


MID, GRID = _floats("kSigMid"), _floats("kSigGrid")
SHIFT, BASE, BUCKETS, TABLE = (_const(n) for n in ("kSigShift", "kSigBase", "kSigBuckets", "kSigTable"))


def sig_buckets() -> np.ndarray:
    """make_sig_buckets(): bucket b's lower edge 2^((BASE >> 5) - 127 + b // 32)
    (1 + (b % 32) / 32), kSigGrid at the count of kSigMid at or below it, and
    the clamp's 0 last."""
    b = np.arange(BUCKETS)
    edge = ((1 + (b % 32) / 32) * 2.0 ** ((BASE >> 5) - 127 + b // 32)).astype(np.float32)
    return np.append(GRID[(MID[None, :] <= edge[:, None]).sum(1)], np.float32(0))


BUCKET = sig_buckets()


def mirror(s: np.ndarray) -> np.ndarray:
    """sig_lut: the bucket of the float just under s, in 32-bit unsigned
    arithmetic as the kernel forms it, clamped to the last entry."""
    bits = np.asarray(s, np.float32).view(np.uint32)
    b = ((bits - np.uint32(1)) >> np.uint32(SHIFT)) - np.uint32(BASE)
    return BUCKET[np.minimum(b, np.uint32(BUCKETS))]


def count42(s: np.ndarray) -> np.ndarray:
    """The pre-redesign index: the midpoints that s exceeds (NaN: none)."""
    return (np.asarray(s, np.float32)[..., None] > MID).sum(-1)


def lut42(s: np.ndarray) -> np.ndarray:
    return GRID[count42(s)]


def _bits(u) -> np.ndarray:
    return np.asarray(u, np.uint64).astype(np.uint32).view(np.float32)


def test_header_constants_describe_the_lut():
    assert MID.size == 42 and GRID.size == 43 and BUCKET.size == TABLE == BUCKETS + 1
    np.testing.assert_array_equal(GRID, tqs.sigmoid_lut_values().astype(np.float32))
    np.testing.assert_array_equal(MID, ((GRID[1:] + GRID[:-1]) / 2).astype(np.float32))
    assert np.unique(GRID).size == 43  # a value names its index
    # every midpoint is a bucket's lower edge: its bits below the shift are 0
    mb = MID.view(np.uint32)
    assert not (mb & np.uint32((1 << SHIFT) - 1)).any()
    keys = (mb >> np.uint32(SHIFT)).astype(np.int64) - BASE
    assert keys.min() == 0 and keys.max() < BUCKETS
    assert int(np.float32(0.5).view(np.uint32) - 1) >> SHIFT == BASE + BUCKETS - 1
    # make_sig_buckets()'s arithmetic edges are the buckets' lower edges in
    # bits, so each bucket holds the LUT value at the count of midpoints at
    # or below the float its key starts at; the clamp entry holds the LUT's 0
    edges = ((np.arange(BUCKETS, dtype=np.uint64) + BASE) << SHIFT).astype(np.uint32).view(np.float32)
    b = np.arange(BUCKETS)
    np.testing.assert_array_equal(((1 + (b % 32) / 32) * 2.0 ** ((BASE >> 5) - 127 + b // 32)).astype(np.float32),
                                  edges)
    np.testing.assert_array_equal(BUCKET[:-1], GRID[(MID[None, :] <= edges[:, None]).sum(1)])
    assert BUCKET[0] == GRID[1] and BUCKET[BUCKETS - 1] == GRID[42] and BUCKET[BUCKETS] == 0


def test_mirror_equals_the_count_on_every_f32_in_the_gate_range():
    """Both ends of every run of floats that sig_lut maps alike: the runs of
    keys BASE .. BASE + BUCKETS - 1 and the run below them, which together
    cover (0, 0.5] (0.5 is the last float of the top run)."""
    keys = np.arange(BASE, BASE + BUCKETS, dtype=np.uint64)
    ends = np.concatenate([(keys << SHIFT) + 1, (keys + 1) << SHIFT, [1, BASE << SHIFT]])
    s = _bits(ends)
    assert float(s.min()) > 0 and float(s.max()) == 0.5
    np.testing.assert_array_equal(mirror(s), lut42(s))
    # the runs tile (0, 0.5]: consecutive and gap-free in bit order
    lo, hi = np.sort((keys << SHIFT) + 1), np.sort((keys + 1) << SHIFT)
    assert lo[0] == (BASE << SHIFT) + 1 and (lo[1:] == hi[:-1] + 1).all()
    assert hi[-1] == np.float32(0.5).view(np.uint32)


def test_mirror_at_zero_subnormals_half_nan_and_midpoints():
    tiny = np.finfo(np.float32).tiny
    sub = np.array([0.0, 1e-45, 1e-40, np.nextafter(tiny, 0, dtype=np.float32), tiny, 2.0**-11, 2.0**-10],
                   np.float32)
    assert (mirror(sub) == 0).all() and (count42(sub) == 0).all()
    assert mirror(np.float32([0.5]))[0] == GRID[42] and count42(np.float32([0.5]))[0] == 42
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF], np.uint32).view(np.float32)
    assert (mirror(nans) == 0).all() and (count42(nans) == 0).all()
    near = np.concatenate([MID, np.nextafter(MID, np.float32(0)), np.nextafter(MID, np.float32(1))])
    np.testing.assert_array_equal(mirror(near), lut42(near))


def test_mirror_on_a_million_random_patterns():
    rng = np.random.default_rng(0)
    top = int(np.float32(0.5).view(np.uint32))
    s = rng.integers(1, top + 1, size=1_000_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(mirror(s), lut42(s))


def _x_edges() -> np.ndarray:
    """x where sigma(-|x|) crosses a midpoint (both signs), 64 f32 steps
    around each, 0, +-inf and NaN."""
    xm = np.log(1.0 / MID.astype(np.float64) - 1.0).astype(np.float32)  # sigma(-xm) = mid
    steps = np.arange(-64, 65, dtype=np.int64)
    xs = (xm.view(np.int32)[:, None].astype(np.int64) + steps).astype(np.int32).view(np.float32).ravel()
    return np.concatenate([xs, -xs, np.float32([0.0, -0.0, np.inf, -np.inf, np.nan])])


def test_mirror_through_sigma_equals_the_jax_and_port_qsigmoid():
    rng = np.random.default_rng(1)
    x = np.concatenate([_x_edges(), (rng.standard_normal(200_000) * 4).astype(np.float32)])
    xj = jnp.asarray(x)
    s_jax = np.asarray(jax.nn.sigmoid(-jnp.abs(xj)))
    q = mirror(s_jax)
    want = np.asarray(jqs.qsigmoid_raw(xj))
    np.testing.assert_array_equal(np.where(x > 0, np.float32(1) - q, q), want)
    s_t = torch.sigmoid(-torch.from_numpy(x).abs()).numpy()
    q_t = mirror(s_t)
    np.testing.assert_array_equal(np.where(x > 0, np.float32(1) - q_t, q_t),
                                  tqs.qsigmoid_raw(torch.from_numpy(x)).numpy())
