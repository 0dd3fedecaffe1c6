"""Payloads of ``fp8_psum``'s parity checks and their two references.

``psum_payloads(n)`` gives {name: [n, 64] f32}, rank r's tensor in row r:

  * ``gaussian``: seeded normals, every rank's max|x| within a factor 1.9
    of the others' (the group's largest scale then saturates no rank);
  * ``po2``: max|x| exactly 4 and one f32 ulp either side of it;
  * ``critical``: max|x| at and one ulp beside 3.5 x 2^m, where 28672 /
    max|x| is a power of two or one ulp from one: floor(log2) there is
    what f32 log2 may round across;
  * ``saturating``: one rank's max|x| five times another's, so the group's
    (largest) scale pushes it past the e5m2 max.

The scales of ``gaussian``, ``po2`` and ``saturating`` are 2^11 and 2^12:
XLA's f32 exp2 on the CPU is exact for the integers -12 .. 12 (and some
even ones beyond), not for 13, 15, 17, ... (exp2(13) = 8192.004), so the
JAX reference's "power of two" scale is one only there.

``jax_psum`` is the JAX package's ``fp8_psum`` under ``vmap(axis_name=
"pod")``; ``exact_psum`` is the same formula in numpy with the exact
power-of-two scale (from float64 log2 of the f32 quotient) and the
saturating e5m2 cast (``ml_dtypes``), summed over the ranks in f32.
"""
import ml_dtypes
import numpy as np

N = 64


def psum_payloads(n: int) -> dict:
    rng = np.random.default_rng(7)
    g = rng.standard_normal((n, N)).astype(np.float32)
    g = g / np.abs(g).max(1, keepdims=True) * np.linspace(5.0, 9.5, n, dtype=np.float32)[:, None]

    def with_amax(amaxes):
        x = rng.uniform(-1.0, 1.0, (n, N)).astype(np.float32) * 0.5
        for r, a in enumerate(amaxes):
            x[r] = x[r] * np.float32(a)
            x[r, r % N] = np.float32(a) * (1 if r % 2 else -1)
        return x.astype(np.float32)

    four = np.float32(4.0)
    po2 = [four, np.nextafter(four, np.float32(0)), np.nextafter(four, np.float32(8)), four]
    crit = []
    for m in (-2, 0, 3, 5):
        c = np.float32(3.5 * 2.0 ** m)
        crit += [c, np.nextafter(c, np.float32(0)), np.nextafter(c, np.float32(np.inf))]
    sat = [4.0, 20.0, 5.0, 6.0]
    return {"gaussian": g,
            "po2": with_amax(po2[:n]),
            "critical": [with_amax(crit[i:i + n]) for i in range(0, len(crit), n)],
            "saturating": with_amax(sat[:n])}


def flat_payloads(payloads: dict) -> list:
    """[(name, [n, 64] array)] in a fixed order."""
    out = []
    for name, p in payloads.items():
        for i, a in enumerate(p if isinstance(p, list) else [p]):
            out.append((f"{name}{i}" if isinstance(p, list) else name, a))
    return out


def po2_scale_exact(x: np.ndarray) -> np.float32:
    amax = np.float32(np.abs(x.astype(np.float32)).max())
    amax = amax if amax > 0 else np.float32(1.0)
    q = np.float32(28672.0) / amax
    return np.float32(2.0 ** np.floor(np.log2(np.float64(q))))


def exact_psum(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    s = max(po2_scale_exact(r) for r in x)
    tot = np.zeros(x.shape[1:], np.float32)
    for r in x:
        xs = np.clip((r.astype(np.float32) * s).astype(np.float32), -57344.0, 57344.0)
        tot = (tot + xs.astype(ml_dtypes.float8_e5m2).astype(np.float32)).astype(np.float32)
    return (tot / np.float32(np.float32(n) * s)).astype(np.float32)


def jax_psum(x: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from repro.optim.grad_compress import fp8_psum

    return np.asarray(jax.vmap(lambda t: fp8_psum(t, "pod"), axis_name="pod")(jnp.asarray(x)))[0]
