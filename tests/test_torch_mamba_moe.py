"""The port's Mamba mixer and mixture of experts against the JAX package's
``repro.nn.mamba.Mamba`` and ``repro.nn.moe.MoE``, on seeded numpy
parameters handed to both, under policies fp32 and floatsd8_table6.

Tolerances (measured on the CPU):
  * softplus: within 2^-22 relative of ``jax.nn.softplus``;
  * Mamba ``apply`` and 48 token-by-token ``decode`` steps (outputs and
    both caches): |err| <= 1e-5 of the scale (max(1, the largest magnitude
    compared)). The two scan the same recurrence in f32; the y = h C
    contraction, the decode step's convolution and the router's dot sum in
    other orders (worst seen 2.2e-7 of the scale);
  * MoE: the routing equal to the reference's, element for element: the
    top-k expert indices, each assignment's expert or drop bucket and its
    slot, and the keep mask, at random tokens, with a third of the tokens
    all zero (every router probability 1/E: the top-k is the k lowest
    experts, the reference's tie rule), with every token zero, and with a
    capacity factor of 0.1
    (most assignments dropped); the gates within 1e-5 (the router's logits
    reach |10|, and their f32 dots sum in other orders: 1.3e-6 seen); the
    output within 1e-5 of the scale; the load-balancing loss ``aux`` equal
    where every router probability is exact (all tokens zero: 1/E), else
    within 2^-20 relative: the router's f32 dot, its softmax's exp and the
    mean over the tokens round differently in the two frameworks, on
    exact logits too (1 or 2 ulps seen);
  * the expert products over packed codes: one ``floatsd_matmul`` record
    an expert, equal to the decode-then-einsum product within 1e-6 of the
    scale.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.nn.mamba import Mamba as JMamba  # noqa: E402
from repro.nn.mamba import MambaCache as JMambaCache  # noqa: E402
from repro.nn.moe import MoE as JMoE  # noqa: E402
from repro_torch.core import floatsd  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.nn.mamba import Mamba, MambaCache, softplus  # noqa: E402
from repro_torch.nn.moe import MoE, record_routes  # noqa: E402
from repro_torch.serving import pack_tree  # noqa: E402

POLICIES = ("fp32", "floatsd8_table6")
D, B, S = 64, 2, 48
MAMBA_TOL = 1e-5
E, K, HID = 4, 2, 96
MOE_TOL, GATE_TOL, AUX_RTOL = 1e-5, 1e-5, 2.0 ** -20


def close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def mamba_params(seed=0):
    rng = np.random.default_rng(seed)
    m = Mamba(D)
    di, ds, r = m.d_inner, m.d_state, m.rank
    p = {"in_proj": rng.standard_normal((D, 2 * di)) / np.sqrt(D),
         "conv_w": rng.standard_normal((m.d_conv, di)) * 0.5,
         "conv_b": rng.standard_normal(di) * 0.1,
         "x_proj": rng.standard_normal((di, r + 2 * ds)) / np.sqrt(di),
         "dt_proj": rng.standard_normal((r, di)) / np.sqrt(r),
         "dt_bias": -4.6 + 0.5 * rng.standard_normal(di),
         "a_log": np.log(rng.uniform(1.0, 16.0, (di, ds))),
         "d": 1.0 + 0.1 * rng.standard_normal(di),
         "out_proj": rng.standard_normal((di, D)) / np.sqrt(di)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def tparams(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def mamba_jax():
    """The JAX Mamba's apply and its decode steps, each policy compiled once."""
    p = mamba_params()
    u = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    jm = JMamba(D)
    out = {}
    for name in POLICIES:
        pol = jget_policy(name)
        y = jax.jit(lambda p, u: jm.apply(p, u, pol))(p, u)
        step = jax.jit(lambda p, u, c: jm.decode(p, u, c, pol))
        cache = JMambaCache(jnp.zeros((B, jm.d_inner, jm.d_state)),
                            jnp.zeros((B, jm.d_conv - 1, jm.d_inner), jnp.bfloat16))
        steps = []
        for t in range(S):
            o, cache = step(p, u[:, t:t + 1], cache)
            steps.append((np.asarray(o), np.asarray(cache.ssm), np.asarray(cache.conv, np.float32),
                          str(cache.conv.dtype)))
        out[name] = (np.asarray(y), steps)
    return p, u, out


@pytest.mark.parametrize("policy", POLICIES)
def test_mamba_apply_matches_jax(mamba_jax, policy):
    p, u, out = mamba_jax
    y = Mamba(D).apply(tparams(p), torch.from_numpy(u), get_policy(policy))
    close(y, out[policy][0], MAMBA_TOL, f"Mamba.apply {policy}")


@pytest.mark.parametrize("policy", POLICIES)
def test_mamba_decode_token_by_token_matches_jax(mamba_jax, policy):
    p, u, out = mamba_jax
    m, tp, pol = Mamba(D), tparams(p), get_policy(policy)
    cache = MambaCache(torch.zeros((B, m.d_inner, m.d_state)),
                       torch.zeros((B, m.d_conv - 1, m.d_inner), dtype=torch.bfloat16))
    for t, (o_j, ssm_j, conv_j, conv_dt) in enumerate(out[policy][1]):
        o, cache = m.decode(tp, torch.from_numpy(u[:, t:t + 1]), cache, pol)
        close(o, o_j, MAMBA_TOL, f"decode out {t}")
        close(cache.ssm, ssm_j, MAMBA_TOL, f"decode ssm {t}")
        close(cache.conv.float(), conv_j, MAMBA_TOL, f"decode conv {t}")
        # the window takes the promoted dtype: f32 after the first step, as the reference's
        assert str(cache.conv.dtype).split(".")[-1] == conv_dt == "float32"
    # the last decode output is the full-sequence path's last position
    close(o[:, 0], out[policy][0][:, -1], MAMBA_TOL, "decode vs apply")


def test_softplus_matches_jax_softplus():
    """Within 2^-22 relative (exp and log1p round differently in the two
    frameworks: 1 ulp at 5% of these points)."""
    x = np.concatenate([np.linspace(-40, 40, 4001), [-1e30, 1e30, 0.0, 20.0, 20.5]]).astype(np.float32)
    got = softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)


def moe_params(seed=2, d=D, e=E, h=HID):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, e)) * 0.5,
         "wi": rng.standard_normal((e, d, h)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, h)) / np.sqrt(d),
         "wo": rng.standard_normal((e, h, d)) / np.sqrt(h)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def jax_moe(jm, p, x, policy):
    """The reference's MoE.apply on x and its per-group routing, as apply
    computes it, in one jitted program: numpy (y, aux, expert indices [g,
    t, k], slot_e, slot_c, keep, gate)."""

    def run(p, x):
        b, s, d = x.shape
        g = math.gcd(b * s, jm.dispatch_groups)
        cap = jm.capacity(b * s // g)
        xf = x.reshape(g, b * s // g, d)
        y, aux = jm.apply(p, x, jget_policy(policy))
        _, (slot_e, slot_c, keep, gate), _ = jax.vmap(
            lambda xg: jm._dispatch_one(p, xg, jget_policy(policy), cap))(xf)
        _, idx = jax.lax.top_k(jax.nn.softmax(jnp.einsum("gtd,de->gte", xf, p["router"]), axis=-1), jm.top_k)
        return y, aux, idx, slot_e, slot_c, keep, gate

    return [np.asarray(t) for t in jax.jit(run)(p, jnp.asarray(x))]


# (case, capacity factor, share of all-zero tokens)
MOE_CASES = [("random", 1.25, 0), ("ties", 1.25, 3), ("all-zero", 1.25, 1), ("overflow", 0.1, 0)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case,cf,zero_every", MOE_CASES)
def test_moe_routing_and_output_match_jax(policy, case, cf, zero_every):
    p = moe_params()
    x = np.random.default_rng(3).standard_normal((4, 256, D)).astype(np.float32)  # 64 tokens a group
    if zero_every:
        x[:, ::zero_every] = 0.0
    jm, tm = JMoE(D, HID, E, K, capacity_factor=cf), MoE(D, HID, E, K, capacity_factor=cf)
    y_j, aux_j, idx_j, slot_e, slot_c, keep, gate = jax_moe(jm, jax.tree_util.tree_map(jnp.asarray, p), x, policy)
    with record_routes() as routes:
        y, aux = tm.apply(tparams(p), torch.from_numpy(x), get_policy(policy))
    (r,) = routes
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx_j)
    np.testing.assert_array_equal(r.slot_e.numpy(), slot_e)
    np.testing.assert_array_equal(r.slot_c.numpy(), slot_c)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert np.abs(r.gate.numpy() - gate).max() <= GATE_TOL
    dropped = int((~keep).sum())
    if case == "overflow":
        assert dropped > keep.size // 2
    if zero_every:  # the all-zero tokens go to experts 0 and 1, as the reference's top_k takes them
        assert (idx_j.reshape(4, 256, K)[:, ::zero_every] == [0, 1]).all()
    if case == "all-zero":  # every probability exactly 1/E
        assert float(aux) == float(aux_j) == 1.0
    else:
        assert abs(float(aux) - float(aux_j)) <= AUX_RTOL * abs(float(aux_j))
    close(y, y_j, MOE_TOL, f"MoE {case} {policy}")


def test_top_k_ties_take_the_lower_index_as_jax_does():
    probs = torch.tensor([[0.3, 0.3, 0.2, 0.2]])
    m = MoE(4, 8, 4, 2)
    route, _ = m.route(torch.eye(4), torch.log(probs)[None], cap=8)
    assert route.expert_idx.tolist() == [[[0, 1]]]
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert route.expert_idx[0].tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("n", [1, 4, 7, 64, 128, 1000, 4096])
def test_capacity_matches_jax(n):
    for e, k, cf in ((16, 2, 1.25), (384, 8, 1.25), (4, 2, 0.1)):
        assert MoE(8, 8, e, k, capacity_factor=cf).capacity(n) == JMoE(8, 8, e, k, capacity_factor=cf).capacity(n)


def test_top8_combine_is_bit_identical_across_runs():
    """Eight rows a token summed in slot order: two runs agree bit for bit."""
    p = moe_params(seed=6, e=16)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 64, D)).astype(np.float32))
    m = MoE(D, HID, 16, 8)
    a, aux_a = m.apply(tparams(p), x, get_policy("floatsd8_table6"))
    b, aux_b = m.apply(tparams(p), x, get_policy("floatsd8_table6"))
    assert torch.equal(a, b) and float(aux_a) == float(aux_b)


def test_expert_products_on_packed_codes_run_one_matmul_an_expert():
    """Packed expert weights: E floatsd_matmul records a product, and the
    output equals the dense fake-quant path's on the decoded values."""
    p = pack_tree(tparams(moe_params()))
    assert all(tkd.is_packed(p[k]) for k in ("router", "wi", "wg", "wo"))
    p["router"] = floatsd.decode(p["router"].codes, p["router"].bias)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 32, D)).astype(np.float32))
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")
    m = MoE(D, HID, E, K)
    tkd.STATS.reset()
    y, _ = m.apply(p, x, pol)
    assert tkd.STATS.snapshot() == {("floatsd_matmul", "ref"): 3 * E}
    dense = {k: floatsd.decode(v.codes, v.bias) if tkd.is_packed(v) else v for k, v in p.items()}
    want, _ = m.apply(dense, x, pol)
    close(y, want, 1e-6, "packed vs decoded experts")
    be = torch.randn((3, E, 5, D))
    got = tkd.packed_einsum("gecd,edh->gech", be, p["wi"])
    np.testing.assert_allclose(got.numpy(), torch.einsum("gecd,edh->gech", be, dense["wi"]).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tkd.packed_einsum("gecd,dh->gech", be, p["wi"])


def test_expert_launches_land_in_the_cost_ledger_at_their_own_shapes():
    """Each expert's product is recorded with the cost of its own [g*C, K]
    x [K, N] call: E calls, E times one call's cost, and the touched bytes
    the plain version's cost model predicts exactly."""
    from repro_torch.kernels.floatsd_matmul import cost as fm_cost

    g, e, c, k, n = 3, E, 5, D, HID
    w = pack_tree(tparams(moe_params()))["wi"]
    x = torch.randn((g, e, c, k))
    tkd.STATS.reset()
    tkd.packed_einsum("gecd,edh->gech", x, w)
    (row,) = [r for r in tkd.LEDGER.rows() if r["op"] == "floatsd_matmul"]
    one = fm_cost.matmul_fwd_cost(g * c, k, n, backend="ref")
    assert row["backend"] == "ref" and row["calls"] == e
    snap = tkd.STATS.cost_snapshot()[("floatsd_matmul", "ref")]
    assert snap["cost"].flops == e * one.flops and snap["cost"].hbm_bytes == e * one.hbm_bytes
    assert snap["touched_bytes"] == e * one.hbm_bytes
