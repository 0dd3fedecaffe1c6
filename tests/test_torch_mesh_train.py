"""The port's training on a device mesh, on the CPU: worlds of 1, 2 and 4
gloo ranks (``tests/torch_mesh_world.py``: one process group a world, the
three at once, started once for the module) against one another and
against the JAX package's step on the global batch.

The LM is ``tests/test_torch_train.py``'s (vocab 128, width 16, 2 layers,
B 8 x S 16, SGD 0.9 at lr 0.5, floatsd8_table6) from JAX's seed-0 init.
On a mesh of (world, 1) ("data", "model") its masters are stored sharded
(the embedding table's and wx's embed dims over "data"), each rank trains
on its rows, and the gradients are summed over the ranks.

Tolerances:
  * losses of worlds 2 and 4 within 1e-6 relative of world 1's (the loss is
    the ranks' shares summed, an f32 sum in another order; measured
    2.0e-7);
  * masters of worlds 2 and 4 against world 1's: wx and wh bit for bit
    (``matmul_dw`` runs the global rows' one chain, as the tied head's bf16
    dW does); every other leaf equal except at most 1% of its elements (or
    2), none more than 1e-4 away (the embedding lookup's and the biases'
    gradients are f32 sums of the ranks' partials, so an FP8 snap can land
    a step apart: measured at world 2 1 of 4096 table elements, 2.4e-7
    apart, and 1 of 64 in each bias, at most 2.9e-5; world 4 bit for bit);
  * every world against JAX's jitted step: the 3 losses within 1e-3
    relative and each master leaf within 0.1% (relative L2) of JAX's
    change to it: ``test_torch_train.py``'s bounds for world 1;
  * the global statistics: a NaN in one rank's loss share makes every rank
    skip the step and halve the dynamic scale; UDPOS rows masked to
    unequal lengths per rank give the global masked mean (the shares'
    sum within 1e-6 of world 1's loss), where the mean of the ranks' means
    differs by more than 1%;
  * checkpoints: a state written at world 4 restores at world 2 equal,
    array for array, and one the JAX package wrote restores onto worlds 2
    and 4 equal to JAX's arrays, each rank holding its piece;
  * ``fp8_psum`` at 4 ranks (``tests/sharding_cases.py``'s payloads): bit
    for bit equal to the exact-scale, saturating formula on every payload,
    and to the JAX package's ``vmap(axis_name="pod")`` reference on every
    payload where that reference's scale is a power of two and nothing
    saturates; where it is not (``critical``: XLA's f32 log2 rounds
    across an integer) or a value saturates (the reference's cast
    overflows to inf), the reference's difference is asserted as it is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_world as world  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import checkpointing as jckpt  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim import train_state as jts  # noqa: E402
from sharding_cases import exact_psum, flat_payloads, jax_psum, psum_payloads  # noqa: E402

STEPS = 3
WORLDS = (1, 2, 4)
#: UDPOS rows' valid lengths: the first half long, the second short, so
#: the ranks of worlds 2 and 4 hold unequal token counts
UDPOS_LENGTHS = [32 - (i % 8) for i in range(32)] + [2 + (i % 5) for i in range(32)]


def _jax_run():
    """JAX's fused step from its seed-0 init on the global batches."""
    model = JLM(vocab=world.V, emb=world.W, hidden=world.W, n_layers=2)
    data = jsyn.wikitext2(batch=world.B, seq=world.S, vocab=world.V, seed=0)
    opt, pol = jsgd(0.9), jget_policy(world.POLICY)
    params = model.init(jax.random.PRNGKey(0))
    state = jts.init_state(params, opt, pol)
    step = jax.jit(jts.make_train_step(model.loss, opt, pol, lr=0.5, fused=True))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in next(data.batches).items()})
        losses.append(float(m["loss"]))
    return params, losses, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    params, losses, state = _jax_run()
    flat = {f"{k}/{n}": np.asarray(a) for k, d in params.items() for n, a in d.items()}
    np.savez(tmp / "params.npz", **flat)
    jckpt.save(str(tmp / "jax_ckpt"), state, STEPS)
    np.savez(tmp / "payloads.npz", **dict(flat_payloads(psum_payloads(4))))
    p = str(tmp / "params.npz")
    jobs = {n: [("lm_steps", {"params_path": p, "steps": STEPS}),
                ("lm_steps", {"params_path": p, "steps": 1, "nan_rank": n - 1, "dynamic": True}),
                ("udpos_step", {"lengths": UDPOS_LENGTHS})] for n in WORLDS}
    jobs[4] += [("ckpt_write", {"params_path": p, "path": str(tmp / "ckpt4")}),
                ("ckpt_restore", {"params_path": p, "path": str(tmp / "jax_ckpt")}),
                ("psum", {"payload_path": str(tmp / "payloads.npz")}),
                ("pod_mean", {"payload_path": str(tmp / "payloads.npz")})]
    jobs[2] += [("ckpt_restore", {"params_path": p, "path": str(tmp / "ckpt4")}),
                ("ckpt_restore", {"params_path": p, "path": str(tmp / "jax_ckpt")})]
    out = world.run_worlds(jobs, tmp)
    jax_flat = {".params/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    return {"worlds": out, "jax": (params, losses, jax_flat, state)}


def _few_apart(a, w) -> bool:
    """At most 1% of the elements (or 2) differ, none by more than 1e-4."""
    return (a != w).sum() <= max(2, 0.01 * a.size) and np.abs(a - w).max() <= 1e-4


def _lm(runs, n, rank=0):
    return runs["worlds"][n][rank][0]


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_holds_the_same_global_step(runs, n):
    ref = _lm(runs, n)
    for r in range(1, n):
        got = _lm(runs, n, r)
        assert got["losses"] == ref["losses"] and got["finite"] == ref["finite"]
        for k, v in ref["masters"].items():
            assert np.array_equal(got["masters"][k], v), (n, r, k)


@pytest.mark.parametrize("n", WORLDS)
def test_masters_are_stored_sharded_by_the_logical_specs(runs, n):
    got = _lm(runs, n)
    assert got["specs"]["embed/table"] == ("model", "data")
    assert got["specs"]["lstm0/wx"] == ("data", "model") and got["specs"]["lstm0/wh"] == (None, "model")
    assert got["pieces"]["embed/table"] == (256, world.W // n)
    assert got["pieces"]["lstm1/wx"] == (world.W // n, 4 * world.W)
    assert got["pieces"]["lstm1/wh"] == (world.W, 4 * world.W)  # hidden: replicated
    # a step: 10 gathers of the masters (an axis each of a leaf's sharded
    # dims), 8 of matmul_dw's rows (x and g, 2 layers x dWx, dWh), 2 of the
    # tied head's bf16 dW rows; one f32 all-reduce
    assert got["collectives"] == {"all_gather": 20 * STEPS, "all_reduce": STEPS}


@pytest.mark.parametrize("n", (2, 4))
def test_worlds_match_world_one(runs, n):
    one, got = _lm(runs, 1), _lm(runs, n)
    assert all(got["finite"])
    rel = np.abs(np.array(got["losses"]) - one["losses"]) / np.abs(one["losses"])
    assert rel.max() <= 1e-6, rel
    for k, want in one["masters"].items():
        a, w = got["masters"][k].astype(np.float32), want.astype(np.float32)
        if k.endswith(("/wx", "/wh")):
            assert np.array_equal(a, w), k
            continue
        assert _few_apart(a, w), (k, (a != w).sum())


@pytest.mark.parametrize("n", WORLDS)
def test_worlds_match_the_jax_global_batch_step(runs, n):
    params_j, losses_j, flat_j, _ = runs["jax"]
    got = _lm(runs, n)
    rel = np.abs(np.array(got["losses"]) - losses_j) / np.abs(losses_j)
    assert rel.max() <= 1e-3, rel
    for key, want in flat_j.items():
        name = key.split("/", 1)[1]
        a = got["masters"][name]
        assert a.dtype == want.dtype == np.float16
        init = np.asarray(params_j[name.split("/")[0]][name.split("/")[1]], np.float16).astype(np.float32)
        moved = np.linalg.norm(want.astype(np.float32) - init)
        assert np.linalg.norm(a.astype(np.float32) - want.astype(np.float32)) <= 1e-3 * moved, key


@pytest.mark.parametrize("n", WORLDS)
def test_a_nonfinite_share_skips_the_step_on_every_rank(runs, n):
    params_j = runs["jax"][0]
    for r in range(n):
        got = runs["worlds"][n][r][1]
        # every rank skips and halves the dynamic scale (2^15) alike
        assert got["finite"] == [False] and got["scale"] == [2.0 ** 14], (n, r)
        for k, v in got["masters"].items():
            init = np.asarray(params_j[k.split("/")[0]][k.split("/")[1]], np.float16)
            assert np.array_equal(v, init), (n, r, k)


@pytest.mark.parametrize("n", (2, 4))
def test_the_masked_loss_takes_the_global_denominator(runs, n):
    one = runs["worlds"][1][0][2]
    shares = [runs["worlds"][n][r][2] for r in range(n)]
    assert len({s["tokens"] for s in shares}) > 1  # the ranks' rows hold unequal token counts
    total = sum(s["share"] for s in shares)
    assert abs(total - one["share"]) <= 1e-6 * abs(one["share"])
    assert abs(shares[0]["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    naive = np.mean([s["share"] * sum(x["tokens"] for x in shares) / s["tokens"] for s in shares])
    assert abs(naive - one["share"]) > 1e-2 * abs(one["share"])
    for k, want in one["masters"].items():
        a, w = shares[0]["masters"][k].astype(np.float32), want.astype(np.float32)
        assert _few_apart(a, w), (k, (a != w).sum())


def test_a_world_four_checkpoint_restores_at_world_two(runs):
    written = runs["worlds"][4][0][3]
    for r in range(2):
        got = runs["worlds"][2][r][3]
        assert got["step"] == 2
        assert got["pieces"][".params/embed/table"] == (256, world.W // 2)
        assert set(got["state"]) == set(written)
        for k, v in written.items():
            assert np.array_equal(got["state"][k], v), k


@pytest.mark.parametrize("n,job", [(4, 4), (2, 4)])
def test_a_jax_checkpoint_restores_onto_the_mesh(runs, n, job):
    _, _, _, state = runs["jax"]
    want = {}
    for path, v in jax.tree_util.tree_flatten_with_path(state)[0]:
        parts = [f".{p.name}" if hasattr(p, "name") else str(getattr(p, "key", getattr(p, "idx", p)))
                 for p in path]
        want["/".join(parts)] = np.asarray(v)
    got = runs["worlds"][n][0][job]
    assert got["step"] == STEPS
    assert got["pieces"][".params/lstm0/wx"] == (world.W // n, 4 * world.W)
    for k, v in got["state"].items():
        assert np.array_equal(v, want[k]), k



PAYLOADS = flat_payloads(psum_payloads(4))


@pytest.mark.parametrize("name,x", PAYLOADS, ids=[n for n, _ in PAYLOADS])
def test_fp8_psum_at_four_ranks(runs, name, x):
    outs = [runs["worlds"][4][r][-2][name] for r in range(4)]
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])
    got, exact, ref = outs[0], exact_psum(x), jax_psum(x)
    assert np.array_equal(got.view(np.uint32), exact.view(np.uint32)), name
    if name.startswith("saturating"):
        over = ~np.isfinite(ref)
        assert over.any() and np.all(np.isfinite(got))  # the reference's cast overflows; the port's saturates
        assert np.array_equal(got[~over], ref[~over])
    elif not name.startswith("critical"):  # there the reference's log2 and exp2 miss the power of two
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), name


@pytest.mark.parametrize("name,x", PAYLOADS, ids=[n for n, _ in PAYLOADS])
def test_pod_compressed_mean_over_two_pods(runs, name, x):
    """On a (2, 2, 1) ("pod", "data", "model") mesh each rank's leaf is the
    FP8 mean over the two ranks of its data coordinate (one a pod), bit for
    bit the exact-scale formula on those two rows."""
    for r in range(4):
        got = runs["worlds"][4][r][-1]
        pod, data = got["coords"]
        assert r == 2 * pod + data
        rows = x[[data, 2 + data]]
        assert np.array_equal(got[name].view(np.uint32), exact_psum(rows).view(np.uint32)), (name, r)
