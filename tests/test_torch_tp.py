"""Tensor parallelism over "model" for the dense family, on the CPU: gloo
worlds of 2 and 4 ranks on ("data", "model") meshes of (1, 2) and (2, 2)
(``tests/torch_tp_world.py``: the worlds start once for the module and
run at once), against the JAX package's unsharded model and the port's
unsharded step.

Reduced dense configs (2 layers, d_model 128, head_dim 32, vocab 512)
under the dry run's policy floatsd8_tpu (FloatSD8 weights, FP8
activations, bf16 compute), and for the comparison with the JAX package
under floatsd8_table6 (f32 compute) with FloatSD8 weights and no
activation quantizer (as ``tests/test_torch_whisper.py`` and
``test_torch_vlm.py`` compare forwards: the JAX package's bf16 products
round otherwise than the port's on the CPU, unsharded too, 0.5% of the
loss, and one FP8 activation flip moves every later row of the reduced
granite, unsharded too), cover the three ways the heads split over a
"model" axis of 2:
  * whole heads: ``stablelm_3b`` (4:4 heads, layernorm, biased q/k/v) and
    ``h2o_danube3_4b`` with 2 KV heads (4:2, rmsnorm, SwiGLU);
  * heads split mid-head: ``phi4_mini_3p8b`` with 3:3 heads (96 q and 96
    kv columns, 48 a rank: each rank gathers q, k and v and attends with
    the two heads its columns cover);
  * MQA: ``granite_20b`` (4:1, GELU): the one KV head of 32 columns split
    16 a rank and gathered whole.

Tolerances (measured on the CPU):
  * the global loss and the gathered prefill logits against the JAX
    package's unsharded ``model.loss`` / ``prefill`` on the global batch
    (FloatSD8 weights, f32 activations): the loss within 1e-5 relative and
    the logits within 1e-4 of the logit scale except at most 0.5% of the
    elements, 1e-3 everywhere (``tests/test_torch_dense.py``'s rule);
  * the same against the port's unsharded loss and logits: measured equal
    (the row-parallel partial products are summed in f32 before the cast to
    bf16, which absorbs the order of the sum here); asserted within the
    bounds above;
  * one SGD step's masters against the port's unsharded step: per leaf
    within 15% relative L2 of the step's change (the FP8 gradient sweep
    rounds to 2 mantissa bits: a partial sum one f32 ulp apart moves an
    element by a quarter; measured at most 10.7%), and the loss of the step
    within 1e-5 relative;
  * a column-parallel ``QuantDense`` bit for bit the whole site's columns
    (measured so on the CPU GEMM under fp32 and floatsd8_tpu); a
    row-parallel one, whose f32 partial products are summed over "model"
    in another order, within 1e-5 of |x| @ |W| before any cast (measured
    1.5e-7 under fp32 at 4 ranks; bit for bit after floatsd8_tpu's bf16
    cast here);
  * a piece's FloatSD8 quantization bit for bit the whole weight's piece
    (the bias of the whole tensor, max|w| reduced over "model"); the clip
    norm's sum of squares within 1e-6 relative of the whole tree's, a whole
    leaf counted once;
  * at a "model" axis of one (a world of one rank) every tensor-parallel
    branch is off: Adam steps with shardings bit for bit the unsharded
    steps, with the distributed runtime's collectives (one all-gather an
    axis of each leaf's spec, two a weight site's dW, one all-reduce).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_world as world  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.models.lm import CausalLM as JLM  # noqa: E402
from test_torch_dense import assert_close, np_params  # noqa: E402

POLICY = "floatsd8_tpu"
JAX_POLICY = "floatsd8_table6"
#: the JAX comparison's policy: FloatSD8 weights, no activation quantizer
NO_ACT = {"act_fwd": "none", "act_bwd": "none", "first_layer_act": "none", "last_layer_act": "none"}
CASES = {
    "whole": ("stablelm_3b", {}),
    "whole-gqa": ("h2o_danube3_4b", {"kv_heads": 2}),
    "split": ("phi4_mini_3p8b", {"n_heads": 3, "kv_heads": 3}),
    "mqa": ("granite_20b", {}),
}
SHAPES = ((1, 2), (2, 2))
B, S, V = 4, 16, 512
LOSS_RTOL = 1e-5
STEP_L2 = 0.15


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    np.savez(tmp / "batch.npz", **batch)
    jax_out, params, jobs = {}, {}, {2: [], 4: [], 1: []}
    pol = jget_policy(JAX_POLICY, **NO_ACT)
    for name, (arch, over) in CASES.items():
        cfg = dataclasses.replace(jget_config(arch).reduced(), **over)
        p = np_params(cfg)
        params[name] = _flat(p)
        np.savez(tmp / f"{name}.npz", **params[name])
        m = JLM(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss = float(jax.jit(lambda p, b: m.loss(p, b, pol))(p, jb))
        logits = np.asarray(jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol))(p, jb["tokens"]), np.float32)
        jax_out[name] = (loss, logits)
        for shape in SHAPES:
            for policy in (POLICY, JAX_POLICY):
                jobs[shape[0] * shape[1]].append(("tp_run", dict(
                    arch=arch, over=over, params_path=str(tmp / f"{name}.npz"),
                    batch_path=str(tmp / "batch.npz"), shape=shape, policy=policy,
                    policy_over=NO_ACT if policy == JAX_POLICY else None)))
    jobs[2].append(("tp_pieces", {}))
    jobs[4].append(("tp_pieces", {}))
    arch, over = CASES["whole-gqa"]
    jobs[1].append(("tp_world1", dict(arch=arch, over=over, params_path=str(tmp / "whole-gqa.npz"),
                                      batch_path=str(tmp / "batch.npz"), policy=POLICY)))
    out = world.run_worlds(jobs, tmp)
    return {"worlds": out, "jax": jax_out, "params": params}


def _got(runs, name, shape, policy=POLICY, rank=0):
    """A world's ``tp_run`` result for the case, mesh shape and policy."""
    return runs["worlds"][shape[0] * shape[1]][rank][2 * list(CASES).index(name) + (policy != POLICY)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loss_and_logits_match_the_jax_unsharded_model(runs, name, shape):
    got = _got(runs, name, shape, JAX_POLICY)
    loss, logits = runs["jax"][name]
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (got["loss"], loss)
    assert_close(got["logits"], logits, f"{name} {shape} logits")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loss_and_logits_match_the_ports_unsharded_model(runs, name, shape):
    got = _got(runs, name, shape)
    assert abs(got["loss"] - got["loss_whole"]) <= LOSS_RTOL * abs(got["loss_whole"])
    assert_close(got["logits"], got["logits_whole"], f"{name} {shape} logits")
    # every rank holds the same global values
    for r in range(1, shape[0] * shape[1]):
        other = _got(runs, name, shape, rank=r)
        assert other["loss"] == got["loss"] and np.array_equal(other["logits"], got["logits"])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CASES))
def test_one_sharded_step_matches_the_unsharded_step(runs, name, shape):
    got = _got(runs, name, shape)
    assert got["finite"]
    assert abs(got["step_loss"] - got["step_loss_whole"]) <= LOSS_RTOL * abs(got["step_loss_whole"])
    init = runs["params"][name]
    for k, w in got["masters_whole"].items():
        w32 = w.astype(np.float32)
        change = np.linalg.norm(w32 - init[k].astype(np.float32))
        gap = np.linalg.norm(got["masters"][k].astype(np.float32) - w32)
        assert gap <= STEP_L2 * change, (k, gap / change)
    assert got["collectives"]["all_reduce"] > 1  # the tensor-parallel sums ran


def test_the_pieces_are_stored_by_the_specs(runs):
    split = _got(runs, "split", SHAPES[0])["pieces"]
    assert split["stack/b0/mixer/wq/w"] == (2, 128, 48)  # 96 columns over 2: mid-head
    assert split["stack/b0/mixer/wo/w"] == (2, 48, 128)
    assert split["embed/table"] == (256, 128)
    mqa = _got(runs, "mqa", SHAPES[0])["pieces"]
    assert mqa["stack/b0/mixer/wk/w"] == (2, 128, 16) and mqa["stack/b0/mlp/wi/w"] == (2, 128, 128)
    assert "stack/b0/mlp/wg/w" not in mqa  # GELU


@pytest.mark.parametrize("n", (2, 4))
def test_a_piece_quantizes_at_the_whole_weights_bias_and_the_clip_norm_counts_a_whole_leaf_once(runs, n):
    for rank, got in enumerate(runs["worlds"][n]):
        p = got[-1]
        assert p["cols"] and p["rows"], rank
        assert abs(p["square_sum"] - p["want"]) <= 1e-6 * p["want"]
        assert abs(p["square_sum"] - p["twice_whole"]) > 1e-3 * p["want"]
    assert runs["worlds"][n][0][-1]["local_max"] < 40.0  # rank 0's columns miss the largest |w|


@pytest.mark.parametrize("n", (2, 4))
def test_a_column_piece_is_the_whole_sites_columns_and_a_row_piece_sums_within_its_bound(runs, n):
    for rank, got in enumerate(runs["worlds"][n]):
        for policy, site in got[-1]["sites"].items():
            assert site["col_equal"], (rank, policy)
            assert site["row_err"] <= 1e-5, (rank, policy, site["row_err"])


def test_a_model_axis_of_one_is_the_unsharded_step_bit_for_bit(runs):
    got = runs["worlds"][1][0][0]
    assert got["mlosses"] == got["losses"] and got["same"]
    sites = 2 * 7 + 1  # 7 weight sites a layer and the tied head
    assert got["collectives"] == {"all_gather": got["axes"] + 2 * sites, "all_reduce": 1}
