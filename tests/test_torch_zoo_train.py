"""The zoo's training on the CPU against the JAX package: the dense
(``h2o_danube3_4b``) and ssm (``rwkv6_3b``) families' reduced configs, one
train step each under ``fp32`` and ``floatsd8_table6``
(``tests/zoo_train_parity.py``: the parameters, batches, what is compared
and every tolerance; the other families are in
``test_torch_zoo_train_families.py`` and ``test_torch_zoo_train_hybrid.py``),
a 3-step ``fp32`` loss trajectory of the dense family, and the training
CLI's ``--arch``.

  * ``rwkv6_3b`` under floatsd8_table6: the loss-scaled gradient of the
    time mix's bonus ``u`` overflows its fp16 master (above 65504) in both
    packages, so both skip the step (grads_finite False), and the masters
    stay as they were;
  * the trajectory: 3 steps of Adam on three batches, each step's loss
    within 5e-5 relative of the reference's (measured 1.0e-5 at step 3:
    Adam's first update moves an element whose gradient is rounding noise,
    a key bias's, by lr times the noise's sign, in either direction);
  * the CLI: ``--arch h2o_danube3_4b --device cpu --steps 3 --batch 2
    --seq 16`` trains from the port's seeded init on
    ``synthetic.wikitext2(2, 16, 512)``; the JAX package's
    ``make_train_step`` from the same masters over the same batches gives
    each loss within 5e-5 relative (the default floatsd8_table6 policy);
    ``--arch whisper_large_v3`` exits 1 with its message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import zoo_train_parity as Z  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build  # noqa: E402

ARCHS = ("h2o_danube3_4b", "rwkv6_3b")
TRAJ_RTOL = 5e-5

(test_loss_matches_the_reference, test_every_leaf_gradient_matches_the_reference,
 test_one_train_step_matches_the_reference) = Z.parity_tests(ARCHS)


def _jax_trajectory(arch, policy, params, batches):
    """The JAX package's make_train_step from ``params`` over ``batches``:
    each step's loss."""
    model = Z.jbuild(Z.jget_config(arch).reduced())
    pol, opt = Z.jget_policy(policy), Z.jadam()
    step = jax.jit(Z.jmake_train_step(model.loss, opt, pol, lr=1e-3))
    state = Z.jinit_state(jax.tree_util.tree_map(jnp.asarray, params), opt, pol)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses


def test_dense_fp32_loss_trajectory_matches_the_reference():
    arch = "h2o_danube3_4b"
    params = Z.np_params(arch)
    batches = [Z.np_batch(arch, seed) for seed in range(3)]
    want = _jax_trajectory(arch, "fp32", params, batches)
    model, pol, opt = build(get_config(arch).reduced()), Z.get_policy("fp32"), Z.adam()
    step = Z.make_train_step(model.loss, opt, pol, lr=1e-3)
    state = Z.init_state(Z.bridge.from_jax_params(params, "cpu"), opt, pol)
    got = []
    for b in batches:
        state, m = step(state, Z.torch_batch(b))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]


def test_cli_arch_trains_the_reduced_config_as_the_reference(capsys):
    arch = "h2o_danube3_4b"
    kd.STATS.reset()
    out = ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                       "--log-every", "1", "--no-telemetry"])
    text = capsys.readouterr().out
    assert f"model: {arch} CausalLM (family dense, n_layers 2, d_model 128" in text and "batch tokens 2 x 16" in text
    assert "trained 3 steps" in text and "dispatch: flash_attention/ref=12" in text  # 2 layers x 3 steps, + remat
    cfg = get_config(arch).reduced()
    init = build(cfg).init(torch.Generator(device="cpu").manual_seed(0))
    params = jax.tree_util.tree_map(lambda t: t.numpy(), init)
    data = jsynthetic.wikitext2(batch=2, seq=16, vocab=cfg.vocab)
    batches = [next(data.batches) for _ in range(3)]
    want = _jax_trajectory(arch, "floatsd8_table6", params, batches)
    np.testing.assert_allclose(out["losses"], want, rtol=TRAJ_RTOL)
    assert out["finite"] == [True] * 3


def test_cli_arch_audio_exits_with_its_message():
    with pytest.raises(SystemExit, match="family 'audio'.*frames"):
        ttrain.main(["--arch", "whisper_large_v3", "--device", "cpu", "--steps", "1"])
