"""The MoE's routing groups on a device mesh, against the JAX package.

The reference routes an MoE layer's tokens in ``_groups()`` groups: the
active mesh's pod x data size, or ``dispatch_groups`` (16) with no mesh;
its training CLI always trains under a mesh, so on one device it routes
one group a step. The port's training CLI trains under its own mesh
(``launch.train.make_mesh_for_host``), where each rank routes its rows of
the global batch as one group: the reference's pod x data groups.

Setup: ``dbrx_132b`` reduced, the CLI's model and first batch for
``--arch dbrx_132b --batch 4 --seq 64`` (``synthetic.wikitext2``, seed 0),
``tests/zoo_train_parity.py``'s seed-0 numpy parameters in both packages,
floatsd8_table6. The port runs on gloo worlds of 1, 2 and 4 CPU ranks
(``tests/torch_mesh_world.py``, started once for the module), each rank on
its rows, the loss the ranks' shares summed. The reference runs its
``model.loss`` on the whole batch: at world 1 under
``use_mesh(make_host_mesh((1, 1)))`` (an ``Auto`` mesh of one CPU device),
at n ranks with its ``_moe()`` replaced by ``dataclasses.replace(moe,
dispatch_groups=n)`` and no mesh (``_groups()`` reads only the mesh's
pod x data size, so that is the reference's n-device routing).

Tolerance: the loss within 2e-6 relative (``tests/zoo_train_parity.py``'s
loss bound; measured 7.6e-8 to 1.5e-7), where the reference's own losses
at 1, 2 and 4 groups differ by more than 1e-5 relative, and the port's
loss with no mesh (16 groups) stands 2.2e-4 from the reference's
one-device loss.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_world as world  # noqa: E402
import zoo_train_parity as Z  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch.mesh import make_host_mesh as jmake_host_mesh  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

ARCH, BATCH, SEQ = "dbrx_132b", 4, 64
WORLDS = (1, 2, 4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _jax_loss(params, batch, groups=None):
    """The reference's loss of the whole batch: under its one-device mesh
    (``groups=None``), or with ``dispatch_groups=groups`` and no mesh."""
    model = jbuild(jget_config(ARCH).reduced())
    pol = jget_policy(Z.POLICIES[1])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    if groups is None:
        with jshd.use_mesh(jmake_host_mesh((1, 1))):
            return float(jax.jit(model.loss, static_argnums=2)(jp, jb, pol))
    orig = jlm.CausalLM._moe
    jlm.CausalLM._moe = lambda self: dataclasses.replace(orig(self), dispatch_groups=groups)
    try:
        return float(jax.jit(model.loss, static_argnums=2)(jp, jb, pol))
    finally:
        jlm.CausalLM._moe = orig


@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    params = Z.np_params(ARCH)
    np.savez(tmp / "params.npz", **_flat(params))
    job = [("moe_loss", {"arch": ARCH, "batch": BATCH, "seq": SEQ, "params_path": str(tmp / "params.npz")})]
    port = world.run_worlds({n: job for n in WORLDS}, tmp)
    batch = next(jsyn.wikitext2(batch=BATCH, seq=SEQ, vocab=jget_config(ARCH).reduced().vocab).batches)
    ref = {1: _jax_loss(params, batch), **{n: _jax_loss(params, batch, n) for n in (2, 4)}}
    return port, ref


def test_the_reference_routes_by_its_mesh(losses):
    _, ref = losses
    assert abs(ref[1] - ref[2]) > 1e-5 * abs(ref[1]) and abs(ref[2] - ref[4]) > 1e-5 * abs(ref[2])


@pytest.mark.parametrize("n", WORLDS)
def test_the_cli_loss_on_the_mesh_matches_the_reference(losses, n):
    port, ref = losses
    got = port[n][0][0]["loss"]
    assert abs(got - ref[n]) <= 2e-6 * abs(ref[n]), (got, ref[n])


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_routes_its_rows_as_one_group(losses, n):
    port, _ = losses
    cfg = jget_config(ARCH).reduced()
    for r in range(n):
        res = port[n][r][0]
        assert res["loss"] == port[n][0][0]["loss"]
        # one Route per MoE layer, each of one group
        assert res["groups"] == [1] * (cfg.n_layers - cfg.first_k_dense), (n, r)


def test_without_a_mesh_the_port_routes_its_dispatch_groups(losses, tmp_path):
    """The same loss in this process with no mesh: 16 groups, well away
    from the reference's one-device loss."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.data import synthetic
    from repro_torch.models import build
    from repro_torch.nn.moe import record_routes
    from repro_torch.optim.train_state import batch_to_device

    _, ref = losses
    model = build(get_config(ARCH).reduced())
    params = bridge.from_jax_params(_flat(Z.np_params(ARCH)), "cpu")
    batch = batch_to_device(next(synthetic.wikitext2(batch=BATCH, seq=SEQ, vocab=model.cfg.vocab).batches), "cpu")
    with torch.no_grad(), record_routes() as routes:
        loss = float(model.loss(params, batch, get_policy(Z.POLICIES[1])))
    assert {int(r.expert_idx.shape[0]) for r in routes} == {16}
    assert abs(loss - ref[1]) > 1e-5 * abs(ref[1])
