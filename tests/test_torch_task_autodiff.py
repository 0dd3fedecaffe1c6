"""The autodiff paths of the port's task models against the JAX
package's, on the CPU: 5 Adam steps of the FP32 baseline (every task) and
of floatsd8_table2 with ``fused=False`` (SNLI's BiLSTM and max-pool,
Multi30K's encoder-to-decoder state), from one JAX init. Tolerances and
their reasons: ``test_torch_task_train.py``, whose helpers run both
packages (losses within 1e-3 relative at every step, every trained master
leaf within 1e-3 of JAX's change to it)."""
import pytest

pytest.importorskip("torch")

from test_torch_task_train import _held_to_jax  # noqa: E402

from repro_torch.kernels import dispatch as tkd  # noqa: E402


@pytest.mark.parametrize("task,path", [("udpos", "fp32"), ("snli", "fp32"), ("multi30k", "fp32"),
                                       ("snli", "table2-autodiff"), ("multi30k", "table2-autodiff")])
def test_autodiff_trajectory_matches_jax(task, path):
    """No engine and no dispatched op: every LSTM runs autodiff through
    the per-step cell, as the reference's unfused path does."""
    _held_to_jax(task, path)
    assert tkd.STATS.snapshot() == {}
