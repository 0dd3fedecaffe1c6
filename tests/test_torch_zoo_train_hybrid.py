"""The zoo's training on the CPU against the JAX package: the hybrid
family (``jamba_v01_52b``'s reduced config: one period of 8 sub-layers,
Mamba mixers with attention at sub-layer 3, an MoE MLP on every second),
one train step under ``fp32`` and ``floatsd8_table6``. The parameters,
batches, what is compared and every tolerance:
``tests/zoo_train_parity.py``. The reference's jitted loss and gradient
of this config take most of the file's time (about 16 s under fp32 and 29
s under floatsd8_table6 to compile on the CPU).
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import zoo_train_parity as Z  # noqa: E402

(test_loss_matches_the_reference, test_every_leaf_gradient_matches_the_reference,
 test_one_train_step_matches_the_reference) = Z.parity_tests(("jamba_v01_52b",))
