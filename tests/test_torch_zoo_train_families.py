"""The zoo's training on the CPU against the JAX package: the moe
(``dbrx_132b``: grouped capacity routing, the FP8 dispatch buffer, the
load-balancing loss), vlm (``qwen2_vl_2b`` with its 16 stub patches: the
attention's causal prefix) and audio (``whisper_large_v3`` with its
``frames``: encoder, cross-attention) families' reduced configs, one train
step each under ``fp32`` and ``floatsd8_table6``. The parameters, batches,
what is compared and every tolerance: ``tests/zoo_train_parity.py``.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import zoo_train_parity as Z  # noqa: E402

(test_loss_matches_the_reference, test_every_leaf_gradient_matches_the_reference,
 test_one_train_step_matches_the_reference) = Z.parity_tests(("dbrx_132b", "qwen2_vl_2b", "whisper_large_v3"))
