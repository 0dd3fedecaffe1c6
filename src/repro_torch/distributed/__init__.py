"""The training runtime of the port on one device: ``checkpointing``
(atomic, async, keep-N, the JAX package's layout) and ``fault_tolerance``
(restartable loop, preemption, stragglers)."""
