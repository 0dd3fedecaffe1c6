"""The training runtime of the port: ``sharding`` (logical-axis rules, the
device mesh, the counted collectives), ``checkpointing`` (atomic, async,
keep-N, the JAX package's layout, elastic restore) and ``fault_tolerance``
(restartable loop, preemption, stragglers)."""
