"""Bridge between the JAX package's parameters and checkpoints and the
port's, both ways, with numpy alone.

The JAX package's parameters are nested dicts of arrays; its checkpoints
(``repro.distributed.checkpointing``) are ``<dir>/step_<n>/manifest.json``
+ ``arrays.npz`` with flat ``/``-joined keys (``embed/table``,
``lstm0/wx`` ...; a saved TrainState has ``.step``, ``.params/...``,
``.opt_state/...`` and ``.scale/.scale``, ``.scale/.growth_counter``,
``.scale/.dynamic``: a NamedTuple's fields are keyed ``.<field>``, so an
Adam state is ``.opt_state/.mu/...``, ``.opt_state/.nu/...`` and
``.opt_state/.count``), written atomically with a CRC32 ``content_hash`` of
the arrays. The port reads and writes a TrainState in that layout,
either package's, through its own ``distributed/checkpointing.py``
(``save``, and ``restore`` into a template state); ``from_jax_params`` /
``load_jax_checkpoint`` give a model trained in JAX to the port's server
(floating arrays as f32 tensors: an
fp16 master converts exactly); ``from_jax_packed`` carries a JAX
``WeightStore.tree`` (FloatSD8 ``PackedTensor`` and FloatSD4
``PackedTensor4`` leaves) into the port's packed tree, codes, biases and
exponents unchanged, so the port serves a store the JAX package packed.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve_device
from .distributed import checkpointing
from .kernels.dispatch import PackedTensor, PackedTensor4

__all__ = ["from_jax_params", "from_jax_packed", "load_jax_checkpoint"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _nest(flat: Mapping[str, Any]) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}. A leading ``params`` component (a
    saved train state) is stripped, and the state's other entries dropped."""
    parts = {k: k.split("/") for k in flat}
    if any(p[0].lstrip(".") == "params" and len(p) > 1 for p in parts.values()):
        parts = {k: p[1:] for k, p in parts.items() if p[0].lstrip(".") == "params"}
    out: dict = {}
    for k, path in parts.items():
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = flat[k]
    return out


def from_jax_params(params: Mapping[str, Any], device=None) -> dict:
    """Nested JAX params (numpy-convertible leaves), or their flat
    ``/``-joined form, -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    if any(not isinstance(v, Mapping) and "/" in k for k, v in params.items()):
        params = _nest(params)

    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, dev)

    return conv(params)


def from_jax_packed(tree: Mapping[str, Any], device=None) -> dict:
    """A JAX ``WeightStore.tree`` (nested dicts whose packed leaves carry
    ``codes`` and ``bias``, or ``codes``, ``exps`` and ``k``; arrays
    numpy-convertible) -> the port's packed tree on ``device``: codes
    uint8, exponents int8, a FloatSD8 bias as a host int, dense leaves as
    ``from_jax_params`` converts them."""
    dev = resolve_device(device)

    def raw(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "codes") and hasattr(x, "exps"):
            return PackedTensor4(raw(x.codes, np.uint8), raw(x.exps, np.int8), int(x.k))
        if hasattr(x, "codes") and hasattr(x, "bias"):
            return PackedTensor(raw(x.codes, np.uint8), int(np.asarray(x.bias)))
        return _tensor(x, dev)

    return conv(tree)


def load_jax_checkpoint(path: str, device=None) -> dict:
    """Read a JAX checkpoint of params or of a TrainState and return the
    port's nested params on ``device``."""
    return from_jax_params(_nest(checkpointing.read_arrays(path)[0]), device)
