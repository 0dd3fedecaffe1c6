"""Weight bridge: parameters of the JAX package -> the port's parameters.

The JAX package's parameters are nested dicts of arrays; its checkpoints
(``repro.distributed.checkpointing``) are ``<dir>/step_<n>/manifest.json``
+ ``arrays.npz`` with flat ``/``-joined keys (``embed/table``,
``lstm0/wx`` ...). Both read here with numpy alone, so a model trained in
JAX is served by the port. Floating arrays become f32 tensors (an fp16
master copy converts exactly).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve_device

__all__ = ["from_jax_params", "load_jax_checkpoint"]


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


def _step_dir(path: str) -> str:
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    steps = sorted(
        d for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith((".tmp", ".old"))
        and os.path.exists(os.path.join(path, d, "manifest.json"))
    )
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return os.path.join(path, steps[-1])


def load_jax_checkpoint(path: str, device=None) -> dict:
    """Read a JAX checkpoint (a ``step_<n>`` dir, or the dir holding them:
    the newest is taken) and return the port's nested params on ``device``.
    The arrays are checked against the manifest's CRC32."""
    d = _step_dir(path)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = os.path.join(d, "arrays.npz")
    want = manifest.get("content_hash")
    if want is not None:
        crc = 0
        with open(arrays, "rb") as f:
            while chunk := f.read(1 << 20):
                crc = zlib.crc32(chunk, crc)
        if crc != want:
            raise ValueError(f"checkpoint {d}: arrays do not match the manifest's content_hash")
    with np.load(arrays) as data:
        flat = {k: data[k] for k in manifest["keys"]}
    return from_jax_params(_nest(flat), device)
