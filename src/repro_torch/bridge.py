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
the arrays. ``from_jax_params`` / ``load_jax_checkpoint`` give a model
trained in JAX to the port's server (floating arrays as f32 tensors: an
fp16 master converts exactly); ``from_jax_packed`` carries a JAX
``WeightStore.tree`` (FloatSD8 ``PackedTensor`` and FloatSD4
``PackedTensor4`` leaves) into the port's packed tree, codes, biases and
exponents unchanged, so the port serves a store the JAX package packed;
``load_train_state`` continues a JAX
TrainState in the port's trainer, and ``save_checkpoint`` writes the
port's TrainState in that layout, dtypes included, so
``repro.distributed.checkpointing.restore`` reads it.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from .core.loss_scaling import LossScaleState
from .device import resolve_device
from .kernels.dispatch import PackedTensor, PackedTensor4
from .optim.optimizers import AdamState
from .optim.train_state import TrainState

__all__ = [
    "from_jax_params", "from_jax_packed", "load_jax_checkpoint", "to_jax_state",
    "save_checkpoint", "load_train_state",
]


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


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc


def _read_flat(path: str) -> dict:
    """The flat arrays of a checkpoint (a ``step_<n>`` dir, or the dir
    holding them: the newest is taken), checked against the manifest's
    CRC32."""
    d = _step_dir(path)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = os.path.join(d, "arrays.npz")
    want = manifest.get("content_hash")
    if want is not None and _crc32(arrays) != want:
        raise ValueError(f"checkpoint {d}: arrays do not match the manifest's content_hash")
    with np.load(arrays) as data:
        return {k: data[k] for k in manifest["keys"]}


def load_jax_checkpoint(path: str, device=None) -> dict:
    """Read a JAX checkpoint of params or of a TrainState and return the
    port's nested params on ``device``."""
    return from_jax_params(_nest(_read_flat(path)), device)


# ---------------------------------------------------------------------------
# TrainState, both ways
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str, out: dict) -> None:
    """Nested dicts -> ``prefix/key/...`` entries in sorted-key order, and a
    NamedTuple's fields -> ``prefix/.field`` in field order (the keys and
    order of ``jax.tree_util``'s paths)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}/.{name}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = tree.detach().cpu().numpy()


def to_jax_state(state: TrainState) -> dict:
    """The port's TrainState -> the flat arrays of a JAX TrainState
    checkpoint, with its keys and dtypes (fp16 master, f32 momentum)."""
    out = {".step": state.step.detach().cpu().numpy().astype(np.int32)}
    _flatten(state.params, ".params", out)
    _flatten(state.opt_state, ".opt_state", out)
    for name in LossScaleState._fields:
        out[f".scale/.{name}"] = getattr(state.scale, name).detach().cpu().numpy()
    return out


def save_checkpoint(path: str, state: TrainState, step: int) -> str:
    """Write ``<path>/step_<step:08d>/`` (arrays.npz, then manifest.json
    with the arrays' CRC32) in a tmp dir renamed into place: a crashed save
    never shadows a good checkpoint. Returns the final directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    flat = to_jax_state(state)
    arrays = os.path.join(tmp, "arrays.npz")
    np.savez(arrays, **flat)
    manifest = {
        "step": step, "keys": list(flat), "dtypes": [str(v.dtype) for v in flat.values()],
        "shapes": [list(v.shape) for v in flat.values()], "time": time.time(),
        "content_hash": _crc32(arrays), "extra": {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    old = None
    if os.path.exists(final):  # re-saving a step: move the old one aside first
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return final


def load_train_state(path: str, device=None) -> TrainState:
    """Read a TrainState checkpoint written by the JAX package (or by
    ``save_checkpoint``) onto ``device``, every array in its stored dtype,
    so a run continues in the port."""
    dev = resolve_device(device)
    flat = _read_flat(path)

    def sub(prefix: str):
        keys = {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}
        nested = _nest(keys) if keys else {}
        return _to_tensors(nested, dev)

    return TrainState(
        torch.from_numpy(np.asarray(flat[".step"])).to(dev),
        sub(".params"),
        _opt_state(sub(".opt_state")),
        LossScaleState(*(torch.from_numpy(np.asarray(flat[f".scale/.{n}"])).to(dev)
                         for n in LossScaleState._fields)),
    )


def _opt_state(tree):
    """The stored optimizer state -> the optimizer's: nothing (momentum-free
    SGD) -> (), a dict of buffers (SGD momentum) as it is, and the
    ``.mu``/``.nu``/``.count`` fields of Adam's -> an ``AdamState``."""
    if not tree:
        return ()
    if not any(k.startswith(".") for k in tree):
        return tree
    fields = ["." + f for f in AdamState._fields]
    if set(tree) != set(fields):
        raise ValueError(f"unknown optimizer state with fields {sorted(tree)}")
    return AdamState(*(tree[f] for f in fields))


def _to_tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
