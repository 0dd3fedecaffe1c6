"""Checkpointing: atomic, async, keep-N; counterpart of
``repro.distributed.checkpointing`` in its layout, so either package reads
the other's checkpoints.

Layout: ``<dir>/step_<n:08d>/manifest.json + arrays.npz``. The npz holds
the tree's leaves under flat ``/``-joined keys, in the order and with the
names of ``jax.tree_util``'s paths: a dict's keys sorted, a NamedTuple's
fields as ``.<field>`` in field order, a tuple's items by index (a
TrainState is ``.step``, ``.params/...``, ``.opt_state/...``,
``.scale/.scale`` ...). The manifest records the keys, dtypes, shapes and a
CRC32 ``content_hash`` of the npz.

Torn-write safety, as the reference's (``--resume auto`` depends on it):
the arrays are written and fsync'd, then the manifest, inside a ``.tmp``
dir that one ``os.rename`` publishes (a re-saved step's old dir is moved
aside first and removed after); ``latest_step`` ignores ``.tmp``, ``.old``
and manifest-less dirs; ``restore`` checks the content hash. A kill at any
byte of a save leaves the previous checkpoint the newest valid one.

A checkpoint holds every leaf whole. ``restore(shardings=)`` cuts each
rank's piece out of it (``sharding.NamedSharding.shard``) onto the
template leaf's device: the reference's elastic reshard, so a state
written at one world size (or by the JAX package) restores at another.
On a mesh, ``fault_tolerance.RestartableLoop`` gathers the pieces and the
first rank alone writes. The ``ckpt_torn_write`` fault point
(``faults.py``) fires between the arrays and the manifest, as the
reference's does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch

from ..faults import CKPT_TORN_WRITE, FAULTS, InjectedFault

__all__ = ["save", "restore", "latest_step", "read_arrays", "flatten", "CheckpointManager",
           "CheckpointCorrupt"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


class CheckpointCorrupt(RuntimeError, ValueError):
    """The stored arrays do not match the manifest's content hash (a
    RuntimeError, as the reference's; a ValueError, as the port's reader
    raised before)."""


def _fsync_file(p: str) -> None:
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _content_hash(npz_path: str) -> int:
    crc = 0
    with open(npz_path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc


def _map_keyed(fn: Callable, tree: Any, key: str = "", sort: bool = False) -> Any:
    """``fn(key, leaf)`` over every leaf, keeping the structure (a dict's
    keys in their order, or visited sorted with ``sort``, as
    ``jax.tree_util`` flattens them); keys as its paths name them. The
    order of a restored dict is the template's: the train step sums its
    gradient norm over the leaves in that order."""
    def sub(name):
        return f"{key}/{name}" if key else str(name)

    if isinstance(tree, Mapping):
        keys = sorted(tree) if sort else list(tree)
        return {k: _map_keyed(fn, tree[k], sub(k), sort) for k in keys}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_keyed(fn, getattr(tree, f), sub("." + f), sort) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_keyed(fn, v, sub(i), sort) for i, v in enumerate(tree))
    return fn(key, tree)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def flatten(tree: Any) -> dict:
    """A tree of tensors (or arrays) -> ``{key: numpy array}`` in the
    checkpoint's key order, each leaf copied to the host in its dtype."""
    out: dict = {}
    _map_keyed(lambda k, v: out.__setitem__(k, _host(v)), tree, sort=True)
    return out


def save(path: str, tree: Any, step: int, *, extra: dict | None = None) -> str:
    """Atomic synchronous save of ``tree`` as step ``step``. Returns the
    final directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = flatten(tree)
    arrays_path = os.path.join(tmp, _ARRAYS)
    np.savez(arrays_path, **flat)
    _fsync_file(arrays_path)
    if FAULTS.enabled and FAULTS.fire(CKPT_TORN_WRITE) is not None:
        # die between the arrays and the manifest: the tmp dir is left torn
        # and unpublished, and latest_step must keep ignoring it
        raise InjectedFault("torn checkpoint write (injected)")
    manifest = {
        "step": step, "keys": list(flat), "dtypes": [str(v.dtype) for v in flat.values()],
        "shapes": [list(v.shape) for v in flat.values()], "time": time.time(),
        "content_hash": _content_hash(arrays_path), "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # publish by renaming onto a name that does not exist: a re-saved
    # step's old dir is moved aside first, so a complete dir always holds
    # this step's name
    old = None
    if os.path.exists(final):
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return final


def _steps(path: str, need_manifest: bool) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith((".tmp", ".old"))
        and (not need_manifest or os.path.exists(os.path.join(path, d, _MANIFEST)))
    )


def latest_step(path: str) -> int | None:
    """The newest published step under ``path`` (None if there is none)."""
    steps = _steps(path, need_manifest=True)
    return steps[-1] if steps else None


def _step_dir(path: str, step: int | None) -> str:
    """``path`` itself if it is a step dir, else its ``step`` (default the
    newest) dir."""
    if step is None and os.path.exists(os.path.join(path, _MANIFEST)):
        return path
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    return os.path.join(path, f"step_{step:08d}")


def read_arrays(path: str, step: int | None = None) -> tuple[dict, int]:
    """The flat arrays of a checkpoint (``path`` a step dir, or the dir
    holding them: ``step``, default the newest) and its step, checked
    against the manifest's CRC32; raises ``CheckpointCorrupt`` on a
    mismatch."""
    d = _step_dir(path, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    arrays = os.path.join(d, _ARRAYS)
    want = manifest.get("content_hash")
    if want is not None and _content_hash(arrays) != want:
        raise CheckpointCorrupt(f"checkpoint {d}: arrays do not match the manifest's content_hash "
                                f"(bit rot or a torn copy); restore an earlier step")
    with np.load(arrays) as data:
        return {k: data[k] for k in manifest["keys"]}, int(manifest["step"])


def restore(path: str, target: Any, step: int | None = None,
            shardings: Any | None = None) -> tuple[Any, int]:
    """Load step ``step`` (default the newest) into the structure of
    ``target``: every leaf in its stored dtype, on the device of the
    template's leaf. ``shardings`` (a ``NamedSharding`` tree shaped as
    ``target``): each leaf is this rank's piece of the stored array.
    Returns (tree, step)."""
    flat, step = read_arrays(path, step)
    keyed = {}
    if shardings is not None:
        _map_keyed(keyed.__setitem__, shardings)

    def leaf(key, v):
        if key not in flat:
            raise KeyError(f"checkpoint under {path} has no array {key!r}")
        t = torch.from_numpy(np.array(flat[key]))  # a copy, 0-d kept 0-d
        if key in keyed:
            t = keyed[key].shard(t)
            if isinstance(v, torch.Tensor) and t.shape != v.shape:
                raise ValueError(f"checkpoint array {key!r}: this rank's piece {tuple(t.shape)} "
                                 f"is not the template's {tuple(v.shape)}")
        return t.to(v.device) if isinstance(v, torch.Tensor) else t

    return _map_keyed(leaf, target), step


class CheckpointManager:
    """Async keep-N manager: ``save`` copies the tree to the host at once
    (the only wait on the device) and writes it on a worker thread, so the
    write overlaps the next steps; ``wait`` joins it and raises what the
    write raised. Keeps the newest ``keep`` steps."""

    def __init__(self, path: str, keep: int = 3, async_write: bool = True):
        self.path = path
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(path, exist_ok=True)

    def save(self, tree: Any, step: int, extra: dict | None = None) -> None:
        host = _map_keyed(lambda _, v: _host(v), tree)
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(host, step, extra), daemon=True)
            self._thread.start()
        else:
            self._write(host, step, extra)

    def _write(self, host, step, extra) -> None:
        try:
            save(self.path, host, step, extra=extra)
            self._gc()
        except Exception as e:  # a failed write is raised by the next wait()
            if not self.async_write:
                raise
            self._error = e

    def _gc(self) -> None:
        steps = _steps(self.path, need_manifest=False)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, target: Any, step: int | None = None,
                shardings: Any | None = None) -> tuple[Any, int]:
        self.wait()
        return restore(self.path, target, step, shardings)

    def latest_step(self) -> int | None:
        self.wait()
        return latest_step(self.path)
