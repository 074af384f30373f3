"""Atomic, async, retention-policied checkpoints in the reference's layout.

Port of ``src/repro/checkpoint/manager.py`` over torch tensors and numpy.
Layout, as the reference writes it: ``<dir>/step_<k>/`` holding one
``leaf_NNNNN.npy`` per leaf plus ``manifest.json`` (key, file, dtype,
shape per leaf), leaves in JAX's flattening order and keys in JAX's
key-path spelling (``[params]/[blocks]/[attn]/[wq]/[core0]``,
``[opt]/.step``).  Writes go to ``step_<k>.tmp`` and are renamed only
after the manifest is fsynced, so a crash mid-save never corrupts the
latest checkpoint; ``save_async`` writes on a worker thread from a host
snapshot taken at the call.

The reference stacks the layers of a model on a leading axis; the port
keeps ``params["blocks"]`` as a list of per-layer dicts.  A list of dicts
is therefore stored stacked, one leaf per key with a leading layer axis,
and split again on restore.  So a checkpoint written by the reference
restores into the port, and one written by the port into the reference.

Across ranks (:class:`RankCheckpointManager`) the state is split (the
AdamW moments of the leaves ``param_shardings`` splits): every rank
gathers it whole, rank 0 writes it in the layout above, and the others
wait at a barrier until the write has landed; on restore every rank reads
the whole checkpoint and keeps its own block.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.tree import is_layer_stack as _is_stack
from repro_torch.tree import is_namedtuple


def _named(tree: Any, path: tuple[str, ...] = ()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` in JAX's order and spelling; a list of dicts gives
    its leaves stacked on a leading axis."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k], path + (f"[{k}]",))]
    if is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _named(v, path + (f".{f}",))]
    if _is_stack(tree):
        per_layer = [_named(t, path) for t in tree]
        keys = [k for k, _ in per_layer[0]]
        if any([k for k, _ in layer] != keys for layer in per_layer):
            raise ValueError(f"{'/'.join(path)}: layers differ in structure")
        return [(key, torch.stack([layer[i][1] for layer in per_layer]))
                for i, key in enumerate(keys)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named(v, path + (f"[{i}]",))]
    key = "/".join(path)
    return [(re.sub(r"[^A-Za-z0-9_./\[\]-]", "_", key) or "leaf", tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(.npy-safe array, true dtype name); bfloat16 travels as uint16."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype_name:
        arr = arr.view(np.dtype(dtype_name))
    return torch.from_numpy(np.array(arr, copy=True))


def _host_snapshot(tree: Any) -> list[tuple[str, np.ndarray, str]]:
    return [(key, *_to_numpy(leaf)) for key, leaf in _named(tree)]


def _write(snapshot, directory: str) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = []
    for i, (key, arr, dtype_name) in enumerate(snapshot):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest.append({"key": key, "file": fname, "dtype": dtype_name,
                         "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def save_tree(tree: Any, directory: str) -> None:
    """Synchronous atomic save of a tree of tensors to ``directory``."""
    _write(_host_snapshot(tree), directory)


def restore_tree(template: Any, directory: str) -> Any:
    """Restore into the structure of ``template``.

    Leaves are matched by position (the reference's rule) and checked
    against the template's keys and shapes; each comes back on its
    template leaf's device, in the dtype the checkpoint holds.
    """
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    want = _named(template)
    if len(manifest) != len(want):
        raise ValueError(
            f"checkpoint has {len(manifest)} leaves, template {len(want)}")
    arrays = []
    for m, (key, leaf) in zip(manifest, want):
        if m["key"] != key or tuple(m["shape"]) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {m['key']} {m['shape']} does not match "
                f"template leaf {key} {list(leaf.shape)}")
        arr = _from_numpy(np.load(os.path.join(directory, m["file"])), m["dtype"])
        arrays.append(arr.to(torch.as_tensor(leaf).device))
    it = iter(arrays)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if _is_stack(t):
            stacked = build(t[0])
            return type(t)(_unstack(stacked, i) for i in range(len(t)))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i].clone()


class CheckpointManager:
    """Step-indexed checkpoints with retention and async save."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        _write(_host_snapshot(tree), self._step_dir(step))
        self._enforce_retention()

    def save_async(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` to host memory now, write it on a thread."""
        self.wait()                                  # one in flight
        snapshot = _host_snapshot(tree)

        def work():
            try:
                _write(snapshot, self._step_dir(step))
                self._enforce_retention()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def wait(self, timeout: float = 600.0) -> None:
        """Join the write in flight; raise what it raised, or on timeout."""
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise TimeoutError(
                    f"checkpoint write still running after {timeout} s")
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template: Any,
                step: Optional[int] = None) -> tuple[int, Any]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step, restore_tree(template, self._step_dir(step))

    def _enforce_retention(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


class RankCheckpointManager(CheckpointManager):
    """Checkpoints of a state split over the ranks of a process group.

    ``whole(tree)`` gathers the whole state from every rank's part (a
    collective: every rank calls it), ``whole_like(tree)`` makes a template
    of the whole state's shapes without one, ``local(tree)`` takes this
    rank's part of a whole state.  Rank 0 writes; every save ends at a
    barrier, so a save is synchronous here (``save_async`` too): no rank
    goes on before the checkpoint has landed.
    """

    def __init__(self, directory: str, keep: int = 3, *, rank: int,
                 whole: Callable[[Any], Any], whole_like: Callable[[Any], Any],
                 local: Callable[[Any], Any],
                 barrier: Callable[[], None]):
        super().__init__(directory, keep)
        self.rank = rank
        self._whole, self._whole_like, self._local = whole, whole_like, local
        self._barrier = barrier

    def save(self, step: int, tree: Any) -> None:
        whole = self._whole(tree)
        if self.rank == 0:
            super().save(step, whole)
        self._barrier()

    def save_async(self, step: int, tree: Any) -> None:
        self.save(step, tree)

    def restore(self, template: Any,
                step: Optional[int] = None) -> tuple[int, Any]:
        step, whole = super().restore(self._whole_like(template), step)
        return step, self._local(whole)
