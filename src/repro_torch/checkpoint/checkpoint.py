"""Tree checkpointing on npz, the counterpart of ``repro.checkpoint``: flatten
a nested dict/list/tuple tree of torch tensors or numpy arrays with
'/'-joined key paths, save atomically, restore into a target tree.

The on-disk format is the reference's, so each package restores the
other's files: ``ckpt_{step:08d}.npz`` holds one array per leaf, keyed by
its path in ``jax.tree_util``'s order (dict keys sorted, list and tuple
indices as ``str``; a None holds no leaf), and ``__meta__``, a JSON object
with the caller's metadata, ``step`` and ``__dtypes__``. A leaf of a dtype
numpy lacks (bfloat16, the float8 types) is stored as a uint16 or uint8
view of its bits and named in ``__dtypes__``; the port makes and reads
those views through torch, with no ``ml_dtypes``.

The FL path saves W_G as ``models.wrn.params_to_jax(params)`` (the
reference's tree, HWIO convs) and loads it back through
``params_from_jax``, so a W_G written by either package loads in the
other.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Tree = Any
_SEP = "/"
_FILE = re.compile(r"ckpt_(\d+)\.npz$")


def _leaves(tree: Tree, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util``'s flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (str(i),))
    elif tree is not None:
        yield _SEP.join(path), tree


def _bits_dtype(itemsize: int):
    """(numpy, torch) integer dtypes of a foreign dtype's stored bits."""
    return (np.uint16, torch.int16) if itemsize == 2 else (np.uint8,
                                                           torch.uint8)


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf -> (npz-safe array, the name of a dtype numpy lacks)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            return t.numpy(), None
        except TypeError:                   # bfloat16, float8: no numpy dtype
            np_bits, t_bits = _bits_dtype(t.element_size())
            return (t.view(t_bits).numpy().view(np_bits),
                    str(t.dtype).removeprefix("torch."))
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:
        return arr.view(_bits_dtype(arr.dtype.itemsize)[0]), arr.dtype.name
    return arr, None


def _flatten(tree: Tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        flat[key], name = _to_numpy(leaf)
        if name is not None:
            dtypes[key] = name
    return flat, dtypes


def save_checkpoint(directory: str, step: int, tree: Tree,
                    metadata: Optional[dict] = None) -> str:
    """Atomic save: write to a temporary file, then rename. Returns the
    checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    flat, dtypes = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    meta = dict(metadata or {}, step=step, __dtypes__=dtypes)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _steps(directory: str):
    return [int(m.group(1)) for f in os.listdir(directory)
            if (m := _FILE.match(f))]


def latest_step(directory: str) -> Optional[int]:
    """The highest step checkpointed in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _as_torch(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name is None:
        return torch.from_numpy(arr)
    _, t_bits = _bits_dtype(arr.dtype.itemsize)
    return torch.from_numpy(arr).view(t_bits).view(getattr(torch, name))


def _restore_leaf(key: str, leaf, arr: np.ndarray, name: Optional[str]):
    """The stored ``arr`` as ``leaf``'s kind: a tensor on the target's
    device and in its dtype, else a numpy array in the target's dtype."""
    if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                         f"{tuple(leaf.shape)}")
    if isinstance(leaf, torch.Tensor):
        return _as_torch(arr, name).to(device=leaf.device, dtype=leaf.dtype)
    if name is not None:
        if getattr(leaf, "dtype", None) is not None \
                and np.dtype(leaf.dtype).name == name:
            return arr.view(leaf.dtype)     # the caller's own such dtype
        arr = _as_torch(arr, name).float().numpy()
    if hasattr(leaf, "dtype") and arr.dtype != leaf.dtype:
        arr = arr.astype(leaf.dtype)
    return arr


def restore_checkpoint(directory: str, target: Tree,
                       step: Optional[int] = None) -> tuple:
    """Restore into ``target``'s structure (the latest step by default).
    Returns (tree, metadata). A leaf the file lacks is a ``KeyError``, a
    shape that differs a ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    dtypes = meta.pop("__dtypes__", {})

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _restore_leaf(key, node, flat[key], dtypes.get(key))

    return rebuild(target, ()), meta


class CheckpointManager:
    """Keeps the last ``max_to_keep`` checkpoints in a directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep

    def save(self, step: int, tree: Tree, metadata: Optional[dict] = None):
        """Save ``tree`` at ``step``, then drop all but the newest
        ``max_to_keep`` checkpoints. Returns the new file's path."""
        path = save_checkpoint(self.directory, step, tree, metadata)
        for s in sorted(_steps(self.directory))[:-self.max_to_keep]:
            os.unlink(os.path.join(self.directory, f"ckpt_{s:08d}.npz"))
        return path

    def restore(self, target: Tree, step: Optional[int] = None):
        """``restore_checkpoint`` from this manager's directory."""
        return restore_checkpoint(self.directory, target, step)

    @property
    def latest(self) -> Optional[int]:
        """The newest step kept, or None."""
        return latest_step(self.directory)
