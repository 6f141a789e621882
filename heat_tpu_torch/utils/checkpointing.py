"""Checkpoint and resume (counterpart of heat_tpu/utils/checkpointing.py).

A checkpoint is a directory.  Each array leaf of the tree (torch tensors,
numpy arrays, DNDarrays) is one ``.npy`` file (bf16 as its uint16 bits),
``tree.json`` holds the tree's structure (dicts, lists, tuples; python
scalars inline), and ``heat_meta.json`` is the JAX package's sidecar:
each DNDarray leaf's split, dtype and shape under its ``keystr`` path, so
a resumed array lands with the distribution it was saved with.  The JAX
package writes Orbax checkpoints, which need orbax and tensorstore; the
port writes its own format and cannot read an Orbax checkpoint.
``Checkpointer`` keeps step-numbered checkpoints with retention.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..core import devices, factories, types
from ..core.dndarray import DNDarray

__all__ = ["Checkpointer", "load_checkpoint", "save_checkpoint"]

_META_NAME = "heat_meta.json"
_TREE_NAME = "tree.json"


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and sequence indices."""
    return "".join(f"[{k!r}]" for k in path)


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _save_tree(node, path, directory, meta, counter):
    if isinstance(node, dict):
        keys = list(node)
        return {"dict": [[_encode_key(k), _save_tree(node[k], path + (k,), directory, meta, counter)] for k in keys]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_save_tree(v, path + (i,), directory, meta, counter) for i, v in enumerate(node)]}
    if isinstance(node, DNDarray):
        meta[_keystr(path)] = {"split": node.split, "dtype": node.dtype.__name__, "shape": list(node.shape)}
        node = node.larray
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
        arr, dtype = _to_numpy(node) if isinstance(node, torch.Tensor) else (np.asarray(node), str(np.asarray(node).dtype))
        name = f"leaf_{counter[0]:06d}.npy"
        counter[0] += 1
        np.save(os.path.join(directory, name), arr, allow_pickle=False)
        return {"array": name, "dtype": dtype, "torch": isinstance(node, torch.Tensor)}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"cannot checkpoint a leaf of type {type(node).__name__}")


def _encode_key(k):
    if isinstance(k, bool) or not isinstance(k, (int, str)):
        raise TypeError(f"checkpoint dict keys must be str or int, got {k!r}")
    return [type(k).__name__, k]


def _load_tree(node, directory, device):
    if "dict" in node:
        return {(int(k) if t == "int" else k): _load_tree(v, directory, device) for (t, k), v in node["dict"]}
    if "list" in node:
        return [_load_tree(v, directory, device) for v in node["list"]]
    if "tuple" in node:
        return tuple(_load_tree(v, directory, device) for v in node["tuple"])
    if "value" in node:
        return node["value"]
    arr = np.load(os.path.join(directory, node["array"]), allow_pickle=False)
    if not node["torch"]:
        return arr
    t = torch.from_numpy(arr)
    if node["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _join(tree, meta, target, comm, device, path=()):
    """Re-wrap the leaves recorded in ``meta`` as DNDarrays; tensors adopt
    the device of ``target``'s leaf where one is given."""
    if isinstance(tree, dict):
        return {k: _join(v, meta, _child(target, k), comm, device, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_join(v, meta, _child(target, i), comm, device, path + (i,)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    info = meta.get(_keystr(path))
    if info is not None:
        tcomm = target.comm if isinstance(target, DNDarray) else comm
        tdev = target.device if isinstance(target, DNDarray) else device
        return factories.array(tree, dtype=getattr(types, info["dtype"]), split=info["split"], comm=tcomm, device=tdev)
    if isinstance(tree, torch.Tensor) and isinstance(target, torch.Tensor):
        return tree.to(target.device)
    return tree


def _child(target, key):
    try:
        return target[key] if target is not None else None
    except (KeyError, IndexError, TypeError):
        return None


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree of dicts, lists and tuples whose leaves are DNDarrays,
    torch tensors, numpy arrays or python scalars to the directory
    ``path`` (replacing what is there)."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    meta: dict = {}
    structure = _save_tree(tree, (), path, meta, [0])
    with open(os.path.join(path, _TREE_NAME), "w") as f:
        json.dump(structure, f)
    with open(os.path.join(path, _META_NAME), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, target: Optional[Any] = None, comm=None, device=None) -> Any:
    """Restore a checkpoint of :func:`save_checkpoint`: tensors on
    ``device`` (the default device; a ``target`` tree's leaves give theirs),
    DNDarrays with their saved split and dtype over ``comm``."""
    path = os.path.abspath(path)
    dev = devices.sanitize_device(device)
    with open(os.path.join(path, _TREE_NAME)) as f:
        structure = json.load(f)
    meta = {}
    meta_path = os.path.join(path, _META_NAME)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    tree = _load_tree(structure, path, dev.torch_device)
    return _join(tree, meta, target, comm, dev)


class Checkpointer:
    """Step-based training checkpoints with retention.

    >>> ckpt = Checkpointer(dir, max_to_keep=3)
    >>> ckpt.save(step, {"model": model.state_dict(), "step": step})
    >>> state = ckpt.restore_latest()        # None if no checkpoint yet
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        path = self._step_dir(step)
        save_checkpoint(path, tree)
        self._retain()
        return path

    def restore(self, step: int, target: Optional[Any] = None, comm=None, device=None) -> Any:
        return load_checkpoint(self._step_dir(step), target=target, comm=comm, device=device)

    def restore_latest(self, target: Optional[Any] = None, comm=None, device=None) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, target=target, comm=comm, device=device)

    def _retain(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            shutil.rmtree(self._step_dir(steps.pop(0)), ignore_errors=True)
