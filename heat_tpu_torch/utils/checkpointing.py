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

A save whose tree holds a DNDarray over a comm that spans processes, or
that is given such a comm (``comm=``, e.g. for a replicated state of
tensors), is made by every process of that comm alike (as every host of a
JAX job makes it): all of them gather the leaves alike (a split
DNDarray's ``larray`` crosses between processes), only the comm's process
0 removes, creates and writes the directory, and a barrier over the
comm's group follows, so no process returns before the files are whole.
Any other save is this process's own, with a process group up or not
(a save on process 0 alone, or into a directory of each process).  A load reads the same
files in every process and cuts each DNDarray by the chunk rule of the
comm it is given, which may have another number of processes or positions
than the one saved from (heat_tpu's Orbax ``target`` shardings).
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


def _save_tree(node, path, directory, meta, counter, write=True):
    """The tree's structure for ``tree.json``; each array leaf is gathered
    (a collective for a split DNDarray across processes) and, where
    ``write``, saved."""
    if isinstance(node, dict):
        keys = list(node)
        return {"dict": [[_encode_key(k), _save_tree(node[k], path + (k,), directory, meta, counter, write)]
                         for k in keys]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_save_tree(v, path + (i,), directory, meta, counter, write) for i, v in enumerate(node)]}
    if isinstance(node, DNDarray):
        meta[_keystr(path)] = {"split": node.split, "dtype": node.dtype.__name__, "shape": list(node.shape)}
        node = node.larray
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
        arr, dtype = _to_numpy(node) if isinstance(node, torch.Tensor) else (np.asarray(node), str(np.asarray(node).dtype))
        name = f"leaf_{counter[0]:06d}.npy"
        counter[0] += 1
        if write:
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


def _scope(tree, comm=None):
    """The comm whose processes make a save of ``tree`` together:
    ``comm`` where it spans processes, else the first DNDarray leaf's comm
    that does; None for a save this process makes alone."""
    if comm is not None and comm.spans_processes:
        return comm
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            found = _scope(node)
            if found is not None:
                return found
    if isinstance(tree, DNDarray) and tree.comm.spans_processes:
        return tree.comm
    return None


def _barrier(scope) -> None:
    if scope is not None:
        torch.distributed.barrier(group=scope.group)


def save_checkpoint(path: str, tree: Any, comm=None) -> None:
    """Save a tree of dicts, lists and tuples whose leaves are DNDarrays,
    torch tensors, numpy arrays or python scalars to the directory
    ``path`` (replacing what is there).  Where the tree's DNDarrays or
    ``comm`` span processes every process of that comm calls this alike
    and its process 0 writes (the module docstring)."""
    _save(os.path.abspath(path), tree, _scope(tree, comm))


def _save(path: str, tree: Any, scope) -> None:
    write = scope is None or scope.rank == 0
    if write:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
    meta: dict = {}
    structure = _save_tree(tree, (), path, meta, [0], write)
    if write:
        with open(os.path.join(path, _TREE_NAME), "w") as f:
            json.dump(structure, f)
        with open(os.path.join(path, _META_NAME), "w") as f:
            json.dump(meta, f)
    _barrier(scope)


def load_checkpoint(path: str, target: Optional[Any] = None, comm=None, device=None) -> Any:
    """Restore a checkpoint of :func:`save_checkpoint`: tensors on
    ``device`` (the default device; a ``target`` tree's leaves give theirs),
    DNDarrays with their saved split and dtype over ``comm`` (the target's
    leaf's comm where one is given), each process holding its positions'
    chunks."""
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

    ``comm``: every save is made by that comm's processes together where
    it spans processes (:func:`save_checkpoint`).
    """

    def __init__(self, directory: str, max_to_keep: int = 3, comm=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.comm = comm
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
        """Save ``tree`` as ``step`` and drop the oldest beyond
        ``max_to_keep``; a save across processes is made by all of them
        alike, and its process 0 writes and removes."""
        path = self._step_dir(step)
        scope = _scope(tree, self.comm)
        _save(path, tree, scope)
        if scope is None or scope.rank == 0:
            self._retain()
        _barrier(scope)
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
