"""Checkpointing of nested containers of tensors for long batch runs.

Counterpart of the JAX package's ``utils/checkpointing.py``: solver state
(d_free, times, duals, optimizer state -- any nesting of tuples, lists,
dicts and NamedTuples of tensors, arrays and scalars) goes to one npz file,
its leaves as ``leaf_<i>`` and a description of the nesting as
``__treedef__``, so that a preempted run resumes exactly.  The flatten is
this module's own: dicts in sorted key order, sequences and NamedTuples in
order, None as an empty node.
"""

from __future__ import annotations

import json
from typing import Any, List, Tuple

import numpy as np
import torch

from .._tensors import DeviceLike, resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List[Any]) -> Any:
    """Appends the leaves of ``tree`` to ``leaves``; returns its treedef (a
    JSON-able description)."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return {"namedtuple": type(tree).__name__, "fields": list(
            tree._fields), "children": [_flatten(c, leaves) for c in tree]}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_flatten(c, leaves) for c in tree]}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"dict": [[str(k), _flatten(tree[k], leaves)] for k in keys]}
    leaves.append(tree)
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    """``like`` with its leaves replaced, in order, from the iterator."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(c, leaves) for c in like])
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves) for c in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, treedef string) of a nested container."""
    leaves: List[Any] = []
    treedef = json.dumps(_flatten(tree, leaves), sort_keys=True)
    return leaves, treedef


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save a nested container of tensors, arrays and scalars to one npz."""
    leaves, treedef = tree_flatten(tree)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(treedef.encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str, like: Any, device: DeviceLike = None) -> Any:
    """Load what ``save_pytree`` saved; ``like`` supplies the nesting (it
    must match what was saved).  Leaves come back as tensors on ``device``
    (None means the CUDA card)."""
    dev = resolve_device(device)
    leaves_like, treedef = tree_flatten(like)
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("leaf_")])
        if n != len(leaves_like):
            raise ValueError(
                f"Checkpoint has {n} leaves; template has {len(leaves_like)}.")
        if "__treedef__" in data.files:
            saved = bytes(data["__treedef__"]).decode()
            if saved != treedef:
                raise ValueError(
                    "Checkpoint treedef does not match the template:\n"
                    f"  saved:    {saved}\n  template: {treedef}")
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=dev)
                  for i in range(n)]
    return _unflatten(like, iter(leaves))
