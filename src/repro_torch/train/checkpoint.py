"""Checkpointing: flat-key .npz with a manifest.  Counterpart of
``repro.train.checkpoint``, writing and reading the same file: arrays
``leaf_0 .. leaf_{n-1}`` in JAX's ``tree_util`` order (``train.tree``) and a
JSON ``__manifest__`` (``n_leaves``, ``step``, ``dtypes``, ``shapes`` and a
``treedef`` string that neither package's restore compares).  So either
package restores the other's checkpoint, given a tree in the reference's
layout: the train state goes through ``bridge.train_state_to_numpy`` before
``save_checkpoint`` and through ``bridge.train_state_from_numpy`` after
``restore_checkpoint``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from .tree import tree_leaves, tree_unflatten


def _structure(tree: Any) -> str:
    """A description of the tree's structure (the manifest's ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(t) for t in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def save_checkpoint(path: str, state: Any, *, step: int | None = None) -> None:
    """Write ``state`` (a tree of numpy arrays) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = [np.asarray(leaf) for leaf in tree_leaves(state)]
    manifest = {
        "treedef": "repro_torch " + _structure(state),
        "n_leaves": len(leaves),
        "step": step,
        "dtypes": [str(a.dtype) for a in leaves],
        "shapes": [list(a.shape) for a in leaves],
    }
    np.savez(path, __manifest__=json.dumps(manifest),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``, a tree of numpy arrays (or
    anything with a numpy ``shape`` and ``dtype``): numpy arrays of each
    leaf's dtype.  Raises ``ValueError`` on a leaf count or shape that
    differs from ``like``'s."""
    with np.load(path, allow_pickle=False) as f:
        manifest = json.loads(str(f["__manifest__"]))
        leaves_like = tree_leaves(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves_like)}")
        leaves = []
        for i, ref in enumerate(leaves_like):
            arr = f[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != expected {tuple(ref.shape)}")
            leaves.append(np.asarray(arr, dtype=ref.dtype))
        return tree_unflatten(like, leaves)
