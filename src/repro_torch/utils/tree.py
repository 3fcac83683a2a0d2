"""Helpers for parameter dicts whose leaves carry a leading worker axis.

The port's counterpart of the reference's pytree utilities: parameters are a
flat ``dict[str, Tensor]`` (the 2-NN's ``w1, b1, …``), and the simulator
keeps all N workers' parameters as one such dict, each leaf stacked along a
new leading axis.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def tree_stack(trees: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Stack identically-keyed dicts along a new leading axis.

    Leaves may be tensors (stacked with ``torch.stack``) or NumPy arrays
    (stacked with ``np.stack``), but one kind per call.
    """
    if not trees:
        raise ValueError("tree_stack needs at least one tree")
    keys = list(trees[0])
    for t in trees[1:]:
        if list(t) != keys:
            raise ValueError(f"tree_stack: keys differ: {keys} vs {list(t)}")
    out = {}
    for k in keys:
        leaves = [t[k] for t in trees]
        if isinstance(leaves[0], torch.Tensor):
            out[k] = torch.stack(leaves, dim=0)
        else:
            out[k] = np.stack([np.asarray(x) for x in leaves], axis=0)
    return out


def tree_size(tree: Dict[str, object]) -> int:
    """Total number of scalars in the tree."""
    return int(sum(np.prod(tuple(v.shape)) for v in tree.values()))
