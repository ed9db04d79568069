"""Tree helpers (counterpart of ``fetode_tpu/utils/trees.py``).

The JAX package marks non-trainable arrays (knot grids) by a
``_buffers`` key in its parameter trees; the port keeps them as module
buffers.  A tree here is a tensor, an ``nn.Module`` (its ``state_dict``:
parameters and buffers) or a dict / list / tuple of trees.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn


def trainable_mask(module: nn.Module) -> Dict[str, bool]:
    """``{state_dict key: trainable}``: a parameter's ``requires_grad``,
    False for every buffer (the JAX mask's ``_buffers`` leaves)."""
    mask = {name: False for name, _ in module.named_buffers()}
    mask.update({name: p.requires_grad
                 for name, p in module.named_parameters()})
    return {k: mask[k] for k in module.state_dict() if k in mask}


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor of ``tree``, paths dotted."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        for k, v in tree.state_dict().items():
            yield (f"{prefix}.{k}" if prefix else k), v
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}.{i}" if prefix else str(i))


def tree_size(tree) -> int:
    """Total number of tensor elements in ``tree``."""
    return sum(t.numel() for _, t in tree_leaves(tree))
