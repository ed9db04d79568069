"""Attention masks (counterpart of ``fetode_tpu/data/masking.py``, the
reference's ``TriangularCausalMask`` and ``ProbMask``).

Boolean tensors, True at a masked position (the reference's
``triu(ones, diagonal=1)`` convention), built by index comparisons.
"""

from __future__ import annotations

import torch


def causal_mask(B: int, L: int, dtype=torch.bool, device=None):
    """(B, 1, L, L) strict upper-triangular mask: position (q, k) is True
    (disallowed) when k > q."""
    q = torch.arange(L, device=device)[:, None]
    k = torch.arange(L, device=device)[None, :]
    return (k > q).to(dtype).expand(B, 1, L, L)


def prob_mask(index, scores, L: int):
    """ProbSparse-attention mask: ``index`` (B, H, n_top) holds each head's
    selected query rows, ``scores`` is (B, H, n_top, L_k).  Returns a
    boolean mask of ``scores.shape``, True where the key position lies in
    the selected query's future."""
    index = torch.as_tensor(index)
    L_k = scores.shape[-1]
    del L  # shape bookkeeping only: rows are generated, not gathered
    k = torch.arange(L_k, device=index.device)
    return k > index[..., None].to(torch.int64)


def apply_mask(scores, mask, fill=float("-inf")):
    """``scores`` with masked positions set to ``fill``."""
    scores = torch.as_tensor(scores)
    return torch.where(torch.as_tensor(mask, device=scores.device),
                       torch.tensor(fill, dtype=scores.dtype,
                                    device=scores.device), scores)
