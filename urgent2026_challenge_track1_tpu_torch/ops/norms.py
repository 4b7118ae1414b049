"""Single-group GroupNorm over explicit axes, as espnet's "GN"
(``nn.GroupNorm(1, C, eps=1e-8)``); counterpart of ``ops/norms.py``.

The masked form keeps padded channel slots and padded frames out of the
statistics of the band-stacked layout and zeroes them in the output.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["group_norm", "masked_group_norm"]

EPS = 1e-8  # espnet choose_norm default


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               axes: Sequence[int], eps: float = EPS) -> torch.Tensor:
    """Normalize over ``axes`` jointly; ``scale``/``bias`` broadcast against x."""
    dims = tuple(axes)
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def masked_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      mask: torch.Tensor, axes: Sequence[int],
                      eps: float = EPS) -> torch.Tensor:
    """GroupNorm over the ``mask``-selected entries of ``axes`` (mask
    broadcasts against x; 1 = valid).  Padded positions come out zero."""
    dims = tuple(axes)
    mask = mask.to(x.dtype)
    denom = (mask * torch.ones_like(x)).sum(dim=dims, keepdim=True)
    # an all-masked row (a zero-length filler item) must give zeros, not NaN
    denom = torch.clamp(denom, min=1.0)
    mean = (x * mask).sum(dim=dims, keepdim=True) / denom
    var = ((x - mean).square() * mask).sum(dim=dims, keepdim=True) / denom
    return ((x - mean) / torch.sqrt(var + eps) * scale + bias) * mask
