"""Single-group GroupNorm over explicit axes, as espnet's "GN"
(``nn.GroupNorm(1, C, eps=1e-8)``); counterpart of ``ops/norms.py``.

The masked form keeps padded channel slots and padded frames out of the
statistics of the band-stacked layout and zeroes them in the output.  The
cumulative form is the causal norm of a streaming model: statistics at
frame t use frames <= t only, with running sums carried across chunks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["group_norm", "masked_group_norm", "cumulative_group_norm"]

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


def cumulative_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          axes: Sequence[int], eps: float = EPS,
                          mask: Optional[torch.Tensor] = None, state=None,
                          return_state: bool = False):
    """Causal GroupNorm: ``x`` is (B, T, ...) with time on axis 1; ``axes``
    are the non-time axes the statistics span within a frame, and time
    joins them cumulatively.  ``mask`` (broadcasts against x) weights the
    entries of a frame (masked ones count for nothing and come out zero).
    ``state`` is the ``(count, s1, s2)`` running sums of earlier chunks, each
    shaped like the per-frame statistics with a time axis of 1, so chained
    chunks reproduce one call over the whole sequence.

    Returns y, or ``(y, (count, s1, s2))`` when ``state`` is given or
    ``return_state`` is set."""
    dims = tuple(axes)
    if 0 in dims or 1 in dims:
        raise ValueError("axes must not include the batch/time axes (0, 1)")
    w = torch.ones_like(x) if mask is None else mask.to(x.dtype).expand_as(x)
    s1 = torch.cumsum((x * w).sum(dim=dims, keepdim=True), dim=1)
    s2 = torch.cumsum((x.square() * w).sum(dim=dims, keepdim=True), dim=1)
    count = torch.cumsum(w.sum(dim=dims, keepdim=True), dim=1)
    if state is not None:
        c0, p1, p2 = state
        count, s1, s2 = count + c0, s1 + p1, s2 + p2
    denom = torch.clamp(count, min=1.0)
    mean = s1 / denom
    # E[x^2] - mean^2 (the carryable form); clamp the cancellation residue
    var = torch.clamp(s2 / denom - mean.square(), min=0.0)
    y = (x - mean) / torch.sqrt(var + eps) * scale + bias
    if mask is not None:
        y = y * w
    if state is not None or return_state:
        return y, (count[:, -1:], s1[:, -1:], s2[:, -1:])
    return y
