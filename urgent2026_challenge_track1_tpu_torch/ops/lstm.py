"""LSTM layers in the torch.nn.LSTM parameter layout (counterpart of
``ops/lstm.py``).

Parameters are a mapping with ``w_ih (4H, I)``, ``w_hh (4H, H)``, ``b_ih``,
``b_hh`` (gates i, f, g, o) and the same names with ``_reverse`` for the
backward direction; the two biases are summed at apply time.  The
recurrences go through the kernel wrappers of ``ops/cuda_lstm.py``: hand
written CUDA kernels for tensors on the card, their plain versions on the
CPU.  Every function runs in the dtype of ``x``; h and c stay float32.
"""

from __future__ import annotations

from typing import Mapping

import torch

from urgent2026_challenge_track1_tpu_torch.ops import cuda_lstm

__all__ = ["lstm", "bilstm", "length_reverse", "bilstm_masked"]


def _proj(params: Mapping[str, torch.Tensor], x: torch.Tensor, sfx: str) -> torch.Tensor:
    """Hoisted input projection x W_ih^T + (b_ih + b_hh) in x's dtype."""
    dtype = x.dtype
    b = (params[f"b_ih{sfx}"] + params[f"b_hh{sfx}"]).to(dtype)
    return torch.addmm(b, x.reshape(-1, x.shape[-1]), params[f"w_ih{sfx}"].to(dtype).t()
                       ).reshape(x.shape[:-1] + (-1,))


def _w_hh_t(params: Mapping[str, torch.Tensor], sfx: str, dtype) -> torch.Tensor:
    return params[f"w_hh{sfx}"].to(dtype).t().contiguous()


def lstm(params: Mapping[str, torch.Tensor], x: torch.Tensor, reverse: bool = False,
         suffix: str = "") -> torch.Tensor:
    """Unidirectional LSTM.  x: (B, T, I) -> (B, T, H)."""
    return cuda_lstm.lstm_scan(_proj(params, x, suffix).contiguous(),
                               _w_hh_t(params, suffix, x.dtype), reverse)


def bilstm(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM.  x: (B, T, I) -> (B, T, 2H), forward ++ backward.
    One fused-input kernel runs both directions (``fusedin_bilstm``)."""
    dtype = x.dtype
    w_ih_t = torch.stack([params["w_ih"].t(), params["w_ih_reverse"].t()]).to(dtype)
    w_hh_t = torch.stack([params["w_hh"].t(), params["w_hh_reverse"].t()]).to(dtype)
    bias = torch.stack([params["b_ih"] + params["b_hh"],
                        params["b_ih_reverse"] + params["b_hh_reverse"]]).to(dtype)
    return cuda_lstm.fusedin_bilstm(x.contiguous(), w_ih_t.contiguous(),
                                    w_hh_t.contiguous(), bias.contiguous())


def length_reverse(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's first ``lengths[b]`` steps; padding stays in place.
    x: (B, T, ...), lengths: (B,).  Applying it twice restores x."""
    T = x.shape[1]
    L = lengths.to(x.device, torch.int64)[:, None]
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t < L, L - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


def bilstm_masked(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Length-exact bidirectional LSTM.  x: (B, T, I), lengths: (B,) ->
    (B, T, 2H).  Outputs at t < lengths[b] do not depend on T; outputs at
    t >= lengths[b] are unspecified, and callers mask them downstream.

    The forward direction is a plain scan (padding follows the valid
    prefix); the backward direction is the reverse walk that zeroes its
    state at padded steps (``lstm_revmasked``), so no gathers are needed."""
    dtype = x.dtype
    fwd = cuda_lstm.lstm_scan(_proj(params, x, "").contiguous(),
                              _w_hh_t(params, "", dtype), False)
    bwd = cuda_lstm.lstm_revmasked(_proj(params, x, "_reverse").contiguous(),
                                   _w_hh_t(params, "_reverse", dtype),
                                   lengths.to(x.device, torch.int32).contiguous())
    return torch.cat([fwd, bwd], dim=-1)
