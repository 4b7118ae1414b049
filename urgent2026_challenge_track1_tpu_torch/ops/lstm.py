"""LSTM layers in the torch.nn.LSTM parameter layout (counterpart of
``ops/lstm.py``).

Parameters are a mapping with ``w_ih (4H, I)``, ``w_hh (4H, H)``, ``b_ih``,
``b_hh`` (gates i, f, g, o) and the same names with ``_reverse`` for the
backward direction; the two biases are summed at apply time.  The
recurrences go through the kernel wrappers of ``ops/cuda_lstm.py``: hand
written CUDA kernels for tensors on the card, their plain versions on the
CPU.  Every function runs in the dtype of ``x``; h and c stay float32.

All three layers are differentiable.  When autograd records, the
recurrences run the residual-storing training kernels and their backward
kernels (``BiLSTMTrain``, ``LSTMDirTrain``, ``LSTMRevMaskedTrain``);
otherwise the lean inference kernels.  The experiment toggles of
``ops/cuda_lstm.py`` (``STREAM_INPUT_TRAIN``, ``FUSED_BIDIR_TRAIN``) are read
at call time, as ``ops/lstm.py`` reads those of ``pallas_lstm.py``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from urgent2026_challenge_track1_tpu_torch import tracing
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


def _w_ih_t(params: Mapping[str, torch.Tensor], sfx: str, dtype) -> torch.Tensor:
    return params[f"w_ih{sfx}"].to(dtype).t().contiguous()


def _bias(params: Mapping[str, torch.Tensor], sfx: str, dtype) -> torch.Tensor:
    """b_ih + b_hh summed in f32, then in ``dtype``."""
    return (params[f"b_ih{sfx}"] + params[f"b_hh{sfx}"]).to(dtype)


@tracing.spanned(tracing.LSTM_OP)
def lstm(params: Mapping[str, torch.Tensor], x: torch.Tensor, reverse: bool = False,
         suffix: str = "", initial_state=None, return_state: bool = False):
    """Unidirectional LSTM.  x: (B, T, I) -> (B, T, H).

    ``initial_state`` (h0 (B, H) in x's dtype, c0 (B, H) float32) and
    ``return_state`` are the carry of a chunked stream: chaining calls over
    consecutive chunks equals one call over the whole sequence, and the
    call returns (h, (hT, cT)).  The carry runs K2 (``lstm_scan``) with
    its carry; without one, the call is ``lstm_dir``'s (K2, or under
    autograd ``LSTMDirTrain``)."""
    xp = _proj(params, x, suffix).contiguous()
    w = _w_hh_t(params, suffix, x.dtype)
    if initial_state is None and not return_state:
        return cuda_lstm.lstm_dir(xp, w, reverse)
    if initial_state is not None:
        initial_state = (initial_state[0].to(x.dtype).contiguous(),
                         initial_state[1].float().contiguous())
    return cuda_lstm.lstm_scan(xp, w, reverse, initial_state=initial_state,
                               return_state=return_state)


@tracing.spanned(tracing.LSTM_OP)
def bilstm(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM.  x: (B, T, I) -> (B, T, 2H), forward ++ backward.

    Without autograd one fused-input kernel runs both directions
    (``fusedin_bilstm``).  Under autograd ``BiLSTMTrain`` runs the training
    kernels the toggles select, as the VJP of the JAX fused-input kernel
    does (``_fusedin_fwd``, ``_fusedin_bwd``)."""
    dtype = x.dtype
    if cuda_lstm.needs_grad(x, *params.values()):
        return cuda_lstm.BiLSTMTrain.apply(
            x.contiguous(), _w_ih_t(params, "", dtype), _w_ih_t(params, "_reverse", dtype),
            _w_hh_t(params, "", dtype), _w_hh_t(params, "_reverse", dtype),
            _bias(params, "", dtype), _bias(params, "_reverse", dtype))
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


@tracing.spanned(tracing.LSTM_OP)
def bilstm_masked(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Length-exact bidirectional LSTM.  x: (B, T, I), lengths: (B,) ->
    (B, T, 2H).  Outputs at t < lengths[b] do not depend on T; outputs at
    t >= lengths[b] are unspecified, and callers mask them downstream.

    The forward direction is a plain scan (padding follows the valid
    prefix); the backward direction is the reverse walk that zeroes its
    state at padded steps (``lstm_dir_revmasked``), so no gathers are
    needed.

    Under ``cuda_lstm.STREAM_INPUT_TRAIN`` both directions stream the raw
    input into K8 (``lstm_dir_streamin``, with or without autograd): the
    backward direction is a forward walk over the length-reversed N-wide
    input, un-reversed afterwards (JAX ``ops/lstm.py:170-187``)."""
    dtype = x.dtype
    if cuda_lstm.STREAM_INPUT_TRAIN:
        x_rev = length_reverse(x, lengths).contiguous()
        fwd = cuda_lstm.lstm_dir_streamin(x.contiguous(), _w_ih_t(params, "", dtype),
                                          _bias(params, "", dtype), _w_hh_t(params, "", dtype))
        bwd = cuda_lstm.lstm_dir_streamin(x_rev, _w_ih_t(params, "_reverse", dtype),
                                          _bias(params, "_reverse", dtype),
                                          _w_hh_t(params, "_reverse", dtype))
        return torch.cat([fwd, length_reverse(bwd, lengths)], dim=-1)
    fwd = cuda_lstm.lstm_dir(_proj(params, x, "").contiguous(),
                             _w_hh_t(params, "", dtype), False)
    bwd = cuda_lstm.lstm_dir_revmasked(_proj(params, x, "_reverse").contiguous(),
                                       _w_hh_t(params, "_reverse", dtype),
                                       lengths.to(x.device, torch.int32).contiguous())
    return torch.cat([fwd, bwd], dim=-1)
