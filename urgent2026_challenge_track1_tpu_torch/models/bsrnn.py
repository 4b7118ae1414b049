"""Band-Split RNN (BSRNN), discriminative, in PyTorch (counterpart of
``models/bsrnn.py``).

  spectrum (B, T, F) complex
    -> BandSplit: K non-uniform subbands, per-band GroupNorm + 1x1 conv -> (B, T, K, N)
    -> num_layer x DualPathLayer:
         time:  GN -> BLSTM over T (rows B*K) -> Linear -> +skip
         band:  GN -> BLSTM over K (rows B*T) -> Linear -> +skip
    -> MaskDecoderHead x 2: per-band MLP -> GLU -> complex (mask, residual)
    -> out = mask * spectrum + residual

Parameters keep the JAX package's band-stacked padded layout (per-band
tensors stacked into (K, W, ...) with zeroed padding slots, masked out of the
statistics), so one parameter tree drives both packages; the layer stack is
a ModuleList where JAX stacks a leading layer axis (``utils/params.py``
converts).  Norms, the residual stream and the LSTM cell state are float32;
the matrix products run in ``cfg.compute_dtype``.

With ``frames`` the forward is length-exact: masked norm statistics and the
length-masked time recurrence make outputs at valid frames independent of
the padding.  With ``cfg.with_condition`` each dual-path layer adds the
Gaussian-Fourier embedding of the flow time t after its time-path norm
(the conditional network of ``models/bsrnn_flowse.py``).

``cfg.causal`` makes the time recurrence one forward LSTM (``fc_time`` in
H, no ``_reverse`` weights); ``cfg.streaming_norm`` makes every norm that
spans time cumulative (``ops/norms.cumulative_group_norm``).  With both,
``bsrnn_apply(..., states=...)`` processes a chunk of an unbounded stream
and returns the carried state beside the output
(``models/streaming_causal.py``); chained chunks equal one offline call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from urgent2026_challenge_track1_tpu_torch import resolve_device, tracing
from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
from urgent2026_challenge_track1_tpu_torch.ops import lstm as lstm_ops
from urgent2026_challenge_track1_tpu_torch.ops.norms import (
    cumulative_group_norm, group_norm, masked_group_norm)

__all__ = [
    "BSRNNConfig",
    "subband_layout",
    "band_count",
    "BSRNN",
    "BandSplit",
    "DualPathLayer",
    "MaskDecoderHead",
    "init_bsrnn",
    "TRAIN_LAUNCHES_PER_LAYER",
    "CAUSAL_TRAIN_LAUNCHES_PER_LAYER",
    "run_layers",
    "bsrnn_apply",
    "bsrnn_se_apply",
]


# ---------------------------------------------------------------------------
# Band layout
# ---------------------------------------------------------------------------


def subband_layout(input_dim: int, target_fs: int = 48000) -> tuple[int, ...]:
    """Non-uniform subband widths in bins; sums to ``input_dim``."""
    if input_dim == 481 and target_fs == 48000:
        return tuple([5] + [4] * 19 + [10] * 6 + [40] * 7 + [60])
    if input_dim == 769 and target_fs == 48000:
        return tuple([5] + [4] * 26 + [10] * 10 + [50] * 10 + [60])
    raise NotImplementedError(
        f"no subband layout for input_dim={input_dim}, target_fs={target_fs}"
    )


def band_count(input_dim: int, target_fs: int, fs: int, n_bins_in: int) -> int:
    """Bands processed at rate ``fs`` with ``n_bins_in`` input bins: the two
    break conditions of the reference BandSplit (bins exhausted, or the
    band's upper edge at or above fs/2)."""
    subbands = subband_layout(input_dim, target_fs)
    n_fft = (input_dim - 1) * 2
    freqs = (np.cumsum(subbands) - 1) * (target_fs / n_fft)
    hz = 0
    for i, sub in enumerate(subbands):
        hz += sub
        if hz >= n_bins_in or freqs[i] >= fs / 2:
            return i + 1
    return len(subbands)


@dataclasses.dataclass(frozen=True)
class BSRNNConfig:
    input_dim: int = 481          # frequency bins at target_fs
    num_channel: int = 192        # embedding dim N (hidden H = 2N)
    num_layer: int = 6
    target_fs: int = 48000
    norm_eps: float = 1e-8        # espnet choose_norm GN eps
    compute_dtype: str = "float32"  # "bfloat16": matmuls and recurrences in
    #                                 bf16, f32 norms/residual/cell state
    remat: bool = True            # under autograd, recompute each dual-path
    #                               layer in the backward pass
    with_condition: bool = False  # flow matching: per-layer t-embedding
    sub_channel: int = 16         # GradDecoder intermediate channels (flow)
    causal: bool = False          # a forward-only time LSTM (else bidirectional)
    streaming_norm: bool = False  # cumulative (causal) norm statistics over
    #                               time: with causal, a streamable model

    @property
    def subbands(self) -> tuple[int, ...]:
        return subband_layout(self.input_dim, self.target_fs)

    @property
    def max_sub(self) -> int:
        return max(self.subbands)

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]


@functools.lru_cache(maxsize=32)
def _band_maps(subbands: tuple[int, ...], n_bins_in: int, n_bands: int):
    """Gather/scatter maps for the padded band-stacked layout (numpy).

    gather (K, W): indices into the interleaved re/im spectrum of length
      2*n_bins_in (+1 zero slot at index 2*n_bins_in) for each band slot;
    chan_mask (K, W): 1.0 where the slot is a real channel of the band
      (including the zero-padded part of a truncated last band);
    flat_valid (n_bins_in,): indices into the flattened (K*max_sub,) complex
      band stack that recover bins 0..n_bins_in-1 in order."""
    K = n_bands
    max_sub = max(subbands)
    W = 2 * max_sub
    gather = np.full((K, W), 2 * n_bins_in, dtype=np.int64)
    chan_mask = np.zeros((K, W), dtype=np.float32)
    flat_valid = np.zeros((n_bins_in,), dtype=np.int64)
    off = 0
    for i in range(K):
        sub = subbands[i]
        for j in range(sub):
            b = off + j
            if b < n_bins_in:
                gather[i, 2 * j] = 2 * b
                gather[i, 2 * j + 1] = 2 * b + 1
                flat_valid[b] = i * max_sub + j
            chan_mask[i, 2 * j] = 1.0
            chan_mask[i, 2 * j + 1] = 1.0
        off += sub
    return gather, chan_mask, flat_valid


def _maps_on(subbands, n_bins_in, n_bands, device):
    gather, chan_mask, flat_valid = _band_maps(subbands, n_bins_in, n_bands)
    return (torch.from_numpy(gather).to(device), torch.from_numpy(chan_mask).to(device),
            torch.from_numpy(flat_valid).to(device))


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype``, as float32: a product of two such operands in
    float32 (TF32 off, PyTorch's default for matmuls) is exact per term and
    sums in float32, which is a ``dtype`` x ``dtype`` -> float32 product."""
    return x.to(dtype).float()


def _mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """(..., I) x (I, O) of operands rounded to ``dtype``, float32 result
    plus the f32 bias (JAX: ``preferred_element_type=float32``)."""
    return _rounded(x, dtype) @ _rounded(w, dtype) + b


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``torch.einsum`` of operands rounded to ``dtype``, float32 result."""
    return torch.einsum(eq, _rounded(x, dtype), _rounded(w, dtype))


def _frame_mask4(fm: Optional[torch.Tensor]):
    return None if fm is None else fm[:, :, None, None]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _zeros(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class BandSplit(nn.Module):
    """(B, T, F) complex -> (B, T, K, N): per-band masked GroupNorm over
    (T, channels) and a per-band 1x1 conv, as one einsum over padded bands."""

    def __init__(self, cfg: BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        K, W, C = len(cfg.subbands), 2 * cfg.max_sub, cfg.num_channel
        self.norm_scale = _zeros(K, W)
        self.norm_bias = _zeros(K, W)
        self.w = _zeros(K, W, C)
        self.b = _zeros(K, C)

    @tracing.spanned(tracing.MODEL_BAND_SPLIT)
    def forward(self, spec: torch.Tensor, n_bands: int,
                fm: Optional[torch.Tensor] = None, nstate=None,
                return_state: bool = False):
        """With ``cfg.streaming_norm`` the per-band norm is cumulative over
        frames; ``nstate`` / ``return_state`` carry its sums across chunks
        and return (z, new_state)."""
        B, T, F = spec.shape
        cfg = self.cfg
        gather, chan_mask, _ = _maps_on(cfg.subbands, F, n_bands, spec.device)
        x2 = torch.view_as_real(spec).reshape(B, T, 2 * F)
        x2 = nn.functional.pad(x2, (0, 1))  # the zero slot
        blocks = x2[..., gather]  # (B, T, K, W)
        scale = self.norm_scale[:n_bands][None, None]
        bias = self.norm_bias[:n_bands][None, None]
        ns = None
        if cfg.streaming_norm:
            h = cumulative_group_norm(blocks, scale, bias, axes=(3,), eps=cfg.norm_eps,
                                      mask=chan_mask[None, None], state=nstate,
                                      return_state=return_state)
            if nstate is not None or return_state:
                h, ns = h
        else:
            mask = chan_mask[None, None]
            if fm is not None:
                mask = mask * _frame_mask4(fm)
            h = masked_group_norm(blocks, scale, bias, mask, axes=(1, 3), eps=cfg.norm_eps)
        z = _einsum("btkw,kwc->btkc", h, self.w[:n_bands], cfg.dtype)
        z = z + self.b[:n_bands][None, None]
        return (z, ns) if nstate is not None or return_state else z


def _lstm_params(input_size: int, hidden: int, bidirectional: bool = True) -> nn.ParameterDict:
    p = {}
    for sfx in ("", "_reverse") if bidirectional else ("",):
        p[f"w_ih{sfx}"] = _zeros(4 * hidden, input_size)
        p[f"w_hh{sfx}"] = _zeros(4 * hidden, hidden)
        p[f"b_ih{sfx}"] = _zeros(4 * hidden)
        p[f"b_hh{sfx}"] = _zeros(4 * hidden)
    return nn.ParameterDict(p)


class DualPathLayer(nn.Module):
    """One dual-path block on (B, T, K, N): a BLSTM over time (rows B*K; a
    forward LSTM when ``cfg.causal``), then a BLSTM over bands (rows B*T),
    each with GroupNorm (cumulative over time with ``cfg.streaming_norm``),
    a linear projection and a residual add."""

    def __init__(self, cfg: BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        N = cfg.num_channel
        hdim = 2 * N
        self.norm_time_scale = nn.Parameter(torch.ones(N))
        self.norm_time_bias = _zeros(N)
        self.rnn_time = _lstm_params(N, hdim, bidirectional=not cfg.causal)
        self.fc_time_w = _zeros(hdim if cfg.causal else 2 * hdim, N)
        self.fc_time_b = _zeros(N)
        self.norm_freq_scale = nn.Parameter(torch.ones(N))
        self.norm_freq_bias = _zeros(N)
        self.rnn_freq = _lstm_params(N, hdim)
        self.fc_freq_w = _zeros(4 * N, N)
        self.fc_freq_b = _zeros(N)
        if cfg.with_condition:
            # GaussianFourierProjection W (N/2,): a fixed buffer in the
            # reference; a parameter here whose gradient the trainer counts
            # in the clip and the grad norm but never applies (optax's mask)
            self.t_proj_w = _zeros(N // 2)

    def _norm(self, z, scale, bias, fm, nstate=None, want_state=False):
        """The GroupNorm of either path: cumulative over time with
        ``cfg.streaming_norm`` (then ``(y, new_state)`` when ``want_state``),
        else over (T, K, N), masked by ``fm``."""
        eps = self.cfg.norm_eps
        if self.cfg.streaming_norm:
            return cumulative_group_norm(z, scale, bias, axes=(2, 3), eps=eps, state=nstate,
                                         return_state=want_state)
        if fm is None:
            return group_norm(z, scale, bias, axes=(1, 2, 3), eps=eps)
        return masked_group_norm(z, scale, bias, _frame_mask4(fm), axes=(1, 2, 3), eps=eps)

    @tracing.spanned(tracing.MODEL_LAYER)
    def forward(self, z: torch.Tensor, frames: Optional[torch.Tensor] = None,
                fm: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None, lstate=None, shard=None):
        """``lstate``: one layer's streaming carry (``norm_time``,
        ``rnn_time`` (h, c), ``norm_freq``; needs ``cfg.causal`` and
        ``cfg.streaming_norm``); the layer then returns (z, new_lstate).
        ``shard``: a ``parallel.model_parallel.RowSharder`` that splits the
        rows of each recurrence and its projection over the mp group."""
        B, T, K, N = z.shape
        cfg = self.cfg
        dt = cfg.dtype
        want = lstate is not None
        new_state = {}
        # --- time path (rows b-major: row = b*K + k) ---
        out = self._norm(z, self.norm_time_scale, self.norm_time_bias, fm,
                         lstate["norm_time"] if want else None, want)
        if want:
            out, new_state["norm_time"] = out
        if t is not None:
            # random Fourier embedding of t (B,) -> (B, N), over (T, K)
            proj = t[:, None] * self.t_proj_w[None, :] * (2.0 * np.pi)
            out = out + torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)[:, None, None, :]
        seq = out.permute(0, 2, 1, 3).reshape(B * K, T, N).to(dt)
        if cfg.causal and want:
            h, new_state["rnn_time"] = lstm_ops.lstm(
                self.rnn_time, seq, initial_state=lstate["rnn_time"], return_state=True)
            h = _mm(h, self.fc_time_w, self.fc_time_b, dt)
        else:
            lengths = None if cfg.causal or frames is None else frames.repeat_interleave(K)
            h = _rows(shard, self._time_rows, seq, lengths)
        z = z + h.reshape(B, K, T, N).permute(0, 2, 1, 3)
        # --- band path (padded frames are independent rows here) ---
        out = self._norm(z, self.norm_freq_scale, self.norm_freq_bias, fm,
                         lstate["norm_freq"] if want else None, want)
        if want:
            out, new_state["norm_freq"] = out
        seq = out.reshape(B * T, K, N).to(dt)
        h = _rows(shard, self._band_rows, seq)
        z = z + h.reshape(B, T, K, N)
        return (z, new_state) if want else z

    def _time_rows(self, seq: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """The time recurrence of (rows, T, N) and its projection to N."""
        if self.cfg.causal:
            h = lstm_ops.lstm(self.rnn_time, seq)
        elif lengths is None:
            h = lstm_ops.bilstm(self.rnn_time, seq)
        else:
            h = lstm_ops.bilstm_masked(self.rnn_time, seq, lengths)
        return _mm(h, self.fc_time_w, self.fc_time_b, self.cfg.dtype)

    def _band_rows(self, seq: torch.Tensor):
        """The band recurrence of (rows, K, N) and its projection to N."""
        return _mm(lstm_ops.bilstm(self.rnn_freq, seq), self.fc_freq_w, self.fc_freq_b,
                   self.cfg.dtype)


def _rows(shard, fn, seq: torch.Tensor, lengths: Optional[torch.Tensor] = None):
    """``fn`` over every row of ``seq``, or with ``shard`` over this mp
    rank's block, gathered."""
    if shard is not None:
        return shard(fn, seq, lengths)
    return fn(seq) if lengths is None else fn(seq, lengths)


class MaskDecoderHead(nn.Module):
    """espnet MaskDecoder head (mask or residual): per band GroupNorm(1, C)
    over (C, T), Conv(C->4C), tanh, Conv(4C->2W) and GLU; (B, T, K, N) ->
    (B, T, n_bins) complex."""

    def __init__(self, cfg: BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        K, C, W = len(cfg.subbands), cfg.num_channel, 2 * cfg.max_sub
        self.norm_scale = nn.Parameter(torch.ones(K, C))
        self.norm_bias = _zeros(K, C)
        self.w1 = _zeros(K, C, 4 * C)
        self.b1 = _zeros(K, 4 * C)
        self.wv = _zeros(K, 4 * C, W)
        self.wg = _zeros(K, 4 * C, W)
        self.bv = _zeros(K, W)
        self.bg = _zeros(K, W)

    @tracing.spanned(tracing.MODEL_DECODER)
    def forward(self, z: torch.Tensor, n_bands: int, n_bins: int,
                fm: Optional[torch.Tensor] = None, nstate=None, return_state: bool = False):
        """With ``cfg.streaming_norm`` the per-band norm is cumulative over
        frames; ``nstate`` / ``return_state`` carry it and return
        (out, new_state)."""
        B, T, K, N = z.shape
        cfg = self.cfg
        _, chan_mask, flat_valid = _maps_on(cfg.subbands, n_bins, n_bands, z.device)
        scale = self.norm_scale[:n_bands][None, None]
        bias = self.norm_bias[:n_bands][None, None]
        ns = None
        if cfg.streaming_norm:
            h = cumulative_group_norm(z, scale, bias, axes=(3,), eps=cfg.norm_eps,
                                      state=nstate, return_state=return_state)
            if nstate is not None or return_state:
                h, ns = h
        else:
            if fm is None:
                mean = z.mean(dim=(1, 3), keepdim=True)
                var = (z - mean).square().mean(dim=(1, 3), keepdim=True)
            else:
                m4 = _frame_mask4(fm)
                denom = m4.sum(dim=1, keepdim=True) * N
                mean = (z * m4).sum(dim=(1, 3), keepdim=True) / denom
                var = ((z - mean).square() * m4).sum(dim=(1, 3), keepdim=True) / denom
            h = (z - mean) / torch.sqrt(var + cfg.norm_eps) * scale + bias
        dt = cfg.dtype
        h = torch.tanh(_einsum("btkc,kcd->btkd", h, self.w1[:n_bands], dt)
                       + self.b1[:n_bands][None, None])
        val = _einsum("btkd,kdw->btkw", h, self.wv[:n_bands], dt) + self.bv[:n_bands][None, None]
        gate = _einsum("btkd,kdw->btkw", h, self.wg[:n_bands], dt) + self.bg[:n_bands][None, None]
        out = val * torch.sigmoid(gate) * chan_mask[None, None]
        cplx = out.reshape(B, T, K, cfg.max_sub, 2)
        cplx = torch.complex(cplx[..., 0], cplx[..., 1]).reshape(B, T, K * cfg.max_sub)
        cplx = cplx[..., flat_valid]
        return (cplx, ns) if nstate is not None or return_state else cplx


# Kernel launches of one training step per dual-path layer with remat (the
# recorded pass, its recompute in the backward, and the backward), for each
# setting of the toggles of ops/cuda_lstm.py: default, STREAM_INPUT_TRAIN,
# FUSED_BIDIR_TRAIN, both.  The same for either model family; the lean
# inference kernels (fusedin_bilstm, lstm_scan, lstm_revmasked) run in none.
TRAIN_LAUNCHES_PER_LAYER = {
    "default": {"lstm_train_fwd": 6, "lstm_train_bwd": 3, "lstm_revmasked_train_fwd": 2,
                "lstm_revmasked_bwd": 1},
    "stream": {"lstm_train_fwd_streamin": 8, "lstm_train_bwd": 4},
    "fused": {"lstm_train_fwd": 2, "lstm_train_bwd": 1, "lstm_revmasked_train_fwd": 2,
              "lstm_revmasked_bwd": 1, "lstm_train_fwd2": 2, "lstm_train_bwd2": 1},
}
TRAIN_LAUNCHES_PER_LAYER["both"] = TRAIN_LAUNCHES_PER_LAYER["stream"]
# The same for a causal model (``cfg.causal``) with the toggles off: its time
# path is one ``LSTMDirTrain`` direction (K4 twice with remat, K5 once)
CAUSAL_TRAIN_LAUNCHES_PER_LAYER = {"lstm_train_fwd": 6, "lstm_train_bwd": 3}


def _layer_state(states, i: int):
    """Layer i's carry out of the layer-stacked streaming state."""
    return {"norm_time": tuple(s[i] for s in states["norm_time"]),
            "rnn_time": tuple(s[i] for s in states["rnn_time"]),
            "norm_freq": tuple(s[i] for s in states["norm_freq"])}


def _stack_states(per_layer: list) -> dict:
    return {name: tuple(torch.stack([ls[name][j] for ls in per_layer])
                        for j in range(len(per_layer[0][name])))
            for name in ("norm_time", "rnn_time", "norm_freq")}


def run_layers(layers: nn.ModuleList, z: torch.Tensor, cfg: BSRNNConfig,
               frames: Optional[torch.Tensor] = None, fm: Optional[torch.Tensor] = None,
               t: Optional[torch.Tensor] = None, states=None, shard=None):
    """The dual-path stack on (B, T, K, N); ``t`` (B,) is the flow time of
    the conditional network.  ``states``: the layer-stacked streaming carry
    (``models/streaming_causal.init_model_states``'s ``"layers"``); the call
    then returns (z, new_states).  ``shard``: the row sharder of
    ``parallel/model_parallel.py`` (not with ``states``)."""
    if states is not None:
        if shard is not None:
            raise ValueError("a streaming carry runs unsharded")
        new = []
        for i, layer in enumerate(layers):
            z, ls = layer(z, frames, fm, t, _layer_state(states, i))
            new.append(ls)
        return z, _stack_states(new)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            # non-reentrant mode: the first pass records autograd, so it runs
            # the training kernels' forward (BiLSTMTrain, LSTMDirTrain,
            # LSTMRevMaskedTrain) and drops their residuals; the backward
            # recomputes the layer with the same functions and the same row
            # split, as jax.checkpoint runs the custom-VJP forward rules in
            # both passes
            z = checkpoint(layer, z, frames, fm, t, shard=shard, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            z = layer(z, frames, fm, t, shard=shard)
    return z


class BSRNN(nn.Module):
    """Discriminative BSRNN; ``forward(spec, fs, frames=None)`` returns
    mask * spec + residual for a (B, T, F) complex spectrum at rate fs;
    ``forward(spec, fs, states=...)`` processes the next chunk of a stream
    and returns (out, new_states); ``shard`` splits the recurrence rows over
    an mp group (``parallel/model_parallel.py``)."""

    def __init__(self, cfg: BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        self.band_split = BandSplit(cfg)
        self.layers = nn.ModuleList(DualPathLayer(cfg) for _ in range(cfg.num_layer))
        self.mask_decoder = nn.ModuleDict(
            {"mask": MaskDecoderHead(cfg), "residual": MaskDecoderHead(cfg)}
        )

    @tracing.spanned(tracing.MODEL_FORWARD)
    def forward(self, spec: torch.Tensor, fs: int,
                frames: Optional[torch.Tensor] = None, states=None, shard=None):
        B, T, F = spec.shape
        cfg = self.cfg
        K = band_count(cfg.input_dim, cfg.target_fs, fs, F)
        if states is not None:
            if not (cfg.causal and cfg.streaming_norm):
                raise ValueError("streaming state requires causal=True and streaming_norm=True")
            z, bs = self.band_split(spec, K, nstate=states["band_split"])
            z, ls = run_layers(self.layers, z, cfg, states=states["layers"])
            m, ms = self.mask_decoder["mask"](z, K, F, nstate=states["mask"])
            r, rs = self.mask_decoder["residual"](z, K, F, nstate=states["residual"])
            return m * spec + r, {"band_split": bs, "layers": ls, "mask": ms, "residual": rs}
        fm = None if frames is None else dsp.frames_mask(frames, T)
        z = run_layers(self.layers, self.band_split(spec, K, fm), cfg, frames, fm, shard=shard)
        m = self.mask_decoder["mask"](z, K, F, fm)
        r = self.mask_decoder["residual"](z, K, F, fm)
        return m * spec + r


# ---------------------------------------------------------------------------
# Init (the JAX init's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def init_band_split(bs: BandSplit, u) -> None:
    """The JAX init's band-split draws, from the uniform sampler ``u``."""
    C = bs.cfg.num_channel
    for i, sub in enumerate(bs.cfg.subbands):
        cw = 2 * sub
        bs.norm_scale[i, :cw] = 1.0
        bs.w[i, :cw] = u((cw, C), cw)
        bs.b[i] = u((C,), cw)


def init_layers(layers: nn.ModuleList, u, gen: torch.Generator) -> None:
    """The JAX init's dual-path layer draws (t_proj_w ~ N(0, 1))."""
    for layer in layers:
        C = layer.cfg.num_channel
        hdim = 2 * C
        for rnn in (layer.rnn_time, layer.rnn_freq):
            for p in rnn.values():
                p.copy_(u(p.shape, hdim))
        t_out = layer.fc_time_w.shape[0]  # H causal, 2H bidirectional
        layer.fc_time_w.copy_(u(layer.fc_time_w.shape, t_out))
        layer.fc_time_b.copy_(u(layer.fc_time_b.shape, t_out))
        layer.fc_freq_w.copy_(u(layer.fc_freq_w.shape, 4 * C))
        layer.fc_freq_b.copy_(u(layer.fc_freq_b.shape, 4 * C))
        if layer.cfg.with_condition:
            layer.t_proj_w.copy_(torch.randn(layer.t_proj_w.shape, generator=gen))


def uniform_sampler(gen: torch.Generator):
    """u(shape, fan_in): U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from ``gen``."""
    def u(shape, fan_in):
        bound = 1.0 / float(np.sqrt(fan_in))
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound
    return u


def init_bsrnn(cfg: BSRNNConfig, seed: int = 0, device="cuda") -> BSRNN:
    """A randomly initialised model (uniform fan-in bounds as the JAX
    ``init_bsrnn``; the draws differ from JAX's, the distributions do not)
    on the card, or on the CPU where the caller asks for it."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = BSRNN(cfg)
    u = uniform_sampler(gen)
    C = cfg.num_channel
    with torch.no_grad():
        init_band_split(model.band_split, u)
        init_layers(model.layers, u, gen)
        for head in model.mask_decoder.values():
            for i, sub in enumerate(cfg.subbands):
                cw = 2 * sub
                head.w1[i] = u((C, 4 * C), C)
                head.b1[i] = u((4 * C,), C)
                wfull, bfull = u((4 * C, 2 * cw), 4 * C), u((2 * cw,), 4 * C)
                head.wv[i, :, :cw], head.wg[i, :, :cw] = wfull[:, :cw], wfull[:, cw:]
                head.bv[i, :cw], head.bg[i, :cw] = bfull[:cw], bfull[cw:]
    return model.to(device)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def bsrnn_apply(model: BSRNN, spec: torch.Tensor, fs: int,
                frames: Optional[torch.Tensor] = None, states=None, shard=None):
    """Core discriminative BSRNN on a (B, T, F) complex spectrum; ``frames``
    (B,) valid-frame counts select the length-exact path.  ``states`` (a
    causal ``streaming_norm`` model's carry, ``models/streaming_causal``)
    treats ``spec`` as the next chunk of a stream and returns
    (enhanced_spec, new_states).  ``shard``: the row sharder of
    ``parallel/model_parallel.py``."""
    return model(spec, fs, frames, states, shard)


def bsrnn_se_apply(model: BSRNN, stft_cfg: dsp.STFTConfig, noisy: torch.Tensor,
                   fs: int, lengths: Optional[torch.Tensor] = None, shard=None):
    """Waveform SE: noisy (B, T) -> (enhanced (B, T), enhanced_spec).

    With ``lengths`` (B,) the pipeline is length-exact (reflect tail, masked
    norms, masked time recurrence, masked-envelope iSTFT), so
    ``out[b, :lengths[b]]`` does not depend on the padding and the padding
    comes out zero.  ``shard``: the row sharder of
    ``parallel/model_parallel.py``."""
    if lengths is None:
        spec = dsp.stft_encode(noisy, fs, stft_cfg)
        enh = model(spec, fs, shard=shard)
        return dsp.stft_decode(enh, fs, stft_cfg, length=noisy.shape[-1]), enh
    lengths = lengths.to(noisy.device)
    n_fft, _, hop = stft_cfg.geometry(fs)
    spec = dsp.stft_encode(dsp.reflect_tail(noisy, lengths, n_fft // 2), fs, stft_cfg)
    frames = dsp.valid_frames(lengths, n_fft, hop)
    fm = dsp.frames_mask(frames, spec.shape[1])
    enh = model(spec, fs, frames, shard=shard)
    wav = dsp.stft_decode(enh, fs, stft_cfg, length=noisy.shape[-1], frame_mask=fm)
    t = torch.arange(wav.shape[-1], device=wav.device)
    return wav * (t[None, :] < lengths[:, None]), enh
