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
the padding.  The causal, cumulative-norm and conditional variants of the
JAX model are not part of this module yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
from urgent2026_challenge_track1_tpu_torch.ops import lstm as lstm_ops
from urgent2026_challenge_track1_tpu_torch.ops.norms import group_norm, masked_group_norm

__all__ = [
    "BSRNNConfig",
    "subband_layout",
    "band_count",
    "BSRNN",
    "BandSplit",
    "DualPathLayer",
    "MaskDecoderHead",
    "init_bsrnn",
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


def _mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """(..., I) x (I, O) in ``dtype``, result float32 plus the f32 bias."""
    return (x.to(dtype) @ w.to(dtype)).float() + b


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

    def forward(self, spec: torch.Tensor, n_bands: int,
                fm: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, F = spec.shape
        cfg = self.cfg
        gather, chan_mask, _ = _maps_on(cfg.subbands, F, n_bands, spec.device)
        x2 = torch.view_as_real(spec).reshape(B, T, 2 * F)
        x2 = nn.functional.pad(x2, (0, 1))  # the zero slot
        blocks = x2[..., gather]  # (B, T, K, W)
        mask = chan_mask[None, None]
        if fm is not None:
            mask = mask * _frame_mask4(fm)
        h = masked_group_norm(blocks, self.norm_scale[:n_bands][None, None],
                              self.norm_bias[:n_bands][None, None], mask,
                              axes=(1, 3), eps=cfg.norm_eps)
        dt = cfg.dtype
        z = torch.einsum("btkw,kwc->btkc", h.to(dt), self.w[:n_bands].to(dt))
        return z.float() + self.b[:n_bands][None, None]


def _lstm_params(input_size: int, hidden: int) -> nn.ParameterDict:
    p = {}
    for sfx in ("", "_reverse"):
        p[f"w_ih{sfx}"] = _zeros(4 * hidden, input_size)
        p[f"w_hh{sfx}"] = _zeros(4 * hidden, hidden)
        p[f"b_ih{sfx}"] = _zeros(4 * hidden)
        p[f"b_hh{sfx}"] = _zeros(4 * hidden)
    return nn.ParameterDict(p)


class DualPathLayer(nn.Module):
    """One dual-path block on (B, T, K, N): a BLSTM over time (rows B*K),
    then a BLSTM over bands (rows B*T), each with GroupNorm, a linear
    projection and a residual add."""

    def __init__(self, cfg: BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        N = cfg.num_channel
        hdim = 2 * N
        self.norm_time_scale = nn.Parameter(torch.ones(N))
        self.norm_time_bias = _zeros(N)
        self.rnn_time = _lstm_params(N, hdim)
        self.fc_time_w = _zeros(2 * hdim, N)
        self.fc_time_b = _zeros(N)
        self.norm_freq_scale = nn.Parameter(torch.ones(N))
        self.norm_freq_bias = _zeros(N)
        self.rnn_freq = _lstm_params(N, hdim)
        self.fc_freq_w = _zeros(4 * N, N)
        self.fc_freq_b = _zeros(N)

    def _norm(self, z, scale, bias, fm):
        if fm is None:
            return group_norm(z, scale, bias, axes=(1, 2, 3), eps=self.cfg.norm_eps)
        return masked_group_norm(z, scale, bias, _frame_mask4(fm), axes=(1, 2, 3),
                                 eps=self.cfg.norm_eps)

    def forward(self, z: torch.Tensor, frames: Optional[torch.Tensor] = None,
                fm: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, K, N = z.shape
        dt = self.cfg.dtype
        # --- time path (rows b-major: row = b*K + k) ---
        out = self._norm(z, self.norm_time_scale, self.norm_time_bias, fm)
        seq = out.permute(0, 2, 1, 3).reshape(B * K, T, N).to(dt)
        if frames is None:
            h = lstm_ops.bilstm(self.rnn_time, seq)
        else:
            h = lstm_ops.bilstm_masked(self.rnn_time, seq, frames.repeat_interleave(K))
        h = _mm(h, self.fc_time_w, self.fc_time_b, dt)
        z = z + h.reshape(B, K, T, N).permute(0, 2, 1, 3)
        # --- band path (padded frames are independent rows here) ---
        out = self._norm(z, self.norm_freq_scale, self.norm_freq_bias, fm)
        seq = out.reshape(B * T, K, N).to(dt)
        h = lstm_ops.bilstm(self.rnn_freq, seq)
        h = _mm(h, self.fc_freq_w, self.fc_freq_b, dt)
        return z + h.reshape(B, T, K, N)


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

    def forward(self, z: torch.Tensor, n_bands: int, n_bins: int,
                fm: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, K, N = z.shape
        cfg = self.cfg
        _, chan_mask, flat_valid = _maps_on(cfg.subbands, n_bins, n_bands, z.device)
        if fm is None:
            mean = z.mean(dim=(1, 3), keepdim=True)
            var = (z - mean).square().mean(dim=(1, 3), keepdim=True)
        else:
            m4 = _frame_mask4(fm)
            denom = m4.sum(dim=1, keepdim=True) * N
            mean = (z * m4).sum(dim=(1, 3), keepdim=True) / denom
            var = ((z - mean).square() * m4).sum(dim=(1, 3), keepdim=True) / denom
        h = (z - mean) / torch.sqrt(var + cfg.norm_eps)
        h = h * self.norm_scale[:n_bands][None, None] + self.norm_bias[:n_bands][None, None]
        dt = cfg.dtype
        h = torch.einsum("btkc,kcd->btkd", h.to(dt), self.w1[:n_bands].to(dt))
        h = torch.tanh(h.float() + self.b1[:n_bands][None, None]).to(dt)
        val = torch.einsum("btkd,kdw->btkw", h, self.wv[:n_bands].to(dt)).float()
        gate = torch.einsum("btkd,kdw->btkw", h, self.wg[:n_bands].to(dt)).float()
        val = val + self.bv[:n_bands][None, None]
        gate = gate + self.bg[:n_bands][None, None]
        out = val * torch.sigmoid(gate) * chan_mask[None, None]
        cplx = out.reshape(B, T, K, cfg.max_sub, 2)
        cplx = torch.complex(cplx[..., 0], cplx[..., 1]).reshape(B, T, K * cfg.max_sub)
        return cplx[..., flat_valid]


class BSRNN(nn.Module):
    """Discriminative BSRNN; ``forward(spec, fs, frames=None)`` returns
    mask * spec + residual for a (B, T, F) complex spectrum at rate fs."""

    def __init__(self, cfg: BSRNNConfig):
        super().__init__()
        self.cfg = cfg
        self.band_split = BandSplit(cfg)
        self.layers = nn.ModuleList(DualPathLayer(cfg) for _ in range(cfg.num_layer))
        self.mask_decoder = nn.ModuleDict(
            {"mask": MaskDecoderHead(cfg), "residual": MaskDecoderHead(cfg)}
        )

    def forward(self, spec: torch.Tensor, fs: int,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, F = spec.shape
        cfg = self.cfg
        K = band_count(cfg.input_dim, cfg.target_fs, fs, F)
        fm = None if frames is None else dsp.frames_mask(frames, T)
        z = self.band_split(spec, K, fm)
        for layer in self.layers:
            z = layer(z, frames, fm)
        m = self.mask_decoder["mask"](z, K, F, fm)
        r = self.mask_decoder["residual"](z, K, F, fm)
        return m * spec + r


# ---------------------------------------------------------------------------
# Init (the JAX init's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def init_bsrnn(cfg: BSRNNConfig, seed: int = 0, device="cpu") -> BSRNN:
    """A randomly initialised model (uniform fan-in bounds as the JAX
    ``init_bsrnn``; the draws differ from JAX's, the distributions do not)."""
    gen = torch.Generator().manual_seed(seed)
    model = BSRNN(cfg)

    def u(shape, fan_in):
        bound = 1.0 / float(np.sqrt(fan_in))
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    C = cfg.num_channel
    bs = model.band_split
    with torch.no_grad():
        for i, sub in enumerate(cfg.subbands):
            cw = 2 * sub
            bs.norm_scale[i, :cw] = 1.0
            bs.w[i, :cw] = u((cw, C), cw)
            bs.b[i] = u((C,), cw)
        hdim = 2 * C
        for layer in model.layers:
            for rnn in (layer.rnn_time, layer.rnn_freq):
                for p in rnn.values():
                    p.copy_(u(p.shape, hdim))
            layer.fc_time_w.copy_(u(layer.fc_time_w.shape, 2 * hdim))
            layer.fc_time_b.copy_(u(layer.fc_time_b.shape, 2 * hdim))
            layer.fc_freq_w.copy_(u(layer.fc_freq_w.shape, 4 * C))
            layer.fc_freq_b.copy_(u(layer.fc_freq_b.shape, 4 * C))
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
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Core discriminative BSRNN on a (B, T, F) complex spectrum; ``frames``
    (B,) valid-frame counts select the length-exact path."""
    return model(spec, fs, frames)


def bsrnn_se_apply(model: BSRNN, stft_cfg: dsp.STFTConfig, noisy: torch.Tensor,
                   fs: int, lengths: Optional[torch.Tensor] = None):
    """Waveform SE: noisy (B, T) -> (enhanced (B, T), enhanced_spec).

    With ``lengths`` (B,) the pipeline is length-exact (reflect tail, masked
    norms, masked time recurrence, masked-envelope iSTFT), so
    ``out[b, :lengths[b]]`` does not depend on the padding and the padding
    comes out zero."""
    if lengths is None:
        spec = dsp.stft_encode(noisy, fs, stft_cfg)
        enh = model(spec, fs)
        return dsp.stft_decode(enh, fs, stft_cfg, length=noisy.shape[-1]), enh
    lengths = lengths.to(noisy.device)
    n_fft, _, hop = stft_cfg.geometry(fs)
    spec = dsp.stft_encode(dsp.reflect_tail(noisy, lengths, n_fft // 2), fs, stft_cfg)
    frames = dsp.valid_frames(lengths, n_fft, hop)
    fm = dsp.frames_mask(frames, spec.shape[1])
    enh = model(spec, fs, frames)
    wav = dsp.stft_decode(enh, fs, stft_cfg, length=noisy.shape[-1], frame_mask=fm)
    t = torch.arange(wav.shape[-1], device=wav.device)
    return wav * (t[None, :] < lengths[:, None]), enh
