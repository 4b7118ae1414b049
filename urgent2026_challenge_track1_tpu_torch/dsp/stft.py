"""STFT / iSTFT with sampling-rate-scaled geometry (counterpart of
``urgent2026_challenge_track1_tpu/dsp/stft.py``).

Hann-windowed, center-padded (reflect) STFT whose ``n_fft`` / ``win_length``
/ ``hop_length`` rescale with the input rate relative to ``default_fs``, so
one model serves 8-48 kHz; plus the length-exact helpers (``reflect_tail``,
``valid_frames``, ``frames_mask``) and the masked-envelope iSTFT.  Tensors
stay on the device they arrive on; the FFTs are ``torch.fft``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "hann_window",
    "stft",
    "istft",
    "STFTConfig",
    "stft_encode",
    "stft_decode",
    "num_frames",
    "valid_frames",
    "frames_mask",
    "reflect_tail",
    "spec_transform",
    "spec_inverse_transform",
]


@functools.lru_cache(maxsize=64)
def _hann_np(win_length: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(win_length)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def hann_window(win_length: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_hann_np(win_length)).to(device)


def _padded_window(n_fft: int, win_length: int, device) -> torch.Tensor:
    """Hann of ``win_length`` centered in ``n_fft`` (torch.stft semantics)."""
    w = hann_window(win_length, device)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = F.pad(w, (left, n_fft - win_length - left))
    return w


def num_frames(n_samples: int, n_fft: int, hop: int, center: bool = True) -> int:
    if center:
        n_samples = n_samples + 2 * (n_fft // 2)
    return 1 + (n_samples - n_fft) // hop


def valid_frames(lengths: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """Per-sample STFT frame count (B,) -> (B,), the tensor form of
    ``num_frames``."""
    L = lengths.to(torch.int64)
    if center:
        L = L + 2 * (n_fft // 2)
    return 1 + torch.div(L - n_fft, hop, rounding_mode="floor")


def frames_mask(frames: torch.Tensor, n_frames: int,
                dtype=torch.float32) -> torch.Tensor:
    """Frame counts (B,) -> validity mask (B, n_frames)."""
    t = torch.arange(n_frames, device=frames.device)
    return (t[None, :] < frames[:, None]).to(dtype)


def reflect_tail(x: torch.Tensor, lengths: torch.Tensor, margin: int) -> torch.Tensor:
    """Rewrite the padding of (B, T) rows so a later center-STFT sees exactly
    what an exact-length STFT would: samples [L, L+margin) become the
    reflection of the signal around L-1, everything after is zero."""
    T = x.shape[-1]
    L = lengths.to(x.device, torch.int64)[:, None]
    t = torch.arange(T, device=x.device)[None, :]
    mirror = torch.clamp(2 * L - 2 - t, 0, T - 1)
    idx = torch.where((t >= L) & (t < L + margin), mirror, t.expand_as(mirror))
    out = torch.gather(x, -1, idx)
    return torch.where(t < L + margin, out, torch.zeros_like(out))


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, center: bool = True,
         onesided: bool = True, normalized: bool = False) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_bins) complex; torch.stft(center=True,
    pad_mode="reflect", periodic Hann, return_complex=True) with the frames
    axis before the bins."""
    win_length = win_length or n_fft
    window = _padded_window(n_fft, win_length, x.device).to(x.dtype)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1) if onesided else torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / float(np.sqrt(n_fft))
    return spec.reshape(lead + spec.shape[-2:])


@functools.lru_cache(maxsize=256)
def _ola_envelope(n_frames: int, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    """sum_k w^2[t - k*hop] (float64 sums), clamped away from zero."""
    w = _hann_np(win_length)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = np.pad(w, (left, n_fft - win_length - left))
    env = np.zeros(hop * (n_frames - 1) + n_fft, dtype=np.float64)
    wsq = w.astype(np.float64) ** 2
    for k in range(n_frames):
        env[k * hop : k * hop + n_fft] += wsq
    return np.maximum(env, 1e-11).astype(np.float32)


def _ola(frames: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Overlap-add (..., n_frames, n_fft) -> (..., hop*(n_frames-1)+n_fft),
    for any hop (also the odd 22.05 kHz geometry, n_fft 441 / hop 220)."""
    n_frames = frames.shape[-2]
    total = hop_length * (n_frames - 1) + n_fft
    lead = frames.shape[:-2]
    cols = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)  # (B, n_fft, L)
    out = F.fold(cols, output_size=(1, total), kernel_size=(1, n_fft),
                 stride=(1, hop_length))
    return out.reshape(lead + (total,))


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, center: bool = True,
          length: Optional[int] = None,
          frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.istft-compatible inverse STFT.  spec: (..., n_frames, n_bins).

    ``frame_mask`` (..., n_frames) restricts the synthesis to the masked
    frames: they contribute neither signal nor window energy, so the valid
    region equals the iSTFT of the valid frames alone."""
    win_length = win_length or n_fft
    window = _padded_window(n_fft, win_length, spec.device)
    n_frames = spec.shape[-2]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    total = hop_length * (n_frames - 1) + n_fft
    if frame_mask is not None:
        frames = frames * frame_mask[..., None]
    out = _ola(frames, n_fft, hop_length)
    if frame_mask is None:
        env = torch.from_numpy(_ola_envelope(n_frames, n_fft, hop_length, win_length))
        env = env.to(spec.device)
    else:
        wsq = (window ** 2) * frame_mask[..., None]  # per-row envelope
        env = torch.clamp(_ola(wsq, n_fft, hop_length), min=1e-11)
    out = out / env
    if center:
        # drop the n_fft//2 leading pad; keep the tail until ``length`` (an
        # odd n_fft would lose valid samples to a symmetric trim)
        start = n_fft // 2
        out = out[..., start:] if length is not None else out[..., start : total - start]
    if length is not None:
        out = out[..., :length]
        if out.shape[-1] < length:
            out = F.pad(out, (0, length - out.shape[-1]))
    return out


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Geometry + spec transform (espnet STFTEncoder/Decoder semantics);
    sizes are defined at ``default_fs`` and rescale by floor division, e.g.
    960 * 22050 // 48000 = 441."""

    n_fft: int = 960
    hop_length: int = 480
    win_length: Optional[int] = None
    default_fs: int = 48000
    center: bool = True
    onesided: bool = True
    normalized: bool = False
    spec_transform_type: str = "none"  # "none" | "exponent" | "log"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5

    def geometry(self, fs: int) -> tuple[int, int, int]:
        """(n_fft, win_length, hop_length) for sampling rate ``fs``."""
        win = self.win_length or self.n_fft
        if fs == self.default_fs:
            return self.n_fft, win, self.hop_length
        return (self.n_fft * fs // self.default_fs, win * fs // self.default_fs,
                self.hop_length * fs // self.default_fs)

    def n_bins(self, fs: int) -> int:
        n_fft, _, _ = self.geometry(fs)
        return n_fft // 2 + 1 if self.onesided else n_fft

    def frames(self, n_samples: int, fs: int) -> int:
        n_fft, _, hop = self.geometry(fs)
        return num_frames(n_samples, n_fft, hop, self.center)


def spec_transform(spec: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Forward spectral compression (espnet STFTEncoder.spec_transform_func)."""
    if cfg.spec_transform_type == "exponent":
        if cfg.spec_abs_exponent != 1.0:
            mag = spec.abs()
            safe = torch.where(mag > 0, mag, torch.ones_like(mag))
            scale = torch.where(mag > 0, safe ** (cfg.spec_abs_exponent - 1.0),
                                torch.zeros_like(mag))
            spec = spec * scale
        spec = spec * cfg.spec_factor
    elif cfg.spec_transform_type == "log":
        mag = spec.abs()
        scale = torch.where(mag > 0, torch.log1p(mag) / torch.clamp(mag, min=1e-12),
                            torch.ones_like(mag))
        spec = spec * scale
    elif cfg.spec_transform_type not in ("none", None):
        raise ValueError(cfg.spec_transform_type)
    return spec


def spec_inverse_transform(spec: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Inverse spectral compression (espnet STFTDecoder.spec_back)."""
    if cfg.spec_transform_type == "exponent":
        spec = spec / cfg.spec_factor
        if cfg.spec_abs_exponent != 1.0:
            mag = spec.abs()
            safe = torch.where(mag > 0, mag, torch.ones_like(mag))
            scale = torch.where(mag > 0, safe ** (1.0 / cfg.spec_abs_exponent - 1.0),
                                torch.zeros_like(mag))
            spec = spec * scale
    elif cfg.spec_transform_type == "log":
        mag = spec.abs()
        scale = torch.where(mag > 0, torch.expm1(mag) / torch.clamp(mag, min=1e-12),
                            torch.ones_like(mag))
        spec = spec * scale
    elif cfg.spec_transform_type not in ("none", None):
        raise ValueError(cfg.spec_transform_type)
    return spec


def stft_encode(x: torch.Tensor, fs: int, cfg: STFTConfig) -> torch.Tensor:
    """Waveform (..., T) -> compressed complex spectrum (..., frames, bins)."""
    n_fft, win, hop = cfg.geometry(fs)
    spec = stft(x, n_fft, hop, win_length=win, center=cfg.center,
                onesided=cfg.onesided, normalized=cfg.normalized)
    return spec_transform(spec, cfg)


def stft_decode(spec: torch.Tensor, fs: int, cfg: STFTConfig,
                length: Optional[int] = None,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compressed complex spectrum (..., frames, bins) -> waveform (..., T)."""
    spec = spec_inverse_transform(spec, cfg)
    n_fft, win, hop = cfg.geometry(fs)
    return istft(spec, n_fft, hop, win_length=win, center=cfg.center,
                 length=length, frame_mask=frame_mask)
