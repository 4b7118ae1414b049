"""Training losses: multi-resolution L1 spectral loss and SI-SNR
(counterpart of ``train/losses.py``).

* ``multi_res_l1_spec_loss``: espnet's ``MultiResL1SpecLoss(window_sz=[256,
  512, 768, 1024], eps=1e-6, normalize_variance=True, time_domain_weight=
  0.5)``: variance-normalise target and estimate (Bessel std), scale-align
  the estimate by least squares, then 0.5 * mean |time error| + 0.5 * the
  mean over windows of mean | |STFT(est)| - |STFT(tgt)| |.
* ``si_snr``: scale-invariant SNR in dB with zero-mean pre-processing;
  ``si_snr_loss`` is its negative.

Both return shape (B,).  With ``lengths`` (B,) every mean, std and inner
product runs over the valid samples only and the STFT terms over the valid
frames only, with the exact-length reflect padding emulated at each
utterance's end, so the value does not depend on the bucket padding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp

__all__ = [
    "multi_res_l1_spec_loss",
    "si_snr_loss",
    "si_snr",
    "length_mask",
    "frame_mask",
    "valid_frames",
]


def length_mask(lengths: torch.Tensor, T: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) sample counts -> (B, T) 1/0 validity mask."""
    t = torch.arange(T, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def valid_frames(lengths: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """Per-sample STFT frame count for exact-length signals (B,) -> (B,)."""
    return dsp.valid_frames(lengths, n_fft, hop, center)


def frame_mask(lengths: torch.Tensor, n_fft: int, hop: int, n_frames: int,
               center: bool = True, dtype=torch.float32) -> torch.Tensor:
    """(B,) sample counts -> (B, n_frames) STFT-frame validity mask."""
    return dsp.frames_mask(valid_frames(lengths, n_fft, hop, center), n_frames, dtype)


def _masked_std(x: torch.Tensor, mask: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """torch.std semantics (Bessel, ddof=1) over the valid samples only."""
    mean = torch.sum(x * mask, dim=-1, keepdim=True) / L
    var = torch.sum(torch.square(x - mean) * mask, dim=-1, keepdim=True) / (L - 1.0)
    return torch.sqrt(var)


def multi_res_l1_spec_loss(
    target: torch.Tensor,
    estimate: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    window_sz: Sequence[int] = (256, 512, 768, 1024),
    eps: float = 1.0e-6,
    time_domain_weight: float = 0.5,
    normalize_variance: bool = True,
    eps_mag: float = 1.0e-6,
) -> torch.Tensor:
    """Multi-resolution L1 spectral + time L1 loss.  (B, T) -> (B,)."""
    target = target.float()
    estimate = estimate.float()
    T = target.shape[-1]
    if lengths is None:
        mask = torch.ones_like(target)
        L = torch.full(target.shape[:-1] + (1,), float(T), device=target.device)
    else:
        lengths = lengths.to(target.device)
        mask = length_mask(lengths, T)
        L = lengths.float()[:, None]
        # the model's output past each utterance's end is garbage: zero it so
        # every sum (and the STFT frames) ignores the padding
        target = target * mask
        estimate = estimate * mask
    if normalize_variance:
        target = target / _masked_std(target, mask, L)
        estimate = estimate / _masked_std(estimate, mask, L)
    scale = torch.sum(estimate * target, dim=-1, keepdim=True) / (
        torch.sum(estimate * estimate, dim=-1, keepdim=True) + eps)
    est = estimate * scale
    time_loss = torch.sum(torch.abs(est - target) * mask, dim=-1) / L[..., 0]
    if not window_sz:
        return time_loss
    if lengths is not None:
        # the exact-length reflect padding torch.stft applies at each
        # utterance's right edge
        margin = max(window_sz) // 2
        target = dsp.reflect_tail(target, lengths, margin)
        est = dsp.reflect_tail(est, lengths, margin)
    spec_loss = torch.zeros_like(time_loss)
    for w in window_sz:
        st = dsp.stft(target, w, w // 2)
        se = dsp.stft(est, w, w // 2)
        mt = torch.sqrt(torch.square(st.real) + torch.square(st.imag) + eps_mag)
        me = torch.sqrt(torch.square(se.real) + torch.square(se.imag) + eps_mag)
        diff = torch.abs(me - mt)
        if lengths is None:
            spec_loss = spec_loss + torch.mean(diff, dim=(-2, -1))
        else:
            fm = frame_mask(lengths, w, w // 2, diff.shape[-2])
            nf = valid_frames(lengths, w, w // 2).float()
            spec_loss = spec_loss + torch.sum(diff * fm[..., None], dim=(-2, -1)) / (
                nf * diff.shape[-1])
    return time_domain_weight * time_loss + (1.0 - time_domain_weight) * (
        spec_loss / len(window_sz))


def si_snr(ref: torch.Tensor, est: torch.Tensor, lengths: Optional[torch.Tensor] = None,
           zero_mean: bool = True, eps: float = 1.0e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB.  (B, T) x (B, T) -> (B,)."""
    ref = ref.float()
    est = est.float()
    if lengths is not None:
        lengths = lengths.to(ref.device)
        mask = length_mask(lengths, ref.shape[-1])
        L = lengths.float()[:, None]
        ref = ref * mask
        est = est * mask
        if zero_mean:
            ref = (ref - torch.sum(ref, dim=-1, keepdim=True) / L) * mask
            est = (est - torch.sum(est, dim=-1, keepdim=True) / L) * mask
    elif zero_mean:
        ref = ref - torch.mean(ref, dim=-1, keepdim=True)
        est = est - torch.mean(est, dim=-1, keepdim=True)
    alpha = torch.sum(est * ref, dim=-1, keepdim=True) / (
        torch.sum(ref * ref, dim=-1, keepdim=True) + eps)
    s_target = alpha * ref
    e_noise = est - s_target
    ratio = torch.sum(s_target * s_target, dim=-1) / (torch.sum(e_noise * e_noise, dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def si_snr_loss(ref: torch.Tensor, est: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """espnet SISNRLoss semantics: the negative SI-SNR (a loss), shape (B,)."""
    return -si_snr(ref, est, lengths)
