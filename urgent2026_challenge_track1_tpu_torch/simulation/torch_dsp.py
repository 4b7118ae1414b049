"""The dynamic-mixing render on the device, in torch (counterpart of
``simulation/jax_dsp.py``).

A whole (fs, T) bucket is rendered at once on the caller's device, from
(B, T) float32 tensors and a small struct of per-item parameters drawn on
the host (``data/dynamic_device.py``): the 70 Hz high-pass, the reverb (the
full RIR for the noisy path, its first 50 ms for the target), SNR mixing
over the non-silent power, the bandwidth limitation, clipping and packet
loss in each item's sampled order, and the joint 0.9 peak normalisation.
The FFTs are torch's (cuFFT on the card), a library call, as the JAX
package leaves them to XLA; there is no hand-written kernel here.

The deviations from the host renderer (``simulation/dsp.py``) are the JAX
package's: the bandwidth limitation is a brickwall mask in the frequency
domain (the host resamples down and up); quantiles interpolate linearly
(numpy's default); the wind-noise compressor and the codec round-trip stay
on the host, and such items arrive rendered.

Quantiles are taken per row by a sort and ``jnp.quantile``'s linear
interpolation in float32 (``torch.quantile`` refuses inputs over 2^24
elements and takes one q for every row).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from urgent2026_challenge_track1_tpu_torch.simulation.dsp import _high_pass_taps

__all__ = [
    "fft_convolve",
    "detect_non_silence_mask",
    "mix_at_snr",
    "early_rir_mask",
    "quantile_clip",
    "apply_packet_loss",
    "bandwidth_mask_apply",
    "is_prefix_mask",
    "bandwidth_lowpass",
    "high_pass",
    "render_batch",
]


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(n)))


def fft_convolve(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Linear convolution truncated to len(x): (..., T) conv (..., L)."""
    T = x.shape[-1]
    nfft = _next_pow2(T + h.shape[-1] - 1)
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft), nfft)
    return y[..., :T]


def detect_non_silence_mask(x: torch.Tensor, threshold: float = 0.01,
                            frame_length: int = 1024, frame_shift: int = 512,
                            lengths=None) -> torch.Tensor:
    """Boolean VAD mask (B, T), espnet's detect_non_silence.  With
    ``lengths`` (B,) only frames inside each item's extent enter the
    relative threshold, samples past the last valid frame take its decision,
    padding is False, and an item shorter than one frame is all True (as the
    host renderer treats such a signal)."""
    T = x.shape[-1]
    if T < frame_length:
        return torch.ones_like(x, dtype=torch.bool)
    n = (T - frame_length) // frame_shift + 1
    power = x.unfold(-1, frame_length, frame_shift).square().mean(dim=-1)  # (B, n)
    if lengths is None:
        fvalid = torch.ones_like(power, dtype=torch.bool)
    else:
        lengths = torch.as_tensor(lengths, device=x.device)
        starts = frame_shift * torch.arange(n, device=x.device)
        fvalid = starts[None, :] + frame_length <= lengths[:, None]
    n_valid = torch.clamp(fvalid.sum(dim=-1, keepdim=True), min=1)
    mean_power = (power * fvalid).sum(dim=-1, keepdim=True) / n_valid
    detect = (power / torch.clamp(mean_power, min=1e-30) > threshold) & fvalid
    detect = torch.where(mean_power > 0, detect, fvalid)
    det = detect.repeat_interleave(frame_shift, dim=-1)
    det = torch.cat([det, det[..., -1:].expand(*det.shape[:-1], T - det.shape[-1])], dim=-1)
    if lengths is not None:
        nv = fvalid.sum(dim=-1)
        last = torch.gather(detect, -1, torch.clamp(nv - 1, min=0)[:, None])
        pos = torch.arange(T, device=x.device)[None, :]
        det = torch.where(pos < (nv * frame_shift)[:, None], det, last)
        det = torch.where((nv == 0)[:, None], torch.ones_like(det), det)
        det = det & (pos < lengths[:, None])
    return det


def mix_at_snr(speech: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor, lengths=None):
    """(B, T) mix at each item's SNR over the VAD-masked powers.  Returns
    (noisy, scaled_noise)."""
    sm = detect_non_silence_mask(speech, lengths=lengths)
    nm = detect_non_silence_mask(noise, lengths=lengths)
    p_s = (speech.square() * sm).sum(dim=-1) / torch.clamp(sm.sum(dim=-1), min=1)
    p_n = (noise.square() * nm).sum(dim=-1) / torch.clamp(nm.sum(dim=-1), min=1)
    scale = 10 ** (-snr_db / 20) * torch.sqrt(p_s) / torch.sqrt(torch.clamp(p_n, min=1e-10))
    scaled = scale[:, None] * noise
    return speech + scaled, scaled


def early_rir_mask(rir: torch.Tensor, fs: int, early_sec: float = 0.05,
                   level_ratio: float = 0.1) -> torch.Tensor:
    """1 for the 50 ms from the direct-path onset (the first sample above
    ``level_ratio`` of the peak), else 0."""
    abs_h = rir.abs()
    over = abs_h > level_ratio * abs_h.amax(dim=-1, keepdim=True)
    start = torch.argmax(over.to(torch.uint8), dim=-1)  # the first True, as jnp.argmax
    stop = start + int(early_sec * fs)
    pos = torch.arange(rir.shape[-1], device=rir.device)
    return (pos[None, :] < stop[:, None]).to(rir.dtype)


def _row_quantile(sorted_x: torch.Tensor, q: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The q[b] quantile of the first counts[b] entries of each sorted row,
    ``jnp.quantile``'s linear interpolation in float32."""
    pos = q.float() * (counts.float() - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    top = counts.float() - 1
    low = torch.minimum(torch.clamp(low, min=0), top).long()
    high = torch.minimum(torch.clamp(high, min=0), top).long()
    lv = torch.gather(sorted_x, -1, low[:, None])[:, 0]
    hv = torch.gather(sorted_x, -1, high[:, None])[:, 0]
    return lv.float() * lw + hv.float() * hw


def quantile_clip(x: torch.Tensor, min_q: torch.Tensor, max_q: torch.Tensor,
                  lengths=None) -> torch.Tensor:
    """Per-item quantile clipping.  With ``lengths`` (B,) the quantiles are
    taken over each item's extent only, and the padding is left as it was."""
    B, T = x.shape
    if lengths is None:
        s = torch.sort(x, dim=-1).values
        n = torch.full((B,), T, device=x.device)
        lo, hi = _row_quantile(s, min_q, n), _row_quantile(s, max_q, n)
        return torch.clamp(x, lo[:, None], hi[:, None])
    lengths = torch.as_tensor(lengths, device=x.device)
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    s = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))), dim=-1).values
    lo, hi = _row_quantile(s, min_q, lengths), _row_quantile(s, max_q, lengths)
    return torch.where(valid, torch.clamp(x, lo[:, None], hi[:, None]), x)


def bandwidth_mask_apply(x: torch.Tensor, bw_mask: torch.Tensor) -> torch.Tensor:
    """Per-item brickwall low-pass by a (B, T//2+1) prefix-of-ones mask (1 on
    the bins below the cut, 0 above; ``is_prefix_mask``).  At a T that is
    not a power of two the transform runs on the next power-of-two grid
    (zero-padded, cut back to T), with the mask rebuilt there from its count
    of ones, as in the JAX package."""
    T = x.shape[-1]
    if T & (T - 1) == 0:
        return torch.fft.irfft(torch.fft.rfft(x, T) * bw_mask, T)
    nfft = _next_pow2(T)
    cut = bw_mask.sum(dim=-1, keepdim=True)
    j = torch.arange(nfft // 2 + 1, dtype=torch.float32, device=x.device)[None, :]
    mask_n = (j * (T / nfft) < cut).to(x.dtype)
    return torch.fft.irfft(torch.fft.rfft(x, nfft) * mask_n, nfft)[..., :T]


def is_prefix_mask(mask) -> bool:
    """True iff every row of ``mask`` is a non-increasing 1/0 mask, the
    ``bandwidth_mask_apply`` contract (a host check)."""
    m = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    return bool(np.all((m == 0.0) | (m == 1.0)) and np.all(np.diff(m, axis=-1) <= 0))


def apply_packet_loss(x: torch.Tensor, packet_mask: torch.Tensor) -> torch.Tensor:
    """Zero the lost packets: ``packet_mask`` (B, n_packets), 1 = keep; each
    packet T // n_packets samples, the tail past the last packet kept."""
    T = x.shape[-1]
    mask = packet_mask.repeat_interleave(T // packet_mask.shape[-1], dim=-1)
    mask = F.pad(mask, (0, T - mask.shape[-1]), value=1.0)
    return x * mask


@functools.lru_cache(maxsize=64)
def _lowpass_taps(fs: int, fs_new: int, numtaps: int = 257) -> np.ndarray:
    cutoff = (fs_new / 2) / (fs / 2)
    return scipy.signal.firwin(numtaps, cutoff * 0.95, window=("kaiser", 9.0)).astype(np.float32)


def bandwidth_lowpass(x: torch.Tensor, fs: int, fs_new: int) -> torch.Tensor:
    """An anti-alias FIR low-pass at the target Nyquist, zero-phase."""
    if fs_new >= fs:
        return x
    taps = torch.from_numpy(_lowpass_taps(fs, fs_new)).to(x.device)
    pad = taps.shape[-1] // 2
    y = fft_convolve(F.pad(x, (0, pad)), taps[None, :])
    return y[..., pad : pad + x.shape[-1]]


@functools.lru_cache(maxsize=16)
def _hp_taps(fs: int) -> np.ndarray:
    return _high_pass_taps(fs).astype(np.float32)


def high_pass(x: torch.Tensor, fs: int) -> torch.Tensor:
    """Zero-phase 70 Hz high-pass: the edge-padded signal filtered forward,
    then again time-reversed (filtfilt)."""
    taps = torch.from_numpy(_hp_taps(fs)).to(x.device)[None, :]
    pad = taps.shape[-1]
    xp = F.pad(x[:, None], (pad, pad), mode="replicate")[:, 0]  # replicate wants (B, C, T)
    T = xp.shape[-1]
    y = fft_convolve(F.pad(xp, (0, pad)), taps)[..., :T]
    y = fft_convolve(F.pad(y.flip(-1), (0, pad)), taps)[..., :T].flip(-1)
    return y[..., pad : pad + x.shape[-1]]


def render_batch(speech, noise, rir, snr_db, use_rir, clip_lo, clip_hi, packet_mask, bw_mask,
                 fs: int, highpass: bool = True, lengths=None, aug_order=None):
    """Render a (B, T) bucket: returns (clean_target, noisy), jointly peak
    normalised to 0.9.

    ``speech`` and ``noise`` (B, T) (the noise fitted to T), ``rir`` (B, L)
    (an identity impulse where no reverb applies), ``snr_db``, ``use_rir``,
    ``clip_lo`` and ``clip_hi`` (B,), ``packet_mask`` (B, n_packets), 1 =
    keep, ``bw_mask`` (B, T//2+1), 1 = pass, ``lengths`` (B,) for the masked
    VAD and quantiles.  ``aug_order`` (B, 3) applies the three augmentations
    (0 bandwidth, 1 clipping, 2 packet loss) in each item's sampled order:
    at each of 3 steps all three run on the batch and a per-item gather
    keeps the one that step selects; an op absent from an item's recipe has
    identity parameters.  None keeps bandwidth -> clipping -> packet loss."""
    if highpass:
        speech = high_pass(speech, fs)
    full = fft_convolve(speech, rir)
    early = fft_convolve(speech, rir * early_rir_mask(rir, fs))
    u = use_rir[:, None]
    noisy = u * full + (1 - u) * speech
    target = u * early + (1 - u) * speech
    noisy, scaled_noise = mix_at_snr(noisy, noise, snr_db, lengths=lengths)

    def op_bw(x):
        return bandwidth_mask_apply(x, bw_mask)

    def op_clip(x):
        return quantile_clip(x, clip_lo, clip_hi, lengths=lengths)

    def op_pl(x):
        return apply_packet_loss(x, packet_mask)

    if aug_order is None:
        noisy = op_pl(op_clip(op_bw(noisy)))
    else:
        rows = torch.arange(speech.shape[0], device=speech.device)
        order = aug_order.long()
        for k in range(3):
            cands = torch.stack([op_bw(noisy), op_clip(noisy), op_pl(noisy)])
            noisy = cands[order[:, k], rows]
    peak = torch.maximum(noisy.abs().amax(dim=-1),
                         torch.maximum(target.abs().amax(dim=-1),
                                       scaled_noise.abs().amax(dim=-1)))
    scale = 0.9 / torch.clamp(peak, min=1e-6)
    return target * scale[:, None], noisy * scale[:, None]
