"""Host-side simulation DSP in numpy/scipy (counterpart of
``simulation/dsp.py``).

The non-silence detector, the 70 Hz high-pass, resampling with the five
``res_type`` methods (windowed-sinc polyphase filters for soxr_hq /
kaiser_best / kaiser_fast, scipy's default polyphase filter, FFT), reverb
with its early-RIR target, SNR mixing, wind-noise mixing through the
sidechain compressor (``utils/native.py``), and the augmentations
bandwidth limitation, clipping and packet loss.  Each function is the JAX
package's, line for line, so one seed gives the same audio in both.

Codec augmentation (mp3/ogg through libavcodec) is not ported yet (ROADMAP
A16b): ``codecs_available()`` is False, and the dynamic-mixing dataset
drops "codec" from its pool and renormalises the weights, the JAX
package's rule for a machine without a codec backend.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import scipy.signal

from urgent2026_challenge_track1_tpu_torch.utils.native import sidechain_compress

__all__ = [
    "detect_non_silence",
    "high_pass_filter",
    "resample",
    "add_reverberation",
    "estimate_early_rir",
    "mix_noise",
    "wind_noise_mix",
    "bandwidth_limitation",
    "clipping",
    "packet_loss_apply",
    "codecs_available",
    "SAMPLE_RATES",
    "RESAMPLE_METHODS",
]

SAMPLE_RATES = (8000, 16000, 22050, 24000, 32000, 44100, 48000)
RESAMPLE_METHODS = ("kaiser_best", "kaiser_fast", "scipy", "polyphase")


# ---------------------------------------------------------------------------
# VAD mask (espnet2.train.preprocessor.detect_non_silence semantics)
# ---------------------------------------------------------------------------


def detect_non_silence(
    x: np.ndarray,
    threshold: float = 0.01,
    frame_length: int = 1024,
    frame_shift: int = 512,
    window: str = "boxcar",
) -> np.ndarray:
    """Power-based VAD boolean mask, same shape as x (..., Time)."""
    if x.shape[-1] < frame_length:
        return np.full(x.shape, True, dtype=bool)
    if x.dtype.kind == "i":
        x = x.astype(np.float64)
    framed = np.lib.stride_tricks.sliding_window_view(x, frame_length, axis=-1)[
        ..., ::frame_shift, :
    ].copy()
    framed *= scipy.signal.get_window(window, frame_length).astype(framed.dtype)
    power = (framed**2).mean(axis=-1)
    mean_power = power.mean(axis=-1, keepdims=True)
    if np.all(mean_power == 0):
        return np.full(x.shape, True, dtype=bool)
    detect_frames = power / mean_power > threshold
    detects = np.broadcast_to(
        detect_frames[..., None], detect_frames.shape + (frame_shift,)
    ).reshape(*detect_frames.shape[:-1], -1)
    pad = x.shape[-1] - detects.shape[-1]
    return np.pad(detects, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="edge")


# ---------------------------------------------------------------------------
# 70 Hz high-pass (simulate_data_from_param.py:29-56)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _high_pass_taps(fs: int, cutoff=70, transition_width=15, attenuation=10):
    nyq = 0.5 * fs
    stop = cutoff - transition_width
    if stop < 0:
        stop = 0
        transition_width = cutoff
    pass_start = min(cutoff, nyq)
    freq_points = [0, stop / nyq, pass_start / nyq, 1.0]
    gain_points = [0, 0, 1, 1]
    numtaps = int((attenuation * fs) / (22 * transition_width))
    numtaps = max(numtaps, 101)
    if numtaps % 2 == 0:
        numtaps += 1
    return scipy.signal.firwin2(numtaps, freq=freq_points, gain=gain_points)


def high_pass_filter(x: np.ndarray, fs: int) -> np.ndarray:
    """Zero-phase 70 Hz high-pass of the clean source (renderer :460-461)."""
    taps = _high_pass_taps(fs)
    return scipy.signal.filtfilt(taps, 1.0, x.reshape(-1)).reshape(x.shape)


# ---------------------------------------------------------------------------
# Resampling (librosa/resampy/soxr replacements)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _kaiser_fir(up: int, down: int, num_zeros: int, beta: float, rolloff: float):
    """Windowed-sinc anti-aliasing filter for polyphase resampling.

    NOTE: scipy.signal.resample_poly multiplies the window by ``up`` itself
    (``h *= up`` in its source, also for user-provided arrays) — the filter
    must therefore be unity-gain here or upsampling gains ``up``x."""
    max_rate = max(up, down)
    cutoff = rolloff / max_rate  # normalized to upsampled Nyquist
    half = num_zeros * max_rate
    n = 2 * half + 1
    return scipy.signal.firwin(n, cutoff, window=("kaiser", beta))


def resample(x: np.ndarray, orig_sr: int, target_sr: int, res_type: str = "soxr_hq"):
    """(..., T) resampler covering the reference's res_type vocabulary:
    kaiser_best / kaiser_fast (resampy-equivalent windowed sinc),
    scipy (FFT), polyphase (scipy default), soxr_hq (high-quality default)."""
    if orig_sr == target_sr:
        return x
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if res_type in ("soxr_hq", "kaiser_best"):
        h = _kaiser_fir(up, down, 64, 14.769656459379492, 0.9475937167399596)
        return scipy.signal.resample_poly(x, up, down, axis=-1, window=h)
    if res_type == "kaiser_fast":
        h = _kaiser_fir(up, down, 16, 8.555504641634386, 0.85)
        return scipy.signal.resample_poly(x, up, down, axis=-1, window=h)
    if res_type == "polyphase":
        return scipy.signal.resample_poly(x, up, down, axis=-1)
    if res_type in ("scipy", "fft"):
        n_out = int(math.ceil(x.shape[-1] * target_sr / orig_sr))
        return scipy.signal.resample(x, n_out, axis=-1)
    raise ValueError(f"unknown res_type {res_type}")


# ---------------------------------------------------------------------------
# Reverb (renderer :220-230; rir_utils.py)
# ---------------------------------------------------------------------------


def add_reverberation(speech: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """Full convolution truncated to the dry length.  (1,T) x (C,L) -> (C,T)."""
    rev = scipy.signal.convolve(speech, rir, mode="full")
    return rev[:, : speech.shape[1]]


def get_rir_start_sample(h: np.ndarray, level_ratio: float = 1e-1) -> int:
    """First sample exceeding level_ratio * max |h| (sms_wsj heuristic)."""
    assert level_ratio < 1, level_ratio
    if h.ndim > 1:
        return int(min(get_rir_start_sample(h_, level_ratio) for h_ in h))
    abs_h = np.abs(h)
    max_index = int(np.argmax(abs_h))
    larger = abs_h[: max_index + 1] > level_ratio * abs_h[max_index]
    return int(np.argmax(larger))


def estimate_early_rir(rir: np.ndarray, early_rir_sec: float = 0.05, fs: int = 48000):
    """Keep 50 ms after the direct-path onset, zero the tail (rir_utils.py:4-21)."""
    starts = np.array([get_rir_start_sample(h) for h in rir])
    stops = starts + int(early_rir_sec * fs)
    early = rir.copy()
    for i in range(rir.shape[0]):
        early[i, stops[i] :] = 0
    return early


# ---------------------------------------------------------------------------
# Noise mixing (renderer :95-126)
# ---------------------------------------------------------------------------


def _fit_noise_length(noise: np.ndarray, T: int, rng) -> np.ndarray:
    L = noise.shape[-1]
    if L < T:
        offset = rng.integers(0, T - L)
        return np.pad(noise, [(0, 0), (offset, T - L - offset)], mode="wrap")
    if L > T:
        offset = rng.integers(0, L - T)
        return noise[:, offset : offset + T]
    return noise


def mix_noise(speech: np.ndarray, noise: np.ndarray, snr: float = 5.0, rng=None):
    """SNR mixing on non-silent powers.  Returns (noisy, scaled_noise)."""
    noise = _fit_noise_length(noise, speech.shape[-1], rng)
    power_speech = (speech[detect_non_silence(speech)] ** 2).mean()
    power_noise = (noise[detect_non_silence(noise)] ** 2).mean()
    scale = 10 ** (-snr / 20) * np.sqrt(power_speech) / np.sqrt(max(power_noise, 1e-10))
    noise = scale * noise
    return speech + noise, noise


def wind_noise_mix(
    speech: np.ndarray,
    noise: np.ndarray,
    fs: int,
    threshold: float,
    ratio: float,
    attack: float,
    release: float,
    sc_gain: float,
    clipping: bool,
    clipping_threshold: float,
    snr: float,
    rng=None,
):
    """Wind-noise mixing with sidechain ducking (renderer :129-217).

    The reference round-trips through ffmpeg
    ("[0][sc]sidechaincompress...[compr][mix]amix"); here the compressor is
    the native kernel and amix's 1/n input normalization is applied directly.
    The reference's pre-ffmpeg 0.9 peak pre-scale cancels (it divides the mix
    by the same scale afterwards) except inside the compressor's nonlinear
    threshold — so the same pre-scale is applied around the compressor.
    Returns (noisy (1,T), scaled_noise (1,T)).
    """
    noise = _fit_noise_length(noise, speech.shape[-1], rng)
    power_speech = (speech[detect_non_silence(speech)] ** 2).mean()
    power_noise = (noise[detect_non_silence(noise)] ** 2).mean()
    scale = 10 ** (-snr / 20) * np.sqrt(power_speech) / np.sqrt(max(power_noise, 1e-10))
    noise = scale * noise

    prescale = 0.9 / max(np.max(np.abs(speech)), np.max(np.abs(noise)), 1e-12)
    sp = speech[0] * prescale
    nz = noise[0] * prescale
    compressed = sidechain_compress(
        sp, nz, fs, threshold=threshold, ratio=ratio,
        attack_ms=attack, release_ms=release, level_sc=sc_gain,
    )
    mix = (compressed + nz) / 2.0  # ffmpeg amix: each input scaled by 1/n
    mix = mix / prescale
    noise_out = nz / prescale
    if clipping:
        mix = np.maximum(clipping_threshold * np.min(mix), mix)
        mix = np.minimum(clipping_threshold * np.max(mix), mix)
    return mix[None], noise_out[None]


# ---------------------------------------------------------------------------
# Augmentations (renderer :233-341)
# ---------------------------------------------------------------------------


def bandwidth_limitation(speech: np.ndarray, fs: int, fs_new: int, res_type: str):
    """Down-up resample through fs_new (renderer :233-252)."""
    if fs == fs_new:
        return speech
    assert fs > fs_new, (fs, fs_new)
    ret = resample(speech, fs, fs_new, res_type)
    ret = resample(ret, fs_new, fs, res_type)
    if ret.shape[-1] < speech.shape[-1]:
        ret = np.pad(ret, [(0, 0), (0, speech.shape[-1] - ret.shape[-1])])
    return ret[:, : speech.shape[-1]]


def clipping(speech: np.ndarray, min_quantile: float = 0.0, max_quantile: float = 0.9):
    """Quantile clipping per channel (renderer :255-276)."""
    q = np.array([min_quantile, max_quantile])
    min_, max_ = np.quantile(speech, q, axis=-1)
    return np.stack(
        [np.clip(speech[i], min_[i], max_[i]) for i in range(speech.shape[0])], axis=0
    )


def packet_loss_apply(
    speech: np.ndarray, fs: int, packet_loss_indices: list, packet_duration_ms: int = 20
):
    """Zero out 20 ms packets (renderer :333-341).  Mutates a copy."""
    speech = speech.copy()
    for idx in packet_loss_indices:
        start = idx * packet_duration_ms * fs // 1000
        end = (idx + 1) * packet_duration_ms * fs // 1000
        speech[:, start:end] = 0
    return speech


def codecs_available() -> bool:
    """Whether codec augmentation can run: not in the port yet (ROADMAP A16b)."""
    return False
