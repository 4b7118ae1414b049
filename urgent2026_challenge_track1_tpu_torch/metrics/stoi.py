"""STOI / ESTOI intelligibility metrics (numpy, vectorized over segments).

Implements the published algorithms — STOI (Taal et al., 2011) and ESTOI
(Jensen & Taal, 2016) — with the standard constants used by the pystoi
package the reference depends on (``calculate_intrusive_se_metrics.py:37-49``):
10 kHz analysis rate, 256-sample frames (512 FFT, 128 hop), 15 one-third
octave bands from 150 Hz, 40 dB silent-frame removal, 384 ms (N=30 frame)
segments, beta = -15 dB clipping (STOI only).
"""

from __future__ import annotations

import functools

import numpy as np

from urgent2026_challenge_track1_tpu_torch.simulation.dsp import resample

__all__ = ["stoi"]

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30
BETA = -15.0
DYN_RANGE = 40.0
EPS = np.finfo(np.float64).eps


@functools.lru_cache(maxsize=1)
def _third_octave_matrix():
    """(NUMBAND, NFFT//2+1) one-third octave band matrix at FS/NFFT resolution."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=float)
    cf = MINFREQ * 2 ** (k / 3.0)
    lo = MINFREQ * 2 ** ((2 * k - 1) / 6.0)
    hi = MINFREQ * 2 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((NUMBAND, len(f)))
    for i in range(NUMBAND):
        lo_idx = int(np.argmin((f - lo[i]) ** 2))
        hi_idx = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _frame(x: np.ndarray, win: np.ndarray, hop: int):
    n = (len(x) - N_FRAME) // hop + 1
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(N_FRAME)[None, :] + hop * np.arange(n)[:, None]
    return x[idx] * win


def _remove_silent_frames(x, y, dyn_range=DYN_RANGE, framelen=N_FRAME, hop=N_FRAME // 2):
    win = np.hanning(framelen + 2)[1:-1]
    xf = _frame(x, win, hop)
    yf = _frame(y, win, hop)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > np.max(energies) - dyn_range
    xf, yf = xf[mask], yf[mask]
    # overlap-add reconstruction of the kept frames
    n_out = hop * (len(xf) - 1) + framelen if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + framelen] += xf[i]
        ys[i * hop : i * hop + framelen] += yf[i]
    return xs, ys


def _spectrogram(x):
    win = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frame(x, win, N_FRAME // 2)
    spec = np.fft.rfft(frames, NFFT, axis=-1)
    return np.abs(spec) ** 2  # (M, F)


def _segments(x: np.ndarray, n: int):
    """(J, M) -> (M-n+1, J, n) sliding segments along time."""
    J, M = x.shape
    if M < n:
        return np.zeros((0, J, n))
    return np.stack([x[:, m : m + n] for m in range(M - n + 1)], axis=0)


def _row_col_normalize(seg):
    """ESTOI normalization: rows (time) then columns (bands)."""
    seg = seg - seg.mean(axis=-1, keepdims=True)
    seg = seg / (np.linalg.norm(seg, axis=-1, keepdims=True) + EPS)
    seg = seg - seg.mean(axis=-2, keepdims=True)
    seg = seg / (np.linalg.norm(seg, axis=-2, keepdims=True) + EPS)
    return seg


def stoi(x: np.ndarray, y: np.ndarray, fs_sig: int, extended: bool = False) -> float:
    """STOI/ESTOI of degraded ``y`` against clean ``x``; higher is better."""
    assert x.shape == y.shape, (x.shape, y.shape)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if fs_sig != FS:
        x = resample(x[None], fs_sig, FS, "polyphase")[0]
        y = resample(y[None], fs_sig, FS, "polyphase")[0]
    x, y = _remove_silent_frames(x, y)
    if len(x) < N_FRAME:
        return 1e-5
    obm = _third_octave_matrix()
    X = np.sqrt(obm @ _spectrogram(x).T + EPS)  # (J, M)
    Y = np.sqrt(obm @ _spectrogram(y).T + EPS)
    if X.shape[1] < N:
        return 1e-5

    if extended:
        xs = _row_col_normalize(_segments(X, N))
        ys = _row_col_normalize(_segments(Y, N))
        return float(np.sum(xs * ys / N) / xs.shape[0])

    xs = _segments(X, N)  # (S, J, N)
    ys = _segments(Y, N)
    alpha = np.linalg.norm(xs, axis=-1, keepdims=True) / (
        np.linalg.norm(ys, axis=-1, keepdims=True) + EPS
    )
    ys = np.minimum(alpha * ys, xs * (1 + 10 ** (-BETA / 20)))
    xn = xs - xs.mean(axis=-1, keepdims=True)
    yn = ys - ys.mean(axis=-1, keepdims=True)
    corr = np.sum(xn * yn, axis=-1) / (
        np.linalg.norm(xn, axis=-1) * np.linalg.norm(yn, axis=-1) + EPS
    )
    return float(corr.mean())
