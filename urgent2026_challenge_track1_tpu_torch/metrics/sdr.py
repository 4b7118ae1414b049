"""BSS-Eval SDR (filtered projection, fast_bss_eval-equivalent) + SI-SDR.

The reference's SDR helper wraps ``fast_bss_eval.bss_eval_sources(...,
compute_permutation=False, clamp_db=50)`` (calculate_intrusive_se_metrics.py
:90-109).  Single-source case: SDR with a length-L distortion filter is the
ratio of the energy of the best FIR(L)-filtered reference approximation of
the estimate to the residual energy — computed via Toeplitz normal equations
in the frequency domain.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

__all__ = ["sdr_metric", "si_sdr"]


def _clamp(ratio_db: float, clamp_db: float) -> float:
    return float(np.clip(ratio_db, -clamp_db, clamp_db))


def sdr_metric(ref: np.ndarray, inf: np.ndarray, filter_length: int = 512,
               clamp_db: float = 50.0) -> float:
    """Single-source BSS-Eval SDR in dB (no permutation)."""
    assert ref.shape == inf.shape
    if ref.ndim == 2:
        return float(np.mean([sdr_metric(r, i, filter_length, clamp_db)
                              for r, i in zip(ref, inf)]))
    ref = np.asarray(ref, np.float64)
    inf = np.asarray(inf, np.float64)
    n = len(ref) + filter_length - 1
    nfft = 1 << int(np.ceil(np.log2(n)))
    R = np.fft.rfft(ref, nfft)
    E = np.fft.rfft(inf, nfft)
    # autocorrelation of ref and cross-correlation ref/inf
    acorr = np.fft.irfft(R * np.conj(R), nfft)[:filter_length]
    xcorr = np.fft.irfft(E * np.conj(R), nfft)[:filter_length]
    acorr[0] += 1e-10 * (acorr[0] + 1.0)
    h = scipy.linalg.solve_toeplitz(acorr, xcorr)
    s_target = np.convolve(ref, h)[: len(ref)]
    e_res = inf - s_target
    num = np.sum(s_target**2)
    den = np.sum(e_res**2)
    ratio = 10 * np.log10((num + 1e-12) / (den + 1e-12))
    return _clamp(ratio, clamp_db)


def si_sdr(ref: np.ndarray, inf: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB (zero-mean)."""
    ref = np.asarray(ref, np.float64)
    inf = np.asarray(inf, np.float64)
    ref = ref - ref.mean()
    inf = inf - inf.mean()
    alpha = np.dot(inf, ref) / (np.dot(ref, ref) + eps)
    s_t = alpha * ref
    e = inf - s_t
    return float(10 * np.log10((np.sum(s_t**2) + eps) / (np.sum(e**2) + eps)))
