"""The wind-noise sidechain compressor (counterpart of ``ops/native.py``).

``sidechain_compress`` runs ``csrc/dsp_native.cpp`` (built with g++ at
first use by ``ops/_host_build``); where that library does not build it
takes ``_sidechain_compress_numpy``, the plain version with the same
arithmetic.  Which one a process uses is printed to stderr once.  Host
code: no device is involved.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from urgent2026_challenge_track1_tpu_torch.ops._host_build import build_host_library

__all__ = ["sidechain_compress", "native_available"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = build_host_library("dsp_native.cpp")
            dp = ctypes.POINTER(ctypes.c_double)
            lib.sidechain_compress.argtypes = [dp, dp, ctypes.c_int64] + [ctypes.c_double] * 6 + [dp]
            lib.sidechain_compress.restype = None
            _LIB = lib
            route = "native (csrc/dsp_native.cpp)"
        except Exception as e:  # no g++, or it failed: the numpy loop
            _LIB = None
            route = f"numpy loop (native build failed: {e})"
        print(f"sidechain_compress: process {os.getpid()} uses the {route}",
              file=sys.stderr, flush=True)
        return _LIB


def native_available() -> bool:
    return _load() is not None


def _sidechain_compress_numpy(speech, sidechain, fs, threshold, ratio, attack_ms, release_ms,
                              level_sc):
    attack_coeff = min(1.0, 1.0 / (attack_ms * fs / 4000.0))
    release_coeff = min(1.0, 1.0 / (release_ms * fs / 4000.0))
    delta = 1.0 - 1.0 / ratio
    thres2 = threshold * threshold
    out = np.empty_like(speech)
    lin_slope = 0.0
    for i in range(speech.shape[0]):
        det = sidechain[i] * level_sc
        det *= det
        coeff = attack_coeff if det > lin_slope else release_coeff
        lin_slope += (det - lin_slope) * coeff
        gain = 1.0
        if lin_slope > thres2 and lin_slope > 0.0:
            gain = np.exp(0.5 * delta * (np.log(thres2) - np.log(lin_slope)))
        out[i] = speech[i] * gain
    return out


def sidechain_compress(speech: np.ndarray, sidechain: np.ndarray, fs: float, threshold: float,
                       ratio: float, attack_ms: float, release_ms: float,
                       level_sc: float = 1.0) -> np.ndarray:
    """Duck ``speech`` by the ``sidechain`` signal (ffmpeg sidechaincompress
    semantics, see csrc/dsp_native.cpp).  1-D float64 in, 1-D float64 out."""
    speech = np.ascontiguousarray(speech, np.float64)
    sidechain = np.ascontiguousarray(sidechain, np.float64)
    if speech.ndim != 1 or speech.shape != sidechain.shape:
        # a raise, so the C loop never reads past a shorter sidechain
        raise ValueError(f"speech/sidechain must be equal-length 1-D arrays, got "
                         f"{speech.shape} vs {sidechain.shape}")
    lib = _load()
    if lib is None:
        return _sidechain_compress_numpy(speech, sidechain, fs, threshold, ratio, attack_ms,
                                         release_ms, level_sc)
    out = np.empty_like(speech)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.sidechain_compress(
        speech.ctypes.data_as(dp), sidechain.ctypes.data_as(dp), ctypes.c_int64(speech.shape[0]),
        *(ctypes.c_double(v) for v in (fs, threshold, ratio, attack_ms, release_ms, level_sc)),
        out.ctypes.data_as(dp))
    return out
