"""mp3/ogg-vorbis/opus through the system FFmpeg libraries (counterpart of
``utils/codec_av.py``).

``roundtrip`` encodes and decodes a signal through a lossy codec (the codec
augmentation of the dynamic-mixing render); ``probe_file`` and
``decode_file`` read compressed corpora (CommonVoice and DNS5 ship mp3 and
ogg).  All three run ``csrc/codec_native.cpp``, built with g++ at first use
by ``ops/_host_build`` and linked against libavformat, libavcodec, libavutil
and libswresample.  The build is tried once per process, and which route
the process uses is printed to stderr once.  Where the libraries or their
headers are missing, ``available()`` is False and the callers take the JAX
package's rule for a machine without a codec backend.  Host code: no
device is involved, and nothing here imports torch.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from urgent2026_challenge_track1_tpu_torch.ops._host_build import build_host_library

__all__ = ["available", "roundtrip", "decode_file", "probe_file"]

LINK_FLAGS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_LONG = ctypes.c_longlong
_FLOATP = ctypes.POINTER(ctypes.c_float)
_INTP = ctypes.POINTER(ctypes.c_int)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = build_host_library("codec_native.cpp", LINK_FLAGS)
            lib.cn_roundtrip.restype = _LONG
            lib.cn_roundtrip.argtypes = [_FLOATP, _LONG, ctypes.c_int, ctypes.c_char_p,
                                         ctypes.c_char_p, ctypes.c_int, _FLOATP, _LONG]
            lib.cn_probe_file.restype = _LONG
            lib.cn_probe_file.argtypes = [ctypes.c_char_p, _INTP, _INTP]
            lib.cn_decode_file.restype = _LONG
            lib.cn_decode_file.argtypes = [ctypes.c_char_p, _FLOATP, _LONG, _INTP, _INTP]
            _LIB = lib
            route = "uses the native libavcodec shim (csrc/codec_native.cpp)"
        except Exception as e:  # no g++, no FFmpeg headers or libraries
            _LIB = None
            route = f"has no codec shim (it did not build or load: {str(e).splitlines()[0]})"
        print(f"codec_av: process {os.getpid()} {route}", file=sys.stderr, flush=True)
        return _LIB


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("codec_native unavailable (no FFmpeg libraries)")
    return lib


def _call_roundtrip(lib, x, fs, fmt, enc, q, out):
    return lib.cn_roundtrip(x.ctypes.data_as(_FLOATP), _LONG(x.size), ctypes.c_int(fs),
                            fmt, enc, ctypes.c_int(q), out.ctypes.data_as(_FLOATP),
                            _LONG(out.size))


def roundtrip(speech: np.ndarray, fs: int, format: str, encoder=None, qscale=None) -> np.ndarray:
    """Encode and decode 1-D ``speech`` through a lossy codec; float64 out,
    resampled back to ``fs`` and gapless-aligned.  The caller pads or
    truncates to the input length."""
    lib = _lib()
    x = np.ascontiguousarray(speech, np.float32)
    if x.ndim != 1:
        raise ValueError(f"roundtrip takes one channel, got shape {x.shape}")
    q = -1000 if qscale is None else int(qscale)
    enc = b"" if encoder in (None, "None") else str(encoder).encode()
    out = np.zeros(x.size + 2 * fs, np.float32)
    m = _call_roundtrip(lib, x, fs, format.encode(), enc, q, out)
    if m > out.size:  # decoded longer than the slack buffer: again, exact
        out = np.zeros(m, np.float32)
        m = _call_roundtrip(lib, x, fs, format.encode(), enc, q, out)
    if m < 0:
        raise RuntimeError(f"codec round-trip failed (AVERROR {m}): format={format} "
                           f"encoder={encoder} qscale={qscale} fs={fs}")
    return out[:m].astype(np.float64)


def probe_file(path: str):
    """(frames_estimate, fs, channels) from the container headers, no decode."""
    lib = _lib()
    fs, ch = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.cn_probe_file(str(path).encode(), ctypes.byref(fs), ctypes.byref(ch))
    if n < 0:
        raise RuntimeError(f"cannot probe {path} (AVERROR {n})")
    return int(n), fs.value, ch.value


def decode_file(path: str):
    """(data, fs): data float64, (T,) mono or (T, C), soundfile's layout."""
    lib = _lib()
    est, fs_est, ch_est = probe_file(path)
    cap = max((est + fs_est) * max(ch_est, 1), 1 << 16)
    fs, ch = ctypes.c_int(0), ctypes.c_int(0)

    def decode(out):
        return lib.cn_decode_file(str(path).encode(), out.ctypes.data_as(_FLOATP),
                                  _LONG(out.size), ctypes.byref(fs), ctypes.byref(ch))

    out = np.zeros(cap, np.float32)
    m = decode(out)
    if m > out.size:  # the estimate was short (VBR without a Xing header): again, exact
        out = np.zeros(m, np.float32)
        m = decode(out)
    if m < 0:
        raise RuntimeError(f"cannot decode {path} (AVERROR {m})")
    data = out[:m].astype(np.float64)
    if ch.value > 1:
        data = data.reshape(-1, ch.value)
    return data, fs.value
