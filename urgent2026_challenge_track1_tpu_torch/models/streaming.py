"""Chunked overlap-add enhancement for unbounded-length inference (the port's
copy of ``models/streaming.py``; numpy only).

Long inputs are cut into fixed-size overlapping chunks, each chunk is
enhanced, and the overlaps are crossfaded with a linear ramp.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["enhance_streaming"]


def enhance_streaming(
    enhance_chunk: Callable[[np.ndarray, int], np.ndarray],
    wav: np.ndarray,
    fs: int,
    chunk_seconds: float = 30.0,
    overlap_seconds: float = 1.0,
) -> np.ndarray:
    """Enhance arbitrarily long mono audio with one fixed chunk shape.

    ``enhance_chunk(x, n_valid)`` maps a (1, chunk) float32 array to
    (1, chunk); the final chunk is right-zero-padded to the shared shape and
    ``n_valid`` says how many leading samples are real audio.  Full chunks
    (``n_valid == chunk``) should skip length masking, which lets the time
    recurrence run on the fused bidirectional kernel.
    """
    T = wav.shape[-1]
    chunk = int(chunk_seconds * fs)
    # an overlap >= chunk would make the hop zero (infinite loop); clamp to
    # half a chunk so small chunk_seconds values stay valid
    overlap = min(int(overlap_seconds * fs), chunk // 2)
    hop = chunk - overlap
    if T <= chunk:
        x = np.zeros((1, chunk), np.float32)
        x[0, :T] = wav
        return np.asarray(enhance_chunk(x, T))[0, :T]

    ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
    out = np.zeros(T, np.float32)
    weight = np.zeros(T, np.float32)
    start = 0
    while start < T:
        end = min(start + chunk, T)
        x = np.zeros((1, chunk), np.float32)
        x[0, : end - start] = wav[start:end]
        y = np.asarray(enhance_chunk(x, end - start))[0, : end - start]
        w = np.ones(end - start, np.float32)
        if start > 0:
            w[:overlap] = ramp[: end - start][:overlap]
        if end < T:
            w[-overlap:] = ramp[::-1][-(end - start):][-overlap:]
        out[start:end] += y * w
        weight[start:end] += w
        if end == T:
            break
        start += hop
    return out / np.maximum(weight, 1e-8)
