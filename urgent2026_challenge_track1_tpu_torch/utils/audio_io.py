"""WAV, FLAC and compressed audio I/O in numpy (counterpart of
``utils/audio_io.py``).

``read(path) -> (data, fs)`` with data float64 in [-1, 1), shape (T,) mono or
(T, C), the format sniffed from the magic bytes; ``info(path) -> (frames,
fs)`` from the header alone for WAV and FLAC, and for mp3/ogg/opus the
exact decoded length; ``write(path, data, fs,
subtype)`` writes FLAC when the path ends in ``.flac`` (PCM_16 or PCM_24)
and RIFF/WAVE otherwise (PCM_16, the default, PCM_24 or FLOAT);
``read_bytes`` / ``write_bytes`` do the same on in-memory buffers.  WAV
reads PCM 16/24/32-bit and IEEE float 32/64, including
WAVE_FORMAT_EXTENSIBLE; FLAC goes through ``utils/flac.py``; mp3 (an ID3
tag or an MPEG frame sync) and ogg-vorbis/opus decode through the libavcodec
shim (``utils/codec_av.py``), and the last 8 decodes are kept, since a
caller that asks ``info`` and then ``read`` of one file would otherwise
decode it twice.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

__all__ = ["read", "info", "info_frames", "write", "read_bytes", "write_bytes"]

_PCM, _FLOAT, _EXTENSIBLE = 0x0001, 0x0003, 0xFFFE


def _chunks(buf: bytes) -> dict[bytes, tuple[int, int]]:
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, out = 12, {}
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        out[cid] = (pos + 8, size)
        pos += 8 + size + (size & 1)
    return out


def _fmt(buf: bytes, chunks) -> tuple[int, int, int, int, int]:
    off, _ = chunks[b"fmt "]
    fmt, n_ch, fs, _, block_align, bits = struct.unpack_from("<HHIIHH", buf, off)
    if fmt == _EXTENSIBLE:
        fmt = struct.unpack_from("<H", buf, off + 24)[0]
    return fmt, n_ch, fs, block_align, bits


def _decode_wav(buf: bytes):
    chunks = _chunks(buf)
    fmt, n_ch, fs, _, bits = _fmt(buf, chunks)
    off, size = chunks[b"data"]
    raw = buf[off : off + size]
    if fmt == _PCM and bits == 16:
        data = np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
    elif fmt == _PCM and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        i = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        data = np.where(i >= 1 << 23, i - (1 << 24), i).astype(np.float64) / 8388608.0
    elif fmt == _PCM and bits == 32:
        data = np.frombuffer(raw, "<i4").astype(np.float64) / 2147483648.0
    elif fmt == _FLOAT and bits in (32, 64):
        data = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float64)
    else:
        raise ValueError(f"unsupported WAVE format tag {fmt:#x} with {bits} bits")
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
    return data, fs


def _is_compressed_magic(head: bytes) -> bool:
    """mp3 (an ID3 tag or an MPEG frame sync) or an ogg container."""
    if head[:3] == b"ID3" or head[:4] == b"OggS":
        return True
    return len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0


# the last decodes of compressed files, least recently used first (dict order)
_COMPRESSED_CACHE: dict = {}
_COMPRESSED_CACHE_MAX = 8


def _decode_compressed(path: str):
    st = os.stat(path)
    key = (str(path), st.st_mtime_ns, st.st_size)
    hit = _COMPRESSED_CACHE.pop(key, None)
    if hit is None:
        from urgent2026_challenge_track1_tpu_torch.utils import codec_av

        hit = codec_av.decode_file(path)
    _COMPRESSED_CACHE[key] = hit
    while len(_COMPRESSED_CACHE) > _COMPRESSED_CACHE_MAX:
        _COMPRESSED_CACHE.pop(next(iter(_COMPRESSED_CACHE)))
    return hit


def read_bytes(buf: bytes, dtype: str = "float64"):
    """(data, fs) from an in-memory WAV or FLAC buffer."""
    if buf[:4] == b"fLaC":
        from urgent2026_challenge_track1_tpu_torch.utils import flac

        data, fs = flac.decode(buf)
    else:
        data, fs = _decode_wav(buf)
    return np.asarray(data).astype(dtype), fs


def read(path: str, dtype: str = "float64"):
    """(data, fs); data (T,) or (T, C) in [-1, 1)."""
    with open(path, "rb") as f:
        buf = f.read()
    if _is_compressed_magic(buf[:4]):
        data, fs = _decode_compressed(path)
        return data.astype(dtype), fs
    return read_bytes(buf, dtype)


def info(path: str) -> tuple[int, int]:
    """(frames, samplerate) from the header (FLAC: its STREAMINFO); for
    mp3/ogg the exact decoded length, which container headers only bound."""
    with open(path, "rb") as f:
        head = f.read(65536)
    if _is_compressed_magic(head[:4]):
        data, fs = _decode_compressed(path)
        return data.shape[0], fs
    if head[:4] == b"fLaC":
        from urgent2026_challenge_track1_tpu_torch.utils import flac

        total, fs, _, _ = flac.probe(head)
        return total, fs
    chunks = _chunks(head)
    _, _, fs, block_align, _ = _fmt(head, chunks)
    _, size = chunks[b"data"]  # the size field is in the header even when truncated here
    return size // block_align, fs


def info_frames(path: str) -> int:
    """The number of frames (soundfile's ``SoundFile.frames``)."""
    return info(path)[0]


def write_bytes(data: np.ndarray, samplerate: int, subtype: Optional[str] = None) -> bytes:
    """(T,) or (T, C) samples in [-1, 1) as an in-memory RIFF/WAVE file."""
    data = np.asarray(data)
    n_ch = 1 if data.ndim == 1 else data.shape[1]
    subtype = subtype or "PCM_16"
    if subtype == "PCM_16":
        raw = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2").tobytes()
        fmt, bits = _PCM, 16
    elif subtype == "PCM_24":
        i = np.clip(np.round(data * 8388608.0), -8388608, 8388607).astype("<i4").reshape(-1)
        raw = i.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        fmt, bits = _PCM, 24
    elif subtype == "FLOAT":
        raw = data.astype("<f4").tobytes()
        fmt, bits = _FLOAT, 32
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    block_align = n_ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, n_ch, samplerate,
                                 samplerate * block_align, block_align, bits)
    hdr += b"data" + struct.pack("<I", len(raw))
    return hdr + raw


def write(path: str, data: np.ndarray, samplerate: int,
          subtype: Optional[str] = None) -> None:
    """Write (T,) or (T, C) samples in [-1, 1): FLAC (PCM_16 or PCM_24) when
    ``path`` ends in ``.flac``, RIFF/WAVE otherwise."""
    if str(path).lower().endswith(".flac"):
        from urgent2026_challenge_track1_tpu_torch.utils import flac

        bits = {None: 16, "PCM_16": 16, "PCM_24": 24}.get(subtype)
        if bits is None:
            raise ValueError(f"unsupported FLAC subtype {subtype!r} (PCM_16 or PCM_24; "
                             "FLAC has no float subtypes)")
        buf = flac.encode(np.asarray(data), samplerate, bits=bits)
    else:
        buf = write_bytes(data, samplerate, subtype)
    with open(path, "wb") as f:
        f.write(buf)
