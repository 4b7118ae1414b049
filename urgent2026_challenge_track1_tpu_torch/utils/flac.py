"""FLAC codec (counterpart of ``utils/flac.py``): a native decoder, a
pure-Python decoder and a pure-Python encoder.

The challenge corpora ship FLAC.  Decoding is the loader's hot path (dynamic
mixing reads its sources every step), so it runs in C++
(``csrc/flac_native.cpp``, built with g++ at first use by
``ops/_host_build``); where that library does not build, ``decode`` takes
``_decode_py``, which has the same semantics and is the plain version the
tests hold the native decoder to, bit for bit.  Which decoder a process
uses is printed to stderr once, at its first decode.  Both are host code:
no device is involved.

``encode`` writes spec-compliant files: fixed predictors of order 0-2,
rice-coded residuals, 4096-sample blocks.

Samples are floats in [-1, 1) scaled by 2**(bits-1), as soundfile's.
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import threading

import numpy as np

from urgent2026_challenge_track1_tpu_torch.ops._host_build import build_host_library

__all__ = ["decode", "encode", "probe", "native_available"]

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
            lib = build_host_library("flac_native.cpp")
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.flac_probe.argtypes = [u8p, ctypes.c_int64, i64p]
            lib.flac_probe.restype = ctypes.c_int
            lib.flac_decode.argtypes = [
                u8p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, i64p,
            ]
            lib.flac_decode.restype = ctypes.c_int
            _LIB = lib
            route = "native (csrc/flac_native.cpp)"
        except Exception as e:  # no g++, or it failed: the pure-Python decoder
            _LIB = None
            route = f"pure-Python _decode_py (native build failed: {e})"
        print(f"flac: process {os.getpid()} decodes with the {route} decoder",
              file=sys.stderr, flush=True)
        return _LIB


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Probe / decode
# ---------------------------------------------------------------------------


def probe(buf: bytes) -> tuple[int, int, int, int]:
    """(total_samples, sample_rate, channels, bits) from STREAMINFO."""
    if buf[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    while pos + 4 <= len(buf):
        hdr = buf[pos]
        last, btype = hdr >> 7, hdr & 0x7F
        size = int.from_bytes(buf[pos + 1 : pos + 4], "big")
        if btype == 0:
            b = buf[pos + 4 : pos + 4 + 34]
            bits_ = int.from_bytes(b[10:18], "big")
            fs = bits_ >> 44
            ch = ((bits_ >> 41) & 0x7) + 1
            bps = ((bits_ >> 36) & 0x1F) + 1
            total = bits_ & ((1 << 36) - 1)
            return total, fs, ch, bps
        pos += 4 + size
        if last:
            break
    raise ValueError("FLAC stream has no STREAMINFO")


def _frames_offset(buf: bytes) -> int:
    """Byte offset of the first audio frame (after the metadata blocks)."""
    pos = 4
    while pos + 4 <= len(buf):
        last = buf[pos] >> 7
        pos += 4 + int.from_bytes(buf[pos + 1 : pos + 4], "big")
        if last:
            break
    return pos


def decode(buf: bytes) -> tuple[np.ndarray, int]:
    """FLAC bytes -> (float64 (T,) or (T, C) in [-1, 1), fs)."""
    total, fs, ch, bps = probe(buf)
    if total == 0 and _frames_offset(buf) >= len(buf):
        # genuinely empty stream (encode() of zero samples writes this):
        # STREAMINFO total 0 is also used for unknown-length piped encodes,
        # so only a stream with no frame bytes at all is treated as empty
        empty = np.zeros((0, ch), np.float64)
        return (empty[:, 0] if ch == 1 else empty), fs
    lib = _load()
    if lib is not None:
        arr = np.frombuffer(buf, np.uint8)
        # unknown total_samples (STREAMINFO 0, e.g. piped encodes): start
        # from a compressed-size guess and grow until the decoder does not
        # hit the capacity ceiling
        cap = total if total > 0 else (len(buf) * 8 // max(bps, 1) // ch + 65536)
        while True:
            out = np.empty((cap, ch), np.int32)
            done = ctypes.c_int64(0)
            rc = lib.flac_decode(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(len(buf)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int64(cap),
                ctypes.byref(done),
            )
            if rc != 0:
                raise ValueError(f"FLAC decode failed (native rc={rc})")
            if total > 0 or done.value < cap:
                break
            cap *= 4
        samples = out[: done.value].astype(np.float64)
    else:
        samples = _decode_py(buf).astype(np.float64)
    samples /= float(1 << (bps - 1))
    if ch == 1:
        samples = samples[:, 0]
    return samples, fs


# ---------------------------------------------------------------------------
# Pure-Python decoder: the plain version the native decoder is held to
# ---------------------------------------------------------------------------


class _BitReader:
    __slots__ = ("bits", "pos", "_ones")

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self._ones = np.flatnonzero(self.bits)  # for O(log n) unary reads
        self.pos = 0

    def read(self, n: int) -> int:
        v = 0
        for b in self.bits[self.pos : self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        i = np.searchsorted(self._ones, self.pos)
        if i >= self._ones.size:
            raise EOFError
        q = int(self._ones[i]) - self.pos
        self.pos += q + 1
        return q

    def read_utf8(self) -> int:
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x40
        while b0 & mask:
            n += 1
            mask >>= 1
        v = b0 & (mask - 1)
        for _ in range(n):
            v = (v << 6) | (self.read(8) & 0x3F)
        return v

    def align(self):
        self.pos = (self.pos + 7) & ~7


_FIXED = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _read_residual(br: _BitReader, order: int, blocksize: int) -> list[int]:
    method = br.read(2)
    plen, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    porder = br.read(4)
    nparts = 1 << porder
    psize = blocksize >> porder
    res: list[int] = []
    for p in range(nparts):
        count = psize - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            nbits = br.read(5)
            res.extend(br.read_signed(nbits) for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                v = (q << param) | br.read(param)
                res.append((v >> 1) ^ -(v & 1))
    return res


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    assert br.read(1) == 0, "bad subframe pad bit"
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
    bps -= wasted
    if stype == 0:
        out = np.full(blocksize, br.read_signed(bps), np.int64)
    elif stype == 1:
        out = np.array([br.read_signed(bps) for _ in range(blocksize)], np.int64)
    elif 8 <= stype <= 12:
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _read_residual(br, order, blocksize)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        coefs = _FIXED[order]
        for i in range(order, blocksize):
            out[i] = res[i - order] + sum(
                c * out[i - 1 - j] for j, c in enumerate(coefs)
            )
    elif stype >= 32:
        order = (stype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        shift = br.read_signed(5)
        coef = [br.read_signed(prec) for _ in range(order)]
        res = _read_residual(br, order, blocksize)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        for i in range(order, blocksize):
            acc = sum(coef[j] * int(out[i - 1 - j]) for j in range(order))
            out[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _decode_py(buf: bytes) -> np.ndarray:
    total, fs, ch, bps = probe(buf)
    # skip metadata blocks
    pos = 4
    while True:
        hdr = buf[pos]
        size = int.from_bytes(buf[pos + 1 : pos + 4], "big")
        pos += 4 + size
        if hdr >> 7:
            break
    br = _BitReader(buf[pos:])
    blocks = []
    nbits = len(br.bits)
    while br.pos + 32 <= nbits:
        if br.read(14) != 0x3FFE:
            break
        br.read(2)  # reserved + blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_asgn = br.read(4)
        ss_code = br.read(3)
        br.read(1)
        br.read_utf8()
        if bs_code == 1:
            blocksize = 192
        elif 2 <= bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = 256 << (bs_code - 8)
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        bps_f = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[ss_code]
        br.read(8)  # crc8
        nch = ch_asgn + 1 if ch_asgn < 8 else 2
        chans = []
        for c in range(nch):
            extra = int(
                (ch_asgn == 8 and c == 1)
                or (ch_asgn == 9 and c == 0)
                or (ch_asgn == 10 and c == 1)
            )
            chans.append(_decode_subframe(br, blocksize, bps_f + extra))
        br.align()
        br.read(16)  # crc16
        if ch_asgn == 8:
            chans[1] = chans[0] - chans[1]
        elif ch_asgn == 9:
            chans[0] = chans[0] + chans[1]
        elif ch_asgn == 10:
            mid, side = chans
            mid = (mid << 1) | (side & 1)
            chans = [(mid + side) >> 1, (mid - side) >> 1]
        blocks.append(np.stack(chans, axis=-1))
    if not blocks:
        raise ValueError("no FLAC frames decoded")
    out = np.concatenate(blocks, axis=0)
    return out[:total] if total else out


# ---------------------------------------------------------------------------
# Encoder (fixed predictors + rice; one pass, 4096-sample blocks)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.chunks = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.chunks.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nacc:
            self.write(0, 8 - self.nacc)

    def bytes(self) -> bytes:
        assert self.nacc == 0
        return bytes(self.chunks)


_CRC8_TBL = None
_CRC16_TBL = None


def _crc_tables():
    global _CRC8_TBL, _CRC16_TBL
    if _CRC8_TBL is None:
        t8 = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            t8.append(c)
        t16 = []
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
            t16.append(c)
        _CRC8_TBL, _CRC16_TBL = t8, t16
    return _CRC8_TBL, _CRC16_TBL


def _crc8(data: bytes) -> int:
    t8, _ = _crc_tables()
    c = 0
    for b in data:
        c = t8[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    _, t16 = _crc_tables()
    c = 0
    for b in data:
        c = t16[(c >> 8) ^ b] ^ ((c << 8) & 0xFFFF)
    return c


def _utf8_coded(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shifts = 6 * (nbytes - 1)
    out.append(lead | (n >> shifts))
    for i in range(nbytes - 1):
        shifts -= 6
        out.append(0x80 | ((n >> shifts) & 0x3F))
    return bytes(out)


def _write_rice(bw: _BitWriter, res: np.ndarray):
    """One partition (partition order 0), rice parameter from the mean."""
    zz = (np.abs(res.astype(np.int64)) << 1) - (res < 0).astype(np.int64)
    mean = float(np.mean(zz)) if zz.size else 0.0
    k = 0
    while (1 << (k + 1)) < mean + 1 and k < 14:
        k += 1
    bw.write(0, 2)   # rice method (4-bit params)
    bw.write(0, 4)   # partition order 0
    bw.write(k, 4)
    for v in zz:
        v = int(v)
        bw.write_unary(v >> k)
        if k:
            bw.write(v & ((1 << k) - 1), k)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int):
    """Pick the cheapest of fixed orders 0-2 (sum |residual| proxy) or
    verbatim/constant."""
    if np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    cands = {0: x.astype(np.int64)}
    cands[1] = np.diff(cands[0])
    cands[2] = np.diff(cands[1])
    costs = {o: float(np.abs(r).sum()) / max(r.size, 1) for o, r in cands.items()}
    order = min(costs, key=costs.get)
    res = cands[order]
    bw.write(0, 1)
    bw.write(8 + order, 6)  # FIXED
    bw.write(0, 1)          # no wasted bits
    for i in range(order):
        bw.write(int(x[i]), bps)
    _write_rice(bw, res)


def encode(data: np.ndarray, fs: int, bits: int = 16, block: int = 4096) -> bytes:
    """float/int (T,) or (T, C) -> FLAC bytes (independent channels)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    T, C = data.shape
    assert 1 <= C <= 8, C
    if np.issubdtype(data.dtype, np.floating):
        scale = float(1 << (bits - 1))
        pcm = np.clip(np.round(data * scale), -scale, scale - 1).astype(np.int64)
    else:
        pcm = data.astype(np.int64)

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(min(block, T) if T else block, 16)  # min blocksize
    si.write(block, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(fs, 20)
    si.write(C - 1, 3)
    si.write(bits - 1, 5)
    si.write(T, 36)
    si_body = si_bytes_md5 = si.bytes() + b"\x00" * 16  # md5 unset
    out += bytes([0x80]) + len(si_body).to_bytes(3, "big") + si_bytes_md5

    for fi, start in enumerate(range(0, T, block)):
        seg = pcm[start : start + block]
        bsz = seg.shape[0]
        hw = _BitWriter()
        hw.write(0x3FFE, 14)
        hw.write(0, 1)
        hw.write(0, 1)          # fixed blocksize stream
        hw.write(7, 4)          # blocksize: 16-bit at end of header
        hw.write(0, 4)          # sample rate: from STREAMINFO
        hw.write(C - 1, 4)      # independent channels
        hw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits], 3)
        hw.write(0, 1)
        hdr = hw.bytes() + _utf8_coded(fi) + struct.pack(">H", bsz - 1)
        hdr += bytes([_crc8(hdr)])
        fw = _BitWriter()
        for c in range(C):
            _encode_subframe(fw, seg[:, c], bits)
        fw.align()
        frame = hdr + fw.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame
    return bytes(out)
