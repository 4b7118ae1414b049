"""The port's audio I/O against the JAX package's on the CPU: FLAC decode and
encode, header-only ``info``, ``.flac`` writes and in-memory buffers.

All comparisons are exact (bitwise): FLAC is integer coding, and both
packages scale the same integers by the same power of two.  Streams are a
fraction of a second long, because the pure-Python decoder (the plain
version the native one is held to) reads bit by bit."""

import numpy as np
import pytest

from urgent2026_challenge_track1_tpu.utils import audio_io as jaio
from urgent2026_challenge_track1_tpu.utils import flac as jflac
from urgent2026_challenge_track1_tpu_torch.utils import audio_io as taio
from urgent2026_challenge_track1_tpu_torch.utils import flac as tflac

# (channels, bits, frames, block): mono and stereo, 16 and 24 bits, lengths
# that are not a multiple of the block, a constant stretch, an empty stream
STREAMS = [(1, 16, 2500, 1024), (2, 16, 2100, 1024), (1, 24, 1500, 512),
           (2, 24, 1800, 4096), (1, 16, 0, 4096)]
IDS = ["mono16", "stereo16", "mono24", "stereo24-one-block", "empty"]


def _signal(ch, frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / 16000.0
    x = 0.4 * np.sin(2 * np.pi * 330.0 * t)[:, None] + 0.05 * rng.standard_normal((frames, ch))
    x[frames // 3 : frames // 3 + 300] = 0.25  # a constant subframe
    return x[:, 0] if ch == 1 else x


@pytest.mark.parametrize("ch, bits, frames, block", STREAMS, ids=IDS)
def test_flac_read_equals_jax(tmp_path, ch, bits, frames, block):
    x = _signal(ch, frames, seed=frames + bits)
    buf = jflac.encode(x, 16000, bits=bits, block=block)
    path = tmp_path / "x.flac"
    path.write_bytes(buf)
    got, fs = taio.read(str(path))
    ref, rfs = jaio.read(str(path))
    assert fs == rfs == 16000 and got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert taio.info(str(path)) == jaio.info(str(path)) == (frames, 16000)
    assert taio.info_frames(str(path)) == frames
    got_b, _ = taio.read_bytes(buf, "float32")
    ref_b, _ = jaio.read_bytes(buf, "float32")
    assert got_b.dtype == np.float32 and np.array_equal(got_b, ref_b)


@pytest.mark.parametrize("ch, bits, frames, block", STREAMS, ids=IDS)
def test_flac_encode_bytes_equal_jax(ch, bits, frames, block):
    x = _signal(ch, frames, seed=7 * frames + bits)
    assert tflac.encode(x, 22050, bits=bits, block=block) == jflac.encode(
        x, 22050, bits=bits, block=block)
    pcm = np.round(np.asarray(x) * 2 ** (bits - 1)).astype(np.int32)  # integer input
    assert tflac.encode(pcm, 22050, bits=bits, block=block) == jflac.encode(
        pcm, 22050, bits=bits, block=block)


@pytest.mark.parametrize("ch, bits, frames, block", STREAMS[:4], ids=IDS[:4])
def test_native_decoder_equals_the_pure_python_decoder(ch, bits, frames, block):
    assert tflac.native_available()
    buf = tflac.encode(_signal(ch, frames, seed=3), 48000, bits=bits, block=block)
    native, fs = tflac.decode(buf)
    plain = tflac._decode_py(buf).astype(np.float64) / float(1 << (bits - 1))
    assert fs == 48000
    assert np.array_equal(native, plain[:, 0] if ch == 1 else plain)


@pytest.mark.parametrize("subtype, bits", [(None, 16), ("PCM_24", 24)])
def test_flac_write_by_extension(tmp_path, subtype, bits):
    x = _signal(2, 3000, seed=5)
    path = tmp_path / "out.flac"
    taio.write(str(path), x, 24000, subtype=subtype)
    assert path.read_bytes()[:4] == b"fLaC"
    assert path.read_bytes() == jflac.encode(x, 24000, bits=bits)
    got, fs = jaio.read(str(path))
    assert fs == 24000 and np.abs(got - x).max() <= 2.0 ** -bits
    with pytest.raises(ValueError, match="FLAC"):
        taio.write(str(tmp_path / "f.flac"), x, 24000, subtype="FLOAT")


@pytest.mark.parametrize("subtype", [None, "FLOAT"])
def test_wav_bytes_equal_jax(subtype):
    x = _signal(1, 1200, seed=9)
    buf = taio.write_bytes(x, 8000, subtype)
    assert buf == jaio.write_bytes(x, 8000, subtype)
    got, fs = taio.read_bytes(buf)
    ref, rfs = jaio.read_bytes(buf)
    assert fs == rfs == 8000 and np.array_equal(got, ref)


def test_wav_is_still_sniffed_and_unknown_bytes_raise(tmp_path):
    x = _signal(2, 900, seed=11)
    path = tmp_path / "x.wav"
    taio.write(str(path), x, 16000, "PCM_24")
    got, _ = taio.read(str(path))
    ref, _ = jaio.read(str(path))
    assert np.array_equal(got, ref) and taio.info(str(path)) == (900, 16000)
    bad = tmp_path / "x.bin"
    bad.write_bytes(b"XYZW" + bytes(64))
    with pytest.raises(ValueError, match="RIFF/WAVE"):
        taio.read(str(bad))
    # an ogg magic is compressed audio now: a broken one fails in the
    # decoder, as in the JAX package (with or without a codec backend)
    bad.write_bytes(b"OggS" + bytes(64))
    with pytest.raises(RuntimeError):
        jaio.read(str(bad))
    with pytest.raises(RuntimeError):
        taio.read(str(bad))
