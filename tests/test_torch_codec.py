"""The port's codec path (``utils/codec_av.py``, ``simulation/dsp.codec_compression``,
the codec entry of ``simulation/render.apply_augmentations`` and the
mp3/ogg reads of ``utils/audio_io``) against the JAX package's on the CPU.

Every comparison is bitwise: both packages build the same
``csrc/codec_native.cpp`` with the same g++ flags against the same system
FFmpeg libraries.  Skipped where the JAX package's shim does not build (no
FFmpeg headers or libraries), as ``tests/test_codec_av.py`` is."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.simulation import dsp as jdsp
from urgent2026_challenge_track1_tpu.simulation import render as jrender
from urgent2026_challenge_track1_tpu.utils import audio_io as jaio
from urgent2026_challenge_track1_tpu.utils import codec_av as jcodec
from urgent2026_challenge_track1_tpu_torch.simulation import dsp as tdsp
from urgent2026_challenge_track1_tpu_torch.simulation import render as trender
from urgent2026_challenge_track1_tpu_torch.utils import audio_io as taio
from urgent2026_challenge_track1_tpu_torch.utils import codec_av as tcodec

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(not jcodec.available(), reason="FFmpeg libraries not present")

# a real mp3 (and the same clip as ogg) shipped with pygame's examples, the
# file tests/test_codec_av.py reads; found without importing pygame
_PYGAME = importlib.util.find_spec("pygame")
SAMPLE_MP3 = (str(Path(_PYGAME.origin).parent / "examples" / "data" / "house_lo.mp3")
              if _PYGAME is not None else "")
needs_sample = pytest.mark.skipif(not Path(SAMPLE_MP3).is_file(),
                                  reason="pygame's example mp3 not present")
CODECS = [("mp3", None, 4), ("ogg", "vorbis", 5), ("ogg", "opus", 5)]


def _speechlike(fs, seconds=0.6, seed=0, ch=None):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    x = 0.25 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    x = x + 0.02 * rng.standard_normal(t.size)
    return x if ch is None else np.stack([x * (1.0 - 0.3 * c) for c in range(ch)])


def test_codecs_available_equals_jax():
    assert tcodec.available()
    assert tdsp.codecs_available() == jdsp.codecs_available()


@pytest.mark.parametrize("fs", [8000, 22050, 48000])
@pytest.mark.parametrize("fmt,enc,q", CODECS, ids=["mp3", "vorbis", "opus"])
def test_roundtrip_equals_jax(fs, fmt, enc, q):
    x = _speechlike(fs, seed=fs)
    got = tcodec.roundtrip(x, fs, fmt, enc, q)
    ref = jcodec.roundtrip(x, fs, fmt, enc, q)
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got, ref)
    assert not np.allclose(got[: x.size], x[: got.size])  # the codec did distort


def test_roundtrip_refuses_two_channels():
    with pytest.raises(ValueError, match="one channel"):
        tcodec.roundtrip(_speechlike(8000, ch=2), 8000, "mp3", None, 4)


@needs_sample
@pytest.mark.parametrize("path", [SAMPLE_MP3, SAMPLE_MP3[:-3] + "ogg"], ids=["mp3", "ogg"])
def test_decode_read_and_info_equal_jax(path):
    assert tcodec.probe_file(path) == jcodec.probe_file(path)
    got, fs = tcodec.decode_file(path)
    ref, rfs = jcodec.decode_file(path)
    assert fs == rfs and np.array_equal(got, ref)
    data, fs = taio.read(path)
    rdata, rfs = jaio.read(path)
    assert fs == rfs and data.dtype == np.float64 and np.array_equal(data, rdata)
    assert taio.info(path) == jaio.info(path) == (data.shape[0], fs)
    assert taio.read(path, dtype="float32")[0].dtype == np.float32


@needs_sample
def test_info_then_read_decodes_once(monkeypatch, tmp_path):
    path = tmp_path / "clip.mp3"
    path.write_bytes(open(SAMPLE_MP3, "rb").read())
    calls = []
    decode = tcodec.decode_file
    monkeypatch.setattr(tcodec, "decode_file", lambda p: calls.append(p) or decode(p))
    frames, _ = taio.info(str(path))
    data, _ = taio.read(str(path))
    assert len(calls) == 1 and data.shape[0] == frames
    # a file rewritten in place is decoded anew (the key holds mtime and size)
    path.write_bytes(open(SAMPLE_MP3, "rb").read()[: 4096 * 4])
    assert taio.info(str(path))[0] < frames and len(calls) == 2


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("fmt,enc,q", CODECS, ids=["mp3", "vorbis", "opus"])
def test_codec_compression_equals_jax(fmt, enc, q, ch):
    x = _speechlike(16000, ch=ch)
    got = tdsp.codec_compression(x, 16000, format=fmt, encoder=enc, qscale=q)
    assert got.shape == x.shape
    assert np.array_equal(got, jdsp.codec_compression(x, 16000, format=fmt, encoder=enc,
                                                      qscale=q))


@pytest.mark.parametrize("chain", [
    "codec(format=mp3,encoder=None,qscale=3)",
    "clipping(min=0.02,max=0.95)/codec(format=ogg,encoder=opus,qscale=3)",
    "codec(format=ogg,encoder=vorbis,qscale=6)/packet_loss(packet_loss_indices=[1, 4],"
    "packet_duration_ms=20)"], ids=["mp3", "clip-opus", "vorbis-pl"])
def test_apply_augmentations_with_a_codec_entry_equals_jax(chain):
    x = _speechlike(16000, seed=3, ch=1)
    got = trender.apply_augmentations(x, 16000, chain)
    assert got.shape == x.shape and not np.allclose(got, x)
    assert np.array_equal(got, jrender.apply_augmentations(x, 16000, chain))
