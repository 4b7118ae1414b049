"""The port's STFT front end against the JAX package's dsp/stft.py on the
CPU, float32, at every supported rate including the odd 22.05 kHz geometry
(n_fft 441, hop 220).  Tolerance 1e-5: same arithmetic, other FFT library."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.dsp import stft as jdsp
from urgent2026_challenge_track1_tpu_torch.dsp import stft as tdsp

torch.set_num_threads(1)
ATOL = 1e-5
RATES = [8000, 16000, 22050, 48000]


def _batch(fs, seed):
    rng = np.random.default_rng(seed)
    T = fs // 2 + 37
    x = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    lengths = np.array([T, T - fs // 9], np.int32)
    return x, lengths


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fs", RATES)
def test_geometry_matches(fs):
    jc, tc = jdsp.STFTConfig(), tdsp.STFTConfig()
    assert tc.geometry(fs) == jc.geometry(fs)
    assert tc.n_bins(fs) == jc.n_bins(fs)
    assert tc.frames(fs + 123, fs) == jc.frames(fs + 123, fs)


@pytest.mark.parametrize("fs", RATES)
def test_stft_matches(fs):
    x, _ = _batch(fs, 0)
    n_fft, win, hop = tdsp.STFTConfig().geometry(fs)
    got = tdsp.stft(torch.from_numpy(x), n_fft, hop, win_length=win)
    ref = jdsp.stft(jnp.asarray(x), n_fft, hop, win_length=win)
    assert got.shape == ref.shape
    _close(got.real, ref.real)
    _close(got.imag, ref.imag)


@pytest.mark.parametrize("fs", RATES)
@pytest.mark.parametrize("masked", [False, True])
def test_istft_matches(fs, masked):
    x, lengths = _batch(fs, 1)
    n_fft, win, hop = tdsp.STFTConfig().geometry(fs)
    spec = np.array(jdsp.stft(jnp.asarray(x), n_fft, hop, win_length=win))
    frames = np.asarray(jdsp.valid_frames(jnp.asarray(lengths), n_fft, hop))
    fm = np.array(jdsp.frames_mask(jnp.asarray(frames), spec.shape[1]))
    t_fm = torch.from_numpy(fm) if masked else None
    j_fm = jnp.asarray(fm) if masked else None
    got = tdsp.istft(torch.from_numpy(spec), n_fft, hop, win_length=win,
                     length=x.shape[1], frame_mask=t_fm)
    ref = jdsp.istft(jnp.asarray(spec), n_fft, hop, win_length=win,
                     length=x.shape[1], frame_mask=j_fm)
    if masked:
        # Compare where the valid frames' window energy is >= 1e-3.  Past
        # lengths[b] (zeroed by callers), and on the last samples of a row
        # that its final frame barely covers, the output is divided by an
        # envelope down to ~1e-5, which amplifies FFT rounding ~1e5-fold in
        # both implementations.
        wsq = jdsp.hann_window(n_fft) ** 2
        env = np.asarray(jdsp._ola(wsq[None, :] * jnp.asarray(fm)[..., None], n_fft, hop))
        env = env[:, n_fft // 2 : n_fft // 2 + x.shape[1]]
        valid = (np.arange(x.shape[1])[None, :] < lengths[:, None]) & (env >= 1e-3)
        assert valid.sum(axis=1).min() >= lengths.min() - hop  # only a tail is left out
        got, ref = got.numpy()[valid], np.asarray(ref)[valid]
    _close(got, ref)
    _close(tdsp.frames_mask(tdsp.valid_frames(torch.from_numpy(lengths), n_fft, hop),
                            spec.shape[1]), fm)


@pytest.mark.parametrize("fs", RATES)
def test_reflect_tail_encode_decode_match(fs):
    x, lengths = _batch(fs, 2)
    jc, tc = jdsp.STFTConfig(), tdsp.STFTConfig()
    n_fft = tc.geometry(fs)[0]
    xt = tdsp.reflect_tail(torch.from_numpy(x), torch.from_numpy(lengths), n_fft // 2)
    xj = jdsp.reflect_tail(jnp.asarray(x), jnp.asarray(lengths), n_fft // 2)
    _close(xt, xj)
    st, sj = tdsp.stft_encode(xt, fs, tc), jdsp.stft_encode(xj, fs, jc)
    _close(st.real, sj.real)
    _close(st.imag, sj.imag)
    _close(tdsp.stft_decode(st, fs, tc, length=x.shape[1]),
           jdsp.stft_decode(sj, fs, jc, length=x.shape[1]))


def test_exponent_spec_transform_matches():
    """The flow model's compression (|S|^0.5 * 0.15) and its inverse."""
    x, _ = _batch(16000, 3)
    jc = jdsp.STFTConfig(n_fft=1536, hop_length=384, spec_transform_type="exponent")
    tc = tdsp.STFTConfig(n_fft=1536, hop_length=384, spec_transform_type="exponent")
    sj = jdsp.stft_encode(jnp.asarray(x), 16000, jc)
    st = tdsp.stft_encode(torch.from_numpy(x), 16000, tc)
    _close(st.real, sj.real)
    _close(st.imag, sj.imag)
    _close(tdsp.stft_decode(st, 16000, tc, length=x.shape[1]),
           jdsp.stft_decode(sj, 16000, jc, length=x.shape[1]))
