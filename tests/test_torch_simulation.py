"""The port's host simulation (``simulation/dsp.py``, ``params.py``,
``render.py`` and the sidechain compressor) against the JAX package's on
the CPU, for one seed.

Every comparison is exact (bitwise): both packages run the same numpy/scipy
calls on the same float64 inputs, the same C++ compressor built with the
same g++ flags, and the same random draws in the same order.  Signals are
a fraction of a second at 8-16 kHz."""

import random

import numpy as np
import pytest

from urgent2026_challenge_track1_tpu.ops import native as jnative
from urgent2026_challenge_track1_tpu.simulation import dsp as jdsp
from urgent2026_challenge_track1_tpu.simulation import params as jparams
from urgent2026_challenge_track1_tpu.simulation import render as jrender
from urgent2026_challenge_track1_tpu.utils import audio_io as jaio
from urgent2026_challenge_track1_tpu.utils import codec_av as jcodec
from urgent2026_challenge_track1_tpu_torch.simulation import dsp as tdsp
from urgent2026_challenge_track1_tpu_torch.simulation import params as tparams
from urgent2026_challenge_track1_tpu_torch.simulation import render as trender
from urgent2026_challenge_track1_tpu_torch.utils import audio_io as taio
from urgent2026_challenge_track1_tpu_torch.utils import native as tnative

FS = 16000


def _speech(n, seed, ch=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    env = (np.sin(2 * np.pi * 3.0 * t) > -0.2).astype(np.float64)  # silent gaps
    x = env * (0.3 * np.sin(2 * np.pi * rng.uniform(150, 300) * t)) + 0.01 * rng.standard_normal(n)
    return np.tile(x, (ch, 1))


def _rir(n, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((1, n)) * np.exp(-np.arange(n) / (0.05 * FS))
    h[0, :40] = 0.0
    h[0, 40] = 1.5
    return h


def test_detect_non_silence_and_high_pass():
    x = _speech(6000, 0)
    assert np.array_equal(tdsp.detect_non_silence(x), jdsp.detect_non_silence(x))
    assert np.array_equal(tdsp.detect_non_silence(x[:, :500]), jdsp.detect_non_silence(x[:, :500]))
    assert np.array_equal(tdsp.high_pass_filter(x, FS), jdsp.high_pass_filter(x, FS))


@pytest.mark.parametrize("res_type", ["soxr_hq", "kaiser_best", "kaiser_fast", "polyphase",
                                      "scipy", "fft"])
@pytest.mark.parametrize("orig, target", [(16000, 8000), (8000, 22050), (16000, 16000)])
def test_resample_every_method(res_type, orig, target):
    x = _speech(3001, 1)
    got = tdsp.resample(x, orig, target, res_type)
    assert np.array_equal(got, jdsp.resample(x, orig, target, res_type))
    assert tdsp.RESAMPLE_METHODS == jdsp.RESAMPLE_METHODS
    assert tdsp.SAMPLE_RATES == jdsp.SAMPLE_RATES


def test_resample_unknown_method_raises():
    with pytest.raises(ValueError, match="res_type"):
        tdsp.resample(_speech(100, 2), 16000, 8000, "sinc_best")


def test_reverb_noise_and_augmentations():
    x, rir = _speech(5000, 3), _rir(800, 4)
    assert np.array_equal(tdsp.add_reverberation(x, rir), jdsp.add_reverberation(x, rir))
    assert np.array_equal(tdsp.estimate_early_rir(rir, fs=FS), jdsp.estimate_early_rir(rir, fs=FS))
    for n_noise in (3000, 5000, 9000):  # shorter (wrap), equal, longer (crop)
        noise = _speech(n_noise, 5) + 0.1 * np.random.default_rng(6).standard_normal(n_noise)
        got = tdsp.mix_noise(x, noise, snr=3.5, rng=np.random.default_rng(7))
        ref = jdsp.mix_noise(x, noise, snr=3.5, rng=np.random.default_rng(7))
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        args = (x, noise, FS, 0.2, 8.0, 20.0, 50.0, 1.1, True, 0.9, -2.0)
        got = tdsp.wind_noise_mix(*args, rng=np.random.default_rng(8))
        ref = jdsp.wind_noise_mix(*args, rng=np.random.default_rng(8))
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    for fs_new, res_type in ((8000, "kaiser_best"), (12000, "scipy"), (FS, "polyphase")):
        assert np.array_equal(tdsp.bandwidth_limitation(x, FS, fs_new, res_type),
                              jdsp.bandwidth_limitation(x, FS, fs_new, res_type))
    x2 = _speech(5000, 9, ch=2)
    assert np.array_equal(tdsp.clipping(x2, 0.05, 0.9), jdsp.clipping(x2, 0.05, 0.9))
    idx = [0, 3, 4, 17]
    assert np.array_equal(tdsp.packet_loss_apply(x2, FS, idx, 20),
                          jdsp.packet_loss_apply(x2, FS, idx, 20))
    assert tdsp.codecs_available() == jdsp.codecs_available()


def test_sidechain_compressor_native_and_plain():
    rng = np.random.default_rng(10)
    speech, side = rng.standard_normal(4000) * 0.3, rng.standard_normal(4000) * 0.5
    args = (speech, side, FS, 0.15, 6.0, 10.0, 80.0, 1.2)
    assert tnative.native_available()
    got = tnative.sidechain_compress(*args)
    assert np.array_equal(got, jnative.sidechain_compress(*args))
    plain = tnative._sidechain_compress_numpy(*args)
    assert np.array_equal(plain, jnative._sidechain_compress_numpy(*args))
    # the C++ loop and the numpy loop differ only in libm's exp/log roundings
    assert np.abs(got - plain).max() < 1e-12
    with pytest.raises(ValueError, match="equal-length"):
        tnative.sidechain_compress(speech, side[:100], FS, 0.1, 2.0, 5.0, 5.0)


def _pools():
    noise = {16000: {"n1": "a", "n2": "b"}, 48000: {"n3": "c"}}
    wind = {48000: {"wind_noise_1": "w"}}
    rirs = {16000: {"r1": "x"}, 8000: {"r2": "y"}}
    return noise, wind, rirs


@pytest.mark.parametrize("use_wind", [False, True])
@pytest.mark.parametrize("augs", ["none", ["bandwidth_limitation"],
                                  ["packet_loss", "clipping", "codec"],
                                  ["clipping", "bandwidth_limitation", "packet_loss"]],
                         ids=["none", "bw", "pl-clip-codec", "clip-bw-pl"])
def test_sample_meta_equals_jax_for_one_seed(use_wind, augs):
    """Same seed: the port's explicit RandomState, the JAX package's global
    state; and the port on the global state as well."""
    noise, wind, rirs = _pools()

    def call(params, **kw):
        return params.sample_meta(params.SimulationConfigs, 24000, 16000, noise, None, wind,
                                  None, snr_range=(-5, 20), wind_noise_snr_range=(-10, 15),
                                  use_wind_noise=use_wind, rir_dic=rirs, used_rir_dic=None,
                                  augmentations=augs, **kw)

    for seed in (0, 1, 2):
        np.random.seed(seed)
        ref = call(jparams)
        after = np.random.random()
        rng = np.random.RandomState(seed)
        assert call(tparams, rng=rng) == ref
        assert rng.random() == after  # the same number of draws
        np.random.seed(seed)
        assert call(tparams) == ref


def test_select_sample_reuse_and_weighted_sample():
    for seed in range(4):
        for fs in (8000, 16000, 44100):
            jn, tn = _pools()[0], _pools()[0]
            ju, tu = {k: {} for k in jn}, {k: {} for k in tn}
            np.random.seed(seed)
            ref = [jparams.select_sample(fs, jn, ju, reuse_sample=True) for _ in range(4)]
            rng = np.random.RandomState(seed)
            got = [tparams.select_sample(fs, tn, tu, reuse_sample=True, rng=rng) for _ in range(4)]
            assert got == ref and tn == jn and tu == ju
    pop = ["a", "b", "c", "d"]
    assert (tparams.weighted_sample(pop, [1, 2, 3, 4], 3, rng=np.random.RandomState(5))
            == jparams.weighted_sample(pop, [1, 2, 3, 4], 3, rng=np.random.RandomState(5)))


@pytest.fixture()
def sources(tmp_path):
    paths = {}
    for name, wav, fs, fmt in (("sp1", _speech(9000, 11)[0], FS, "flac"),
                               ("sp8k", _speech(4000, 12)[0], 8000, "wav"),
                               ("n1", 0.2 * np.random.default_rng(13).standard_normal(7000), FS,
                                "wav"),
                               ("wind_noise_1", 0.3 * np.random.default_rng(14).standard_normal(
                                   12000), 48000, "flac"),
                               ("r1", _rir(600, 15)[0] / 2.0, FS, "wav")):
        p = tmp_path / f"{name}.{fmt}"
        jaio.write(str(p), wav, fs)
        paths[name] = str(p)
    return paths


INFOS = [
    dict(speech_uid="sp1", noise_uid="n1", rir_uid="r1", snr_dB=4.0, fs=FS, length=8000,
         augmentation="bandwidth_limitation-kaiser_fast->8000/clipping(min=0.02,max=0.95)"),
    dict(speech_uid="sp1", noise_uid="wind_noise_1", rir_uid="none", snr_dB=-3.0, fs=FS,
         length=8000, augmentation=(
             "wind_noise(threshold=0.2,ratio=5.0,attack=10.0,release=60.0,sc_gain=1.0,"
             "clipping=True,clipping_threshold=0.9)/packet_loss(packet_loss_indices=[1, 2, 9],"
             "packet_duration_ms=20)")),
    dict(speech_uid="sp8k", noise_uid="n1", rir_uid="none", snr_dB=10.0, fs=FS, length=8000,
         augmentation="none"),
]


@pytest.mark.parametrize("info", INFOS, ids=["reverb-bw-clip", "wind-pl", "resampled"])
def test_render_one_on_the_fly_equals_jax(sources, info, monkeypatch):
    """The on-the-fly renderer draws its noise offset from a fresh
    ``np.random.default_rng()`` and crops long sources with ``random``;
    both are pinned to one seed for the two packages."""
    fresh = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: fresh(1234 if seed is None else seed))
    info = dict(info, id=info["speech_uid"])
    kw = dict(store_noise=False, speech_dic=sources, noise_dic=sources, rir_dic=sources,
              highpass=True, on_the_fly=True, max_duration=8000)
    random.seed(0)
    ref = jrender.render_one(dict(info), **kw)
    random.seed(0)
    got = trender.render_one(dict(info), **kw)
    assert got[2] == ref[2] == FS
    assert got[0].shape == (1, 8000) and np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1])


def test_render_one_offline_writes_what_jax_writes(sources, tmp_path):
    info = dict(INFOS[0], id="fileid_17", max_duration=-1)
    out = {}
    for name, render in (("jax", jrender), ("port", trender)):
        paths = {k: str(tmp_path / f"{name}_{k}.wav") for k in ("clean", "noisy", "noise")}
        render.render_one(dict(info, clean_path=paths["clean"], noisy_path=paths["noisy"],
                               noise_path=paths["noise"], length=9000),
                          store_noise=True, speech_dic=sources, noise_dic=sources,
                          rir_dic=sources, highpass=True)
        out[name] = [taio.read(p)[0] for p in paths.values()]
    assert all(np.array_equal(a, b) for a, b in zip(out["port"], out["jax"]))


@pytest.mark.skipif(not jcodec.available(), reason="FFmpeg libraries not present")
def test_codec_entries_raise_with_their_item():
    """A codec entry renders as the JAX package's does, bitwise (it raised
    before the codec port; the name is kept)."""
    chain = "codec(format=mp3,encoder=None,qscale=3)"
    x = _speech(4000, 16)
    got = trender.apply_augmentations(x, FS, chain)
    assert got.shape == x.shape
    assert np.array_equal(got, jrender.apply_augmentations(x, FS, chain))
