"""The port's on-device dynamic-mixing render (``simulation/torch_dsp.py``,
``data/dynamic_device.py`` and ``train/trainer.make_train_step_rendered``)
against the JAX package's (``simulation/jax_dsp.py``,
``data/dynamic_device.py``, ``train/trainer.make_train_step_rendered``) on
the CPU, at 8-16 kHz, B = 3, at most 0.5 s, float32.

* every ``torch_dsp`` function against its ``jax_dsp`` counterpart: the
  masks (VAD, early RIR, packet loss) and the quantiles bitwise or within
  one rounding; the FFT paths (convolution, high-pass, bandwidth masks at a
  power-of-two and another T, the FIR low-pass) and ``render_batch``
  within RENDER_ATOL, with ``aug_order`` None and permuted;
* ``render_batch``'s control: the same batch with ``aug_order`` rolled by
  one step must differ from the JAX render by more than 100 x RENDER_ATOL;
* the ``DynamicMixingSourceDataset`` items and ``collate_device_render``
  bitwise for one seed, with codec augmentation as the machine allows it
  in both packages and the JAX config pinned as
  ``tests/test_torch_dynamic.py`` pins it; its spawned workers import no
  torch;
* one ``make_train_step_rendered`` step at 16 ch x 2 against the JAX
  step: the loss within 1e-5 relative, the grad norm within 1e-4 relative.

The trainer's run of the dm YAML with ``dynamic_mixing_on_device`` over
``tests/torch_dm_corpus.py`` is ``tests/test_torch_dynamic.py``'s.

RENDER_ATOL is 5e-6 absolute (XLA's CPU FFT against pocketfft): the
largest readings were 6.9e-7 over the renders (peak-normalised to 0.9) and
1.2e-6 for the bare convolution (values up to about 3); the control reads
0.09 or more."""

import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dynamic import _JCfg, _TCfg, _kwargs, pinned_jax_config  # noqa: F401
from torch_dm_corpus import make_corpus
from urgent2026_challenge_track1_tpu.config import Config as JConfig
from urgent2026_challenge_track1_tpu.data import dynamic_device as jdd
from urgent2026_challenge_track1_tpu.simulation import jax_dsp as J
from urgent2026_challenge_track1_tpu.train import trainer as jtrainer
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.data import dataset as tdataset
from urgent2026_challenge_track1_tpu_torch.data import dynamic_device as tdd
from urgent2026_challenge_track1_tpu_torch.simulation import torch_dsp as Tt
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)
RENDER_ATOL = 5e-6
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
FS, B = 16000, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _maxd(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())


def _speech(n, seed, fs=FS):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    gate = (np.sin(2 * np.pi * 3.0 * t) > -0.2)
    rows = [gate * 0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t)
            + 0.01 * rng.standard_normal(n) for _ in range(B)]
    return np.stack(rows).astype(np.float32)


def _rirs(L, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, L)) * np.exp(-np.arange(L) / 300.0)
    h[:, :30] = 0.0
    h[:, 30 + 10 * np.arange(B)] = 1.0
    return (0.5 * h).astype(np.float32)


LENGTHS = np.array([6000, 4100, 700], np.int32)  # the last shorter than one VAD frame


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_vad_and_mix_match_jax(masked):
    x = _speech(6000, 0)
    x[1, 3000:] *= 1e-4  # a quiet half
    noise = 0.2 * np.random.default_rng(1).standard_normal((B, 6000)).astype(np.float32)
    lengths = LENGTHS if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else _t(lengths)
    for sig in (x, x[:, :900]):  # the second shorter than one frame: all ones
        ref = np.asarray(J.detect_non_silence_mask(jnp.asarray(sig), lengths=jl))
        assert np.array_equal(Tt.detect_non_silence_mask(_t(sig), lengths=tl).numpy(), ref)
    snr = np.array([5.0, -2.5, 12.0], np.float32)
    got = Tt.mix_at_snr(_t(x), _t(noise), _t(snr), lengths=tl)
    ref = J.mix_at_snr(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(snr), lengths=jl)
    for g, r in zip(got, ref):
        assert _maxd(g, r) < RENDER_ATOL


def test_convolution_reverb_mask_and_filters_match_jax():
    x, h = _speech(5000, 2), _rirs(900, 3)
    assert _maxd(Tt.fft_convolve(_t(x), _t(h)), J.fft_convolve(jnp.asarray(x),
                                                               jnp.asarray(h))) < RENDER_ATOL
    for fs in (8000, 16000):
        assert np.array_equal(Tt.early_rir_mask(_t(h), fs).numpy(),
                              np.asarray(J.early_rir_mask(jnp.asarray(h), fs)))
        assert _maxd(Tt.high_pass(_t(x), fs), J.high_pass(jnp.asarray(x), fs)) < RENDER_ATOL
    for fs_new in (4000, 8000, 16000):
        assert _maxd(Tt.bandwidth_lowpass(_t(x), FS, fs_new),
                     J.bandwidth_lowpass(jnp.asarray(x), FS, fs_new)) < RENDER_ATOL


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_quantile_clip_matches_jax(masked):
    x = _speech(6000, 4) + 0.05 * np.random.default_rng(5).standard_normal((B, 6000)).astype(
        np.float32)
    lo = np.array([0.0, 0.05, 0.13], np.float32)
    hi = np.array([1.0, 0.9, 0.77], np.float32)
    lengths = LENGTHS if masked else None
    got = Tt.quantile_clip(_t(x), _t(lo), _t(hi), None if lengths is None else _t(lengths))
    ref = J.quantile_clip(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi),
                          None if lengths is None else jnp.asarray(lengths))
    assert _maxd(got, ref) <= 6e-8  # one float32 rounding of the interpolation
    if masked:  # the padding is left as it was
        assert np.array_equal(got[2, 700:].numpy(), x[2, 700:])


def _bw_masks(T, fs, cuts):
    freqs = np.fft.rfftfreq(T, 1.0 / fs)
    return np.stack([(freqs <= c / 2).astype(np.float32) for c in cuts])


@pytest.mark.parametrize("T", [4096, 6000], ids=["pow2", "regrid"])
def test_bandwidth_mask_and_packet_loss_match_jax(T):
    x = _speech(T, 6)
    mask = _bw_masks(T, FS, (4000, 8000, FS))
    assert Tt.is_prefix_mask(mask) and Tt.is_prefix_mask(_t(mask))
    assert not Tt.is_prefix_mask(1.0 - mask)
    got = Tt.bandwidth_mask_apply(_t(x), _t(mask))
    assert _maxd(got, J.bandwidth_mask_apply(jnp.asarray(x), jnp.asarray(mask))) < RENDER_ATOL
    assert _maxd(got[2], x[2]) < RENDER_ATOL  # an all-ones mask passes the signal
    pm = np.ones((B, T // 320), np.float32)
    pm[0, [1, 3]] = 0.0
    pm[2, -1] = 0.0
    assert np.array_equal(Tt.apply_packet_loss(_t(x), _t(pm)).numpy(),
                          np.asarray(J.apply_packet_loss(jnp.asarray(x), jnp.asarray(pm))))


def _render_inputs(T=6000, seed=7):
    x = _speech(T, seed)
    rng = np.random.default_rng(seed + 1)
    pm = np.ones((B, T // 320), np.float32)
    pm[1, [2, 5, 6]] = 0.0
    return dict(
        speech=x, noise=(0.1 * rng.standard_normal((B, T))).astype(np.float32),
        rir=_rirs(800, seed + 2), snr_db=np.array([3.0, 8.0, -1.0], np.float32),
        use_rir=np.array([1.0, 0.0, 1.0], np.float32),
        clip_lo=np.array([0.0, 0.05, 0.02], np.float32),
        clip_hi=np.array([1.0, 0.9, 0.95], np.float32), packet_mask=pm,
        bw_mask=_bw_masks(T, FS, (8000, FS, 4000)))


ORDERS = {"canonical": None,
          "permuted": np.array([[2, 0, 1], [1, 2, 0], [0, 2, 1]], np.int32)}


@pytest.mark.parametrize("highpass", [True, False], ids=["hp", "no-hp"])
@pytest.mark.parametrize("order", list(ORDERS), ids=list(ORDERS))
@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_render_batch_matches_jax(order, masked, highpass):
    inp = _render_inputs()
    aug = ORDERS[order]
    lengths = LENGTHS if masked else None
    kw = dict(fs=FS, highpass=highpass)
    ref = J.render_batch(**{k: jnp.asarray(v) for k, v in inp.items()}, **kw,
                         lengths=None if lengths is None else jnp.asarray(lengths),
                         aug_order=None if aug is None else jnp.asarray(aug))
    got = Tt.render_batch(**{k: _t(v) for k, v in inp.items()}, **kw,
                          lengths=None if lengths is None else _t(lengths),
                          aug_order=None if aug is None else _t(aug))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and _maxd(g, r) < RENDER_ATOL
    rolled = np.roll(np.arange(3)[None].repeat(B, 0) if aug is None else aug, 1, axis=1)
    control = Tt.render_batch(**{k: _t(v) for k, v in inp.items()}, **kw,
                              lengths=None if lengths is None else _t(lengths),
                              aug_order=_t(rolled.astype(np.int32)))
    assert _maxd(control[1], ref[1]) > 100 * RENDER_ATOL


def _items_equal(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert isinstance(got[k], np.ndarray) and got[k].dtype == v.dtype, k
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("dmdev"))


@pytest.mark.parametrize("seed", [0, 3])
def test_source_items_and_collate_equal_jax(corpus, monkeypatch, pinned_jax_config, seed):
    fresh = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: fresh(77 if s is None else s))
    ref_ds = jdd.DynamicMixingSourceDataset(**_kwargs(corpus, _JCfg))
    ds = tdd.DynamicMixingSourceDataset(**_kwargs(corpus, _TCfg), rng=np.random.RandomState(seed))
    assert ds.augmentations == ref_ds.augmentations
    np.random.seed(seed)
    random.seed(seed)
    ref = [ref_ds[i] for i in (2, 3, 4, 5, 2, 3)]  # the 16 kHz sources
    random.seed(seed)
    got = [ds[i] for i in (2, 3, 4, 5, 2, 3)]
    for g, r in zip(got, ref):
        _items_equal(g, r)
    assert any(r["prerendered"] for r in ref) and not all(r["prerendered"] for r in ref)
    for chunk in (slice(0, 3), slice(3, 6)):
        for quantum in (250, 0):
            _items_equal(tdd.collate_device_render(got[chunk], quantum),
                         jdd.collate_device_render(ref[chunk], quantum))


def test_parse_augmentation_ops_equals_jax():
    chains = ["none", "packet_loss(packet_loss_indices=[1, 5],packet_duration_ms=20)/"
              "bandwidth_limitation-kaiser_fast->8000",
              "clipping(min=0.02,max=0.95)/clipping(min=0.1,max=0.8)",
              "codec(format=mp3,encoder=None,qscale=3)/clipping(min=0.0,max=0.9)"]
    for chain in chains:
        assert tdd.parse_augmentation_ops(chain, FS) == jdd.parse_augmentation_ops(chain, FS)


def test_render_on_device_equals_jax_and_keeps_prerendered_rows():
    inp = _render_inputs(T=8000)
    batch = {**inp, "aug_order": ORDERS["permuted"], "lengths": np.array([8000, 6100, 3000],
                                                                        np.int32),
             "prerendered_mask": np.array([0.0, 1.0, 0.0], np.float32),
             "clean_pre": np.full((B, 8000), 0.25, np.float32),
             "noisy_pre": np.full((B, 8000), -0.5, np.float32), "fs": FS}
    got = tdd.render_on_device(tdd.DeviceRenderBatch(batch), highpass=True, device="cpu")
    ref = jdd.render_on_device(jdd.DeviceRenderBatch(batch), highpass=True)
    for g, r in zip(got, ref):
        assert _maxd(g, r) < RENDER_ATOL
    assert bool((got[0][1] == 0.25).all()) and bool((got[1][1] == -0.5).all())
    assert ttrainer.RENDER_KEYS == tdd.RENDER_KEYS == jtrainer.RENDER_KEYS


def test_spawned_source_workers_do_not_import_torch(corpus):
    ds = tdd.DynamicMixingSourceDataset(**_kwargs(corpus, None))
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                             initializer=tdataset._init_worker, initargs=(ds,)) as pool:
        item = pool.submit(tdataset._worker_get, 2).result()
        assert item["fs"] == 16000 and item["length"] > 0
        assert pool.submit(eval, "'torch' in __import__('sys').modules").result() is False


MODEL = {"num_channel": 16, "num_layer": 2}


def test_rendered_step_matches_jax(corpus, monkeypatch, pinned_jax_config):
    fresh = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: fresh(5 if s is None else s))
    ds = tdd.DynamicMixingSourceDataset(**_kwargs(corpus, _TCfg), rng=np.random.RandomState(1))
    batch = tdd.collate_device_render([ds[i] for i in (2, 3, 4)], 250)
    fs = batch["fs"]
    jcfg = JConfig(model_configs=MODEL, use_pallas_lstm="false")
    jbundle = jtrainer.build_model(jcfg)
    params = jtrainer.init_params(jax.random.PRNGKey(0), jbundle)
    model = from_jax_params(jax.tree.map(np.asarray, params))
    optimizer = jtrainer.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.array, params)
    jstep = jtrainer.make_train_step_rendered(jbundle, optimizer, jcfg, fs)
    _, _, _, jm = jstep(jp, optimizer.init(jp), None, jax.random.PRNGKey(0),
                        *(jnp.asarray(batch[k]) for k in jtrainer.RENDER_KEYS))
    cfg = Config(model_configs=MODEL, device="cpu")
    assert cfg.use_high_pass == jcfg.use_high_pass
    step = ttrainer.make_train_step_rendered(ttrainer.build_model(cfg), cfg, fs)
    m = step(model, ttrainer.make_optimizer(cfg, model),
             *(torch.from_numpy(batch[k]) for k in ttrainer.RENDER_KEYS))
    assert not m["nan_grad"]
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_RTOL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) < GNORM_RTOL * float(
        jm["grad_norm"])
