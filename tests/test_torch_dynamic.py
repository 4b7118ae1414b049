"""The port's dynamic-mixing dataset and its process-pool loader on the CPU.

* ``DynamicMixingDataset.__getitem__`` over a few indices, single-process,
  is bitwise equal to the JAX package's from the same seeded state: the
  port draws from an explicit ``np.random.RandomState(seed)``, the JAX
  package from ``np.random.seed(seed)``; the on-the-fly noise offset
  (``np.random.default_rng()``) and long-source crops (``random``) are
  pinned to one seed for both.  Deviation, named here because it is
  ROADMAP A16b's: codec augmentation is off on both sides, the port by its
  ``codecs_available()`` and the JAX package by monkeypatching its own, so
  both drop "codec" from the pool and renormalise the weights.
* the spawned process-pool loader yields batches of the right shapes, and
  its workers do not import torch;
* a train step of a 16 ch x 1 model on a Config read from
  ``conf/models/BSRNN_baseline_dm.yaml`` with ``device="cpu"``.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_dm_corpus import MAX_DURATION, make_corpus, make_valid
from urgent2026_challenge_track1_tpu.data import dynamic as jdynamic
from urgent2026_challenge_track1_tpu.simulation import params as jparams
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.data import dataset as tdataset
from urgent2026_challenge_track1_tpu_torch.data import dynamic as tdynamic
from urgent2026_challenge_track1_tpu_torch.simulation import params as tparams

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent


def _kwargs(root: Path, cfg):
    return dict(speech_source_scp=str(root / "speech_sources.scp"),
                noise_source_scp=str(root / "noise_scoures.scp"), rir_scp=str(root / "rirs.scp"),
                windnoise_scp=str(root / "wind_noise_scoures.scp"),
                speech_length_file=str(root / "source_length.scp"), max_duration=MAX_DURATION,
                simulation_configs=cfg)


class _JCfg(jparams.SimulationConfigs):
    prob_wind_noise = 0.4  # so that a few indices reach the wind-noise branch


class _TCfg(tparams.SimulationConfigs):
    prob_wind_noise = 0.4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("dm"))


@pytest.mark.parametrize("seed", [0, 3])
def test_items_equal_jax_for_one_seed(corpus, monkeypatch, seed):
    monkeypatch.setattr(jdynamic.sim_dsp, "codecs_available", lambda: False)
    fresh = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: fresh(77 if s is None else s))
    with pytest.warns(UserWarning, match="codec"):
        ref_ds = jdynamic.DynamicMixingDataset(**_kwargs(corpus, _JCfg))
    with pytest.warns(UserWarning, match="A16b"):
        ds = tdynamic.DynamicMixingDataset(**_kwargs(corpus, _TCfg),
                                           rng=np.random.RandomState(seed))
    assert ds.augmentations == ref_ds.augmentations == ["bandwidth_limitation", "clipping",
                                                        "packet_loss"]
    assert np.array_equal(ds.weight_augmentations, ref_ds.weight_augmentations)
    assert len(ds) == len(ref_ds) == 6
    assert ds.get_srs() == ref_ds.get_srs() and ds.get_source_length() == ref_ds.get_source_length()
    np.random.seed(seed)
    random.seed(seed)
    ref = [ref_ds[i] for i in (0, 1, 2, 5, 1, 4)]
    random.seed(seed)
    got = [ds[i] for i in (0, 1, 2, 5, 1, 4)]
    for (s, n, fs, length), (rs, rn, rfs, rlength) in zip(got, ref):
        assert (fs, length) == (rfs, rlength) and s.shape == (1, length)
        assert np.array_equal(s, rs) and np.array_equal(n, rn)


def test_recipes_follow_the_seed(corpus):
    """The recipe stream is the RandomState's: one seed, one stream."""
    with pytest.warns(UserWarning):
        a = tdynamic.DynamicMixingDataset(**_kwargs(corpus, _TCfg), rng=np.random.RandomState(5))
        b = tdynamic.DynamicMixingDataset(**_kwargs(corpus, _TCfg), rng=np.random.RandomState(5))
    ra = [(w, list(x) if isinstance(x, np.ndarray) else [x]) for w, x in
          (a._sample_recipe() for _ in range(20))]
    rb = [(w, list(x) if isinstance(x, np.ndarray) else [x]) for w, x in
          (b._sample_recipe() for _ in range(20))]
    assert ra == rb
    assert any(w for w, _ in ra) and not any(w and "clipping" in x for w, x in ra)


def _dm_config(root: Path, valid: Path, **over) -> Config:
    cfg = Config(config_file=str(REPO / "conf/models/BSRNN_baseline_dm.yaml"), device="cpu")
    cfg.read_yaml()
    assert cfg.train_set_dynamic_mixing and cfg.model_configs == {"num_channel": 196,
                                                                  "num_layer": 6}
    base = dict(train_set_path=str(root), valid_set_path=str(valid), batch_size=2,
                max_duration=MAX_DURATION, length_bucket_ms=250, num_train_epochs=1,
                val_check_interval=3, log_every_steps=1, train_tag="dm",
                model_configs={"num_channel": 16, "num_layer": 1})
    base.update(over)
    for k, v in base.items():
        setattr(cfg, k, v)
    return cfg


def test_process_pool_loader_yields_batches(corpus, tmp_path):
    cfg = _dm_config(corpus, make_valid(tmp_path / "valid"))
    dm = tdataset.AudioDataModule(cfg)
    assert isinstance(dm.train_dataset, tdynamic.DynamicMixingDataset)
    loader = dm.train_dataloader(epoch=0)
    assert loader.use_processes and loader.num_workers == 2  # num_worker of the YAML
    batches = list(loader)
    assert len(batches) == len(loader) == 3  # 16 kHz: 4 sources, 8 kHz: 2
    for clean, noisy, fs, lengths in batches:
        assert fs in (8000, 16000) and clean.shape == noisy.shape
        assert clean.shape[:2] == (2, 1) and clean.dtype == np.float32
        assert clean.shape[2] % (fs // 4) == 0 and lengths.max() <= clean.shape[2]
        assert np.isfinite(noisy).all() and (lengths <= MAX_DURATION).all()
        assert np.abs(noisy[0, 0, lengths[0]:]).max(initial=0.0) == 0.0


def test_spawned_workers_do_not_import_torch(corpus):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with pytest.warns(UserWarning):  # the package's own configs: nothing of this module
        ds = tdynamic.DynamicMixingDataset(**_kwargs(corpus, None))
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                             initializer=tdataset._init_worker, initargs=(ds,)) as pool:
        item = pool.submit(tdataset._worker_get, 2).result()
        assert item[0].shape == (1, item[3])
        # a builtin, so that unpickling the call imports nothing
        assert pool.submit(eval, "'torch' in __import__('sys').modules").result() is False


def test_dm_yaml_trains_a_tiny_model_on_the_cpu(corpus, tmp_path, monkeypatch):
    from urgent2026_challenge_track1_tpu_torch import train_se

    monkeypatch.chdir(tmp_path)
    cfg = _dm_config(corpus, make_valid(tmp_path / "valid"))
    state = train_se.run(cfg)
    assert (state.step, state.epoch) == (3, 1)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_on_device_render_still_raises_with_its_item(corpus, tmp_path):
    cfg = _dm_config(corpus, make_valid(tmp_path / "valid"), dynamic_mixing_on_device=True)
    with pytest.raises(NotImplementedError, match="A13b"):
        tdataset.AudioDataModule(cfg)
