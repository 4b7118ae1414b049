"""Online dynamic-mixing dataset (counterpart of ``data/dynamic.py``): each
item is simulated when it is loaded.

The index space is the concatenation of the per-rate speech lists.  Each
item draws a recipe (the wind-noise gate, then the number and kinds of
augmentations: ``_sample_recipe``), then its parameters
(``simulation/params.sample_meta``), and renders it with
``simulation/render.render_one``, the renderer of offline simulation.

Every recipe draw comes from ``rng``: the global ``np.random`` state by
default, as in the JAX package, or an explicit ``np.random.RandomState``;
one seed gives the JAX package's draws in the same order.  In the loader's
process pool each worker holds its own copy of the dataset, and so of an
explicit RandomState.

Where no codec backend exists (``simulation/dsp.codecs_available()``),
"codec" leaves the augmentation pool and the other weights renormalise,
with a warning: the JAX package's rule.

The module imports numpy and scipy only (no torch), so a spawned loader
worker stays light.
"""

from __future__ import annotations

import copy
import warnings

import numpy as np

from urgent2026_challenge_track1_tpu_torch.data.scp import read_kv_scp, read_source_scp
from urgent2026_challenge_track1_tpu_torch.simulation import dsp as sim_dsp
from urgent2026_challenge_track1_tpu_torch.simulation import params as sim_params
from urgent2026_challenge_track1_tpu_torch.simulation import render as sim_render
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["DynamicMixingDataset"]


class DynamicMixingDataset:
    def __init__(
        self,
        speech_source_scp,
        noise_source_scp,
        rir_scp,
        windnoise_scp,
        speech_length_file,
        use_high_pass=True,
        retry_when_fails=False,
        max_duration=240000,
        simulation_configs=None,
        rng=None,
    ):
        self.rng = rng  # None: the global np.random state
        self.cfg = simulation_configs or sim_params.SimulationConfigs
        self.speech_source, self.speech_uids, self.speech_source_flt = read_source_scp(
            speech_source_scp
        )
        self.noise_source, self.noise_uids, self.noise_source_flt = read_source_scp(
            noise_source_scp
        )
        self.rirs, self.rir_uids, self.rirs_flt = read_source_scp(rir_scp)
        self.wind_noises, self.wind_noises_uids, self.wind_noises_flt = read_source_scp(
            windnoise_scp
        )
        self.all_noise_flt = copy.deepcopy(self.noise_source_flt)
        self.all_noise_flt.update(self.wind_noises_flt)

        self.source_length = {
            k: min(int(v), max_duration)
            for k, v in read_kv_scp(speech_length_file).items()
        }
        self.max_duration = max_duration
        self.length = sum(len(self.speech_source[k]) for k in self.speech_source)
        self.samplerates = list(self.speech_source.keys())
        self.fs_sub_lengths = [len(self.speech_source[k]) for k in self.samplerates]
        self.accum_lengths = [
            sum(self.fs_sub_lengths[: i + 1]) for i in range(len(self.fs_sub_lengths))
        ]

        augs = dict(self.cfg.augmentations)
        if "codec" in augs and not sim_dsp.codecs_available():
            warnings.warn(
                "no codec backend (libavcodec shim or ffmpeg): 'codec' augmentation "
                "disabled, weights renormalized"
            )
            augs = {k: v for k, v in augs.items() if k != "codec"}
        self.augmentations = list(augs.keys())
        w = np.array([v["weight"] for v in augs.values()], dtype=float)
        self.weight_augmentations = w / w.sum()
        self.use_high_pass = use_high_pass
        self.retry_when_fails = retry_when_fails

    # -- sampler interface ---------------------------------------------------

    def get_srs(self):
        return [self._get_from_index(i)[0] for i in range(len(self))]

    def get_source_length(self):
        out = []
        for i in range(len(self)):
            fs, real_idx = self._get_from_index(i)
            out.append(self.source_length[self.speech_uids[fs][real_idx]])
        return out

    def __len__(self):
        return self.length

    def _get_from_index(self, index):
        previous = 0
        for i, fs in enumerate(self.samplerates):
            if previous <= index < self.accum_lengths[i]:
                return fs, index - previous
            previous = self.accum_lengths[i]
        raise IndexError(index)

    # -- simulation ----------------------------------------------------------

    @property
    def _rng(self):
        return np.random if self.rng is None else self.rng

    def _sample_recipe(self):
        """(use_wind_noise, aug): the augmentation-chain draw (reference
        dataset.py:232-257)."""
        rng = self._rng
        use_wind_noise = rng.random() < self.cfg.prob_wind_noise
        num_aug = rng.choice(
            list(self.cfg.num_augmentations.keys()),
            p=list(self.cfg.num_augmentations.values()),
        )
        num_aug = min(num_aug, len(self.augmentations))
        if use_wind_noise:
            # wind-noise simulation already clips; the re-roll below rejects
            # chains containing clipping, so cap num_aug at the clipping-free
            # pool size or the rejection loop could never terminate (the
            # reference always has a 4-item pool; ours may have dropped codec)
            num_aug = min(
                num_aug, len([a for a in self.augmentations if a != "clipping"])
            )
        if num_aug == 0:
            aug = "none"
        else:
            aug = rng.choice(
                self.augmentations, p=self.weight_augmentations,
                size=num_aug, replace=False,
            )
            # never double-apply clipping on top of the wind-noise clip
            while use_wind_noise and "clipping" in aug:
                aug = rng.choice(
                    self.augmentations, p=self.weight_augmentations,
                    size=num_aug, replace=False,
                )
        return use_wind_noise, aug

    def run_simulation(self, speech_uid, speech_length, sr):
        use_wind_noise, aug = self._sample_recipe()

        info = sim_params.sample_meta(
            self.cfg,
            speech_length,
            sr,
            noise_dic=self.noise_source,
            used_noise_dic=None,
            wind_noise_dic=self.wind_noises,
            used_wind_noise_dic=None,
            use_wind_noise=use_wind_noise,
            snr_range=(self.cfg.snr_low_bound, self.cfg.snr_high_bound),
            wind_noise_snr_range=(
                self.cfg.wind_noise_config["wind_noise_snr_low_bound"],
                self.cfg.wind_noise_config["wind_noise_snr_high_bound"],
            ),
            store_noise=False,
            rir_dic=self.rirs,
            used_rir_dic=None,
            augmentations=aug,
            force_1ch=True,
            rng=self._rng,
        )
        info["speech_uid"] = speech_uid
        info["id"] = speech_uid
        info["snr_dB"] = info["snr"]

        return sim_render.render_one(
            info,
            store_noise=False,
            speech_dic=self.speech_source_flt,
            noise_dic=self.all_noise_flt,
            rir_dic=self.rirs_flt,
            highpass=self.use_high_pass,
            on_the_fly=True,
            max_duration=self.max_duration,
        )

    def __getitem__(self, index):
        speech_fs, real_idx = self._get_from_index(index)
        speech_uid = self.speech_uids[speech_fs][real_idx]
        speech_path = self.speech_source[speech_fs][speech_uid]
        speech_length = min(self.max_duration, audio_io.info_frames(speech_path))

        if self.retry_when_fails:
            for _ in range(3):
                try:
                    speech, noisy, fs = self.run_simulation(
                        speech_uid, speech_length, speech_fs
                    )
                    return speech, noisy, fs, speech_length
                except Exception:
                    continue
            data, fs = audio_io.read(speech_path)
            speech = data[None, :] if data.ndim == 1 else data.T
            print("Simulation Failed after 3 times try, return clean speech")
            return speech, speech, fs, speech_length

        speech, noisy, fs = self.run_simulation(speech_uid, speech_length, speech_fs)
        return speech, noisy, fs, speech_length
