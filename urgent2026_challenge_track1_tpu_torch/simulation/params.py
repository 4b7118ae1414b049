"""Simulation parameter sampling (counterpart of ``simulation/params.py``):
the recipe of one noisy utterance as pure metadata.

``sample_meta`` draws a recipe (noise or wind noise and its settings, the
SNR, whether to reverberate and with which RIR, the augmentation chain and
its parameters) and encodes the augmentations in the "/"-separated strings
of the reference's meta.tsv, which ``simulation/render.py`` parses.
``select_sample`` picks a source at the target rate, else at a higher one,
else (with reuse) from the used pool.

Every draw comes from ``rng``: the ``np.random`` module (its global state,
as in the JAX package) by default, or an explicit ``np.random.RandomState``.
A RandomState seeded with s yields the stream of ``np.random.seed(s)``, so
the same seed gives the same draws in the same order as the JAX package.

Kept from the reference: the reverb gate ``rand() <= prob_reverberation``
*skips* reverb with that probability.
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.simulation.dsp import (
    RESAMPLE_METHODS,
    SAMPLE_RATES,
)

__all__ = [
    "SimulationConfigs",
    "bandwidth_limitation_params",
    "packet_loss_indices",
    "select_sample",
    "sample_meta",
    "weighted_sample",
]


class SimulationConfigs:
    """Frozen online-mixing hyperparams (reference dataset.py:20-76, mirrors
    conf/simulation_train.yaml)."""

    snr_low_bound = -5.0
    snr_high_bound = 20.0
    reuse_noise = True
    prob_wind_noise = 0.05
    wind_noise_config = dict(
        threshold=[0.1, 0.3],
        ratio=[1, 20],
        attack=[5, 100],
        release=[5, 100],
        sc_gain=[0.8, 1.2],
        clipping_threshold=[0.85, 1.0],
        clipping_chance=0.75,
        wind_noise_snr_low_bound=-10.0,
        wind_noise_snr_high_bound=15.0,
    )
    prob_reverberation = 0.5
    reuse_rir = True

    augmentations_name = ["bandwidth_limitation", "clipping", "codec", "packet_loss"]

    num_augmentations = {0: 0.25, 1: 0.40, 2: 0.20, 3: 0.15}

    augmentations = dict(
        bandwidth_limitation=dict(weight=1.0, resample_methods="random"),
        clipping=dict(
            weight=1.0,
            clipping_min_quantile=[0.0, 0.1],
            clipping_max_quantile=[0.9, 1.0],
        ),
        codec=dict(
            weight=1.0,
            config=[
                dict(format="mp3", encoder=None, qscale=[1, 10]),
                dict(format="ogg", encoder=["vorbis"], qscale=[-1, 10]),
            ],
        ),
        packet_loss=dict(
            weight=1.0,
            packet_duration_ms=20,
            max_continuous_packet_loss=10,
            packet_loss_rate=[0.05, 0.25],
        ),
    )


def bandwidth_limitation_params(fs: int = 16000, res_type="random", rng=np.random):
    """(res_type, fs_new) draw (generate_data_param.py:34-55)."""
    fs_opts = [fs_new for fs_new in SAMPLE_RATES if fs_new < fs]
    if fs_opts:
        if res_type == "random":
            res_type = rng.choice(RESAMPLE_METHODS)
        fs_new = rng.choice(fs_opts)
    else:
        res_type = "none"
        fs_new = fs
    return res_type, fs_new


def packet_loss_indices(
    speech_length, fs, packet_duration_ms, packet_loss_rate, max_continuous_packet_loss,
    rng=np.random,
):
    """Indices of zeroed packets (generate_data_param.py:58-91)."""
    speech_duration_ms = speech_length / fs * 1000
    num_packets = int(speech_duration_ms // packet_duration_ms)
    rate = rng.uniform(*packet_loss_rate)
    packet_loss_duration_ms = rate * speech_duration_ms
    num_packet_loss = int(round(packet_loss_duration_ms / packet_duration_ms, 0))
    lengths = []
    for _ in range(num_packet_loss):
        lengths.append(rng.randint(1, max_continuous_packet_loss))
        if num_packet_loss - sum(lengths) <= max_continuous_packet_loss:
            lengths.append(num_packet_loss - sum(lengths))
            break
    starts = rng.choice(range(num_packets), len(lengths), replace=False)
    out = []
    for idx, length in zip(starts, lengths):
        out += list(range(idx, idx + length))
    return list(set(out))


def weighted_sample(population, weights, k, replace=True, rng=np.random):
    weights = np.array(weights, dtype=float)
    weights = weights / weights.sum()
    idx = rng.choice(range(len(population)), size=k, replace=replace, p=weights)
    return [population[i] for i in idx]


def select_sample(fs, sample_dic, used_sample_dic=None, reuse_sample=False, rng=np.random):
    """fs-aware pool selection (generate_data_param.py:421-452): prefer an
    unused sample at fs, else any higher fs, else (reuse) a used one."""
    if fs not in sample_dic.keys() or len(sample_dic[fs]) == 0:
        fs_opts = list(sample_dic.keys())
        rng.shuffle(fs_opts)
        for fs2 in fs_opts:
            if fs2 > fs and len(sample_dic[fs2]) > 0:
                uid = rng.choice(list(sample_dic[fs2].keys()))
                if used_sample_dic is not None:
                    sample = sample_dic[fs2].pop(uid)
                    used_sample_dic[fs2][uid] = sample
                else:
                    sample = sample_dic[fs2][uid]
                break
        else:
            if reuse_sample:
                return select_sample(fs, used_sample_dic, reuse_sample=False, rng=rng)
            return None, None
    else:
        uid = rng.choice(list(sample_dic[fs].keys()))
        if used_sample_dic is not None:
            sample = sample_dic[fs].pop(uid)
            used_sample_dic[fs][uid] = sample
        else:
            sample = sample_dic[fs][uid]
    return uid, sample


def sample_meta(
    cfg,
    speech_length,
    fs,
    noise_dic,
    used_noise_dic,
    wind_noise_dic,
    used_wind_noise_dic,
    snr_range,
    wind_noise_snr_range,
    use_wind_noise,
    store_noise=False,
    rir_dic=None,
    used_rir_dic=None,
    augmentations="none",
    force_1ch=True,
    rng=np.random,
):
    """One augmentation recipe -> meta dict (generate_data_param.py:294-418),
    every draw from ``rng``.

    ``cfg`` provides attributes: wind_noise_config, reuse_noise, reuse_rir,
    prob_reverberation, augmentations (dict).  The augmentation string format
    is preserved verbatim for meta.tsv round-tripping.
    """
    if use_wind_noise:
        noise_uid, _ = select_sample(
            fs, wind_noise_dic, used_sample_dic=used_wind_noise_dic, reuse_sample=True,
            rng=rng,
        )
        wn_conf = cfg.wind_noise_config
        threshold = rng.uniform(*wn_conf["threshold"])
        ratio = rng.uniform(*wn_conf["ratio"])
        attack = rng.uniform(*wn_conf["attack"])
        release = rng.uniform(*wn_conf["release"])
        sc_gain = rng.uniform(*wn_conf["sc_gain"])
        clipping_threshold = rng.uniform(*wn_conf["clipping_threshold"])
        clipping = rng.random() < wn_conf["clipping_chance"]
        augmentation_config = (
            "wind_noise("
            f"threshold={threshold},ratio={ratio},"
            f"attack={attack},release={release},"
            f"sc_gain={sc_gain},clipping={clipping},"
            f"clipping_threshold={clipping_threshold})/"
        )
        snr = rng.uniform(*wind_noise_snr_range)
    else:
        noise_uid, _ = select_sample(
            fs, noise_dic, used_sample_dic=used_noise_dic, reuse_sample=cfg.reuse_noise,
            rng=rng,
        )
        augmentation_config = ""
        snr = rng.uniform(*snr_range)
    if noise_uid is None:
        raise ValueError(f"Noise sample not found for fs={fs}+ Hz")

    # RIR gate — inverted check preserved (see module docstring)
    if (
        rir_dic is None
        or cfg.prob_reverberation <= 0.0
        or rng.rand() <= cfg.prob_reverberation
    ):
        rir_uid = None
    else:
        rir_uid, _ = select_sample(
            fs, rir_dic, used_sample_dic=used_rir_dic, reuse_sample=cfg.reuse_rir,
            rng=rng,
        )

    if isinstance(augmentations, str) and augmentations == "none":
        if not use_wind_noise:
            augmentation_config = "none"
    else:
        for i, augmentation in enumerate(augmentations):
            this_aug = cfg.augmentations[augmentation]
            if augmentation == "bandwidth_limitation":
                res_type, fs_new = bandwidth_limitation_params(fs=fs, res_type="random", rng=rng)
                augmentation_config += f"{augmentation}-{res_type}->{fs_new}"
            elif augmentation == "clipping":
                min_q = rng.uniform(*this_aug["clipping_min_quantile"])
                max_q = rng.uniform(*this_aug["clipping_max_quantile"])
                augmentation_config += f"{augmentation}(min={min_q},max={max_q})"
            elif augmentation == "codec":
                codec_config = rng.choice(this_aug["config"], 1)[0]
                format, encoder, qscale = (
                    codec_config["format"],
                    codec_config["encoder"],
                    codec_config["qscale"],
                )
                if encoder is not None and isinstance(encoder, list):
                    encoder = rng.choice(encoder, 1)[0]
                if qscale is not None and isinstance(qscale, list):
                    qscale = rng.randint(*qscale)
                augmentation_config += (
                    f"{augmentation}(format={format},encoder={encoder},qscale={qscale})"
                )
            elif augmentation == "packet_loss":
                duration_ms = this_aug["packet_duration_ms"]
                indices = packet_loss_indices(
                    speech_length,
                    fs,
                    duration_ms,
                    this_aug["packet_loss_rate"],
                    this_aug["max_continuous_packet_loss"],
                    rng=rng,
                )
                augmentation_config += (
                    f"{augmentation}"
                    f"(packet_loss_indices={indices},"
                    f"packet_duration_ms={duration_ms})"
                )
            else:
                raise NotImplementedError(augmentation)
            if i < len(augmentations) - 1:
                augmentation_config += "/"

    return {
        "noise_uid": "none" if noise_uid is None else noise_uid,
        "rir_uid": "none" if rir_uid is None else rir_uid,
        "snr": snr,
        "augmentation": augmentation_config,
        "fs": fs,
        "length": speech_length,
    }
