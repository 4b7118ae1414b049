"""Simulation renderer (counterpart of ``simulation/render.py``): one meta
recipe -> (clean, noisy) audio.

``render_one`` loads the sources (resampled to the target rate), high-passes
the clean source at 70 Hz, convolves the noisy path with the full RIR and
the training target with its first 50 ms, mixes noise at the SNR over
non-silent power (wind noise through the sidechain compressor), applies the
"/"-separated augmentation chain (bandwidth limitation, clipping, codec
compression, packet loss) and peak-normalises both to 0.9.  The
augmentation strings are parsed with the reference's regexes, so its
meta.tsv files replay.

Offline rendering seeds its generator from the file id; on the fly
(dynamic mixing) takes a fresh ``np.random.default_rng()`` for the noise
offset, and a source longer than ``max_duration`` is cropped at a
``random.randint`` offset, both as in the JAX package.
"""

from __future__ import annotations

import ast
import re
from copy import deepcopy

import numpy as np

from urgent2026_challenge_track1_tpu_torch.simulation import dsp
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["read_audio", "apply_augmentations", "render_one", "process_one_sample"]


def read_audio(filename, force_1ch=False, fs=None, max_duration=-1, rng=None):
    """(channels, T), fs — with soxr_hq-equivalent resampling to ``fs`` and
    optional random max_duration crop (renderer :347-361)."""
    audio, fs_ = audio_io.read(filename)
    audio = audio[:, None] if audio.ndim == 1 else audio
    audio = audio[:, :1].T if force_1ch else audio.T
    if fs is not None and fs != fs_:
        audio = dsp.resample(audio, fs_, fs, "soxr_hq")
        return audio, fs
    if max_duration > 0 and audio.shape[1] > max_duration:
        import random as _random

        start = (rng.integers(0, audio.shape[1] - max_duration)
                 if rng is not None else _random.randint(0, audio.shape[1] - max_duration))
        audio = audio[:, start : start + max_duration]
    return audio, fs_


def apply_augmentations(noisy_speech, fs, augmentations):
    """Apply a meta.tsv augmentation chain to (C, T) audio.

    ``augmentations`` is the "/"-separated chain string or an already-split
    list; wind_noise entries are skipped (they are consumed by the mixing
    stage).  String formats match the reference encoder/decoder pair
    (generate_data_param.py:326-408 / simulate_data_from_param.py:466-570).
    """
    if isinstance(augmentations, str):
        augmentations = augmentations.split("/")
    for augmentation in augmentations:
        if augmentation in ("none", "") or augmentation.startswith("wind_noise"):
            continue
        if augmentation.startswith("bandwidth_limitation"):
            match = re.fullmatch(r"bandwidth_limitation-(.*)->(\d+)", augmentation)
            res_type, fs_new = match.groups()
            noisy_speech = dsp.bandwidth_limitation(
                noisy_speech, fs=fs, fs_new=int(fs_new), res_type=res_type
            )
        elif augmentation.startswith("clipping"):
            match = re.fullmatch(r"clipping\(min=(.*),max=(.*)\)", augmentation)
            min_, max_ = map(float, match.groups())
            noisy_speech = dsp.clipping(noisy_speech, min_quantile=min_, max_quantile=max_)
        elif augmentation.startswith("codec"):
            match = re.fullmatch(
                r"codec\(format=(.*),encoder=(.*),qscale=(.*)\)", augmentation
            )
            format, encoder, qscale = match.groups()
            noisy_speech = dsp.codec_compression(
                noisy_speech, fs, format=format, encoder=encoder, qscale=int(qscale)
            )
        elif augmentation.startswith("packet_loss"):
            match = re.fullmatch(
                r"packet_loss\(packet_loss_indices=(.*),packet_duration_ms=(.*)\)",
                augmentation,
            )
            indices_, duration_ = match.groups()
            noisy_speech = dsp.packet_loss_apply(
                noisy_speech, fs, ast.literal_eval(indices_), int(duration_)
            )
        else:
            raise NotImplementedError(augmentation)
    return noisy_speech


def render_one(
    info,
    force_1ch=True,
    store_noise=False,
    speech_dic=None,
    noise_dic=None,
    rir_dic=None,
    highpass=False,
    on_the_fly=False,
    max_duration=-1,
):
    """Render one meta row.  Returns (clean, noisy, fs) when on_the_fly else
    writes clean/noisy(/noise) wavs to the paths in ``info``."""
    uid = info["id"]
    fs = int(info["fs"])
    snr = float(info["snr_dB"])

    speech_path = speech_dic[info["speech_uid"]]
    noise_path = noise_dic[info["noise_uid"]]
    speech_sample = read_audio(
        speech_path, force_1ch=force_1ch, fs=fs, max_duration=max_duration
    )[0]
    if highpass:
        speech_sample = dsp.high_pass_filter(speech_sample, fs)
    noise_sample = read_audio(
        noise_path, force_1ch=force_1ch, fs=fs, max_duration=max_duration
    )[0]

    augmentations = info["augmentation"].split("/")

    rir_uid = info["rir_uid"]
    if rir_uid != "none":
        rir_sample = read_audio(
            rir_dic[rir_uid], force_1ch=force_1ch, fs=fs, max_duration=max_duration
        )[0]
        noisy_speech = dsp.add_reverberation(speech_sample, rir_sample)
        # align the training target with the noisy input via the early RIR
        early_rir = dsp.estimate_early_rir(rir_sample, fs=fs)
        speech_sample = dsp.add_reverberation(speech_sample, early_rir)
    else:
        noisy_speech = deepcopy(speech_sample)

    if not on_the_fly:
        rng = np.random.default_rng(int(uid.split("_")[-1]))
    else:
        rng = np.random.default_rng()

    if info["noise_uid"].startswith("wind_noise"):
        wind_augs = [a for a in augmentations if a.startswith("wind_noise")]
        assert len(wind_augs) == 1, (
            f"Configuration for the wind-noise simulation is necessary: "
            f"{wind_augs} {info['noise_uid']}"
        )
        match = re.fullmatch(
            r"wind_noise\(threshold=(.*),ratio=(.*),attack=(.*),release=(.*),"
            r"sc_gain=(.*),clipping=(.*),clipping_threshold=(.*)\)",
            wind_augs[0],
        )
        threshold, ratio, attack, release, sc_gain, clip_, clip_thres = match.groups()
        # NB: bool("False") is True — the reference has the same quirk
        # (simulate_data_from_param.py:517), so meta-replayed wind mixes are
        # always clipped; preserved for distribution parity.
        noisy_speech, noise_sample = dsp.wind_noise_mix(
            noisy_speech,
            noise_sample,
            fs,
            float(threshold),
            float(ratio),
            float(attack),
            float(release),
            float(sc_gain),
            bool(clip_),
            float(clip_thres),
            float(snr),
            rng=rng,
        )
    else:
        noisy_speech, noise_sample = dsp.mix_noise(
            noisy_speech, noise_sample, snr=snr, rng=rng
        )

    noisy_speech = apply_augmentations(noisy_speech, fs, augmentations)

    length = int(info["length"])
    assert noisy_speech.shape[-1] == length, (info, noisy_speech.shape)

    scale = 0.9 / max(
        np.max(np.abs(noisy_speech)),
        np.max(np.abs(speech_sample)),
        np.max(np.abs(noise_sample)),
        1e-6,
    )
    if on_the_fly:
        return speech_sample * scale, noisy_speech * scale, fs
    audio_io.save_audio(speech_sample * scale, info["clean_path"], fs)
    audio_io.save_audio(noisy_speech * scale, info["noisy_path"], fs)
    if store_noise:
        audio_io.save_audio(noise_sample * scale, info["noise_path"], fs)
    return None


process_one_sample = render_one  # the reference's name (simulate_data_from_param)
