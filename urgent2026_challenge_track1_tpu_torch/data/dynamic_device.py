"""Dynamic mixing rendered on the device (counterpart of
``data/dynamic_device.py``): the host loads the sources and draws each
item's recipe, the card renders the batch.

  host (this module, in the loader's workers): the scp pools, the recipe
    draws of ``simulation/params.py`` (the distributions and the wind and
    codec gates of the host dataset), audio decode, the noise fitted to
    the speech length at a random offset, the RIR;
  device (``simulation/torch_dsp.render_batch``, in the trainer's
    process): the high-pass, the reverb and its early-RIR target, SNR
    mixing, the bandwidth masks, clipping, packet loss and the joint peak
    normalisation.

Wind-noise and codec items take the host render (``render_one``: the
sidechain compressor is sequential, the codec round-trip runs in
libavcodec) and arrive rendered, with identity device parameters.

This module imports numpy only: the loader's spawned workers import it with
the dataset, and must not import torch.  ``render_on_device`` imports torch
when it is called.
"""

from __future__ import annotations

import ast
import re

import numpy as np

from urgent2026_challenge_track1_tpu_torch.data.dynamic import DynamicMixingDataset
from urgent2026_challenge_track1_tpu_torch.simulation import params as sim_params
from urgent2026_challenge_track1_tpu_torch.simulation import render as sim_render
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = [
    "RENDER_KEYS",
    "DeviceRenderBatch",
    "DynamicMixingSourceDataset",
    "parse_augmentation_ops",
    "collate_device_render",
    "render_tensors",
    "render_on_device",
]

_PACKET_MS = 20

# the DeviceRenderBatch arrays the render takes, in its argument order
RENDER_KEYS = (
    "speech", "noise", "rir", "snr_db", "use_rir", "clip_lo", "clip_hi",
    "packet_mask", "bw_mask", "aug_order", "prerendered_mask", "clean_pre",
    "noisy_pre", "lengths",
)


class DeviceRenderBatch(dict):
    """The numpy arrays of RENDER_KEYS, and ``fs``."""


class DynamicMixingSourceDataset(DynamicMixingDataset):
    """Per item: the raw sources and the recipe's parameters; no DSP on the
    host but for the wind-noise and codec items."""

    rir_pad = 8000  # the RIRs' static length in samples: real RIRs are cut or padded

    def __getitem__(self, index):
        speech_fs, real_idx = self._get_from_index(index)
        speech_uid = self.speech_uids[speech_fs][real_idx]
        speech_path = self.speech_source[speech_fs][speech_uid]
        speech_length = min(self.max_duration, audio_io.info_frames(speech_path))

        use_wind_noise, aug = self._sample_recipe()
        info = sim_params.sample_meta(
            self.cfg, speech_length, speech_fs,
            noise_dic=self.noise_source, used_noise_dic=None,
            wind_noise_dic=self.wind_noises, used_wind_noise_dic=None,
            use_wind_noise=use_wind_noise,
            snr_range=(self.cfg.snr_low_bound, self.cfg.snr_high_bound),
            wind_noise_snr_range=(
                self.cfg.wind_noise_config["wind_noise_snr_low_bound"],
                self.cfg.wind_noise_config["wind_noise_snr_high_bound"],
            ),
            rir_dic=self.rirs, used_rir_dic=None, augmentations=aug, rng=self._rng,
        )
        info["speech_uid"] = speech_uid
        info["id"] = speech_uid
        info["snr_dB"] = info["snr"]

        if info["noise_uid"].startswith("wind_noise") or "codec" in info["augmentation"]:
            clean, noisy, fs = sim_render.render_one(
                info, speech_dic=self.speech_source_flt,
                noise_dic=self.all_noise_flt, rir_dic=self.rirs_flt,
                highpass=self.use_high_pass, on_the_fly=True,
                max_duration=self.max_duration,
            )
            return {"prerendered": True, "clean": clean[0], "noisy": noisy[0],
                    "fs": fs, "length": clean.shape[-1]}

        rng = np.random.default_rng()
        speech = sim_render.read_audio(speech_path, force_1ch=True, fs=speech_fs,
                                       max_duration=self.max_duration, rng=rng)[0][0]
        noise = sim_render.read_audio(self.all_noise_flt[info["noise_uid"]], force_1ch=True,
                                      fs=speech_fs, max_duration=self.max_duration, rng=rng)[0][0]
        T = speech.shape[-1]
        # the noise fitted to T at a random offset: wrapped or cropped
        if len(noise) < T:
            off = rng.integers(0, T - len(noise))
            noise = np.pad(noise, (off, T - len(noise) - off), mode="wrap")
        elif len(noise) > T:
            off = rng.integers(0, len(noise) - T)
            noise = noise[off : off + T]

        rir = np.zeros(self.rir_pad, np.float64)
        use_rir = 0.0
        if info["rir_uid"] != "none":
            r = sim_render.read_audio(self.rirs_flt[info["rir_uid"]], force_1ch=True,
                                      fs=speech_fs)[0][0][: self.rir_pad]
            rir[: len(r)] = r
            use_rir = 1.0
        else:
            rir[0] = 1.0  # the identity impulse

        params = {"snr_db": float(info["snr_dB"]), "use_rir": use_rir,
                  **parse_augmentation_ops(info["augmentation"], speech_fs)}
        return {"prerendered": False, "speech": speech, "noise": noise, "rir": rir,
                "fs": speech_fs, "length": T, **params}


def parse_augmentation_ops(augmentation: str, fs: int) -> dict:
    """The device ops' parameters and order from a sampled chain.  Order
    codes: 0 bandwidth, 1 clipping, 2 packet loss, in the chain's order;
    absent ops get identity parameters and the canonical order's remaining
    slots.  A chain that repeats an op (the last one's parameters win) is
    de-duplicated, so ``aug_order`` always has 3 entries."""
    params = {"clip_lo": 0.0, "clip_hi": 1.0, "bw_fs_new": fs, "lost_packets": []}
    order = []
    for a in augmentation.split("/"):
        if a.startswith("bandwidth_limitation"):
            m = re.fullmatch(r"bandwidth_limitation-(.*)->(\d+)", a)
            params["bw_fs_new"] = int(m.group(2))
            order.append(0)
        elif a.startswith("clipping"):
            m = re.fullmatch(r"clipping\(min=(.*),max=(.*)\)", a)
            params["clip_lo"], params["clip_hi"] = float(m.group(1)), float(m.group(2))
            order.append(1)
        elif a.startswith("packet_loss"):
            m = re.fullmatch(r"packet_loss\(packet_loss_indices=(.*),packet_duration_ms=(.*)\)",
                             a)
            params["lost_packets"] = ast.literal_eval(m.group(1))
            order.append(2)
    order = list(dict.fromkeys(order))
    params["aug_order"] = order + [i for i in (0, 1, 2) if i not in order]
    return params


def collate_device_render(items, pad_quantum_ms: int = 1000) -> DeviceRenderBatch:
    """A DeviceRenderBatch (numpy) of source items padded to the bucket
    length; rendered (wind and codec) items pass through with identity
    device parameters."""
    from urgent2026_challenge_track1_tpu_torch.data.dataset import bucket_length

    fs = items[0]["fs"]
    if any(it["fs"] != fs for it in items):
        raise ValueError(f"mixed sampling rates {sorted({it['fs'] for it in items})} in one batch")
    B = len(items)
    T = bucket_length(max(it["length"] for it in items), fs, pad_quantum_ms)
    rir_len = max((it["rir"].shape[-1] for it in items if not it["prerendered"]), default=1)
    n_packets = T // (_PACKET_MS * fs // 1000)
    out = DeviceRenderBatch(
        speech=np.zeros((B, T), np.float32),
        noise=np.zeros((B, T), np.float32),
        rir=np.zeros((B, rir_len), np.float32),
        snr_db=np.zeros(B, np.float32),
        use_rir=np.zeros(B, np.float32),
        clip_lo=np.zeros(B, np.float32),
        clip_hi=np.ones(B, np.float32),
        packet_mask=np.ones((B, max(n_packets, 1)), np.float32),
        bw_mask=np.ones((B, T // 2 + 1), np.float32),
        aug_order=np.tile(np.arange(3, dtype=np.int32), (B, 1)),
        prerendered_mask=np.zeros(B, np.float32),
        clean_pre=np.zeros((B, T), np.float32),
        noisy_pre=np.zeros((B, T), np.float32),
        fs=fs,
        lengths=np.asarray([it["length"] for it in items], np.int32),
    )
    freqs = np.fft.rfftfreq(T, 1.0 / fs)
    for j, it in enumerate(items):
        L = it["length"]
        if it["prerendered"]:
            out["prerendered_mask"][j] = 1.0
            out["clean_pre"][j, :L] = it["clean"]
            out["noisy_pre"][j, :L] = it["noisy"]
            out["rir"][j, 0] = 1.0
            out["snr_db"][j] = 100.0  # the mix scales the (zero) noise to ~0
            continue
        out["speech"][j, :L] = it["speech"]
        out["noise"][j, :L] = it["noise"]
        out["rir"][j, : it["rir"].shape[-1]] = it["rir"]
        out["snr_db"][j] = it["snr_db"]
        out["use_rir"][j] = it["use_rir"]
        out["clip_lo"][j] = it["clip_lo"]
        out["clip_hi"][j] = it["clip_hi"]
        out["aug_order"][j] = it["aug_order"]
        for p in it["lost_packets"]:
            if p < out["packet_mask"].shape[1]:
                out["packet_mask"][j, p] = 0.0
        if it["bw_fs_new"] < fs:
            out["bw_mask"][j] = (freqs <= it["bw_fs_new"] / 2).astype(np.float32)
    return out


def render_tensors(tensors, fs: int, highpass: bool = True):
    """(clean_target, noisy) of the RENDER_KEYS tensors, in that order, on
    their device: ``torch_dsp.render_batch``, then the rendered items'
    rows taken from ``clean_pre`` / ``noisy_pre``."""
    import torch

    from urgent2026_challenge_track1_tpu_torch.simulation.torch_dsp import render_batch

    (speech, noise, rir, snr_db, use_rir, clip_lo, clip_hi, packet_mask, bw_mask, aug_order,
     pre_mask, clean_pre, noisy_pre, lengths) = tensors
    with torch.no_grad():
        target, noisy = render_batch(speech, noise, rir, snr_db, use_rir, clip_lo, clip_hi,
                                     packet_mask, bw_mask, fs=fs, highpass=highpass,
                                     lengths=lengths, aug_order=aug_order)
        m = pre_mask[:, None]
        return (1 - m) * target + m * clean_pre, (1 - m) * noisy + m * noisy_pre


def render_on_device(batch: DeviceRenderBatch, highpass: bool = True, device="cuda"):
    """Move a DeviceRenderBatch to ``device``, one copy per array, and
    render it there (``render_tensors``).  Returns (clean_target, noisy)."""
    import torch

    tensors = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(device) for k in RENDER_KEYS]
    return render_tensors(tensors, batch["fs"], highpass)
