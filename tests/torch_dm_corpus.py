"""A tiny dynamic-mixing corpus for the port's tests: FLAC speech sources at
8 and 16 kHz, WAV noises, RIRs and wind noises, the source scp files, and a
FLAC pre-simulated validation split.  Imports no JAX, so the card tests
use it too."""

from pathlib import Path

import numpy as np

from urgent2026_challenge_track1_tpu_torch.utils import audio_io

MAX_DURATION = 6000


def _tone(n, fs, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    gate = (np.sin(2 * np.pi * 2.5 * t) > -0.3).astype(np.float64)
    return gate * 0.3 * np.sin(2 * np.pi * rng.uniform(120, 300) * t) + 0.01 * rng.standard_normal(n)


def make_corpus(root: Path, n_speech=6, seed=0) -> Path:
    """Speech sources as FLAC at 16 and 8 kHz (one longer than MAX_DURATION),
    WAV noises, RIRs and wind noises, and the scp files the data module
    reads."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = {k: [] for k in ("speech_sources.scp", "noise_scoures.scp", "rirs.scp",
                             "wind_noise_scoures.scp", "source_length.scp")}
    for i in range(n_speech):
        fs = 16000 if i % 3 else 8000
        n = int(fs * (0.3 + 0.05 * i)) + (4000 if i == 1 else 0)
        path = root / f"sp{i}.flac"
        audio_io.write(str(path), _tone(n, fs, seed + i), fs)
        lines["speech_sources.scp"].append(f"sp{i} {fs} {path}")
        lines["source_length.scp"].append(f"sp{i} {n}")
    for i, fs in enumerate((16000, 16000, 48000)):
        path = root / f"noise{i}.wav"
        audio_io.write(str(path), 0.1 * rng.standard_normal(int(fs * (0.2 + 0.2 * i))), fs)
        lines["noise_scoures.scp"].append(f"noise{i} {fs} {path}")
    for i, fs in enumerate((16000, 8000)):
        h = rng.standard_normal(400) * np.exp(-np.arange(400) / 80.0)
        h[:20], h[20] = 0.0, 1.0
        path = root / f"rir{i}.wav"
        audio_io.write(str(path), h / 2.0, fs)
        lines["rirs.scp"].append(f"rir{i} {fs} {path}")
    for i in range(2):
        path = root / f"wind_noise_{i}.wav"
        audio_io.write(str(path), 0.2 * rng.standard_normal(9000), 16000)
        lines["wind_noise_scoures.scp"].append(f"wind_noise_{i} 16000 {path}")
    for name, ls in lines.items():
        (root / name).write_text("\n".join(ls) + "\n")
    return root


def make_valid(root: Path, n=2, fs=8000) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    lines = {k: [] for k in ("spk1.scp", "wav.scp", "utt2fs", "speech_length.scp")}
    for i in range(n):
        clean = _tone(3000 + 200 * i, fs, 50 + i)
        for name, wav in (("spk1.scp", clean), ("wav.scp", clean + 0.05 * _tone(len(clean), fs, 9))):
            path = root / f"v{i}_{name[:3]}.flac"
            audio_io.write(str(path), wav, fs)
            lines[name].append(f"v{i} {path}")
        lines["utt2fs"].append(f"v{i} {fs}")
        lines["speech_length.scp"].append(f"v{i} {len(clean)}")
    for name, ls in lines.items():
        (root / name).write_text("\n".join(ls) + "\n")
    return root
