"""Estimate each file's effective bandwidth (counterpart of
``utils/estimate_audio_bandwidth.py``).

    python -m urgent2026_challenge_track1_tpu_torch.dataprep.estimate_audio_bandwidth \
        --audio_dir corpus/ [more dirs, wav.scp or segment JSON files] \
        --outfile tmp/corpus.json [--threshold -50] [--audio_format wav] [--nj 8]

The bandwidth is the highest frequency at which every channel's mean STFT
power exceeds the smallest channel peak times ``10^(threshold/10)``.  The
STFT's length and hop are 512 and 256 samples scaled from 16 kHz to the
file's rate (truncated), under a periodic Hann window, over frames gathered
by index with no padding.  A segment JSON's ``start`` / ``end`` are scaled
by 16 kHz whatever the file's rate, as in the root tool.  The raw results
(``(uid, [path, bandwidth])`` or None, in input order) are pickled beside
``--outfile`` and reloaded in place of a new estimate when that file exists;
colliding uids become ``uid(2)``, ``uid(3)``, ...  The output is a JSON
(``--outfile`` ending in ``.json``) or ``uid bandwidth path`` lines.
"""

from __future__ import annotations

import argparse
import json
import pickle
from functools import partial
from multiprocessing import get_context
from pathlib import Path

import numpy as np

from urgent2026_challenge_track1_tpu_torch.utils import audio_io, capped_nj

__all__ = ["estimate_bandwidth", "main", "parser"]


def estimate_bandwidth(audios, threshold=-50.0, nfft=512, hop=256, sample_rate=16000):
    """``(uid, [str(path), bandwidth])``, or None for a file that cannot be
    read or is shorter than one frame."""
    uid, audio_path = audios
    if isinstance(audio_path, dict):
        st = int(audio_path["start"] * sample_rate)
        et = int(audio_path["end"] * sample_rate)
        idx = slice(st, et)
        audio_path = audio_path["audio_path"]
    else:
        idx = slice(None)
    try:
        audio, fs = audio_io.read(audio_path)
    except Exception:
        print(f"Error: cannot open audio file '{audio_path}'. Skipping it", flush=True)
        return None
    audio = audio[idx].T if audio.ndim > 1 else audio[None, idx]
    n_fft = int(nfft / sample_rate * fs)
    hop_len = int(hop / sample_rate * fs)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    n = max(0, (audio.shape[1] - n_fft) // hop_len + 1)
    if n == 0:
        return None
    fidx = np.arange(n_fft)[None, :] + hop_len * np.arange(n)[:, None]
    frames = audio[:, fidx] * win
    spec = np.fft.rfft(frames, axis=-1)
    freq = np.fft.rfftfreq(n_fft, d=1 / fs)
    power = spec.real**2 + spec.imag**2  # (C, frames, F)
    mean_power = power.mean(1)  # (C, F)
    min_energy = mean_power.max(1).min() * 10 ** (threshold / 10)
    for i in range(len(freq) - 1, -1, -1):
        if mean_power[:, i].min() > min_energy:
            return uid, [str(audio_path), float(freq[i])]
    return None


def _inputs(audio_dirs, audio_format: str) -> list:
    """(uid, path or segment dict) of every input, in order."""
    all_audios = []
    for audio_dir in audio_dirs:
        p = Path(audio_dir)
        if p.is_dir():
            all_audios += [(q.stem, q) for q in sorted(p.rglob("*." + audio_format))]
        elif p.is_file() and p.suffix == ".scp":
            with open(p) as f:
                all_audios += [tuple(line.strip().split(maxsplit=1)) for line in f]
        elif p.is_file() and p.suffix == ".json":
            with open(p) as f:
                all_audios += list(json.load(f).items())
        else:
            raise ValueError(f"Invalid format: {audio_dir}")
    return all_audios


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--audio_dir", type=str, required=True, nargs="+",
                   help="audio directory / wav.scp / segments json")
    p.add_argument("--outfile", type=str, required=True)
    p.add_argument("--threshold", type=float, default=-50)
    p.add_argument("--audio_format", type=str, default="wav")
    p.add_argument("--nj", type=int, default=8)
    p.add_argument("--chunksize", type=int, default=1000)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    Path(args.outfile).parent.mkdir(parents=True, exist_ok=True)
    all_audios = _inputs(args.audio_dir, args.audio_format)

    pkl_file = Path(args.outfile).with_suffix(".pkl")
    if pkl_file.exists():
        print(f"Loading existing pkl file: {pkl_file}")
        with pkl_file.open("rb") as f:
            ret0 = pickle.load(f)
    else:
        fn = partial(estimate_bandwidth, threshold=args.threshold)
        nj = capped_nj(args.nj)
        if nj <= 1:
            ret0 = [fn(a) for a in all_audios]
        else:
            with get_context("spawn").Pool(nj) as pool:
                ret0 = list(pool.imap(fn, all_audios, chunksize=args.chunksize))
        with pkl_file.open("wb") as f:
            pickle.dump(ret0, f)

    ret = {}
    for uid_val in ret0:
        if uid_val is None:
            continue
        uid, val = uid_val
        i, uid2 = 1, uid
        while uid2 in ret:
            i += 1
            uid2 = f"{uid}({i})"
        ret[uid2] = val

    with open(args.outfile, "w") as f:
        if args.outfile.endswith(".json"):
            json.dump(ret, f, indent=2)
        else:
            for uid, (audio_path, bandwidth) in ret.items():
                f.write(f"{uid} {bandwidth} {audio_path}\n")


if __name__ == "__main__":
    main()
