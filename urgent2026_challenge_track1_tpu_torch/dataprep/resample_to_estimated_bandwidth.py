"""Resample each file to the smallest standard rate that holds its
estimated bandwidth (counterpart of ``utils/resample_to_estimated_bandwidth.py``).

    python -m urgent2026_challenge_track1_tpu_torch.dataprep.resample_to_estimated_bandwidth \
        --bandwidth_data tmp/corpus.json --out_scpfile corpus_resampled.scp \
        --outdir resampled/ [--nj 1] [-m 10000]

The rate is the smallest of ``SAMPLING_RATES`` that is at least twice the
bandwidth, else 48 kHz.  The ``idx``-th file goes to
``<outdir>/<idx // max_files in hex>/<uid>.flac``, resampled by
``simulation.dsp.resample(..., "soxr_hq")``; a file already at that rate is
not rewritten and keeps its path, and an output file that exists is kept
(resume).  The output scp holds ``uid fs path`` lines in input order;
unreadable files are left out.
"""

from __future__ import annotations

import argparse
import json
import math
from functools import partial
from multiprocessing import get_context
from pathlib import Path

from urgent2026_challenge_track1_tpu_torch.simulation.dsp import resample
from urgent2026_challenge_track1_tpu_torch.utils import audio_io, capped_nj

__all__ = ["SAMPLING_RATES", "estimated_rate", "main", "parser", "resample_one"]

SAMPLING_RATES = (8000, 16000, 22050, 24000, 32000, 44100, 48000)


def estimated_rate(bandwidth) -> int:
    """The smallest standard rate >= 2 x ``bandwidth`` (a number or its
    text), else the largest."""
    for sr in SAMPLING_RATES:
        if float(bandwidth) * 2 <= sr:
            return sr
    return SAMPLING_RATES[-1]


def resample_one(item, max_files_per_dir, num_digits, outdir):
    """``(uid, path, fs)`` of one ``((uid, path, bandwidth), idx)``, or None
    where the file cannot be read."""
    (uid, audio_path, est_bandwidth), idx = item
    est_fs = estimated_rate(est_bandwidth)
    subdir = f"{idx // max_files_per_dir:0{num_digits}x}"
    outfile = Path(outdir) / subdir / (uid + ".flac")
    if outfile.exists():
        return uid, outfile, est_fs
    outfile.parent.mkdir(parents=True, exist_ok=True)
    try:
        audio, fs = audio_io.read(audio_path)
    except Exception:
        print(f"Error: cannot open audio file '{audio_path}'. Skipping it", flush=True)
        return None
    if est_fs == fs:
        return uid, audio_path, fs
    audio = resample(audio.T if audio.ndim > 1 else audio[None], fs, est_fs, "soxr_hq")
    audio_io.save_audio(audio, str(outfile), est_fs)
    return uid, outfile, est_fs


def _bandwidths(path: str) -> list[tuple[str, str, object]]:
    """(uid, path, bandwidth) from the estimator's JSON or text output."""
    audios = []
    with open(path) as f:
        if Path(path).suffix == ".json":
            for uid, (audio_path, bandwidth) in json.load(f).items():
                audios.append((uid, audio_path, bandwidth))
        else:
            for line in f:
                uid, bandwidth, audio_path = line.strip().split(maxsplit=2)
                audios.append((uid, audio_path, bandwidth))
    return audios


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--bandwidth_data", type=str, required=True,
                   help="json/scp with audio paths + bandwidths")
    p.add_argument("--out_scpfile", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--nj", type=int, default=1)
    p.add_argument("--chunksize", type=int, default=1)
    p.add_argument("-m", "--max_files", type=int, default=10000)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    audios = _bandwidths(args.bandwidth_data)
    num_digits = max(1, math.ceil(math.log(max(len(audios), 2) / args.max_files, 16)))
    Path(args.outdir).mkdir(parents=True, exist_ok=True)
    items = list(zip(audios, range(len(audios))))
    fn = partial(resample_one, max_files_per_dir=args.max_files, num_digits=num_digits,
                 outdir=args.outdir)
    nj = capped_nj(args.nj)
    if nj <= 1:
        ret = [fn(it) for it in items]
    else:
        with get_context("spawn").Pool(nj) as pool:
            ret = list(pool.imap(fn, items, chunksize=args.chunksize))

    Path(args.out_scpfile).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out_scpfile, "w") as f:
        for item in ret:
            if item is None:
                continue
            uid, audio_path, fs = item
            f.write(f"{uid} {fs} {audio_path}\n")


if __name__ == "__main__":
    main()
