"""Plumbing shared by the port's evaluation CLIs (counterpart of
``evaluation_metrics/_shared.py``).

Every CLI reads ``inf.scp`` (and ``ref.scp`` where the metric is
intrusive), shards the list by ``--nsplits/--job`` (output scps suffixed
``.{job}``), scores each utterance and writes one ``{METRIC}.scp`` per
metric plus, for an unsharded run, ``RESULTS.txt`` with each metric's
nanmean.  A CLI whose model stack or weights are not here exits with
``EXIT_BACKEND_UNAVAILABLE`` (86), which a suite records as skipped; any
other failure is an error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

__all__ = ["EXIT_BACKEND_UNAVAILABLE", "TARGET_FS", "base_parser", "exit_backend_unavailable",
           "read_at", "read_pairs", "run_cli", "shard", "wave_tensor", "write_results"]

EXIT_BACKEND_UNAVAILABLE = 86
TARGET_FS = 16000  # the rate the model-scored metrics resample to


def exit_backend_unavailable(exc) -> None:
    print(f"SKIPPED (backend unavailable): {exc}", file=sys.stderr, flush=True)
    raise SystemExit(EXIT_BACKEND_UNAVAILABLE)


def run_cli(main, parser, argv=None) -> None:
    """Parse ``argv`` (the command line when None) and run ``main``; a
    ``BackendUnavailable`` exits with ``EXIT_BACKEND_UNAVAILABLE``."""
    from urgent2026_challenge_track1_tpu_torch.evaluation._backends import BackendUnavailable

    args = parser.parse_args(argv)
    try:
        main(args)
    except BackendUnavailable as e:
        exit_backend_unavailable(e)


def base_parser(need_ref=False, need_meta=False):
    """The JAX CLIs' flags; ``--device`` defaults to the card."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--inf_scp", type=str, required=True,
                        help="Path to the scp file containing enhanced signals")
    if need_ref:
        parser.add_argument("--ref_scp", type=str, required=True,
                            help="Path to the scp file containing reference signals")
    if need_meta:
        parser.add_argument("--meta_tsv", type=str, required=True,
                            help="Path to label file (two columns: uid label)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--nsplits", type=int, default=1)
    parser.add_argument("--job", type=int, default=1)
    return parser


def read_at(path: str, fs_out: int = TARGET_FS) -> np.ndarray:
    """A mono file's samples (float64), resampled to ``fs_out`` on the host
    (``simulation/dsp.resample``, soxr_hq)."""
    from urgent2026_challenge_track1_tpu_torch.simulation.dsp import resample
    from urgent2026_challenge_track1_tpu_torch.utils import audio_io

    audio, fs = audio_io.read(path)
    if audio.ndim != 1:
        raise ValueError(f"{path}: expected mono audio, got shape {audio.shape}")
    if fs != fs_out:
        audio = resample(audio[None], fs, fs_out, "soxr_hq")[0]
    return audio


def wave_tensor(audio, device):
    """(1, T) float32 tensor of ``audio`` on ``device``."""
    import torch

    return torch.from_numpy(np.asarray(audio, np.float32))[None].to(device)


def read_pairs(args, need_ref=False):
    """[(uid, [ref_path,] inf_path)] from the scp files."""
    refs = {}
    if need_ref:
        with open(args.ref_scp, "r") as f:
            for line in f:
                uid, path = line.strip().split()
                refs[uid] = path
    pairs = []
    with open(args.inf_scp, "r") as f:
        for line in f:
            uid, path = line.strip().split()
            pairs.append((uid, refs[uid], path) if need_ref else (uid, path))
    return pairs


def shard(pairs, args):
    """Contiguous --nsplits/--job slice + output suffix."""
    size = len(pairs)
    if not 1 <= args.job <= args.nsplits <= size:
        raise ValueError(f"--job {args.job} / --nsplits {args.nsplits} do not fit "
                         f"{size} utterances")
    interval = size // args.nsplits
    start = (args.job - 1) * interval
    end = size if args.job == args.nsplits else start + interval
    out = pairs[start:end]
    print(
        f"[Job {args.job}/{args.nsplits}] Processing ({len(out)}/{size}) samples",
        flush=True,
    )
    suffix = "" if args.nsplits == args.job == 1 else f".{args.job}"
    return out, suffix


def write_results(outdir, metrics, ret, suffix=""):
    """Write {METRIC}{suffix}.scp per metric + RESULTS.txt (suffix-free run)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for metric in metrics:
        with (outdir / f"{metric}{suffix}.scp").open("w") as w:
            for uid, score in ret:
                w.write(f"{uid} {score[metric]}\n")
    if suffix == "":
        with (outdir / "RESULTS.txt").open("w") as f:
            for metric in metrics:
                vals = [
                    float(s[metric]) for _, s in ret
                    if isinstance(s[metric], (int, float, np.floating))
                ]
                f.write(f"{metric}: {np.nanmean(vals):.4f}\n")
        print(f"Overall results have been written in {outdir / 'RESULTS.txt'}",
              flush=True)
