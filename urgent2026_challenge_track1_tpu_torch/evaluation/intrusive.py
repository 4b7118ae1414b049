"""Intrusive SE metrics, PESQ and ESTOI, with the SDR helper (counterpart of
``evaluation_metrics/calculate_intrusive_se_metrics.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.intrusive \
        --ref_scp ref.scp --inf_scp inf.scp --output_dir scores [--nj 8]

The metrics are the port's numpy copies (``metrics/pesq.py``,
``metrics/stoi.py``, ``metrics/sdr.py``), so they run on the host:
``--device`` is accepted for the CLIs' common flags and not read.  With
``--nj`` > 1 a spawn pool, capped at the CPU count, scores the pairs.
"""

from __future__ import annotations

import logging
from multiprocessing import get_context

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    base_parser,
    read_pairs,
    run_cli,
    shard,
    write_results,
)
from urgent2026_challenge_track1_tpu_torch.utils import audio_io, capped_nj

__all__ = ["METRICS", "estoi_metric", "pesq_metric", "sdr_metric", "process_one_pair", "main",
           "cli"]

METRICS = ("PESQ", "ESTOI")


def estoi_metric(ref, inf, fs=16000):
    from urgent2026_challenge_track1_tpu_torch.metrics.stoi import stoi

    np.random.seed(0)  # parity with the reference's determinism guard
    return stoi(ref, inf, fs_sig=fs, extended=True)


def pesq_metric(ref, inf, fs=8000):
    from urgent2026_challenge_track1_tpu_torch.metrics.pesq import pesq_metric as _pesq

    score = _pesq(ref, inf, fs=fs)
    if np.isnan(score):
        logging.warning("[PESQ] Error: No utterances detected. Skipping this sample.")
        return None
    return score


def sdr_metric(ref, inf):
    from urgent2026_challenge_track1_tpu_torch.metrics.sdr import sdr_metric as _sdr

    return _sdr(ref, inf)


def process_one_pair(data_pair):
    uid, ref_path, inf_path = data_pair
    ref, fs = audio_io.read(ref_path, dtype="float32")
    inf, fs2 = audio_io.read(inf_path, dtype="float32")
    if fs != fs2 or ref.shape != inf.shape:
        raise ValueError(f"{uid}: reference {ref.shape} at {fs} Hz and enhanced "
                         f"{inf.shape} at {fs2} Hz differ")
    scores = {}
    for metric in METRICS:
        if metric == "PESQ":
            s = pesq_metric(ref, inf, fs=fs)
            scores[metric] = s if s is not None else np.nan
        elif metric == "ESTOI":
            scores[metric] = estoi_metric(ref, inf, fs=fs)
        else:
            raise NotImplementedError(metric)
    return uid, scores


def main(args):
    pairs = read_pairs(args, need_ref=True)
    pairs, suffix = shard(pairs, args)
    nj = capped_nj(args.nj)
    if nj <= 1:
        ret = [process_one_pair(p) for p in pairs]
    else:
        with get_context("spawn").Pool(nj) as pool:
            ret = list(pool.imap(process_one_pair, pairs, chunksize=args.chunksize))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser(need_ref=True)
    p.add_argument("--nj", type=int, default=8)
    p.add_argument("--chunksize", type=int, default=1000)
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
