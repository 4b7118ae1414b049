"""Per-group score breakdowns over a simulation meta.tsv (counterpart of
``evaluation_metrics/get_breakdown.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.breakdown \
        score/se/PESQ.scp --meta_tsv meta.tsv

Groups a per-utterance result scp six ways (sampling rate, 5 dB SNR bin,
5 s duration bin, source corpus, RIR or not, augmentation family) and
prints each group's mean, or for the WER CLI's JSON records the group's
corpus-level WER with its edit counts, in the JAX tool's text.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

__all__ = ["GROUPERS", "load_meta", "load_results", "main", "summarize"]

# (name, sorted output, meta row -> group)
GROUPERS = [
    ("fs", True, lambda m: f"fs={int(m['fs'])}Hz"),
    ("snr", True, lambda m: f"snr={int(float(m['snr_dB']) / 5) * 5:02d}dB"),
    (
        "duration",
        True,
        lambda m: f"duration={int(float(m['length']) / float(m['fs']) / 5) * 5:02d}s",
    ),
    ("corpus", False, lambda m: "corpus=" + m["speech_sid"].split("_", 1)[0]),
    ("rir", False, lambda m: "with_rir" if m["rir_uid"] != "none" else "no_rir"),
    (
        "augmentation",
        False,
        lambda m: next(
            (fam for fam in ("bandwidth_limitation", "clipping")
             if m["augmentation"].startswith(fam)),
            m["augmentation"],
        ),
    ),
]


def load_results(path):
    """(uid -> float score, or uid -> edit-op dict for WER records, is_wer)."""
    scores, is_wer = {}, None
    with open(path) as f:
        for line in f:
            uid, payload = line.strip().split(maxsplit=1)
            if is_wer is None:
                try:
                    float(payload)
                    is_wer = False
                except ValueError:
                    is_wer = True
            # uids that carry a path-derived prefix
            if not uid.startswith("fileid") and "fileid" in uid:
                uid = "fileid" + uid.split("fileid", 1)[1]
            scores[uid] = json.loads(payload) if is_wer else float(payload)
    return scores, bool(is_wer)


def load_meta(path):
    meta = {}
    with open(path) as f:
        headers = next(f).rstrip("\n").split("\t")
        for line in f:
            row = dict(zip(headers, line.rstrip("\n").split("\t")))
            meta[row["id"]] = row
    return meta


def summarize(values, is_wer):
    if not is_wer:
        return f"Average score: {np.nanmean(values)}\n"
    ops = {"delete": 0, "insert": 0, "replace": 0, "equal": 0}
    for rec in values:
        for op in ops:
            ops[op] += rec.get(op, 0)
    errors = ops["replace"] + ops["delete"] + ops["insert"]
    ref_len = ops["replace"] + ops["delete"] + ops["equal"]
    lines = [f"WER: {errors / max(ref_len, 1):.4f}"]
    lines += [f"    {op}: {count}" for op, count in ops.items()]
    return "\n".join(lines) + "\n"


def main(args):
    scores, is_wer = load_results(args.result_scp)
    meta = load_meta(args.meta_tsv)
    for name, sort_groups, group_fn in GROUPERS:
        buckets = defaultdict(list)
        for uid, score in scores.items():
            buckets[group_fn(meta[uid])].append(score)
        keys = sorted(buckets) if sort_groups else list(buckets)
        print(f"\n====== Group by {name} =====\n")
        for group in keys:
            print(f"[Group] {group}\n\t" + summarize(buckets[group], is_wer))


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("result_scp", help="per-sample evaluation result scp")
    p.add_argument("--meta_tsv", required=True,
                   help="simulation meta.tsv with per-sample metadata")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
