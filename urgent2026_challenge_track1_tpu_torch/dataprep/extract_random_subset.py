"""A random subset of each speech scp, with a 2-15 s duration filter
(counterpart of ``utils/extract_random_subset.py``).

    python -m urgent2026_challenge_track1_tpu_torch.dataprep.extract_random_subset \
        --speech_scps a.scp b.scp --num_data_per_dataset 100 50 --outfile subset.scp

Each ``uid fs path`` scp is shuffled in turn by one ``random.Random(--seed)``
(the stream of the root tool's global ``random.seed``), and its first
``n`` lines whose file lasts from 2.0 to 15.0 s are kept, unchanged.
"""

from __future__ import annotations

import argparse
import random

from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["main", "parser", "select_audio"]


def select_audio(scp_file: str, num_data: int, rng: random.Random) -> list[str]:
    with open(scp_file) as f:
        lines = f.readlines()
    rng.shuffle(lines)
    selected = []
    for line in lines:
        _, fs, audio_path = line.strip().split()
        duration = audio_io.info_frames(audio_path) / int(fs)
        if duration < 2.0 or duration > 15.0:
            continue
        selected.append(line)
        if len(selected) == num_data:
            break
    return selected


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--speech_scps", type=str, nargs="+", required=True)
    p.add_argument("--num_data_per_dataset", type=int, nargs="+", required=True)
    p.add_argument("--outfile", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> None:
    p = parser()
    args = p.parse_args(argv)
    if len(args.speech_scps) != len(args.num_data_per_dataset):
        p.error("--speech_scps and --num_data_per_dataset differ in length")
    rng = random.Random(args.seed)
    selected = []
    for scp, n in zip(args.speech_scps, args.num_data_per_dataset):
        selected += select_audio(scp, n, rng)
    with open(args.outfile, "w") as f:
        f.writelines(selected)


if __name__ == "__main__":
    main()
