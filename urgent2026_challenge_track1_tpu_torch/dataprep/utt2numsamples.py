"""Write each utterance's frame count (counterpart of ``utils/utt2numsamples.py``).

    python -m urgent2026_challenge_track1_tpu_torch.dataprep.utt2numsamples \
        --input_scp speech_sources.scp --outfile source_length.scp

The scp has 2 (``uid path``) or 3 (``uid fs path``) columns; each line of
the output is ``uid frames``, the frames read from the file's header.
"""

from __future__ import annotations

import argparse

from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["main", "parser"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--input_scp", type=str, required=True,
                   help="scp with 2 (uid path) or 3 (uid fs path) columns")
    p.add_argument("--outfile", type=str, required=True)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    with open(args.input_scp) as f, open(args.outfile, "w") as out:
        for line in f:
            parts = line.strip().split()
            uid, path = (parts[0], parts[2]) if len(parts) == 3 else (parts[0], parts[1])
            print(uid, audio_io.info_frames(path), file=out)


if __name__ == "__main__":
    main()
