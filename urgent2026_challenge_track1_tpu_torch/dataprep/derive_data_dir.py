"""A Kaldi-style data directory from a simulation meta.tsv (counterpart of
``utils/derive_data_dir.py``).

    python -m urgent2026_challenge_track1_tpu_torch.dataprep.derive_data_dir \
        --meta_tsv simulation_train/log/meta.tsv --output_dir data/train_simulation

Writes ``wav.scp`` (noisy), ``spk1.scp`` (clean), ``utt2spk``, ``text``,
``utt2fs``, ``utt2category``, ``utt2lang``, ``spk2utt`` (speakers sorted)
and ``speech_length.scp`` (the noisy file's frames), every file's rows
sorted by id.  ``utt2lang`` maps the source utterance's id to a language
by its corpus prefix (``LANGUAGE_PREFIXES``, a copy of the root
``utils/get_utt2lang.py``'s), English where none matches.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["LANGUAGE_PREFIXES", "determine_language", "main", "parser"]

LANGUAGE_PREFIXES = (
    ("mls_french", "fra"),
    ("mls_german", "deu"),
    ("mls_spanish", "spa"),
    ("common_voice_fr", "fra"),
    ("common_voice_de", "deu"),
    ("common_voice_es", "spa"),
    ("common_voice_zh-CN", "zho"),
)


def determine_language(speech_uid: str) -> str:
    """The ISO 639-2 code of the first prefix found in ``speech_uid``."""
    for prefix, lang in LANGUAGE_PREFIXES:
        if prefix in speech_uid:
            return lang
    return "eng"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--meta_tsv", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    with open(args.meta_tsv) as f:
        headers = next(f).strip().split("\t")
        for line in f:
            rows.append(dict(zip(headers, line.strip().split("\t"))))
    rows.sort(key=lambda r: r["id"])

    def write(name, key_fn):
        with open(out / name, "w") as f:
            for r in rows:
                f.write(f"{r['id']} {key_fn(r)}\n")

    write("wav.scp", lambda r: r["noisy_path"])
    write("spk1.scp", lambda r: r["clean_path"])
    write("utt2spk", lambda r: r["speech_sid"])
    write("text", lambda r: r["text"])
    write("utt2fs", lambda r: r["fs"])
    write("utt2category", lambda r: f"1ch_{r['fs']}Hz")
    write("utt2lang", lambda r: determine_language(r["speech_uid"]))

    spk2utt = defaultdict(list)
    for r in rows:
        spk2utt[r["speech_sid"]].append(r["id"])
    with open(out / "spk2utt", "w") as f:
        for spk in sorted(spk2utt):
            f.write(f"{spk} {' '.join(spk2utt[spk])}\n")

    write("speech_length.scp", lambda r: audio_io.info_frames(r["noisy_path"]))


if __name__ == "__main__":
    main()
