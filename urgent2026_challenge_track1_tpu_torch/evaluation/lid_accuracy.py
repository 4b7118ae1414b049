"""Language-ID accuracy (counterpart of
``evaluation_metrics/calculate_lid_accuracy.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.lid_accuracy \
        --meta_tsv utt2lang --inf_scp inf.scp --output_dir scores \
        --model_path lid.pt [--device cpu]

OWSM-CTC v4 1B greedy decoding with the ``<nolang>`` prompt through espnet
(else exit 86), or a TorchScript export given by ``--model_path``
(``forward(wave_T, lang_sym, task_sym) -> str`` whose first token is the
language tag; ``_backends.ScriptedSpeech2Text``) on ``--device`` (the card
unless ``cpu`` is asked for).  Each wave is resampled to 16 kHz on the
host.  The score is 1 where the first token, brackets removed, is the
utterance's label in ``--meta_tsv`` (``uid lang``), else 0.
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
    require_local,
    ScriptedSpeech2Text,
    load_torchscript,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    base_parser,
    read_at,
    read_pairs,
    run_cli,
    shard,
    write_results,
)

__all__ = ["METRICS", "cli", "load_model", "main", "parser", "read_labels"]

METRICS = ("LIDAccuracy",)
MODEL_TAG = "espnet/owsm_ctc_v4_1B"


def load_model(args, device):
    if args.model_path:
        return ScriptedSpeech2Text(load_torchscript(args.model_path, device), device)
    try:
        from espnet2.bin.s2t_ctc_inference import Speech2TextGreedySearch
    except ImportError as e:
        raise BackendUnavailable(
            "LIDAccuracy", f"espnet is not installed (model: {MODEL_TAG})"
        ) from e
    require_local(MODEL_TAG, "LIDAccuracy")
    return Speech2TextGreedySearch.from_pretrained(
        model_tag=MODEL_TAG, device=str(device), lang_sym="<nolang>", task_sym="<asr>"
    )


def read_labels(path: str) -> dict:
    """uid -> the rest of its line (``uid label``)."""
    labels = {}
    with open(path, "r") as f:
        for line in f:
            uid, value = line.strip().split(maxsplit=1)
            labels[uid] = value
    return labels


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    model = load_model(args, device)
    labels = read_labels(args.meta_tsv)
    pairs = read_pairs(args)
    pairs, suffix = shard(pairs, args)
    ret = []
    for uid, path in pairs:
        result = model(read_at(path).astype(np.float32))
        # the first TOKEN is the language tag, e.g. '<eng>' (the detokenized
        # text would glue adjacent special tokens together)
        pred_lang = (
            result[0][1][0].replace("<", "").replace(">", "") if result else "unk"
        )
        ret.append((uid, {"LIDAccuracy": float(pred_lang == labels[uid])}))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser(need_meta=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript export (forward(wave_T, lang_sym, task_sym) -> str "
                        "whose first token is the language tag, e.g. '<eng>') instead of "
                        "the espnet hub model")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
