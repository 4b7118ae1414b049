"""Emotion-embedding cosine similarity (counterpart of
``evaluation_metrics/calculate_emotion_similarity.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.emotion_similarity \
        --ref_scp ref.scp --inf_scp inf.scp --output_dir scores \
        --model_path embedder.pt [--device cpu]

The embedder is funasr's emotion2vec base (else exit 86) or a TorchScript
export given by ``--model_path`` (``forward(wave_1xT at 16 kHz) -> (1, D)
or (D,)``) on ``--device`` (the card unless ``cpu`` is asked for); both
signals are resampled to 16 kHz on the host.
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
    require_local,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import base_parser, run_cli
from urgent2026_challenge_track1_tpu_torch.evaluation.speaker_similarity import (
    score_pairs,
    scripted_embedder,
)

__all__ = ["METRICS", "cli", "load_emotion2vec", "main", "parser"]

METRICS = ("EmotionSimilarity",)
MODEL_ID = "emotion2vec/emotion2vec_base"


def load_emotion2vec(device):
    try:
        from funasr import AutoModel
    except ImportError as e:
        raise BackendUnavailable(
            "EmotionSimilarity",
            "funasr is not installed (needed for emotion2vec base)",
        ) from e
    return AutoModel(model=require_local(MODEL_ID, "EmotionSimilarity"), device=str(device))


def _make_embedder(args, device):
    if args.model_path:
        return scripted_embedder(args.model_path, device)
    model = load_emotion2vec(device)
    return lambda wave: model.generate(
        wave.astype(np.float32), granularity="utterance")[0]["feats"]


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    score_pairs(args, _make_embedder(args, device), METRICS[0])


def parser():
    p = base_parser(need_ref=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript export of an emotion embedder "
                        "(forward(wave_1xT at 16 kHz) -> embedding) instead of funasr")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
