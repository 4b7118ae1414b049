"""Speaker-embedding cosine similarity (counterpart of
``evaluation_metrics/calculate_speaker_similarity.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.speaker_similarity \
        --ref_scp ref.scp --inf_scp inf.scp --output_dir scores \
        --model_path embedder.pt [--device cpu]

The embedder is espnet's voxcelebs12_rawnet3 (else exit 86) or a
TorchScript export given by ``--model_path`` (``forward(wave_1xT at 16 kHz)
-> (1, D) or (D,)``) on ``--device`` (the card unless ``cpu`` is asked
for); both signals are resampled to 16 kHz on the host.
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
    require_local,
    cosine_similarity,
    load_torchscript,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    base_parser,
    read_at,
    read_pairs,
    run_cli,
    shard,
    wave_tensor,
    write_results,
)

__all__ = ["METRICS", "cli", "main", "parser", "score_pairs", "scripted_embedder"]

METRICS = ("SpeakerSimilarity",)
MODEL_TAG = "espnet/voxcelebs12_rawnet3"


def scripted_embedder(model_path: str, device):
    """(wave at 16 kHz) -> embedding (numpy) through a TorchScript export."""
    import torch

    predictor = load_torchscript(model_path, device).eval()

    def embed(wave):
        with torch.no_grad():
            e = predictor(wave_tensor(wave, device))
        return e.cpu().numpy().squeeze()

    return embed


def _make_embedder(args, device):
    if args.model_path:
        return scripted_embedder(args.model_path, device)
    try:
        from espnet2.bin.spk_inference import Speech2Embedding
    except ImportError as e:
        raise BackendUnavailable(
            "SpeakerSimilarity", f"espnet is not installed (model: {MODEL_TAG})"
        ) from e
    require_local(MODEL_TAG, "SpeakerSimilarity")
    model = Speech2Embedding.from_pretrained(model_tag=MODEL_TAG, device=str(device))
    return lambda wave: np.asarray(model(wave).squeeze().cpu())


def score_pairs(args, embed, metric):
    """Cosine similarity of the two signals' embeddings, per pair."""
    pairs = read_pairs(args, need_ref=True)
    pairs, suffix = shard(pairs, args)
    ret = []
    for uid, ref_path, inf_path in pairs:
        ref, inf = read_at(ref_path), read_at(inf_path)
        ret.append((uid, {metric: cosine_similarity(embed(ref), embed(inf))}))
    write_results(args.output_dir, (metric,), ret, suffix)


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    score_pairs(args, _make_embedder(args, device), METRICS[0])


def parser():
    p = base_parser(need_ref=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript export of a speaker embedder "
                        "(forward(wave_1xT at 16 kHz) -> embedding) instead of espnet")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
