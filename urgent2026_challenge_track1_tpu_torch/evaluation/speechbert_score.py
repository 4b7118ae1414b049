"""SpeechBERTScore precision (counterpart of
``evaluation_metrics/calculate_speechbert_score.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.speechbert_score \
        --ref_scp ref.scp --inf_scp inf.scp --output_dir scores \
        --model_path <save_pretrained dir> [--device cpu]

The cosine-similarity precision between mHuBERT-147 layer-8 features of the
enhanced and the reference signal, both resampled to 16 kHz on the host.
The model is a transformers ``AutoModel`` (the hub id from a local cache,
else exit 86; an explicit ``--model_path`` directory that does not load is
an error) on ``--device`` (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
    local_hf_dir,
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

__all__ = ["METRICS", "bert_score_precision", "cli", "main", "parser"]

METRICS = ("SpeechBERTScore",)
LAYER = 8
MODEL_ID = "utter-project/mHuBERT-147"


def _features(model, audio, device):
    import torch

    with torch.no_grad():
        out = model(wave_tensor(audio, device), output_hidden_states=True)
    return out.hidden_states[LAYER][0].cpu().numpy()  # (T, D)


def bert_score_precision(ref_feats, inf_feats):
    """The max-similarity precision over the enhanced frames."""
    a = ref_feats / (np.linalg.norm(ref_feats, axis=1, keepdims=True) + 1e-12)
    b = inf_feats / (np.linalg.norm(inf_feats, axis=1, keepdims=True) + 1e-12)
    sim = b @ a.T  # (T_inf, T_ref)
    return float(sim.max(axis=1).mean())


def load_model(model_path: str):
    """The transformers ``AutoModel`` from a directory or the local HF cache."""
    local = local_hf_dir(model_path)
    try:
        if local is None:
            raise FileNotFoundError("neither a directory nor in the local HF cache")
        import transformers

        return transformers.AutoModel.from_pretrained(local)
    except Exception as e:
        if model_path != MODEL_ID:
            raise SystemExit(
                f"ERROR: could not load '{model_path}' ({type(e).__name__}: {e})"
            ) from e
        raise BackendUnavailable(
            "SpeechBERTScore",
            f"could not load '{model_path}' (it needs the model in the local HF cache "
            "or a --model_path directory saved with save_pretrained)",
        ) from e


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    model = load_model(args.model_path).to(device).eval()
    pairs = read_pairs(args, need_ref=True)
    pairs, suffix = shard(pairs, args)
    ret = []
    for uid, ref_path, inf_path in pairs:
        ref, inf = read_at(ref_path), read_at(inf_path)
        score = bert_score_precision(_features(model, ref, device),
                                     _features(model, inf, device))
        ret.append((uid, {"SpeechBERTScore": score}))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser(need_ref=True)
    p.add_argument("--model_path", type=str, default=MODEL_ID,
                   help="HF hub id or a local save_pretrained directory")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
