"""Levenshtein phoneme similarity, LPS (counterpart of
``evaluation_metrics/calculate_phoneme_similarity.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.phoneme_similarity \
        --ref_scp ref.scp --inf_scp inf.scp --output_dir scores \
        --model_path <save_pretrained dir> [--device cpu]

Phoneme strings from a wav2vec2 CTC model (wav2vec2-lv-60-espeak-cv-ft by
default: a local HF cache, else exit 86; an explicit ``--model_path`` that
does not load is an error) on ``--device`` (the card unless ``cpu`` is
asked for), both signals resampled to 16 kHz on the host.  The score is
1 - Levenshtein distance / reference length, over characters with the
spaces removed; an empty reference string scores NaN (left out of the mean).
"""

from __future__ import annotations

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
    local_hf_dir,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    TARGET_FS,
    base_parser,
    read_at,
    read_pairs,
    run_cli,
    shard,
    write_results,
)
from urgent2026_challenge_track1_tpu_torch.metrics.text import levenshtein_distance

__all__ = ["METRICS", "cli", "main", "parser"]

METRICS = ("LPS",)
MODEL_ID = "facebook/wav2vec2-lv-60-espeak-cv-ft"


def _phonemes(model, processor, audio, device):
    """The space-stripped phoneme string (the reference scores characters of
    ``predictor(x)[0].replace(" ", "")``)."""
    import torch

    inputs = processor(audio, sampling_rate=TARGET_FS, return_tensors="pt")
    with torch.no_grad():
        logits = model(inputs.input_values.to(device)).logits
    ids = torch.argmax(logits, dim=-1)
    return processor.batch_decode(ids.cpu())[0].replace(" ", "")


def load_model(model_path: str):
    """(processor, model) from a directory or the local HF cache."""
    local = local_hf_dir(model_path)
    try:
        if local is None:
            raise FileNotFoundError("neither a directory nor in the local HF cache")
        import transformers

        processor = transformers.AutoProcessor.from_pretrained(local)
        model = transformers.Wav2Vec2ForCTC.from_pretrained(local)
        return processor, model
    except Exception as e:
        if model_path != MODEL_ID:
            raise SystemExit(
                f"ERROR: could not load '{model_path}' ({type(e).__name__}: {e})"
            ) from e
        raise BackendUnavailable(
            "LPS",
            f"could not load '{model_path}' (it needs the model in the local HF cache "
            "and espeak-ng, or a --model_path directory saved with save_pretrained)",
        ) from e


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    processor, model = load_model(args.model_path)
    model = model.to(device).eval()
    pairs = read_pairs(args, need_ref=True)
    pairs, suffix = shard(pairs, args)
    ret = []
    for uid, ref_path, inf_path in pairs:
        ref, inf = read_at(ref_path), read_at(inf_path)
        ph_ref = _phonemes(model, processor, ref, device)
        ph_inf = _phonemes(model, processor, inf, device)
        if len(ph_ref) == 0:
            ret.append((uid, {"LPS": float("nan")}))
            continue
        dist = levenshtein_distance(list(ph_ref), list(ph_inf))
        ret.append((uid, {"LPS": 1.0 - dist / len(ph_ref)}))
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
