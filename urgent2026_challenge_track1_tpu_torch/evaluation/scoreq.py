"""Non-intrusive SCOREQ MOS (counterpart of
``evaluation_metrics/calculate_nonintrusive_scoreq.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.scoreq \
        --inf_scp inf.scp --output_dir scores --model_path scoreq.pt [--device cpu]

With ``--model_path``: a TorchScript export of the natural-speech
no-reference model (``forward(wave_1xT at 16 kHz) -> MOS``) on
``--device`` (the card unless ``cpu`` is asked for), each wave resampled
to 16 kHz on the host.  Without it, the ``scoreq`` package (else exit 86).
"""

from __future__ import annotations

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
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

__all__ = ["METRICS", "cli", "main", "parser"]

METRICS = ("SCOREQ",)


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    pairs = read_pairs(args)
    pairs, suffix = shard(pairs, args)
    ret = []
    if args.model_path:
        import torch

        predictor = load_torchscript(args.model_path, device).eval()
        for uid, path in pairs:
            with torch.no_grad():
                score = predictor(wave_tensor(read_at(path), device))
            ret.append((uid, {"SCOREQ": float(score.reshape(-1)[0])}))
        write_results(args.output_dir, METRICS, ret, suffix)
        return
    try:
        import scoreq
    except ImportError as e:
        raise BackendUnavailable(
            "SCOREQ",
            "the scoreq package is not importable: install "
            "https://github.com/alessandroragano/scoreq or pass --model_path.",
        ) from e
    model = scoreq.Scoreq(data_domain="natural", mode="nr")
    for uid, path in pairs:
        score = model.predict(test_path=path, ref_path=None)
        ret.append((uid, {"SCOREQ": float(score)}))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser()
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript export of the SCOREQ nr-mode model "
                        "(forward(wave_1xT at 16 kHz) -> score) instead of the scoreq package")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
