"""Non-intrusive UTMOS (counterpart of
``evaluation_metrics/calculate_nonintrusive_utmos.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.utmos \
        --inf_scp inf.scp --output_dir scores --model_path utmos22.pt [--device cpu]

The predictor is ``utmos22_strong`` from torch.hub (a filled hub cache; else
exit 86), or a TorchScript export given by ``--model_path`` with the same
``forward(wave_BxT, fs) -> score`` contract, on ``--device`` (the card
unless ``cpu`` is asked for).  Each wave goes to the device at its own rate.
"""

from __future__ import annotations

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    load_torch_hub,
    load_torchscript,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    base_parser,
    read_pairs,
    run_cli,
    shard,
    wave_tensor,
    write_results,
)
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["METRICS", "cli", "load_predictor", "main", "parser"]

METRICS = ("UTMOS",)


def load_predictor(args):
    if args.model_path:
        return load_torchscript(args.model_path, args.device)
    return load_torch_hub("tarepan/SpeechMOS:v1.2.0", "utmos22_strong", "UTMOS")


def main(args):
    import torch

    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    pairs = read_pairs(args)
    pairs, suffix = shard(pairs, args)
    predictor = load_predictor(args).to(device).eval()
    ret = []
    for uid, path in pairs:
        audio, fs = audio_io.read(path)
        with torch.no_grad():
            score = predictor(wave_tensor(audio, device), fs)
        ret.append((uid, {"UTMOS": float(score.cpu().item())}))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser()
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript export of the UTMOS predictor "
                        "(forward(wave_BxT, fs) -> score) instead of torch.hub")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
