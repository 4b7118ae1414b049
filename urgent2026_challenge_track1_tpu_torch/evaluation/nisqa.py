"""Non-intrusive NISQA MOS (counterpart of
``evaluation_metrics/calculate_nonintrusive_nisqa.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.nisqa \
        --inf_scp inf.scp --output_dir scores --model_path nisqa.pt [--device cpu]

With ``--model_path``: a TorchScript export of a NISQA predictor
(``forward(wave_1xT, fs) -> MOS``) on ``--device`` (the card unless ``cpu``
is asked for), each wave at its own rate.  Without it, the NISQA v2
checkpoint ``--nisqa_ckpt`` through the NISQA repository's package (else
exit 86).
"""

from __future__ import annotations

from pathlib import Path

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
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

__all__ = ["METRICS", "cli", "load_nisqa", "main", "parser"]

METRICS = ("NISQA_MOS",)


def load_nisqa(ckpt_path: str, device):
    if not Path(ckpt_path).exists():
        raise BackendUnavailable(
            "NISQA",
            f"checkpoint '{ckpt_path}' not found: nisqa.tar comes with the "
            "NISQA repository's releases (--nisqa_ckpt).",
        )
    try:
        from nisqa.NISQA_model import nisqaModel
    except ImportError as e:
        raise BackendUnavailable(
            "NISQA",
            "the NISQA package is not importable: put the NISQA repository "
            "on PYTHONPATH or pass --model_path.",
        ) from e
    args = {"mode": "predict_file", "pretrained_model": ckpt_path,
            "deg": None, "data_dir": None, "output_dir": None,
            "csv_file": None, "num_workers": 0, "bs": 1, "ms_channel": None,
            "tr_bs_val": 1, "tr_num_workers": 0}
    return nisqaModel(args)


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
            audio, fs = audio_io.read(path)
            with torch.no_grad():
                score = predictor(wave_tensor(audio, device), fs)
            ret.append((uid, {"NISQA_MOS": float(score.reshape(-1)[0])}))
        write_results(args.output_dir, METRICS, ret, suffix)
        return
    model = load_nisqa(args.nisqa_ckpt, device)
    for uid, path in pairs:
        model.args["deg"] = path
        model._loadDatasetsFile()
        score = float(model.predict()["mos_pred"].iloc[0])
        ret.append((uid, {"NISQA_MOS": score}))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser()
    p.add_argument("--nisqa_ckpt", type=str, default="./NISQA/weights/nisqa.tar")
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript export of a NISQA predictor "
                        "(forward(wave_1xT, fs) -> MOS) instead of the NISQA repository")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
