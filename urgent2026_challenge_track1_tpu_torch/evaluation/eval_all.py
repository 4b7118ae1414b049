"""The evaluation suite over an enhanced scp (counterpart of ``eval_all.sh``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.eval_all \
        --inf_scp enhanced/inf.scp --ref_scp data/spk1.scp \
        --output_dir enhanced --utt2lang data/utt2lang --text data/text \
        [--meta_tsv meta.tsv] [--device cpu]

Runs every metric CLI of the port in ``eval_all.sh``'s order, in this
process, into the same ``<output_dir>/score/<metric>`` directories:
intrusive (PESQ, ESTOI), DNSMOS, NISQA, UTMOS, SCOREQ, SpeechBERTScore,
phoneme similarity, speaker and emotion similarity, LID, WER/CER.  Each
flag defaults to the environment variable of ``eval_all.sh`` (``inf_scp``,
``ref_scp``, ``output_dir``, ``utt2lang``, ``text``, ``meta_tsv``, ``nj``,
``device``, ``dnsmos_args``), and the offline model routes come from the
same variables (``UTMOS_MODEL``, ``NISQA_MODEL``, ``SCOREQ_MODEL``,
``SPEECHBERT_MODEL``, ``LPS_MODEL``, ``SPK_MODEL``, ``EMO_MODEL``,
``LID_MODEL``, ``WER_MODEL``: each a ``--model_path``).  A metric that
exits 86 (its model stack is not here) is recorded as skipped; any other
failure aborts the suite.  With ``--meta_tsv`` every result scp is then
broken down (``breakdown``) into ``<name>.breakdown.txt``; a breakdown that
fails is recorded and the summary is still printed.  The model-scored
metrics run on ``--device``, the card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import os
import shlex
import sys
import traceback
from pathlib import Path

from urgent2026_challenge_track1_tpu_torch.evaluation._shared import EXIT_BACKEND_UNAVAILABLE

__all__ = ["SUITE", "main", "parser"]

# (name, module of evaluation/, directory under score/, inputs, the
# environment variable of its --model_path) in eval_all.sh's order
SUITE = (
    ("intrusive_se", "intrusive", "se", ("ref",), None),
    ("dnsmos", "dnsmos", "dnsmos", (), None),
    ("nisqa", "nisqa", "nisqa", (), "NISQA_MODEL"),
    ("utmos", "utmos", "utmos", (), "UTMOS_MODEL"),
    ("scoreq", "scoreq", "scoreq", (), "SCOREQ_MODEL"),
    ("speechbert_score", "speechbert_score", "speechbert_score", ("ref",), "SPEECHBERT_MODEL"),
    ("phoneme_similarity", "phoneme_similarity", "lps", ("ref",), "LPS_MODEL"),
    ("speaker_similarity", "speaker_similarity", "spk_sim", ("ref",), "SPK_MODEL"),
    ("emotion_similarity", "emotion_similarity", "emo_sim", ("ref",), "EMO_MODEL"),
    ("lid_accuracy", "lid_accuracy", "lid_acc", ("utt2lang",), "LID_MODEL"),
    ("wer", "wer", "cer", ("text", "utt2lang"), "WER_MODEL"),
)


def _argv(args, module, score_dir, inputs, model_path):
    argv = ["--inf_scp", args.inf_scp, "--output_dir", str(Path(args.output_dir) / "score" /
                                                           score_dir)]
    if "ref" in inputs:
        argv = ["--ref_scp", args.ref_scp] + argv
    if "text" in inputs:
        argv += ["--meta_tsv", args.text, "--utt2lang", args.utt2lang]
    elif "utt2lang" in inputs:
        argv += ["--meta_tsv", args.utt2lang]
    if module == "intrusive":
        return argv + ["--nj", str(args.nj)]
    argv += ["--device", args.device]
    if module == "dnsmos":
        argv += shlex.split(args.dnsmos_args)
    if model_path:
        argv += ["--model_path", model_path]
    return argv


def _run_metric(name, cli, argv, produced, skipped):
    print(f"=== {name} ===", flush=True)
    try:
        cli(argv)
    except SystemExit as e:
        if e.code == EXIT_BACKEND_UNAVAILABLE:
            skipped.append(name)
            return
        if e.code not in (None, 0):
            print(f"FAILED: {name} ({e.code})", file=sys.stderr, flush=True)
            raise
    except Exception:
        print(f"FAILED: {name}", file=sys.stderr, flush=True)
        raise
    produced.append(name)


def _breakdowns(output_dir: Path, meta_tsv: str) -> bool:
    """Break down every result scp under ``score/``; False if one failed."""
    from urgent2026_challenge_track1_tpu_torch.evaluation import breakdown

    ok = True
    for scp in sorted(str(p) for p in (output_dir / "score").rglob("*.scp")):
        print(f"=== breakdown: {scp} ===", flush=True)
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                breakdown.main(argparse.Namespace(result_scp=scp, meta_tsv=meta_tsv))
        except Exception:
            traceback.print_exc()
            print(f"FAILED: breakdown for {scp}", file=sys.stderr, flush=True)
            ok = False
        print(text.getvalue(), end="", flush=True)
        Path(scp[: -len(".scp")] + ".breakdown.txt").write_text(text.getvalue())
    return ok


def main(argv=None, environ=None):
    """Run the suite; returns (produced, skipped) metric names."""
    environ = os.environ if environ is None else environ
    args = parser(environ).parse_args(argv)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    produced, skipped = [], []
    for name, module, score_dir, inputs, model_env in SUITE:
        cli = importlib.import_module(
            f"urgent2026_challenge_track1_tpu_torch.evaluation.{module}").cli
        argv_ = _argv(args, module, score_dir, inputs, environ.get(model_env) if model_env
                      else None)
        _run_metric(name, cli, argv_, produced, skipped)
    if args.meta_tsv and os.path.isfile(args.meta_tsv):
        if _breakdowns(output_dir, args.meta_tsv):
            produced.append("breakdown")
        else:
            skipped.append("breakdown(failed)")
    print()
    print("================ eval_all summary ================")
    print(f"produced ({len(produced)}): {' '.join(produced)}")
    print(f"skipped  ({len(skipped)}): {' '.join(skipped)}")
    print("==================================================", flush=True)
    return produced, skipped


def parser(environ=None):
    environ = os.environ if environ is None else environ
    p = argparse.ArgumentParser(description="the port's evaluation suite")
    for flag, default in (("inf_scp", "./enhanced/baseline/inf.scp"),
                          ("ref_scp", "./data/validation_leaderboard/spk1.scp"),
                          ("output_dir", "./enhanced/baseline"),
                          ("utt2lang", "./data/validation_leaderboard/utt2lang"),
                          ("text", "./data/validation_leaderboard/text"),
                          ("meta_tsv", "")):
        p.add_argument(f"--{flag}", type=str, default=environ.get(flag, default))
    p.add_argument("--nj", type=int, default=int(environ.get("nj", 8)))
    p.add_argument("--device", type=str, default=environ.get("device", "cuda"),
                   choices=("cuda", "cpu"))
    p.add_argument("--dnsmos_args", type=str, default=environ.get("dnsmos_args", ""),
                   help="extra DNSMOS flags, e.g. '--primary_model A.onnx --p808_model B.onnx'")
    return p


if __name__ == "__main__":
    main()
