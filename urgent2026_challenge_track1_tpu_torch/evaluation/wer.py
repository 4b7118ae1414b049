"""WER and CER (counterpart of ``evaluation_metrics/calculate_wer.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.wer \
        --meta_tsv text --utt2lang utt2lang --inf_scp inf.scp \
        --output_dir scores --model_path asr.pt [--device cpu]

Per utterance: resample to 16 kHz on the host, decode with OWSM v3.1 ebf
through espnet (else exit 86) or a TorchScript export given by
``--model_path`` (``_backends.ScriptedSpeech2Text``) on ``--device`` (the
card unless ``cpu`` is asked for), with the utterance's language from
``--utt2lang``; beam 5, and past 30 s the long-form decode: 30 s windows
with timestamps, each resumed at its last segment boundary.  Both texts go
through the Whisper basic normalizer and the edit operations are counted
from Levenshtein opcodes.  Each line of ``WER.scp`` and ``CER.scp`` is a
JSON record (delete / insert / replace / equal and the two texts), from
which ``breakdown`` sums the corpus-level rate.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._backends import (
    BackendUnavailable,
    require_local,
    ScriptedSpeech2Text,
    load_torchscript,
)
from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    TARGET_FS,
    base_parser,
    run_cli,
    shard,
)
from urgent2026_challenge_track1_tpu_torch.evaluation.lid_accuracy import read_labels
from urgent2026_challenge_track1_tpu_torch.metrics.text import opcodes, whisper_basic_normalize
from urgent2026_challenge_track1_tpu_torch.simulation.dsp import resample
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["METRICS", "cli", "decode_long", "format_timestamp", "levenshtein_metric",
           "load_model", "main", "owsm_predict", "parse_timestamped", "parser"]

METRICS = ("WER", "CER")
MODEL_TAG = "espnet/owsm_v3.1_ebf"
BEAMSIZE = 5
CHUNK_S = 30

END_TIME_THRESHOLD = 29.00  # the reference's end_time_threshold="<29.00>"
MIN_ADVANCE_S = 2.0  # the smallest resume step; below it a window advances a
#                      whole chunk (bounds the number of beam decodes)
_TS_RE = re.compile(r"<(\d+\.\d+)>")


def _decode_segment(model, seg, fs, lang_sym, task_sym, maxlenratio=None):
    """One decode of at most 30 s with the reference's conditioning: the
    utterance's language and task symbols, about 10 tokens a second of
    maxlenratio, zero-padded to the 30 s window."""
    import torch

    model.maxlenratio = (
        maxlenratio if maxlenratio is not None
        else -min(300, max(10, int(len(seg) / fs * 10)))
    )
    pad = CHUNK_S * fs
    if len(seg) < pad:
        seg = np.pad(seg, (0, pad - len(seg)))
    with torch.no_grad():
        return model(seg, "<na>", lang_sym=lang_sym, task_sym=task_sym)[0][-2]


def parse_timestamped(text):
    """OWSM timestamped output -> ([(t1, t2, seg_text)], last_ts).

    ``"<0.00> hello there<4.52><4.60> second segment<8.00>"`` yields two
    segments; text outside a timestamp pair becomes a (None, None) segment
    so no word is dropped.  ``last_ts`` is the last timestamp, or None."""
    matches = list(_TS_RE.finditer(text))
    if not matches:
        stripped = text.strip()
        return ([(None, None, stripped)] if stripped else []), None
    segments = []
    head = text[: matches[0].start()].strip()
    if head:
        segments.append((None, None, head))
    for m, m_next in zip(matches, matches[1:]):
        seg = text[m.end() : m_next.start()].strip()
        if seg:
            segments.append((float(m.group(1)), float(m_next.group(1)), seg))
    tail = text[matches[-1].end() :].strip()
    if tail:
        segments.append((float(matches[-1].group(1)), None, tail))
    return segments, float(matches[-1].group(1))


def format_timestamp(seconds, always_include_hours=False, decimal_marker="."):
    """A Whisper-style timestamp."""
    if seconds < 0:
        raise ValueError(f"negative timestamp {seconds}")
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hm = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hm}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def decode_long(model, speech, fs, lang_sym, task_sym):
    """The segmenting long-form decode: a sliding 30 s window decoded with
    timestamps advances to its LAST segment boundary when that lies before
    the 29 s threshold (so no segment cuts a word at a window's edge);
    returns (abs_start, abs_end, text) tuples."""
    chunk = CHUNK_S * fs
    pos = 0
    utts = []
    while pos < len(speech):
        window = speech[pos : pos + chunk]
        text = _decode_segment(
            model, window, fs, lang_sym, task_sym, maxlenratio=-300
        )
        segments, last_ts = parse_timestamped(text)
        offset = pos / fs
        win_seconds = len(window) / fs
        is_last_window = pos + chunk >= len(speech)
        # resume at the final boundary only where that is real progress: a
        # near-zero last timestamp (a mostly silent window) would re-run a
        # beam decode every few hundred samples, and the whole window was
        # decoded, so a full-chunk advance drops nothing
        advance_to_ts = (
            not is_last_window
            and last_ts is not None
            and MIN_ADVANCE_S <= last_ts < END_TIME_THRESHOLD
        )
        for t1, t2, seg in segments:
            if advance_to_ts and t1 is not None and t2 is None:
                # the unclosed tail is decoded again from last_ts in the
                # next window: emitting it here would repeat its words
                continue
            a = offset + (t1 if t1 is not None else 0.0)
            b = offset + (t2 if t2 is not None else win_seconds)
            utts.append((a, b, seg))
        if is_last_window:
            break
        pos += int(last_ts * fs) if advance_to_ts else chunk
    return utts


def owsm_predict(model, speech, fs, src_lang="eng", long_form=False):
    """OWSM ASR: a long input takes the segmenting decode, and falls back to
    a plain decode of its first 30 s where that raises."""
    model.beam_search.beam_size = BEAMSIZE
    lang_sym = f"<{src_lang}>"
    task_sym = "<asr>"
    if long_form:
        try:
            utts = decode_long(model, speech, fs, lang_sym, task_sym)
            return "\n".join(
                f"[{format_timestamp(seconds=t1)} --> "
                f"{format_timestamp(seconds=t2)}] {res}"
                for t1, t2, res in utts
            )
        except Exception:
            print(
                "An exception occurred in long-form decoding. "
                "Fall back to standard decoding (only first 30s)", flush=True
            )
            speech = speech[: CHUNK_S * fs]
    return _decode_segment(model, speech, fs, lang_sym, task_sym)


def _account(ref_tokens, inf_tokens, ref_txt, inf_txt):
    ret = {"hyp_text": inf_txt, "ref_text": ref_txt,
           "delete": 0, "insert": 0, "replace": 0, "equal": 0}
    for op, ref_st, ref_et, inf_st, inf_et in opcodes(ref_tokens, inf_tokens):
        if op == "insert":
            ret[op] += inf_et - inf_st
        else:
            ret[op] += ref_et - ref_st
    total = ret["delete"] + ret["replace"] + ret["equal"]
    assert total == len(ref_tokens), (total, len(ref_tokens))
    total = ret["insert"] + ret["replace"] + ret["equal"]
    assert total == len(inf_tokens), (total, len(inf_tokens))
    return ret


def levenshtein_metric(model, ref_txt, inf, lang_id, fs=16000):
    if ref_txt == "<not-available>":
        return dict(WER={}, CER={})
    if fs != TARGET_FS:
        inf = resample(inf[None], fs, TARGET_FS, "soxr_hq")[0]
        fs = TARGET_FS
    inf_txt = owsm_predict(
        model, inf.astype(np.float64), fs, src_lang=lang_id,
        long_form=len(inf) > CHUNK_S * fs,
    )
    ref_txt = whisper_basic_normalize(ref_txt)
    inf_txt = whisper_basic_normalize(inf_txt)
    ret_wer = _account(ref_txt.split(), inf_txt.split(), ref_txt, inf_txt)
    ret_cer = _account(list(ref_txt), list(inf_txt), ref_txt, inf_txt)
    return dict(WER=ret_wer, CER=ret_cer)


def load_model(args, device):
    if args.model_path:
        return ScriptedSpeech2Text(load_torchscript(args.model_path, device), device)
    try:
        from espnet2.bin.s2t_inference import Speech2Text
    except ImportError as e:
        raise BackendUnavailable(
            "WER", f"espnet is not installed (model: {MODEL_TAG})"
        ) from e
    require_local(MODEL_TAG, "WER")
    return Speech2Text.from_pretrained(
        model_tag=MODEL_TAG,
        device=str(device),
        task_sym="<asr>",
        beam_size=BEAMSIZE,
        predict_time=False,
    )


def main(args):
    from urgent2026_challenge_track1_tpu_torch import resolve_device

    device = resolve_device(args.device)
    transcripts = read_labels(args.meta_tsv)
    language_id = read_labels(args.utt2lang)
    unknown = sorted(set(language_id) - set(transcripts))
    if unknown:
        raise ValueError(f"{args.utt2lang}: uids without a transcript: {unknown[:5]}")

    pairs = []
    with open(args.inf_scp, "r") as f:
        for line in f:
            uid, path = line.strip().split()
            pairs.append((uid, transcripts[uid], path, language_id[uid]))
    pairs, suffix = shard(pairs, args)

    model = load_model(args, device)

    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    writers = {m: (outdir / f"{m}{suffix}.scp").open("w") for m in METRICS}
    try:
        for uid, ref_txt, path, lang in pairs:
            inf, fs = audio_io.read(path)
            if inf.ndim != 1:
                raise ValueError(f"{uid}: expected mono audio, got shape {inf.shape}")
            scores = levenshtein_metric(model, ref_txt, inf, lang, fs=fs)
            for m in METRICS:
                writers[m].write(f"{uid} {json.dumps(scores[m])}\n")
    finally:
        for w in writers.values():
            w.close()
    print(f"Results written under {outdir}", flush=True)


def parser():
    p = base_parser(need_meta=True)
    p.add_argument("--utt2lang", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="TorchScript ASR export (forward(wave_T, lang_sym, task_sym) -> "
                        "transcript) instead of the espnet hub model")
    return p


def cli(argv=None):
    run_cli(main, parser(), argv)


if __name__ == "__main__":
    cli()
