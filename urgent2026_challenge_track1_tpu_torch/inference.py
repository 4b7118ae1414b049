"""Inference CLI of the PyTorch port (same flags as the JAX ``inference.py``).

    python -m urgent2026_challenge_track1_tpu_torch.inference \\
        --input_scp in.scp --ckpt_path model.ckpt --output_dir out/ [--device cuda]

Per utterance: read the audio (WAV or FLAC, sniffed from its first bytes),
enhance it, peak-normalise to 0.9 and write
``out/wav/{uid}.wav`` and a line of ``out/inf.scp``.  Inputs are padded to
1 s buckets with their true lengths passed along, so the padding does not
change the result; inputs longer than ``--chunk_seconds`` are enhanced as
fixed-size overlapping chunks.  ``--batch_size > 1`` groups utterances by
(fs, bucket) and enhances whole batches.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch.models.streaming import enhance_streaming
from urgent2026_challenge_track1_tpu_torch.serving import make_enhance_fn
from urgent2026_challenge_track1_tpu_torch.utils import audio_io
from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import load_model_for_inference

__all__ = ["build_parser", "main"]


def _mono(wav: np.ndarray) -> np.ndarray:
    return wav[:, 0] if wav.ndim > 1 else wav


def _peak_normalize(y: np.ndarray) -> np.ndarray:
    return y / (np.abs(y).max() or 1.0) * 0.9


def _chunk_fn(enhance, fs: int, device):
    """Callback for enhance_streaming: full chunks skip length masking (the
    unmasked time path), the zero-padded last chunk passes its length."""
    def run(x: np.ndarray, n: int) -> np.ndarray:
        lengths = None if n == x.shape[1] else torch.tensor([n], dtype=torch.int32)
        return enhance(torch.from_numpy(x).to(device), fs, lengths).cpu().numpy()
    return run


def _enhance_bucketed(enhance, wavs, lengths, bucket: int, fs: int, device) -> np.ndarray:
    x = np.zeros((len(wavs), bucket), np.float32)
    for j, w in enumerate(wavs):
        x[j, : len(w)] = w
    lens = torch.tensor(lengths, dtype=torch.int32)
    return enhance(torch.from_numpy(x).to(device), fs, lens).cpu().numpy()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    kind, model, model_cfg, stft_cfg = load_model_for_inference(args.ckpt_path, args.device)
    device = next(model.parameters()).device
    print(f"Loaded {kind} model from {args.ckpt_path} on {device}")
    enhance = make_enhance_fn(kind, model, model_cfg, stft_cfg, nfe=args.nfe,
                              solver=args.solver)

    input_audios = {}
    with open(args.input_scp) as f:
        for line in f:
            uid, path = line.strip().split()
            input_audios[uid] = path
    os.makedirs(os.path.join(args.output_dir, "wav"), exist_ok=True)
    if args.batch_size > 1:
        _main_batched(args, enhance, input_audios, device)
        print("done")
        return
    with open(os.path.join(args.output_dir, "inf.scp"), "w") as f:
        for uid, path in input_audios.items():
            wav, sr = audio_io.read(path)
            wav = _mono(wav).astype(np.float32)
            T = wav.shape[0]
            if T > args.chunk_seconds * sr:
                y = enhance_streaming(_chunk_fn(enhance, sr, device), wav, sr,
                                      chunk_seconds=args.chunk_seconds)
            else:
                bucket = -(-T // sr) * sr
                y = _enhance_bucketed(enhance, [wav], [T], bucket, sr, device)[0, :T]
            out_path = os.path.join(args.output_dir, "wav", f"{uid}.wav")
            audio_io.write(out_path, _peak_normalize(y), sr)
            print(f"{uid} {out_path}", file=f)
    print("done")


def _main_batched(args, enhance, input_audios, device) -> None:
    """Group utterances by (fs, 1 s length bucket) and enhance each group in
    batches of ``batch_size``; filler rows carry the full bucket length (a
    zero length would zero the norm denominators)."""
    groups = defaultdict(list)
    long_items = []
    for uid, path in input_audios.items():
        frames, fs = audio_io.info(path)
        if frames > args.chunk_seconds * fs:
            long_items.append((uid, path, fs))
            continue
        groups[(fs, -(-frames // fs) * fs)].append((uid, path, frames))
    with open(os.path.join(args.output_dir, "inf.scp"), "w") as f:
        for uid, path, fs in long_items:
            wav = _mono(audio_io.read(path)[0]).astype(np.float32)
            y = enhance_streaming(_chunk_fn(enhance, fs, device), wav, fs,
                                  chunk_seconds=args.chunk_seconds)
            out_path = os.path.join(args.output_dir, "wav", f"{uid}.wav")
            audio_io.write(out_path, _peak_normalize(y), fs)
            print(f"{uid} {out_path}", file=f)
        for (fs, bucket), items in sorted(groups.items()):
            for i in range(0, len(items), args.batch_size):
                chunk = items[i : i + args.batch_size]
                wavs = [_mono(audio_io.read(path)[0]).astype(np.float32)
                        for _, path, _ in chunk]
                lens = [len(w) for w in wavs]
                n_fill = args.batch_size - len(chunk)
                out = _enhance_bucketed(enhance, wavs + [np.zeros(0, np.float32)] * n_fill,
                                        lens + [bucket] * n_fill, bucket, fs, device)
                for j, (uid, _, frames) in enumerate(chunk):
                    out_path = os.path.join(args.output_dir, "wav", f"{uid}.wav")
                    audio_io.write(out_path, _peak_normalize(out[j, :frames]), fs)
                    print(f"{uid} {out_path}", file=f)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_scp", type=str, required=True,
                        help="Path to the scp file listing input audio")
    parser.add_argument("--output_dir", "--output", type=str, default="./tmp/se",
                        help="Output directory for enhanced speech")
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="Reference Lightning .ckpt (SEModel or "
                             "FlowSEModel), a file from "
                             "utils.checkpoint.save_model or a checkpoint "
                             "of the port's trainer")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--batch_size", type=int, default=1,
                        help=">1 groups utterances by (fs, length bucket) "
                             "and enhances them in batches")
    parser.add_argument("--nfe", type=int, default=15,
                        help="flow-model sampler steps (ignored by the "
                             "discriminative model)")
    parser.add_argument("--solver", type=str, default="euler",
                        choices=["euler", "midpoint", "heun"],
                        help="flow-model ODE solver; see --nfe")
    parser.add_argument("--chunk_seconds", type=float, default=30.0,
                        help="inputs longer than this are enhanced as "
                             "fixed-size overlapping chunks with crossfade")
    return parser


if __name__ == "__main__":
    main()
