"""Non-intrusive DNSMOS on the port's ONNX executor (counterpart of
``evaluation_metrics/calculate_nonintrusive_dnsmos.py``).

    python -m urgent2026_challenge_track1_tpu_torch.evaluation.dnsmos \
        --inf_scp inf.scp --output_dir scores [--device cpu]

Scores with the Microsoft DNS-Challenge ONNX predictors through espnet's
``DNSMOS_local`` pipeline: 9.01 s windows hopped by 1 s; the primary model
(sig_bak_ovr.onnx) consumes the raw waveform and its raw (SIG, BAK, OVR)
are mapped through the P835 polynomials; the P808 model (model_v8.onnx)
consumes a 120-band log-mel spectrogram (librosa-compatible: n_fft=321, hop
160, Slaney mel filterbank, power_to_db ref=max, (x+40)/40) of the window
minus its last 160 samples.  Emits DNSMOS_OVRL plus P808_MOS.  Both graphs
run on ``ops/onnx_torch.InferenceSession`` on ``--device`` (the card unless
``cpu`` is asked for); the features are numpy, as in the JAX package.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np

from urgent2026_challenge_track1_tpu_torch.evaluation._shared import (
    base_parser,
    read_pairs,
    shard,
    write_results,
)
from urgent2026_challenge_track1_tpu_torch.simulation.dsp import resample
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["METRICS", "BackendUnavailable", "load_dnsmos", "logmel_features", "score_one",
           "main"]

METRICS = ("DNSMOS_OVRL", "P808_MOS")
INPUT_LENGTH = 9.01
FS = 16000
# the JAX CLIs' exit code for "this metric's model files are not here", so an
# orchestrator can skip and report the metric and still abort on real failures
EXIT_BACKEND_UNAVAILABLE = 86


class BackendUnavailable(RuntimeError):
    def __init__(self, name: str, hint: str):
        super().__init__(f"backend for {name} is unavailable: {hint}")


def load_dnsmos(primary_model: str, p808_model: str, device="cuda"):
    """(primary, p808) sessions of the two DNSMOS graphs on ``device`` (the
    card unless the caller asks for the CPU).  A missing model file, or an
    op the executor lacks, raises ``BackendUnavailable``."""
    from urgent2026_challenge_track1_tpu_torch import resolve_device
    from urgent2026_challenge_track1_tpu_torch.ops import onnx_torch

    dev = resolve_device(device)
    if not (Path(primary_model).exists() and Path(p808_model).exists()):
        raise BackendUnavailable(
            "DNSMOS",
            f"model files not found: {primary_model}, {p808_model} — download "
            "sig_bak_ovr.onnx / model_v8.onnx from "
            "https://github.com/microsoft/DNS-Challenge (DNSMOS dir).",
        )
    try:
        return (
            onnx_torch.InferenceSession(primary_model, device=dev),
            onnx_torch.InferenceSession(p808_model, device=dev),
        )
    except NotImplementedError as e:
        raise BackendUnavailable(
            "DNSMOS",
            f"the port's ONNX executor lacks an op used by these models ({e}); "
            "extend ops/onnx_torch.py.",
        ) from e


def _poly_fit(sig, bak, ovr):
    """DNSMOS P835 polynomial mapping (from the DNS-Challenge recipe)."""
    p_ovr = np.poly1d([-0.06766283, 1.11546468, 0.04602535])
    p_sig = np.poly1d([-0.08397278, 1.22083953, 0.0052439])
    p_bak = np.poly1d([-0.13166888, 1.60915514, -0.39604546])
    return p_sig(sig), p_bak(bak), p_ovr(ovr)


@functools.lru_cache(maxsize=4)
def _slaney_mel_matrix(fs=FS, n_fft=321, n_mels=120):
    """librosa.filters.mel defaults: Slaney mel scale + Slaney (area) norm.
    Cached — it is rebuilt identically for every 9 s window otherwise."""
    def hz2mel(f):
        f = np.atleast_1d(np.asarray(f, np.float64))
        m = f / (200.0 / 3.0)
        log_region = f >= 1000.0
        m[log_region] = 15.0 + np.log(f[log_region] / 1000.0) / (np.log(6.4) / 27.0)
        return m

    def mel2hz(m):
        m = np.atleast_1d(np.asarray(m, np.float64))
        f = m * (200.0 / 3.0)
        log_region = m >= 15.0
        f[log_region] = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m[log_region] - 15.0))
        return f

    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, fs / 2, n_bins)
    pts = mel2hz(np.linspace(hz2mel(0.0)[0], hz2mel(fs / 2)[0], n_mels + 2))
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        weights[i] = np.maximum(0, np.minimum(up, down))
        weights[i] *= 2.0 / (hi - lo)  # Slaney area normalisation
    return weights


def logmel_features(audio, fs=FS, n_mels=120, n_fft=321, hop=160):
    """(frames, n_mels) float32, matching espnet DNSMOS_local.audio_melspec
    (librosa melspectrogram + power_to_db(ref=max), then (x + 40) / 40)."""
    audio = np.asarray(audio, np.float64)
    pad = n_fft // 2
    x = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))  # periodic hann
    spec = np.abs(np.fft.rfft(x[idx] * win, n=n_fft, axis=-1)) ** 2
    mel = spec @ _slaney_mel_matrix(fs, n_fft, n_mels).T  # (frames, n_mels)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db - db.max(), -80.0)  # power_to_db(ref=np.max, top_db=80)
    return ((db + 40.0) / 40.0).astype(np.float32)


def score_one(sessions, audio, fs):
    primary, p808 = sessions
    if len(audio) == 0:
        # corrupt/zero-sample entry: NaN (excluded by the nanmean aggregation)
        # instead of spinning forever in the tile-up loop below
        return {"DNSMOS_OVRL": float("nan"), "P808_MOS": float("nan")}
    if fs != FS:
        audio = resample(audio[None], fs, FS, "soxr_hq")[0]
    need = int(INPUT_LENGTH * FS)
    while len(audio) < need:
        audio = np.concatenate([audio, audio])
    num_hops = int(np.floor(len(audio) / FS) - INPUT_LENGTH) + 1
    hop_len = FS
    ovrl, p808_mos = [], []
    for i in range(max(num_hops, 1)):
        seg = audio[int(i * hop_len) : int(i * hop_len) + need]
        if len(seg) < need:
            break
        inp = np.array(seg, np.float32)[None]
        mos_sig_raw, mos_bak_raw, mos_ovr_raw = primary.run(None, {"input_1": inp})[0][0]
        _, _, mos_ovr = _poly_fit(mos_sig_raw, mos_bak_raw, mos_ovr_raw)
        ovrl.append(mos_ovr)
        feats = logmel_features(seg[:-160])[None]  # (1, frames, 120)
        p808_mos.append(float(p808.run(None, {"input_1": feats})[0][0][0]))
    return {"DNSMOS_OVRL": float(np.mean(ovrl)), "P808_MOS": float(np.mean(p808_mos))}


def main(args, sessions=None):
    pairs = read_pairs(args)
    pairs, suffix = shard(pairs, args)
    if sessions is None:
        sessions = load_dnsmos(args.primary_model, args.p808_model, args.device)
    ret = []
    for uid, path in pairs:
        audio, fs = audio_io.read(path)
        if audio.ndim != 1:
            raise ValueError(f"{uid}: DNSMOS scores mono audio, got shape {audio.shape}")
        ret.append((uid, score_one(sessions, audio, fs)))
    write_results(args.output_dir, METRICS, ret, suffix)


def parser():
    p = base_parser()
    p.add_argument("--primary_model", type=str, default="./DNSMOS/sig_bak_ovr.onnx")
    p.add_argument("--p808_model", type=str, default="./DNSMOS/model_v8.onnx")
    p.add_argument("--convert_to_torch", type=bool, default=False)  # the reference's flag; unused
    return p


if __name__ == "__main__":
    try:
        main(parser().parse_args())
    except BackendUnavailable as e:
        print(f"SKIPPED (backend unavailable): {e}", file=sys.stderr, flush=True)
        raise SystemExit(EXIT_BACKEND_UNAVAILABLE)
