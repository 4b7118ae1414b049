"""The port's intrusive metrics (``metrics/``) and their CLI
(``evaluation/intrusive.py``) against the JAX package's, on the CPU.

Both packages' metrics are the same numpy and scipy code on the same
resampler, so every score must be *equal* (no tolerance): PESQ at 8 and
16 kHz (and a 48 kHz input, resampled), STOI/ESTOI at 16 kHz and at a rate
that resamples, SDR and SI-SDR, the Levenshtein distance and opcodes and the
Whisper normaliser.  Signals are 2 s of synthetic speech (the JAX package's
``utils/speech_synth``) with seeded noise.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.metrics import pesq as jpesq
from urgent2026_challenge_track1_tpu.metrics import sdr as jsdr
from urgent2026_challenge_track1_tpu.metrics import stoi as jstoi
from urgent2026_challenge_track1_tpu.metrics import text as jtext
from urgent2026_challenge_track1_tpu.utils.speech_synth import synth_speech
from urgent2026_challenge_track1_tpu_torch.evaluation import intrusive
from urgent2026_challenge_track1_tpu_torch.metrics import pesq as tpesq
from urgent2026_challenge_track1_tpu_torch.metrics import sdr as tsdr
from urgent2026_challenge_track1_tpu_torch.metrics import stoi as tstoi
from urgent2026_challenge_track1_tpu_torch.metrics import text as ttext
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent


def _pair(fs, seconds=2.0, snr=5.0, seed=0):
    rng = np.random.default_rng(seed)
    clean = synth_speech(rng, fs, seconds).astype(np.float64)
    noise = rng.standard_normal(len(clean))
    noise *= np.linalg.norm(clean) / np.linalg.norm(noise) * 10 ** (-snr / 20)
    return clean, clean + noise


@pytest.mark.parametrize("fs", [8000, 16000, 48000])
def test_pesq_equals_jax(fs):
    ref, deg = _pair(fs, seed=fs)
    got = tpesq.pesq_metric(ref, deg, fs=fs)
    assert np.isfinite(got) and got == jpesq.pesq_metric(ref, deg, fs=fs)


@pytest.mark.parametrize("fs, extended", [(16000, True), (16000, False), (24000, True)])
def test_stoi_equals_jax(fs, extended):
    ref, deg = _pair(fs, snr=0.0, seed=1)
    got = tstoi.stoi(ref, deg, fs, extended=extended)
    assert 0.0 < got < 1.0 and got == jstoi.stoi(ref, deg, fs, extended=extended)


def test_sdr_equals_jax():
    ref, deg = _pair(16000, seconds=1.0, seed=2)
    assert tsdr.sdr_metric(ref, deg) == jsdr.sdr_metric(ref, deg)
    assert tsdr.sdr_metric(ref, deg, filter_length=64) == jsdr.sdr_metric(ref, deg, 64)
    both = np.stack([ref, deg[::-1].copy()])
    assert tsdr.sdr_metric(both, np.stack([deg, ref])) == jsdr.sdr_metric(
        both, np.stack([deg, ref]))
    assert tsdr.si_sdr(ref, deg) == jsdr.si_sdr(ref, deg)


@pytest.mark.parametrize("a, b", [
    ("the cat sat on the mat".split(), "a cat sat on mat today".split()),
    ("kitten", "sitting"),
    ("", "abc"),
    (["x"] * 3, []),
])
def test_levenshtein_equals_jax(a, b):
    assert ttext.levenshtein_distance(a, b) == jtext.levenshtein_distance(a, b)
    assert ttext.opcodes(a, b) == jtext.opcodes(a, b)


@pytest.mark.parametrize("s", [
    "Hello, World! [noise] (laughs) <unk>  naïve café",
    "ÉCOLE—test; 12.5% of ＦＵＬＬＷＩＤＴＨ",
    "  ",
])
def test_whisper_normalize_equals_jax(s):
    assert ttext.whisper_basic_normalize(s) == jtext.whisper_basic_normalize(s)


def _load_jax_cli():
    sys.path.insert(0, str(REPO / "evaluation_metrics"))
    spec = importlib.util.spec_from_file_location(
        "calc_intrusive", REPO / "evaluation_metrics" / "calculate_intrusive_se_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_intrusive_cli_equals_jax(tmp_path):
    """Two pairs (16 kHz and 8 kHz) through the port's CLI and the JAX
    package's ``calculate_intrusive_se_metrics.main``: the same files."""
    ref_lines, inf_lines = [], []
    for i, fs in enumerate((16000, 8000)):
        ref, deg = _pair(fs, seconds=1.5, snr=10.0, seed=10 + i)
        for name, x, lines in (("ref", ref, ref_lines), ("inf", deg, inf_lines)):
            path = tmp_path / f"{name}{i}.wav"
            audio_io.write(str(path), x / np.abs(x).max() * 0.5, fs)
            lines.append(f"u{i} {path}")
    (tmp_path / "ref.scp").write_text("\n".join(ref_lines) + "\n")
    (tmp_path / "inf.scp").write_text("\n".join(inf_lines) + "\n")
    argv = ["--ref_scp", str(tmp_path / "ref.scp"), "--inf_scp", str(tmp_path / "inf.scp"),
            "--nj", "1"]
    intrusive.main(intrusive.parser().parse_args(argv + ["--output_dir", str(tmp_path / "t")]))
    _load_jax_cli().main(argparse.Namespace(
        ref_scp=str(tmp_path / "ref.scp"), inf_scp=str(tmp_path / "inf.scp"),
        output_dir=str(tmp_path / "j"), nj=1, chunksize=1000, nsplits=1, job=1, device="cpu"))
    for name in ("PESQ.scp", "ESTOI.scp", "RESULTS.txt"):
        got = (tmp_path / "t" / name).read_text()
        assert got == (tmp_path / "j" / name).read_text(), name
    assert "PESQ: " in (tmp_path / "t" / "RESULTS.txt").read_text()


def test_intrusive_cli_shards_and_caps_the_pool(tmp_path):
    ref, deg = _pair(16000, seconds=1.0, seed=3)
    lines = []
    for i in range(3):
        audio_io.write(str(tmp_path / f"r{i}.wav"), ref, 16000)
        lines.append(f"u{i} {tmp_path / f'r{i}.wav'}")
    (tmp_path / "s.scp").write_text("\n".join(lines) + "\n")
    args = intrusive.parser().parse_args(
        ["--ref_scp", str(tmp_path / "s.scp"), "--inf_scp", str(tmp_path / "s.scp"),
         "--output_dir", str(tmp_path / "o"), "--nsplits", "2", "--job", "2", "--nj", "1"])
    assert args.device == "cuda"  # the CLIs' common default; the metrics run on the host
    intrusive.main(args)
    assert [ln.split()[0] for ln in (tmp_path / "o" / "ESTOI.2.scp").read_text().splitlines()
            ] == ["u1", "u2"]
    assert not (tmp_path / "o" / "RESULTS.txt").exists()
    assert intrusive.capped_nj(10 ** 6) >= 1 and intrusive.capped_nj(1) == 1
