"""The port's DNSMOS entry point (``evaluation/dnsmos.py``) against the JAX
package's (``evaluation_metrics/calculate_nonintrusive_dnsmos.py``), on the
CPU.

No DNS-Challenge model is in the repository, so the graphs are written from
a seed: the two of ``tests/test_dnsmos.py`` and the stand-in CNNs of
``evaluation/dnsmos_standin.py`` (the inputs and outputs of the real
predictors).  The JAX side scores with its jitted ``onnx_jax`` sessions,
the port with ``onnx_torch`` sessions on ``device="cpu"``.  Tolerance: the
scores within 1e-5 of each other (float32 graphs, only the order of sums
differs); the log-mel features bitwise equal (the same numpy).
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.ops import onnx_jax
from urgent2026_challenge_track1_tpu.utils import onnx_lite as jlite
from urgent2026_challenge_track1_tpu_torch.evaluation import dnsmos, dnsmos_standin
from urgent2026_challenge_track1_tpu_torch.evaluation.dnsmos import BackendUnavailable
from urgent2026_challenge_track1_tpu_torch.ops import onnx_torch
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent
TOL = 1e-5


def _jax_cli():
    sys.path.insert(0, str(REPO / "evaluation_metrics"))
    spec = importlib.util.spec_from_file_location(
        "calc_dnsmos", REPO / "evaluation_metrics" / "calculate_nonintrusive_dnsmos.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _simple_graphs():
    """tests/test_dnsmos.py's graphs: mean -> affine at the two input shapes."""
    rng = np.random.default_rng(2)

    def save(nodes, inits, shape):
        g = jlite.Graph(nodes=[jlite.Node(*n) for n in nodes], initializers=inits,
                        inputs=["input_1"], outputs=["out"], input_shapes={"input_1": shape})
        return jlite.dumps(jlite.Model(graph=g))

    primary = save([("ReduceMean", ["input_1"], ["m"], {"axes": [1], "keepdims": 1}),
                    ("Gemm", ["m", "w1", "b1"], ["out"], {"transB": 1})],
                   {"w1": rng.standard_normal((3, 1)).astype(np.float32),
                    "b1": np.array([3.0, 3.4, 2.9], np.float32)}, (1, 144160))
    p808 = save([("ReduceMean", ["input_1"], ["m"], {"axes": [1, 2], "keepdims": 0}),
                 ("Unsqueeze", ["m"], ["mu"], {"axes": [0]}),
                 ("Gemm", ["mu", "w2", "b2"], ["out"], {"transB": 1})],
                {"w2": rng.standard_normal((1, 1)).astype(np.float32),
                 "b2": np.array([3.6], np.float32)}, (1, 900, 120))
    return primary, p808


GRAPHS = {
    "test_dnsmos graphs": _simple_graphs,
    "stand-in cnn": lambda: (dnsmos_standin.primary_graph(), dnsmos_standin.p808_graph()),
}


def _sessions(graphs):
    jax_s = tuple(onnx_jax.InferenceSession(g) for g in graphs)
    port_s = tuple(onnx_torch.InferenceSession(g, device="cpu") for g in graphs)
    return jax_s, port_s


@pytest.mark.parametrize("graphs", list(GRAPHS))
@pytest.mark.parametrize("fs, seconds", [(16000, 11.5), (8000, 4.0)])
def test_score_one_equals_jax(graphs, fs, seconds):
    """11.5 s at 16 kHz (two windows) and 4 s at 8 kHz (resampled, tiled)."""
    jax_s, port_s = _sessions(GRAPHS[graphs]())
    audio = 0.05 * np.random.default_rng(3).standard_normal(int(seconds * fs))
    ref = _jax_cli().score_one(jax_s, audio, fs)
    got = dnsmos.score_one(port_s, audio, fs)
    assert set(got) == set(ref) == set(dnsmos.METRICS)
    for k in ref:
        assert np.isfinite(got[k]) and abs(got[k] - ref[k]) <= TOL * abs(ref[k]), (k, got, ref)


@pytest.mark.parametrize("seconds", [1.0, 9.01])
def test_logmel_features_bitwise_equal(seconds):
    jcli = _jax_cli()
    t = np.arange(int(seconds * 16000)) / 16000
    x = np.sin(2 * np.pi * 440 * t) + 0.01 * np.random.default_rng(4).standard_normal(len(t))
    got, ref = dnsmos.logmel_features(x[:-160]), jcli.logmel_features(x[:-160])
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(dnsmos._slaney_mel_matrix(), jcli._slaney_mel_matrix())
    assert dnsmos._poly_fit(3.1, 2.7, 3.3) == jcli._poly_fit(3.1, 2.7, 3.3)


def test_empty_audio_scores_nan():
    scores = dnsmos.score_one((None, None), np.zeros(0), 16000)
    assert all(np.isnan(v) for v in scores.values())


def test_cli_main_equals_jax(tmp_path):
    """The port's CLI (its sessions loaded from the model files on the CPU)
    and the JAX CLI (its sessions): the same RESULTS.txt keys and per-file
    scores within the tolerance, for two files."""
    primary, p808 = _simple_graphs()
    (tmp_path / "sig_bak_ovr.onnx").write_bytes(primary)
    (tmp_path / "model_v8.onnx").write_bytes(p808)
    rng = np.random.default_rng(1)
    lines = []
    for i, fs in enumerate((16000, 8000)):
        wav = tmp_path / f"a{i}.wav"
        audio_io.write(str(wav), 0.05 * rng.standard_normal(fs * 2), fs)
        lines.append(f"u{i} {wav}")
    (tmp_path / "inf.scp").write_text("\n".join(lines) + "\n")
    common = ["--inf_scp", str(tmp_path / "inf.scp"),
              "--primary_model", str(tmp_path / "sig_bak_ovr.onnx"),
              "--p808_model", str(tmp_path / "model_v8.onnx")]
    args = dnsmos.parser().parse_args(common + ["--output_dir", str(tmp_path / "t"),
                                                "--device", "cpu"])
    dnsmos.main(args)
    jax_s = (onnx_jax.InferenceSession(primary), onnx_jax.InferenceSession(p808))
    _jax_cli().main(argparse.Namespace(
        inf_scp=str(tmp_path / "inf.scp"), output_dir=str(tmp_path / "j"), nsplits=1, job=1,
        device="cpu", primary_model="x", p808_model="y"), sessions=jax_s)

    def keys(d):
        return [ln.split(":")[0] for ln in (tmp_path / d / "RESULTS.txt").read_text().splitlines()]

    assert keys("t") == keys("j") == list(dnsmos.METRICS)
    for m in dnsmos.METRICS:
        got = [ln.split() for ln in (tmp_path / "t" / f"{m}.scp").read_text().splitlines()]
        ref = [ln.split() for ln in (tmp_path / "j" / f"{m}.scp").read_text().splitlines()]
        assert [u for u, _ in got] == [u for u, _ in ref] == ["u0", "u1"]
        for (_, a), (_, b) in zip(got, ref):
            assert abs(float(a) - float(b)) <= TOL * abs(float(b))


def test_load_dnsmos_refusals(tmp_path):
    with pytest.raises(BackendUnavailable, match="model files not found"):
        dnsmos.load_dnsmos(str(tmp_path / "a.onnx"), str(tmp_path / "b.onnx"), device="cpu")
    g = jlite.Graph(nodes=[jlite.Node("NonMaxSuppression", ["input_1"], ["out"], {})],
                    inputs=["input_1"], outputs=["out"])
    for name in ("a.onnx", "b.onnx"):
        (tmp_path / name).write_bytes(jlite.dumps(jlite.Model(graph=g)))
    with pytest.raises(BackendUnavailable, match="NonMaxSuppression"):
        dnsmos.load_dnsmos(str(tmp_path / "a.onnx"), str(tmp_path / "b.onnx"), device="cpu")
