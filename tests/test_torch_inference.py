"""The port's inference CLI against the JAX inference.py on one reference
.ckpt and one scp, on the CPU: single-utterance, batched and long-form
branches write WAVs that, read back as float, agree within 2e-4 (both
peak-normalise to 0.9 and write PCM_16)."""

import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
from urgent2026_challenge_track1_tpu.utils.export_torch import save_lightning_ckpt
from urgent2026_challenge_track1_tpu_torch import inference as tinference
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent
ATOL = 2e-4
UTTS = (("a8", 8000, 6500), ("b8", 8000, 7900), ("c16", 16000, 12345), ("d16", 16000, 17000))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = jbsrnn.BSRNNConfig(input_dim=481, num_channel=8, num_layer=1)
    path = tmp_path_factory.mktemp("ckpt") / "bsrnn.ckpt"
    save_lightning_ckpt(str(path), "discriminative",
                        jbsrnn.init_bsrnn(jax.random.PRNGKey(0), cfg), cfg)
    return path


def _scp(tmp_path, utts, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for uid, fs, n in utts:
        path = tmp_path / f"{uid}.wav"
        audio_io.write(str(path), 0.1 * rng.standard_normal(n), fs)
        lines.append(f"{uid} {path}")
    scp = tmp_path / "in.scp"
    scp.write_text("\n".join(lines) + "\n")
    return scp


def _run_jax_cli(argv):
    old = sys.argv
    sys.argv = ["inference.py", *argv]
    try:
        runpy.run_path(str(REPO / "inference.py"), run_name="__main__")
    finally:
        sys.argv = old


@pytest.mark.parametrize("mode", ["single", "batched", "long-form"])
def test_cli_matches_jax_cli(ckpt, tmp_path, mode):
    utts = UTTS
    extra = []
    if mode == "batched":
        extra = ["--batch_size", "3"]
    elif mode == "long-form":
        utts = (("long8", 8000, 20000),)  # 2.5 s with 1 s chunks
        extra = ["--chunk_seconds", "1"]
    scp = _scp(tmp_path, utts, 0)
    outs = {}
    for name, run in (("jax", _run_jax_cli), ("torch", tinference.main)):
        out = tmp_path / name
        run(["--input_scp", str(scp), "--ckpt_path", str(ckpt), "--output_dir", str(out),
             "--device", "cpu", *extra])
        outs[name] = dict(line.split() for line in (out / "inf.scp").read_text().splitlines())
    assert set(outs["jax"]) == set(outs["torch"]) == {u for u, _, _ in utts}
    for uid, fs, n in utts:
        ref, ref_fs = audio_io.read(outs["jax"][uid])
        got, got_fs = audio_io.read(outs["torch"][uid])
        assert got_fs == ref_fs == fs and len(got) == len(ref) == n
        assert 0.85 <= np.abs(got).max() <= 0.901
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=uid)
