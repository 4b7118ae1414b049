"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: honest it comes out correct; with the timed path broken
underneath (a step that leaves the state unchanged, or a few of its
leaves, half of the batch left out and the mean taken over the rest, an
answer altered where it is produced) it comes out not correct.  And the measurement path itself
refuses to run without a card."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from conftest import REPO

CELLS = ["bsrnn196.train", "flowse384.train", "bsrnn196.enhance_b8", "flowse384.enhance"]


def _run(spec, cell, hook=None, trace=False, seed=2 ** 31 + 99):
    from port_bench.harness import Cell

    return Cell(spec, cell, seed, 0.0, trace, "cpu", time.perf_counter(), hook=hook).run()


def test_without_a_card_the_benchmark_exits_without_a_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "bsrnn196.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                              "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_folder_without_the_port_exits_without_a_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "bsrnn196.train",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_an_honest_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "train_rate" if "train" in cell else "enhance_rate"}
    json.dumps(out)


def test_a_traced_run_reports_per_layer_metrics(tiny):
    out = _run(tiny, "bsrnn196.enhance_b8", trace=True)
    assert out["correct"]
    assert "batch_fill_pct.enhance" in out["metrics"] and "setup_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


def _unchanged(prog):
    prog.optimizer.step = lambda *a, **k: None


def _norm_biases_unmoved(prog):
    """A minority of the leaves (the norms' biases) left where they were."""
    import torch

    step = prog.optimizer.step
    leaves = [p for n, p in prog.model.named_parameters() if n.endswith("norm_bias")]
    assert 0 < len(leaves) < len(list(prog.model.parameters())) // 2

    def frozen(*a, **k):
        kept = [p.detach().clone() for p in leaves]
        out = step(*a, **k)
        with torch.no_grad():
            for p, v in zip(leaves, kept):
                p.copy_(v)
        return out
    prog.optimizer.step = frozen


def _half_train(prog):
    step = prog.step

    def half(fs, clean, noisy, lengths, noise=None, t=None):
        h = max(1, len(lengths) // 2)
        cut = (lambda a: None if a is None else a[:h])
        return step(fs, clean[:h], noisy[:h], lengths[:h], cut(noise), cut(t))
    prog.step = half


def _half_enhance(prog):
    run = prog.run

    def half(wavs, lengths, bucket, fs, generator=None):
        out = run(wavs, lengths, bucket, fs, generator)
        out[(len(out) + 1) // 2:] = 0.0
        return out
    prog.run = half


def _altered(prog):
    run = prog.run

    def altered(wavs, lengths, bucket, fs, generator=None):
        out = run(wavs, lengths, bucket, fs, generator)
        out[:, : out.shape[1] // 8] *= -1.0
        return out
    prog.run = altered


@pytest.mark.parametrize("cell,fault", [
    ("bsrnn196.train", _unchanged), ("flowse384.train", _unchanged),
    ("bsrnn196.train", _norm_biases_unmoved), ("flowse384.train", _norm_biases_unmoved),
    ("bsrnn196.train", _half_train), ("flowse384.train", _half_train),
    ("bsrnn196.enhance_b8", _half_enhance), ("bsrnn196.enhance_b8", _altered),
    ("flowse384.enhance", _altered)])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    out = _run(tiny, cell, hook=fault)
    assert not out["correct"], out["checks"]
