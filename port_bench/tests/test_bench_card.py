"""On the card (marked ``cuda``; skipped without one): a small run of each
cell through the port's kernels is correct, and the control (the reference
in the program's place, one precision below the configuration's) is not.

    python -m pytest port_bench/tests -m cuda
"""

from __future__ import annotations

import json
import time

import pytest
import torch

# flowse384.train is not here: the port runs its conv's backward in TF32
# under PyTorch's defaults, so on the card it is not correct (PERF.md)
CONTROL = {"bsrnn196.train": "tf32", "bsrnn196.enhance_b8": "fp8", "flowse384.enhance": "fp8"}


@pytest.fixture
def card_spec(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for c in tiny.bench["configs"]:
        path = tiny.root / c["file"]
        cfg = json.loads(path.read_text())
        if cfg["reference"] == "bsrnn":
            cfg["yaml"]["model_configs"] = {"num_channel": 64, "num_layer": 2}
        else:
            cfg["yaml"].update(bsrnn_hidden=64, num_layer=2)
        cfg["enhance_dtype"] = "bfloat16"
        path.write_text(json.dumps(cfg))
    return tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_control_fails_where_the_program_passes(card_spec, cell):
    from port_bench.check import verdict
    from port_bench.harness import Cell

    c = Cell(card_spec, cell, 2 ** 31 + 3, 0.0, False, "cuda:0", time.perf_counter())
    out = c.run()
    assert out["correct"], out["checks"]
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    ok, shown = verdict(c.numbers(CONTROL[cell]), limits)
    assert not ok, shown
