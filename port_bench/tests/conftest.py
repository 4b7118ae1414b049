"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark
(the same files, the models cut to 8 channels and one layer, the traffic to
short items at two or three rates) beside the real one."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "port_bench"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_TRAFFIC = {
    "train": {"kind": "train", "rates": [8000, 16000, 22050], "crop_samples": 4000,
              "last_item_fraction": 0.85, "checked_rates": [8000, 22050]},
    "enhance": {"kind": "enhance", "rates": [8000, 16000], "seconds": [0.3, 0.5],
                "batch_size": 1, "check_files": "all"},
    "enhance_b8": {"kind": "enhance", "rates": [8000], "batch_size": 4, "check_files": 3,
                   "lognormal": {"n": 6, "median_s": 0.5, "sigma": 0.5, "min_s": 0.2,
                                 "max_s": 1.5}},
}


def make_tiny(root: Path) -> tuple[Path, Path]:
    """A checkout root and a benchmark folder whose cells run on the CPU in
    seconds: every configuration at 8 channels and one layer, computing in
    float32 (the CLI's dtype on the CPU), two sampler steps."""
    bench = root / "bench"
    (bench / "traffic").mkdir(parents=True)
    (root / "cfg").mkdir()
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        if cfg["reference"] == "bsrnn":
            cfg["yaml"]["model_configs"] = {"num_channel": 8, "num_layer": 1}
        else:
            cfg["yaml"].update(bsrnn_hidden=8, num_layer=1)
            cfg["model"]["nfe"] = 2
        cfg["enhance_dtype"] = "float32"
        c["file"] = f"cfg/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    # the batched route's cell and the flow training cell, out of
    # BENCHMARK.json until the port's faults in them are fixed (PERF.md),
    # run here all the same
    spec["workloads"].append({"name": "bsrnn196.enhance_b8", "config": "bsrnn196",
                              "traffic": "enhance_b8", "chips": 1, "why": "batched"})
    spec["workloads"].append({"name": "flowse384.train", "config": "flowse384",
                              "traffic": "train", "chips": 1, "why": "flow training"})
    spec["per_layer"].append({"name": "batch_fill_pct.enhance", "unit": "%",
                              "better": "higher", "source": "program_counter",
                              "layer": "entry", "moves": "enhance_rate",
                              "workloads": ["bsrnn196.enhance_b8"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            cell = {"enhance_rate": "bsrnn196.enhance_b8",
                    "train_rate": "flowse384.train"}[m.get("moves", m["name"])]
            m["workloads"] = sorted(set(m["workloads"]) | {cell})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for k, v in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{k}.json").write_text(json.dumps(v))
    return root, bench


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(1)
    from port_bench.spec import Spec

    root, bench = make_tiny(tmp_path)
    return Spec(root, bench)
