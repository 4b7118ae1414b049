"""Every file of the benchmark parses, and BENCHMARK.json holds together:
each cell's configuration, mix and metric readers are found by name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {"setup_s"} <= {m["name"] for m in SPEC["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.glob("*/*.json")))
def test_json_files_parse(path):
    assert isinstance(json.loads((BENCH / path).read_text()), dict)


@pytest.mark.parametrize("metric", sorted(p.name[:-3] for p in (BENCH / "metrics").glob("*.py")))
def test_metric_readers_load_and_stay_silent_on_other_kinds(metric):
    from port_bench.harness import Readings
    from port_bench.spec import Spec

    read = Spec(REPO).reader(metric)
    other = "enhance" if metric.endswith(".train") else "train"
    assert read(Readings(other, window_s=1.0, flops=1.0, peak_flops=1.0, rows_real=1,
                         rows_total=1)) is None


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cells_find_their_pieces(cell):
    from port_bench.spec import Spec
    from port_bench.traffic import Traffic

    spec = Spec(REPO)
    w = spec.workload(cell)
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    assert Traffic(spec.traffic(w["traffic"]), cfg["yaml"]["batch_size"]).items
    e2e = {m["name"] for m in spec.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    assert set(cfg["limits"]) >= {spec.traffic(w["traffic"])["kind"]}


def test_config_sources_match_the_yaml_copies():
    import importlib.util

    if importlib.util.find_spec("yaml") is None:
        pytest.skip("PyYAML is not installed")
    import yaml

    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        shipped = yaml.safe_load((REPO / "conf" / "models" / c["source"].split("/")[-1]).read_text())
        for k, v in cfg["yaml"].items():
            assert shipped[k] == v, (c["name"], k)
