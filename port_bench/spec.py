"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic mix; the files live
beside this module (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``).  Adding a configuration, a mix or a metric adds a
file and an entry; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]

    def reader(self, metric: str):
        """``read(readings) -> float | None`` of ``metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def model_cfg(cfg: dict) -> dict:
    """The flat settings the reference and the yardstick read: the YAML's
    keys, its ``model_configs`` group and the file's ``model`` keys."""
    yaml = cfg["yaml"]
    return {**yaml, **(yaml.get("model_configs") or {}), **cfg.get("model", {})}
