"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points pick the card unless asked for the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device

torch.set_num_threads(1)
REPO = Path(__file__).parent.parent
PKG = "urgent2026_challenge_track1_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "urgent2026_challenge_track1_tpu")


def _modules():
    root = REPO / PKG
    return sorted(
        ".".join((PKG, *p.relative_to(root).with_suffix("").parts)).removesuffix(".__init__")
        for p in root.rglob("*.py")
    )


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    loaded = json.loads(out.stdout.splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert PKG + ".inference" in loaded


def test_sources_import_no_jax():
    for path in (REPO / PKG).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            assert all(n.split(".")[0] not in FORBIDDEN for n in names), names


@pytest.mark.parametrize("device, expected", [("cpu", "cpu"), (torch.device("cpu"), "cpu")])
def test_resolve_device_cpu(device, expected):
    assert resolve_device(device).type == expected


def test_resolve_device_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_resolve_device_other_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")
