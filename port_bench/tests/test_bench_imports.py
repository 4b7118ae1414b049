"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

JAXLIKE = {"jax", "jaxlib", "flax", "urgent2026_challenge_track1_tpu"}
PORT = "urgent2026_challenge_track1_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py") if "tests" not in p.parts))
def test_sources_name_no_jax(path):
    names = set(_imports(BENCH / path))
    assert not names & JAXLIKE
    if path.startswith("reference/"):
        assert PORT not in names


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_loads_no_port_and_no_jax():
    names = _loaded("import port_bench.reference, port_bench.yardstick, port_bench.check")
    assert not names & (JAXLIKE | {PORT})


def test_harness_and_program_load_no_jax():
    names = _loaded("import port_bench.harness, port_bench.program as p\np._port()")
    assert PORT in names and not names & JAXLIKE


def test_the_harness_check_compares_whole_names(monkeypatch):
    import types

    from port_bench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "urgent2026_challenge_track1_tpu_torch_x", types.ModuleType("x"))
    assert forbidden_modules() == [] or set(forbidden_modules()) <= JAXLIKE
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert "flax" in forbidden_modules()
