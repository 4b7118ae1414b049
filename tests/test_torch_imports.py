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
    assert {PKG + ".inference", PKG + ".train_se", PKG + ".train.trainer",
            PKG + ".models.streaming_causal", PKG + ".serving", PKG + ".serve"} <= set(loaded)
    # the evaluation and export path: the ONNX executor, DNSMOS, the
    # intrusive metrics and their CLI, the export and its CLI
    assert {PKG + ".ops.onnx_torch", PKG + ".utils.onnx_lite", PKG + ".evaluation.dnsmos",
            PKG + ".evaluation.intrusive", PKG + ".evaluation._shared", PKG + ".metrics.pesq",
            PKG + ".metrics.pesq_tables", PKG + ".metrics.stoi", PKG + ".metrics.sdr",
            PKG + ".metrics.text", PKG + ".utils.export_torch", PKG + ".export_ckpt"} <= set(loaded)
    # the offline simulation CLIs, the model-scored evaluation CLIs with the
    # suite and the breakdown, and checkpoint averaging
    assert {PKG + ".simulation." + m for m in ("wind", "simulate_wind_noise",
                                               "generate_data_param",
                                               "simulate_data_from_param")} <= set(loaded)
    assert {PKG + ".evaluation." + m for m in (
        "_backends", "utmos", "scoreq", "nisqa", "speechbert_score", "phoneme_similarity",
        "speaker_similarity", "emotion_similarity", "lid_accuracy", "wer", "breakdown",
        "eval_all")} <= set(loaded)
    assert PKG + ".average_checkpoints" in loaded
    # importing them needs no PyYAML (the card machine may lack it)
    assert "yaml" not in loaded


def test_flow_family_imports_no_jax():
    """The flow-matching modules and the entry points' flow branches (trainer,
    checkpoint loader, serving) run a flow model without loading JAX."""
    code = (
        "import json, sys, torch\n"
        f"from {PKG}.models import bsrnn_flowse as F\n"
        f"from {PKG}.sampling import sample_flow\n"
        f"from {PKG}.models.odes import FlowMatching\n"
        f"from {PKG}.serving import make_enhance_fn\n"
        f"from {PKG}.train import trainer\n"
        f"from {PKG}.config import Config\n"
        "cfg = F.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=4, num_layer=1)\n"
        "model = F.init_flowse(cfg, seed=0, device='cpu')\n"
        "enhance = make_enhance_fn('flowse', model, cfg, cfg.stft_cfg, nfe=2)\n"
        "out = enhance(torch.zeros((1, 800)) + 0.1, 8000, None)\n"
        "bundle = trainer.build_model(Config(model_type='flowse', bsrnn_hidden=4, num_layer=1))\n"
        "assert bundle.kind == 'flowse' and out.shape == (1, 800)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    loaded = json.loads(out.stdout.splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert {PKG + ".models.odes", PKG + ".sampling", PKG + ".models.bsrnn_flowse"} <= set(loaded)


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


@pytest.mark.parametrize("family", ["bsrnn", "flowse"])
def test_model_constructors_pick_the_card_unless_asked_for_the_cpu(family, monkeypatch):
    """``init_bsrnn`` and ``init_flowse`` default to the card, as
    ``init_sgmse`` does: without one they raise, and they build on the CPU
    only where the caller asks for it."""
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn as B
    from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as F

    init, cfg = ((B.init_bsrnn, B.BSRNNConfig(num_channel=4, num_layer=1)) if family == "bsrnn"
                 else (F.init_flowse, F.FlowSEConfig(bsrnn_hidden=4, num_layer=1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init(cfg)
    model = init(cfg, seed=1, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_onnx_session_and_dnsmos_pick_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """The ONNX session and the DNSMOS entry point default to the card:
    without one they raise (no CPU fallback), and they build on the CPU
    only where the caller asks for it."""
    from urgent2026_challenge_track1_tpu_torch.evaluation import dnsmos, dnsmos_standin
    from urgent2026_challenge_track1_tpu_torch.ops import onnx_torch

    graph = dnsmos_standin.p808_graph()
    for name in ("p.onnx", "q.onnx"):
        (tmp_path / name).write_bytes(graph)
    models = (str(tmp_path / "p.onnx"), str(tmp_path / "q.onnx"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        onnx_torch.InferenceSession(graph)
    with pytest.raises(RuntimeError, match="cuda"):
        dnsmos.load_dnsmos(*models)
    args = dnsmos.parser().parse_args(["--inf_scp", "x", "--output_dir", str(tmp_path),
                                       "--primary_model", models[0], "--p808_model", models[1]])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        dnsmos.load_dnsmos(args.primary_model, args.p808_model, args.device)
    assert onnx_torch.InferenceSession(graph, device="cpu").device.type == "cpu"
    assert {s.device.type for s in dnsmos.load_dnsmos(*models, device="cpu")} == {"cpu"}
