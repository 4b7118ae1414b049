"""The port's checkpoint averaging (``average_checkpoints.py``) against the
JAX script (``scripts/average_checkpoints.average_checkpoints``) on the CPU.

The port averages the trainer's ``step_<N>.pt`` files; the JAX script reads
orbax trees, written here with the same numpy leaves (parameter names with
"." as "__") and the same metas.  Both select the same steps, by val_loss
and by val_sisnr, and their means agree within 1e-7 (both sum in float64
in the same order and cast back to float32, so they are in fact equal).
The output loads through ``load_model_for_inference`` and enhances.
"""

import json
import sys
from pathlib import Path

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from urgent2026_challenge_track1_tpu_torch.average_checkpoints import average_checkpoints, main
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNN, bsrnn_se_apply
from urgent2026_challenge_track1_tpu_torch.train.trainer import (
    CheckpointIO,
    TrainState,
    build_model,
    make_optimizer,
)
from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import load_model_for_inference

sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))

from average_checkpoints import average_checkpoints as jax_average  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-7
# scale of the parameters, of the EMA weights, and the validation metrics per step
HISTORY = [(1, 1.0, 3.0, {"val_loss": 0.5, "val_sisnr": 5.0}),
           (2, 2.0, 0.5, {"val_loss": 0.9, "val_sisnr": 7.0}),
           (3, 4.0, 1.5, {"val_loss": 0.6, "val_sisnr": 6.5})]


def _scaled(model, scale):
    out = BSRNN(model.cfg)
    out.load_state_dict({k: v * scale for k, v in model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Three port checkpoints (params and EMA weights scaled per step) and
    the JAX script's orbax trees of the same leaves and metas."""
    tmp = tmp_path_factory.mktemp("avg")
    cfg = Config(model_configs={"num_channel": 4, "num_layer": 1}, device="cpu")
    torch.manual_seed(0)
    base = BSRNN(build_model(cfg).model_cfg)
    io = CheckpointIO(str(tmp / "port"), save_top_k=3, save_last=False, metric="val_sisnr")
    mgr = ocp.CheckpointManager(str(tmp / "jax"))
    for step, scale, ema_scale, metrics in HISTORY:
        model = _scaled(base, scale)
        ema = _scaled(base, ema_scale)
        state = TrainState(model, make_optimizer(cfg, model), step=step, epoch=step - 1,
                           ema=ema)
        io.save(step, state, metrics, cfg.to_dict())
        tree = {"params": {k.replace(".", "__"): v.numpy() for k, v in
                           model.state_dict().items()},
                "ema": {k.replace(".", "__"): v.numpy() for k, v in ema.state_dict().items()},
                "step": step, "epoch": step - 1}
        meta = {"val_loss": metrics["val_loss"], "metrics": metrics, "config": cfg.to_dict()}
        mgr.save(step, args=ocp.args.Composite(state=ocp.args.StandardSave(tree),
                                                meta=ocp.args.JsonSave(meta)))
    mgr.wait_until_finished()
    return tmp, base


def _jax_output(path):
    mgr = ocp.CheckpointManager(str(path))
    step = mgr.latest_step()
    restored = mgr.restore(step, args=ocp.args.Composite(
        state=ocp.args.StandardRestore(), meta=ocp.args.JsonRestore()))
    return step, restored["state"], restored["meta"]


@pytest.mark.parametrize("by, top_k, steps", [("val_loss", 2, [1, 3]),
                                              ("val_sisnr", 2, [2, 3]),
                                              ("val_loss", 3, [1, 2, 3])])
def test_selection_and_means_equal_jax(ckpts, tmp_path, by, top_k, steps):
    tmp, _ = ckpts
    info = average_checkpoints(str(tmp / "port"), str(tmp_path / "port_avg"), top_k=top_k,
                               by=by)
    jinfo = jax_average(str(tmp / "jax"), str(tmp_path / "jax_avg"), top_k=top_k, by=by)
    assert info["steps"] == jinfo["steps"] == steps
    assert info["val_losses"] == jinfo["val_losses"]
    got = torch.load(info["path"], map_location="cpu", weights_only=True)
    jstep, jstate, jmeta = _jax_output(tmp_path / "jax_avg")
    assert got["step"] == jstep == max(steps) and got["epoch"] == int(jstate["epoch"])
    assert "opt_state" not in got
    for kind in ("params", "ema"):
        assert len(got[kind]) == len(jstate[kind])
        for name, value in got[kind].items():
            ref = np.asarray(jstate[kind][name.replace(".", "__")])
            assert value.dtype == torch.float32 and ref.dtype == np.float32
            np.testing.assert_allclose(value.numpy(), ref, rtol=0, atol=TOL)
    meta = CheckpointIO._path(str(tmp_path / "port_avg"), max(steps), "json")
    with open(meta) as f:
        meta = json.load(f)
    for key in ("averaged_steps", "averaged_val_losses", "val_loss"):
        assert meta[key] == jmeta[key]


def test_output_loads_and_enhances(ckpts, tmp_path):
    """Explicit steps 1 and 2: the parameters are 1.5x the base, the
    directory loads through the inference loader and one forward is
    finite; the CLI prints the written file."""
    tmp, base = ckpts
    info = main(["--ckpt_dir", str(tmp / "port"), "--output", str(tmp_path / "avg"),
                 "--steps", "1", "2"])
    assert info["steps"] == [1, 2]
    kind, model, mcfg, stft_cfg = load_model_for_inference(str(tmp_path / "avg"), device="cpu")
    assert kind == "discriminative" and (mcfg.num_channel, mcfg.num_layer) == (4, 1)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, base.state_dict()[name] * 1.5, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        wav, _ = bsrnn_se_apply(model, stft_cfg, 0.1 * torch.ones(1, 4800), 48000)
    assert wav.shape == (1, 4800) and torch.isfinite(wav).all()


def test_rejects_missing_steps_and_metrics(ckpts, tmp_path):
    tmp, _ = ckpts
    with pytest.raises(SystemExit, match="not in"):
        average_checkpoints(str(tmp / "port"), str(tmp_path / "x"), steps=[99])
    with pytest.raises(SystemExit, match="stores metric"):
        average_checkpoints(str(tmp / "port"), str(tmp_path / "x"), by="val_pesq")
    with pytest.raises(SystemExit, match="no checkpoints"):
        average_checkpoints(str(tmp_path / "empty"), str(tmp_path / "x"))
