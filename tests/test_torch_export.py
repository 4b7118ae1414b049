"""The port's export to the reference checkpoint layout
(``utils/export_torch.py``, ``export_ckpt.py``) against the JAX package's
``utils/export_torch.py``, on the CPU.

A tree in the JAX package's layout, drawn by numpy from a seed, becomes a
port model (``utils/params.from_jax_params``); the port exports that model and the JAX
package exports the tree.  The two checkpoints must be equal key for key, in
the same order, with bitwise equal tensors and the same torch_ema record;
reading the port's file back through ``load_model_for_inference`` must give
bitwise the same parameters.  Both families, at a few channels and layers.
"""

import argparse
import types

import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.models import bsrnn as jbsrnn
from urgent2026_challenge_track1_tpu.models import bsrnn_flowse as jflow
from urgent2026_challenge_track1_tpu.utils import export_torch as jexport
from urgent2026_challenge_track1_tpu_torch import export_ckpt
from urgent2026_challenge_track1_tpu_torch.config import Config
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as tbsrnn
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as tflow
from urgent2026_challenge_track1_tpu_torch.train import trainer as ttrainer
from urgent2026_challenge_track1_tpu_torch.utils import checkpoint as tckpt
from urgent2026_challenge_track1_tpu_torch.utils import export_torch as texport
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params, to_numpy_tree

torch.set_num_threads(1)


def _jax_tree(family):
    """(tree, JAX export cfg, EMA tree or None): a tree in the JAX package's
    layout (numpy leaves, layers stacked), 8 channels, 2 layers, its values
    drawn by numpy from a seed where the initialiser's are not zero."""
    rng = np.random.default_rng(1 if family == "discriminative" else 2)
    if family == "discriminative":
        cfg = jbsrnn.BSRNNConfig(input_dim=481, num_channel=8, num_layer=2)
        shapes = to_numpy_tree(tbsrnn.init_bsrnn(tbsrnn.BSRNNConfig(num_channel=8, num_layer=2),
                                                 device="cpu"))
    else:
        fcfg = jflow.FlowSEConfig(bsrnn_hidden=8, num_layer=2)
        cfg = fcfg.dnn_cfg
        shapes = to_numpy_tree(tflow.init_flowse(tflow.FlowSEConfig(bsrnn_hidden=8, num_layer=2),
                                                 device="cpu"))

    def draw(tree, scale=1.0):  # the padded band rows stay zero, as the export drops them
        return {k: draw(v, scale) if isinstance(v, dict) else
                np.where(v != 0, scale * rng.standard_normal(np.shape(v)), 0).astype(np.float32)
                for k, v in tree.items()}

    params = draw(shapes)
    if family == "discriminative":
        return params, cfg, None
    # an EMA that differs from the weights everywhere but the frozen
    # projection, as the trainer's EMA of t_proj_w stays the weight
    ema = draw(shapes, 0.5)
    ema["layers"]["t_proj_w"] = params["layers"]["t_proj_w"].copy()
    return params, cfg, ema


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_ckpt_equal(got, ref):
    assert list(got["state_dict"]) == list(ref["state_dict"])  # key order is load-bearing
    for k, v in ref["state_dict"].items():
        assert got["state_dict"][k].dtype == v.dtype and torch.equal(got["state_dict"][k], v), k
    for k in ("epoch", "global_step", "pytorch-lightning_version"):
        assert got[k] == ref[k], k
    assert ("ema" in got) == ("ema" in ref)
    if "ema" in ref:
        g, r = got["ema"], ref["ema"]
        assert (g["decay"], g["num_updates"], g["collected_params"]) == (
            r["decay"], r["num_updates"], r["collected_params"])
        assert len(g["shadow_params"]) == len(r["shadow_params"])
        for a, b in zip(g["shadow_params"], r["shadow_params"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["discriminative", "flowse"])
def test_export_equals_jax_export(family):
    params, cfg, ema = _jax_tree(family)
    model = from_jax_params(params)
    ema_model = None if ema is None else from_jax_params(ema)
    assert (model.cfg.subbands, model.cfg.num_layer, model.cfg.causal,
            model.cfg.num_channel) == (cfg.subbands, cfg.num_layer, cfg.causal, cfg.num_channel)
    ref = jexport.build_lightning_ckpt(family, params, cfg, ema_params=ema, step=7, epoch=1)
    got = texport.build_lightning_ckpt(family, to_numpy_tree(model), model.cfg,
                                       ema_params=None if ema is None else to_numpy_tree(
                                           ema_model), step=7, epoch=1)
    _assert_ckpt_equal(got, ref)
    if family == "flowse":
        assert len(got["ema"]["shadow_params"]) == len(got["state_dict"]) - cfg.num_layer


@pytest.mark.parametrize("family", ["discriminative", "flowse"])
def test_export_round_trips_bitwise(family, tmp_path):
    """export, then the port's reader (``_from_reference``): the same
    parameters bit for bit (a flow model's: its EMA weights)."""
    params, cfg, ema = _jax_tree(family)
    model = from_jax_params(params)
    ema_model = None if ema is None else from_jax_params(ema)
    path = texport.save_model_ckpt(str(tmp_path / "m.ckpt"), model, ema_model, step=3)
    jpath = jexport.save_lightning_ckpt(str(tmp_path / "j.ckpt"), family, params, cfg,
                                        ema_params=ema, step=3)
    _assert_ckpt_equal(torch.load(path, weights_only=False), torch.load(jpath, weights_only=False))
    kind, loaded, _, _ = tckpt.load_model_for_inference(path, device="cpu")
    assert kind == family
    want = _leaves(to_numpy_tree(ema_model if ema_model is not None else model))
    got = _leaves(to_numpy_tree(loaded))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _trainer_checkpoint(tmp_path):
    """A flow checkpoint written by the port's ``CheckpointIO`` (4 wide, one
    layer), its EMA moved off the weights."""
    cfg = Config(model_type="flowse", bsrnn_hidden=4, num_layer=1, device="cpu", seed=5)
    bundle = ttrainer.build_model(cfg)
    model = ttrainer.init_params(cfg.seed, bundle, "cpu")
    ema = ttrainer.init_params(cfg.seed, bundle, "cpu").requires_grad_(False)
    with torch.no_grad():
        for name, p in ema.named_parameters():
            if not name.endswith("t_proj_w"):
                p.mul_(0.75)
    # the export reads no optimizer state: a stand-in spares AdamW's first build
    state = ttrainer.TrainState(model, types.SimpleNamespace(state_dict=dict), step=9, epoch=2,
                                ema=ema)
    io = ttrainer.CheckpointIO(str(tmp_path / "ckpts"), save_top_k=1, save_last=False)
    io.save(9, state, 0.5, cfg.to_dict())
    return tmp_path / "ckpts" / "step_9.pt", model, ema


@pytest.mark.parametrize("family", ["discriminative", "flowse"])
def test_export_cli_on_port_checkpoints(family, tmp_path, capsys):
    """The CLI on a ``save_model`` file (discriminative) and on a trainer
    checkpoint (flow): the output loads back into the same parameters, a
    flow model's EMA weights, and carries the step and the config."""
    if family == "discriminative":
        params, _, _ = _jax_tree(family)
        model = ema = from_jax_params(params)
        src = tckpt.save_model(str(tmp_path / "m.pt"), model, STFTConfig())
        step = 0
    else:
        src, model, ema = _trainer_checkpoint(tmp_path)
        step = 9
    out = str(tmp_path / "out.ckpt")
    export_ckpt.main(["--ckpt", str(src), "--out", out])
    assert f"exported {family} checkpoint (step {step}" in capsys.readouterr().out
    ckpt = torch.load(out, weights_only=False)
    assert ckpt["global_step"] == step
    hp = ckpt["hyper_parameters"]["cfg"]
    assert isinstance(hp, argparse.Namespace) and hp.model_type == family
    kind, loaded, _, _ = tckpt.load_model_for_inference(out, device="cpu")
    assert kind == family
    want, got = _leaves(to_numpy_tree(ema)), _leaves(to_numpy_tree(loaded))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if family == "flowse":  # the frozen projection is the weights', the rest the EMA's
        np.testing.assert_array_equal(got["layers/t_proj_w"],
                                      to_numpy_tree(model)["layers"]["t_proj_w"])


def test_export_cli_refuses_other_files(tmp_path):
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {}}, path)
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        export_ckpt.main(["--ckpt", str(path), "--out", str(tmp_path / "o.ckpt")])
