"""Checkpoint loading for inference (counterpart of ``utils/checkpoint.py``).

Three formats are read, for both model families:
  * a reference Lightning ``.ckpt`` of the discriminative SEModel (prefix,
    width and depth are detected from the keys, as the JAX loader does) or
    of the FlowSEModel (``dnn.`` keys), whose EMA weights replace the
    trainable ones when the file carries them;
  * the port's own file written by ``save_model`` (state_dict + config, and
    the EMA weights of a flow model);
  * a checkpoint of the port's trainer (``train/trainer.CheckpointIO``): its
    config rebuilds the model, a flow model loads its EMA weights; a
    directory of them (``average_checkpoints``'s output) reads as its
    newest ``step_<N>.pt``.
Orbax directories of the JAX package are not read here: export them to a
reference ``.ckpt`` with ``scripts/export_to_torch.py`` first.

On the card the model computes in bfloat16 (float32 norms, residual stream
and cell state); on the CPU in float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNN, BSRNNConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn_flowse import FlowDNN, FlowSEConfig
from urgent2026_challenge_track1_tpu_torch.utils import convert
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

__all__ = ["load_model_for_inference", "save_model", "PORT_FORMAT", "TRAIN_FORMAT"]

PORT_FORMAT = "urgent2026-bsrnn-torch/1"
TRAIN_FORMAT = "urgent2026-bsrnn-torch-train/1"  # train/trainer.CheckpointIO files
_ARCH_FIELDS = ("input_dim", "num_channel", "num_layer", "target_fs", "norm_eps", "causal",
                "streaming_norm")


def inference_dtype(device: torch.device) -> str:
    return "bfloat16" if device.type == "cuda" else "float32"


def save_model(path: str, model: nn.Module, stft_cfg: STFTConfig,
               flow_cfg: Optional[FlowSEConfig] = None,
               ema: Optional[nn.Module] = None) -> str:
    """Write the port's checkpoint: architecture, STFT geometry, weights.  A
    flow model (``FlowDNN``) is saved with its ``FlowSEConfig`` and, when
    given, its EMA weights, which inference loads in their place."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if flow_cfg is None:
        payload = {"kind": "discriminative", "config": {k: getattr(model.cfg, k)
                                                         for k in _ARCH_FIELDS},
                   "stft": dataclasses.asdict(stft_cfg), "state_dict": state}
    else:
        payload = {"kind": "flowse", "config": dataclasses.asdict(flow_cfg), "state_dict": state}
        if ema is not None:
            payload["ema"] = {k: v.detach().cpu() for k, v in ema.state_dict().items()}
    torch.save({"format": PORT_FORMAT, **payload}, path)
    return path


def _from_port_file(ckpt: dict, dtype: str):
    if ckpt.get("kind") == "flowse":
        fcfg = dataclasses.replace(FlowSEConfig(**ckpt["config"]), compute_dtype=dtype)
        model = FlowDNN(fcfg.dnn_cfg)
        model.load_state_dict(ckpt.get("ema", ckpt["state_dict"]), strict=True)
        return "flowse", model, fcfg, fcfg.stft_cfg
    cfg = BSRNNConfig(**ckpt["config"], compute_dtype=dtype)
    model = BSRNN(cfg)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return "discriminative", model, cfg, STFTConfig(**ckpt["stft"])


def _from_trainer_file(ckpt: dict, dtype: str):
    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.train.trainer import build_model

    bundle = build_model(Config(**{**ckpt["config"], "compute_dtype": dtype}))
    if bundle.kind == "flowse":
        model = FlowDNN(bundle.model_cfg.dnn_cfg)
        model.load_state_dict(ckpt.get("ema") or ckpt["params"], strict=True)
    else:
        model = BSRNN(bundle.model_cfg)
        model.load_state_dict(ckpt["params"], strict=True)
    return bundle.kind, model, bundle.model_cfg, bundle.stft_cfg


def _from_reference(sd: dict, ckpt: dict, dtype: str):
    if any(k.startswith("dnn.") for k in sd):
        if "ema" in ckpt:
            sd = convert.apply_ema_record(sd, ckpt["ema"])
        n = sd["dnn.condition_fc.bias"].shape[0]
        layers = len({k.split(".")[2] for k in sd if k.startswith("dnn.rnn_time.")})
        fcfg = FlowSEConfig(bsrnn_hidden=n, num_layer=layers, compute_dtype=dtype)
        tree = convert.convert_flowse_state_dict(sd, fcfg.dnn_cfg)
        return "flowse", from_jax_params(tree, compute_dtype=dtype), fcfg, fcfg.stft_cfg
    first = next(k for k in sd if "band_split.fc.0.weight" in k)
    prefix = first.split("band_split")[0]
    n = sd[f"{prefix}band_split.fc.0.bias"].shape[0]
    layers = len({k.split("rnn_time.")[1].split(".")[0] for k in sd if f"{prefix}rnn_time." in k})
    cfg = BSRNNConfig(input_dim=481, num_channel=n, num_layer=layers)
    tree = convert.convert_discriminative_state_dict(sd, cfg, prefix)
    model = from_jax_params(tree, compute_dtype=dtype)
    return "discriminative", model, model.cfg, STFTConfig(n_fft=960, hop_length=480)


def _checkpoint_file(path: str) -> str:
    """``path``, or the newest ``step_<N>.pt`` of a directory of trainer
    checkpoints."""
    if not os.path.isdir(path):
        return path
    from urgent2026_challenge_track1_tpu_torch.train.trainer import CheckpointIO

    steps = CheckpointIO._steps(path)
    if not steps:
        raise FileNotFoundError(f"{path}: a directory without step_<N>.pt checkpoints")
    return CheckpointIO._path(path, steps[-1], "pt")


def load_model_for_inference(path: str, device="cuda"):
    """Returns (kind, model, model_cfg, stft_cfg) with the model on
    ``device`` in eval mode; ``model_cfg`` is the ``BSRNNConfig`` of a
    discriminative model and the ``FlowSEConfig`` of a flow model."""
    dev = resolve_device(device)
    dtype = inference_dtype(dev)
    sd, ckpt = convert.load_torch_checkpoint(_checkpoint_file(path))
    fmt = ckpt.get("format") if isinstance(ckpt, dict) else None
    if fmt == PORT_FORMAT:
        kind, model, model_cfg, stft_cfg = _from_port_file(ckpt, dtype)
    elif fmt == TRAIN_FORMAT:
        kind, model, model_cfg, stft_cfg = _from_trainer_file(ckpt, dtype)
    else:
        kind, model, model_cfg, stft_cfg = _from_reference(sd, ckpt, dtype)
    return kind, model.to(dev).eval(), model_cfg, stft_cfg
