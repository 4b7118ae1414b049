"""Checkpoint loading for inference (counterpart of ``utils/checkpoint.py``).

Two formats are read:
  * a reference Lightning ``.ckpt`` of the discriminative SEModel (prefix,
    width and depth are detected from the keys, as the JAX loader does);
  * the port's own file written by ``save_model`` (state_dict + config).
Orbax directories of the JAX package are not read here: export them to a
reference ``.ckpt`` with ``scripts/export_to_torch.py`` first.

On the card the model computes in bfloat16 (float32 norms, residual stream
and cell state); on the CPU in float32.
"""

from __future__ import annotations

import dataclasses

import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.dsp.stft import STFTConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNN, BSRNNConfig
from urgent2026_challenge_track1_tpu_torch.utils import convert
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

__all__ = ["load_model_for_inference", "save_model", "PORT_FORMAT"]

PORT_FORMAT = "urgent2026-bsrnn-torch/1"
_ARCH_FIELDS = ("input_dim", "num_channel", "num_layer", "target_fs", "norm_eps")


def inference_dtype(device: torch.device) -> str:
    return "bfloat16" if device.type == "cuda" else "float32"


def save_model(path: str, model: BSRNN, stft_cfg: STFTConfig) -> str:
    """Write the port's checkpoint: architecture, STFT geometry, weights."""
    torch.save({
        "format": PORT_FORMAT,
        "kind": "discriminative",
        "config": {k: getattr(model.cfg, k) for k in _ARCH_FIELDS},
        "stft": dataclasses.asdict(stft_cfg),
        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
    }, path)
    return path


def _from_port_file(ckpt: dict, dtype: str):
    cfg = BSRNNConfig(**ckpt["config"], compute_dtype=dtype)
    model = BSRNN(cfg)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return model, STFTConfig(**ckpt["stft"])


def _from_reference(sd: dict, dtype: str):
    if any(k.startswith("dnn.") for k in sd):
        raise NotImplementedError(
            "flow-matching (FlowSEModel) checkpoints are not supported by the "
            "PyTorch port yet; use the JAX package's inference.py"
        )
    first = next(k for k in sd if "band_split.fc.0.weight" in k)
    prefix = first.split("band_split")[0]
    n = sd[f"{prefix}band_split.fc.0.bias"].shape[0]
    layers = len({k.split("rnn_time.")[1].split(".")[0] for k in sd if f"{prefix}rnn_time." in k})
    cfg = BSRNNConfig(input_dim=481, num_channel=n, num_layer=layers)
    tree = convert.convert_discriminative_state_dict(sd, cfg, prefix)
    return from_jax_params(tree, compute_dtype=dtype), STFTConfig(n_fft=960, hop_length=480)


def load_model_for_inference(path: str, device="cuda"):
    """Returns (kind, model, model_cfg, stft_cfg) with the model on
    ``device`` in eval mode."""
    dev = resolve_device(device)
    dtype = inference_dtype(dev)
    sd, ckpt = convert.load_torch_checkpoint(path)
    if isinstance(ckpt, dict) and ckpt.get("format") == PORT_FORMAT:
        model, stft_cfg = _from_port_file(ckpt, dtype)
    else:
        model, stft_cfg = _from_reference(sd, dtype)
    model = model.to(dev).eval()
    return "discriminative", model, model.cfg, stft_cfg
