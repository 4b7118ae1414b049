"""Bridge between the JAX parameter tree and the port's ``BSRNN`` and
``FlowDNN`` modules.

The JAX package keeps the dual-path layers stacked on a leading layer axis
(``params["layers"][name][i]``); the port keeps one ``DualPathLayer`` per
layer.  Every other leaf has the same name, shape and layout in both, so the
bridge only unstacks (or restacks) the layer axis.  A tree with a
``grad_decoder`` (the JAX ``init_flowse``) becomes a ``FlowDNN``; a tree
whose ``rnn_time`` has no ``_reverse`` weights is a causal model's.
Whether a causal model normalizes cumulatively (``streaming_norm``) does
not show in its shapes, so the caller says so.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from torch import nn

from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNN, BSRNNConfig
from urgent2026_challenge_track1_tpu_torch.models.bsrnn_flowse import FlowDNN

__all__ = ["from_jax_params", "to_numpy_tree", "config_from_tree"]

_INPUT_DIM_BY_BANDS = {34: 481, 48: 769}  # subband_layout of each input_dim


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def config_from_tree(tree: Mapping[str, Any], compute_dtype: str = "float32",
                     streaming_norm: bool = False) -> BSRNNConfig:
    """The BSRNN configuration that the shapes of a tree imply (the
    conditional network's when the tree has a ``grad_decoder``; a causal
    one when its time LSTM has no reverse direction)."""
    K, C = np.shape(tree["band_split"]["b"])
    flow = "grad_decoder" in tree
    return BSRNNConfig(
        input_dim=_INPUT_DIM_BY_BANDS[K], num_channel=C,
        num_layer=np.shape(tree["layers"]["norm_time_scale"])[0],
        compute_dtype=compute_dtype, with_condition=flow,
        sub_channel=np.shape(tree["grad_decoder"]["mask"]["w"])[2] if flow else 16,
        causal="w_ih_reverse" not in tree["layers"]["rnn_time"], streaming_norm=streaming_norm,
    )


def from_jax_params(tree: Mapping[str, Any], compute_dtype: str = "float32",
                    device="cpu", streaming_norm: bool = False) -> nn.Module:
    """A ``BSRNN`` (``FlowDNN`` for a flow tree) holding the leaves of a JAX
    ``init_bsrnn``- or ``init_flowse``-shaped tree (numpy or JAX arrays); the
    layer axis of ``tree["layers"]`` is unstacked.  ``streaming_norm``: the
    causal model's cumulative norms (the tree cannot tell)."""
    cfg = config_from_tree(tree, compute_dtype, streaming_norm)
    sd = {}
    for key, leaf in _flatten(tree).items():
        arr = np.asarray(leaf, dtype=np.float32)
        if key.startswith("layers."):
            for i in range(cfg.num_layer):
                sd[f"layers.{i}.{key[len('layers.'):]}"] = torch.from_numpy(arr[i].copy())
        else:
            sd[key] = torch.from_numpy(arr.copy())
    model = FlowDNN(cfg) if cfg.with_condition else BSRNN(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def to_numpy_tree(model: nn.Module) -> dict[str, Any]:
    """The JAX-shaped tree (numpy leaves, layers stacked) of a ``BSRNN`` or
    ``FlowDNN``."""
    tree: dict[str, Any] = {}
    per_layer: dict[str, list[np.ndarray]] = {}
    for key, t in model.state_dict().items():
        arr = t.detach().float().cpu().numpy()
        parts = key.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(".".join(parts[2:]), []).append(arr)
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    layers: dict[str, Any] = {}
    for name, arrs in per_layer.items():
        node = layers
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.stack(arrs)
    tree["layers"] = layers
    return tree
