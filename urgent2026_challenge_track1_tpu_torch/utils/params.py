"""Bridge between the JAX parameter tree and the port's ``BSRNN`` module.

The JAX package keeps the dual-path layers stacked on a leading layer axis
(``params["layers"][name][i]``); the port keeps one ``DualPathLayer`` per
layer.  Every other leaf has the same name, shape and layout in both, so the
bridge only unstacks (or restacks) the layer axis.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNN, BSRNNConfig

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


def config_from_tree(tree: Mapping[str, Any], compute_dtype: str = "float32") -> BSRNNConfig:
    """The BSRNN configuration that the shapes of a discriminative tree imply."""
    K, C = np.shape(tree["band_split"]["b"])
    return BSRNNConfig(
        input_dim=_INPUT_DIM_BY_BANDS[K], num_channel=C,
        num_layer=np.shape(tree["layers"]["norm_time_scale"])[0],
        compute_dtype=compute_dtype,
    )


def from_jax_params(tree: Mapping[str, Any], compute_dtype: str = "float32",
                    device="cpu") -> BSRNN:
    """A ``BSRNN`` holding the leaves of a JAX ``init_bsrnn``-shaped tree
    (numpy or JAX arrays); the layer axis of ``tree["layers"]`` is unstacked."""
    cfg = config_from_tree(tree, compute_dtype)
    sd = {}
    for key, leaf in _flatten(tree).items():
        arr = np.asarray(leaf, dtype=np.float32)
        if key.startswith("layers."):
            for i in range(cfg.num_layer):
                sd[f"layers.{i}.{key[len('layers.'):]}"] = torch.from_numpy(arr[i].copy())
        else:
            sd[key] = torch.from_numpy(arr.copy())
    model = BSRNN(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def to_numpy_tree(model: BSRNN) -> dict[str, Any]:
    """The JAX-shaped tree (numpy leaves, layers stacked) of a ``BSRNN``."""
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
