"""Reference Lightning ``state_dict`` -> JAX-shaped parameter tree (numpy),
discriminative model only (the port's copy of the mapping in
``utils/convert.py``).

Key structure of the reference SEModel (espnet BSRNNSeparator):
``se_model.bsrnn.bsrnn.{band_split,norm_time,rnn_time,fc_time,norm_freq,
rnn_freq,fc_freq,mask_decoder}...``.  Per-band tensors go into the
band-stacked padded layout of ``models/bsrnn.py``; torch LSTM tensors (gates
i, f, g, o) copy through unchanged.  ``utils/params.from_jax_params`` turns
the tree into a ``BSRNN``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_discriminative_state_dict", "load_torch_checkpoint"]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _convert_band_split(sd, prefix, subbands, C):
    K, W = len(subbands), 2 * max(subbands)
    out = {
        "norm_scale": np.zeros((K, W), np.float32),
        "norm_bias": np.zeros((K, W), np.float32),
        "w": np.zeros((K, W, C), np.float32),
        "b": np.zeros((K, C), np.float32),
    }
    for i, sub in enumerate(subbands):
        cw = 2 * sub
        out["norm_scale"][i, :cw] = _np(sd[f"{prefix}norm.{i}.weight"]).reshape(-1)
        out["norm_bias"][i, :cw] = _np(sd[f"{prefix}norm.{i}.bias"]).reshape(-1)
        out["w"][i, :cw] = _np(sd[f"{prefix}fc.{i}.weight"])[:, :, 0].T
        out["b"][i] = _np(sd[f"{prefix}fc.{i}.bias"])
    return out


def _convert_layers(sd, prefix, num_layer):
    def stack(fmt, post=lambda x: x):
        return np.stack([post(_np(sd[fmt.format(i=i)])) for i in range(num_layer)])

    def lstm_params(name):
        p = {}
        for sfx in ("", "_reverse"):
            for src, dst in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                             ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                p[f"{dst}{sfx}"] = stack(f"{prefix}{name}.{{i}}.{src}{sfx}")
        return p

    return {
        "norm_time_scale": stack(f"{prefix}norm_time.{{i}}.weight"),
        "norm_time_bias": stack(f"{prefix}norm_time.{{i}}.bias"),
        "rnn_time": lstm_params("rnn_time"),
        "fc_time_w": stack(f"{prefix}fc_time.{{i}}.weight", post=lambda x: x.T),
        "fc_time_b": stack(f"{prefix}fc_time.{{i}}.bias"),
        "norm_freq_scale": stack(f"{prefix}norm_freq.{{i}}.weight"),
        "norm_freq_bias": stack(f"{prefix}norm_freq.{{i}}.bias"),
        "rnn_freq": lstm_params("rnn_freq"),
        "fc_freq_w": stack(f"{prefix}fc_freq.{{i}}.weight", post=lambda x: x.T),
        "fc_freq_b": stack(f"{prefix}fc_freq.{{i}}.bias"),
    }


def _convert_mask_decoder_head(sd, prefix, subbands, C):
    """espnet MaskDecoder mlp: [0]=GN(C), [1]=Conv1d(C,4C,1), [2]=tanh,
    [3]=Conv1d(4C, 4*sub, 1), [4]=GLU(dim=1) (value rows, then gate rows)."""
    K, W = len(subbands), 2 * max(subbands)
    out = {
        "norm_scale": np.zeros((K, C), np.float32),
        "norm_bias": np.zeros((K, C), np.float32),
        "w1": np.zeros((K, C, 4 * C), np.float32),
        "b1": np.zeros((K, 4 * C), np.float32),
        "wv": np.zeros((K, 4 * C, W), np.float32),
        "wg": np.zeros((K, 4 * C, W), np.float32),
        "bv": np.zeros((K, W), np.float32),
        "bg": np.zeros((K, W), np.float32),
    }
    for i, sub in enumerate(subbands):
        cw = 2 * sub
        out["norm_scale"][i] = _np(sd[f"{prefix}.{i}.0.weight"]).reshape(-1)
        out["norm_bias"][i] = _np(sd[f"{prefix}.{i}.0.bias"]).reshape(-1)
        out["w1"][i] = _np(sd[f"{prefix}.{i}.1.weight"])[:, :, 0].T
        out["b1"][i] = _np(sd[f"{prefix}.{i}.1.bias"])
        w2 = _np(sd[f"{prefix}.{i}.3.weight"])[:, :, 0]  # (4*sub, 4C)
        b2 = _np(sd[f"{prefix}.{i}.3.bias"])
        out["wv"][i, :, :cw] = w2[:cw].T
        out["wg"][i, :, :cw] = w2[cw:].T
        out["bv"][i, :cw] = b2[:cw]
        out["bg"][i, :cw] = b2[cw:]
    return out


def convert_discriminative_state_dict(sd, cfg, prefix="se_model.bsrnn.bsrnn."):
    """SEModel state_dict -> JAX ``init_bsrnn``-shaped tree of numpy arrays."""
    subs, C = cfg.subbands, cfg.num_channel
    return {
        "band_split": _convert_band_split(sd, f"{prefix}band_split.", subs, C),
        "layers": _convert_layers(sd, prefix, cfg.num_layer),
        "mask_decoder": {
            head: _convert_mask_decoder_head(sd, f"{prefix}mask_decoder.mlp_{head}", subs, C)
            for head in ("mask", "residual")
        },
    }


def load_torch_checkpoint(path: str):
    """(state_dict, full checkpoint dict) from a torch/Lightning checkpoint."""
    import torch

    # a Lightning checkpoint pickles more than tensors (hyper-parameters), as
    # the reference's own loader accepts
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return sd, ckpt
