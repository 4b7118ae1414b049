"""Reference Lightning ``state_dict`` -> JAX-shaped parameter tree (numpy),
for both model families (the port's copy of the mapping in
``utils/convert.py``).

Key structure of the reference SEModel (espnet BSRNNSeparator):
``se_model.bsrnn.bsrnn.{band_split,norm_time,rnn_time,fc_time,norm_freq,
rnn_freq,fc_freq,mask_decoder}...``; of the FlowSEModel:
``dnn.{band_split_x,band_split_y,condition_fc,t_cond,norm_time,rnn_time,...,
grad_decoder}...`` with its EMA weights in ``ckpt["ema"]``.  Per-band
tensors go into the band-stacked padded layout of ``models/bsrnn.py``; torch
LSTM tensors (gates i, f, g, o) copy through unchanged.
``utils/params.from_jax_params`` turns the tree into a ``BSRNN`` or a
``FlowDNN``.  ``load_init_from`` is the trainer's warm start: it tells the
family, width and depth of a reference checkpoint from its keys.
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_discriminative_state_dict", "convert_flowse_state_dict",
           "apply_ema_record", "load_torch_checkpoint", "load_init_from"]


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


def _convert_layers(sd, prefix, num_layer, with_t_cond=False):
    def stack(fmt, post=lambda x: x):
        return np.stack([post(_np(sd[fmt.format(i=i)])) for i in range(num_layer)])

    def lstm_params(name):
        p = {}
        for sfx in ("", "_reverse"):
            for src, dst in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                             ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                p[f"{dst}{sfx}"] = stack(f"{prefix}{name}.{{i}}.{src}{sfx}")
        return p

    layers = {
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
    if with_t_cond:
        layers["t_proj_w"] = stack(f"{prefix}t_cond.{{i}}.W")
    return layers


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


def _convert_grad_decoder_head(sd, mlp_prefix, conv_prefix, subbands, C, sc):
    """GradDecoder head: per band [GN(C), Conv1d(C, sub*sc, 1), tanh] (output
    channel s_c * sub + s_b), then the shared Conv2d(sc, 4, 5, 1, 2)."""
    K, SM = len(subbands), max(subbands)
    out = {
        "norm_scale": np.zeros((K, C), np.float32),
        "norm_bias": np.zeros((K, C), np.float32),
        "w": np.zeros((K, C, sc, SM), np.float32),
        "b": np.zeros((K, sc, SM), np.float32),
    }
    for i, sub in enumerate(subbands):
        out["norm_scale"][i] = _np(sd[f"{mlp_prefix}.{i}.0.weight"]).reshape(-1)
        out["norm_bias"][i] = _np(sd[f"{mlp_prefix}.{i}.0.bias"]).reshape(-1)
        wf = _np(sd[f"{mlp_prefix}.{i}.1.weight"])[:, :, 0].reshape(sc, sub, C)
        out["w"][i, :, :, :sub] = wf.transpose(2, 0, 1)
        out["b"][i, :, :sub] = _np(sd[f"{mlp_prefix}.{i}.1.bias"]).reshape(sc, sub)
    out["conv_w"] = _np(sd[f"{conv_prefix}.0.weight"]).transpose(2, 3, 1, 0)  # OIHW -> HWIO
    out["conv_b"] = _np(sd[f"{conv_prefix}.0.bias"])
    return out


def convert_flowse_state_dict(sd, cfg, prefix="dnn."):
    """FlowSEModel state_dict -> JAX ``init_flowse``-shaped tree of numpy
    arrays; ``cfg`` is the conditional network's BSRNNConfig."""
    subs, C = cfg.subbands, cfg.num_channel
    return {
        "band_split": _convert_band_split(sd, f"{prefix}band_split_x.", subs, C),
        "band_split_y": _convert_band_split(sd, f"{prefix}band_split_y.", subs, C),
        "condition_fc_w": _np(sd[f"{prefix}condition_fc.weight"]).T.copy(),
        "condition_fc_b": _np(sd[f"{prefix}condition_fc.bias"]),
        "layers": _convert_layers(sd, prefix, cfg.num_layer, with_t_cond=True),
        "grad_decoder": {
            head: _convert_grad_decoder_head(
                sd, f"{prefix}grad_decoder.mlp_{head}",
                f"{prefix}grad_decoder.conv_after_{head}", subs, C, cfg.sub_channel)
            for head in ("mask", "residual")
        },
    }


def apply_ema_record(sd: dict, ema_state: dict) -> dict:
    """The state_dict with its trainable tensors replaced by the torch_ema
    shadow parameters (the reference evaluates with its EMA weights).
    ``shadow_params`` follows ``parameters()`` with requires_grad: the
    state-dict order without the frozen ``dnn.t_cond.{i}.W`` buffers."""
    import re

    shadow = ema_state["shadow_params"]
    trainable = [k for k in sd if not re.fullmatch(r"dnn\.t_cond\.\d+\.W", k)]
    if len(shadow) != len(trainable):
        raise ValueError(f"EMA shadow_params count {len(shadow)} != trainable parameter "
                         f"count {len(trainable)}: not a FlowSEModel EMA record")
    out = dict(sd)
    out.update(zip(trainable, shadow))
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


def load_init_from(path: str) -> dict:
    """Warm start (the reference's train_se.py:55-60): the JAX-shaped tree
    of numpy arrays of a reference ``.ckpt``/``.pt``/``.pth``.  ``dnn.`` keys
    make it a FlowSEModel (width from ``condition_fc``, depth from
    ``rnn_time``), any other an SEModel (prefix, width and depth from its
    band split and ``rnn_time`` keys), as the JAX package's
    ``load_init_from`` reads them.  Any other path raises."""
    if not path.endswith((".ckpt", ".pt", ".pth")):
        raise ValueError(f"unsupported init_from: {path}")
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNNConfig

    sd, _ = load_torch_checkpoint(path)
    if any(k.startswith("dnn.") for k in sd):
        n = sd["dnn.condition_fc.bias"].shape[0]
        layers = len({k.split(".")[2] for k in sd if k.startswith("dnn.rnn_time.")})
        cfg = BSRNNConfig(input_dim=769, num_channel=n, num_layer=layers, with_condition=True)
        return convert_flowse_state_dict(sd, cfg)
    first = next(k for k in sd if "band_split.fc.0.weight" in k)
    prefix = first.split("band_split")[0]
    n = sd[f"{prefix}band_split.fc.0.bias"].shape[0]
    layers = len({k.split(".")[-2] for k in sd if k.startswith(f"{prefix}rnn_time.")})
    cfg = BSRNNConfig(input_dim=481, num_channel=n, num_layer=layers)
    return convert_discriminative_state_dict(sd, cfg, prefix)
