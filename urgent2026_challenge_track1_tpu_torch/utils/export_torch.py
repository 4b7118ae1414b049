"""Export of the port's models to the reference's Lightning checkpoint
layout (counterpart of ``utils/export_torch.py``; the inverse of
``utils/convert.py``).

The ``.ckpt`` files use the released-checkpoint layout:
``se_model.bsrnn.bsrnn.*`` keys for the discriminative SEModel, ``dnn.*``
keys plus a torch_ema ``ema`` record for the FlowSEModel, so the reference's
inference sniffs and loads them unchanged, as does the port's
``utils/checkpoint.load_model_for_inference``.  The export functions take
the JAX-shaped tree of numpy arrays; ``save_model_ckpt`` feeds them a
``BSRNN`` or ``FlowDNN`` through ``utils/params.to_numpy_tree`` and reads
the fields they need (``subbands``, ``num_layer``, ``causal``,
``num_channel``) from the model's own ``BSRNNConfig``.

Key ORDER matters: the ``ema.shadow_params`` list is ordered like
``module.parameters()`` filtered to ``requires_grad`` — i.e. the state-dict
key order minus the frozen ``t_cond.{i}.W`` buffers.  Every export function
therefore emits keys in the reference module's registration order.  The
layout carries one ``t_cond.{i}.W``, the trained model's (the frozen
projection is not in the EMA record).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "export_discriminative_state_dict",
    "export_flowse_state_dict",
    "build_lightning_ckpt",
    "save_lightning_ckpt",
    "save_model_ckpt",
]


def _np32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _export_band_split(params, subbands, prefix):
    """Inverse of convert._convert_band_split: per-band GroupNorm(1, 2*sub)
    + Conv1d(2*sub, C, 1), valid rows sliced out of the padded stack."""
    sd = {}
    w = _np32(params["w"])
    b = _np32(params["b"])
    ns = _np32(params["norm_scale"])
    nb = _np32(params["norm_bias"])
    for i, sub in enumerate(subbands):
        cw = 2 * sub
        sd[f"{prefix}norm.{i}.weight"] = ns[i, :cw].copy()
        sd[f"{prefix}norm.{i}.bias"] = nb[i, :cw].copy()
    for i, sub in enumerate(subbands):
        cw = 2 * sub
        sd[f"{prefix}fc.{i}.weight"] = w[i, :cw].T[:, :, None].copy()
        sd[f"{prefix}fc.{i}.bias"] = b[i].copy()
    return sd


def _export_layers(sd, layers, prefix, num_layer, bidirectional_time, with_t_cond):
    """Inverse of convert._convert_layers, emitted in the reference
    registration order: norm_time -> rnn_time -> fc_time -> norm_freq ->
    rnn_freq -> fc_freq [-> t_cond]."""

    def put_lstm(name, p, bidirectional):
        srcs = [("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")]
        if bidirectional:
            srcs += [(f"{t}_reverse", f"{s}_reverse") for t, s in srcs]
        for i in range(num_layer):
            for tname, sname in srcs:
                sd[f"{prefix}{name}.{i}.{tname}"] = _np32(p[sname][i]).copy()

    for i in range(num_layer):
        sd[f"{prefix}norm_time.{i}.weight"] = _np32(layers["norm_time_scale"][i]).copy()
        sd[f"{prefix}norm_time.{i}.bias"] = _np32(layers["norm_time_bias"][i]).copy()
    put_lstm("rnn_time", layers["rnn_time"], bidirectional_time)
    for i in range(num_layer):
        sd[f"{prefix}fc_time.{i}.weight"] = _np32(layers["fc_time_w"][i]).T.copy()
        sd[f"{prefix}fc_time.{i}.bias"] = _np32(layers["fc_time_b"][i]).copy()
    for i in range(num_layer):
        sd[f"{prefix}norm_freq.{i}.weight"] = _np32(layers["norm_freq_scale"][i]).copy()
        sd[f"{prefix}norm_freq.{i}.bias"] = _np32(layers["norm_freq_bias"][i]).copy()
    put_lstm("rnn_freq", layers["rnn_freq"], True)
    for i in range(num_layer):
        sd[f"{prefix}fc_freq.{i}.weight"] = _np32(layers["fc_freq_w"][i]).T.copy()
        sd[f"{prefix}fc_freq.{i}.bias"] = _np32(layers["fc_freq_b"][i]).copy()
    if with_t_cond:
        for i in range(num_layer):
            sd[f"{prefix}t_cond.{i}.W"] = _np32(layers["t_proj_w"][i]).copy()
    return sd


def _export_mask_decoder_head(head, subbands, C, prefix):
    """Inverse of convert._convert_mask_decoder_head: espnet MaskDecoder mlp
    [GN(C), Conv1d(C,4C,1), tanh, Conv1d(4C,4*sub,1), GLU] — GLU channel
    layout [value rows | gate rows]."""
    sd = {}
    w1 = _np32(head["w1"])
    b1 = _np32(head["b1"])
    wv = _np32(head["wv"])
    wg = _np32(head["wg"])
    bv = _np32(head["bv"])
    bg = _np32(head["bg"])
    for i, sub in enumerate(subbands):
        cw = 2 * sub
        sd[f"{prefix}.{i}.0.weight"] = _np32(head["norm_scale"][i]).copy()
        sd[f"{prefix}.{i}.0.bias"] = _np32(head["norm_bias"][i]).copy()
        sd[f"{prefix}.{i}.1.weight"] = w1[i].T[:, :, None].copy()
        sd[f"{prefix}.{i}.1.bias"] = b1[i].copy()
        w2 = np.concatenate([wv[i, :, :cw].T, wg[i, :, :cw].T], axis=0)
        sd[f"{prefix}.{i}.3.weight"] = w2[:, :, None].copy()
        sd[f"{prefix}.{i}.3.bias"] = np.concatenate([bv[i, :cw], bg[i, :cw]])
    return sd


def _export_grad_decoder_head(head, subbands, sc, mlp_prefix, conv_prefix):
    """Inverse of convert._convert_grad_decoder_head (GradDecoder,
    models/bsrnn_flowse.py:103-168): per-band [GN(C), Conv1d(C, sub*sc, 1),
    tanh] with sc-major output channels; shared Conv2d(sc,4,5,1,2)."""
    mlp = {}
    w = _np32(head["w"])  # (K, C, sc, SM)
    b = _np32(head["b"])  # (K, sc, SM)
    for i, sub in enumerate(subbands):
        mlp[f"{mlp_prefix}.{i}.0.weight"] = _np32(head["norm_scale"][i]).copy()
        mlp[f"{mlp_prefix}.{i}.0.bias"] = _np32(head["norm_bias"][i]).copy()
        wf = w[i][:, :, :sub].transpose(1, 2, 0).reshape(sc * sub, -1)
        mlp[f"{mlp_prefix}.{i}.1.weight"] = wf[:, :, None].copy()
        mlp[f"{mlp_prefix}.{i}.1.bias"] = b[i][:, :sub].reshape(-1).copy()
    conv = {
        f"{conv_prefix}.0.weight": _np32(head["conv_w"]).transpose(3, 2, 0, 1).copy(),
        f"{conv_prefix}.0.bias": _np32(head["conv_b"]).copy(),
    }
    return mlp, conv


def export_discriminative_state_dict(params, cfg, prefix="se_model.bsrnn.bsrnn."):
    """init_bsrnn-shaped pytree -> SEModel state_dict (numpy values)."""
    subs = cfg.subbands
    sd = {}
    sd.update(_export_band_split(params["band_split"], subs, f"{prefix}band_split."))
    _export_layers(sd, params["layers"], prefix, cfg.num_layer,
                   not cfg.causal, False)
    mask = _export_mask_decoder_head(
        params["mask_decoder"]["mask"], subs, cfg.num_channel,
        f"{prefix}mask_decoder.mlp_mask")
    res = _export_mask_decoder_head(
        params["mask_decoder"]["residual"], subs, cfg.num_channel,
        f"{prefix}mask_decoder.mlp_residual")
    sd.update(mask)
    sd.update(res)
    return sd


def export_flowse_state_dict(params, cfg, prefix="dnn."):
    """init_flowse-shaped pytree -> FlowSEModel state_dict (numpy values).

    Registration order (tests/torch_ref_bsrnn.FlowBSRNN / reference
    bsrnn_flowse.py:171-241): band_split_y FIRST, then band_split_x."""
    subs = cfg.subbands
    sd = {}
    sd.update(_export_band_split(params["band_split_y"], subs,
                                 f"{prefix}band_split_y."))
    sd.update(_export_band_split(params["band_split"], subs,
                                 f"{prefix}band_split_x."))
    sd[f"{prefix}condition_fc.weight"] = _np32(params["condition_fc_w"]).T.copy()
    sd[f"{prefix}condition_fc.bias"] = _np32(params["condition_fc_b"]).copy()
    _export_layers(sd, params["layers"], prefix, cfg.num_layer,
                   not cfg.causal, True)
    sc = params["grad_decoder"]["mask"]["w"].shape[2]
    m_mlp, m_conv = _export_grad_decoder_head(
        params["grad_decoder"]["mask"], subs, sc,
        f"{prefix}grad_decoder.mlp_mask", f"{prefix}grad_decoder.conv_after_mask")
    r_mlp, r_conv = _export_grad_decoder_head(
        params["grad_decoder"]["residual"], subs, sc,
        f"{prefix}grad_decoder.mlp_residual",
        f"{prefix}grad_decoder.conv_after_residual")
    # GradDecoder registers the mlp ModuleLists BEFORE conv_after_mask /
    # conv_after_residual (reference bsrnn_flowse.py:108-114) — this order is
    # load-bearing for the positional ema.shadow_params record
    sd.update(m_mlp)
    sd.update(r_mlp)
    sd.update(m_conv)
    sd.update(r_conv)
    return sd


def _ema_record(sd_keys, ema_sd, decay=0.999, num_updates=0):
    """torch_ema ExponentialMovingAverage.state_dict(): shadow_params ordered
    like parameters() with requires_grad — state-dict order minus the frozen
    t_cond buffers (flow_model.py:98-112; parity_vs_released.apply_ema)."""
    import re

    import torch

    shadow = [torch.from_numpy(np.ascontiguousarray(ema_sd[k]))
              for k in sd_keys if not re.fullmatch(r"dnn\.t_cond\.\d+\.W", k)]
    # torch_ema's load_state_dict indexes "collected_params" unconditionally
    return {"decay": decay, "num_updates": num_updates,
            "shadow_params": shadow, "collected_params": None}


def build_lightning_ckpt(kind, params, cfg, ema_params=None, step=0, epoch=0,
                         hyper_parameters=None):
    """Full released-layout checkpoint dict (pass to torch.save)."""
    import torch

    if kind == "flowse":
        sd_np = export_flowse_state_dict(params, cfg)
    elif kind == "discriminative":
        sd_np = export_discriminative_state_dict(params, cfg)
    else:
        raise ValueError(f"unknown model kind: {kind}")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd_np.items()}
    ckpt = {
        "state_dict": sd,
        "hyper_parameters": hyper_parameters or {},
        "epoch": int(epoch),
        "global_step": int(step),
        # Lightning's checkpoint migration requires this key before
        # load_from_checkpoint will touch the file
        "pytorch-lightning_version": "2.2.0",
    }
    if kind == "flowse" and ema_params is not None:
        ema_np = export_flowse_state_dict(ema_params, cfg)
        ckpt["ema"] = _ema_record(list(sd_np), ema_np, num_updates=int(step))
    return ckpt


def save_lightning_ckpt(path, kind, params, cfg, ema_params=None, step=0,
                        epoch=0, hyper_parameters=None):
    import torch

    torch.save(
        build_lightning_ckpt(kind, params, cfg, ema_params, step, epoch,
                             hyper_parameters),
        path,
    )
    return path


def save_model_ckpt(path, model, ema_model=None, step=0, epoch=0, hyper_parameters=None):
    """Write a port ``BSRNN`` (discriminative) or ``FlowDNN`` (flow, with the
    EMA weights of ``ema_model`` as the ``ema`` record) as a reference
    ``.ckpt``; the configuration the export reads is the model's ``cfg``."""
    from urgent2026_challenge_track1_tpu_torch.utils.params import to_numpy_tree

    kind = "flowse" if model.cfg.with_condition else "discriminative"
    ema = None if ema_model is None else to_numpy_tree(ema_model)
    return save_lightning_ckpt(path, kind, to_numpy_tree(model), model.cfg, ema_params=ema,
                               step=step, epoch=epoch, hyper_parameters=hyper_parameters)
