"""Export a checkpoint of the port to the reference's Lightning ``.ckpt``
layout (counterpart of ``scripts/export_to_torch.py``).

    python -m urgent2026_challenge_track1_tpu_torch.export_ckpt \
        --ckpt exp/.../step_8.pt --out model.ckpt

Reads the port's own files: a trainer checkpoint (``train/trainer.
CheckpointIO``: parameters, the EMA weights of a flow model, step, epoch
and the training config) or a ``utils/checkpoint.save_model`` file.  The
output has ``se_model.bsrnn.bsrnn.*`` keys for a discriminative model and
``dnn.*`` keys plus the torch_ema ``ema`` record for a flow model, so the
reference's inference and the port's ``--ckpt_path`` both load it.  The
conversion is host work: the weights are read onto the CPU and no card is
needed.
"""

from __future__ import annotations

import argparse
import dataclasses

__all__ = ["load_port_checkpoint", "main"]


def load_port_checkpoint(path: str):
    """(kind, model, ema_model or None, step, epoch, config dict) of a port
    checkpoint, the models on the CPU in float32; ``config`` is the
    training config's dict (for a ``save_model`` file, the defaults with
    the file's architecture)."""
    import torch

    from urgent2026_challenge_track1_tpu_torch.config import Config
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import BSRNN, BSRNNConfig
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn_flowse import FlowDNN, FlowSEConfig
    from urgent2026_challenge_track1_tpu_torch.train.trainer import build_model
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import PORT_FORMAT, TRAIN_FORMAT

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    fmt = ckpt.get("format") if isinstance(ckpt, dict) else None
    if fmt == TRAIN_FORMAT:
        config = dict(ckpt["config"], compute_dtype="float32")
        bundle = build_model(Config(**config))
        kind, sd, ema_sd = bundle.kind, ckpt["params"], ckpt.get("ema")
        mcfg = bundle.model_cfg.dnn_cfg if kind == "flowse" else bundle.model_cfg
        step, epoch = int(ckpt.get("step", 0)), int(ckpt.get("epoch", 0))
    elif fmt == PORT_FORMAT:
        kind, sd, ema_sd = ckpt["kind"], ckpt["state_dict"], ckpt.get("ema")
        step = epoch = 0
        if kind == "flowse":
            fcfg = FlowSEConfig(**{**ckpt["config"], "compute_dtype": "float32"})
            mcfg = fcfg.dnn_cfg
            schema = Config().to_dict()
            config = Config(model_type="flowse", **{k: v for k, v in dataclasses.asdict(
                fcfg).items() if k in schema}).to_dict()
        else:
            mcfg = BSRNNConfig(**{**ckpt["config"], "compute_dtype": "float32"})
            config = Config(model_type="discriminative", model_configs={
                "num_channel": mcfg.num_channel, "num_layer": mcfg.num_layer,
                "causal": mcfg.causal, "streaming_norm": mcfg.streaming_norm}).to_dict()
    else:
        raise ValueError(f"{path}: not a checkpoint of the port (format {fmt!r}); a "
                         "reference .ckpt needs no export")

    def build(state):
        model = FlowDNN(mcfg) if kind == "flowse" else BSRNN(mcfg)
        model.load_state_dict(state, strict=True)
        return model

    ema = build(ema_sd) if kind == "flowse" and ema_sd is not None else None
    return kind, build(sd), ema, step, epoch, config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ckpt", required=True,
                        help="the port's trainer checkpoint (step_N.pt) or save_model file")
    parser.add_argument("--out", required=True, help="output .ckpt path")
    args = parser.parse_args(argv)

    import torch

    from urgent2026_challenge_track1_tpu_torch.utils import export_torch

    kind, model, ema, step, epoch, config = load_port_checkpoint(args.ckpt)
    # the reference instantiates its model as cls(**hyper_parameters) with
    # attribute access to cfg; a stdlib Namespace of the config dict loads
    # on any machine, and BSRNN_SE(**model_configs) takes the two widths
    if kind == "discriminative":
        config["model_configs"] = {"num_channel": model.cfg.num_channel,
                                   "num_layer": model.cfg.num_layer}
    export_torch.save_model_ckpt(args.out, model, ema, step=step, epoch=epoch,
                                 hyper_parameters={"cfg": argparse.Namespace(**config)})
    ckpt = torch.load(args.out, map_location="cpu", weights_only=False)
    ema_note = " + ema record" if "ema" in ckpt else ""
    print(f"exported {kind} checkpoint (step {ckpt['global_step']}, "
          f"{len(ckpt['state_dict'])} state_dict keys{ema_note}) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
