"""Average the port trainer's checkpoints into one inference checkpoint
(counterpart of ``scripts/average_checkpoints.py``).

    python -m urgent2026_challenge_track1_tpu_torch.average_checkpoints \
        --ckpt_dir exp/.../checkpoints [--top_k 3 | --steps 12000 16000 20000] \
        [--by val_loss] [--output exp/.../checkpoints_avg]

Reads ``train/trainer.CheckpointIO``'s ``step_<N>.pt`` / ``step_<N>.json``
pairs.  Selects the ``--top_k`` steps with the best stored ``--by`` metric
(``val_loss`` ascending; a metric naming "sisnr" descending) or the
explicit ``--steps``, reads one checkpoint at a time into float64 running
sums of ``params`` (and of the EMA weights where every chosen checkpoint
has them), and writes their means, cast back to each tensor's dtype, as a
single step ``step_<max>.pt`` under ``--output`` with a meta holding
``averaged_steps`` and ``averaged_val_losses``.  The optimizer state is
dropped: the result is for inference (``inference.py`` / ``serve.py``
``--ckpt_path <output>``, ``utils/checkpoint.load_model_for_inference``),
not for resuming.  Host work: every tensor is read onto the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["average_checkpoints", "main"]


def _rank_value(meta: dict, by: str):
    """The stored value of ``by``, or None where this step has none (older
    metas carry only ``val_loss``)."""
    v = meta.get("metrics", {}).get(by)
    if v is None and by == "val_loss":
        v = meta.get("val_loss")
    return None if v is None else float(v)


def average_checkpoints(ckpt_dir: str, output: str, top_k: int = 3,
                        steps=None, by: str = "val_loss") -> dict:
    """Returns a summary: the chosen steps, their val losses, the output
    directory and the written file."""
    import numpy as np
    import torch

    from urgent2026_challenge_track1_tpu_torch.train.trainer import CheckpointIO
    from urgent2026_challenge_track1_tpu_torch.utils.checkpoint import TRAIN_FORMAT

    all_steps = CheckpointIO._steps(ckpt_dir) if os.path.isdir(ckpt_dir) else []
    if not all_steps:
        raise SystemExit(f"no checkpoints under {ckpt_dir}")
    metas = {}
    for s in all_steps:
        with open(CheckpointIO._path(ckpt_dir, s, "json"), encoding="utf-8") as f:
            metas[s] = json.load(f)
    if steps:
        chosen = sorted(int(s) for s in steps)
        missing = [s for s in chosen if s not in all_steps]
        if missing:
            raise SystemExit(f"steps {missing} not in {all_steps}")
    else:
        ranked = [s for s in all_steps if _rank_value(metas[s], by) is not None]
        if not ranked:
            raise SystemExit(f"no checkpoint under {ckpt_dir} stores metric {by!r}")
        reverse = "sisnr" in by  # losses rank ascending, SI-SNR-like metrics descending
        chosen = sorted(sorted(ranked, key=lambda s: _rank_value(metas[s], by),
                               reverse=reverse)[:top_k])

    # one checkpoint at a time into float64 running sums: never k states at once
    sums = {"params": None, "ema": None}
    dtypes = {}
    epoch = 0
    have_ema = True
    for s in chosen:
        state = torch.load(CheckpointIO._path(ckpt_dir, s, "pt"), map_location="cpu",
                           weights_only=True)
        epoch = max(epoch, int(state.get("epoch", 0)))
        for kind in ("params", "ema"):
            tree = state.get(kind)
            if tree is None:
                if kind == "ema":
                    have_ema = False
                continue
            dtypes.setdefault(kind, {k: v.dtype for k, v in tree.items()})
            acc = {k: v.to(torch.float64) for k, v in tree.items()}
            sums[kind] = acc if sums[kind] is None else {
                k: sums[kind][k] + v for k, v in acc.items()}
        del state

    k = float(len(chosen))
    config = metas[chosen[0]]["config"]
    payload = {"format": TRAIN_FORMAT, "config": config,
               "params": {n: (v / k).to(dtypes["params"][n]) for n, v in sums["params"].items()},
               "step": max(chosen), "epoch": epoch, "batch_in_epoch": 0}
    if have_ema and sums["ema"] is not None:
        payload["ema"] = {n: (v / k).to(dtypes["ema"][n]) for n, v in sums["ema"].items()}
    val_losses = [float(metas[s]["val_loss"]) for s in chosen]
    meta = {"step": max(chosen), "val_loss": float(np.mean(val_losses)),
            "metrics": {"val_loss": float(np.mean(val_losses))},
            "config": config, "averaged_steps": chosen, "averaged_val_losses": val_losses}
    io = CheckpointIO(output, save_top_k=1, save_last=False)
    for s in io.all_steps():  # the output holds one step
        io._remove(io.directory, s)
    io._write(io.directory, max(chosen), payload, meta)
    return {"steps": chosen, "val_losses": val_losses, "output": output,
            "path": CheckpointIO._path(io.directory, max(chosen), "pt")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt_dir", required=True,
                    help="the trainer's checkpoint directory (step_<N>.pt files)")
    ap.add_argument("--output", default=None,
                    help="output directory (default <ckpt_dir>_avg)")
    ap.add_argument("--top_k", type=int, default=3,
                    help="average the k best steps by --by")
    ap.add_argument("--by", default="val_loss",
                    help="ranking metric: val_loss (ascending) or a stored "
                         "checkpoint_metric like val_sisnr (descending)")
    ap.add_argument("--steps", type=int, nargs="*", default=None,
                    help="explicit steps to average (overrides --top_k)")
    args = ap.parse_args(argv)

    out = args.output or args.ckpt_dir.rstrip("/") + "_avg"
    info = average_checkpoints(args.ckpt_dir, out, args.top_k, args.steps, by=args.by)
    print(f"averaged steps {info['steps']} "
          f"(val_loss {['%.4f' % v for v in info['val_losses']]}) -> {info['path']}")
    return info


if __name__ == "__main__":
    main()
