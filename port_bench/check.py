"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``reference/``), computed after the window on the
same inputs and weights, in float32 with TF32 off.

Training cells compare the first three steps that set-up drove through
the window's own step (the mix's ``checked_rates``):

* ``loss_gap``: the largest |loss_prog - loss_ref| / |loss_ref| of the steps;
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap of the
  two norms over the larger of the reference leaf's norm and the median
  leaf's;
* ``change_gap``: the same gap for each leaf's change after the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (the others move by round-off alone), taken at the
  median leaf: the worst leaf's reads the sign flips of Adam's updates of
  near-zero gradient entries in a few small leaves (norm scales and
  biases), which swing from seed to seed;
* ``leaves_off``: how many of those leaves changed by less than half or
  more than 1.5 times the reference's change (a leaf left unmoved, or
  moved twice; rounding moves a leaf's change by 1e-3 of itself at most);
* ``ema_gap`` (flow): the same for the EMA's change (whose worst leaf reads
  the float32 rounding of a change 1e-3 of the step's on weights ~1e4
  times larger).

Enhancement cells compare the outputs of a sample of files:

* ``wave_gap``: the largest ||y_prog - y_ref|| / ||y_ref|| over the
  sampled files' valid samples, both peak-normalised to 0.9 as the CLI
  writes them.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from port_bench.reference import common as C
from port_bench.reference import train as RT


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def reference_train(family, mcfg: dict, params0: dict, steps: list, device,
                    prec: C.Precision, ema: bool) -> dict:
    """The reference's readings of ``steps`` [(fs, items)] from ``params0``."""
    p0 = {k: v.to(device) for k, v in params0.items()}
    params = {k: v.clone() for k, v in p0.items()}
    opt = RT.AdamW(params, mcfg["learning_rate"], mcfg["weight_decay"], mcfg["adam_epsilon"])
    shadow = {k: v.clone() for k, v in p0.items()} if ema else None
    out = {"losses": []}
    for s, (fs, items) in enumerate(steps):
        loss, grads = RT.step(family, params, mcfg, opt, items, fs, prec, shadow)
        out["losses"].append(loss)
        if s == 0:
            out["grad"] = {k: float(g.norm()) for k, g in grads.items() if RT.trainable(k)}
    out["change"] = {k: float((params[k] - p0[k]).norm()) for k in params if RT.trainable(k)}
    if ema:
        out["ema"] = {k: float((shadow[k] - p0[k]).norm()) for k in shadow if RT.trainable(k)}
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad"].values())
    moving = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    out = {"loss_gap": loss, "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
           "change_gap": statistics.median(leaf_gaps(prog["change"], ref["change"],
                                                     moving).values()),
           "leaves_off": sum(abs(prog["change"][k] - ref["change"][k]) > 0.5 * ref["change"][k]
                             for k in moving)}
    if "ema" in ref:
        out["ema_gap"] = statistics.median(leaf_gaps(prog["ema"], ref["ema"], moving).values())
    return out


def reference_enhance(family, mcfg: dict, params: dict, items: list, device,
                      prec: C.Precision) -> list[np.ndarray]:
    """Each item (``noisy`` host array, ``fs``, flow ``z``) enhanced by the
    reference and peak-normalised to 0.9, on the host."""
    p = {k: v.to(device) for k, v in params.items()}
    out = []
    with torch.no_grad(), prec.flags():
        for it in items:
            x = {"noisy": torch.from_numpy(it["noisy"]).to(device)}
            if it.get("z") is not None:
                x["z"] = it["z"].to(device)
            y = family.enhance_item(p, mcfg, x, it["fs"], prec).cpu().numpy()
            out.append(y / (np.abs(y).max() or 1.0) * 0.9)
    return out


def enhance_numbers(prog: list, ref: list) -> dict:
    gaps = [float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            for a, b in zip(prog, ref)]
    return {"wave_gap": max(gaps)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number within its limit (a number above it, or not finite,
    fails); returns (correct, {name: {value, limit}})."""
    shown = {k: {"value": float(v), "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and limits.get(k) is not None and v <= limits[k]
             for k, v in numbers.items())
    return ok, shown
