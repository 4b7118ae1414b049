"""The reference's optimizer step: every gradient clipped by their global
norm (optax ``clip_by_global_norm``: scaled when the norm reaches the
limit), then AdamW (decoupled weight decay, bias-corrected moments) on
every parameter but the flow model's frozen Fourier projection, then
(flow) the EMA.  The loss of a batch is the mean of its utterances'
losses; a non-finite gradient skips the update, as the baseline's NaN
guard does."""

from __future__ import annotations

import math

import torch

FROZEN_SUFFIX = "t_proj_w"  # the Fourier projection: a buffer in the baseline


def trainable(name: str) -> bool:
    return not name.endswith(FROZEN_SUFFIX)


class AdamW:
    def __init__(self, params: dict, lr: float, weight_decay: float, eps: float,
                 betas=(0.9, 0.999)):
        self.lr, self.wd, self.eps, self.betas = lr, weight_decay, eps, betas
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items() if trainable(k)}
        self.v = {k: torch.zeros_like(v) for k, v in params.items() if trainable(k)}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k in self.m:
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p = params[k]
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def clip(grads: dict, max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                  for g in grads.values()]))
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)


def step(family, params: dict, cfg: dict, opt: AdamW, items: list, fs: int, prec,
         ema: dict | None = None) -> tuple[float, dict]:
    """One step on ``items`` (utterances at exact length); returns the
    batch loss and the clipped gradients."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total = 0.0
    with prec.flags():
        for item in items:
            loss = family.item_loss(leaves, cfg, item, fs, prec) / len(items)
            if not torch.isfinite(loss):
                loss = loss * 0.0  # the baseline's NaN-loss skip, per utterance
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for (k, _), g in zip(leaves.items(), got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
    if all(bool(torch.isfinite(g).all()) for g in grads.values()):
        clip(grads, cfg["gradient_clip"])
        opt.step(params, grads)
    if ema is not None:
        d = cfg["ema_decay"]
        with torch.no_grad():
            for k in ema:
                ema[k].mul_(d).add_(params[k], alpha=1 - d)
    return total if math.isfinite(total) else 0.0, grads
