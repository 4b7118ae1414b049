"""Enhancement closures shared by the inference CLI (counterpart of
``serving.make_enhance_fn``).

PyTorch runs eagerly, so there is no per-(fs, bucket) program to compile:
the closure calls the model under ``torch.inference_mode()``.  The dynamic
batching engine of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from urgent2026_challenge_track1_tpu_torch.models import bsrnn as bsrnn_mod
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as flow_mod

__all__ = ["make_enhance_fn"]


def make_enhance_fn(kind: str, model: nn.Module, model_cfg, stft_cfg, nfe: int = 15,
                    solver: str = "euler") -> Callable:
    """``enhance(wav, fs, lengths) -> wav`` for a (B, T) float32 tensor on the
    model's device; ``lengths`` (B,) makes the padding numerically exact.
    A flow model (``kind == "flowse"``, ``model_cfg`` its ``FlowSEConfig``)
    samples with ``nfe`` steps of ``solver``, its priors drawn from one
    generator on the model's device, seeded with 0 (the key the JAX CLI
    starts from)."""
    if kind == "discriminative":
        @torch.inference_mode()
        def enhance(wav: torch.Tensor, fs: int,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
            out, _ = bsrnn_mod.bsrnn_se_apply(model, stft_cfg, wav, fs, lengths=lengths)
            return out

        return enhance
    if kind != "flowse":
        raise ValueError(f"model kind {kind!r}: expected discriminative or flowse")
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(0)

    @torch.inference_mode()
    def enhance_flow(wav: torch.Tensor, fs: int,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return flow_mod.flowse_enhance(model, model_cfg, wav, fs, N=nfe, solver=solver,
                                       lengths=lengths, generator=generator)

    return enhance_flow
