"""Enhancement closures shared by the inference CLI (counterpart of the
discriminative branch of ``serving.make_enhance_fn``).

PyTorch runs eagerly, so there is no per-(fs, bucket) program to compile:
the closure calls the model under ``torch.inference_mode()``.  The dynamic
batching engine of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from urgent2026_challenge_track1_tpu_torch.models import bsrnn as bsrnn_mod

__all__ = ["make_enhance_fn"]


def make_enhance_fn(kind: str, model: bsrnn_mod.BSRNN, stft_cfg) -> Callable:
    """``enhance(wav, fs, lengths) -> wav`` for a (B, T) float32 tensor on the
    model's device; ``lengths`` (B,) makes the padding numerically exact."""
    if kind != "discriminative":
        raise NotImplementedError(f"model kind {kind!r} is not ported yet")

    @torch.inference_mode()
    def enhance(wav: torch.Tensor, fs: int,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        out, _ = bsrnn_mod.bsrnn_se_apply(model, stft_cfg, wav, fs, lengths=lengths)
        return out

    return enhance
