"""PyTorch + CUDA port of the BSRNN speech-enhancement stack for one NVIDIA H100.

Module names mirror ``urgent2026_challenge_track1_tpu`` so each module's
counterpart is easy to find.  The package imports torch and numpy only; the
LSTM recurrences run on hand-written Hopper kernels (``csrc/``) when their
tensors are on the card and on plain PyTorch versions when they are on the
CPU.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default) or an explicit ``"cpu"``; anything else, or
    ``"cuda"`` on a machine without a card, raises."""
    # torch is imported here, not with the package: the data loader's
    # spawned workers import the package's data modules without torch
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
