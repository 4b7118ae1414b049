"""Named host spans at the port's layer boundaries.

``span(NAME)`` is a context manager: while tracing is off (the default) it
is one shared no-op object, so a span costs one function call; while it is
on (``with on():``) it is a ``torch.profiler.record_function`` range, so
under ``torch.profiler`` the spans land in the same trace as the card's
kernels, on one clock.  ``spanned(NAME)`` decorates a function whose whole
body is one span; off, it costs the one call of its wrapper.  The switch is process-wide, not per thread: the
backward pass (and remat's recompute) runs on autograd's own thread.

Names are ``<layer>.<phase>``: ``entry.*`` and ``train.*`` (the CLI and the
trainer), ``model.*`` and ``flow.*`` (the model step), ``lstm.op`` (the
recurrence op).
"""

from __future__ import annotations

import contextlib
import functools

import torch

ENTRY_PAD, ENTRY_H2D, ENTRY_D2H, ENTRY_NORMALIZE = (
    "entry.pad", "entry.h2d", "entry.d2h", "entry.normalize")
TRAIN_DATA_WAIT, TRAIN_H2D, TRAIN_RENDER = "train.data_wait", "train.h2d", "train.render"
TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_GRAD_NORM = (
    "train.forward", "train.backward", "train.grad_norm")
TRAIN_CLIP, TRAIN_ADAMW, TRAIN_EMA = "train.clip", "train.adamw", "train.ema"
MODEL_FORWARD, MODEL_STFT, MODEL_ISTFT = "model.forward", "model.stft", "model.istft"
MODEL_BAND_SPLIT, MODEL_LAYER, MODEL_DECODER, MODEL_LOSS = (
    "model.band_split", "model.layer", "model.decoder", "model.loss")
FLOW_PRIOR, FLOW_STEP = "flow.prior", "flow.step"
LSTM_OP = "lstm.op"

_OFF = contextlib.nullcontext()
_on = False


def span(name: str):
    """A range named ``name`` while tracing is on; else a shared no-op."""
    return torch.profiler.record_function(name) if _on else _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def on():
    """Tracing on for the block (and as it was after it)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was
