"""Real-time stateful streaming enhancement for the causal BSRNN (counterpart
of ``models/streaming_causal.py``).

  * ``BSRNNConfig(causal=True, streaming_norm=True)``: every norm that spans
    time is cumulative (``ops/norms.cumulative_group_norm``) and the time
    LSTM runs forward only, so the whole network is causal with bounded
    state;
  * ``make_streaming_step``: one step function per (config, fs, chunk):
    it consumes ``chunk_frames * hop`` new samples, carries the STFT input
    tail, every norm's running sums, every time LSTM's (h, c) (K2 with its
    carry on the card) and the iSTFT overlap-add tail (signal and window
    envelope), and emits ``chunk_frames * hop`` final output samples;
  * ``StreamingSession``: the host side: the center reflect pad at the
    start and end of the stream, feeds of any size, an exact-length flush.

Chained chunks reproduce the offline ``bsrnn_se_apply`` of the same model
up to float reassociation (``tests/test_torch_streaming_causal.py``).
PyTorch runs eagerly, so there is no program to compile or cache: the step
is a plain function on tensors on the model's device, and the state stays
there between steps.  Algorithmic latency = ``chunk_frames * hop + n_fft //
2`` samples plus the step's time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch.dsp import stft as dsp
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as B

__all__ = ["init_model_states", "make_streaming_step", "StreamingSession"]


def init_model_states(model: B.BSRNN, cfg: B.BSRNNConfig, batch: int, n_bands: int):
    """Zero streaming carry for ``bsrnn_apply(..., states=...)``, on the
    model's device.

    Norm states are ``(count, s1, s2)`` running sums shaped like each norm's
    per-frame statistics (time axis kept at 1), stacked over the layers for
    the dual-path norms; the time-LSTM carry is ``(h, c)`` for the ``batch *
    n_bands`` band rows, h in the compute dtype and c float32."""
    device = next(model.parameters()).device
    n_layers = len(model.layers)
    hidden = model.layers[0].rnn_time["w_hh"].shape[-1]

    def z3(shape):
        return tuple(torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3))

    per_batch = (n_layers, batch, 1, 1, 1)
    per_band = (batch, 1, n_bands, 1)
    lstm_shape = (n_layers, batch * n_bands, hidden)
    return {
        "band_split": z3(per_band),
        "layers": {
            "norm_time": z3(per_batch),
            "rnn_time": (torch.zeros(lstm_shape, dtype=cfg.dtype, device=device),
                         torch.zeros(lstm_shape, dtype=torch.float32, device=device)),
            "norm_freq": z3(per_batch),
        },
        "mask": z3(per_band),
        "residual": z3(per_band),
    }


def make_streaming_step(cfg: B.BSRNNConfig, stft_cfg: dsp.STFTConfig, fs: int,
                        chunk_frames: int = 8):
    """(step, n_fft, hop, n_bands); ``step(model, state, chunk, n_valid)``
    takes the next (B, chunk_frames * hop) samples as a tensor on the
    model's device and the count of valid frames in this step
    (``chunk_frames`` mid-stream, fewer on the final and drain steps), and
    returns (new_state, emitted (B, chunk_frames * hop)); emitted samples
    are final."""
    if not (cfg.causal and cfg.streaming_norm):
        raise ValueError("streaming requires BSRNNConfig(causal=True, streaming_norm=True)")
    n_fft, win, hop = stft_cfg.geometry(fs)
    n_bins = stft_cfg.n_bins(fs)
    n_bands = B.band_count(cfg.input_dim, cfg.target_fs, fs, n_bins)
    C = int(chunk_frames)
    tail = n_fft - hop

    @torch.inference_mode()
    def step(model, state, chunk: torch.Tensor, n_valid: int):
        window = dsp._padded_window(n_fft, win, chunk.device)
        buf = torch.cat([state["in_tail"], chunk], dim=-1)
        frames = buf.unfold(-1, n_fft, hop) * window  # (B, C, n_fft)
        spec = dsp.spec_transform(torch.fft.rfft(frames, dim=-1), stft_cfg)
        enh, mstates = model(spec, fs, states=state["model"])
        enh = dsp.spec_inverse_transform(enh, stft_cfg)
        fmask = (torch.arange(C, device=chunk.device) < n_valid).to(torch.float32)
        td = torch.fft.irfft(enh, n=n_fft, dim=-1) * window * fmask[None, :, None]
        full = dsp._ola(td, n_fft, hop)  # (B, (C - 1) hop + n_fft)
        env_f = dsp._ola(window.square()[None, :] * fmask[:, None], n_fft, hop)
        full = torch.cat([full[:, :tail] + state["ola"], full[:, tail:]], dim=-1)
        env_f = torch.cat([env_f[:tail] + state["env"], env_f[tail:]])
        emit = full[:, :C * hop] / torch.clamp(env_f[:C * hop], min=1e-11)
        new_state = {"model": mstates, "in_tail": buf[:, C * hop:], "ola": full[:, C * hop:],
                     "env": env_f[C * hop:]}
        return new_state, emit

    return step, n_fft, hop, n_bands


class StreamingSession:
    """Stateful chunk-in / chunk-out enhancement of an unbounded stream.

    ``feed(samples)`` accepts any number of new samples (B, n) and returns
    the output samples that became final; ``flush()`` returns the rest, so
    that ``concat(feeds..., flush)`` has exactly the fed length and equals
    the offline ``bsrnn_se_apply`` of the whole signal (same causal
    ``streaming_norm`` model).  The stream must be longer than ``n_fft //
    2`` samples (the reflect center pad, as in torch.stft)."""

    def __init__(self, model: B.BSRNN, cfg: B.BSRNNConfig, stft_cfg: dsp.STFTConfig,
                 fs: int, batch: int = 1, chunk_frames: int = 8):
        self.model = model
        self.cfg = cfg
        self.fs = fs
        self.batch = batch
        self.device = next(model.parameters()).device
        self._step, self.n_fft, self.hop, self._n_bands = make_streaming_step(
            cfg, stft_cfg, fs, int(chunk_frames))
        self.chunk_frames = int(chunk_frames)
        self.pad = self.n_fft // 2
        self._chunk = self.chunk_frames * self.hop
        self._in_tail_len = self.n_fft - self.hop
        # host buffers
        self._pending = np.zeros((batch, 0), np.float32)  # xp not yet consumed
        self._head: Optional[np.ndarray] = np.zeros((batch, 0), np.float32)
        self._recent = np.zeros((batch, 0), np.float32)  # last pad+1 raw samples
        self._fed = 0
        self._frames_done = 0
        self._emit_pos = 0  # OLA positions emitted so far
        self._delivered = 0  # output samples handed to the caller
        self._state = None
        self._flushed = False

    @property
    def latency_samples(self) -> int:
        """Algorithmic latency: samples that must arrive before the first
        output sample can be emitted."""
        return self._chunk + self.pad

    def _device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _append_pending(self, xp: np.ndarray) -> None:
        self._pending = np.concatenate([self._pending, xp], axis=-1)

    def _prime(self) -> bool:
        """Seed the device state once the STFT left context is available."""
        if self._state is not None:
            return True
        if self._pending.shape[-1] < self._in_tail_len:
            return False
        self._state = {
            "model": init_model_states(self.model, self.cfg, self.batch, self._n_bands),
            "in_tail": self._device(self._pending[:, :self._in_tail_len]),
            "ola": torch.zeros((self.batch, self._in_tail_len), device=self.device),
            "env": torch.zeros((self._in_tail_len,), device=self.device),
        }
        self._pending = self._pending[:, self._in_tail_len:]
        return True

    def _run_steps(self, n_valid_fn, drain_until: Optional[int] = None):
        """Consume full chunks from ``_pending``; optionally keep running
        zero-input drain steps until ``_emit_pos >= drain_until``."""
        outs = []
        while True:
            # prime first: it consumes n_fft - hop samples of _pending, so
            # whether a chunk is there is judged on what remains
            if not self._prime():
                break
            have = self._pending.shape[-1] >= self._chunk
            draining = drain_until is not None and self._emit_pos < drain_until
            if have:
                chunk = self._pending[:, :self._chunk]
                self._pending = self._pending[:, self._chunk:]
            elif draining:
                chunk = np.zeros((self.batch, self._chunk), np.float32)
                if self._pending.shape[-1]:
                    chunk[:, :self._pending.shape[-1]] = self._pending
                    self._pending = self._pending[:, :0]
            else:
                break
            n_valid = n_valid_fn(self._frames_done)
            self._state, emit = self._step(self.model, self._state, self._device(chunk),
                                           n_valid)
            self._frames_done += n_valid
            outs.append(emit.float().cpu().numpy())
            self._emit_pos += self._chunk
            if drain_until is not None and self._emit_pos >= drain_until \
                    and self._pending.shape[-1] < self._chunk:
                break
        if not outs:
            return np.zeros((self.batch, 0), np.float32)
        return np.concatenate(outs, axis=-1)

    def _deliverable(self, emitted: np.ndarray, limit: int) -> np.ndarray:
        """Map emitted OLA positions to output samples [pad, pad + T)."""
        start_pos = self._emit_pos - emitted.shape[-1]
        lo = max(self.pad + self._delivered, start_pos)
        hi = min(limit, self._emit_pos)
        if hi <= lo:
            return np.zeros((self.batch, 0), np.float32)
        out = emitted[:, lo - start_pos:hi - start_pos]
        self._delivered += out.shape[-1]
        return out

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Push new samples; returns finalized output samples (maybe none)."""
        if self._flushed:
            raise RuntimeError("session already flushed")
        samples = np.atleast_2d(np.asarray(samples, np.float32))
        if samples.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {samples.shape}")
        self._fed += samples.shape[-1]
        keep = self.pad + 1
        self._recent = np.concatenate([self._recent, samples], axis=-1)[:, -keep:]
        if self._head is not None:
            # accumulate until the reflect prefix xp[i] = x[pad - i] exists
            self._head = np.concatenate([self._head, samples], axis=-1)
            if self._head.shape[-1] <= self.pad:
                return np.zeros((self.batch, 0), np.float32)
            prefix = self._head[:, self.pad:0:-1]
            self._append_pending(np.concatenate([prefix, self._head], axis=-1))
            self._head = None
        else:
            self._append_pending(samples)
        emitted = self._run_steps(lambda done: self.chunk_frames)
        # mid-stream every processed frame is valid; cap at what is final
        return self._deliverable(emitted, self.pad + self._fed)

    def flush(self) -> np.ndarray:
        """End of stream: returns the remaining output samples."""
        if self._flushed:
            raise RuntimeError("session already flushed")
        self._flushed = True
        T = self._fed
        if T <= self.pad:
            raise ValueError(f"stream too short: need more than {self.pad} samples, got {T}")
        if self._head is not None:
            prefix = self._head[:, self.pad:0:-1]
            self._append_pending(np.concatenate([prefix, self._head], axis=-1))
            self._head = None
        # reflect suffix: xp[pad + T + j] = x[T - 2 - j]; _recent holds the
        # last pad + 1 raw samples, so x[T - 2 - j] = _recent[pad - 1 - j]
        suffix = self._recent[:, self.pad - 1::-1] if self.pad else \
            np.zeros((self.batch, 0), np.float32)
        self._append_pending(suffix)
        total_frames = dsp.num_frames(T, self.n_fft, self.hop, center=True)
        out_end = self.pad + T

        def n_valid(done: int) -> int:
            return max(0, min(self.chunk_frames, total_frames - done))

        emitted = self._run_steps(n_valid, drain_until=out_end)
        return self._deliverable(emitted, out_end)

    def process(self, wav: np.ndarray, feed_size: Optional[int] = None) -> np.ndarray:
        """Stream ``wav`` through in ``feed_size``-sample feeds (default: one
        chunk) and return the whole enhanced signal."""
        wav = np.atleast_2d(np.asarray(wav, np.float32))
        feed_size = int(feed_size or self._chunk)
        outs = []
        for i in range(0, wav.shape[-1], feed_size):
            outs.append(self.feed(wav[:, i:i + feed_size]))
        outs.append(self.flush())
        return np.concatenate(outs, axis=-1)
