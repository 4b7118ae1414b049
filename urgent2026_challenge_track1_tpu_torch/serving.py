"""Serving: the enhancement closures of the inference CLI and the dynamic
(fs, length-bucket) batching engine (counterpart of ``serving.py``).

``BatchingEngine`` accepts single utterances from many threads (the HTTP
handlers of ``serve.py``), groups them by (fs, bucket) and flushes a group
when ``max_batch`` requests wait or the oldest has waited ``max_wait_ms``.
A batch is padded to the next power of two with filler rows that carry the
full bucket length (a zero length would zero the norm denominators), runs
as one call of the enhance closure on the model's device, and each
utterance is cut back to its length before the 0.9 peak normalization of
``inference.py``.  Inputs longer than ``chunk_seconds`` go one at a time
through the fixed-shape overlap-add streamer (``models/streaming.py``).

PyTorch runs eagerly, so there is no per-(fs, bucket) program to compile:
the closures call the model under ``torch.inference_mode()``.

``make_sharded_serving_fn`` serves over a dp x mp mesh of processes
(``serve.py --mesh`` under ``torchrun``): global rank 0 runs the engine and
broadcasts each batch; every other rank runs the same enhancement on its
share in ``run_worker()``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.models import bsrnn as bsrnn_mod
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as flow_mod

__all__ = ["BatchingEngine", "MeshFault", "make_enhance_fn", "make_sharded_serving_fn"]


def make_enhance_fn(kind: str, model: nn.Module, model_cfg, stft_cfg, nfe: int = 15,
                    solver: str = "euler") -> Callable:
    """``enhance(wav, fs, lengths=None, generator=None) -> wav`` for a (B, T)
    float32 tensor on the model's device; ``lengths`` (B,) makes the padding
    numerically exact.  A flow model (``kind == "flowse"``, ``model_cfg``
    its ``FlowSEConfig``) samples with ``nfe`` steps of ``solver``, its
    priors drawn from ``generator``, or from the closure's own generator on
    the model's device, seeded with 0 (the key the JAX CLI starts from).
    The discriminative model ignores ``generator``.  The closure's
    ``device`` attribute is the model's device, where the engine sends its
    batches."""
    device = next(model.parameters()).device
    if kind == "discriminative":
        @torch.inference_mode()
        def enhance(wav: torch.Tensor, fs: int, lengths: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
            out, _ = bsrnn_mod.bsrnn_se_apply(model, stft_cfg, wav, fs, lengths=lengths)
            return out

        enhance.device = device
        return enhance
    if kind != "flowse":
        raise ValueError(f"model kind {kind!r}: expected discriminative or flowse")
    own = torch.Generator(device=device).manual_seed(0)

    @torch.inference_mode()
    def enhance_flow(wav: torch.Tensor, fs: int, lengths: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return flow_mod.flowse_enhance(model, model_cfg, wav, fs, N=nfe, solver=solver,
                                       lengths=lengths, generator=generator or own)

    enhance_flow.device = device
    return enhance_flow


_STOP, _BATCH = 0, 1


class MeshFault(RuntimeError):
    """A sharded batch failed on rank 0 after its broadcast.  The other
    ranks may still wait inside that batch's collectives, where no later
    broadcast can meet them, so the mesh serves no more batches: the
    engine does not retry it, and the process should exit, which makes
    ``torchrun`` stop the other ranks."""


def make_sharded_serving_fn(kind: str, model: nn.Module, model_cfg, stft_cfg, mesh,
                            nfe: int = 15, solver: str = "euler",
                            on_fault: Optional[Callable[[BaseException], None]] = None
                            ) -> Callable:
    """``make_enhance_fn``'s ``enhance(wav, fs, lengths=None, generator=None)``
    over ``mesh`` (``parallel/mesh.py``), for global rank 0, whose engine
    calls it.  Each call broadcasts (fs, the batch, its lengths and, for a
    flow model, the generator's state: the seed of the batch's prior) to
    every rank, pads the rows to a dp multiple with full-length filler rows,
    runs ``parallel.model_parallel``'s sharded enhancement there (the rows
    over dp, the recurrence rows over mp) and cuts the padding off.  A flow
    batch's prior is drawn for the padded batch from that state on every
    rank, each keeping its rows, so the result equals ``make_enhance_fn``'s
    on the padded batch with the same generator.  Every other rank calls
    ``enhance.run_worker()``, which serves the broadcasts until rank 0 calls
    ``enhance.close()``.  Programs are built once per fs.

    A failure on rank 0 from the broadcast on leaves the ranks out of step:
    that call, and every later one, raises ``MeshFault`` without another
    broadcast, ``close()`` sends nothing, ``enhance.fault`` holds the
    first error and ``on_fault(error)`` is called once (``serve.py`` stops
    its server and exits).  A failure on another rank ends its
    ``run_worker()`` with the error."""
    from urgent2026_challenge_track1_tpu_torch.parallel import model_parallel as mpar
    from urgent2026_challenge_track1_tpu_torch.parallel.mesh import broadcast_batch

    if kind not in ("discriminative", "flowse"):
        raise ValueError(f"model kind {kind!r}: expected discriminative or flowse")
    device = mesh.device
    flow = kind == "flowse"
    programs: dict = {}
    own = torch.Generator(device=device).manual_seed(0)

    def run(wav: torch.Tensor, fs: int, lengths: torch.Tensor, generator) -> torch.Tensor:
        if fs not in programs:
            programs[fs] = (
                mpar.make_sharded_flow_enhance(mesh, model, model_cfg, fs, N=nfe, solver=solver,
                                               lengths=True) if flow
                else mpar.make_sharded_enhance(mesh, model, stft_cfg, fs, lengths=True))
        B, L = wav.shape
        pad = -(-B // mesh.dp) * mesh.dp - B
        if pad:
            wav = torch.cat([wav, wav.new_zeros((pad, L))])
            lengths = torch.cat([lengths, lengths.new_full((pad,), L)])
        out = (programs[fs](wav, lengths, generator=generator) if flow
               else programs[fs](wav, lengths))
        return out[:B]

    def send(header, *tensors):
        if mesh.world_size > 1:
            broadcast_batch(torch.tensor(header, dtype=torch.int64, device=device),
                            *(t for t in tensors if t.numel()))

    @torch.inference_mode()
    def enhance(wav: torch.Tensor, fs: int, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fs = int(fs)
        wav = wav.to(device, torch.float32).contiguous()
        if lengths is None:
            lengths = torch.full((wav.shape[0],), wav.shape[1], dtype=torch.int32)
        lengths = lengths.to(device, torch.int32).contiguous()
        generator = generator or own
        state = (generator.get_state() if flow else torch.zeros(0, dtype=torch.uint8)).to(device)
        if enhance.fault is not None:
            raise MeshFault("an earlier sharded batch failed; the mesh serves no more "
                            "batches") from enhance.fault
        try:
            send([_BATCH, fs, *wav.shape, state.numel()], wav, lengths, state)
            return run(wav, fs, lengths, generator)
        except Exception as e:
            enhance.fault = e
            if on_fault is not None:
                on_fault(e)
            raise MeshFault("a sharded batch failed on rank 0 after its broadcast; the "
                            "other ranks may wait in its collectives") from e

    @torch.inference_mode()
    def run_worker() -> None:
        while True:
            header = torch.zeros(5, dtype=torch.int64, device=device)
            broadcast_batch(header)
            op, fs, B, L, n_state = header.tolist()
            if op == _STOP:
                return
            wav = torch.empty((B, L), dtype=torch.float32, device=device)
            lengths = torch.empty((B,), dtype=torch.int32, device=device)
            state = torch.empty((n_state,), dtype=torch.uint8, device=device)
            broadcast_batch(wav, lengths, *([state] if n_state else []))
            generator = None
            if flow:
                generator = torch.Generator(device=device)
                generator.set_state(state.cpu())
            run(wav, fs, lengths, generator)

    def close() -> None:
        if enhance.fault is None:
            send([_STOP, 0, 0, 0, 0])

    enhance.device = device
    enhance.fault = None
    enhance.run_worker = run_worker
    enhance.close = close
    return enhance


class _Request:
    __slots__ = ("wav", "fs", "future", "t_submit")

    def __init__(self, wav: np.ndarray, fs: int):
        self.wav = wav
        self.fs = fs
        self.future: Future = Future()
        self.t_submit = time.monotonic()


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class BatchingEngine:
    """Groups enhancement requests into device batches.

    enhance:        ``(wav (B, T) f32, fs, lengths (B,) int32, generator=)
                    -> (B, T)`` on ``enhance.device``, the model's device,
                    where batches run (see :func:`make_enhance_fn`).
    max_batch:      flush a (fs, bucket) group as soon as this many requests
                    wait; also the padded batch-size cap.
    max_wait_ms:    flush a group once its oldest request has waited this
                    long, whatever the occupancy (tail-latency bound).
    bucket_seconds: length quantum: requests are padded up to its next
                    multiple.
    chunk_seconds:  longer inputs stream through fixed-shape overlap-add
                    chunks instead of joining a batch.
    normalize:      the CLI's 0.9 peak normalization of each output.
    max_retries:    re-dispatch a failed batch this many times before
                    failing its requests (0: a kernel fault fails at once;
                    a ``MeshFault`` is never retried).
    seed:           the seed of the one ``torch.Generator`` on
                    ``enhance.device`` that every flow request draws its
                    prior from.
    autostart:      start the background dispatch thread (tests drive
                    :meth:`step` by hand with ``autostart=False``).
    """

    def __init__(self, enhance: Callable, *, max_batch: int = 8,
                 max_wait_ms: float = 25.0, bucket_seconds: float = 1.0,
                 chunk_seconds: float = 30.0, normalize: bool = True,
                 max_retries: int = 1, seed: int = 0,
                 autostart: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._enhance = enhance
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.bucket_seconds = float(bucket_seconds)
        self.chunk_seconds = float(chunk_seconds)
        self.normalize = bool(normalize)
        self.max_retries = int(max_retries)
        self.device = resolve_device(enhance.device)
        self._seed = seed
        self._generator: Optional[torch.Generator] = None  # made at the first dispatch
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (fs, bucket) -> deque[_Request]; ordered, so tests see a fixed order
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._long: deque = deque()
        self._closed = False
        self._stats = {
            "requests": 0, "batches": 0, "batched_requests": 0,
            "long_form": 0, "errors": 0, "retries": 0, "wait_s_sum": 0.0,
        }
        self._dispatch_started: Optional[float] = None  # wedge watchdog
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self._worker = threading.Thread(target=self._run, name="batching-engine",
                                            daemon=True)
            self._worker.start()

    # -- client API ----------------------------------------------------

    def submit(self, wav: np.ndarray, fs: int) -> Future:
        """Enqueue one mono utterance; the Future resolves to the enhanced
        float32 waveform at the input's exact length."""
        wav = np.asarray(wav)
        if wav.ndim not in (1, 2) or (wav.ndim == 2 and wav.shape[1] < 1):
            raise ValueError(f"audio must be (T,) or (T, C), got {wav.shape}")
        if wav.ndim == 2:  # (T, C) -> the first channel, as inference.py does
            wav = wav[:, 0]
        wav = wav.astype(np.float32)
        if wav.shape[0] == 0:
            raise ValueError("empty audio")
        fs = int(fs)
        if fs <= 0:
            raise ValueError(f"sampling rate must be positive, got {fs}")
        req = _Request(wav, fs)
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._stats["requests"] += 1
            if wav.shape[0] > self.chunk_seconds * fs:
                self._stats["long_form"] += 1
                self._long.append(req)
            else:
                bucket = self._bucket(wav.shape[0], fs)
                self._queues.setdefault((fs, bucket), deque()).append(req)
            self._cv.notify()
        return req.future

    def enhance_sync(self, wav: np.ndarray, fs: int,
                     timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(wav, fs).result(timeout=timeout)

    def snapshot(self) -> dict:
        """Counts, mean occupancy and wait for monitoring endpoints;
        ``dispatch_in_flight_s`` grows while one dispatch is stuck."""
        with self._lock:
            s = dict(self._stats)
            s["pending"] = sum(len(q) for q in self._queues.values()) + len(self._long)
            s["dispatch_in_flight_s"] = (
                0.0 if self._dispatch_started is None
                else time.monotonic() - self._dispatch_started)
        b = max(s["batches"], 1)
        s["mean_batch_occupancy"] = s["batched_requests"] / b
        s["mean_wait_ms"] = 1e3 * s["wait_s_sum"] / max(s["requests"], 1)
        del s["wait_s_sum"]
        return s

    def reset_stats(self):
        """Zero the counters (e.g. after warmup, before a measured window)."""
        with self._lock:
            for k in self._stats:
                self._stats[k] = type(self._stats[k])()

    def close(self, timeout: float = 30.0):
        """Drain pending requests, then stop the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch internals ---------------------------------------------

    def _bucket(self, n: int, fs: int) -> int:
        q = max(int(self.bucket_seconds * fs), 1)
        return -(-n // q) * q

    def step(self, force: bool = True) -> int:
        """Pick and dispatch one batch synchronously; returns the number of
        requests served (0 if nothing is eligible).  ``force=True`` ignores
        the max-wait timer."""
        with self._lock:
            batch = self._pick_locked(time.monotonic(), force=force)
        if not batch:
            return 0
        self._dispatch(batch)
        return len(batch)

    def _pick_locked(self, now: float, force: bool):
        """Pop the most urgent dispatchable group (the caller holds the
        lock): FIFO by head age across the long-form queue and the batch
        groups, so neither starves the other past max_wait."""
        long_t = self._long[0].t_submit if self._long else None
        # a full group flushes at once unless an older long-form request is
        # ahead of it
        for key, q in self._queues.items():
            if len(q) >= self.max_batch and (long_t is None or q[0].t_submit <= long_t):
                return self._pop_locked(key)
        oldest_key, oldest_t = None, None
        for key, q in self._queues.items():
            if q and (oldest_t is None or q[0].t_submit < oldest_t):
                oldest_key, oldest_t = key, q[0].t_submit
        if long_t is not None and (oldest_t is None or long_t <= oldest_t):
            return [self._long.popleft()]
        if oldest_key is None:
            return None
        if force or now - oldest_t >= self.max_wait:
            return self._pop_locked(oldest_key)
        return None

    def _pop_locked(self, key):
        q = self._queues[key]
        out = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        if not q:
            del self._queues[key]
        return out

    def _run(self):
        while True:
            with self._cv:
                while True:
                    now = time.monotonic()
                    batch = self._pick_locked(now, force=self._closed)
                    if batch is not None:
                        break
                    if self._closed:
                        return
                    # sleep until the oldest head is due (or a submit/close)
                    timeout = None
                    for q in self._queues.values():
                        if q:
                            due = q[0].t_submit + self.max_wait - now
                            timeout = due if timeout is None else min(timeout, due)
                    self._cv.wait(timeout=max(timeout, 1e-3) if timeout is not None else None)
            self._dispatch(batch)

    def _finalize(self, req: _Request, y: np.ndarray):
        y = np.asarray(y, np.float32)[:req.wav.shape[0]]
        if self.normalize:
            y = y / (np.abs(y).max() or 1.0) * 0.9
        with self._lock:
            self._stats["wait_s_sum"] += time.monotonic() - req.t_submit
        req.future.set_result(y)

    def _call(self, x: np.ndarray, fs: int, lengths: Optional[np.ndarray]) -> np.ndarray:
        """One call of the enhance closure on the engine's device."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device).manual_seed(self._seed)
        lens = None if lengths is None else torch.from_numpy(lengths).to(self.device)
        out = self._enhance(torch.from_numpy(x).to(self.device), fs, lens,
                            generator=self._generator)
        return out.float().cpu().numpy()

    def _compute(self, batch) -> list:
        """The device work of one batch: one waveform per request (raises on
        a device failure, which :meth:`_dispatch_inner` may retry)."""
        fs = batch[0].fs
        if len(batch) == 1 and batch[0].wav.shape[0] > self.chunk_seconds * fs:
            from urgent2026_challenge_track1_tpu_torch.models.streaming import enhance_streaming

            return [enhance_streaming(
                lambda x, n: self._call(x, fs, None if n == x.shape[1]
                                        else np.asarray([n], np.int32)),
                batch[0].wav, fs, chunk_seconds=self.chunk_seconds)]
        bucket = self._bucket(max(r.wav.shape[0] for r in batch), fs)
        B = _next_pow2(len(batch))
        x = np.zeros((B, bucket), np.float32)
        # filler rows keep full-bucket lengths: zero audio is harmless, a zero
        # length would zero the norm denominators
        lens = np.full((B,), bucket, np.int32)
        for j, r in enumerate(batch):
            x[j, :r.wav.shape[0]] = r.wav
            lens[j] = r.wav.shape[0]
        out = self._call(x, fs, lens)
        return [out[j] for j in range(len(batch))]

    def _dispatch(self, batch):
        # claim each future: a cancelled request is dropped here, and a
        # RUNNING future can no longer be cancelled, so set_result is safe
        batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        with self._lock:
            self._dispatch_started = time.monotonic()
        try:
            self._dispatch_inner(batch)
        finally:
            with self._lock:
                self._dispatch_started = None

    def _dispatch_inner(self, batch):
        for attempt in range(self.max_retries + 1):
            try:
                outs = self._compute(batch)
                break
            except Exception as e:
                # a MeshFault leaves the mesh's ranks out of step: no retry
                if attempt < self.max_retries and not isinstance(e, MeshFault):
                    with self._lock:
                        self._stats["retries"] += 1
                    continue
                with self._lock:  # the failure reaches every waiter
                    self._stats["errors"] += len(batch)
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                return
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_requests"] += len(batch)
        for r, y in zip(batch, outs):
            self._finalize(r, y)
