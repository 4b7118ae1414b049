"""The pre-simulated and dynamic-mixing datasets, fs-grouped length-bucketed
batching and a prefetching loader (counterpart of ``data/dataset.py``).

Batches are numpy on the host; the trainer moves them to the device.
``collate_fn`` pads each batch's time axis up to a bucket length (the next
multiple of ``pad_quantum_ms``) and carries the true lengths, which the
length-exact model and losses use.  Pre-simulated data loads in a thread
pool (file I/O and numpy); dynamic mixing renders in a process pool where
the host has more than two cores, since its numpy/scipy render holds the
GIL.  The pool is spawned, never forked: the trainer's process holds a
CUDA context, which a forked child must not inherit.  What a worker
imports for the dataset is ``data/``, ``simulation/`` and ``utils/``
(numpy, scipy and the host C++ libraries); none of it initialises CUDA.
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import queue
import random
import threading
from collections import defaultdict, deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator

import numpy as np

from urgent2026_challenge_track1_tpu_torch.data.scp import read_kv_scp
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = [
    "read_audio",
    "PreSimulatedDataset",
    "GroupedBatchSampler",
    "bucket_length",
    "collate_fn",
    "PrefetchLoader",
    "AudioDataModule",
]


# the dataset of a process-pool worker, set once by its initializer
_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    """Process-pool initializer: keep the dataset for ``_worker_get``.  A
    worker that imported torch (a spawned child re-imports the parent's
    ``-m`` entry module) runs it on one thread and never touches CUDA."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    import sys

    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(1)


def _worker_get(i):
    return _WORKER_DATASET[i]


read_audio = audio_io.read_audio  # (channels, T) float64 and fs


class PreSimulatedDataset:
    """Paired clean/noisy scp dataset with random ``max_duration`` cropping;
    crops are keyed by (uid, epoch), so a mid-epoch resume reproduces them."""

    def __init__(self, clean_speech, noisy_speech, utt2fs, speech_length, max_duration=-1):
        self.clean_speech = read_kv_scp(clean_speech)
        self.noisy_speech = read_kv_scp(noisy_speech)
        self.utt2fs = {k: int(v) for k, v in read_kv_scp(utt2fs).items()}
        self.speech_length = {k: int(v) for k, v in read_kv_scp(speech_length).items()}
        self.uid = list(self.clean_speech.keys())
        self.max_duration = max_duration
        self.epoch = 0
        n = len(self.clean_speech)
        if not n == len(self.noisy_speech) == len(self.utt2fs) == len(self.speech_length):
            raise ValueError(f"scp files of {clean_speech} list different utterance counts")

    def get_source_length(self):
        if self.max_duration > 0:
            return [min(self.speech_length[k], self.max_duration) for k in self.uid]
        return [self.speech_length[k] for k in self.uid]

    def get_srs(self):
        return [self.utt2fs[k] for k in self.uid]

    def __len__(self):
        return len(self.clean_speech)

    def __getitem__(self, index):
        uid = self.uid[index]
        audio, fs = read_audio(self.clean_speech[uid])
        noisy, nfs = read_audio(self.noisy_speech[uid])
        if not fs == nfs == self.utt2fs[uid]:
            raise ValueError(f"{uid}: rates {fs} / {nfs} differ from utt2fs {self.utt2fs[uid]}")
        if 0 < self.max_duration < audio.shape[1]:
            rng = random.Random(f"{uid}:{self.epoch}")
            start = rng.randint(0, audio.shape[1] - self.max_duration)
            audio = audio[:, start : start + self.max_duration]
            noisy = noisy[:, start : start + self.max_duration]
        return audio, noisy, fs, audio.shape[1]

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)


class GroupedBatchSampler:
    """Groups by fs, sorts by length, buckets of ``batch_size *
    bucket_size_mult``, then shuffles bucket order, in-bucket order and
    batch order with ``random.Random(seed + epoch)``: the JAX package's
    sampler (and the reference's), so an epoch gives the same batch order
    in both.  One process trains with ``seed`` 0, which is the JAX sampler's
    ``epoch + rank`` at rank 0.  Multi-process training (the JAX package's
    SPMD row mode) gives every rank the configured seed, so every rank
    builds the same sequence of global batches, and
    ``PrefetchLoader(row_slice=...)`` loads each rank's rows of them."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = False,
                 bucket_size_mult: int = 100, seed: int = 0):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.bucket_size = batch_size * bucket_size_mult
        self.epoch = 0
        self.seed = seed
        sr_groups = defaultdict(list)
        for idx, sr in enumerate(dataset.get_srs()):
            sr_groups[sr].append(idx)
        source_length = dataset.get_source_length()
        self.buckets = []
        for indices in sr_groups.values():
            ordered = sorted(indices, key=lambda x: source_length[x])
            for i in range(0, len(ordered), self.bucket_size):
                self.buckets.append(ordered[i : i + self.bucket_size])

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[list[int]]:
        rng = random.Random(self.seed + self.epoch)
        buckets = [list(b) for b in self.buckets]
        rng.shuffle(buckets)
        all_batches = []
        for bucket in buckets:
            rng.shuffle(bucket)
            for i in range(0, len(bucket), self.batch_size):
                batch = bucket[i : i + self.batch_size]
                if len(batch) < self.batch_size and self.drop_last:
                    continue
                all_batches.append(batch)
        rng.shuffle(all_batches)
        return iter(all_batches)

    def __len__(self):
        total = 0
        for bucket in self.buckets:
            n = len(bucket)
            total += n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return total


def bucket_length(T: int, fs: int, pad_quantum_ms: int = 1000) -> int:
    """Round T up to a bucket boundary of ``pad_quantum_ms`` at rate fs."""
    if pad_quantum_ms <= 0:
        return T
    q = max(1, fs * pad_quantum_ms // 1000)
    return -(-T // q) * q


def collate_fn(batch, pad_quantum_ms: int = 1000, pad_to: int = 0):
    """Right-zero-pad to the batch's bucket length; one fs per batch.
    Returns (clean (B, 1, T), noisy (B, 1, T), fs, lengths (B,) int32).
    ``pad_to``: a length the bucket must hold even if no item is that long
    (a rank's rows padded to their global batch's length)."""
    srs = {int(item[2]) for item in batch}
    if len(srs) != 1:
        raise ValueError(f"mixed sampling rates {sorted(srs)} in one batch")
    sr = srs.pop()
    T = bucket_length(max(max(item[0].shape[1] for item in batch), pad_to), sr,
                      pad_quantum_ms)

    def pad(x):
        # truncate, then pad: a noisy file a few samples longer than its
        # clean pair gives no negative pad width
        x = np.asarray(x, np.float32)[:, :T]
        return np.pad(x, ((0, 0), (0, T - x.shape[1])))

    clean = np.stack([pad(item[0]) for item in batch])
    noisy = np.stack([pad(item[1]) for item in batch])
    lengths = np.asarray([item[3] for item in batch], np.int32)
    return clean, noisy, sr, lengths


class _LoaderError:
    """A producer failure forwarded through the prefetch queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Dataset loader with bounded batch prefetch: items load in a thread
    pool, or with ``use_processes`` in a spawned process pool whose workers
    each hold a copy of the dataset.  ``collate`` (default ``collate_fn``)
    assembles each batch in the loader's thread.

    ``row_slice=(rank, world)``: the sampler yields global batches, the
    same on every rank; this loader loads rows ``idxs[rank::world]`` of each
    and pads them to the global batch's length (from the dataset's source
    lengths), so that every rank's rows of a step have one shape."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 4,
                 pad_quantum_ms: int = 1000, prefetch: int = 4,
                 use_processes: bool = False, collate=None, row_slice=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.pad_quantum_ms = pad_quantum_ms
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.collate = collate or collate_fn
        self.row_slice = row_slice

    def _pool(self):
        """(executor, submit(pool, index) -> future)."""
        if self.use_processes:
            # spawn: a forked child would inherit the parent's CUDA context
            pool = ProcessPoolExecutor(self.num_workers,
                                       mp_context=multiprocessing.get_context("spawn"),
                                       initializer=_init_worker, initargs=(self.dataset,))
            return pool, lambda p, i: p.submit(_worker_get, i)
        return (ThreadPoolExecutor(self.num_workers),
                lambda p, i: p.submit(self.dataset.__getitem__, i))

    def __len__(self):
        return len(self.batch_sampler)

    def _rows(self, batches) -> list[tuple[list[int], int]]:
        """(this rank's item indices, the length to pad them to) a batch."""
        if self.row_slice is None:
            return [(idxs, 0) for idxs in batches]
        rank, world = self.row_slice
        lengths = self.dataset.get_source_length()
        return [(idxs[rank::world], max(int(lengths[i]) for i in idxs)) for idxs in batches]

    def __iter__(self):
        batches = self._rows(iter(self.batch_sampler))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_bounded(item) -> bool:
            # a plain put could block this thread forever once the consumer
            # has stopped reading
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                pool, submit = self._pool()
                try:
                    pending: deque = deque()
                    it = iter(batches)
                    while not stop.is_set():
                        for idxs, pad_to in itertools.islice(
                                it, max(2, self.prefetch) - len(pending)):
                            pending.append((pad_to, [submit(pool, i) for i in idxs]))
                        if not pending:
                            break
                        pad_to, futures = pending.popleft()
                        items = [f.result() for f in futures]
                        batch = (self.collate(items, self.pad_quantum_ms, pad_to=pad_to)
                                 if pad_to else self.collate(items, self.pad_quantum_ms))
                        if not put_bounded(batch):
                            return
                finally:
                    # a consumer that stopped early leaves prefetched items:
                    # drop those not started, then join the workers
                    pool.shutdown(wait=True, cancel_futures=True)
                put_bounded(None)
            except BaseException as e:  # a dead producer must not hang the consumer
                put_bounded(_LoaderError(e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _LoaderError):
                    raise RuntimeError("PrefetchLoader producer failed") from item.exc
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


class _SkipSampler:
    """Skips the first ``skip`` index-batches of a deterministic sampler
    (mid-epoch resume)."""

    def __init__(self, sampler, skip: int):
        self.sampler = sampler
        self.skip = skip

    def __iter__(self):
        return itertools.islice(iter(self.sampler), self.skip, None)

    def __len__(self):
        return max(0, len(self.sampler) - self.skip)


class AudioDataModule:
    """Train and validation datasets and loaders from a Config.  The
    validation set is pre-simulated (``spk1.scp``, ``wav.scp``, ``utt2fs``,
    ``speech_length.scp``); so is the training set, unless
    ``train_set_dynamic_mixing``, where it is a ``DynamicMixingDataset``
    over the source lists ``speech_sources.scp``, ``noise_scoures.scp``,
    ``rirs.scp``, ``wind_noise_scoures.scp`` (the JAX package's names) and
    ``source_length.scp``.  With ``dynamic_mixing_on_device`` too it is a
    ``DynamicMixingSourceDataset``: the items carry sources and recipe
    parameters, the loader collates them into a ``DeviceRenderBatch`` (a
    dict), and the trainer renders it on its device."""

    def __init__(self, config):
        self.batch_size = config.batch_size
        self.seed = config.seed
        self.num_worker = config.num_worker
        self.pad_quantum_ms = config.length_bucket_ms
        self.dynamic_mixing = bool(config.train_set_dynamic_mixing)
        self.device_render = self.dynamic_mixing and bool(config.dynamic_mixing_on_device)
        if self.dynamic_mixing:
            if self.device_render:
                from urgent2026_challenge_track1_tpu_torch.data.dynamic_device import (
                    DynamicMixingSourceDataset as dataset_cls)
            else:
                from urgent2026_challenge_track1_tpu_torch.data.dynamic import (
                    DynamicMixingDataset as dataset_cls)

            root = config.train_set_path
            self.train_dataset = dataset_cls(
                speech_source_scp=f"{root}/speech_sources.scp",
                noise_source_scp=f"{root}/noise_scoures.scp",
                rir_scp=f"{root}/rirs.scp",
                windnoise_scp=f"{root}/wind_noise_scoures.scp",
                speech_length_file=f"{root}/source_length.scp",
                retry_when_fails=False, max_duration=config.max_duration,
                use_high_pass=config.use_high_pass)
        else:
            self.train_dataset = self._dataset(config.train_set_path, config.max_duration)
        self.val_dataset = self._dataset(config.valid_set_path)

    @staticmethod
    def _dataset(root: str, max_duration: int = -1) -> PreSimulatedDataset:
        return PreSimulatedDataset(
            clean_speech=f"{root}/spk1.scp", noisy_speech=f"{root}/wav.scp",
            utt2fs=f"{root}/utt2fs", speech_length=f"{root}/speech_length.scp",
            max_duration=max_duration,
        )

    def train_dataloader(self, rank: int = 0, world_size: int = 1, epoch: int = 0,
                         skip_batches: int = 0) -> PrefetchLoader:
        """``skip_batches`` fast-forwards the (deterministic, epoch-seeded)
        sampler on mid-epoch resume without loading the skipped items.
        Dynamic mixing renders in spawned processes where the host has more
        than two cores, as the JAX package's loader does.

        ``world_size`` > 1 (the trainer passes its dp index and dp size) is
        the SPMD row mode: global batches of ``batch_size * world_size`` rows,
        the same sequence on every rank, of which this rank loads rows
        ``[rank::world_size]`` padded to the global batch's length; each rank
        keeps ``batch_size`` rows, the reference's batch a GPU."""
        spmd = world_size > 1
        if spmd and self.device_render:
            raise NotImplementedError(
                "dynamic_mixing_on_device with multi-process training is not supported "
                "(its dict collate has no global padding); use host dynamic mixing, as "
                "the JAX package requires")
        sampler = GroupedBatchSampler(self.train_dataset,
                                      batch_size=self.batch_size * world_size,
                                      drop_last=True, seed=self.seed if spmd else 0)
        sampler.set_epoch(epoch)
        if hasattr(self.train_dataset, "set_epoch"):
            self.train_dataset.set_epoch(epoch)
        if skip_batches:
            sampler = _SkipSampler(sampler, skip_batches)
        use_processes = self.dynamic_mixing and (os.cpu_count() or 1) > 2
        collate = None
        if self.device_render:
            from urgent2026_challenge_track1_tpu_torch.data.dynamic_device import (
                collate_device_render as collate)
        return PrefetchLoader(self.train_dataset, sampler, self.num_worker,
                              self.pad_quantum_ms, use_processes=use_processes,
                              collate=collate,
                              row_slice=(rank, world_size) if spmd else None)

    def val_dataloader(self) -> PrefetchLoader:
        sampler = GroupedBatchSampler(self.val_dataset, batch_size=self.batch_size,
                                      drop_last=True)
        return PrefetchLoader(self.val_dataset, sampler, self.num_worker,
                              self.pad_quantum_ms)
