"""The general traffic generator: a mix's JSON file in ``traffic/`` gives
the parameters, this module turns them and a seed into rounds.

A round's composition (which rates, which lengths, how they are batched)
is fixed by the mix; the seed draws only the audio content and, where the
mix says so, the order within a round.  Two kinds:

* ``train``: one batch per rate of ``batch_size`` crops (the last item of
  each batch ``last_item_fraction`` of the crop), zero-padded to the
  batch's 1 s bucket, with the items' lengths, as the training loader
  collates them; the batches' order drawn per round.
* ``enhance``: files at every rate with lengths from ``seconds`` or the
  quantiles of a clipped lognormal; with ``batch_size`` 1 each file alone
  (the CLI's default route), padded to its bucket, in an order drawn per
  round; above 1 grouped by (rate, bucket) in sorted order and cut into
  batches filled up with rows of the bucket's length (the CLI's batched
  route).

Buckets are whole seconds of samples, the rule of the port's CLI and
loader.  Content is made on the device at set-up (a tone with harmonics
under an envelope, plus white noise), once for every round of a run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for torch or numpy from the run's seed and tags."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *[int(t) for t in tags]]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


@dataclasses.dataclass(frozen=True)
class Batch:
    """One call of the program: ``items`` index the round's files (or crops),
    ``fill`` rows of the bucket's length are added (the CLI's filler)."""

    fs: int
    bucket: int
    items: tuple[int, ...]
    lengths: tuple[int, ...]
    fill: int = 0

    @property
    def rows(self) -> int:
        return len(self.items) + self.fill


def _bucket(n: int, fs: int) -> int:
    return -(-n // fs) * fs


def lognormal_seconds(n: int, median_s: float, sigma: float, min_s: float,
                      max_s: float) -> list[float]:
    """The quantiles (i + 0.5) / n of a lognormal, clipped to [min, max]."""
    from statistics import NormalDist

    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [min(max(median_s * math.exp(sigma * zi), min_s), max_s) for zi in z]


class Traffic:
    def __init__(self, spec: dict, batch_size: int | None = None):
        self.spec = spec
        self.kind = spec["kind"]
        if self.kind not in ("train", "enhance"):
            raise ValueError(f"traffic kind {self.kind!r}: expected train or enhance")
        self.rates = [int(r) for r in spec["rates"]]
        self.batch_size = int(spec.get("batch_size") or batch_size)
        self.items = self._items()  # (fs, samples) of every item of a round

    def _items(self) -> list[tuple[int, int]]:
        s = self.spec
        if self.kind == "train":
            crop = int(s["crop_samples"])
            last = int(crop * float(s["last_item_fraction"]))
            per = [crop] * (self.batch_size - 1) + [last]
            return [(fs, n) for fs in self.rates for n in per]
        if "seconds" in s:
            secs = [float(x) for x in s["seconds"]]
        else:
            secs = lognormal_seconds(**s["lognormal"])
        return [(fs, int(round(x * fs))) for fs in self.rates for x in secs]

    # -- composition -------------------------------------------------------

    def _batch(self, idx) -> Batch:
        fs = self.items[idx[0]][0]
        lengths = tuple(self.items[i][1] for i in idx)
        return Batch(fs, _bucket(max(lengths), fs), tuple(idx), lengths)

    def batches(self) -> list[Batch]:
        """A round's batches in the program's order before any shuffle."""
        B = self.batch_size
        if self.kind == "train":
            return [self._batch(list(range(i, i + B))) for i in range(0, len(self.items), B)]
        if B == 1:
            return [self._batch([i]) for i in range(len(self.items))]
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (fs, n) in enumerate(self.items):
            groups.setdefault((fs, _bucket(n, fs)), []).append(i)
        out = []
        for (fs, bucket), idx in sorted(groups.items()):
            for j in range(0, len(idx), B):
                chunk = idx[j:j + B]
                out.append(Batch(fs, bucket, tuple(chunk),
                                 tuple(self.items[i][1] for i in chunk), B - len(chunk)))
        return out

    def shuffled(self) -> bool:
        return self.kind == "train" or self.batch_size == 1

    def round(self, seed: int, r: int) -> list[Batch]:
        """Round r's batches: in an order drawn from (seed, r) where the mix
        shuffles, else in the grouped order."""
        b = self.batches()
        if self.shuffled():
            order = np.random.default_rng(derive(seed, 1, r)).permutation(len(b))
            b = [b[i] for i in order]
        return b

    def shapes(self) -> list[tuple[int, int, int]]:
        """Every distinct (fs, rows, bucket) a round sends."""
        return sorted({(b.fs, b.rows, b.bucket) for b in self.batches()})

    def audio_seconds(self) -> float:
        return sum(n / fs for fs, n in self.items)

    # -- content ------------------------------------------------------------

    def content(self, seed: int, tag: int, device) -> list[dict]:
        """The round's items as host float32 arrays: ``noisy`` (and for
        training ``clean``), drawn on ``device`` from (seed, tag)."""
        gen = torch.Generator(device=device).manual_seed(derive(seed, 2, tag))
        sizes = [n for _, n in self.items]
        total = sum(sizes)
        noise = torch.randn(total, generator=gen, device=device)
        par = torch.rand(len(sizes), 4, generator=gen, device=device)
        out, at = [], 0
        for (fs, n), (f0, ph, rate, lvl) in zip(self.items, par):
            t = torch.arange(n, device=device, dtype=torch.float32) / fs
            f = 100.0 + 300.0 * f0
            tone = sum(torch.sin(2 * math.pi * k * f * t + k * 6.283 * ph) / k for k in (1, 2, 3))
            clean = (0.1 + 0.2 * lvl) * tone * (0.6 + 0.4 * torch.sin(2 * math.pi * (1 + 3 * rate) * t))
            noisy = clean + 0.05 * noise[at:at + n]
            at += n
            out.append({"clean": clean, "noisy": noisy})
        flat = {k: torch.cat([o[k] for o in out]).cpu().numpy() for k in ("clean", "noisy")}
        res, at = [], 0
        for n in sizes:
            item = {"noisy": flat["noisy"][at:at + n]}
            if self.kind == "train":
                item["clean"] = flat["clean"][at:at + n]
            res.append(item)
            at += n
        return res

    @staticmethod
    def padded(content: list[dict], batch: Batch, key: str) -> np.ndarray:
        """(rows, bucket) float32: a training batch's items zero-padded, as
        the loader collates them."""
        x = np.zeros((batch.rows, batch.bucket), np.float32)
        for j, i in enumerate(batch.items):
            w = content[i][key]
            x[j, :len(w)] = w
        return x
