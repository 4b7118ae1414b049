"""Row-sharded recurrences over a dp x mp mesh (counterpart of
``parallel/model_parallel.py``).

The dual-path layer's recurrences treat their rows as independent
sequences: B*K (batch x band) rows over time, B*T (batch x frame) rows over
bands.  The JAX package shards those rows over the whole mesh with sharding
constraints and lets GSPMD insert the collectives.  Here every process holds
its own data: the wav batch splits over dp (each dp rank runs its block of
utterances), and inside every dp block the rows of each recurrence split
over mp.  Everything else of the model (norms, band split, decoders) runs
whole on each mp rank of a dp block.

``row_sharder(mesh)`` wraps each recurrence, with the linear projection
that follows it, in a pair of autograd Functions (``models/bsrnn.py``
``DualPathLayer``):

* ``split``: forward takes this mp rank's block of rows (padded to
  ceil(R / mp) rows a rank, with zero rows of full length, so that no kernel
  sees an empty row); backward all-gathers the row gradients over mp and
  divides them by mp.
* ``gather``: forward all-gathers the blocks and drops the padding;
  backward takes this rank's block of the upstream gradient, times mp.

Every mp rank computes the same loss from the gathered rows.  So the
parameters inside the pair get mp times their rows' share of the gradient
on each rank, and the sum over the mp group is mp times the whole
gradient; every parameter outside gets the whole gradient on every rank,
also mp times over the group.  One uniform mean over the world
(``mesh.all_reduce_gradients``, 1/(dp*mp)) is then the global batch's
gradient for every parameter, with no list of which ones the pair holds,
and the split's division hands the layers below the exact gradient (the
factor is exact for a power-of-two mp).  Not
``torch.distributed.nn.functional.all_gather``: its backward sums the
upstream gradient over the group, with no division in the split.  The
projection sits inside the pair because it is row-wise too, and it shrinks
what the gather moves from 2H (4N) to N columns; GSPMD places the JAX
package's reshard after it as well.  Each rank launches the port's kernels
on its own rows.

``make_sharded_enhance`` / ``make_sharded_flow_enhance`` take the global
batch on every rank and return the global output on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from urgent2026_challenge_track1_tpu_torch.parallel.mesh import Mesh, all_gather_rows

__all__ = ["RowSharder", "row_sharder", "make_sharded_enhance", "make_sharded_flow_enhance",
           "gather_dp"]


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharder: "RowSharder"):
        ctx.sharder, ctx.rows = sharder, x.shape[0]
        return sharder.block(_pad_rows(x, sharder.padded(x.shape[0]), 0)).clone()

    @staticmethod
    def backward(ctx, g):
        s = ctx.sharder
        return all_gather_rows(g.contiguous(), s.group, s.size)[:ctx.rows] / s.size, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, sharder: "RowSharder", rows: int):
        ctx.sharder = sharder
        return all_gather_rows(h.contiguous(), sharder.group, sharder.size)[:rows]

    @staticmethod
    def backward(ctx, g):
        s = ctx.sharder
        return s.block(_pad_rows(g, s.padded(g.shape[0]), 0)) * s.size, None, None


class RowSharder:
    """``sharder(fn, seq, lengths=None)`` = ``fn(seq[, lengths])`` with the
    rows of ``seq`` (and ``lengths``) split over the ``size`` members of
    ``group``, this member (``index``) running its block."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size

    def padded(self, rows: int) -> int:
        return -(-rows // self.size) * self.size

    def block(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0] // self.size
        return x[self.index * b:(self.index + 1) * b]

    def __call__(self, fn: Callable, seq: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows = seq.shape[0]
        part = _Split.apply(seq, self)
        if lengths is None:
            return _Gather.apply(fn(part), self, rows)
        # padded rows run at full length: a zero-length row would meet no kernel
        lens = self.block(_pad_rows(lengths, self.padded(rows), seq.shape[1]))
        return _Gather.apply(fn(part, lens.contiguous()), self, rows)


def row_sharder(mesh: Mesh) -> Optional[RowSharder]:
    """The sharder of ``mesh``'s mp group; None where mp is 1 (nothing to
    split: the model then runs its unsharded path, launch for launch)."""
    if mesh.mp == 1:
        return None
    return RowSharder(mesh.mp_group, mesh.mp_index, mesh.mp)


def gather_dp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The dp blocks of ``x`` concatenated in dp order, on every rank."""
    return x if mesh.dp == 1 else all_gather_rows(x, mesh.dp_group, mesh.dp)


def make_sharded_enhance(mesh: Mesh, model, stft_cfg, fs: int,
                         lengths: bool = False) -> Callable:
    """``fn(noisy (B, T)[, lengths (B,)]) -> enhanced (B, T)``: the global
    batch in, on every rank; each dp rank enhances its B / dp rows with the
    recurrence rows split over mp; the global output out, on every rank."""
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn import bsrnn_se_apply

    shard = row_sharder(mesh)

    @torch.inference_mode()
    def fn(noisy: torch.Tensor, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows = mesh.dp_block(noisy.shape[0])
        wav, _ = bsrnn_se_apply(model, stft_cfg, noisy[rows], fs,
                                lengths=lens[rows] if lengths else None, shard=shard)
        return gather_dp(wav, mesh)

    return fn


def make_sharded_flow_enhance(mesh: Mesh, model, cfg, fs: int, N: int = 15,
                              solver: str = "euler", lengths: bool = False) -> Callable:
    """``fn(noisy (B, T)[, lengths (B,)], generator=None, x0=None)``: the
    flow sampler with ``make_sharded_enhance``'s contract.  The prior of the
    global batch comes from ``x0`` (B, frames, F) or is drawn from
    ``generator`` for all B rows on every rank, each keeping its block, so
    the result equals one process's ``flowse_enhance`` with that draw."""
    from urgent2026_challenge_track1_tpu_torch.models.bsrnn_flowse import flowse_enhance

    shard = row_sharder(mesh)

    @torch.inference_mode()
    def fn(noisy: torch.Tensor, lens: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows = mesh.dp_block(noisy.shape[0])
        wav = flowse_enhance(model, cfg, noisy[rows], fs, N=N, solver=solver,
                             lengths=lens[rows] if lengths else None, generator=generator,
                             x0=None if x0 is None else x0[rows],
                             prior_rows=(noisy.shape[0], rows), shard=shard)
        return gather_dp(wav, mesh)

    return fn
