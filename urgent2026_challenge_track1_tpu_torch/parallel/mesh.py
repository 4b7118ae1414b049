"""The process mesh: dp x mp over one process a GPU (counterpart of
``parallel/mesh.py``).

The reference trains data-parallel with DDP over NCCL, one process a GPU
(its ``train_se.py:74-83``); the JAX package builds one program over a
device mesh and lets XLA insert the collectives.  Here every process holds
its own rows, so the collectives are explicit: the trainer all-reduces the
gradients (``all_reduce_gradients``), the serving rank broadcasts each batch
(``broadcast_batch``), and ``parallel/model_parallel.py`` gathers the row
blocks of the recurrences (``all_gather_rows``).

``mesh_shape`` strings have the JAX grammar ("dp=-1", "dp=2,mp=4"; -1
takes the world size over the product of the other sizes).  Ranks lie on
the mesh in C order, as JAX's ``devices.reshape(sizes)``: for "dp=2,mp=4"
``rank = dp_index * 4 + mp_index``, so an mp group is consecutive ranks.
Every axis but ``dp`` counts as model-parallel, as in the JAX
``row_constrainer``; ``mp`` is the product of their sizes.

A world of one needs no process group.  A larger one needs
``torch.distributed`` initialised (``train_se.py`` and ``serve.py`` do so
under ``torchrun``): NCCL on the card, gloo on the CPU.  The collectives
take the tensors where they lie, CUDA tensors under gloo included (PyTorch
2.11's gloo all-gathers, all-reduces and broadcasts CUDA tensors).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device

__all__ = [
    "parse_mesh_shape",
    "resolve_sizes",
    "mesh_coords",
    "Mesh",
    "make_mesh",
    "all_gather_rows",
    "all_reduce_gradients",
    "broadcast_batch",
]


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """'dp=8' / 'dp=-1' / 'dp=4,tp=2' -> ordered {axis: size}."""
    out = {}
    for part in spec.split(","):
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


def resolve_sizes(spec: str, world_size: int) -> dict[str, int]:
    """The axis sizes of ``spec`` over ``world_size`` processes, the -1
    resolved; raises where their product is not the world size."""
    axes = parse_mesh_shape(spec)
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world_size // known
    if int(np.prod(sizes)) != world_size or min(sizes) < 1:
        raise ValueError(
            f"mesh_shape {spec!r} needs {int(np.prod(sizes))} processes, but the world "
            f"size is {world_size}: launch one process a device (torchrun "
            f"--nproc_per_node N) with a mesh whose sizes multiply to N")
    return dict(zip(axes, sizes))


def mesh_coords(sizes: dict[str, int], rank: int) -> tuple[int, int]:
    """(dp_index, mp_index) of ``rank``: its C-order coordinates on the
    mesh, the non-dp axes flattened into one mp index."""
    coords = np.unravel_index(rank, tuple(sizes.values()))
    dp_i, mp_i = 0, 0
    for (name, size), c in zip(sizes.items(), coords):
        if name == "dp":
            dp_i = int(c)
        else:
            mp_i = mp_i * size + int(c)
    return dp_i, mp_i


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a dp x mp mesh and its process groups
    (None where a group has one member or there is no process group)."""

    sizes: dict
    dp: int
    mp: int
    dp_index: int
    mp_index: int
    rank: int
    world_size: int
    dp_group: Optional[object]
    mp_group: Optional[object]
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def dp_block(self, n: int) -> slice:
        """This rank's rows of ``n`` global rows split evenly over dp."""
        if n % self.dp:
            raise ValueError(f"{n} rows do not split over dp={self.dp}")
        b = n // self.dp
        return slice(self.dp_index * b, (self.dp_index + 1) * b)


def _grouped() -> bool:
    """Whether this process is in a process group (a world of one may be)."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _default_device() -> str:
    return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"


def make_mesh(mesh_shape: str = "dp=-1", device=None) -> Mesh:
    """The mesh of this process.  ``device``: where its tensors go,
    ``cuda:LOCAL_RANK`` by default (``"cuda"`` means the same; it becomes the
    current CUDA device), the CPU only where asked for.  Every process of the
    world calls it, in the same order (it creates the dp and mp groups)."""
    dist = torch.distributed
    rank, world = (dist.get_rank(), dist.get_world_size()) if _grouped() else (0, 1)
    sizes = resolve_sizes(mesh_shape, world)
    if device is None or str(device) == "cuda":
        device = _default_device()
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # the kernels launch on the current device
    dp = sizes.get("dp", 1)
    mp = world // dp
    dp_i, mp_i = mesh_coords(sizes, rank)
    dp_group = mp_group = None
    coords = [mesh_coords(sizes, r) for r in range(world)]
    # every rank creates every group of more than one member, in one order
    if dp > 1:
        for m in range(mp):
            g = dist.new_group([r for r in range(world) if coords[r][1] == m])
            if m == mp_i:
                dp_group = g
    if mp > 1:
        for d in range(dp):
            g = dist.new_group([r for r in range(world) if coords[r][0] == d])
            if d == dp_i:
                mp_group = g
    return Mesh(sizes, dp, mp, dp_i, mp_i, rank, world, dp_group, mp_group, device)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``size`` members' equal blocks of ``x`` concatenated along the
    leading axis, in group-rank order."""
    parts = [torch.empty_like(x) for _ in range(size)]
    torch.distributed.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_reduce_gradients(grads: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Every gradient set in place to its mean over the world, which is the
    global batch's gradient (``parallel/model_parallel.py`` says why one
    weight, 1/(dp*mp), serves every parameter).  One flat all-reduce;
    nothing where there is no process group."""
    if not _grouped():
        return
    grads = list(grads)
    flat = torch.cat([g.reshape(-1).float() for g in grads]) * (1.0 / mesh.world_size)
    torch.distributed.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_batch(*tensors: torch.Tensor, group=None, src: int = 0) -> None:
    """Every rank's ``tensors`` (of ``group``, the world by default) set in
    place to those of global rank ``src``, one broadcast each."""
    for t in tensors:
        torch.distributed.broadcast(t, src, group=group)
