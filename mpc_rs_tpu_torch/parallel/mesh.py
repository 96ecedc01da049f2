"""The rank mesh: named axes over the ranks of a ``torch.distributed`` world.

Port of ``mpc_rs_tpu/parallel/mesh.py``. The JAX package lays devices out
on a named ``Mesh`` and ``shard_map`` runs one program over it; here one
process is one rank, and a mesh is this rank's place on the named axes with
one process group an axis:

- ``rollouts``: MPPI's K sampled sequences split over ranks, merged by one
  log-sum-exp round of collectives (``all_reduce`` MAX, then SUM),
- ``scenario``: independent closed loops split over ranks, with no
  collective in the tick.

Ranks lay out row-major over the axes in the order given, the last axis
fastest, as ``np.array(devices).reshape(shape)`` does there: on
``{"scenario": S, "rollouts": R}`` rank s·R + r sits at (s, r)
(``mpc_rs_tpu/parallel/distributed.py:35-42``). A process with no
``torch.distributed`` group is a world of one: there every axis has size 1,
no group, and every collective is skipped.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh."""

    shape: dict  # axis name -> size, in layout order (the last axis fastest)
    coords: dict  # axis name -> this rank's coordinate; empty for a rank outside the mesh
    groups: dict  # axis name -> the process group of this rank's line along it, or None (a world of one)
    rank: int  # this rank in the world
    world: int  # ranks in the world

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def world() -> tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axis_sizes: dict[str, int] | None = None) -> Mesh:
    """A mesh of the world's first prod(sizes) ranks, default every rank on
    one ``rollouts`` axis. ``make_mesh({"scenario": 2, "rollouts": 4})`` is
    2×4. Every rank of the world calls it with the same sizes: the groups
    are created with ``dist.new_group``, one a line of each axis, on every
    rank in the same order. Raises when the mesh needs more ranks than the
    world has."""
    rank, n_world = world()
    if axis_sizes is None:
        axis_sizes = {"rollouts": n_world}
    shape = dict(axis_sizes)
    if any(int(v) < 1 for v in shape.values()):
        raise ValueError(f"mesh axis sizes must be positive, got {shape}")
    n = math.prod(shape.values())
    if n > n_world:
        raise ValueError(f"mesh needs {n} ranks, have {n_world}")
    names = list(shape)
    sizes = [shape[a] for a in names]
    coords = {}
    if rank < n:
        rest = rank
        for a, size in zip(reversed(names), reversed(sizes)):
            coords[a] = rest % size
            rest //= size
        coords = {a: coords[a] for a in names}
    groups = {a: None for a in names}
    if dist.is_available() and dist.is_initialized():
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        for i, a in enumerate(names):
            others = [range(s) if j != i else range(1) for j, s in enumerate(sizes)]
            for base in itertools.product(*others):
                start = sum(c * st for c, st in zip(base, strides))
                ranks = [start + c * strides[i] for c in range(sizes[i])]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[a] = g
    return Mesh(shape, coords, groups, rank, n_world)


def all_reduce(t: torch.Tensor, op, mesh: Mesh, axis: str) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``axis``'s group; nothing
    without a group (a world of one). Returns ``t``."""
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_host(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The tensors of ``axis``'s ranks, concatenated along dim ``0`` in
    coordinate order, on the host. NCCL gathers on the card; gloo, whose
    CUDA tensors have no all_gather, gathers host copies. Without a group,
    ``t`` on the host."""
    group = mesh.group(axis)
    if group is None:
        return t.detach().cpu()
    src = t.detach().contiguous()
    if dist.get_backend(group) != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat([p.cpu() for p in parts], dim=0)
