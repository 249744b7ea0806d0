"""The collectives of the multi-device layer, on plain local tensors.

Where the JAX package's sharded solvers leave their communication to XLA
(``psum``, ``psum_scatter``, ``all_gather``, ``ppermute`` inside
``shard_map`` or inserted by the SPMD partitioner), the port calls
``torch.distributed`` explicitly, over the process group of one named
mesh dimension.  Every call goes through these wrappers, which count
themselves in :data:`counts` (calls since :func:`reset_counts`), so that a
test or ``chip_smoke.py`` can read which collectives a path issued.

Each wrapper takes the group of one mesh dimension
(:func:`~tensornetwork_tpu_torch.parallel.mesh.axis_group`) and works at
every world size, 1 included.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

counts: Dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0,
                          "all_gather": 0, "send_recv": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def require_group() -> None:
    """Raise unless a default process group is up: every sharded entry
    point runs its sharded code, at a world of one rank too, and none
    falls back to the unsharded path without one."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "initialize_distributed() (or init_process_group) on every rank "
            "first; a single process is a world of one rank")


def group_rank(group) -> int:
    require_group()
    return dist.get_rank(group)


def group_size(group) -> int:
    require_group()
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor; ``x`` is kept)."""
    counts["all_reduce"] += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over the group and keep this rank's block of ``dim``
    (``dim`` split in group-size equal blocks, in rank order)."""
    counts["reduce_scatter"] += 1
    size = group_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{size} ranks")
    blk = x.shape[dim] // size
    # blocks of dim to the front: reduce_scatter_tensor splits dim 0
    parts = x.reshape(x.shape[:dim] + (size, blk) + x.shape[dim + 1:])
    parts = parts.movedim(dim, 0).contiguous()
    # flat buffers: both backends split a flat input in equal blocks
    out = torch.empty(parts[0].numel(), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # torch 2.13 renames it reduce_scatter_single; 2.11 has only this
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, parts.reshape(-1), group=group)
    return out.reshape(parts.shape[1:])


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order."""
    counts["all_gather"] += 1
    size = group_size(group)
    dim = dim % x.dim()
    out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # torch 2.13 renames it all_gather_single; 2.11 has only this
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                    group=group)
    out = out.reshape((size,) + tuple(x.shape)).movedim(0, dim)
    return out.reshape(x.shape[:dim] + (size * x.shape[dim],)
                       + x.shape[dim + 1:])


def shift(x: torch.Tensor, group, direction: int) -> Optional[torch.Tensor]:
    """One neighbour exchange along the group's ranks, the counterpart of
    one ``lax.ppermute`` with the permutation [(i, i + direction)]: rank i
    sends ``x`` to rank i + direction and receives from rank i -
    direction.  Returns what was received, or None on the rank that has no
    sender (rank 0 for +1, the last rank for -1)."""
    counts["send_recv"] += 1
    rank, size = group_rank(group), group_size(group)
    ranks: Sequence[int] = dist.get_process_group_ranks(group)
    ops: List[dist.P2POp] = []
    src, dst = rank - direction, rank + direction
    recv = None
    if 0 <= dst < size:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst],
                              group=group))
    if 0 <= src < size:
        recv = torch.empty_like(x, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src], group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv
