"""Device meshes and sharding helpers on ``torch.distributed``.

Counterpart of :mod:`tensornetwork_tpu.parallel.mesh`.  A JAX ``Mesh`` of
devices becomes a :class:`~torch.distributed.device_mesh.DeviceMesh` over
the ranks of the process group, with the same named dimensions; a
``NamedSharding`` of a public array becomes a DTensor with one placement a
mesh dimension (``Shard(k)`` or ``Replicate()``).  The sharded solvers
work on the local blocks of those tensors and communicate over the
process group of a named dimension (:func:`axis_group`) through
:mod:`~tensornetwork_tpu_torch.parallel.collectives`.

Meshes go on the card (NCCL) unless the caller asks for the CPU (gloo),
as :func:`~tensornetwork_tpu_torch.config.default_device` decides.  Every
mesh needs a process group: there is no single-process fall back, and a
world of one rank is a mesh like any other.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.parallel.collectives import require_group

#: init_process_group's timeout when the caller gives none
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _ranks(devices: Optional[Sequence[int]]) -> list:
    require_group()
    if devices is None:
        return list(range(dist.get_world_size()))
    return [int(d) for d in devices]


def make_mesh(shape: Union[Tuple[int, ...], Sequence[int]],
              axis_names: Sequence[str] = ("data", "model"),
              devices: Optional[Sequence[int]] = None,
              device: Optional[Device] = None) -> DeviceMesh:
    """A named mesh over the ranks ``devices`` (default: the whole world),
    in row-major order.  ``shape`` entries of -1 are inferred from the
    rank count.  ``device``: the card unless the caller asks for the CPU
    (:func:`~tensornetwork_tpu_torch.config.default_device`)."""
    ranks = _ranks(devices)
    shape = list(shape)
    n = len(ranks)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not match "
                         f"{n} devices")
    if len(shape) != len(axis_names):
        raise ValueError("axis_names must match mesh rank")
    return DeviceMesh(default_device(device).type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the mesh dimension ``axis`` that holds this
    rank."""
    require_group()
    return mesh.get_group(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    require_group()
    return mesh.size(mesh.mesh_dim_names.index(axis))


def placements(mesh: DeviceMesh, shards: dict) -> list:
    """One placement a mesh dimension: ``Shard(shards[name])`` for the
    dimensions named in ``shards``, ``Replicate()`` for the others."""
    unknown = set(shards) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"mesh has no dimension {sorted(unknown)}; it has "
                         f"{mesh.mesh_dim_names}")
    return [Shard(shards[name]) if name in shards else Replicate()
            for name in mesh.mesh_dim_names]


def batch_spec(mesh: DeviceMesh, batch_axis: str = "data",
               ndim: int = 5) -> list:
    """Placements of a stacked batch of MPS instances: the leading (batch)
    axis split over ``batch_axis``, everything else replicated."""
    if ndim < 1:
        raise ValueError("a batch needs at least one dimension")
    return placements(mesh, {batch_axis: 0})


def shard_array(x: torch.Tensor, mesh: DeviceMesh, spec):
    """``x`` as a DTensor on ``mesh`` with ``spec``'s placements (one a
    mesh dimension); rank 0's ``x`` is the one distributed."""
    return distribute_tensor(x, mesh, list(spec))


def replicate(x: torch.Tensor, mesh: DeviceMesh):
    return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)


def local(x) -> torch.Tensor:
    """This rank's block of a DTensor; a plain tensor as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


# ---------------------------------------------------------------------------
# Multi-host ownership: process bring-up and the host x chip layout.
# ---------------------------------------------------------------------------


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids=None,
                           device: Optional[Device] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT
                           ) -> bool:
    """Start the default process group, one process a card.

    The arguments default to torchrun's environment (``MASTER_ADDR``/
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  Safe to
    call unconditionally, as the JAX function: with nothing configured it
    does nothing and returns ``False``; with a group already up it returns
    ``True``.  NCCL on the card, gloo when ``device`` is the CPU;
    ``local_device_ids`` (or ``LOCAL_RANK``) picks this process's card."""
    if dist.is_initialized():
        return True
    env = os.environ
    has_cfg = (coordinator_address is not None or "MASTER_ADDR" in env
               or "WORLD_SIZE" in env or "RANK" in env)
    if not has_cfg:
        return False
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    dev = default_device(device)
    if dev.type == "cuda":
        local_id = (local_device_ids[0] if local_device_ids is not None
                    else int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(int(local_id))
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank,
                            timeout=timeout)
    return True


def make_hybrid_mesh(ici_shape: Tuple[int, ...], dcn_shape: Tuple[int, ...],
                     axis_names: Sequence[str],
                     devices: Optional[Sequence[int]] = None,
                     device: Optional[Device] = None) -> DeviceMesh:
    """Host x chip mesh: the leading ``dcn_shape`` dimensions split across
    hosts (the slow network: put the batch axis there), the trailing
    ``ici_shape`` ones inside a host (NVLink: bond or chain axes).
    ``axis_names`` names the host dimensions first.  Ranks fill the chip
    dimensions first, as torchrun numbers the processes of a host
    consecutively."""
    ranks = _ranks(devices)
    if len(dcn_shape) + len(ici_shape) != len(axis_names):
        raise ValueError("axis_names must cover dcn + ici axes")
    n_needed = int(np.prod(dcn_shape, dtype=np.int64)) * int(
        np.prod(ici_shape, dtype=np.int64))
    if n_needed != len(ranks):
        raise ValueError(f"mesh {tuple(dcn_shape)}x{tuple(ici_shape)} "
                         f"needs {n_needed} devices, got {len(ranks)}")
    return make_mesh(tuple(dcn_shape) + tuple(ici_shape), axis_names,
                     devices=ranks, device=device)


def pod_layout(n_hosts: Optional[int] = None,
               devices: Optional[Sequence[int]] = None,
               device: Optional[Device] = None) -> DeviceMesh:
    """The solver suite's recommended mesh, ``("host", "model")``: the
    instance (batch) axis over hosts, the bond or chain axis over the
    cards of a host.  ``n_hosts`` defaults to the world over torchrun's
    ``LOCAL_WORLD_SIZE`` (1 without it)."""
    ranks = _ranks(devices)
    if n_hosts is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
        n_hosts = max(len(ranks) // max(per, 1), 1)
    per_host = len(ranks) // n_hosts
    if n_hosts * per_host != len(ranks):
        raise ValueError(f"{len(ranks)} devices do not split over "
                         f"{n_hosts} hosts")
    return make_hybrid_mesh((per_host,), (n_hosts,), ("host", "model"),
                            devices=ranks, device=device)
