"""Sector-sharded batched U(1) DMRG, with the cold-start cache, on the
port (counterpart of ``examples/distributed_symmetric_dmrg.py``).

A batch of XXZ realizations sharing one charge skeleton runs one-site
DMRG on one device, its programs' plans written to ``export_dir`` and
installed again (a later process loads them instead of building:
:meth:`~tensornetwork_tpu_torch.models.symmetric_dmrg_batched.
BatchedSymmetricDMRG.export_programs`); then the same sweeps with every
contraction's charge sectors split over the ranks of the process group
and every environment stored as one 1/P block a rank (capacity EP,
``ep_mesh=``, ``ep_capacity=True``).  The two runs agree.

The process group is the caller's; without one, :func:`main` starts a
group of one rank (NCCL on the card, gloo on the CPU) and ends it.  On
several processes (``torchrun``), rank 0 writes the files and every rank
reads them.

    python -m tensornetwork_tpu_torch.examples.distributed_symmetric_dmrg \
        [EXPORT_DIR] [--cpu]
"""
import argparse
import contextlib
import datetime
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tensornetwork_tpu_torch.blocksparse.batched import (
    random_data_batch, uniform_skeleton_mps)
from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)
from tensornetwork_tpu_torch.parallel.mesh import (initialize_distributed,
                                                   make_mesh)


@contextlib.contextmanager
def process_group(device: Optional[Device] = None):
    """The running process group, or one of one rank for the block
    (``file://`` rendezvous in a temporary directory, 120 s timeout)."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp()
    try:
        initialize_distributed(f"file://{tmp}/rendezvous", num_processes=1,
                               process_id=0, device=device,
                               timeout=datetime.timedelta(seconds=120))
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def compare(N=8, chi=16, B=4, sweeps=3, export_dir=None,
            device: Optional[Device] = None):
    """(single-device energies, capacity-EP energies, files written,
    programs installed), float32, the data from seed 0; inside a process
    group (:func:`process_group`)."""
    device = default_device(device)
    skel = uniform_skeleton_mps(N, chi, dtype=torch.float32, device=device)
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float32, device=device)
    data = random_data_batch(skel, B, seed=0, device=device)

    # single-device reference run
    ref = BatchedSymmetricDMRG(skel, [d.clone() for d in data], mpo,
                               num_krylov_vecs=10)
    written = loaded = 0
    if export_dir:
        if dist.get_rank() == 0:
            written = ref.export_programs(export_dir)
            print(f"exported {written} programs' plans -> {export_dir}")
        dist.barrier()
        loaded = ref.load_programs(export_dir)
    es_ref = ref.run_one_site(num_sweeps=sweeps)
    print(f"single-device: E mean {es_ref.mean():.8f} "
          f"span [{es_ref.min():.6f}, {es_ref.max():.6f}]")

    # capacity EP: the charge sectors over every rank, and the env stacks
    # stored 1/P a rank (env chains reduce-scatter, no all_reduce)
    world = dist.get_world_size()
    mesh = make_mesh((world,), ("ep",), device=device)
    ep = BatchedSymmetricDMRG(skel, [d.clone() for d in data], mpo,
                              num_krylov_vecs=10, ep_mesh=mesh,
                              ep_capacity=True)
    es_ep = ep.run_one_site(num_sweeps=sweeps)
    print(f"capacity-EP ({world} ranks, env stacks sharded): E mean "
          f"{es_ep.mean():.8f} (max dev vs single-device "
          f"{np.abs(es_ep - es_ref).max():.2e})")
    return es_ref, es_ep, written, loaded


def main(N=8, chi=16, B=4, sweeps=3, export_dir=None,
         device: Optional[Device] = None):
    """:func:`compare` in the caller's process group, or in one of one
    rank; returns the capacity-EP energies."""
    with process_group(device):
        return compare(N, chi, B, sweeps, export_dir, device)[1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("export_dir", nargs="?", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None
    # under torchrun the environment names the group
    initialize_distributed(device=dev)
    main(export_dir=args.export_dir, device=dev)
