"""Disorder-averaged U(1) DMRG: many realizations in one batched sweep,
on the port (counterpart of ``examples/disorder_study.py``).

Every realization of a random-bond XXZ chain shares one charge skeleton,
so the whole ensemble sweeps on the device as batched sector GEMMs
(:class:`~tensornetwork_tpu_torch.models.symmetric_dmrg_batched.
BatchedSymmetricDMRG`).

    python -m tensornetwork_tpu_torch.examples.disorder_study [--chi 64] \
        [--B 16] [--N 12] [--sweeps 6] [--cpu]
"""
import argparse
import time
from typing import Optional

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.batched import (
    random_data_batch, uniform_skeleton_mps)
from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)


def solve(N: int = 12, chi: int = 64, B: int = 16, num_sweeps: int = 6,
          seed: int = 0, verbose: int = 1,
          device: Optional[Device] = None) -> BatchedSymmetricDMRG:
    """The solver after ``num_sweeps`` one-site sweeps of B realizations,
    float32: per-realization Jz drawn uniform in [0.5, 1.5] from
    ``numpy.random.default_rng(seed)``, the data drawn from ``seed``.
    The MPO's charge structure does not depend on the couplings, so its
    data stacks on the batch axis; every sweep's energies are in
    ``energies``."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    skel = uniform_skeleton_mps(N, chi, dtype=torch.float32, device=device)
    data = random_data_batch(skel, B, seed=seed, device=device)
    Jzs = rng.uniform(0.5, 1.5, size=B)
    mpos = [u1_xxz_mpo(float(jz), 1.0, 0.0, N, dtype=torch.float32,
                       device=device) for jz in Jzs]
    mpo_data = [torch.stack([mpos[b][i].data for b in range(B)])
                for i in range(N)]
    dmrg = BatchedSymmetricDMRG(skel, data, mpos[0], mpo_data=mpo_data,
                                num_krylov_vecs=10)
    dmrg.run_one_site(num_sweeps=num_sweeps, verbose=verbose)
    return dmrg


def main(N: int = 12, chi: int = 64, B: int = 16, num_sweeps: int = 6,
         seed: int = 0, verbose: int = 1, device: Optional[Device] = None):
    """:func:`solve`; returns the (B,) energies of the last sweep."""
    t0 = time.perf_counter()
    es = solve(N, chi, B, num_sweeps, seed, verbose, device).energies[-1]
    dt = time.perf_counter() - t0
    if verbose:
        print(f"\n{B} realizations x {num_sweeps} sweeps in {dt:.1f} s")
        print(f"disorder-averaged E: {es.mean():.6f} +- {es.std():.6f}")
        print(f"per-realization: {np.array2string(es, precision=4)}")
    return es


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--N", type=int, default=12)
    p.add_argument("--chi", type=int, default=64)
    p.add_argument("--B", type=int, default=16)
    p.add_argument("--sweeps", type=int, default=6)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    main(args.N, args.chi, args.B, args.sweeps,
         device="cpu" if args.cpu else None)
