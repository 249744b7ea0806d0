"""U(1)-symmetric two-site DMRG on the XXZ chain, on the port
(counterpart of ``examples/symmetric_dmrg.py``; reference analog:
``examples/dmrg/symmetric_dmrg.py``).

    python -m tensornetwork_tpu_torch.examples.symmetric_dmrg [--cpu]
"""
import argparse
from typing import Optional

from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.models.symmetric_dmrg import (
    SymmetricFiniteDMRG, half_filled_mps, u1_xxz_mpo)


def solve(N=16, chi=32, sweeps=6, device: Optional[Device] = None,
          verbose: int = 1) -> SymmetricFiniteDMRG:
    """The solver after ``sweeps`` two-site sweeps of the half-filled XXZ
    chain (Jz = Jxy = 1) from the seed-0 random MPS, float64 (every
    sweep's energy in its ``energies``)."""
    device = default_device(device)
    mpo = u1_xxz_mpo(Jz=1.0, Jxy=1.0, Bz=0.0, N=N, device=device)
    mps = half_filled_mps(N, chi, seed=0, device=device)
    dmrg = SymmetricFiniteDMRG(mps, mpo)
    dmrg.run_two_site(max_bond_dim=chi, num_sweeps=sweeps,
                      num_krylov_vecs=20, verbose=verbose)
    return dmrg


def main(N=16, chi=32, sweeps=6, device: Optional[Device] = None):
    """:func:`solve`; returns the last sweep's energy."""
    e = solve(N, chi, sweeps, device).energies[-1]
    print(f"U(1) XXZ N={N} chi={chi}: E = {e:.12f}")
    return e


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    main(device="cpu" if ap.parse_args().cpu else None)
