"""Trotterized real-time evolution: the exact state against TEBD on an
MPS, on the port (counterpart of ``examples/wavefunctions.py``;
reference analog: ``examples/wavefunctions``).

    python -m tensornetwork_tpu_torch.examples.wavefunctions [--cpu]
"""
import argparse
from typing import Optional

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.models import FiniteMPS, tebd


def main(N=8, dt=0.02, steps=25, device: Optional[Device] = None):
    """The TFI quench (H = -sum XX - 1/2 sum Z) of the all-up state by
    ``steps`` Trotter steps of the dense state and of a chi=16 MPS, in
    float64 / complex128; returns their fidelity."""
    device = default_device(device)
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    I = np.eye(2)
    h2 = -np.kron(X, X) - 0.5 * (np.kron(Z, I) + np.kron(I, Z))
    psi0 = np.zeros((2,) * N)
    psi0[(0,) * N] = 1.0
    psi_t = tebd.evolve_exact(torch.as_tensor(psi0, device=device), h2, dt,
                              steps)

    chi = 16
    As = np.zeros((N, chi, 2, chi))
    As[:, 0, 0, 0] = 1.0
    mps = FiniteMPS(torch.as_tensor(As, device=device), canonicalize=False)
    tebd.evolve_mps(mps, h2, dt, steps, max_singular_values=chi)
    blk = mps.to_dense()[0, ..., 0]
    blk = blk / torch.linalg.vector_norm(blk)
    fid = abs(complex(torch.vdot(blk.reshape(-1), psi_t.reshape(-1))))
    print(f"TEBD vs exact fidelity after t={dt * steps:.2f}: {fid:.6f}")
    return fid


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    main(device="cpu" if ap.parse_args().cpu else None)
