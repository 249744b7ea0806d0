"""Scale-invariant binary MERA for the critical Ising model, on the port
(counterpart of ``examples/simple_mera.py``; reference analog:
``examples/simple_mera/simple_mera.py``).

    python -m tensornetwork_tpu_torch.examples.simple_mera [--cpu]
"""
import argparse
from typing import Optional

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.models import mera


def main(num_layers=3, iterations=120, device: Optional[Device] = None):
    """chi=4 MERA of ``num_layers`` layers optimised for ``iterations``
    sweeps in float64; returns the energy per spin (exact: -4/pi)."""
    device = default_device(device)
    h3 = mera.blocked_ising_hamiltonian(dtype=torch.float64, device=device)
    state = mera.initialize_mera(4, num_layers=num_layers,
                                 dtype=torch.float64, device=device)
    state, e = mera.optimize_mera(h3, state, num_iterations=iterations)
    per_spin = e / 2.0
    print(f"MERA E/spin = {per_spin:.6f}  (exact -4/pi = "
          f"{-4 / np.pi:.6f})")
    return per_spin


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    main(device="cpu" if ap.parse_args().cpu else None)
