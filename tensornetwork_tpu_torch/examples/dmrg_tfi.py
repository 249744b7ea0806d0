"""One-site DMRG on the transverse-field Ising chain: the headline sweep
workload, on the port (counterpart of ``examples/dmrg_tfi.py``).  At
chi=64 in float32 on the card the local solve is K2, the fused Lanczos
(``csrc/fused_lanczos.cu``), on its resident tier.

    python -m tensornetwork_tpu_torch.examples.dmrg_tfi [--cpu]
"""
import argparse
import time
from typing import Optional

import torch

from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.models import FiniteDMRG, FiniteTFI
from tensornetwork_tpu_torch.models.dmrg import random_mps_stack


def main(N=32, chi=64, sweeps=6, device: Optional[Device] = None,
         dtype: torch.dtype = torch.float32):
    """``sweeps`` one-site sweeps of the TFI chain (Jx = Bz = 1) from a
    random MPS (a generator seeded 0 on ``device``); returns the last
    sweep's energy.  The JAX example computes in float64 under x64 and in
    float32 on the TPU; here ``dtype`` says which."""
    device = default_device(device)
    mpo = FiniteTFI(Jx=1.0, Bz=1.0, N=N, dtype=dtype, device=device)
    mps = random_mps_stack(torch.Generator(device=device).manual_seed(0), N,
                           chi, dtype=dtype)
    dmrg = FiniteDMRG(mps, mpo)
    t0 = time.perf_counter()
    e = dmrg.run_one_site(num_sweeps=sweeps, num_krylov_vecs=10, verbose=1)
    dt = time.perf_counter() - t0
    print(f"E = {e:.12f}  ({sweeps} sweeps in {dt:.2f}s)")
    return e


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    main(device="cpu" if ap.parse_args().cpu else None)
