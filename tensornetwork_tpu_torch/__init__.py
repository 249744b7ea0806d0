"""PyTorch/CUDA port of :mod:`tensornetwork_tpu`, one slice at a time.

This slice: one-site DMRG, single instance and batched, with the
fused-Lanczos and H_eff matvec kernels written in CUDA for Hopper
(``csrc/``).  The package imports torch, numpy and ctypes, never JAX.
Entry points run on the CUDA card unless handed CPU tensors or
``device="cpu"``.
"""
from tensornetwork_tpu_torch import config, interop
from tensornetwork_tpu_torch.config import default_device, highest_precision
from tensornetwork_tpu_torch.models.dmrg import (FiniteDMRG, SweepResult,
                                                 one_site_sweep,
                                                 random_mps_stack)
from tensornetwork_tpu_torch.models.mpo import MPO, FiniteTFI, mpo_to_dense
from tensornetwork_tpu_torch.parallel.batch import (BatchedDMRG,
                                                    batched_one_site_sweep)
