"""PyTorch/CUDA port of :mod:`tensornetwork_tpu`, one slice at a time.

Ported so far: one- and two-site DMRG, single instance and batched.  The
local solve is a ladder of tiers by bond dimension (resident, two-pass,
streamed, streamed matvec, XL streamed matvec), each on kernels written in
CUDA for Hopper (``csrc/``); the one-site gauge shift and environment
growth may run as one fused kernel (``epilogue_impl="fused"``); two-site
bonds are truncated by the masked SVD or the matmul-only subspace
iteration.  Beside DMRG: the batched MPS transfer chain
(``ops.kernels.transfer_chain``) and the chained-GEMM probe
(``benchmarks.mxu_micro``), each on its own kernel.  The package imports torch, numpy
and ctypes, never JAX.  Entry points run on the CUDA card unless handed
CPU tensors or ``device="cpu"``.
"""
from tensornetwork_tpu_torch import config, interop
from tensornetwork_tpu_torch.config import default_device, highest_precision
from tensornetwork_tpu_torch.models.dmrg import (FiniteDMRG, SweepResult,
                                                 one_site_sweep,
                                                 random_mps_stack,
                                                 two_site_sweep)
from tensornetwork_tpu_torch.models.mpo import MPO, FiniteTFI, mpo_to_dense
from tensornetwork_tpu_torch.ops.decompositions import (subspace_truncate,
                                                        svd_masked)
from tensornetwork_tpu_torch.parallel.batch import (BatchedDMRG,
                                                    batched_one_site_sweep,
                                                    batched_two_site_sweep)
