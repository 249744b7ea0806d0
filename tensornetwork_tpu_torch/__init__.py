"""PyTorch/CUDA port of :mod:`tensornetwork_tpu`, one slice at a time.

Ported so far: one- and two-site DMRG, single instance and batched, and
TDVP time evolution (``models.tdvp``; batched real-time quenches in
``parallel.batch``), whose local evolutions run K2, the fused Lanczos, on
realified complex operands; and the infinite chain (``models.vumps``):
VUMPS ground states, whose AC and C solves run K2, iTDVP, and the
transfer-matrix correlation length on the restarted Arnoldi of
``ops.krylov``; and the MPS object layer: ``FiniteMPS`` (canonical forms,
measurements, gates; ``FiniteDMRG`` and ``TDVP`` take it and write their
result back), TEBD (``models.tebd``), ``InfiniteMPS`` and the binary MERA
(``models.mera``).  The
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
from tensornetwork_tpu_torch.models import mera, tebd
from tensornetwork_tpu_torch.models.infinite_mps import InfiniteMPS
from tensornetwork_tpu_torch.models.mpo import (MPO, FiniteFreeFermion2D,
                                               FiniteTFI, FiniteXXZ,
                                               InfiniteMPO, mpo_to_dense)
from tensornetwork_tpu_torch.models.mps import FiniteMPS
from tensornetwork_tpu_torch.models.tdvp import (TDVP, tdvp_one_site_sweep,
                                                 tdvp_one_site_sweep_sc,
                                                 tdvp_two_site_sweep,
                                                 tdvp_two_site_sweep_sc)
from tensornetwork_tpu_torch.models.vumps import (VUMPSResult, VUMPSState,
                                                  correlation_length, itdvp,
                                                  vumps, vumps_iteration)
from tensornetwork_tpu_torch.ops.decompositions import (ns_polar_express,
                                                        polar_complete,
                                                        subspace_truncate,
                                                        svd_masked)
from tensornetwork_tpu_torch.parallel.batch import (
    BatchedDMRG, batched_one_site_sweep, batched_one_site_sweep_paired,
    batched_tdvp_one_site_sweep_sc, batched_two_site_sweep,
    batched_two_site_sweep_paired)
