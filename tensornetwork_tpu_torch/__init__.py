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
(``models.mera``); and the library's contraction surface: ``ncon``
(``ops.ncon``, a host-compiled plan replayed eagerly), the contraction-path
solvers (``ops.paths``: optimal, greedy and branch written in the port, and
an exact subset-DP solver in C++, ``native/``, built by g++ at first
use), the Node/Edge graph core (``core``: nodes, edges, contraction,
splitting, JSON in the JAX package's format), the ``Tensor`` API and its
linear algebra, the contractors (``contractors``) and the ``Config``
stack; and the block-sparse U(1)/Z_N tensors (``blocksparse``: host charge
algebra, the per-sector loop and the bucketed batched executor) with
U(1)-symmetric DMRG, single (``SymmetricFiniteDMRG``) and batched over
disorder realizations (``BatchedSymmetricDMRG``), whose products are
cuBLAS GEMMs, since the JAX package's block-sparse path reaches no Pallas
kernel; and the application layer: the tensor-network NN layers as
``torch.nn.Module`` subclasses (``nn``; the ``tn_keras`` classifier in
``benchmarks.tn_classifier``), the lazy quantum operators (``quantum``)
and the utils (``utils``: HDF5 snapshots, checkpoints, profiling,
topology strings, graphviz), where no kernel runs either.  The
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
from tensornetwork_tpu_torch.config import (
    Config, DefaultBackend, config_context, default_device,
    enable_persistent_compilation_cache, get_config, get_default_backend,
    highest_precision, set_default_backend)
from tensornetwork_tpu_torch.ops.ncon import finalize, ncon
from tensornetwork_tpu_torch.ops import krylov
from tensornetwork_tpu_torch.ops.decompositions import (
    MaskedSVD, eigh, rq, svd, tensor_qr as qr)
# the graph core (reference ``network_components.py`` /
# ``network_operations.py``)
from tensornetwork_tpu_torch.core.network import (
    AbstractNode, CopyNode, Edge, Node, NodeCollection, connect,
    contract, contract_between, contract_copy_node, contract_parallel,
    disconnect, flatten_all_edges, flatten_edges, flatten_edges_between,
    get_all_dangling, get_all_edges, get_all_nondangling, get_neighbors,
    get_parallel_edges, get_shared_edges, outer_product,
    outer_product_final_nodes, slice_edge, split_edge)
from tensornetwork_tpu_torch.core.operations import (
    check_connected, check_correct, contract_trace_edges, copy,
    get_all_nodes, get_subgraph_dangling, nodes_from_json, nodes_to_json,
    reachable, redirect_edge, reduced_density, remove_node,
    replicate_nodes, split_node, split_node_full_svd, split_node_qr,
    split_node_rq, switch_backend)
from tensornetwork_tpu_torch import contractors
# the functional layer (reference ``tensor.py`` / ``linalg/``)
from tensornetwork_tpu_torch.core.tensor import NconBuilder, Tensor
from tensornetwork_tpu_torch.core import linalg, node_linalg
from tensornetwork_tpu_torch.core.linalg import (
    abs, conj, cos, diagflat, diagonal, eigs, eigsh_lanczos, einsum, exp,
    expm, eye, gmres, hconj, inv, kron, log, norm, ones, outer, pivot,
    randn, random_uniform, reshape, shape, sign, sin, sqrt, take_slice,
    tensordot, trace, transpose, zeros)
from tensornetwork_tpu_torch.models.dmrg import (FiniteDMRG, SweepResult,
                                                 one_site_sweep,
                                                 random_mps_stack,
                                                 two_site_sweep)
from tensornetwork_tpu_torch.models import mera, tebd
from tensornetwork_tpu_torch.models.infinite_mps import InfiniteMPS
from tensornetwork_tpu_torch.models.mpo import (MPO, BaseMPO,
                                               FiniteFreeFermion2D,
                                               FiniteMPO, FiniteTFI,
                                               FiniteXXZ, InfiniteMPO,
                                               mpo_to_dense)
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
# block-sparse symmetric tensors (reference ``block_sparse/``)
from tensornetwork_tpu_torch import blocksparse
block_sparse = blocksparse  # reference module name alias
from tensornetwork_tpu_torch.blocksparse import (
    BaseCharge, BlockSparseTensor, ChargeArray, Index, U1Charge, Z2Charge,
    ZNCharge)
from tensornetwork_tpu_torch.models.symmetric_dmrg import (
    SymmetricFiniteDMRG, half_filled_mps, u1_xxz_mpo)
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)
# quantum operators (reference ``quantum/``) and the utils
from tensornetwork_tpu_torch import models, quantum
from tensornetwork_tpu_torch.utils import (from_topology, load_nodes,
                                           save_nodes, to_graphviz)


def jit(fun=None, backend=None, backend_argnum=None, static_argnums=None,
        **kwargs):
    """Reference-compatible jit decorator (reference
    ``backends/decorators.py:26-89``): the arguments are accepted and the
    function comes back unchanged, since the port runs eagerly -- the
    reference's own behaviour on its numpy backend."""
    if fun is None:
        return lambda f: f
    return fun


__version__ = "0.1.0"
