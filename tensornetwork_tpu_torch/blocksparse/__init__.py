"""Block-sparse U(1)/Z_N symmetric tensors (counterpart of
:mod:`tensornetwork_tpu.blocksparse`): host charge algebra in numpy, data
as 1-D torch tensors on an explicit device; the per-sector loop
(:func:`tensordot`), the bucketed executor
(:mod:`~tensornetwork_tpu_torch.blocksparse.torch_engine`) and the
batched-realization plans
(:mod:`~tensornetwork_tpu_torch.blocksparse.batched`).
"""
from tensornetwork_tpu_torch.blocksparse.charge import (
    BaseCharge, U1Charge, Z2Charge, ZNCharge, fuse_charges, charge_equal,
    fuse_ndarrays, fuse_degeneracies)
from tensornetwork_tpu_torch.blocksparse.index import Index, fuse_index_pair
from tensornetwork_tpu_torch.blocksparse.tensor import (
    ChargeArray, BlockSparseTensor, tensordot, outerproduct, transpose,
    reshape, conj)
from tensornetwork_tpu_torch.blocksparse.linalg import (
    svd, qr, eigh, eig, diag, trace, pinv, eye, norm, inv, sqrt,
    abs, sign)
from tensornetwork_tpu_torch.blocksparse.initialization import (
    randn, zeros, ones, random, randn_like, empty_like)
from tensornetwork_tpu_torch.blocksparse.caching import (
    enable_caching, disable_caching, clear_cache, get_cacher)
from tensornetwork_tpu_torch.blocksparse.batched import (
    canonical_bond_charges, uniform_skeleton_mps, random_data_batch,
    contraction_plan, ShiftPlan)
