"""Linear algebra on block-sparse tensors.

Counterpart of :mod:`tensornetwork_tpu.blocksparse.linalg` (reference
``block_sparse/linalg.py:35-704``): per-charge-sector decompositions with
*global* cross-block singular-value truncation (reference
``backends/symmetric/decompositions.py:70-120``), diag/trace/pinv/eye.
Each sector is factored on the data's device: the SVD through
:func:`decompositions.thin_svd` (cuSOLVER's gesvd on the card, whose f32
vectors are orthonormal to working precision), QR and ``eigh`` through
:func:`decompositions.lapack_factor` (complex64 CPU panels in
complex128).  The ranking of the truncation runs on the host.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.charge import BaseCharge
from tensornetwork_tpu_torch.blocksparse.index import Index
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, ChargeArray, _col_indices_per_sector,
    compute_num_nonzero, device_index, find_diagonal_blocks, torch_dtype)
from tensornetwork_tpu_torch.config import DEFAULT_DTYPE, Device
from tensornetwork_tpu_torch.ops.decompositions import (lapack_factor,
                                                        thin_svd)


def _matrix_partition(t: BlockSparseTensor) -> int:
    if t.ndim != 2:
        raise ValueError(f"expected a rank-2 tensor, got rank {t.ndim}")
    return len(t._order[0])


def _bond_index(sectors: BaseCharge, ks: Sequence[int],
                flow: bool) -> Tuple[BaseCharge, Index]:
    reps = np.repeat(np.arange(sectors.dim), np.asarray(ks, dtype=np.int64))
    bond_charges = BaseCharge(sectors.charges[reps], sectors.charge_types)
    return bond_charges, Index(bond_charges, flow)


def _scatter(blocks: List[torch.Tensor], sectors: BaseCharge, charges,
             flows, order, partition: int, dtype, device
             ) -> BlockSparseTensor:
    """The tensor of the given structure whose sector of charge
    ``sectors[i]`` holds ``blocks[i]`` (zeros elsewhere)."""
    nnz = compute_num_nonzero(charges, flows)
    data = torch.zeros(nnz, dtype=dtype, device=device)
    common, maps, _ = find_diagonal_blocks(charges, flows, partition)
    _, io, isec = common.intersect(sectors, return_indices=True)
    for t in range(len(io)):
        data[device_index(maps[io[t]], device)] = blocks[isec[t]].to(dtype)
    return BlockSparseTensor(data, charges, flows, order)


def _scatter_matrix(blocks, sectors, row_charges, row_flows,
                    row_order_len: int, bond_charges: BaseCharge,
                    bond_flow: bool, dtype, device) -> BlockSparseTensor:
    """Build the (rows..., bond) tensor from per-sector blocks."""
    return _scatter(blocks, sectors, list(row_charges) + [bond_charges],
                    list(row_flows) + [bond_flow],
                    [list(range(row_order_len)), [row_order_len]],
                    row_order_len, dtype, device)


def _scatter_matrix_left_bond(blocks, sectors, bond_charges: BaseCharge,
                              bond_flow: bool, col_charges, col_flows,
                              dtype, device) -> BlockSparseTensor:
    """Build the (bond, cols...) tensor from per-sector blocks."""
    return _scatter(blocks, sectors, [bond_charges] + list(col_charges),
                    [bond_flow] + list(col_flows),
                    [[0], list(range(1, 1 + len(col_charges)))], 1, dtype,
                    device)


def _get_blocks(t: BlockSparseTensor):
    p = _matrix_partition(t)
    common, maps, shapes = find_diagonal_blocks(t._charges, t._flows, p)
    blocks = [t.data[device_index(m, t.device)] for m in maps]
    return p, common, maps, shapes, blocks


def _cat(parts: List[torch.Tensor], dtype, device) -> torch.Tensor:
    return torch.cat(parts) if parts else torch.zeros(0, dtype=dtype,
                                                      device=device)


def _factors(matrix, p, common, us, ss, vs, ks):
    """(U, S, V) of per-sector factors: U (rows..., bond), S over the bond,
    V (bond, cols...)."""
    dev = matrix.device
    bond_charges, _ = _bond_index(common, ks, True)
    S = ChargeArray(_cat(ss, matrix.dtype.to_real(), dev), [bond_charges],
                    [False])
    U = _scatter_matrix(us, common, matrix._charges[:p], matrix._flows[:p],
                        p, bond_charges, True, matrix.dtype, dev)
    V = _scatter_matrix_left_bond(
        vs, common, BaseCharge(bond_charges.charges,
                               bond_charges.charge_types),
        False, matrix._charges[p:], matrix._flows[p:], matrix.dtype, dev)
    return U, S, V


def svd(matrix: BlockSparseTensor, full_matrices: bool = False,
        compute_uv: bool = True, hermitian: bool = False):
    """Per-sector SVD.  Returns ``(U, S, V)`` with ``S`` a rank-1
    :class:`ChargeArray` over the new bond (reference
    ``block_sparse/linalg.py:183``)."""
    if full_matrices:
        raise NotImplementedError(
            "full_matrices=True is not supported for block-sparse svd")
    p, common, maps, shapes, blocks = _get_blocks(matrix)
    us, ss, vs, ks = [], [], [], []
    for b in blocks:
        u, s, vh = thin_svd(b)
        us.append(u); ss.append(s); vs.append(vh)
        ks.append(min(b.shape))
    if not compute_uv:
        bond_charges, _ = _bond_index(common, ks, True)
        return ChargeArray(_cat(ss, matrix.dtype.to_real(), matrix.device),
                           [bond_charges], [False])
    return _factors(matrix, p, common, us, ss, vs, ks)


def truncated_svd(matrix: BlockSparseTensor,
                  max_singular_values: Optional[int] = None,
                  max_truncation_error: Optional[float] = None,
                  relative: bool = False):
    """SVD with *global* cross-sector truncation: all sectors' singular
    values are ranked together (on the host) and the weakest discarded
    (reference ``backends/symmetric/decompositions.py:27-130``).

    Returns ``(U, S, V, s_rest)`` with ``s_rest`` the discarded values
    (descending), a tensor on the data's device."""
    p, common, maps, shapes, blocks = _get_blocks(matrix)
    us, ss, vs = [], [], []
    for b in blocks:
        u, s, vh = thin_svd(b)
        us.append(u); ss.append(s); vs.append(vh)
    dev = matrix.device
    all_s_t = _cat(ss, matrix.dtype.to_real(), dev)
    all_s = all_s_t.cpu().numpy()
    order = np.argsort(all_s)[::-1]
    sorted_s = all_s[order]
    keep = sorted_s.shape[0]
    if max_truncation_error is not None:
        err = float(max_truncation_error)
        if relative and sorted_s.size:
            err *= float(sorted_s[0])
        tail = np.sqrt(np.cumsum(sorted_s[::-1] ** 2))
        num_discard = int(np.searchsorted(tail, err, side="right"))
        keep -= num_discard
    if max_singular_values is not None:
        keep = min(keep, int(max_singular_values))
    keep = max(keep, 0)
    kept_mask = np.zeros(all_s.shape[0], dtype=bool)
    kept_mask[order[:keep]] = True
    s_rest = all_s_t[device_index(order[keep:], dev)]
    # per-sector keep counts
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in ss])])
    new_us, new_ss, new_vs, ks = [], [], [], []
    for i in range(len(ss)):
        m = device_index(np.nonzero(kept_mask[offsets[i]:offsets[i + 1]])[0],
                         dev)
        ks.append(int(m.shape[0]))
        new_us.append(us[i][:, m])
        new_ss.append(ss[i][m])
        new_vs.append(vs[i][m, :])
    U, S, V = _factors(matrix, p, common, new_us, new_ss, new_vs, ks)
    return U, S, V, s_rest


def qr(matrix: BlockSparseTensor, mode: str = "reduced"):
    """(reference ``block_sparse/linalg.py:300``)"""
    if mode not in ("reduced", "complete"):
        raise ValueError(f"unsupported mode {mode!r}")
    p, common, maps, shapes, blocks = _get_blocks(matrix)
    qs, rs, ks = [], [], []
    for b in blocks:
        q, r = lapack_factor(functools.partial(torch.linalg.qr, mode=mode),
                             b)
        qs.append(q); rs.append(r)
        ks.append(q.shape[1])
    dev = matrix.device
    bond_charges, _ = _bond_index(common, ks, True)
    Q = _scatter_matrix(qs, common, matrix._charges[:p], matrix._flows[:p],
                        p, bond_charges, True, matrix.dtype, dev)
    R = _scatter_matrix_left_bond(
        rs, common, BaseCharge(bond_charges.charges,
                               bond_charges.charge_types),
        False, matrix._charges[p:], matrix._flows[p:], matrix.dtype, dev)
    return Q, R


def eigh(matrix: BlockSparseTensor):
    """(reference ``block_sparse/linalg.py:395``)"""
    p, common, maps, shapes, blocks = _get_blocks(matrix)
    es, vs, ks = [], [], []
    for b in blocks:
        e, v = lapack_factor(torch.linalg.eigh, b)
        es.append(e); vs.append(v); ks.append(e.shape[0])
    dev = matrix.device
    bond_charges, _ = _bond_index(common, ks, True)
    E = ChargeArray(_cat(es, matrix.dtype.to_real(), dev), [bond_charges],
                    [False])
    V = _scatter_matrix(vs, common, matrix._charges[:p], matrix._flows[:p],
                        p, bond_charges, True, matrix.dtype, dev)
    return E, V


def eig(matrix: BlockSparseTensor):
    """(reference ``block_sparse/linalg.py:454``)"""
    p, common, maps, shapes, blocks = _get_blocks(matrix)
    es, vs, ks = [], [], []
    for b in blocks:
        e, v = lapack_factor(torch.linalg.eig, b)
        es.append(e); vs.append(v); ks.append(e.shape[0])
    dev = matrix.device
    cdtype = torch.promote_types(matrix.dtype, torch.complex64)
    bond_charges, _ = _bond_index(common, ks, True)
    E = ChargeArray(_cat(es, cdtype, dev), [bond_charges], [False])
    V = _scatter_matrix(vs, common, matrix._charges[:p], matrix._flows[:p],
                        p, bond_charges, True, cdtype, dev)
    return E, V


def _diagonal_positions(bm: np.ndarray) -> np.ndarray:
    n = min(bm.shape)
    return bm[np.arange(n), np.arange(n)]


def diag(x):
    """ChargeArray -> diagonal matrix; rank-2 tensor -> diagonal
    (reference ``block_sparse/linalg.py:35``)."""
    if isinstance(x, ChargeArray) and x.ndim == 1:
        charges = x.flat_charges[0]
        flow = x.flat_flows[0]
        mat_charges = [charges, charges]
        mat_flows = [flow, not flow]
        dev = x.device
        nnz = compute_num_nonzero(mat_charges, mat_flows)
        data = torch.zeros(nnz, dtype=x.dtype, device=dev)
        common, maps, shapes = find_diagonal_blocks(mat_charges, mat_flows,
                                                    1)
        _, rows, cols = _col_indices_per_sector(mat_charges, mat_flows, 1)
        for bm, r_idx in zip(maps, rows):
            n = min(bm.shape)
            data[device_index(_diagonal_positions(bm), dev)] = \
                x.data[device_index(r_idx[:n], dev)]
        return BlockSparseTensor(data, mat_charges, mat_flows, [[0], [1]])
    if isinstance(x, BlockSparseTensor) and x.ndim == 2:
        p = _matrix_partition(x)
        common, maps, shapes = find_diagonal_blocks(x._charges, x._flows, p)
        datas, sec_charges = [], []
        for s, bm in enumerate(maps):
            # the block diagonal (the dense diagonal is only meaningful
            # for square matricizations)
            n = min(bm.shape)
            datas.append(x.data[device_index(_diagonal_positions(bm),
                                             x.device)])
            sec_charges.append(np.repeat(common.charges[s][None, :], n,
                                         axis=0))
        charges = BaseCharge(
            np.concatenate(sec_charges, axis=0) if sec_charges
            else np.zeros((0, x._charges[0].num_symmetries), dtype=np.int64),
            x._charges[0].charge_types)
        return ChargeArray(_cat(datas, x.dtype, x.device), [charges],
                           [x._flows[0]])
    raise TypeError("diag expects a rank-1 ChargeArray or rank-2 "
                    "BlockSparseTensor")


def trace(matrix: BlockSparseTensor, axes=None):
    """Trace over two legs (reference ``block_sparse/linalg.py:595``).

    For a matrix (``ndim == 2``) returns the scalar trace as a 0-d tensor.
    For higher-rank tensors returns the partially-traced
    ``BlockSparseTensor`` over the given axis pair (default: the last
    two), a contraction against a block-sparse identity as in the
    reference."""
    if matrix.ndim != 2:
        return trace_axes(matrix, axes)
    if axes is not None:
        ax = sorted(a % matrix.ndim for a in axes)
        if ax != [0, 1]:
            raise ValueError(f"invalid trace axes {axes} for a matrix")
    p = _matrix_partition(matrix)
    common, maps, shapes = find_diagonal_blocks(matrix._charges,
                                                matrix._flows, p)
    _, rows, cols = _col_indices_per_sector(matrix._charges, matrix._flows,
                                            p)
    total = torch.zeros((), dtype=matrix.dtype, device=matrix.device)
    for bm, r_idx, c_idx in zip(maps, rows, cols):
        # positions where the dense row index equals the dense col index
        common_idx, ri, ci = np.intersect1d(r_idx, c_idx,
                                            return_indices=True)
        if len(common_idx):
            total = total + torch.sum(
                matrix.data[device_index(bm[ri, ci], matrix.device)])
    return total


def trace_axes(tensor: BlockSparseTensor, axes=None) -> BlockSparseTensor:
    """Partial trace over one axis pair of a rank-n tensor (reference
    ``block_sparse/linalg.py:595-644``, which likewise contracts against a
    block-sparse identity)."""
    from tensornetwork_tpu_torch.blocksparse.tensor import tensordot as _td
    if axes is None:
        axes = (tensor.ndim - 2, tensor.ndim - 1)
    if len(axes) != 2:
        raise ValueError(f"`len(axes)` has to be 2, found `axes = {axes}`")
    ax1, ax2 = (a % tensor.ndim for a in axes)
    if ax1 == ax2:
        raise ValueError(f"trace axes must differ, got {axes}")
    idx = tensor.sparse_shape[ax1]
    ident = eye(idx.flip_flow(), dtype=tensor.dtype, device=tensor.device)
    return _td(tensor, ident, [[ax1, ax2], [0, 1]])


def inv(matrix: BlockSparseTensor) -> BlockSparseTensor:
    """(reference ``block_sparse/linalg.py``)"""
    return _apply_blockwise(matrix, torch.linalg.inv, transpose_structure=True)


def pinv(matrix: BlockSparseTensor, rcond: float = 1e-15
         ) -> BlockSparseTensor:
    """(reference ``block_sparse/linalg.py:660``); ``rcond`` is numpy's:
    singular values below ``rcond`` times the largest count as zero."""
    return _apply_blockwise(matrix,
                            lambda b: torch.linalg.pinv(b, rtol=rcond),
                            transpose_structure=True)


def _apply_blockwise(matrix, fn, transpose_structure=False):
    p, common, maps, shapes, blocks = _get_blocks(matrix)
    dev = matrix.device
    if transpose_structure:
        # the (pseudo)inverse maps the other way: legs (cols..., rows...)
        # with all flows flipped, so inv(A) @ A contracts legally; flipping
        # the col side's flows makes its fused charge the original sector
        # charge, so sectors match directly
        n_col = len(matrix._charges) - p
        out_charges = matrix._charges[p:] + matrix._charges[:p]
        out_flows = ([not f for f in matrix._flows[p:]]
                     + [not f for f in matrix._flows[:p]])
        out_order = [list(range(n_col)),
                     list(range(n_col, len(out_charges)))]
        return _scatter([fn(b) for b in blocks], common, out_charges,
                        out_flows, out_order, n_col, matrix.dtype, dev)
    data = torch.zeros_like(matrix.data)
    for s, b in enumerate(blocks):
        data[device_index(maps[s], dev)] = fn(b)
    return matrix._like(data)


def sqrt(t: BlockSparseTensor) -> BlockSparseTensor:
    return t._like(torch.sqrt(t.data))


def norm(t: BlockSparseTensor) -> float:
    """(reference ``block_sparse/linalg.py``)"""
    return float(torch.linalg.vector_norm(t.data))


def abs(tensor: BlockSparseTensor) -> BlockSparseTensor:  # noqa: A001
    """Elementwise absolute value (reference
    ``block_sparse/linalg.py:696``)."""
    return tensor._like(torch.abs(tensor.data))


def sign(tensor: BlockSparseTensor) -> BlockSparseTensor:
    """Elementwise sign (reference ``block_sparse/linalg.py:701``)."""
    return tensor._like(torch.sgn(tensor.data))


def eye(column_index: Index, row_index: Optional[Index] = None,
        dtype=DEFAULT_DTYPE, device: Optional[Device] = None
        ) -> BlockSparseTensor:
    """Identity matrix with legs (column_index, dual) (reference
    ``block_sparse/linalg.py:557``), on ``device`` (default: the card)."""
    from tensornetwork_tpu_torch.config import default_device
    if row_index is None:
        row_index = column_index.flip_flow()
    charges = column_index.flat_charges + row_index.flat_charges
    flows = column_index.flat_flows + row_index.flat_flows
    p = len(column_index.flat_charges)
    order = [list(range(p)), list(range(p, len(charges)))]
    dev = default_device(device)
    nnz = compute_num_nonzero(charges, flows)
    data = torch.zeros(nnz, dtype=torch_dtype(dtype), device=dev)
    common, maps, shapes = find_diagonal_blocks(charges, flows, p)
    for bm in maps:
        data[device_index(_diagonal_positions(bm), dev)] = 1.0
    return BlockSparseTensor(data, charges, flows, order)
