"""Block-sparse symmetric tensors.

Counterpart of :mod:`tensornetwork_tpu.blocksparse.tensor` (reference
``block_sparse/blocksparsetensor.py:35-1101`` and the block-lookup
machinery ``block_sparse/blocksparse_utils.py:80-634``).

Data layout: ``data`` holds the charge-conserving (total charge zero)
entries of the dense tensor in dense row-major order.  For any bipartition
of the legs the nonzeros of one dense row are contiguous and belong to a
single charge sector, so each sector forms a dense matrix addressed by an
index map computed from per-side charge fusion only (never full dense
enumeration) -- the same scheme as the reference's
``_find_diagonal_sparse_blocks`` (``blocksparse_utils.py:330``).

The metadata stays on the host as numpy, as in the JAX package: charges,
flows, leg groups, the sector lookup (:func:`find_diagonal_blocks`) and
the stored entries' dense coordinates.  ``data`` is a 1-D torch tensor on
an explicit device: a tensor keeps its device, anything else goes through
:func:`config.as_tensor` to the card unless ``device`` says otherwise.
Index maps go to the data's device when they are used.  Transposition is
eager (the data vector is permuted by a host-computed coordinate sort),
and :func:`tensordot` is the per-sector loop: one dense product per
common charge sector, the plain version of the bucketed executor in
:mod:`tensornetwork_tpu_torch.blocksparse.torch_engine`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.caching import get_cacher
from tensornetwork_tpu_torch.blocksparse.charge import (
    BaseCharge, charge_equal, fuse_charges)
from tensornetwork_tpu_torch.blocksparse.index import Index
from tensornetwork_tpu_torch.config import Device, as_tensor


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def device_index(arr: np.ndarray, device) -> torch.Tensor:
    """A host int64 index array as a long tensor on ``device`` (shared
    memory on the CPU, one copy to the card).  An int32 array (a plan read
    from a file) crosses as int32 and is widened where it lands."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.int32:
        arr = arr.astype(np.int64, copy=False)
    if any(s < 0 for s in arr.strides):
        # a view of < 2 entries may keep a negative stride: torch refuses it
        arr = arr.copy()
    t = torch.from_numpy(arr)
    t = t if torch.device(device).type == "cpu" else t.to(device)
    return t.long()


def is_blocksparse(t) -> bool:
    """Duck test for symmetric (block-sparse) operands, on which ``ncon``
    and the graph core dispatch (reference parity:
    ``tests/tensornetwork_symmetric_test.py``)."""
    return hasattr(t, "flat_charges") and hasattr(t, "todense")


def _is_scalar(x) -> bool:
    return np.isscalar(x) or (isinstance(x, torch.Tensor) and x.ndim == 0)


# ---------------------------------------------------------------------------
# Block lookup (host)
# ---------------------------------------------------------------------------


def _side_or_identity(charges, flows, like: BaseCharge) -> BaseCharge:
    if len(charges) == 0:
        return like.identity_charges(1)
    return fuse_charges(charges, flows)


def _lookup_key(charges: Sequence[BaseCharge], flows: Sequence[bool],
                partition: int):
    parts = [c.charges.tobytes() for c in charges]
    types = tuple(tuple(t.__name__ for t in c.charge_types)
                  for c in charges)
    return (tuple(parts), types, tuple(bool(f) for f in flows),
            int(partition))


def find_diagonal_blocks(
    charges: Sequence[BaseCharge], flows: Sequence[bool], partition: int,
) -> Tuple[BaseCharge, List[np.ndarray], List[Tuple[int, int]]]:
    """Sector decomposition of the (rows=[:p], cols=[p:]) matricization.

    Returns ``(sector_charges, block_maps, block_shapes)``: for each sector
    a (nr, nc) int64 array of positions into the flat data vector
    (reference ``_find_diagonal_sparse_blocks``,
    ``blocksparse_utils.py:330``)."""
    cacher = get_cacher()
    key = None
    if cacher.do_caching:
        key = _lookup_key(charges, flows, partition)
        hit = cacher.cache.get(key)
        if hit is not None:
            return hit
    if not len(charges):
        raise ValueError("rank-0 tensors have no blocks")
    ref = charges[0]
    row = _side_or_identity(list(charges[:partition]),
                            list(flows[:partition]), ref)
    col = _side_or_identity(list(charges[partition:]),
                            list(flows[partition:]), ref)
    # entry (i, j) is nonzero iff row[i] + col[j] == 0, i.e. the required
    # row charge for column j is dual(col[j])
    col_req = col.dual(True)
    u_row, row_labels, row_counts = row.unique(return_inverse=True,
                                               return_counts=True)
    u_col, col_labels, col_counts = col_req.unique(return_inverse=True,
                                                   return_counts=True)
    common, ia, ib = u_row.intersect(u_col, return_indices=True)
    row_labels = np.asarray(row_labels).reshape(-1)
    # run length of dense row i = degeneracy of its charge on the column
    # side (0 if the sector is absent there)
    col_deg_of_row_label = np.zeros(u_row.dim, dtype=np.int64)
    col_deg_of_row_label[ia] = col_counts[ib]
    run_lengths = col_deg_of_row_label[row_labels]
    starts = np.concatenate([[0], np.cumsum(run_lengths)[:-1]])
    block_maps: List[np.ndarray] = []
    block_shapes: List[Tuple[int, int]] = []
    for s in range(common.dim):
        rows_i = np.nonzero(row_labels == ia[s])[0]
        nc = int(col_counts[ib[s]])
        bm = starts[rows_i][:, None] + np.arange(nc, dtype=np.int64)[None, :]
        block_maps.append(bm)
        block_shapes.append((rows_i.shape[0], nc))
    result = (common, block_maps, block_shapes)
    if cacher.do_caching:
        cacher.cache[key] = result
    return result


def compute_num_nonzero(charges: Sequence[BaseCharge],
                        flows: Sequence[bool]) -> int:
    """(reference ``blocksparse_utils.py:188``): the sum over sectors of
    row count times column count, from the two sides' charge counts
    alone (no block maps)."""
    p = max(len(charges) // 2, 1) if len(charges) > 1 else 1
    ref = charges[0]
    row = _side_or_identity(list(charges[:p]), list(flows[:p]), ref)
    col = _side_or_identity(list(charges[p:]), list(flows[p:]), ref)
    u_row, row_counts = row.unique(return_counts=True)
    u_col, col_counts = col.dual(True).unique(return_counts=True)
    _, ia, ib = u_row.intersect(u_col, return_indices=True)
    return int(np.sum(row_counts[ia] * col_counts[ib]))


def _col_indices_per_sector(charges, flows, partition):
    """For each sector: the dense row indices (rows side) and dense column
    indices (cols side) of its block, in enumeration order."""
    ref = charges[0]
    row = _side_or_identity(list(charges[:partition]),
                            list(flows[:partition]), ref)
    col = _side_or_identity(list(charges[partition:]),
                            list(flows[partition:]), ref)
    col_req = col.dual(True)
    u_row, row_labels = row.unique(return_inverse=True)
    u_col, col_labels = col_req.unique(return_inverse=True)
    common, ia, ib = u_row.intersect(u_col, return_indices=True)
    row_labels = np.asarray(row_labels).reshape(-1)
    col_labels = np.asarray(col_labels).reshape(-1)
    rows, cols = [], []
    for s in range(common.dim):
        rows.append(np.nonzero(row_labels == ia[s])[0])
        cols.append(np.nonzero(col_labels == ib[s])[0])
    return common, rows, cols


def nonzero_dense_coords(charges: Sequence[BaseCharge],
                         flows: Sequence[bool]) -> np.ndarray:
    """(nnz, rank) dense multi-indices of the stored entries, in data
    order.  O(Dr + Dc + nnz) -- no full dense enumeration."""
    rank = len(charges)
    dims = [c.dim for c in charges]
    if rank == 1:
        fused = fuse_charges(list(charges), list(flows))
        idx = np.nonzero(np.all(fused.charges == 0, axis=1))[0]
        return idx[:, None]
    p = _balanced_partition(dims)
    common, block_maps, shapes = find_diagonal_blocks(charges, flows, p)
    _, rows, cols = _col_indices_per_sector(charges, flows, p)
    nnz = int(sum(r * c for (r, c) in shapes))
    coords = np.zeros((nnz, rank), dtype=np.int64)
    row_dims = dims[:p]
    col_dims = dims[p:]
    for bm, r_idx, c_idx in zip(block_maps, rows, cols):
        rc = np.array(np.unravel_index(r_idx, row_dims)).T  # (nr, p)
        cc = np.array(np.unravel_index(c_idx, col_dims)).T  # (nc, rank-p)
        nr, nc = rc.shape[0], cc.shape[0]
        full = np.concatenate(
            [np.repeat(rc, nc, axis=0), np.tile(cc, (nr, 1))], axis=1)
        coords[bm.reshape(-1)] = full
    return coords


def _dense_linear(charges, flows, flat_perm=None) -> np.ndarray:
    """Row-major dense position of each stored entry, in data order, in
    the leg order ``flat_perm`` (default: as stored).  Per sector the
    position is an outer sum of a row-side and a column-side part, so
    no (nnz, rank) coordinate array is built."""
    rank = len(charges)
    dims = [c.dim for c in charges]
    flat_perm = list(range(rank)) if flat_perm is None else list(flat_perm)
    new_dims = [dims[i] for i in flat_perm]
    strides = np.empty(rank, dtype=np.int64)
    strides[flat_perm] = np.cumprod([1] + new_dims[::-1])[-2::-1]
    if rank == 1:
        return nonzero_dense_coords(charges, flows)[:, 0] * strides[0]
    p = _balanced_partition(dims)
    _, block_maps, shapes = find_diagonal_blocks(charges, flows, p)
    _, rows, cols = _col_indices_per_sector(charges, flows, p)

    def part(lo, hi):
        n = int(np.prod(dims[lo:hi], dtype=np.int64))
        coords = np.unravel_index(np.arange(n), dims[lo:hi])
        return sum(c * strides[lo + k] for k, c in enumerate(coords))

    row_part, col_part = part(0, p), part(p, rank)
    out = np.empty(int(sum(r * c for (r, c) in shapes)), dtype=np.int64)
    for bm, r_idx, c_idx in zip(block_maps, rows, cols):
        out[bm] = row_part[r_idx][:, None] + col_part[c_idx][None, :]
    return out


def _sort_permutation(keys: np.ndarray, size: int) -> np.ndarray:
    """``argsort`` of distinct non-negative keys below ``size``: by one
    scatter into a dense table where that is not much larger than the
    keys, else by a sort."""
    if size > 16 * keys.shape[0] + (1 << 22):
        return np.argsort(keys, kind="stable")
    table = np.full(size, -1, dtype=np.int64)
    table[keys] = np.arange(keys.shape[0], dtype=np.int64)
    return table[table >= 0]


def _balanced_partition(dims: List[int]) -> int:
    total = np.prod(dims, dtype=np.float64)
    best_p, best = 1, np.inf
    for p in range(1, len(dims)):
        dr = np.prod(dims[:p], dtype=np.float64)
        bal = max(dr, total / dr)
        if bal < best:
            best, best_p = bal, p
    return best_p


def transpose_perm(charges, flows, flat_perm: Sequence[int]) -> np.ndarray:
    """Host permutation of the data vector realising an eager transpose of
    the elementary legs by ``flat_perm``."""
    size = int(np.prod([c.dim for c in charges], dtype=np.int64))
    return _sort_permutation(_dense_linear(charges, flows, flat_perm), size)


def _regroup(order: List[List[int]], perm: Sequence[int]):
    """(flat leg permutation, renumbered groups) of a group permutation."""
    flat_perm = [i for g in [order[o] for o in perm] for i in g]
    new_order, k = [], 0
    for o in perm:
        g = order[o]
        new_order.append(list(range(k, k + len(g))))
        k += len(g)
    return flat_perm, new_order


# ---------------------------------------------------------------------------
# ChargeArray / BlockSparseTensor
# ---------------------------------------------------------------------------


class ChargeArray:
    """Dense array with per-leg charges (no conservation constraint);
    used for singular-value vectors etc. (reference
    ``blocksparsetensor.py:35``).  ``order`` groups elementary charge
    vectors into composite legs (reshape bookkeeping)."""

    def __init__(self, data, charges: Sequence[BaseCharge],
                 flows: Sequence[bool],
                 order: Optional[List[List[int]]] = None,
                 device: Optional[Device] = None):
        self.data = as_tensor(data, device)
        self._charges = list(charges)
        self._flows = [bool(f) for f in flows]
        if order is None:
            order = [[i] for i in range(len(self._charges))]
        self._order = [list(g) for g in order]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(
            int(np.prod([self._charges[i].dim for i in g],
                        dtype=np.int64)) for g in self._order)

    @property
    def flat_charges(self) -> List[BaseCharge]:
        return list(self._charges)

    @property
    def flat_flows(self) -> List[bool]:
        return list(self._flows)

    @property
    def charges(self):
        return self._charges

    @property
    def flows(self):
        return self._flows

    @property
    def ndim(self) -> int:
        return len(self._order)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def todense(self) -> torch.Tensor:
        return self.data.reshape(self.shape)

    def reshape(self, shape) -> "ChargeArray":
        """Reshape along elementary charge boundaries (dense data is
        untouched; reference ``ChargeArray.reshape``,
        ``blocksparsetensor.py:205``)."""
        shape = tuple(int(x) for x in shape)
        dims = [c.dim for c in self._charges]
        groups, i = [], 0
        for s_ in shape:
            g, prod = [], 1
            while prod < s_ and i < len(dims):
                prod *= dims[i]
                g.append(i)
                i += 1
            if not g and i < len(dims) and dims[i] == 1:
                g.append(i)
                i += 1
            if prod != s_ or not g:
                raise ValueError(
                    f"cannot reshape {self.shape} into {shape}: target "
                    f"dim {s_} does not align with charge boundaries")
            groups.append(g)
        while i < len(dims) and dims[i] == 1:
            groups[-1].append(i)
            i += 1
        if i != len(dims):
            raise ValueError(f"cannot reshape {self.shape} into {shape}")
        return ChargeArray(self.data, self._charges, self._flows, groups)

    def transpose(self, order) -> "ChargeArray":
        """(dense data transpose with charge bookkeeping; reference
        ``ChargeArray.transpose``, ``blocksparsetensor.py:340``)"""
        order = list(order)
        dense = self.todense().permute(order)
        flat_perm, new_order = _regroup(self._order, order)
        return ChargeArray(dense.reshape(-1),
                           [self._charges[i] for i in flat_perm],
                           [self._flows[i] for i in flat_perm], new_order)

    def __mul__(self, other):
        if _is_scalar(other):
            return type(self)(self.data * other, self._charges, self._flows)
        raise TypeError("unsupported multiplication")

    __rmul__ = __mul__

    def __repr__(self):
        return (f"{type(self).__name__}(shape={self.shape}, "
                f"dtype={self.dtype})")


class BlockSparseTensor:
    """Charge-conserving block-sparse tensor (reference
    ``blocksparsetensor.py:468``).  ``data``: the stored entries as a 1-D
    torch tensor (see the module docstring for its device)."""

    def __init__(self, data, charges: Sequence[BaseCharge],
                 flows: Sequence[bool],
                 order: Optional[List[List[int]]] = None,
                 check_consistency: bool = False,
                 device: Optional[Device] = None):
        self.data = as_tensor(data, device).reshape(-1)
        self._charges = list(charges)
        self._flows = [bool(f) for f in flows]
        if order is None:
            order = [[i] for i in range(len(charges))]
        self._order = [list(g) for g in order]
        if check_consistency:
            nnz = compute_num_nonzero(self._charges, self._flows)
            if nnz != self.data.shape[0]:
                raise ValueError(
                    f"data length {self.data.shape[0]} does not match "
                    f"number of charge-conserving entries {nnz}")

    # -- structural properties --------------------------------------------
    @property
    def flat_charges(self) -> List[BaseCharge]:
        return list(self._charges)

    @property
    def flat_flows(self) -> List[bool]:
        return list(self._flows)

    @property
    def flat_order(self) -> List[int]:
        return [i for g in self._order for i in g]

    @property
    def ndim(self) -> int:
        return len(self._order)

    @property
    def rank(self) -> int:
        return self.ndim

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(
            int(np.prod([self._charges[i].dim for i in g], dtype=np.int64))
            for g in self._order)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def sparse_shape(self) -> List[Index]:
        return [Index([self._charges[i] for i in g],
                      [self._flows[i] for i in g]) for g in self._order]

    def _like(self, data) -> "BlockSparseTensor":
        """This tensor's structure around other data."""
        return BlockSparseTensor(data, self._charges, self._flows,
                                 self._order)

    def copy(self) -> "BlockSparseTensor":
        return BlockSparseTensor(self.data.clone(),
                                 [c.copy() for c in self._charges],
                                 list(self._flows),
                                 [list(g) for g in self._order])

    def to(self, device: Device) -> "BlockSparseTensor":
        """The same tensor with its data on ``device``."""
        return self._like(self.data.to(device))

    def __repr__(self):
        return (f"BlockSparseTensor(shape={self.shape}, "
                f"dtype={self.dtype}, nnz={self.data.shape[0]})")

    # -- construction ------------------------------------------------------
    @classmethod
    def fromdense(cls, indices: Sequence[Index], array,
                  device: Optional[Device] = None) -> "BlockSparseTensor":
        """(reference ``blocksparsetensor.py:534``)"""
        charges, flows, order = _expand_indices(indices)
        array = as_tensor(array, device)
        if tuple(array.shape) != tuple(
                int(np.prod([charges[i].dim for i in g])) for g in order):
            raise ValueError("array shape does not match index dims")
        lin = device_index(_dense_linear(charges, flows), array.device)
        return cls(array.reshape(-1)[lin], charges, flows, order)

    def todense(self) -> torch.Tensor:
        """(reference ``blocksparsetensor.py:575``)"""
        lin = device_index(_dense_linear(self._charges, self._flows),
                           self.device)
        size = int(np.prod([c.dim for c in self._charges], dtype=np.int64))
        out = torch.zeros(size, dtype=self.dtype, device=self.device)
        out[lin] = self.data
        return out.reshape(self.shape)

    # -- elementwise algebra ----------------------------------------------
    def _check_same_structure(self, other: "BlockSparseTensor"):
        """Operand compatibility for elementwise arithmetic.  Transposition
        is eager, so two tensors with equal elementary charges/flows share
        a storage layout (the reference's ``_align_storage_layout``,
        ``blocksparsetensor.py:708``, is a no-op by construction)."""
        if self.shape != other.shape:
            raise ValueError(
                f"cannot combine tensors of shapes {self.shape} and "
                f"{other.shape}")
        if len(self._charges) != len(other._charges) or any(
                not charge_equal(a, b) for a, b in
                zip(self._charges, other._charges)) or \
                self._flows != other._flows:
            raise ValueError("tensors have incompatible charge structure")

    def __add__(self, other):
        if isinstance(other, BlockSparseTensor):
            self._check_same_structure(other)
            return self._like(self.data + other.data)
        raise TypeError("can only add BlockSparseTensor")

    def __sub__(self, other):
        if isinstance(other, BlockSparseTensor):
            self._check_same_structure(other)
            return self._like(self.data - other.data)
        raise TypeError("can only subtract BlockSparseTensor")

    def __mul__(self, scalar):
        if _is_scalar(scalar):
            return self._like(self.data * scalar)
        raise TypeError("can only multiply by scalars")

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        if _is_scalar(scalar):
            return self._like(self.data / scalar)
        raise TypeError("can only divide by scalars")

    def __neg__(self):
        return self * (-1)

    def conj(self) -> "BlockSparseTensor":
        """Complex conjugation flips all flows (reference
        ``blocksparsetensor.py`` ``conj``)."""
        return BlockSparseTensor(self.data.conj().resolve_conj(),
                                 self._charges,
                                 [not f for f in self._flows], self._order)

    @property
    def T(self) -> "BlockSparseTensor":
        return self.transpose(tuple(reversed(range(self.ndim))))

    @property
    def H(self) -> "BlockSparseTensor":
        """Hermitian conjugate of a rank-2 tensor (reference
        ``blocksparsetensor.py`` ``ChargeArray.H``)."""
        if self.ndim != 2:
            raise ValueError(
                "hermitian conjugate only defined for rank-2 tensors, "
                f"got rank {self.ndim}")
        return self.conj().transpose((1, 0))

    @property
    def size(self) -> int:
        """Total DENSE element count (reference ``ChargeArray.size``)."""
        return int(np.prod([d for d in self.shape], dtype=np.int64))

    def item(self):
        """The single element of a size-1 (or rank-0) tensor (reference
        ``blocksparsetensor.py`` ``item``)."""
        if self.ndim == 0:
            return self.data.item()
        if self.size == 1:
            # a size-1 symmetric tensor has at most one structurally
            # allowed entry; zero entries means the value is 0
            return self.data.item() if self.data.numel() == 1 else \
                torch.zeros((), dtype=self.dtype).item()
        raise ValueError("can only convert an array of size 1 to a "
                         "Python scalar")

    def __matmul__(self, other: "BlockSparseTensor") -> "BlockSparseTensor":
        """Matrix multiply for rank-1/rank-2 operands (reference
        ``blocksparsetensor.py`` ``__matmul__``)."""
        if self.ndim > 2 or other.ndim > 2:
            raise ValueError("__matmul__ only implemented for rank-1 or "
                             "rank-2 tensors")
        return tensordot(self, other, [[self.ndim - 1], [0]])

    # -- transpose / reshape ----------------------------------------------
    def transpose(self, order: Sequence[int]) -> "BlockSparseTensor":
        """Eager transpose: the data vector permuted by a host coordinate
        sort, O(nnz log nnz) (reference ``blocksparsetensor.py:340`` is
        lazy via ``_order``)."""
        order = list(order)
        if sorted(order) != list(range(self.ndim)):
            raise ValueError(f"{order} is not a valid permutation")
        flat_perm, new_order = _regroup(self._order, order)
        new_charges = [self._charges[i] for i in flat_perm]
        new_flows = [self._flows[i] for i in flat_perm]
        if flat_perm == list(range(len(self._charges))):
            # identity on the elementary legs: only the grouping changes
            return BlockSparseTensor(self.data, new_charges, new_flows,
                                     new_order)
        perm = transpose_perm(self._charges, self._flows, flat_perm)
        return BlockSparseTensor(self.data[device_index(perm, self.device)],
                                 new_charges, new_flows, new_order)

    def reshape(self, shape: Sequence[int]) -> "BlockSparseTensor":
        """Reshape along elementary-leg boundaries only (reference
        ``blocksparsetensor.py:205``)."""
        shape = [int(s) for s in shape]
        elementary_dims = [c.dim for c in self._charges]
        new_order: List[List[int]] = []
        i = 0
        for s in shape:
            g = []
            prod = 1
            while prod < s and i < len(elementary_dims):
                prod *= elementary_dims[i]
                g.append(i)
                i += 1
            if not g and i < len(elementary_dims) \
                    and elementary_dims[i] == 1:
                # a target dim of 1 consumes an elementary dim-1 leg
                g.append(i)
                i += 1
            if not g:
                raise ValueError(
                    f"cannot reshape {self.shape} into {tuple(shape)}: "
                    f"target dim {s} has no elementary legs to absorb "
                    f"(synthetic singleton legs are not supported)")
            if prod != s:
                raise ValueError(
                    f"cannot reshape {self.shape} into {tuple(shape)}: "
                    f"target dim {s} does not align with elementary legs "
                    f"{elementary_dims}")
            new_order.append(g)
        # absorb trailing dim-1 elementary legs into the last group
        while i < len(elementary_dims) and elementary_dims[i] == 1:
            new_order[-1].append(i)
            i += 1
        if i != len(elementary_dims):
            raise ValueError(
                f"cannot reshape {self.shape} into {tuple(shape)}")
        return BlockSparseTensor(self.data, self._charges, self._flows,
                                 new_order)

    def contiguous(self) -> "BlockSparseTensor":
        """No-op: transposition is eager (the reference needs this to
        materialize lazy transposes, ``blocksparsetensor.py:310``)."""
        return self

    # -- norms etc ---------------------------------------------------------
    def norm(self) -> float:
        return float(torch.linalg.vector_norm(self.data))


def _expand_indices(indices: Sequence[Index]):
    charges: List[BaseCharge] = []
    flows: List[bool] = []
    order: List[List[int]] = []
    k = 0
    for idx in indices:
        fc = idx.flat_charges
        ff = idx.flat_flows
        charges.extend(fc)
        flows.extend(ff)
        order.append(list(range(k, k + len(fc))))
        k += len(fc)
    return charges, flows, order


def transpose(t: BlockSparseTensor, order: Sequence[int]
              ) -> BlockSparseTensor:
    return t.transpose(order)


def reshape(t: BlockSparseTensor, shape: Sequence[int]) -> BlockSparseTensor:
    return t.reshape(shape)


def conj(t: BlockSparseTensor) -> BlockSparseTensor:
    return t.conj()


def outerproduct(t1: BlockSparseTensor,
                 t2: BlockSparseTensor) -> BlockSparseTensor:
    """(reference ``blocksparsetensor.py:887``)"""
    dense = torch.tensordot(t1.todense(), t2.todense(), 0)
    indices = t1.sparse_shape + t2.sparse_shape
    return BlockSparseTensor.fromdense(indices, dense)


def _check_contracted_legs(t1, t2, axes1, axes2):
    """Loud validation of the contracted composite legs: without it,
    mismatched charges/flows would find no common sectors and return
    zeros."""
    s1, s2 = t1.sparse_shape, t2.sparse_shape
    for a1, a2 in zip(axes1, axes2):
        i1, i2 = s1[a1], s2[a2]
        if i1.dim != i2.dim:
            raise ValueError(
                f"cannot contract axes with dims {i1.dim} and {i2.dim}")
        if not np.array_equal(i1.charges.charges,
                              i2.charges.dual(True).charges):
            raise ValueError(
                "contracted legs have incompatible charges/flows")


def normalize_axes(t1, t2, axes) -> Tuple[List[int], List[int]]:
    if isinstance(axes, int):
        return list(range(t1.ndim - axes, t1.ndim)), list(range(axes))
    axes1, axes2 = [list(a) for a in axes]
    if len(axes1) != len(axes2):
        raise ValueError("axes lists must have equal length")
    return axes1, axes2


def tensordot_structure(t1: BlockSparseTensor, t2: BlockSparseTensor,
                        axes1: List[int], axes2: List[int]) -> dict:
    """Host metadata of ``tensordot(t1, t2, (axes1, axes2))`` without
    touching data: the operands' matmul normal forms (flat leg
    permutations, charges, flows, row partitions) and the output's
    charges, flows, leg groups and partition."""
    free1 = [i for i in range(t1.ndim) if i not in axes1]
    free2 = [i for i in range(t2.ndim) if i not in axes2]
    fp1, order1 = _regroup(t1._order, free1 + axes1)
    fp2, order2 = _regroup(t2._order, axes2 + free2)
    c1 = [t1._charges[i] for i in fp1]
    f1 = [t1._flows[i] for i in fp1]
    c2 = [t2._charges[i] for i in fp2]
    f2 = [t2._flows[i] for i in fp2]
    p1 = sum(len(order1[k]) for k in range(len(free1)))
    p2 = sum(len(order2[k]) for k in range(len(axes2)))
    out_order: List[List[int]] = []
    k = 0
    for g in order1[:len(free1)] + order2[len(axes2):]:
        out_order.append(list(range(k, k + len(g))))
        k += len(g)
    return dict(flat_perm1=fp1, flat_perm2=fp2, charges1=c1, flows1=f1,
                charges2=c2, flows2=f2, p1=p1, p2=p2,
                out_charges=c1[:p1] + c2[p2:], out_flows=f1[:p1] + f2[p2:],
                out_order=out_order, p_out=p1)


def _sector_triples(st: dict):
    """Matched sectors of a contraction: ``(maps1, maps2, maps_out,
    shapes1, shapes2, triples)`` with each triple the (operand 1, operand
    2, output) sector numbers; output maps are ``None`` for a scalar."""
    common1, maps1, shapes1 = find_diagonal_blocks(st["charges1"],
                                                   st["flows1"], st["p1"])
    common2, maps2, shapes2 = find_diagonal_blocks(st["charges2"],
                                                   st["flows2"], st["p2"])
    _, ia, ib = common1.intersect(common2, return_indices=True)
    if not st["out_charges"]:
        return (maps1, maps2, None, shapes1, shapes2,
                [(int(a), int(b), None) for a, b in zip(ia, ib)])
    # partition the output exactly at the t1-free / t2-free boundary so
    # sector keys line up with the operand lookups (0 is a valid partition:
    # the row side is then the identity charge)
    common_out, maps_out, _ = find_diagonal_blocks(
        st["out_charges"], st["out_flows"], st["p_out"])
    _, io, ic = common_out.intersect(common1[ia], return_indices=True)
    return (maps1, maps2, maps_out, shapes1, shapes2,
            [(int(ia[c]), int(ib[c]), int(o)) for o, c in zip(io, ic)])


def tensordot(
    t1: BlockSparseTensor,
    t2: BlockSparseTensor,
    axes: Union[int, Sequence[Sequence[int]]] = 2,
) -> BlockSparseTensor:
    """Symmetric tensordot: one dense matmul per common charge sector
    (reference ``blocksparsetensor.py:925``; hot loop ``:1094-1101``).
    The per-sector loop on the data's device; a full contraction returns
    a 0-d tensor."""
    axes1, axes2 = normalize_axes(t1, t2, axes)
    if len(axes1) == 0:
        return outerproduct(t1, t2)
    _check_contracted_legs(t1, t2, axes1, axes2)
    free1 = [i for i in range(t1.ndim) if i not in axes1]
    free2 = [i for i in range(t2.ndim) if i not in axes2]
    # eager transpose into matmul normal form
    m1 = t1.transpose(free1 + axes1)
    m2 = t2.transpose(axes2 + free2)
    st = tensordot_structure(t1, t2, axes1, axes2)
    maps1, maps2, maps_out, _, _, triples = _sector_triples(st)
    dev = m1.device
    dtype = torch.promote_types(t1.dtype, t2.dtype)
    d1, d2 = m1.data.to(dtype), m2.data.to(dtype)
    if maps_out is None:
        total = torch.zeros((), dtype=dtype, device=dev)
        for s1, s2, _ in triples:
            b1 = d1[device_index(maps1[s1], dev)]
            b2 = d2[device_index(maps2[s2], dev)]
            total = total + torch.sum(b1 * b2.T)
        return total
    out_nnz = compute_num_nonzero(st["out_charges"], st["out_flows"])
    out_data = torch.zeros(out_nnz, dtype=dtype, device=dev)
    for s1, s2, so in triples:
        b1 = d1[device_index(maps1[s1], dev)]
        b2 = d2[device_index(maps2[s2], dev)]
        out_data[device_index(maps_out[so], dev)] = b1 @ b2
    return BlockSparseTensor(out_data, st["out_charges"], st["out_flows"],
                             st["out_order"])


# ---------------------------------------------------------------------------
# Batched symmetric tensordot (ncon batch labels on BlockSparseTensor)
# ---------------------------------------------------------------------------


def _elementwise_fuse(c1: BaseCharge, f1: bool,
                      c2: BaseCharge, f2: bool) -> BaseCharge:
    """Per-position (diagonal) fuse of two same-dimension charge vectors,
    flow-adjusted -- the charge a shared batch leg carries on the output
    of a batched contraction."""
    if c1.dim != c2.dim:
        raise ValueError(
            f"cannot fuse charge vectors of dims {c1.dim} and {c2.dim}")
    a = c1.dual(f1).charges
    b = c2.dual(f2).charges
    cols = [ct.fuse(a[:, k], b[:, k])
            for k, ct in enumerate(c1.charge_types)]
    return BaseCharge(np.stack(cols, axis=1), c1.charge_types)


def _stacked_tensordot(charges1, flows1, p1, data1,
                       charges2, flows2, p2, data2,
                       out_charges, out_flows, p_out):
    """Tensordot of a stack of identically-structured *charged* tensors.

    Operands are given at the flat-charge level, already in matmul normal
    form: operand 1 rows = ``charges1[:p1]`` (free side), cols = the
    contracted side; operand 2 rows = ``charges2[:p2]`` (contracted
    side), cols = free side.  ``data1``/``data2`` carry a leading batch
    dimension: shape (n_b, nnz).  Charge conservation per stack element
    is encoded by phantom aux legs inside ``charges*`` (dim-1 legs
    carrying the element's total charge), so the standard block lookup
    applies unchanged and each inner charge sector becomes ONE batched
    ``torch.matmul`` over the stack.  Returns the stacked output data
    (n_b, nnz_out)."""
    common1, maps1, _ = find_diagonal_blocks(charges1, flows1, p1)
    common2, maps2, _ = find_diagonal_blocks(charges2, flows2, p2)
    nnz_out = compute_num_nonzero(out_charges, out_flows)
    dev = data1.device
    out = torch.zeros((data1.shape[0], nnz_out),
                      dtype=torch.promote_types(data1.dtype, data2.dtype),
                      device=dev)
    common_out, maps_out, _ = find_diagonal_blocks(out_charges, out_flows,
                                                   p_out)
    _, ia, ib = common1.intersect(common2, return_indices=True)
    _, io, ic = common_out.intersect(common1[ia], return_indices=True)
    for t in range(len(io)):
        b1 = data1[:, device_index(maps1[ia[ic[t]]], dev)]   # (n_b, r, k)
        b2 = data2[:, device_index(maps2[ib[ic[t]]], dev)]   # (n_b, k, c)
        out[:, device_index(maps_out[io[t]], dev)] = torch.matmul(
            b1.to(out.dtype), b2.to(out.dtype))
    return out


def tensordot_batched(
    t1: BlockSparseTensor,
    t2: BlockSparseTensor,
    axes: Sequence[Sequence[int]],
    batch_axes: Sequence[Sequence[int]],
) -> BlockSparseTensor:
    """Batched symmetric tensordot: contract ``axes`` while the
    ``batch_axes`` legs ride along elementwise -- the BlockSparseTensor
    lowering of ncon *batch labels* (dense semantics of the reference's
    ``_batch_cont``, ``ncon_interface.py:280-354``).

    Output axis order: ``[batch (t1 order)] + [free1] + [free2]``.  Each
    output batch leg carries the per-position fused charge of the two
    operands' legs (flow ``False``), so the result is a genuine
    BlockSparseTensor whose ``todense()`` matches the dense oracle.

    Execution: batch positions are grouped by their (operand-1, operand-2)
    fused-charge pair; within a group every stack element has the same
    block structure, so the contraction lowers to one batched
    ``torch.matmul`` per inner charge sector (:func:`_stacked_tensordot`).
    """
    axes1, axes2 = [list(a) for a in axes]
    bax1, bax2 = [list(a) for a in batch_axes]
    if len(bax1) != len(bax2):
        raise ValueError("batch axis lists must have equal length")
    if not bax1:
        return tensordot(t1, t2, (axes1, axes2))
    for a1, a2 in zip(bax1, bax2):
        if t1.shape[a1] != t2.shape[a2]:
            raise ValueError(
                f"batch axes have mismatched dims {t1.shape[a1]} and "
                f"{t2.shape[a2]}")
    _check_contracted_legs(t1, t2, axes1, axes2)

    nb = len(bax1)
    free1 = [i for i in range(t1.ndim) if i not in axes1 and i not in bax1]
    free2 = [i for i in range(t2.ndim) if i not in axes2 and i not in bax2]
    m1 = t1.transpose(bax1 + free1 + axes1)
    m2 = t2.transpose(bax2 + axes2 + free2)
    pb1 = sum(len(m1._order[k]) for k in range(nb))
    pb2 = sum(len(m2._order[k]) for k in range(nb))
    nf1 = sum(len(m1._order[k]) for k in range(nb, nb + len(free1)))
    nc2 = sum(len(m2._order[k]) for k in range(nb, nb + len(axes2)))

    # output structure: per-axis elementwise-fused batch charges (flow
    # False) + free legs of both operands
    out_batch_charges: List[BaseCharge] = []
    for k in range(nb):
        gA, gB = m1._order[k], m2._order[k]
        cA = fuse_charges([m1._charges[i] for i in gA],
                          [m1._flows[i] for i in gA])
        cB = fuse_charges([m2._charges[i] for i in gB],
                          [m2._flows[i] for i in gB])
        out_batch_charges.append(_elementwise_fuse(cA, False, cB, False))
    out_charges = (out_batch_charges + m1._charges[pb1:pb1 + nf1]
                   + m2._charges[pb2 + nc2:])
    out_flows = ([False] * nb + m1._flows[pb1:pb1 + nf1]
                 + m2._flows[pb2 + nc2:])
    out_order: List[List[int]] = [[k] for k in range(nb)]
    k = nb
    for i in range(len(free1)):
        g = m1._order[nb + i]
        out_order.append(list(range(k, k + len(g))))
        k += len(g)
    for i in range(nb + len(axes2), m2.ndim):
        g = m2._order[i]
        out_order.append(list(range(k, k + len(g))))
        k += len(g)
    out_nnz = compute_num_nonzero(out_charges, out_flows)
    dev = m1.device
    out_dtype = torch.promote_types(t1.dtype, t2.dtype)
    out = BlockSparseTensor(torch.zeros(out_nnz, dtype=out_dtype,
                                        device=dev),
                            out_charges, out_flows, out_order)

    # batch-side block structure of each operand and the output:
    # per-sector position lists are in ascending dense batch order
    secA, mapsA, _ = find_diagonal_blocks(m1._charges, m1._flows, pb1)
    secB, mapsB, _ = find_diagonal_blocks(m2._charges, m2._flows, pb2)
    secO, mapsO, _ = find_diagonal_blocks(out_charges, out_flows, nb)
    _, posA, _ = _col_indices_per_sector(m1._charges, m1._flows, pb1)
    _, posB, _ = _col_indices_per_sector(m2._charges, m2._flows, pb2)
    _, posO, _ = _col_indices_per_sector(out_charges, out_flows, nb)
    D = int(np.prod([t1.shape[a] for a in bax1], dtype=np.int64))

    def sector_and_rank(pos_lists):
        sect = np.full(D, -1, dtype=np.int64)
        rank = np.zeros(D, dtype=np.int64)
        for s, p in enumerate(pos_lists):
            sect[p] = s
            rank[p] = np.arange(p.shape[0])
        return sect, rank

    sectA, rankA = sector_and_rank(posA)
    sectB, rankB = sector_and_rank(posB)
    sectO, rankO = sector_and_rank(posO)

    valid = (sectA >= 0) & (sectB >= 0)
    pairs = sectA[valid] * (len(posB) + 1) + sectB[valid]
    positions = np.nonzero(valid)[0]
    for pair in np.unique(pairs):
        P = positions[pairs == pair]
        sA = int(sectA[P[0]])
        sB = int(sectB[P[0]])
        sO = int(sectO[P[0]])
        if sO < 0:
            continue  # no charge-allowed output entries for this pair
        dataA = m1.data[device_index(mapsA[sA][rankA[P]], dev)]
        dataB = m2.data[device_index(mapsB[sB][rankB[P]], dev)]
        # phantom aux legs carry the per-element total charge (the
        # find_diagonal_blocks row convention is flow-applied, so the
        # aux flow is False)
        skel1_c = [secA[sA]] + m1._charges[pb1:]
        skel1_f = [False] + m1._flows[pb1:]
        skel2_c = (m2._charges[pb2:pb2 + nc2] + [secB[sB]]
                   + m2._charges[pb2 + nc2:])
        skel2_f = (m2._flows[pb2:pb2 + nc2] + [False]
                   + m2._flows[pb2 + nc2:])
        skelo_c = ([secA[sA]] + m1._charges[pb1:pb1 + nf1]
                   + [secB[sB]] + m2._charges[pb2 + nc2:])
        skelo_f = ([False] + m1._flows[pb1:pb1 + nf1]
                   + [False] + m2._flows[pb2 + nc2:])
        res = _stacked_tensordot(
            skel1_c, skel1_f, 1 + nf1, dataA,
            skel2_c, skel2_f, nc2, dataB,
            skelo_c, skelo_f, 1 + nf1)
        out.data[device_index(mapsO[sO][rankO[P]], dev)] = res
    return out
