"""Abelian charges for symmetric block-sparse tensors.

Capability parity with the reference charge system (reference
``block_sparse/charge.py:21-644``: ``BaseCharge``, ``U1Charge``,
``Z2Charge``, ``ZNCharge`` factory, fusion/dual/intersect/unique/reduce).

Design difference from the reference: charges are stored as a dense
``(dim, num_symmetries)`` integer array rather than the factorized
(unique_charges, charge_labels) pair; uniqueness/degeneracy queries are
computed on demand.  This keeps the per-leg metadata a plain numpy array
that the plan compiler can hash and cache.

A copy of :mod:`tensornetwork_tpu.blocksparse.charge`: the charge algebra
is pure numpy on the host, in the port as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Type, Union

import numpy as np


class ChargeType:
    """Fusion algebra of one abelian symmetry."""

    @staticmethod
    def fuse(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def dual(a: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def identity() -> int:
        return 0


class U1ChargeType(ChargeType):
    @staticmethod
    def fuse(a, b):
        return a + b

    @staticmethod
    def dual(a):
        return -a


def _zn_type(n: int) -> Type[ChargeType]:
    class ZNChargeType(ChargeType):
        N = n

        @staticmethod
        def fuse(a, b):
            return (a + b) % n

        @staticmethod
        def dual(a):
            return (-a) % n

    ZNChargeType.__name__ = f"Z{n}ChargeType"
    return ZNChargeType


_ZN_TYPE_CACHE = {}


def zn_type(n: int) -> Type[ChargeType]:
    if n not in _ZN_TYPE_CACHE:
        _ZN_TYPE_CACHE[n] = _zn_type(n)
    return _ZN_TYPE_CACHE[n]


class BaseCharge:
    """A vector of (possibly multi-symmetry) abelian charges
    (reference ``block_sparse/charge.py:21``)."""

    def __init__(self, charges: np.ndarray,
                 charge_types: Optional[Sequence[Type[ChargeType]]] = None):
        charges = np.asarray(charges, dtype=np.int64)
        if charges.ndim == 1:
            charges = charges[:, None]
        self.charges = charges
        if charge_types is None:
            charge_types = [U1ChargeType] * charges.shape[1]
        if len(charge_types) != charges.shape[1]:
            raise ValueError("one charge type per symmetry column required")
        self.charge_types = list(charge_types)

    # -- basic properties --------------------------------------------------
    @property
    def dim(self) -> int:
        return self.charges.shape[0]

    def __len__(self) -> int:
        return self.dim

    @property
    def num_symmetries(self) -> int:
        return self.charges.shape[1]

    @property
    def dtype(self):
        return self.charges.dtype

    def copy(self) -> "BaseCharge":
        return BaseCharge(self.charges.copy(), self.charge_types)

    def __repr__(self):
        return (f"{type(self).__name__}(dim={self.dim}, "
                f"num_symmetries={self.num_symmetries})")

    # -- fusion ------------------------------------------------------------
    def __add__(self, other: "BaseCharge") -> "BaseCharge":
        """Fuse: all pairwise combinations, other index faster (row-major
        kron order; reference ``charge.py:208``)."""
        self._check_compatible(other)
        cols = []
        for k, ct in enumerate(self.charge_types):
            a = self.charges[:, k]
            b = other.charges[:, k]
            cols.append(ct.fuse(a[:, None], b[None, :]).reshape(-1))
        return BaseCharge(np.stack(cols, axis=1), self.charge_types)

    def dual(self, take_dual: bool = True) -> "BaseCharge":
        """(reference ``charge.py:223``)"""
        if not take_dual:
            return self.copy()
        cols = [ct.dual(self.charges[:, k])
                for k, ct in enumerate(self.charge_types)]
        return BaseCharge(np.stack(cols, axis=1), self.charge_types)

    def _check_compatible(self, other: "BaseCharge"):
        if self.num_symmetries != other.num_symmetries:
            raise ValueError("different numbers of symmetries")
        for a, b in zip(self.charge_types, other.charge_types):
            if a is not b and a.__name__ != b.__name__:
                raise ValueError(f"incompatible charge types {a.__name__} "
                                 f"and {b.__name__}")

    # -- set operations ----------------------------------------------------
    def _rows_as_void(self) -> np.ndarray:
        """The charge rows as one sortable key each: the integers
        themselves for one symmetry (they sort as the one-field rows do,
        and far faster), else a structured view of the rows."""
        c = np.ascontiguousarray(self.charges)
        if c.shape[1] == 1:
            return c[:, 0]
        return c.view([("", c.dtype)] * c.shape[1]).reshape(-1)

    def unique(self, return_counts: bool = False,
               return_inverse: bool = False, return_index: bool = False):
        """Unique charge rows (reference ``charge.py:325``)."""
        out = np.unique(self._rows_as_void(), return_counts=return_counts,
                        return_inverse=return_inverse,
                        return_index=return_index)
        if not (return_counts or return_inverse or return_index):
            uniq = out
            rest: Tuple = ()
        else:
            uniq, *rest = out
        uniq_charges = uniq.view(self.dtype).reshape(-1, self.num_symmetries)
        result = [BaseCharge(uniq_charges, self.charge_types)]
        result.extend(rest)
        return result[0] if len(result) == 1 else tuple(result)

    @property
    def unique_charges(self) -> np.ndarray:
        return self.unique().charges

    @property
    def charge_labels(self) -> np.ndarray:
        _, inv = self.unique(return_inverse=True)
        return np.asarray(inv).reshape(-1)

    def intersect(self, other: "BaseCharge", return_indices: bool = False):
        """Common charge rows (reference ``charge.py:275``)."""
        self._check_compatible(other)
        a = self._rows_as_void()
        b = other._rows_as_void()
        if return_indices:
            common, ia, ib = np.intersect1d(a, b, return_indices=True)
            charges = common.view(self.dtype).reshape(
                -1, self.num_symmetries)
            return BaseCharge(charges, self.charge_types), ia, ib
        common = np.intersect1d(a, b)
        return BaseCharge(common.view(self.dtype).reshape(
            -1, self.num_symmetries), self.charge_types)

    def reduce(self, targets: "BaseCharge", return_locations: bool = False):
        """Keep only entries whose charge is in ``targets`` (reference
        ``charge.py:413``)."""
        mask = self.isin(targets)
        reduced = BaseCharge(self.charges[mask], self.charge_types)
        if return_locations:
            return reduced, np.nonzero(mask)[0]
        return reduced

    def isin(self, targets: "BaseCharge") -> np.ndarray:
        self._check_compatible(targets)
        return np.isin(self._rows_as_void(), targets._rows_as_void())

    def __eq__(self, other) -> np.ndarray:  # elementwise row comparison
        if isinstance(other, BaseCharge):
            target = other.charges
        else:
            target = np.asarray(other, dtype=np.int64).reshape(
                -1, self.num_symmetries)
        return np.all(self.charges[:, None, :] == target[None, :, :],
                      axis=2)

    def __getitem__(self, idx) -> "BaseCharge":
        charges = np.atleast_2d(self.charges[idx])
        if charges.shape[-1] != self.num_symmetries:
            charges = charges.reshape(-1, self.num_symmetries)
        return BaseCharge(charges, self.charge_types)

    def identity_charges(self, dim: int = 1) -> "BaseCharge":
        ids = np.array([[ct.identity() for ct in self.charge_types]],
                       dtype=np.int64)
        return BaseCharge(np.repeat(ids, dim, axis=0), self.charge_types)

    def __matmul__(self, other: "BaseCharge") -> "BaseCharge":
        """Stack symmetries of two equal-length charge vectors (product
        group; reference ``charge.py`` ``__matmul__``)."""
        if self.dim != other.dim:
            raise ValueError("can only combine equal-length charges")
        return BaseCharge(
            np.concatenate([self.charges, other.charges], axis=1),
            self.charge_types + other.charge_types)


class U1Charge(BaseCharge):
    """(reference ``charge.py:485``)"""

    def __init__(self, charges: Union[Sequence[int], np.ndarray],
                 charge_types=None):
        charges = np.asarray(charges, dtype=np.int64)
        if charges.ndim == 1:
            charges = charges[:, None]
        super().__init__(charges,
                         charge_types or [U1ChargeType] * charges.shape[1])


class Z2Charge(BaseCharge):
    """(reference ``charge.py:506``)"""

    def __init__(self, charges: Union[Sequence[int], np.ndarray],
                 charge_types=None):
        charges = np.asarray(charges, dtype=np.int64)
        if not np.all(np.isin(charges, [0, 1])):
            raise ValueError("Z2 charges must be 0 or 1")
        if charges.ndim == 1:
            charges = charges[:, None]
        super().__init__(charges,
                         charge_types or [zn_type(2)] * charges.shape[1])


def ZNCharge(n: int) -> Callable[[Sequence[int]], BaseCharge]:
    """Class factory for Z_n charges (reference ``charge.py:549``)."""
    if n < 2:
        raise ValueError(f"n must be >= 2, got {n}")

    class _ZNCharge(BaseCharge):
        def __init__(self, charges, charge_types=None):
            charges = np.asarray(charges, dtype=np.int64)
            if not np.all((0 <= charges) & (charges < n)):
                raise ValueError(f"Z{n} charges must be in [0, {n})")
            if charges.ndim == 1:
                charges = charges[:, None]
            super().__init__(charges,
                             charge_types or [zn_type(n)] * charges.shape[1])

    _ZNCharge.__name__ = f"Z{n}Charge"
    return _ZNCharge


def fuse_charges(charges: Sequence[BaseCharge],
                 flows: Sequence[bool]) -> BaseCharge:
    """Fuse a list of charge vectors with flows, left to right (reference
    ``charge.py:622``)."""
    if len(charges) != len(flows):
        raise ValueError("len(charges) != len(flows)")
    out = charges[0].dual(flows[0])
    for c, f in zip(charges[1:], flows[1:]):
        out = out + c.dual(f)
    return out


def charge_equal(a: BaseCharge, b: BaseCharge) -> bool:
    """(reference ``charge.py:644``)"""
    return (a.num_symmetries == b.num_symmetries and a.dim == b.dim
            and np.array_equal(a.charges, b.charges))


def fuse_ndarrays(arrays) -> np.ndarray:
    """Fuse integer arrays by Kronecker addition, right-to-left
    (reference ``block_sparse/utils.py:96``): the result enumerates
    ``a[i0] + b[i1] + ...`` in row-major index order."""
    if len(arrays) == 1:
        return np.array(arrays[0])
    fused = np.asarray(arrays[0])
    for n in range(1, len(arrays)):
        fused = np.ravel(np.add.outer(fused, arrays[n]))
    return fused


def fuse_degeneracies(degen1, degen2) -> np.ndarray:
    """Fuse degeneracy vectors: multiplicities of the Kronecker-added
    charges (reference ``block_sparse/utils.py:113``)."""
    return np.ravel(np.multiply.outer(np.asarray(degen1),
                                      np.asarray(degen2)))
