"""Functional ``Tensor`` wrapper and ncon-builder sugar.

Counterpart of :mod:`tensornetwork_tpu.core.tensor` (reference
``tensor.py:25-202``) and its ``NconBuilder`` call syntax
(``A(1, -1) @ B(1, -2)`` builds an ncon network; reference
``tensor.py:193``, finalized by ``ncon_interface.finalize:665``).  The
wrapper is a thin shell over a torch tensor, placed by
:func:`config.as_tensor`; there is no backend tag.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import as_tensor
from tensornetwork_tpu_torch.core.network import conj


class NconBuilder:
    """Accumulates (tensor, labels) pairs (reference ``tensor.py:193``)."""

    def __init__(self, tensors: List[Any], axes: List[List[Any]]):
        self.tensors = list(tensors)
        self.axes = [list(a) for a in axes]

    def __matmul__(self, other: "NconBuilder") -> "NconBuilder":
        if not isinstance(other, NconBuilder):
            raise TypeError("can only combine NconBuilder with NconBuilder")
        return NconBuilder(self.tensors + other.tensors,
                           self.axes + other.axes)


class Tensor:
    """Backend-free tensor wrapper (reference ``tensor.py:25``)."""

    def __init__(self, array: Any):
        if isinstance(array, Tensor):
            array = array.array
        self.array = as_tensor(array)

    # -- properties --------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def ndim(self) -> int:
        return self.array.ndim

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def T(self) -> "Tensor":
        return self.transpose()

    @property
    def H(self) -> "Tensor":
        """Conjugate transpose (hermitian adjoint for matrices; for higher
        rank, conjugate + reversed axes)."""
        return Tensor(conj(self.transpose().array))

    def conj(self) -> "Tensor":
        return Tensor(conj(self.array))

    hconj = H

    def copy(self) -> "Tensor":
        return Tensor(self.array.clone())

    def reshape(self, shape: Sequence[int]) -> "Tensor":
        return Tensor(self.array.reshape(tuple(shape)))

    def transpose(self, perm: Optional[Sequence[int]] = None) -> "Tensor":
        if perm is None:
            perm = tuple(reversed(range(self.ndim)))
        return Tensor(self.array.permute(tuple(perm)))

    def flatten(self) -> "Tensor":
        return Tensor(self.array.reshape(-1))

    def ravel(self) -> "Tensor":
        return self.flatten()

    def squeeze(self) -> "Tensor":
        return Tensor(self.array.squeeze())

    # -- arithmetic --------------------------------------------------------
    @staticmethod
    def _unwrap(x):
        return x.array if isinstance(x, Tensor) else x

    def __add__(self, o):
        return Tensor(self.array + self._unwrap(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Tensor(self.array - self._unwrap(o))

    def __rsub__(self, o):
        return Tensor(self._unwrap(o) - self.array)

    def __mul__(self, o):
        return Tensor(self.array * self._unwrap(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return Tensor(self.array / self._unwrap(o))

    def __rtruediv__(self, o):
        return Tensor(self._unwrap(o) / self.array)

    def __neg__(self):
        return Tensor(-self.array)

    def __pow__(self, o):
        return Tensor(self.array ** self._unwrap(o))

    def __matmul__(self, other):
        if isinstance(other, NconBuilder):
            raise ValueError(
                "cannot mix a plain Tensor with an NconBuilder; call the "
                "tensor with axis labels first")
        other = self._unwrap(other)
        dtype = torch.promote_types(self.array.dtype, other.dtype)
        return Tensor(self.array.to(dtype) @ other.to(dtype))

    def __getitem__(self, key):
        return Tensor(self.array[key])

    def __call__(self, *labels) -> NconBuilder:
        """ncon-builder sugar: ``A(1, -1) @ B(1, -2)``."""
        if len(labels) != self.ndim:
            raise ValueError(
                f"{len(labels)} labels for a rank-{self.ndim} tensor")
        return NconBuilder([self.array], [list(labels)])

    def __repr__(self):
        return f"Tensor(shape={self.shape}, dtype={self.dtype})"

