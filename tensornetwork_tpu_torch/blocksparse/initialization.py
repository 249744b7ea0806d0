"""Initializers for block-sparse tensors
(reference ``block_sparse/initialization.py:22-163``).

Counterpart of :mod:`tensornetwork_tpu.blocksparse.initialization`.  Random
data is drawn on the host from ``numpy.random.default_rng(seed)`` (``seed``
may also be a numpy ``Generator``), exactly as the JAX package draws it, so
both packages given one seed hold the same bits; the data then goes to
``device`` (default: the card).  ``dtype`` is a torch or numpy dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.index import Index
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, _expand_indices, compute_num_nonzero, torch_dtype)
from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device,
                                            default_device)

Seed = Union[int, np.random.Generator]


def _nnz(indices: Sequence[Index]) -> tuple:
    charges, flows, order = _expand_indices(indices)
    return compute_num_nonzero(charges, flows), charges, flows, order


def _draw(draw, n: int, dtype: torch.dtype) -> np.ndarray:
    """``draw(n)`` real values, or real + 1j * imaginary draws."""
    if dtype.is_complex:
        return draw(n) + 1j * draw(n)
    return draw(n)


def _host(values: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host draws cast to ``dtype`` (as numpy's ``astype`` rounds), then
    moved to ``device`` (default: the card)."""
    return torch.from_numpy(np.asarray(values)).to(dtype).to(
        default_device(device))


def zeros(indices: Sequence[Index], dtype=DEFAULT_DTYPE,
          device: Optional[Device] = None) -> BlockSparseTensor:
    n, charges, flows, order = _nnz(indices)
    return BlockSparseTensor(
        _host(np.zeros(n), torch_dtype(dtype), device), charges, flows,
        order)


def ones(indices: Sequence[Index], dtype=DEFAULT_DTYPE,
         device: Optional[Device] = None) -> BlockSparseTensor:
    n, charges, flows, order = _nnz(indices)
    return BlockSparseTensor(
        _host(np.ones(n), torch_dtype(dtype), device), charges, flows,
        order)


def randn(indices: Sequence[Index], dtype=DEFAULT_DTYPE, seed: Seed = 0,
          device: Optional[Device] = None) -> BlockSparseTensor:
    n, charges, flows, order = _nnz(indices)
    rng = np.random.default_rng(seed)
    dtype = torch_dtype(dtype)
    data = _draw(rng.standard_normal, n, dtype)
    return BlockSparseTensor(_host(data, dtype, device), charges, flows,
                             order)


def random(indices: Sequence[Index], boundaries=(0.0, 1.0),
           dtype=DEFAULT_DTYPE, seed: Seed = 0,
           device: Optional[Device] = None) -> BlockSparseTensor:
    n, charges, flows, order = _nnz(indices)
    rng = np.random.default_rng(seed)
    lo, hi = boundaries
    dtype = torch_dtype(dtype)
    data = _draw(lambda k: rng.uniform(lo, hi, k), n, dtype)
    return BlockSparseTensor(_host(data, dtype, device), charges, flows,
                             order)


def randn_like(t: BlockSparseTensor, seed: Seed = 0) -> BlockSparseTensor:
    """Normal draws in ``t``'s structure, dtype and device."""
    rng = np.random.default_rng(seed)
    data = _draw(rng.standard_normal, t.data.shape[0], t.dtype)
    return BlockSparseTensor(_host(data, t.dtype, t.device), t.flat_charges,
                             t.flat_flows, [list(g) for g in t._order])


def empty_like(t: BlockSparseTensor) -> BlockSparseTensor:
    return BlockSparseTensor(torch.empty_like(t.data), t.flat_charges,
                             t.flat_flows, [list(g) for g in t._order])
