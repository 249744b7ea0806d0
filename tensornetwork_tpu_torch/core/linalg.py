"""Functional linear-algebra API over :class:`Tensor`.

Counterpart of :mod:`tensornetwork_tpu.core.linalg` (reference
``linalg/operations.py:40-308``, ``linalg/linalg.py:19-226``,
``linalg/initialization.py:28-202``, ``linalg/krylov.py:113-264``): free
functions on torch tensors, tensor initializers, and Krylov wrappers over
``Tensor`` matvecs on the port's :mod:`~tensornetwork_tpu_torch.ops.krylov`.
Initializers default to float64, as the JAX package's do, and make their
tensors on ``device`` (default: the card).  ``randn`` and
``random_uniform`` draw from a ``torch.Generator`` seeded with ``seed``:
the same seed gives the same tensor on the same device, but other
numbers than the JAX package's ``jax.random`` draws.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (Device, as_tensor,
                                            default_device, get_config)
from tensornetwork_tpu_torch.core.network import _tensordot, conj as _conj
from tensornetwork_tpu_torch.core.tensor import Tensor
from tensornetwork_tpu_torch.ops import decompositions as _decomp
from tensornetwork_tpu_torch.ops import krylov as _krylov
from tensornetwork_tpu_torch.ops.ncon import ncon as _ncon


def _unwrap(x) -> torch.Tensor:
    return x.array if isinstance(x, Tensor) else as_tensor(x)


# -- operations (reference ``linalg/operations.py``) -------------------------

def tensordot(a, b, axes) -> Tensor:
    return Tensor(_tensordot(_unwrap(a), _unwrap(b), axes))


def einsum(expr: str, *tensors, optimize="auto") -> Tensor:
    """``torch.einsum``; ``optimize`` is accepted for the JAX package's
    signature (torch picks its own order)."""
    arrays = [_unwrap(t) for t in tensors]
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in arrays))
    with get_config().precision():
        return Tensor(torch.einsum(expr, *(t.to(dtype) for t in arrays)))


def reshape(t, shape) -> Tensor:
    return Tensor(_unwrap(t).reshape(tuple(shape)))


def transpose(t, perm=None) -> Tensor:
    return Tensor(t).transpose(perm)


def take_slice(t, start_indices, slice_sizes) -> Tensor:
    """``lax.dynamic_slice``: a negative start counts from the end, and
    starts are clamped so that the slice lies inside the tensor."""
    arr = _unwrap(t)
    for axis, (start, size) in enumerate(zip(start_indices, slice_sizes)):
        start = int(start) + (arr.shape[axis] if int(start) < 0 else 0)
        start = min(max(start, 0), arr.shape[axis] - int(size))
        arr = arr.narrow(axis, start, int(size))
    return Tensor(arr)


def shape(t) -> Tuple[int, ...]:
    return tuple(_unwrap(t).shape)


def sqrt(t) -> Tensor:
    return Tensor(torch.sqrt(_unwrap(t)))


def outer(a, b) -> Tensor:
    return tensordot(a, b, 0)


def ncon(tensors, network_structure, con_order=None, out_order=None,
         check_network=True) -> Tensor:
    arrays = [_unwrap(t) for t in tensors]
    return Tensor(_ncon(arrays, network_structure, con_order, out_order,
                        check_network))


def diagonal(t, offset=0, axis1=-2, axis2=-1) -> Tensor:
    return Tensor(torch.diagonal(_unwrap(t), offset, axis1, axis2))


def diagflat(t, k=0) -> Tensor:
    return Tensor(torch.diag(_unwrap(t).reshape(-1), k))


def trace(t, offset=0, axis1=-2, axis2=-1) -> Tensor:
    return Tensor(torch.diagonal(_unwrap(t), offset, axis1, axis2).sum(-1))


def sign(t) -> Tensor:
    arr = _unwrap(t)
    if arr.is_complex():
        return Tensor(torch.sgn(arr))
    return Tensor(torch.sign(arr))


def abs(t) -> Tensor:  # noqa: A001 - reference exports `abs`
    return Tensor(torch.abs(_unwrap(t)))


def conj(t) -> Tensor:
    """Complex conjugate (reference ``linalg/operations.py:142``)."""
    return Tensor(_conj(_unwrap(t)))


def hconj(t, perm=None) -> Tensor:
    """Hermitian conjugate: conjugate + transpose (reference
    ``linalg/operations.py:153``)."""
    return Tensor(_conj(transpose(t, perm).array))


def sin(t) -> Tensor:
    """(reference ``linalg/operations.py:165``)"""
    return Tensor(torch.sin(_unwrap(t)))


def cos(t) -> Tensor:
    """(reference ``linalg/operations.py:177``)"""
    return Tensor(torch.cos(_unwrap(t)))


def exp(t) -> Tensor:
    """Elementwise exponential (reference ``linalg/operations.py:189``)."""
    return Tensor(torch.exp(_unwrap(t)))


def log(t) -> Tensor:
    """Natural logarithm (reference ``linalg/operations.py:201``)."""
    return Tensor(torch.log(_unwrap(t)))


def pivot(t, pivot_axis: int = -1) -> Tensor:
    """Reshape into a matrix around ``pivot_axis``."""
    arr = _unwrap(t)
    if pivot_axis < 0:
        pivot_axis += arr.ndim
    left = int(np.prod(arr.shape[:pivot_axis], dtype=np.int64))
    return Tensor(arr.reshape(left, -1))


def kron(a, b) -> Tensor:
    """Tensor Kronecker product (reference ``linalg/node_linalg.py:331``):
    for even-rank operands (k row axes then k column axes) the result has
    rows (a_rows, b_rows) and columns (a_cols, b_cols), so matricizing
    reproduces ``np.kron``."""
    A, B = _unwrap(a), _unwrap(b)
    if A.ndim % 2 != 0 or B.ndim % 2 != 0:
        raise ValueError("kron requires even-rank tensors")
    ka, kb = A.ndim // 2, B.ndim // 2
    out = outer(A, B).array
    # axes: (a_rows, a_cols, b_rows, b_cols) -> (a_rows, b_rows,
    #        a_cols, b_cols)
    perm = (list(range(ka)) + list(range(2 * ka, 2 * ka + kb))
            + list(range(ka, 2 * ka))
            + list(range(2 * ka + kb, 2 * (ka + kb))))
    return Tensor(out.permute(perm))


def norm(t) -> torch.Tensor:
    return torch.linalg.vector_norm(_unwrap(t).reshape(-1))


def inv(t) -> Tensor:
    arr = _unwrap(t)
    if arr.ndim != 2:
        raise ValueError("inv requires a matrix")
    return Tensor(torch.linalg.inv(arr))


def expm(t) -> Tensor:
    arr = _unwrap(t)
    if arr.ndim != 2:
        raise ValueError("expm requires a matrix")
    return Tensor(torch.linalg.matrix_exp(arr))


# -- decompositions (reference ``linalg/linalg.py``) -------------------------

def svd(t, pivot_axis: int = -1, max_singular_values=None,
        max_truncation_error=None, relative=False):
    u, s, vh, s_rest = _decomp.svd(_unwrap(t), pivot_axis,
                                   max_singular_values,
                                   max_truncation_error, relative)
    return Tensor(u), Tensor(s), Tensor(vh), Tensor(s_rest)


def qr(t, pivot_axis: int = -1, non_negative_diagonal: bool = False):
    q, r = _decomp.tensor_qr(_unwrap(t), pivot_axis, non_negative_diagonal)
    return Tensor(q), Tensor(r)


def rq(t, pivot_axis: int = -1, non_negative_diagonal: bool = False):
    r, q = _decomp.rq(_unwrap(t), pivot_axis, non_negative_diagonal)
    return Tensor(r), Tensor(q)


def eigh(t, pivot_axis: int = -1):
    e, v = _decomp.eigh(_unwrap(t), pivot_axis)
    return Tensor(e), Tensor(v)


# -- initialization (reference ``linalg/initialization.py``) -----------------

def eye(N: int, dtype: torch.dtype = torch.float64, M: Optional[int] = None,
        device: Optional[Device] = None) -> Tensor:
    return Tensor(torch.eye(N, N if M is None else M, dtype=dtype,
                            device=default_device(device)))


def zeros(shape, dtype: torch.dtype = torch.float64,
          device: Optional[Device] = None) -> Tensor:
    return Tensor(torch.zeros(tuple(shape), dtype=dtype,
                              device=default_device(device)))


def ones(shape, dtype: torch.dtype = torch.float64,
         device: Optional[Device] = None) -> Tensor:
    return Tensor(torch.ones(tuple(shape), dtype=dtype,
                             device=default_device(device)))


def _generator(seed: Optional[int], device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    if seed is None:
        g.seed()  # a fresh seed, as the reference draws one
    else:
        g.manual_seed(int(seed))
    return g


def randn(shape, dtype: torch.dtype = torch.float64,
          seed: Optional[int] = None,
          device: Optional[Device] = None) -> Tensor:
    """Standard normal entries; complex dtypes get a standard normal real
    and imaginary part each, as the JAX package's."""
    device = default_device(device)
    g = _generator(seed, device)
    shape = tuple(shape)
    if dtype.is_complex:
        real = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=g, dtype=real, device=device)
        im = torch.randn(shape, generator=g, dtype=real, device=device)
        return Tensor(torch.complex(re, im))
    return Tensor(torch.randn(shape, generator=g, dtype=dtype, device=device))


def random_uniform(shape, dtype: torch.dtype = torch.float64,
                   seed: Optional[int] = None,
                   boundaries: Tuple[float, float] = (0.0, 1.0),
                   device: Optional[Device] = None) -> Tensor:
    """Entries uniform in ``boundaries``; complex dtypes get a uniform real
    and imaginary part each."""
    device = default_device(device)
    g = _generator(seed, device)
    lo, hi = boundaries
    shape = tuple(shape)
    real = torch.empty((), dtype=dtype).real.dtype

    def draw():
        u = torch.rand(shape, generator=g, dtype=real, device=device)
        return lo + (hi - lo) * u

    if dtype.is_complex:
        return Tensor(torch.complex(draw(), draw()))
    return Tensor(draw())


# -- Krylov wrappers (reference ``linalg/krylov.py``) ------------------------

def _tensor_matvec(A: Callable, args: Optional[List] = None):
    uargs = [Tensor(_unwrap(a)) for a in (args or [])]

    def mv(x):
        return _unwrap(A(Tensor(x), *uargs))

    return mv


def _start(initial_state, shape, dtype, device):
    if initial_state is None:
        if shape is None or dtype is None:
            raise ValueError("provide initial_state or (shape, dtype)")
        initial_state = randn(shape, dtype, device=device)
    return _unwrap(initial_state)


def eigsh_lanczos(A: Callable, args=None, initial_state: Tensor = None,
                  shape=None, dtype=None, num_krylov_vecs: int = 20,
                  numeig: int = 1, tol: float = 1e-8, delta: float = 1e-8,
                  ndiag: int = 10, reorthogonalize: bool = True,
                  num_restarts: int = 1, device: Optional[Device] = None):
    """(reference ``linalg/krylov.py:113``.)

    Runs a fixed number of Lanczos steps (``num_krylov_vecs``, repeated
    ``num_restarts`` times from the best Ritz vector) on the port's
    ``krylov.eigsh_lanczos`` with a batch of one; ``tol``/``ndiag`` are
    accepted for the signature, as in the JAX package."""
    x0 = _start(initial_state, shape, dtype, device)
    mv = _tensor_matvec(A, args)
    evals, evecs = _krylov.eigsh_lanczos(
        lambda x: mv(x[0])[None], x0[None], num_krylov_vecs=num_krylov_vecs,
        numeig=numeig, reorthogonalize=reorthogonalize, delta=delta,
        num_restarts=num_restarts)
    return ([evals[0, k] for k in range(numeig)],
            [Tensor(evecs[0, k]) for k in range(numeig)])


def eigs(A: Callable, args=None, initial_state: Tensor = None, shape=None,
         dtype=None, num_krylov_vecs: int = 20, numeig: int = 1,
         tol: float = 1e-8, which: str = "LM", maxiter: int = 2,
         device: Optional[Device] = None):
    """(reference ``linalg/krylov.py:176``)"""
    x0 = _start(initial_state, shape, dtype, device)
    evals, evecs = _krylov.eigs(
        _tensor_matvec(A, args), x0, num_krylov_vecs=num_krylov_vecs,
        numeig=numeig, which=which, maxiter=maxiter, tol=tol)
    return [evals[k] for k in range(numeig)], [Tensor(v) for v in evecs]


def gmres(A: Callable, b: Tensor, args=None, x0: Tensor = None,
          tol: float = 1e-8, atol: float = 0.0,
          num_krylov_vectors: int = 20, maxiter: int = 1):
    """(reference ``linalg/krylov.py:264``)"""
    x, info = _krylov.gmres(
        _tensor_matvec(A, args), _unwrap(b),
        x0=None if x0 is None else _unwrap(x0), tol=tol, atol=atol,
        num_krylov_vectors=num_krylov_vectors, maxiter=maxiter)
    return Tensor(x), info
