"""Gauge factorizations and bond truncations of the DMRG sweeps.

Counterpart of the gauge and truncation part of
:mod:`tensornetwork_tpu.ops.decompositions`: ``ns_polar``, ``cholqr2``,
``svd_masked`` and ``subspace_truncate``; Householder QR is
``torch.linalg.qr``.  Every function works on stacks of matrices (leading
batch dimensions).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch


def ns_polar(m: torch.Tensor, quintic_iters: Optional[int] = None,
             cubic_iters: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar decomposition m = Q.P (Q column-isometric, P = Q^H m) by a
    matmul-only Newton-Schulz iteration: quintic steps (coefficients
    3.4445, -4.7750, 2.0315) inflate the small singular values, cubic
    steps polish.  Counts default to (14, 7) in float32 and (20, 10)
    otherwise, as in the JAX package.

    On an exactly rank-deficient panel the result is a PARTIAL isometry:
    the null columns stay zero."""
    if quintic_iters is None:
        quintic_iters = 14 if m.dtype == torch.float32 else 20
    if cubic_iters is None:
        cubic_iters = 7 if m.dtype == torch.float32 else 10
    k = m.shape[-1]
    nrm = torch.linalg.vector_norm(m, dim=(-2, -1), keepdim=True)
    X = m / torch.where(nrm > 0, nrm * 1.01, 1.0)
    eye = torch.eye(k, dtype=m.dtype, device=m.device)
    a, b, c = 3.4445, -4.7750, 2.0315
    for _ in range(quintic_iters):
        G = X.mH @ X
        X = a * X + X @ (b * G + c * (G @ G))
    for _ in range(cubic_iters):
        G = X.mH @ X
        X = 0.5 * X @ (3.0 * eye - G)
    return X, X.mH @ m


def cholqr2(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky-QR2: m = Q.R with Q column-orthonormal and R upper
    triangular, from two Gram/Cholesky passes (the second restores the
    orthogonality the first loses to the squared condition number).

    Each Gram matrix gets a relative diagonal jitter, max(1e3 eps, 1e-6)
    times its mean diagonal in the first pass and max(10 eps, 1e-12) in the
    second, so that the Cholesky stays finite on a rank-deficient panel;
    the directions it invents there are gauge-null.  As in the JAX
    package."""
    n = m.shape[-1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    eps = torch.finfo(m.dtype).eps

    def factor(a, floor, jfac):
        G = a.mH @ a
        jit = (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / n)[..., None, None]
        L = torch.linalg.cholesky(G + max(jfac * eps, floor) * jit * eye)
        # q = a L^-H, as the transpose of L^-1 a^T
        q = torch.linalg.solve_triangular(L, a.mT, upper=False).mT
        return q, L

    q1, L1 = factor(m, 1e-6, 1e3)
    q2, L2 = factor(q1, 1e-12, 10.0)
    return q2, L2.mT @ L1.mT


def qr(m: torch.Tensor, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """An isometric/rest split m = Q.R of a stack of tall matrices:
    ``"householder"`` (triangular R), ``"cholesky"`` (:func:`cholqr2`) or
    ``"polar"`` (:func:`ns_polar`)."""
    if impl == "householder":
        return torch.linalg.qr(m)
    if impl == "cholesky":
        return cholqr2(m)
    if impl == "polar":
        return ns_polar(m)
    raise ValueError(f"unknown qr_impl {impl!r}")


class MaskedSVD(NamedTuple):
    """Static-rank truncated SVD: ``u`` [..., m, k], ``s`` [..., k] (the
    discarded values zeroed), ``vh`` [..., k, n], ``num_kept`` [...] int32,
    ``trunc_sq_norm`` [...] the squared norm of everything discarded (the
    masked values and the tail beyond k)."""
    u: torch.Tensor
    s: torch.Tensor
    vh: torch.Tensor
    num_kept: torch.Tensor
    trunc_sq_norm: torch.Tensor


def svd_masked(matrix: torch.Tensor, max_singular_values: int,
               max_truncation_error: Optional[float] = None,
               relative: bool = False) -> MaskedSVD:
    """Truncated SVD whose output rank is always ``k = min(
    max_singular_values, min(m, n))``: a singular value that the
    truncation discards is zeroed in ``s``, its column of ``u`` and its row
    of ``vh`` are zeroed, and its weight is counted in ``trunc_sq_norm``.
    ``s[i]`` is kept iff the tail ``s[i:]`` has an L2 norm above
    ``max_truncation_error`` (times ``s[0]`` when ``relative``).
    Counterpart of the JAX package's ``svd_masked``.

    On the card the SVD is cuSOLVER's QR-iteration routine (gesvd): the
    default Jacobi routine's f32 singular vectors are orthonormal only to
    its tolerance, and a two-site sweep that builds its environments from
    them reported f32 Ritz energies ~1e-4 too high (measured on an H100 at
    N=10, chi=16)."""
    kw = {"driver": "gesvd"} if matrix.is_cuda else {}
    u, s, vh = torch.linalg.svd(matrix, full_matrices=False, **kw)
    k = min(int(max_singular_values), s.shape[-1])
    full_sq = (s * s).sum(-1)
    u_k, s_k, vh_k = u[..., :, :k], s[..., :k], vh[..., :k, :]
    if max_truncation_error is not None:
        err = torch.full(s.shape[:-1], float(max_truncation_error),
                         dtype=s.dtype, device=s.device)
        if relative:
            err = err * s[..., 0]
        tail_sq = torch.flip(torch.cumsum(torch.flip(s * s, (-1,)), -1), (-1,))
        keep = (torch.sqrt(tail_sq) > err[..., None])[..., :k]
    else:
        keep = torch.ones(s_k.shape, dtype=torch.bool, device=s.device)
    s_masked = torch.where(keep, s_k, 0.0)
    num_kept = keep.sum(-1).to(torch.int32)
    trunc_sq = full_sq - (s_masked * s_masked).sum(-1)
    u_k = torch.where(keep[..., None, :], u_k, 0.0)
    vh_k = torch.where(keep[..., :, None], vh_k, 0.0)
    return MaskedSVD(u_k, s_masked, vh_k, num_kept, trunc_sq)


class SubspaceTrunc(NamedTuple):
    """Matmul-only truncation: ``q`` [..., m, k] an isometry spanning (an
    approximation of) the dominant rank-k left-singular subspace, ``rest``
    [..., k, n] with ``q @ rest`` the projected matrix, ``trunc_sq_norm``
    [...] the discarded squared norm."""
    q: torch.Tensor
    rest: torch.Tensor
    trunc_sq_norm: torch.Tensor


_ORTH = {"qr": torch.linalg.qr, "cholqr2": cholqr2,
         "polar": ns_polar}


def subspace_truncate(matrix: torch.Tensor, k: int,
                      q0: Optional[torch.Tensor] = None, iters: int = 6,
                      key: Optional[torch.Generator] = None,
                      power: int = 1, orth: str = "qr",
                      polar_fast: Optional[Tuple[int, int]] = None
                      ) -> SubspaceTrunc:
    """Rank-``k`` truncation by warm-started subspace iteration on the
    normalised Gram matrix ``G = A A^T / |A A^T|``: ``iters`` steps of
    ``q <- orth(G^power q)``, then ``rest = q^T A``.  Equal to the
    truncated SVD as a projector once converged; the basis inside the
    subspace is gauge, not the singular basis.

    ``q0`` [..., m, k]: the warm start (need not be orthonormal); the
    first k columns of the identity when None, plus ``0.01`` times a
    standard normal draw from ``key`` (a :class:`torch.Generator` on the
    matrix's device) when one is given.  ``orth``: ``"qr"``
    (Householder), ``"cholqr2"``, ``"polar"`` (:func:`ns_polar`; leaves
    exact-null columns zero) or ``"polar+qr"`` (polar, then one final
    Householder QR).  ``polar_fast=(quintic, cubic)`` with ``"polar"``:
    that shorter Newton-Schulz schedule on every iterate but the last.
    Counterpart of the JAX package's ``subspace_truncate``; a
    ``torch.Generator`` draws other numbers than a JAX key of the same
    seed."""
    m = matrix.shape[-2]
    if q0 is None:
        q0 = torch.eye(m, k, dtype=matrix.dtype, device=matrix.device
                       ).expand(matrix.shape[:-2] + (m, k))
        if key is not None:
            q0 = q0 + 0.01 * torch.randn(q0.shape, generator=key,
                                         dtype=matrix.dtype,
                                         device=matrix.device)
    G = matrix @ matrix.mT
    gnorm = torch.linalg.vector_norm(G, dim=(-2, -1), keepdim=True)
    Gn = G / torch.where(gnorm > 0, gnorm, 1.0)
    if orth == "polar" and polar_fast is not None:
        fast = functools.partial(ns_polar, quintic_iters=polar_fast[0],
                                 cubic_iters=polar_fast[1])
        orth_fns = [fast] * (iters - 1) + [ns_polar]
    elif orth == "polar+qr":
        orth_fns = [ns_polar] * (iters - 1) + [_ORTH["qr"]]
    elif orth in _ORTH:
        orth_fns = [_ORTH[orth]] * iters
    else:
        raise ValueError(f"unknown orth {orth!r}")
    q = q0
    for orth_fn in orth_fns:
        y = Gn @ q
        for _ in range(power - 1):
            y = Gn @ y
        q = orth_fn(y)[0]
    rest = q.mT @ matrix
    trunc = (matrix * matrix).sum((-2, -1)) - (rest * rest).sum((-2, -1))
    return SubspaceTrunc(q, rest, torch.clamp(trunc, min=0.0))
