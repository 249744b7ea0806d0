"""Gauge factorizations of the DMRG sweep.

Counterpart of the gauge part of :mod:`tensornetwork_tpu.ops.decompositions`
(``ns_polar``); Householder QR is ``torch.linalg.qr``.  Every function
works on stacks of matrices (leading batch dimensions).
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def qr(m: torch.Tensor, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """An isometric/rest split m = Q.R of a stack of tall matrices:
    ``"householder"`` (triangular R) or ``"polar"`` (:func:`ns_polar`)."""
    if impl == "householder":
        return torch.linalg.qr(m)
    if impl == "polar":
        return ns_polar(m)
    raise ValueError(f"unknown qr_impl {impl!r}")
