"""Lanczos eigensolver, batched over a leading axis.

Counterpart of the main-path part of :mod:`tensornetwork_tpu.ops.krylov`:
the same static iteration counts, the same invariant-subspace masks,
``delta`` and +1e10 sentinels, written as a Python loop over the Krylov
steps with the batch as the leading dimension of every tensor.  This plain
Lanczos is also the oracle of the fused-Lanczos kernel.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

LARGE = 1e10  # diagonal sentinel of a dead Lanczos step


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-instance <a, b> of (B, n) tensors."""
    return (torch.conj(a) * b).sum(-1)


def lanczos_factorization(matvec: Callable, v0: torch.Tensor,
                          num_krylov_vecs: int,
                          reorthogonalize: bool = True,
                          delta: float = 1e-8
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Run ``m = num_krylov_vecs`` Lanczos steps on every instance.

    ``v0``: (B, n); ``matvec`` maps (B, n) to (B, n).  Returns ``(V,
    alphas, betas)`` with ``V`` (B, m, n) orthonormal rows, ``alphas``
    (B, m) and ``betas`` (B, m-1) the tridiagonal projection."""
    B, n = v0.shape
    m = num_krylov_vecs
    nrm = torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    v = torch.where(nrm > delta, v0 / torch.where(nrm > delta, nrm, 1.0),
                    torch.zeros_like(v0))
    V = torch.zeros((B, m, n), dtype=v0.dtype, device=v0.device)
    V[:, 0] = v
    alphas = torch.zeros((B, m), dtype=v0.dtype, device=v0.device)
    betas = torch.zeros((B, max(m - 1, 0)), dtype=v0.dtype, device=v0.device)
    alive = torch.ones((B,), dtype=torch.bool, device=v0.device)
    for j in range(m):
        vj = V[:, j]
        w = matvec(vj).to(V.dtype)
        alpha = _bdot(vj, w)
        w = w - alpha[:, None] * vj
        if j > 0:
            w = w - betas[:, j - 1, None] * V[:, j - 1]
        if reorthogonalize:
            # twice-is-enough classical Gram-Schmidt against rows <= j
            for _ in range(2):
                coeffs = torch.einsum("Bkn,Bn->Bk", torch.conj(V[:, :j + 1]), w)
                w = w - torch.einsum("Bkn,Bk->Bn", V[:, :j + 1], coeffs)
        wnorm = torch.linalg.vector_norm(w, dim=-1)
        alphas[:, j] = torch.where(alive, alpha, LARGE)
        alive = alive & (wnorm > delta)
        if j < m - 1:
            betas[:, j] = torch.where(alive, wnorm, 0.0)
            safe = torch.where(wnorm > delta, wnorm, 1.0)[:, None]
            vnext = torch.where((wnorm > delta)[:, None], w / safe,
                                torch.zeros_like(w))
            V[:, j + 1] = torch.where(alive[:, None], vnext,
                                      torch.zeros_like(vnext))
    return V, alphas, betas


def tridiag_ritz(alphas: torch.Tensor, betas: torch.Tensor,
                 method: str = "eigh",
                 power_iters: int = 60) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest Ritz pair of real symmetric tridiagonal matrices.

    ``alphas`` (..., m), ``betas`` (..., m-1).  Returns ``(lam (...,), w
    (..., m))``.  ``"power"`` is the steepest-descent iteration with a
    closed-form 2x2 Ritz step started from e1 (a Rayleigh quotient in the
    Krylov space, so variational); ``"eigh"`` is exact."""
    m = alphas.shape[-1]
    T = torch.diag_embed(alphas)
    if m > 1:
        T = T + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    if method == "power":
        w = torch.zeros_like(alphas)
        w[..., 0] = 1.0

        def mv(u):
            return (T @ u[..., None])[..., 0]

        def dot(a, b):
            return (a * b).sum(-1)

        for _ in range(power_iters):
            Tw = mv(w)
            lam = dot(w, Tw)
            r = Tw - lam[..., None] * w
            r = r - dot(w, r)[..., None] * w
            rn = torch.linalg.vector_norm(r, dim=-1)
            u = r / torch.where(rn > 1e-30, rn, 1.0)[..., None]
            Tu = mv(u)
            h = dot(w, Tu)
            g = dot(u, Tu)
            disc = torch.sqrt(torch.clamp((lam - g) ** 2 / 4 + h * h, min=0.0))
            mu = (lam + g) / 2 - disc
            v = h[..., None] * w + (mu - lam)[..., None] * u
            vn = torch.linalg.vector_norm(v, dim=-1)
            w2 = v / torch.where(vn > 1e-30, vn, 1.0)[..., None]
            w = torch.where((rn > 1e-14)[..., None], w2, w)
        return dot(w, mv(w)), w
    if method != "eigh":
        raise ValueError(f"unknown Ritz method {method!r}")
    evals, evecs = torch.linalg.eigh(T)
    return evals[..., 0], evecs[..., :, 0]


def eigsh_lanczos(matvec: Callable, initial_state: torch.Tensor,
                  num_krylov_vecs: int = 20, numeig: int = 1,
                  reorthogonalize: bool = True, delta: float = 1e-8,
                  ritz_method: str = "eigh",
                  power_iters: int = 60
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest ``numeig`` eigenpairs of a Hermitian operator, per instance.

    ``initial_state``: (B, *shape); ``matvec`` maps (B, *shape) to the
    same.  Returns ``(evals (B, numeig), vecs (B, numeig, *shape))``."""
    B, shape = initial_state.shape[0], initial_state.shape[1:]
    n = initial_state[0].numel()
    num_krylov_vecs = min(num_krylov_vecs, n)

    def mv(x):
        return matvec(x.reshape((B,) + shape)).reshape(B, n)

    V, alphas, betas = lanczos_factorization(
        mv, initial_state.reshape(B, n), num_krylov_vecs, reorthogonalize,
        delta)
    alphas, betas = alphas.real, betas.real
    if ritz_method == "power" and numeig == 1:
        lam, w = tridiag_ritz(alphas, betas, "power", power_iters)
        evals, evecs = lam[:, None], w[:, :, None]
    else:
        T = torch.diag_embed(alphas)
        if betas.shape[-1]:
            T = T + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
        evals, evecs = torch.linalg.eigh(T)
    vecs = torch.einsum("Bkn,Bke->Ben", V, evecs[:, :, :numeig].to(V.dtype))
    norms = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
    vecs = vecs / torch.where(norms > delta, norms, 1.0)
    return evals[:, :numeig], vecs.reshape((B, numeig) + tuple(shape))
