"""Lanczos eigensolver, batched over a leading axis.

Counterpart of the Lanczos part of :mod:`tensornetwork_tpu.ops.krylov`:
the same static iteration counts, the same invariant-subspace masks,
``delta`` and +1e10 sentinels, written as a Python loop over the Krylov
steps with the batch as the leading dimension of every tensor.  This plain
Lanczos is also the oracle of the fused-Lanczos kernel.  The exponential
``exp(coeff * A) v`` (:func:`expm_multiply_lanczos`) takes real or complex
states; the JAX package's split-complex forms (``_sc``) take complex
tensors here, which the card has natively.
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
    return _lanczos(matvec, v0, num_krylov_vecs, reorthogonalize, delta,
                    False)


def lanczos_factorization_sc(matvec: Callable, v0: torch.Tensor,
                             num_krylov_vecs: int, delta: float = 1e-8
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """:func:`lanczos_factorization` of a Hermitian operator on complex
    states, reorthogonalised, with ``alpha_j = Re<v_j, H v_j>`` (real by
    Hermiticity) and real ``(alphas, betas)``.  Counterpart of the JAX
    package's split-complex ``lanczos_factorization_sc``."""
    V, alphas, betas = _lanczos(matvec, v0, num_krylov_vecs, True, delta,
                                True)
    return V, alphas.real, betas.real


def _lanczos(matvec, v0, num_krylov_vecs, reorthogonalize, delta,
             real_alpha):
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
        if real_alpha:
            alpha = alpha.real.to(w.dtype)
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


def _coeff_parts(coeff, B: int, dtype: torch.dtype, device):
    """(cr, ci) of a coefficient -- a number or a tensor of shape () or
    (B,) -- as real (B,) tensors of ``dtype``; ``ci`` is None for a real
    coefficient (a float, or a tensor of a real dtype)."""
    if isinstance(coeff, torch.Tensor):
        cr, ci = ((coeff.real, coeff.imag) if coeff.is_complex()
                  else (coeff, None))
    else:
        cr = complex(coeff).real
        ci = complex(coeff).imag if isinstance(coeff, complex) else None

    def per_instance(c):
        return torch.as_tensor(c, dtype=dtype, device=device).expand(B)

    return per_instance(cr), None if ci is None else per_instance(ci)


def expm_weights(alphas: torch.Tensor, betas: torch.Tensor,
                 coeff) -> torch.Tensor:
    """Krylov weights ``exp(coeff T) e1`` of real tridiagonal projections
    (``alphas`` (B, m), ``betas`` (B, m-1)), by the eigendecomposition of
    T.  Dead steps' +1e10 sentinels become the first alpha (their basis
    rows are zero, so the result does not change and exp stays finite).
    ``coeff``: a number or a (B,) tensor, real or complex; a complex one
    is evaluated as ``exp(cr l) (cos(ci l) + i sin(ci l))``.  Returns (B,
    m), complex for a complex coefficient."""
    alphas = torch.where(alphas.abs() >= 1e9, alphas[:, :1], alphas)
    T = torch.diag_embed(alphas)
    if betas.shape[-1]:
        T = T + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    evals, evecs = torch.linalg.eigh(T)
    cr, ci = _coeff_parts(coeff, alphas.shape[0], evals.dtype, evals.device)
    amp = torch.exp(cr[:, None] * evals) * evecs[:, 0, :]

    def rotate(c):
        return (evecs @ c[:, :, None])[:, :, 0]

    if ci is None:
        return rotate(amp)
    ph = ci[:, None] * evals
    return torch.complex(rotate(amp * torch.cos(ph)),
                         rotate(amp * torch.sin(ph)))


def combine_basis(V: torch.Tensor, weights: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """``scale_b * sum_k weights[b, k] V[b, k]`` of a basis V (B, m, ...),
    in the wider of the two dtypes."""
    dtype = torch.promote_types(V.dtype, weights.dtype)
    y = torch.einsum("Bk,Bk...->B...", weights.to(dtype), V.to(dtype))
    return y * scale.to(dtype).reshape((-1,) + (1,) * (y.dim() - 1))


def _expm_multiply(factorization, matvec, v, coeff, num_krylov_vecs, delta):
    B, shape = v.shape[0], v.shape[1:]
    n = v[0].numel()

    def mv(x):
        return matvec(x.reshape(v.shape)).reshape(B, n)

    vf = v.reshape(B, n)
    V, alphas, betas = factorization(mv, vf, min(num_krylov_vecs, n),
                                     delta=delta)
    weights = expm_weights(alphas.real, betas.real, coeff)
    out = combine_basis(V, weights, torch.linalg.vector_norm(vf, dim=-1))
    return out.reshape((B,) + tuple(shape))


def expm_multiply_lanczos(matvec: Callable, v: torch.Tensor, coeff,
                          num_krylov_vecs: int = 20,
                          delta: float = 1e-8) -> torch.Tensor:
    """``exp(coeff * A) v`` per instance for a Hermitian ``A``, by the
    reorthogonalised Lanczos projection (:func:`lanczos_factorization`) and
    the exponential of the small tridiagonal (:func:`expm_weights`).

    ``v``: (B, *shape), real or complex; ``matvec`` maps (B, *shape) to the
    same.  ``coeff``: a number or a (B,) tensor, real (imaginary time) or
    complex (real time: ``-1j * dt``).  The norm of ``v`` is kept up to the
    Krylov projection error.  Counterpart of the JAX package's
    ``expm_multiply_lanczos``, batched."""
    return _expm_multiply(lanczos_factorization, matvec, v, coeff,
                          num_krylov_vecs, delta)


def expm_multiply_lanczos_sc(matvec: Callable, v: torch.Tensor, coeff,
                             num_krylov_vecs: int = 20,
                             delta: float = 1e-8) -> torch.Tensor:
    """:func:`expm_multiply_lanczos` on complex states through
    :func:`lanczos_factorization_sc` (real alphas).  Counterpart of the
    JAX package's split-complex ``expm_multiply_lanczos_sc``; ``coeff`` as
    there, or a (B,) tensor of per-instance coefficients."""
    return _expm_multiply(lanczos_factorization_sc, matvec, v, coeff,
                          num_krylov_vecs, delta)
