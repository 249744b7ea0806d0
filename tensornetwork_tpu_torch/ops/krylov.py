"""Krylov solvers: Lanczos batched over a leading axis; Arnoldi, the
implicitly restarted eigensolvers and GMRES on one operator.

Counterpart of :mod:`tensornetwork_tpu.ops.krylov`.  The Lanczos part
keeps the same static iteration counts, the same invariant-subspace masks,
``delta`` and +1e10 sentinels, written as a Python loop over the Krylov
steps with the batch as the leading dimension of every tensor.  This plain
Lanczos is also the oracle of the fused-Lanczos kernel.  The exponential
``exp(coeff * A) v`` (:func:`expm_multiply_lanczos`) takes real or complex
states; the JAX package's split-complex forms (``_sc``) take complex
tensors here, which the card has natively.

The rest keeps the JAX package's unbatched signatures (``matvec`` maps a
state of ``initial_state``'s shape to the same): :func:`arnoldi_factorization`,
:func:`eigs` (implicitly restarted, :func:`iram`, or explicit restarts),
:func:`eigsh`, :func:`ir_lanczos` and :func:`gmres` / :func:`gmres_kernel`.
The JAX package runs each restart loop inside one compiled ``while_loop``;
here the loop is Python, and each restart ends in one host check of its
convergence test (counted in :data:`counts`).  The small eigenproblems of
the restarts come from ``torch.linalg.eig``/``eigh`` (the TPU lacked a
nonsymmetric eig and took shifts from a real double-shift QR iteration);
the selection, the residual test and the dead-row handling are the JAX
package's.  GMRES builds the (m+1) x m Hessenberg matrix over the m
Arnoldi steps and solves its least-squares problem once per restart by a
QR on the device, where the JAX package rotates each new column by Givens
rotations in a loop over all m rows.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.ops.decompositions import lapack_factor
from tensornetwork_tpu_torch.utils import tracing

LARGE = 1e10  # diagonal sentinel of a dead Lanczos step

# Since the last reset_counts(): GMRES restarts, and the host checks (one
# device-to-host sync each) that end a restart loop -- GMRES's residual,
# the restarted Arnoldi's convergence test and the VUMPS Ritz residual.
counts = {"gmres_restarts": 0, "host_checks": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


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


def _norm(v: torch.Tensor, reduce) -> torch.Tensor:
    """Per-instance norm of (B, n) rows; with ``reduce``, of rows whose
    blocks lie on several ranks (``reduce`` sums a partial over them)."""
    if reduce is None:
        return torch.linalg.vector_norm(v, dim=-1)
    return torch.sqrt(reduce((torch.conj(v) * v).real.sum(-1)))


@tracing.spanned("lanczos")
def _lanczos(matvec, v0, num_krylov_vecs, reorthogonalize, delta,
             real_alpha, reduce=None):
    """``reduce``: None, or the sum over ranks of a per-rank partial, for
    vectors whose entries are split over ranks (each rank holds a block of
    every row, and each inner product is a local partial and one
    ``reduce``)."""
    B, n = v0.shape
    m = num_krylov_vecs
    red = (lambda x: x) if reduce is None else reduce
    nrm = _norm(v0, reduce)[:, None]
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
        alpha = red(_bdot(vj, w))
        if real_alpha:
            alpha = alpha.real.to(w.dtype)
        w = w - alpha[:, None] * vj
        if j > 0:
            w = w - betas[:, j - 1, None] * V[:, j - 1]
        if reorthogonalize:
            # twice-is-enough classical Gram-Schmidt against rows <= j
            for _ in range(2):
                coeffs = red(torch.einsum("Bkn,Bn->Bk",
                                          torch.conj(V[:, :j + 1]), w))
                w = w - torch.einsum("Bkn,Bk->Bn", V[:, :j + 1], coeffs)
        wnorm = _norm(w, reduce)
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


def _tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """The dense (..., m, m) matrix of tridiagonal projections."""
    T = torch.diag_embed(alphas)
    if betas.shape[-1]:
        T = T + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    return T


def tridiag_ritz_power_plain(alphas: torch.Tensor, betas: torch.Tensor,
                             power_iters: int = 60
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The power Ritz step on PyTorch operations: the twin of K10
    (:func:`~tensornetwork_tpu_torch.ops.kernels.tridiag_ritz_power`),
    which :func:`tridiag_ritz` runs for CPU tensors.  Steepest descent
    with a closed-form 2x2 Ritz step, started from e1 (a Rayleigh
    quotient in the Krylov space, so variational)."""
    T = _tridiag(alphas, betas)
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
        # a converged w whose residual is rounding noise can give h = 0
        # and mu = lam exactly (v = 0): keep w rather than zero it
        w = torch.where(((rn > 1e-14) & (vn > 1e-30))[..., None], w2, w)
    return dot(w, mv(w)), w


@tracing.spanned("ritz")
def tridiag_ritz(alphas: torch.Tensor, betas: torch.Tensor,
                 method: str = "eigh",
                 power_iters: int = 60) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest Ritz pair of real symmetric tridiagonal matrices.

    ``alphas`` (..., m), ``betas`` (..., m-1).  Returns ``(lam (...,), w
    (..., m))``.  ``"power"`` is the steepest-descent iteration with a
    closed-form 2x2 Ritz step started from e1 (a Rayleigh quotient in the
    Krylov space, so variational): one launch of K10 for CUDA tensors (m
    <= 64; anything it does not take raises), its twin
    :func:`tridiag_ritz_power_plain` for CPU tensors, counted as
    ``ritz.kernel`` / ``ritz.plain`` in :data:`tracing.counts`.
    ``"eigh"`` is exact."""
    if method == "power":
        if alphas.device.type == "cpu":
            tracing.add("ritz.plain")
            return tridiag_ritz_power_plain(alphas, betas, power_iters)
        # kernels imports this module
        from tensornetwork_tpu_torch.ops import kernels
        tracing.add("ritz.kernel")
        return kernels.tridiag_ritz_power(alphas, betas, power_iters)
    if method != "eigh":
        raise ValueError(f"unknown Ritz method {method!r}")
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
    return evals[..., 0], evecs[..., :, 0]


def eigsh_lanczos(matvec: Callable, initial_state: torch.Tensor,
                  num_krylov_vecs: int = 20, numeig: int = 1,
                  reorthogonalize: bool = True, delta: float = 1e-8,
                  num_restarts: int = 1, ritz_method: str = "eigh",
                  power_iters: int = 60,
                  reduce: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest ``numeig`` eigenpairs of a Hermitian operator, per instance.

    ``initial_state``: (B, *shape); ``matvec`` maps (B, *shape) to the
    same.  Returns ``(evals (B, numeig), vecs (B, numeig, *shape))``.
    ``num_restarts > 1`` repeats the factorization from each instance's
    best Ritz vector so far, trading matvecs for basis memory, as the JAX
    package's ``eigsh_lanczos`` does.  ``reduce``: for states split over
    ranks, the sum over them of a per-rank partial (see
    :func:`_lanczos`); ``initial_state`` and ``matvec`` are then this
    rank's block."""
    B, shape = initial_state.shape[0], initial_state.shape[1:]
    n = initial_state[0].numel()
    if reduce is None:
        num_krylov_vecs = min(num_krylov_vecs, n)

    def mv(x):
        return matvec(x.reshape((B,) + shape)).reshape(B, n)

    def one_pass(state):
        V, alphas, betas = _lanczos(mv, state, num_krylov_vecs,
                                    reorthogonalize, delta, False, reduce)
        alphas, betas = alphas.real, betas.real
        if ritz_method == "power" and numeig == 1:
            lam, w = tridiag_ritz(alphas, betas, "power", power_iters)
            evals, evecs = lam[:, None], w[:, :, None]
        else:
            with tracing.span("ritz"):
                evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
        vecs = torch.einsum("Bkn,Bke->Ben", V,
                            evecs[:, :, :numeig].to(V.dtype))
        norms = _norm(vecs.reshape(-1, n), reduce).reshape(
            vecs.shape[:-1] + (1,))
        return evals[:, :numeig], vecs / torch.where(norms > delta, norms,
                                                     1.0)

    evals, vecs = one_pass(initial_state.reshape(B, n))
    for _ in range(num_restarts - 1):
        evals, vecs = one_pass(vecs[:, 0])
    return evals, vecs.reshape((B, numeig) + tuple(shape))


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


# ---------------------------------------------------------------------------
# Arnoldi and the implicitly restarted eigensolvers (one operator)
# ---------------------------------------------------------------------------


def _flat(matvec: Callable, shape) -> Callable:
    return lambda x: matvec(x.reshape(shape)).reshape(-1)


def _normalized_or_zero(w: torch.Tensor, wnorm: torch.Tensor,
                        delta: float) -> torch.Tensor:
    alive = wnorm > delta
    return torch.where(alive, w / torch.where(alive, wnorm, 1.0),
                       torch.zeros_like(w))


def arnoldi_factorization(matvec: Callable, v0: Optional[torch.Tensor],
                          num_krylov_vecs: int, delta: float = 1e-8,
                          V0: Optional[torch.Tensor] = None,
                          H0: Optional[torch.Tensor] = None,
                          start: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``m``-step Arnoldi on flat states: returns ``(V, H)`` with ``V``
    (m+1, n) orthonormal rows and ``H`` (m+1, m) upper Hessenberg.  Each
    step orthogonalises against rows <= j twice (classical Gram-Schmidt);
    a residual of norm <= ``delta`` leaves a zero row.

    Warm start (implicit restarts): ``V0``/``H0`` hold a valid
    ``start``-step factorization with ``V0[start]`` the normalised residual
    and ``H0[start, start-1]`` its norm; they are copied, not changed.
    Counterpart of the JAX package's ``arnoldi_factorization``."""
    m = num_krylov_vecs
    if V0 is None:
        v = v0.reshape(-1)
        V = torch.zeros((m + 1, v.numel()), dtype=v.dtype, device=v.device)
        V[0] = _normalized_or_zero(v, torch.linalg.vector_norm(v), delta)
        H = torch.zeros((m + 1, m), dtype=v.dtype, device=v.device)
        start = 0
    else:
        V, H = V0.clone(), H0.clone()
    for j in range(start, m):
        w = matvec(V[j])
        Vj = V[:j + 1]
        h = torch.conj(Vj) @ w
        w = w - h @ Vj
        h2 = torch.conj(Vj) @ w
        w = w - h2 @ Vj
        wnorm = torch.linalg.vector_norm(w)
        H[:, j] = 0
        H[:j + 1, j] = h + h2
        H[j + 1, j] = wnorm
        V[j + 1] = _normalized_or_zero(w, wnorm, delta)
    return V, H


def _eig_sort_key(re, im, which: str):
    """Relevance key (larger = more wanted) of eigenvalues (re, im), for
    torch tensors and numpy arrays alike."""
    if which == "LM":
        return re * re + im * im
    if which in ("LR", "LA"):
        return re
    if which == "SM":
        return -(re * re + im * im)
    if which in ("SR", "SA"):
        return -re
    raise ValueError(f"which = {which!r} not supported")


def _host_order(evals: np.ndarray, which: str) -> np.ndarray:
    """Indices of numpy eigenvalues, most wanted first."""
    return np.argsort(-_eig_sort_key(np.real(evals), np.imag(evals), which),
                      kind="stable")


def _small_eig(Hm: torch.Tensor, hermitian: bool):
    """(re, im, lasts) of the m x m projection: its eigenvalues and the
    |last components| of its unit eigenvectors (the Ritz residual of
    (lambda, V y) is beta_m |e_m^T y|)."""
    if hermitian:
        ev, evec = torch.linalg.eigh((Hm + Hm.mH) / 2)
        return ev, torch.zeros_like(ev), evec[-1, :].abs()
    ev, evec = torch.linalg.eig(Hm)
    return ev.real, ev.imag, evec[-1, :].abs()


def _shifted_qr(Vm: torch.Tensor, Hm: torch.Tensor, fm: torch.Tensor,
                shifts_re: List[float], shifts_im: List[float], k: int):
    """Compress an m-step factorization to ``k`` steps by applying the
    unwanted eigenvalues as QR shifts.  A real dtype applies a
    complex-conjugate pair (sr +- i si, the next slot its partner) as one
    double shift through the real polynomial H^2 - 2 sr H + |s|^2; a pair
    split by the last slot falls back to a single real shift at sr.  A
    complex dtype applies single complex shifts.  As the JAX package's
    ``_shifted_qr``, which computes both forms and selects."""
    m = Hm.shape[0]
    eye = torch.eye(m, dtype=Hm.dtype, device=Hm.device)
    q = torch.zeros((m,), dtype=Hm.dtype, device=Hm.device)
    q[-1] = 1.0
    p = len(shifts_re)
    skip = False
    for i, (sr, si) in enumerate(zip(shifts_re, shifts_im)):
        if skip:            # the partner of the last double shift
            skip = False
            continue
        if Hm.is_complex():
            shift = complex(sr, si)
            Q, R = lapack_factor(torch.linalg.qr, Hm - shift * eye)
            Hm = R @ Q + shift * eye
        elif si != 0 and i < p - 1:
            Q, _ = lapack_factor(torch.linalg.qr, Hm @ Hm - (2 * sr) * Hm
                                 + (sr * sr + si * si) * eye)
            Hm = Q.T @ Hm @ Q
            skip = True
        else:
            Q, R = lapack_factor(torch.linalg.qr, Hm - sr * eye)
            Hm = R @ Q + sr * eye
        Vm = Q.T @ Vm
        q = q @ Q
    fk = Vm[k] * Hm[k, k - 1] + fm * q[k - 1]
    return Vm, Hm, fk


def _restarted_arnoldi_engine(mv: Callable, v0: torch.Tensor, m: int,
                              numeig: int, which: str, maxiter: int,
                              tol: float, hermitian: bool,
                              delta: float = 1e-8):
    """Implicitly restarted Arnoldi (or Lanczos, ``hermitian``) on flat
    states: returns the final ``(V, H, iterations, converged)``.

    Each pass checks the Ritz residuals of the current m-step
    factorization, ``beta_m |e_m^T y| < max(eps |H_m|, |lambda| tol)``
    for the ``numeig`` wanted pairs (one host check); if they fail, it
    applies the unwanted Ritz values as shifts (:func:`_shifted_qr`) and
    re-expands the compressed ``numeig``-step factorization to m steps.
    At most ``maxiter - 1`` passes, as the JAX package's engine."""
    rdtype = v0.real.dtype
    eps = torch.finfo(rdtype).eps
    V, H = arnoldi_factorization(mv, v0, m, delta)
    it, conv = 1, False
    while it < maxiter and not conv:
        Hm = H[:m, :m]
        re, im, lasts = _small_eig(Hm, hermitian)
        order = torch.argsort(-_eig_sort_key(re, im, which), stable=True)
        re, im, lasts = re[order], im[order], lasts[order]
        w_abs = torch.sqrt(re[:numeig] ** 2 + im[:numeig] ** 2)
        beta_m = H[m, m - 1].abs().to(rdtype)
        thresh = torch.clamp(w_abs * tol,
                             min=eps * torch.linalg.vector_norm(Hm))
        ok = (beta_m * lasts[:numeig] < thresh).all()
        # the test and the shifts in one transfer
        host = torch.cat([ok[None], re[numeig:], im[numeig:]]).to(
            torch.float64).tolist()
        counts["host_checks"] += 1
        conv = host[0] > 0
        if not conv:
            fm = V[m] * H[m, m - 1].real.to(rdtype)
            p = m - numeig
            Vk, Hk, fk = _shifted_qr(V[:m], Hm, fm, host[1:1 + p],
                                     host[1 + p:], numeig)
            beta = torch.linalg.vector_norm(fk)
            Vn = torch.zeros_like(V)
            Vn[:numeig] = Vk[:numeig]
            Vn[numeig] = _normalized_or_zero(fk, beta, delta)
            Hn = torch.zeros_like(H)
            Hn[:numeig, :numeig] = Hk[:numeig, :numeig]
            Hn[numeig, numeig - 1] = beta
            V, H = arnoldi_factorization(mv, None, m, delta, V0=Vn, H0=Hn,
                                         start=numeig)
        it += 1
    return V, H, it, conv


def iram(matvec: Callable, initial_state: torch.Tensor,
         num_krylov_vecs: int = 50, numeig: int = 6, which: str = "LM",
         maxiter: int = 20, tol: float = 1e-8
         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Implicitly restarted Arnoldi for a general operator: the
    ``numeig`` wanted eigenpairs by ``which`` ('LM', 'LR', 'SM', 'SR').
    Returns ``(evals (numeig,) complex, [eigenvectors, each of
    initial_state's shape, unit norm, complex])`` on the state's device.

    A real operator keeps one extra vector in the compressed block, so that
    a complex-conjugate pair on the boundary is never split by the shifts.
    The final m x m eigenproblem runs on the host (numpy), restricted to
    the basis rows that are alive: an early invariant subspace leaves zero
    rows, which would add spurious zero eigenvalues.  Counterpart of the
    JAX package's ``iram``."""
    shape = initial_state.shape
    m = min(num_krylov_vecs, initial_state.numel())
    numeig = min(numeig, m)
    extra = 0 if initial_state.is_complex() else 1
    k_eng = min(numeig + extra, max(m - 1, 1))
    V, H, _, _ = _restarted_arnoldi_engine(
        _flat(matvec, shape), initial_state.reshape(-1), m, k_eng, which,
        maxiter, tol, hermitian=False)
    Vh = V[:m]
    Hm = H[:m, :m].cpu().numpy()
    alive = (torch.linalg.vector_norm(Vh, dim=1) > 0.5).cpu().numpy()
    p = int(alive.sum())
    if p < m:
        Hm, Vh = Hm[:p, :p], Vh[:p]
        numeig = min(numeig, p)
    evals, U = np.linalg.eig(Hm)
    inds = _host_order(evals, which)[:numeig]
    cdtype = torch.promote_types(Vh.dtype, torch.complex64)
    vecs = (torch.as_tensor(U[:, inds], device=Vh.device).to(cdtype).T
            @ Vh.to(cdtype))
    norms = torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    vecs = vecs / torch.where(norms > 0, norms, 1.0)
    return (torch.as_tensor(evals[inds], device=Vh.device).to(cdtype),
            [vecs[k].reshape(shape) for k in range(numeig)])


def eigs(matvec: Callable, initial_state: torch.Tensor,
         num_krylov_vecs: int = 50, numeig: int = 1, which: str = "LM",
         maxiter: Optional[int] = None, tol: float = 1e-8,
         method: str = "iram") -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Dominant eigenpairs of a general (non-Hermitian) operator.

    ``method="iram"`` (default): :func:`iram` with ``maxiter`` 20.
    ``method="explicit"``: ``maxiter`` (default 2) Arnoldi factorizations,
    each restarted from the sum of the last one's ``numeig`` Ritz vectors
    (not normalised), stopping early once ``|H[m, m-1]| < tol``; the
    m x m eigenproblem of each on the host.  Counterpart of the JAX
    package's ``eigs``."""
    if method == "iram":
        return iram(matvec, initial_state, num_krylov_vecs=num_krylov_vecs,
                    numeig=numeig, which=which,
                    maxiter=20 if maxiter is None else maxiter, tol=tol)
    if method != "explicit":
        raise ValueError(f"unknown method {method!r}")
    if maxiter is None:
        maxiter = 2
    shape = initial_state.shape
    mv = _flat(matvec, shape)
    m = num_krylov_vecs
    v0 = initial_state
    for it in range(maxiter):
        V, H = arnoldi_factorization(mv, v0, m)
        Hh = H.cpu().numpy()
        counts["host_checks"] += 1
        evals, evecs = np.linalg.eig(Hh[:m, :m])
        order = _host_order(evals, which)
        evals, evecs = evals[order], evecs[:, order]
        cdtype = torch.promote_types(V.dtype, torch.complex64)
        ritz = torch.as_tensor(evecs[:, :numeig], device=V.device).to(cdtype)
        vecs = ritz.T @ V[:m].to(cdtype)
        if float(np.abs(Hh[m, m - 1])) < tol or it == maxiter - 1:
            break
        v0 = vecs.sum(0).reshape(shape)
    return (torch.as_tensor(evals[:numeig], device=V.device).to(cdtype),
            [vecs[k].reshape(shape) for k in range(numeig)])


def eigsh(matvec: Callable, initial_state: torch.Tensor,
          num_krylov_vecs: int = 50, numeig: int = 1, which: str = "SA",
          **_) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Hermitian eigensolver on one operator: ``which='SA'`` (smallest
    algebraic) is :func:`eigsh_lanczos`; ``'LA'`` and ``'LM'`` solve the
    negated operator (so ``'LM'`` is the largest algebraic, as in the JAX
    package's ``eigsh``).  Returns ``(evals (numeig,), [vectors])``."""
    if which not in ("SA", "LA", "LM"):
        raise ValueError(f"which = {which!r} not supported")
    sign = 1.0 if which == "SA" else -1.0
    evals, vecs = eigsh_lanczos(lambda x: sign * matvec(x[0])[None],
                                initial_state[None], num_krylov_vecs, numeig)
    return sign * evals[0], [vecs[0, k] for k in range(numeig)]


def ir_lanczos(matvec: Callable, initial_state: torch.Tensor,
               num_krylov_vecs: int = 20, numeig: int = 1,
               which: str = "SA", maxiter: int = 20, tol: float = 1e-8
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Implicitly restarted Lanczos for a Hermitian operator: the restarted
    engine with exact (``eigh``) shifts.  Returns ``(evals (numeig,),
    evecs (numeig, *shape))`` sorted by ``which`` ('SA', 'LA', 'LM').  The
    final eigenproblem sees dead (zero) basis rows only through a sentinel
    diagonal that never wins the selection.  Counterpart of the JAX
    package's ``ir_lanczos``."""
    shape = initial_state.shape
    m = min(num_krylov_vecs, initial_state.numel())
    numeig = min(numeig, m)
    sentinel = {"SA": 1e10, "SR": 1e10, "SM": 1e10,
                "LA": -1e10, "LR": -1e10, "LM": 0.0}[which]
    V, H, _, _ = _restarted_arnoldi_engine(
        _flat(matvec, shape), initial_state.reshape(-1), m, numeig, which,
        maxiter, tol, hermitian=True)
    Hm = (H[:m, :m] + H[:m, :m].mH) / 2
    alive = torch.linalg.vector_norm(V[:m], dim=1) > 0.5
    Hm = Hm * (alive[:, None] & alive[None, :]).to(Hm.dtype)
    Hm = Hm + torch.diag((~alive).to(Hm.dtype) * sentinel)
    evals, evecs = torch.linalg.eigh(Hm)
    inds = torch.argsort(-_eig_sort_key(evals, torch.zeros_like(evals),
                                        which), stable=True)[:numeig]
    vecs = evecs[:, inds].T @ V[:m]
    norms = torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    vecs = vecs / torch.where(norms > 0, norms, 1.0)
    return evals[inds], vecs.reshape((numeig,) + tuple(shape))


# ---------------------------------------------------------------------------
# GMRES (one operator)
# ---------------------------------------------------------------------------


def _gmres_restart(mv: Callable, bf: torch.Tensor, x: torch.Tensor, m: int,
                   delta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GMRES(m) cycle from x: m Arnoldi steps (twice-orthogonalised,
    a residual of norm <= ``delta`` leaves a zero row), then the
    least-squares problem min |beta e1 - H y| by one complete QR of H on
    the device.  A dead column (|R_jj| <= delta, after an invariant
    subspace) gets a unit pivot: its basis row is zero, so it adds
    nothing.  Returns (x + V y, |g_m|), g = Q^H beta e1: the residual norm
    the JAX package's Givens recurrence carries (0 after a breakdown)."""
    n = bf.shape[0]
    r = bf - mv(x)
    beta = torch.linalg.vector_norm(r)
    V = torch.zeros((m + 1, n), dtype=bf.dtype, device=bf.device)
    V[0] = r / torch.where(beta > delta, beta, 1.0)
    H = torch.zeros((m + 1, m), dtype=bf.dtype, device=bf.device)
    for j in range(m):
        w = mv(V[j])
        Vj = V[:j + 1]
        h = torch.conj(Vj) @ w
        w = w - h @ Vj
        h2 = torch.conj(Vj) @ w
        w = w - h2 @ Vj
        wn = torch.linalg.vector_norm(w)
        H[:j + 1, j] = h + h2
        H[j + 1, j] = wn
        V[j + 1] = _normalized_or_zero(w, wn, delta)
    Q, R = lapack_factor(functools.partial(torch.linalg.qr, mode="complete"),
                         H)
    g = beta * torch.conj(Q[0])
    Rm = R[:m, :m]
    dead = torch.diagonal(Rm).abs() <= delta
    Rm = Rm + torch.diag(dead.to(Rm.dtype))
    y = torch.linalg.solve_triangular(Rm, g[:m, None], upper=True)[:, 0]
    return x + y @ V[:m], g[m].abs()


def gmres_kernel(mv: Callable, bf: torch.Tensor, x0f: torch.Tensor, m: int,
                 maxiter: int, threshold, delta: float = 1e-12
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restarted GMRES(m) on flat states: ``A x = bf`` from ``x0f``, at
    most ``maxiter`` cycles (:func:`_gmres_restart`), ending as soon as the
    residual norm is <= ``threshold`` (a number or a 0-dim tensor), which
    is checked before every cycle, once on the host.  Returns ``(x, final
    residual norm)``.  Counterpart of the JAX package's ``gmres_kernel``."""
    x = x0f
    rnorm = torch.linalg.vector_norm(bf - mv(x))
    threshold = torch.as_tensor(threshold, dtype=rnorm.dtype,
                                device=rnorm.device)
    for _ in range(maxiter):
        counts["host_checks"] += 1
        r_now, thr = torch.stack([rnorm, threshold]).tolist()
        if not r_now > thr:
            break
        x, rnorm = _gmres_restart(mv, bf, x, m, delta)
        counts["gmres_restarts"] += 1
    return x, rnorm


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
          atol: float = 0.0, num_krylov_vectors: int = 20,
          maxiter: int = 1) -> Tuple[torch.Tensor, int]:
    """Solve ``A x = b`` by restarted GMRES(m), m = ``num_krylov_vectors``,
    to the residual ``max(tol |b|, atol)`` or ``maxiter`` restarts.
    Returns ``(x, 0)``.  Counterpart of the JAX package's ``gmres``."""
    shape = b.shape
    bf = b.reshape(-1)
    x0f = torch.zeros_like(bf) if x0 is None else x0.reshape(-1)
    m = min(num_krylov_vectors, bf.numel())
    threshold = torch.clamp(tol * torch.linalg.vector_norm(bf), min=atol)
    x, _ = gmres_kernel(_flat(matvec, shape), bf, x0f, m, maxiter, threshold)
    return x.reshape(shape), 0
