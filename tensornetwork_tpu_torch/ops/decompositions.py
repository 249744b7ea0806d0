"""Gauge factorizations and bond truncations of the DMRG sweeps.

Counterpart of :mod:`tensornetwork_tpu.ops.decompositions`: ``ns_polar``,
``ns_polar_express``, ``cholqr2``, ``svd_masked`` and
``subspace_truncate``; Householder QR is ``torch.linalg.qr`` and the SVD
``torch.linalg.svd``, both through :func:`lapack_factor`.  Also
``polar_complete``, the full-isometry polar split of the TDVP gauge shifts
(the JAX package's ``ns_polar_complete`` and its split-complex
``polar_complete`` in one).  Every one of these works on stacks of
matrices (leading batch dimensions); ``ns_polar``, ``polar_complete`` and
``svd_masked`` take complex ones too.

The host-level tensor factorizations :func:`svd`, :func:`tensor_qr`,
:func:`rq` and :func:`eigh` split one tensor around a pivot axis and keep the JAX
package's truncation contract: the discarded singular values are the
largest tail whose L2 norm is at most ``max_truncation_error`` (times the
largest singular value when ``relative``), capped by
``max_singular_values``.  Their output shapes depend on the data.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def ns_polar(m: torch.Tensor, quintic_iters: Optional[int] = None,
             cubic_iters: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar decomposition m = Q.P (Q column-isometric, P = Q^H m) by a
    matmul-only Newton-Schulz iteration: quintic steps (coefficients
    3.4445, -4.7750, 2.0315) inflate the small singular values, cubic
    steps polish.  Counts default to (14, 7) in float32 and complex64 and
    (20, 10) otherwise, as in the JAX package.

    On an exactly rank-deficient panel the result is a PARTIAL isometry:
    the null columns stay zero."""
    X = _newton_schulz(m, quintic_iters, cubic_iters)
    return X, X.mH @ m


def _single_precision(dtype: torch.dtype) -> bool:
    return dtype in (torch.float32, torch.complex64)


def _newton_schulz(m, quintic_iters, cubic_iters):
    """The isometric factor of :func:`ns_polar`."""
    if quintic_iters is None:
        quintic_iters = 14 if _single_precision(m.dtype) else 20
    if cubic_iters is None:
        cubic_iters = 7 if _single_precision(m.dtype) else 10
    nrm = torch.linalg.vector_norm(m, dim=(-2, -1), keepdim=True)
    X = m / torch.where(nrm > 0, nrm * 1.01, 1.0)
    a, b, c = 3.4445, -4.7750, 2.0315
    for _ in range(quintic_iters):
        G = X.mH @ X
        X = a * X + X @ (b * G + c * (G @ G))
    return _cubic_polish(X, cubic_iters)


def _cubic_polish(X, iters: int):
    """Newton-Schulz cubic steps X <- X (3 I - X^H X) / 2: they push the
    singular values to 1 and keep span(X)."""
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    for _ in range(iters):
        X = 0.5 * X @ (3.0 * eye - X.mH @ X)
    return X


def polar_complete(m: torch.Tensor, quintic_iters: Optional[int] = None,
                   cubic_iters: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar split m = Q.P (P = Q^H m) of a stack of tall (n >= k) real or
    complex matrices with Q a FULL isometry (Q^H Q = I), also where m is
    rank-deficient and :func:`ns_polar` leaves the null columns at zero.

    The defect projector D = I - X^H X of the Newton-Schulz factor X is
    sharpened to a hard projector by 25 smoothstep steps (D <- 3D^2 -
    2D^3), the leading k coordinate directions projected off col(X) and
    onto the defect are orthonormalised by a second Newton-Schulz pass and
    added, and 4 cubic steps polish Q.  The completion is orthogonal to
    col(m), so Q^H m = X^H m.  Matmul-only, with the schedule of
    :func:`ns_polar`.  Counterpart of the JAX package's
    ``ns_polar_complete`` (real) and split-complex ``polar_complete``: the
    completion directions seed entanglement growth in the TDVP gauge
    shifts of a product state, as Householder QR's do."""
    n, k = m.shape[-2], m.shape[-1]
    if n < k:
        raise ValueError(f"need n >= k, got {tuple(m.shape)}")
    eye = torch.eye(k, dtype=m.dtype, device=m.device)
    X = _newton_schulz(m, quintic_iters, cubic_iters)
    D = eye - X.mH @ X
    for _ in range(25):
        D2 = D @ D
        D = 3.0 * D2 - 2.0 * (D2 @ D)
    E = torch.eye(n, k, dtype=m.dtype, device=m.device).expand(m.shape)
    Y = E - X @ (X.mH @ E)
    Z = _newton_schulz(Y @ D, quintic_iters, cubic_iters) @ D
    Q = _cubic_polish(X + Z, 4)
    return Q, Q.mH @ m


# the JAX package's name for the real case (``ops/decompositions.py:462``);
# the port's one function takes real and complex stacks
ns_polar_complete = polar_complete


def _pe_best_step(l: float) -> Tuple[Tuple[float, float, float], float]:
    """One Polar Express step on the host, in float64: the odd quintic
    p(x) = a x + b x^3 + c x^5 maximising min p on [l, 1] subject to p <= 1
    there, by a linear program on a grid refined with cutting planes from a
    fine validation grid.  Returns ((a, b, c), new l), scaled so that max
    p <= 1 with a small safety margin.  The JAX package's ``_pe_best_step``."""
    from scipy.optimize import linprog
    x = np.unique(np.concatenate([np.geomspace(l, 1.0, 2500),
                                  np.linspace(l, 1.0, 2500)]))
    xf = np.unique(np.concatenate([np.geomspace(l, 1.0, 120000),
                                   np.linspace(l, 1.0, 120000)]))
    a = b = c = t = None
    for _ in range(8):
        n = len(x)
        M = np.stack([x, x**3, x**5], axis=1)
        # vars (a, b, c, t): maximise t  s.t.  M v <= 1,  t - M v <= 0
        A_ub = np.concatenate([
            np.concatenate([M, np.zeros((n, 1))], axis=1),
            np.concatenate([-M, np.ones((n, 1))], axis=1)])
        b_ub = np.concatenate([np.ones(n), np.zeros(n)])
        res = linprog(np.array([0.0, 0.0, 0.0, -1.0]), A_ub=A_ub, b_ub=b_ub,
                      bounds=[(None, None)] * 4, method="highs")
        a, b, c, t = res.x
        vals = a * xf + b * xf**3 + c * xf**5
        mn, mx = float(np.min(vals)), float(np.max(vals))
        if mn >= t * (1.0 - 1e-3) and mx <= 1.0 + 1e-9:
            break
        new_pts = [xf[int(np.argmin(vals))], xf[int(np.argmax(vals))]]
        x = np.unique(np.concatenate([x, np.asarray(new_pts)]))
    scale = max(mx, 1.0) * 1.00002
    return (a / scale, b / scale, c / scale), mn / scale


@functools.lru_cache(maxsize=32)
def _polar_express_schedule(l: float, target: float, max_steps: int = 24
                            ) -> Tuple[Tuple[float, float, float], ...]:
    """The per-step quintic coefficients of :func:`ns_polar_express`: one
    :func:`_pe_best_step` after another from the lower edge ``l`` of the
    singular values until ``1 - l < target`` (at most ``max_steps``; stops
    when a step no longer raises l).  Computed once per (l, target) on the
    host.  The JAX package's ``_polar_express_schedule``."""
    steps = []
    lo = float(l)
    while 1.0 - lo > target and len(steps) < max_steps:
        coeffs, new_lo = _pe_best_step(lo)
        steps.append(coeffs)
        if new_lo <= lo:
            break
        lo = new_lo
    return tuple(steps)


@functools.lru_cache(maxsize=32)
def _polar_hybrid_schedule(l: float) -> Tuple[Tuple[float, float, float],
                                               ...]:
    """The ``mode="hybrid"`` schedule of :func:`ns_polar_express`: the
    fixed quintic (3.4445, -4.7750, 2.0315) of :func:`ns_polar` while the
    lower edge is below 5% of the upper (1.2022...), then
    :func:`_pe_best_step` quintics, each folding the normalisation by the
    upper edge into its coefficients, until 1 - l/hi <= 1e-2.  The JAX
    package's ``_polar_hybrid_schedule``."""
    a, b, c = 3.4445, -4.7750, 2.0315
    steps = []
    lo = float(l)
    hi = 1.20224838
    while lo < 0.05 * hi and len(steps) < 20:
        steps.append((a, b, c))
        lo = a * lo + b * lo**3 + c * lo**5
    while 1.0 - lo / hi > 1e-2 and len(steps) < 26:
        (ca, cb, cc), new_lo = _pe_best_step(lo / hi)
        steps.append((ca / hi, cb / hi**3, cc / hi**5))
        if new_lo <= lo / hi:
            break
        lo, hi = new_lo, 1.0
    return tuple(steps)


def ns_polar_express(m: torch.Tensor, cond_bound: Optional[float] = None,
                     polish: Optional[int] = None, mode: str = "lp"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar decomposition m = Q.P by the minimax-scheduled quintic
    iteration (the "Polar Express" construction): the same contract as
    :func:`ns_polar` (a partial isometry on a rank-deficient panel) with
    fewer matmuls.  ``cond_bound``: the assumed bound on the panel's
    condition number (1e7 for float32, else 1e10); the Frobenius-normalised
    panel's smallest singular value is then at least l0 = 1 / (cond_bound
    sqrt(k) 1.01).  Where l0 < 3e-9 (the float64 default) the schedule's
    linear programs are unreliable and this is :func:`ns_polar`.  Otherwise
    the quintic steps of :func:`_polar_express_schedule` (or, with
    ``mode="hybrid"``, :func:`_polar_hybrid_schedule`), computed on the
    host in float64, take the lower edge to 1e-2, and ``polish`` cubic
    Newton-Schulz steps (3 in float32, else 4) finish.  Counterpart of the
    JAX package's ``ns_polar_express``."""
    if cond_bound is None:
        cond_bound = 1e7 if m.dtype == torch.float32 else 1e10
    k = m.shape[-1]
    l0 = 1.0 / (float(cond_bound) * float(np.sqrt(k)) * 1.01)
    if l0 < 3e-9:
        return ns_polar(m)
    nrm = torch.linalg.vector_norm(m, dim=(-2, -1), keepdim=True)
    X = m / torch.where(nrm > 0, nrm * 1.01, 1.0)
    if mode == "hybrid":
        sched = _polar_hybrid_schedule(l0)
    else:
        sched = _polar_express_schedule(l0, 1e-2)
    if polish is None:
        polish = 3 if m.dtype == torch.float32 else 4
    for (a, b, c) in sched:
        G = X.mH @ X
        X = a * X + X @ (b * G + c * (G @ G))
    X = _cubic_polish(X, polish)
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


def lapack_factor(fn, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn(m)``, a LAPACK-style factorization returning a tuple of tensors
    (``torch.linalg.qr``, ``torch.linalg.svd``), by one rule of device and
    dtype: a complex64 tensor on the CPU is factored in complex128 and each
    factor is cast back (complex factors to complex64, real ones such as
    the singular values to float32).  Everything else is factored as it
    is; on the card cuSOLVER stays in complex64.

    The CPU rule is not a retry: PyTorch's CPU LAPACK (torch 2.13) returns
    NaN from complex64 Householder QR, and fails to converge in the
    complex64 SVD, on some rank-deficient panels (a few random nonzero
    rows, as a product state padded to chi gives), where complex128 and the
    JAX package's complex64 are finite."""
    if m.dtype == torch.complex64 and m.device.type == "cpu":
        return tuple(f.to(torch.complex64 if f.is_complex() else torch.float32)
                     for f in fn(m.to(torch.complex128)))
    return fn(m)


def thin_svd(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``torch.linalg.svd(m, full_matrices=False)`` of a stack of matrices
    through :func:`lapack_factor`.  On the card the SVD is cuSOLVER's
    QR-iteration routine (gesvd): the default Jacobi routine's f32 singular
    vectors are orthonormal only to its tolerance, which sets the floor of
    anything built from them (a two-site sweep's f32 Ritz energies, VUMPS's
    gauge error)."""
    kw = {"driver": "gesvd"} if m.is_cuda else {}
    return lapack_factor(
        functools.partial(torch.linalg.svd, full_matrices=False, **kw), m)


def qr(m: torch.Tensor, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """An isometric/rest split m = Q.R of a stack of tall matrices:
    ``"householder"`` (triangular R, ``torch.linalg.qr`` through
    :func:`lapack_factor`), ``"cholesky"`` (:func:`cholqr2`), ``"polar"``
    (:func:`ns_polar`), ``"polar_express"`` (:func:`ns_polar_express`) or
    ``"polar_complete"`` (:func:`polar_complete`)."""
    if impl == "householder":
        return lapack_factor(torch.linalg.qr, m)
    if impl == "cholesky":
        return cholqr2(m)
    if impl == "polar":
        return ns_polar(m)
    if impl == "polar_express":
        return ns_polar_express(m)
    if impl == "polar_complete":
        return polar_complete(m)
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

    The SVD is :func:`thin_svd`: on the card cuSOLVER's gesvd (with the
    Jacobi routine, a two-site sweep that builds its environments from the
    f32 singular vectors reported f32 Ritz energies ~1e-4 too high,
    measured on an H100 at N=10, chi=16); complex64 on the CPU in
    complex128 (:func:`lapack_factor`).  Complex matrices give complex
    ``u``/``vh`` and real ``s`` (the JAX package's ``svd_masked_sc``)."""
    u, s, vh = thin_svd(matrix)
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


# Host-level tensor factorizations around a pivot axis
# ---------------------------------------------------------------------------


def _to_matrix(tensor: torch.Tensor, pivot_axis: int):
    """``tensor`` as a (prod(left), prod(right)) matrix, with the left and
    right shapes, split before ``pivot_axis``."""
    left, right = tuple(tensor.shape[:pivot_axis]), tuple(
        tensor.shape[pivot_axis:])
    return (tensor.reshape(int(np.prod(left, dtype=np.int64)),
                           int(np.prod(right, dtype=np.int64))), left, right)


def _num_keep_from_spectrum(s: np.ndarray,
                            max_singular_values: Optional[int],
                            max_truncation_error: Optional[float],
                            relative: bool) -> int:
    """How many of the descending singular values ``s`` (a host array) to
    keep: all but the largest tail of L2 norm <= ``max_truncation_error``
    (times s[0] when ``relative``), then at most ``max_singular_values``."""
    n = s.shape[0]
    keep = n
    if max_truncation_error is not None:
        err = float(max_truncation_error)
        if relative and n > 0:
            err = err * float(s[0])
        tail_sq = np.cumsum((s**2)[::-1])
        keep = n - int(np.searchsorted(np.sqrt(tail_sq), err, side="right"))
    if max_singular_values is not None:
        keep = min(keep, int(max_singular_values))
    return max(keep, 0)


def svd(tensor: torch.Tensor, pivot_axis: int = -1,
        max_singular_values: Optional[int] = None,
        max_truncation_error: Optional[float] = None,
        relative: bool = False) -> Tuple[torch.Tensor, ...]:
    """Truncated SVD of ``tensor`` split before ``pivot_axis``: returns
    ``(u, s, vh, s_rest)`` with ``u`` of shape left + (D,), ``vh`` (D,) +
    right and ``s_rest`` the discarded singular values.  Without
    ``max_truncation_error`` the rank D is known without looking at the
    spectrum; with it, the spectrum is read on the host (one sync).  The
    SVD is :func:`thin_svd`.  Counterpart of the JAX package's ``svd``."""
    if pivot_axis < 0:
        pivot_axis += tensor.dim()
    matrix, left, right = _to_matrix(tensor, pivot_axis)
    u, s, vh = thin_svd(matrix)
    if max_truncation_error is None:
        keep = s.shape[0]
        if max_singular_values is not None:
            keep = min(keep, int(max_singular_values))
    else:
        keep = _num_keep_from_spectrum(
            s.detach().cpu().double().numpy(), max_singular_values,
            max_truncation_error, relative)
    return (u[:, :keep].reshape(left + (keep,)), s[:keep],
            vh[:keep, :].reshape((keep,) + right), s[keep:])


def tensor_qr(tensor: torch.Tensor, pivot_axis: int = -1,
              non_negative_diagonal: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QR of ``tensor`` split before ``pivot_axis``: ``(q, r)`` with
    tensor = q @ r, ``q`` of shape left + (k,) with orthonormal columns
    and ``r`` (k,) + right, k = min(prod(left), prod(right)); Householder
    QR through :func:`lapack_factor`.  With ``non_negative_diagonal`` the
    phases of R's diagonal move into Q.  Counterpart of the JAX package's
    ``qr`` (here :func:`qr` is the gauge split of a stack of panels)."""
    if pivot_axis < 0:
        pivot_axis += tensor.dim()
    matrix, left, right = _to_matrix(tensor, pivot_axis)
    q, r = lapack_factor(torch.linalg.qr, matrix)
    if non_negative_diagonal:
        d = torch.diagonal(r)
        phase = torch.where(d == 0, torch.ones_like(d), d / d.abs())
        q = q * torch.conj(phase)[None, :]
        r = r * phase[:, None]
    k = q.shape[1]
    return q.reshape(left + (k,)), r.reshape((k,) + right)


def rq(tensor: torch.Tensor, pivot_axis: int = -1,
       non_negative_diagonal: bool = False
       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQ of ``tensor`` split before ``pivot_axis``: ``(r, q)`` with
    tensor = r @ q and ``q`` of orthonormal rows, from the Householder QR
    of the conjugate transpose (through :func:`lapack_factor`).  With
    ``non_negative_diagonal`` the phases of R's diagonal move into Q.
    Counterpart of the JAX package's ``rq``."""
    if pivot_axis < 0:
        pivot_axis += tensor.dim()
    matrix, left, right = _to_matrix(tensor, pivot_axis)
    q_, r_ = lapack_factor(torch.linalg.qr, matrix.mH)
    if non_negative_diagonal:
        d = torch.diagonal(r_)
        phase = torch.where(d == 0, torch.ones_like(d), d / d.abs())
        q_ = q_ * torch.conj(phase)[None, :]
        r_ = r_ * phase[:, None]
    r, q = r_.mH.resolve_conj(), q_.mH.resolve_conj()
    k = q.shape[0]
    return r.reshape(left + (k,)), q.reshape((k,) + right)


def eigh(tensor: torch.Tensor, pivot_axis: int = -1
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of the Hermitian matrix ``tensor`` makes when
    split before ``pivot_axis``: ``(e, v)`` with ``v`` of shape left + (n,).
    Counterpart of the JAX package's ``eigh``."""
    if pivot_axis < 0:
        pivot_axis += tensor.dim()
    matrix, left, _ = _to_matrix(tensor, pivot_axis)
    e, v = lapack_factor(torch.linalg.eigh, matrix)
    return e, v.reshape(left + (v.shape[1],))
