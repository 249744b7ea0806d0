"""One- and two-site DMRG ground-state search.

Counterpart of :mod:`tensornetwork_tpu.models.dmrg`.
The MPS is a uniform stack ``(N, chi, d, chi)`` with trace (identity)
boundary environments, as in the JAX package.  Where JAX runs a sweep as
one ``lax.scan`` and batches it with ``vmap``, the port runs a Python loop
over the sites on tensors with a leading batch dimension: the single
instance is a batch of one, and the batch rides the fused-Lanczos
kernel's grid (:mod:`tensornetwork_tpu_torch.parallel.batch`).  The fused
local solve takes the kernel tier that
:func:`~tensornetwork_tpu_torch.ops.kernels.one_site_tier` (or
``two_site_tier``) picks for the bond dimension, as the JAX package does.
The two-site sweep truncates each bond back to the static ``chi`` by the
masked SVD or the matmul-only subspace iteration and accumulates the
discarded weight.

Conventions:
  A[l, s, r]        ket site tensor
  W[wl, wr, s, t]   MPO tensor, s = bra phys, t = ket phys
  L[a, w, a']       left env, a = ket bond, a' = bra bond
  R[b, w, b']       right env
Every helper below takes a leading batch axis B; W is (M, M, d, d),
shared by the batch, or (B, M, M, d, d).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device, as_tensor,
                                            default_device, highest_precision)
from tensornetwork_tpu_torch.models.mpo import MPO
from tensornetwork_tpu_torch.ops import decompositions, kernels, krylov
from tensornetwork_tpu_torch.utils import tracing

# Single-instance defaults, the JAX package's off-TPU ones; the local
# solve defaults to the fused kernel, as the JAX package does on its
# accelerator.
QR_IMPL = "householder"   # decompositions.qr: "householder" | "cholesky" |
                          # "polar" | "polar_express" | "polar_complete"
RITZ_IMPL = "eigh"        # "eigh" | "power"
# The JAX package's MATVEC_PRECISION and the sweeps' ``matvec_prec``, kept
# for their names and read by nothing.  There they lower the precision of the
# plain route's Lanczos matvec.  Here that matvec is K1 on the card, whose
# float32 arithmetic is its own (3xTF32) whatever cuBLAS is allowed, and
# K1's plain twin on the CPU, where there is no TF32: no value could change
# a result.  Every sweep runs with TF32 off (config.highest_precision).
MATVEC_PRECISION: Optional[str] = None
LANCZOS_IMPL = "fused"    # "fused" | "plain" (the JAX package's "xla")
# The one-site site epilogue (gauge shift and environment growth), the
# JAX package's default and names: "fused" is the fused kernel
# (kernels.fused_gauge_env_left/right), taken with qr_impl="polar" where
# kernels.gauge_epilogue_admitted admits the shape; "xla" the gauge
# factorization of qr_impl and the environment einsums.
EPILOGUE_IMPL = "xla"     # "xla" | "fused"
# Two-site bond truncation, the JAX package's module defaults: the exact
# masked SVD; "subspace" is the warm-started subspace iteration with
# TRUNC_ITERS steps orthonormalised by TRUNC_ORTH ("qr" | "polar" |
# "polar+qr" | "cholqr2"), the batched route's choice.
TRUNC_IMPL = "svd"        # "svd" | "subspace"
TRUNC_ITERS = 4
TRUNC_ORTH = "qr"


def _ws(W) -> str:
    return "wvst" if W.dim() == 4 else "Bwvst"


def _update_left(L, A, W):
    """L'[r, v, p] = L[a,w,c] A[a,t,r] W[w,v,s,t] conj(A)[c,s,p]."""
    X = torch.einsum("Bawc,Batr->Bwctr", L, A)
    Y = torch.einsum(f"Bwctr,{_ws(W)}->Bcrvs", X, W)
    return torch.einsum("Bcrvs,Bcsp->Brvp", Y, torch.conj(A))


def _update_right(R, A, W):
    """R'[l, w, p] = R[b,v,d] A[l,t,b] W[w,v,s,t] conj(A)[p,s,d]."""
    X = torch.einsum("Bbvd,Bltb->Bvdlt", R, A)
    Y = torch.einsum(f"Bvdlt,{_ws(W)}->Bdlws", X, W)
    return torch.einsum("Bdlws,Bpsd->Blwp", Y, torch.conj(A))


def _matvec_1s(L, W, R, x):
    """y[c, s, d] = L[a,w,c] W[w,v,s,t] x[a,t,b] R[b,v,d]."""
    X = torch.einsum("Bawc,Batb->Bwctb", L, x)
    Y = torch.einsum(f"Bwctb,{_ws(W)}->Bcbvs", X, W)
    return torch.einsum("Bcbvs,Bbvd->Bcsd", Y, R)


def _matvec_2s(L, W1, W2, R, x):
    """y[c,s,u,d] = L[a,w,c] W1[w,m,s,t] W2[m,v,u,z] x[a,t,z,b] R[b,v,d]."""
    b = "" if W1.dim() == 4 else "B"
    X = torch.einsum("Bawc,Batzb->Bwctzb", L, x)
    X = torch.einsum(f"Bwctzb,{b}wmst->Bcmszb", X, W1)
    X = torch.einsum(f"Bcmszb,{b}mvuz->Bcsubv", X, W2)
    return torch.einsum("Bcsubv,Bbvd->Bcsud", X, R)


def _boundary_left(B: int, chi: int, vL):
    eye = torch.eye(chi, dtype=vL.dtype, device=vL.device)
    return torch.einsum("ac,w->awc", eye, vL).expand(B, -1, -1, -1)


def _boundary_right(B: int, chi: int, vR):
    eye = torch.eye(chi, dtype=vR.dtype, device=vR.device)
    return torch.einsum("bd,v->bvd", eye, vR).expand(B, -1, -1, -1)


def _normalize(A):
    """Each instance of a (B, ...) stack over its Frobenius norm (zero
    stays zero)."""
    nrm = torch.linalg.vector_norm(A, dim=tuple(range(1, A.dim())),
                                   keepdim=True)
    return A / torch.where(nrm > 0, nrm, 1.0)


def _qr_shift_right(A, impl: str):
    """Left-canonicalize: A = Q.Rm with Q^H Q = I on the right bond."""
    B, chi_l, d, chi_r = A.shape
    q, rm = decompositions.qr(A.reshape(B, chi_l * d, chi_r), impl)
    return q.reshape(B, chi_l, d, chi_r), rm


def _rq_shift_left(A, impl: str):
    """Right-canonicalize: A = Lm.Q with Q Q^H = I on the left bond."""
    B, chi_l, d, chi_r = A.shape
    qt, rt = decompositions.qr(A.reshape(B, chi_l, d * chi_r).mT, impl)
    return rt.mT, qt.mT.reshape(B, chi_l, d, chi_r)


# The fused local solve of each tier of kernels.one_site_tier.
_FUSED_TIERS = {
    "resident": kernels.fused_lanczos_ground_state,
    "two_pass": functools.partial(kernels.fused_lanczos_ground_state,
                                  two_pass=True),
    "streamed": kernels.fused_lanczos_ground_state_streamed,
    "streamed_matvec": kernels.fused_lanczos_ground_state_streamed2,
    "streamed_matvec_xl": functools.partial(
        kernels.fused_lanczos_ground_state_streamed2, xl=True),
}
# The fused two-site local solve of each tier of kernels.two_site_tier.
_FUSED_TIERS_2S = {
    "resident": kernels.fused_lanczos_ground_state_2s,
    "streamed_matvec": kernels.fused_lanczos_ground_state_2s_streamed,
    "streamed_matvec_xl": functools.partial(
        kernels.fused_lanczos_ground_state_2s_streamed, xl=True),
}


@tracing.spanned("local_solve")
def _local_solve_1s(Lenv, W, Renv, A, num_krylov_vecs: int, ritz_impl: str,
                    reorth: bool, lanczos_impl: str):
    """Smallest Ritz pair of every instance's H_eff.  ``"fused"`` is the
    fused-Lanczos kernels of the tier :func:`kernels.one_site_tier` picks
    for the shape (plain three-term recurrence; ``reorth`` does not
    apply); ``"plain"`` is :func:`krylov.eigsh_lanczos` with the H_eff
    matvec kernel."""
    if lanczos_impl == "fused":
        _, chi, d, _ = A.shape
        tier = kernels.one_site_tier(chi, d, W.shape[-4], num_krylov_vecs)
        tracing.add("solve_tier." + tier)
        return _FUSED_TIERS[tier](Lenv, W, Renv, A,
                                  num_krylov_vecs=num_krylov_vecs,
                                  ritz_method=ritz_impl)
    if lanczos_impl != "plain":
        raise ValueError(f"unknown lanczos_impl {lanczos_impl!r}")
    tracing.add("solve_tier.plain")
    Lt, W, Rt, _ = kernels.prepare_operands(Lenv, W.contiguous(), Renv, A)

    def mv(x):
        xt = x.permute(0, 2, 1, 3).contiguous()
        return kernels.finalize_output(kernels.heff_matvec(Lt, W, Rt, xt))

    evals, evecs = krylov.eigsh_lanczos(
        mv, A, num_krylov_vecs=num_krylov_vecs, numeig=1,
        ritz_method=ritz_impl, reorthogonalize=reorth)
    return evals[:, 0], evecs[:, 0]


@tracing.spanned("local_solve")
def _local_solve_2s(Lenv, W1, W2, Renv, theta, num_krylov_vecs: int,
                    ritz_impl: str, reorth: bool, lanczos_impl: str):
    """Smallest Ritz pair of every instance's two-site H_eff, theta (B,
    chi, d, d, chi).  ``"fused"`` takes the tier
    :func:`kernels.two_site_tier` picks (nt = d*d tiles, the MPO pair
    pre-fused; plain three-term recurrence); ``"plain"`` is
    :func:`krylov.eigsh_lanczos` with the H_eff matvec kernel at nt = d*d."""
    if lanczos_impl == "fused":
        _, chi, d, _, _ = theta.shape
        tier = kernels.two_site_tier(chi, d, W1.shape[-4], num_krylov_vecs)
        tracing.add("solve_tier." + tier)
        return _FUSED_TIERS_2S[tier](Lenv, W1, W2, Renv, theta,
                                     num_krylov_vecs=num_krylov_vecs,
                                     ritz_method=ritz_impl)
    if lanczos_impl != "plain":
        raise ValueError(f"unknown lanczos_impl {lanczos_impl!r}")
    tracing.add("solve_tier.plain")
    B, chi, d, _, _ = theta.shape
    Lt, C, Rt, _ = kernels.prepare_operands_2s(Lenv, W1, W2, Renv, theta)

    def mv(x):
        xt = x.reshape(B, chi, d * d, chi).permute(0, 2, 1, 3).contiguous()
        y = kernels.finalize_output(kernels.heff_matvec(Lt, C, Rt, xt))
        return y.reshape(x.shape)

    evals, evecs = krylov.eigsh_lanczos(
        mv, theta, num_krylov_vecs=num_krylov_vecs, numeig=1,
        ritz_method=ritz_impl, reorthogonalize=reorth)
    return evals[:, 0], evecs[:, 0]


def _fused_epilogue(W, A, qr_impl: str, epilogue_impl: str) -> bool:
    """Whether the site epilogue runs the fused kernel: the JAX package's
    condition, ``epilogue_impl == "fused"`` with the polar gauge at a shape
    the route rule admits."""
    if epilogue_impl not in ("xla", "fused"):
        raise ValueError(f"unknown epilogue_impl {epilogue_impl!r}")
    _, chi, d, _ = A.shape
    return (epilogue_impl == "fused" and qr_impl == "polar"
            and kernels.gauge_epilogue_admitted(chi, d, W.shape[-4]))


@tracing.spanned("gauge_env")
def _gauge_env_left(Lenv, W, A, qr_impl: str, epilogue_impl: str):
    """Gauge-shift right (A = Q.Rm) and grow the left env with Q."""
    if _fused_epilogue(W, A, qr_impl, epilogue_impl):
        return kernels.fused_gauge_env_left(Lenv, W, A,
                                            *kernels.polar_iters(A.dtype))
    Q, Rm = _qr_shift_right(A, qr_impl)
    return Q, Rm, _update_left(Lenv, Q, W)


@tracing.spanned("gauge_env")
def _gauge_env_right(Renv, W, A, qr_impl: str, epilogue_impl: str):
    """Gauge-shift left (A = Lm.Q) and grow the right env with Q."""
    if _fused_epilogue(W, A, qr_impl, epilogue_impl):
        return kernels.fused_gauge_env_right(Renv, W, A,
                                             *kernels.polar_iters(A.dtype))
    Lm, Q = _rq_shift_left(A, qr_impl)
    return Q, Lm, _update_right(Renv, Q, W)


def _site(Ws, i: int):
    """Site i's MPO tensor of a shared (N, ...) or batched (B, N, ...)
    stack."""
    return Ws[i] if Ws.dim() == 5 else Ws[:, i]


@tracing.spanned("canon")
def _right_canonicalize_and_envs(As, Ws, vR, R0, qr_impl: str,
                                 epilogue_impl: str = "xla"):
    B, N, chi, d, _ = As.shape
    Renv = _boundary_right(B, chi, vR) if R0 is None else R0
    Lm = torch.eye(chi, dtype=As.dtype, device=As.device).expand(B, -1, -1)
    Qs, Renvs = [None] * N, [None] * N
    for i in reversed(range(N)):
        A = _normalize(torch.einsum("Basb,Bbc->Basc", As[:, i], Lm))
        Renvs[i] = Renv
        Qs[i], Lm, Renv = _gauge_env_right(Renv, _site(Ws, i), A, qr_impl,
                                           epilogue_impl)
    # re-absorb the left-over center factor: site 0 is the center
    Qs[0] = torch.einsum("Bab,Bbsc->Basc", Lm, Qs[0])
    return torch.stack(Qs, 1), torch.stack(Renvs, 1)


def right_canonicalize_and_envs(As, Ws, vL, vR, R0=None,
                                qr_impl: Optional[str] = None,
                                epilogue_impl: Optional[str] = None):
    """Bring all sites to right-canonical form and emit the right
    environments ``Renvs[i]`` (of the sites > i), for one instance
    As (N, chi, d, chi).  ``R0`` overrides the open-boundary right env;
    ``epilogue_impl`` as in :func:`one_site_sweep`."""
    qr_impl = QR_IMPL if qr_impl is None else qr_impl
    epilogue_impl = EPILOGUE_IMPL if epilogue_impl is None else epilogue_impl
    with highest_precision():
        Qs, Renvs = _right_canonicalize_and_envs(
            As[None], Ws, vR, None if R0 is None else R0[None], qr_impl,
            epilogue_impl)
    return Qs[0], Renvs[0]


class SweepResult(NamedTuple):
    As: torch.Tensor
    energy: torch.Tensor
    energies: torch.Tensor    # per-site Lanczos energies, last half-sweep
    trunc_err: torch.Tensor   # accumulated truncated weight (2-site only)
    renvs: Optional[torch.Tensor] = None  # right envs in the final gauge;
    # passing them as ``renvs=`` to the next sweep skips the prepass


@tracing.spanned("sweep")
def _one_site_sweep_impl(As, Ws, vL, vR, num_krylov_vecs: int,
                         boundary_envs, qr_impl: str, ritz_impl: str,
                         reorth: bool, lanczos_impl: str,
                         epilogue_impl: str, renvs) -> SweepResult:
    """One full (left-to-right + right-to-left) one-site sweep of a batch
    As (B, N, chi, d, chi).  ``boundary_envs`` are (B, chi, M, chi)."""
    B, N, chi, d, _ = As.shape
    Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
    if renvs is None:
        As, Renvs = _right_canonicalize_and_envs(
            As, Ws, vR, None if boundary_envs is None else boundary_envs[1],
            qr_impl, epilogue_impl)
    else:
        # sweep chaining: the previous reverse pass left the stack
        # right-canonical and built exactly these environments
        Renvs = renvs
    Lenv = (_boundary_left(B, chi, vL) if boundary_envs is None
            else boundary_envs[0])
    Rm = torch.eye(chi, dtype=As.dtype, device=As.device).expand(B, -1, -1)

    As1, Lenvs = [None] * N, [None] * N
    for i in range(N):
        W = _site(Ws, i)
        A = _normalize(torch.einsum("Bab,Bbsc->Basc", Rm, As[:, i]))
        _, A_opt = _local_solve_1s(Lenv, W, Renvs[:, i], A, num_krylov_vecs,
                                   ritz_impl, reorth, lanczos_impl)
        Lenvs[i] = Lenv
        As1[i], Rm, Lenv = _gauge_env_left(Lenv, W, A_opt, qr_impl,
                                           epilogue_impl)

    Renv = (_boundary_right(B, chi, vR) if boundary_envs is None
            else boundary_envs[1])
    Lm = Rm
    As2, Es, Renvs_out = [None] * N, [None] * N, [None] * N
    for i in reversed(range(N)):
        W = _site(Ws, i)
        A = _normalize(torch.einsum("Basb,Bbc->Basc", As1[i], Lm))
        Es[i], A_opt = _local_solve_1s(Lenvs[i], W, Renv, A, num_krylov_vecs,
                                       ritz_impl, reorth, lanczos_impl)
        Renvs_out[i] = Renv
        As2[i], Lm, Renv = _gauge_env_right(Renv, W, A_opt, qr_impl,
                                            epilogue_impl)
    # re-absorb the final center factor so the stack is the optimized state
    As2[0] = torch.einsum("Bab,Bbsc->Basc", Lm, As2[0])
    Es = torch.stack(Es, 1)
    return SweepResult(torch.stack(As2, 1), Es[:, 0], Es,
                       torch.zeros((B,), dtype=Es.dtype, device=Es.device),
                       torch.stack(Renvs_out, 1))


def one_site_sweep(As, Ws, vL, vR, num_krylov_vecs: int = 10,
                   boundary_envs: Optional[Tuple] = None,
                   qr_impl: Optional[str] = None,
                   ritz_impl: Optional[str] = None,
                   reorth: bool = True,
                   lanczos_impl: Optional[str] = None,
                   epilogue_impl: Optional[str] = None,
                   renvs=None,
                   matvec_prec: Optional[str] = None) -> SweepResult:
    """One full one-site DMRG sweep of one instance As (N, chi, d, chi),
    on the device the tensors lie on.

    ``boundary_envs``: optional (L0, R0), each (chi, M, chi), replacing the
    open-boundary environments.  ``qr_impl``/``ritz_impl``/``lanczos_impl``/
    ``epilogue_impl`` default to :data:`QR_IMPL`/:data:`RITZ_IMPL`/
    :data:`LANCZOS_IMPL`/:data:`EPILOGUE_IMPL`; ``epilogue_impl="fused"``
    takes effect with ``qr_impl="polar"``.  ``renvs``: the previous
    result's ``renvs``, which skips the re-canonicalization prepass.
    ``matvec_prec`` is the JAX package's argument, accepted and ignored
    (see :data:`MATVEC_PRECISION`)."""
    qr_impl = QR_IMPL if qr_impl is None else qr_impl
    ritz_impl = RITZ_IMPL if ritz_impl is None else ritz_impl
    lanczos_impl = LANCZOS_IMPL if lanczos_impl is None else lanczos_impl
    epilogue_impl = EPILOGUE_IMPL if epilogue_impl is None else epilogue_impl
    benvs = (None if boundary_envs is None
             else tuple(e[None] for e in boundary_envs))
    with highest_precision():
        res = _one_site_sweep_impl(
            As[None], Ws, vL, vR, num_krylov_vecs, benvs, qr_impl,
            ritz_impl, reorth, lanczos_impl, epilogue_impl,
            None if renvs is None else renvs[None])
    return SweepResult(*(t[0] for t in res))


def _truncate(th, q0, chi: int, trunc_impl: str, trunc_iters: int,
              trunc_orth: str, trunc_polar_fast):
    """Split every instance's (B, m, n) panel th ~ U @ SV at rank chi:
    ``U`` a column isometry, ``SV`` the rest normalised, and the discarded
    squared norm.  ``"subspace"`` warm-starts from ``q0`` (B, m, chi)."""
    if trunc_impl == "subspace":
        st = decompositions.subspace_truncate(
            th, chi, q0=q0, iters=trunc_iters, orth=trunc_orth,
            polar_fast=trunc_polar_fast)
        return st.q, _normalize(st.rest), st.trunc_sq_norm
    if trunc_impl != "svd":
        raise ValueError(f"unknown trunc_impl {trunc_impl!r}")
    res = decompositions.svd_masked(th, max_singular_values=chi)
    s = _normalize(res.s)
    return res.u, s[:, :, None] * res.vh, res.trunc_sq_norm


@tracing.spanned("sweep")
def _two_site_sweep_impl(As, Ws, vL, vR, num_krylov_vecs: int,
                         boundary_envs, qr_impl: str, ritz_impl: str,
                         reorth: bool, lanczos_impl: str, trunc_impl: str,
                         trunc_iters: int, trunc_orth: str,
                         trunc_polar_fast, renvs) -> SweepResult:
    """One full two-site sweep of a batch As (B, N, chi, d, chi): the
    left-to-right pass over the bonds (0, 1) ... (N-2, N-1), then the
    right-to-left pass back, each bond truncated to chi.  ``renvs`` (B,
    N-1, chi, M, chi): the previous result's, which skips the prepass."""
    B, N, chi, d, _ = As.shape
    Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
    if renvs is None:
        As, Renvs = _right_canonicalize_and_envs(
            As, Ws, vR, None if boundary_envs is None else boundary_envs[1],
            qr_impl)
        step_renvs = Renvs[:, 1:]
    else:
        # sweep chaining: the previous reverse pass left sites 1.. right-
        # canonical (truncation isometries), the center at site 0, and
        # built exactly these bond-step environments
        step_renvs = renvs
    solve = functools.partial(_local_solve_2s,
                              num_krylov_vecs=num_krylov_vecs,
                              ritz_impl=ritz_impl, reorth=reorth,
                              lanczos_impl=lanczos_impl)
    trunc = functools.partial(_truncate, chi=chi, trunc_impl=trunc_impl,
                              trunc_iters=trunc_iters, trunc_orth=trunc_orth,
                              trunc_polar_fast=trunc_polar_fast)
    terr = torch.zeros((B,), dtype=As.dtype, device=As.device)

    Lenv = (_boundary_left(B, chi, vL) if boundary_envs is None
            else boundary_envs[0])
    pending = As[:, 0]
    As1, Lenvs = [None] * N, [None] * (N - 1)
    for i in range(N - 1):
        W1, W2 = _site(Ws, i), _site(Ws, i + 1)
        theta = _normalize(torch.einsum("Basb,Bbtc->Bastc", pending,
                                        As[:, i + 1]))
        _, th = solve(Lenv, W1, W2, step_renvs[:, i], theta)
        Lenvs[i] = Lenv
        with tracing.span("gauge_env"):
            U, SV, tsq = trunc(th.reshape(B, chi * d, d * chi),
                               pending.reshape(B, chi * d, chi))
            As1[i] = U.reshape(B, chi, d, chi)
            Lenv = _update_left(Lenv, As1[i], W1)
        pending = SV.reshape(B, chi, d, chi)
        terr = terr + tsq
    As1[N - 1] = pending

    Renv = (_boundary_right(B, chi, vR) if boundary_envs is None
            else boundary_envs[1])
    As2, Es, Renvs_out = [None] * N, [None] * (N - 1), [None] * (N - 1)
    for i in reversed(range(N - 1)):
        W1, W2 = _site(Ws, i), _site(Ws, i + 1)
        theta = _normalize(torch.einsum("Basb,Bbtc->Bastc", As1[i],
                                        pending))
        Es[i], th = solve(Lenvs[i], W1, W2, Renv, theta)
        Renvs_out[i] = Renv
        with tracing.span("gauge_env"):
            # truncate th^T = q @ rest, so th = rest^T @ q^T = US @ V
            q, rest, tsq = trunc(th.reshape(B, chi * d, d * chi).mT,
                                 pending.reshape(B, chi, d * chi).mT)
            As2[i + 1] = q.mT.reshape(B, chi, d, chi)
            Renv = _update_right(Renv, As2[i + 1], W2)
        pending = rest.mT.reshape(B, chi, d, chi)
        terr = terr + tsq
    As2[0] = pending
    Es = torch.stack(Es, 1)
    return SweepResult(torch.stack(As2, 1), Es[:, 0], Es, terr,
                       torch.stack(Renvs_out, 1))


def two_site_sweep(As, Ws, vL, vR, num_krylov_vecs: int = 10,
                   boundary_envs: Optional[Tuple] = None,
                   qr_impl: Optional[str] = None,
                   ritz_impl: Optional[str] = None,
                   reorth: bool = True,
                   lanczos_impl: Optional[str] = None,
                   trunc_impl: Optional[str] = None,
                   trunc_iters: Optional[int] = None,
                   trunc_orth: Optional[str] = None,
                   trunc_polar_fast: Optional[Tuple[int, int]] = None,
                   renvs=None,
                   matvec_prec: Optional[str] = None) -> SweepResult:
    """One full two-site DMRG sweep of one instance As (N, chi, d, chi),
    each bond truncated back to chi, on the device the tensors lie on.
    Returns a :class:`SweepResult` with ``energies`` per bond (N-1,),
    ``trunc_err`` the accumulated discarded weight of both passes and
    ``renvs`` (N-1, chi, M, chi) for chaining.

    ``boundary_envs``, ``qr_impl``, ``ritz_impl``, ``lanczos_impl``,
    ``matvec_prec`` as in :func:`one_site_sweep`; ``trunc_impl``/
    ``trunc_iters``/``trunc_orth`` default to :data:`TRUNC_IMPL`/
    :data:`TRUNC_ITERS`/:data:`TRUNC_ORTH`; ``trunc_polar_fast`` as in
    :func:`~tensornetwork_tpu_torch.ops.decompositions.subspace_truncate`."""
    qr_impl = QR_IMPL if qr_impl is None else qr_impl
    ritz_impl = RITZ_IMPL if ritz_impl is None else ritz_impl
    lanczos_impl = LANCZOS_IMPL if lanczos_impl is None else lanczos_impl
    trunc_impl = TRUNC_IMPL if trunc_impl is None else trunc_impl
    trunc_iters = TRUNC_ITERS if trunc_iters is None else trunc_iters
    trunc_orth = TRUNC_ORTH if trunc_orth is None else trunc_orth
    benvs = (None if boundary_envs is None
             else tuple(e[None] for e in boundary_envs))
    with highest_precision():
        res = _two_site_sweep_impl(
            As[None], Ws, vL, vR, num_krylov_vecs, benvs, qr_impl, ritz_impl,
            reorth, lanczos_impl, trunc_impl, trunc_iters, trunc_orth,
            trunc_polar_fast, None if renvs is None else renvs[None])
    return SweepResult(*(t[0] for t in res))


def random_mps_stack(generator, N: int, chi: int, d: int = 2,
                     dtype: Optional[torch.dtype] = None,
                     device: Optional[Device] = None) -> torch.Tensor:
    """Random uniform MPS stack (N, chi, d, chi).  ``generator`` is a
    ``torch.Generator`` on the target device or an integer seed."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    if isinstance(generator, torch.Generator) and device is None:
        device = generator.device
    device = default_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    return (torch.randn((N, chi, d, chi), generator=generator, dtype=dtype,
                        device=device) / float(np.sqrt(chi * d)))


def mps_mpo_expectation(As, Ws, vL, vR) -> torch.Tensor:
    """<psi|H|psi>/<psi|psi> of one stack (identity boundary envs)."""
    N, chi, d, _ = As.shape
    with highest_precision():
        L = _boundary_left(1, chi, vL)
        for i in range(N):
            L = _update_left(L, As[None, i], Ws[i])
        eye = torch.eye(chi, dtype=As.dtype, device=As.device)
        num = torch.einsum("awc,ac,w->", L[0], eye, vR)
        nL = eye
        for i in range(N):
            nL = torch.einsum("ac,atr,ctp->rp", nL, As[i], torch.conj(As[i]))
        return num / torch.trace(nL)


class FiniteDMRG:
    """Sweeping ground-state solver for one MPS -- a stack (N, chi, d,
    chi) or a :class:`~tensornetwork_tpu_torch.models.mps.FiniteMPS`, which
    gets the result back (``from_stack``) when a run ends -- and an
    :class:`MPO`.  Tensors stay on their device; anything else goes to
    :func:`default_device`."""

    def __init__(self, mps, mpo: MPO, device: Optional[Device] = None):
        self._mps_obj = mps if hasattr(mps, "to_stack") else None
        self.As = as_tensor(mps.to_stack() if self._mps_obj is not None
                            else mps, device)
        self.mpo = mpo
        if self.As.shape[0] != mpo.num_sites:
            raise ValueError(f"MPS has {self.As.shape[0]} sites but MPO "
                             f"has {mpo.num_sites}")
        if self.As.shape[2] != mpo.phys_dim:
            raise ValueError(f"MPS physical dimension {self.As.shape[2]} "
                             f"!= MPO physical dimension {mpo.phys_dim}")
        self.energies: list = []
        self.truncation_errors: list = []

    def _run(self, sweep_fn, num_sweeps: int, num_krylov_vecs: int,
             tol: float, verbose: int, **knobs) -> float:
        e_prev, renvs = None, None
        for sweep in range(num_sweeps):
            res = sweep_fn(self.As, self.mpo.Ws, self.mpo.vL, self.mpo.vR,
                           num_krylov_vecs=num_krylov_vecs, renvs=renvs,
                           **knobs)
            self.As, renvs = res.As, res.renvs
            e = float(res.energy)
            self.energies.append(e)
            self.truncation_errors.append(float(res.trunc_err))
            if verbose > 0:
                print(f"sweep {sweep}: E = {e:.12f}")
            if e_prev is not None and abs(e - e_prev) < tol:
                break
            e_prev = e
        if self._mps_obj is not None:
            self._mps_obj.from_stack(self.As)
        return self.energies[-1]

    def run_one_site(self, num_sweeps: int = 4, num_krylov_vecs: int = 10,
                     tol: float = 1e-10, verbose: int = 0,
                     qr_impl: Optional[str] = None,
                     epilogue_impl: Optional[str] = None) -> float:
        """Run chained one-site sweeps; returns the last energy.
        ``qr_impl`` and ``epilogue_impl`` as in :func:`one_site_sweep`."""
        return self._run(one_site_sweep, num_sweeps, num_krylov_vecs, tol,
                         verbose, qr_impl=qr_impl, epilogue_impl=epilogue_impl)

    def run_two_site(self, num_sweeps: int = 4, num_krylov_vecs: int = 10,
                     tol: float = 1e-10, verbose: int = 0) -> float:
        """Run chained two-site sweeps (each bond truncated back to the
        MPS bond dimension); returns the last energy.  The discarded
        weight of each sweep is appended to ``truncation_errors``."""
        return self._run(two_site_sweep, num_sweeps, num_krylov_vecs, tol,
                         verbose)

    def compute_energy(self) -> float:
        return float(mps_mpo_expectation(self.As, self.mpo.Ws, self.mpo.vL,
                                         self.mpo.vR))
