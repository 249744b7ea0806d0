"""One-site DMRG ground-state search.

Counterpart of the one-site part of :mod:`tensornetwork_tpu.models.dmrg`.
The MPS is a uniform stack ``(N, chi, d, chi)`` with trace (identity)
boundary environments, as in the JAX package.  Where JAX runs a sweep as
one ``lax.scan`` and batches it with ``vmap``, the port runs a Python loop
over the sites on tensors with a leading batch dimension: the single
instance is a batch of one, and the batch rides the fused-Lanczos
kernel's grid (:mod:`tensornetwork_tpu_torch.parallel.batch`).

Conventions:
  A[l, s, r]        ket site tensor
  W[wl, wr, s, t]   MPO tensor, s = bra phys, t = ket phys
  L[a, w, a']       left env, a = ket bond, a' = bra bond
  R[b, w, b']       right env
Every helper below takes a leading batch axis B; W is (M, M, d, d),
shared by the batch, or (B, M, M, d, d).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device, as_tensor,
                                            default_device, highest_precision)
from tensornetwork_tpu_torch.models.mpo import MPO
from tensornetwork_tpu_torch.ops import decompositions, kernels, krylov

# Single-instance defaults, the JAX package's off-TPU ones; the local
# solve defaults to the fused kernel, as the JAX package does on its
# accelerator.
QR_IMPL = "householder"   # "householder" | "polar"
RITZ_IMPL = "eigh"        # "eigh" | "power"
LANCZOS_IMPL = "fused"    # "fused" | "plain" (the JAX package's "xla")


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


def _boundary_left(B: int, chi: int, vL):
    eye = torch.eye(chi, dtype=vL.dtype, device=vL.device)
    return torch.einsum("ac,w->awc", eye, vL).expand(B, -1, -1, -1)


def _boundary_right(B: int, chi: int, vR):
    eye = torch.eye(chi, dtype=vR.dtype, device=vR.device)
    return torch.einsum("bd,v->bvd", eye, vR).expand(B, -1, -1, -1)


def _normalize(A):
    nrm = torch.linalg.vector_norm(A, dim=(1, 2, 3), keepdim=True)
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


def _local_solve_1s(Lenv, W, Renv, A, num_krylov_vecs: int, ritz_impl: str,
                    reorth: bool, lanczos_impl: str):
    """Smallest Ritz pair of every instance's H_eff.  ``"fused"`` is the
    fused-Lanczos kernel (plain three-term recurrence; ``reorth`` does not
    apply); ``"plain"`` is :func:`krylov.eigsh_lanczos` with the H_eff
    matvec kernel."""
    if lanczos_impl == "fused":
        return kernels.fused_lanczos_ground_state(
            Lenv, W, Renv, A, num_krylov_vecs=num_krylov_vecs,
            ritz_method=ritz_impl)
    if lanczos_impl != "plain":
        raise ValueError(f"unknown lanczos_impl {lanczos_impl!r}")
    Lt, W, Rt, _ = kernels.prepare_operands(Lenv, W.contiguous(), Renv, A)

    def mv(x):
        xt = x.permute(0, 2, 1, 3).contiguous()
        return kernels.finalize_output(kernels.heff_matvec(Lt, W, Rt, xt))

    evals, evecs = krylov.eigsh_lanczos(
        mv, A, num_krylov_vecs=num_krylov_vecs, numeig=1,
        ritz_method=ritz_impl, reorthogonalize=reorth)
    return evals[:, 0], evecs[:, 0]


def _gauge_env_left(Lenv, W, A, qr_impl: str):
    """Gauge-shift right (A = Q.Rm) and grow the left env with Q."""
    Q, Rm = _qr_shift_right(A, qr_impl)
    return Q, Rm, _update_left(Lenv, Q, W)


def _gauge_env_right(Renv, W, A, qr_impl: str):
    """Gauge-shift left (A = Lm.Q) and grow the right env with Q."""
    Lm, Q = _rq_shift_left(A, qr_impl)
    return Q, Lm, _update_right(Renv, Q, W)


def _site(Ws, i: int):
    """Site i's MPO tensor of a shared (N, ...) or batched (B, N, ...)
    stack."""
    return Ws[i] if Ws.dim() == 5 else Ws[:, i]


def _right_canonicalize_and_envs(As, Ws, vR, R0, qr_impl: str):
    B, N, chi, d, _ = As.shape
    Renv = _boundary_right(B, chi, vR) if R0 is None else R0
    Lm = torch.eye(chi, dtype=As.dtype, device=As.device).expand(B, -1, -1)
    Qs, Renvs = [None] * N, [None] * N
    for i in reversed(range(N)):
        A = _normalize(torch.einsum("Basb,Bbc->Basc", As[:, i], Lm))
        Renvs[i] = Renv
        Qs[i], Lm, Renv = _gauge_env_right(Renv, _site(Ws, i), A, qr_impl)
    # re-absorb the left-over center factor: site 0 is the center
    Qs[0] = torch.einsum("Bab,Bbsc->Basc", Lm, Qs[0])
    return torch.stack(Qs, 1), torch.stack(Renvs, 1)


def right_canonicalize_and_envs(As, Ws, vL, vR, R0=None,
                                qr_impl: Optional[str] = None):
    """Bring all sites to right-canonical form and emit the right
    environments ``Renvs[i]`` (of the sites > i), for one instance
    As (N, chi, d, chi).  ``R0`` overrides the open-boundary right env."""
    qr_impl = QR_IMPL if qr_impl is None else qr_impl
    with highest_precision():
        Qs, Renvs = _right_canonicalize_and_envs(
            As[None], Ws, vR, None if R0 is None else R0[None], qr_impl)
    return Qs[0], Renvs[0]


class SweepResult(NamedTuple):
    As: torch.Tensor
    energy: torch.Tensor
    energies: torch.Tensor    # per-site Lanczos energies, last half-sweep
    trunc_err: torch.Tensor   # accumulated truncated weight (2-site only)
    renvs: Optional[torch.Tensor] = None  # right envs in the final gauge;
    # passing them as ``renvs=`` to the next sweep skips the prepass


def _one_site_sweep_impl(As, Ws, vL, vR, num_krylov_vecs: int,
                         boundary_envs, qr_impl: str, ritz_impl: str,
                         reorth: bool, lanczos_impl: str,
                         renvs) -> SweepResult:
    """One full (left-to-right + right-to-left) one-site sweep of a batch
    As (B, N, chi, d, chi).  ``boundary_envs`` are (B, chi, M, chi)."""
    B, N, chi, d, _ = As.shape
    Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
    if renvs is None:
        As, Renvs = _right_canonicalize_and_envs(
            As, Ws, vR, None if boundary_envs is None else boundary_envs[1],
            qr_impl)
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
        As1[i], Rm, Lenv = _gauge_env_left(Lenv, W, A_opt, qr_impl)

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
        As2[i], Lm, Renv = _gauge_env_right(Renv, W, A_opt, qr_impl)
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
                   renvs=None) -> SweepResult:
    """One full one-site DMRG sweep of one instance As (N, chi, d, chi),
    on the device the tensors lie on.

    ``boundary_envs``: optional (L0, R0), each (chi, M, chi), replacing the
    open-boundary environments.  ``qr_impl``/``ritz_impl``/``lanczos_impl``
    default to :data:`QR_IMPL`/:data:`RITZ_IMPL`/:data:`LANCZOS_IMPL`.
    ``renvs``: the previous result's ``renvs``, which skips the
    re-canonicalization prepass."""
    qr_impl = QR_IMPL if qr_impl is None else qr_impl
    ritz_impl = RITZ_IMPL if ritz_impl is None else ritz_impl
    lanczos_impl = LANCZOS_IMPL if lanczos_impl is None else lanczos_impl
    benvs = (None if boundary_envs is None
             else tuple(e[None] for e in boundary_envs))
    with highest_precision():
        res = _one_site_sweep_impl(
            As[None], Ws, vL, vR, num_krylov_vecs, benvs, qr_impl,
            ritz_impl, reorth, lanczos_impl,
            None if renvs is None else renvs[None])
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
    """Sweeping ground-state solver for one MPS stack (N, chi, d, chi)
    and an :class:`MPO`.  Tensors stay on their device; anything else goes
    to :func:`default_device`."""

    def __init__(self, mps, mpo: MPO, device: Optional[Device] = None):
        self.As = as_tensor(mps, device)
        self.mpo = mpo
        if self.As.shape[0] != mpo.num_sites:
            raise ValueError(f"MPS has {self.As.shape[0]} sites but MPO "
                             f"has {mpo.num_sites}")
        if self.As.shape[2] != mpo.phys_dim:
            raise ValueError(f"MPS physical dimension {self.As.shape[2]} "
                             f"!= MPO physical dimension {mpo.phys_dim}")
        self.energies: list = []

    def run_one_site(self, num_sweeps: int = 4, num_krylov_vecs: int = 10,
                     tol: float = 1e-10, verbose: int = 0) -> float:
        """Run chained one-site sweeps; returns the last energy."""
        e_prev, renvs = None, None
        for sweep in range(num_sweeps):
            res = one_site_sweep(self.As, self.mpo.Ws, self.mpo.vL,
                                 self.mpo.vR,
                                 num_krylov_vecs=num_krylov_vecs,
                                 renvs=renvs)
            self.As, renvs = res.As, res.renvs
            e = float(res.energy)
            self.energies.append(e)
            if verbose > 0:
                print(f"sweep {sweep}: E = {e:.12f}")
            if e_prev is not None and abs(e - e_prev) < tol:
                break
            e_prev = e
        return self.energies[-1]

    def compute_energy(self) -> float:
        return float(mps_mpo_expectation(self.As, self.mpo.Ws, self.mpo.vL,
                                         self.mpo.vR))
