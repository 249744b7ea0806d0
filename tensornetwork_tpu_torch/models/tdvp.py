"""TDVP: one- and two-site time evolution of finite MPS.

Counterpart of :mod:`tensornetwork_tpu.models.tdvp`: the symmetric
projector-splitting integrator (Haegeman et al., PRB 94, 165116 (2016)) on
the uniform stack ``(N, chi, d, chi)`` of :mod:`.dmrg`.  A sweep evolves
each center tensor forward by dt/2 and each bond matrix backward by dt/2,
left to right and back; ``imaginary=True`` evolves ``exp(-H t)`` toward
the ground state, else ``exp(-i H t)``.  As in the DMRG sweeps, the JAX
package's ``lax.scan`` is a Python loop over the sites on tensors with a
leading batch axis, so the batched sweep
(:func:`tensornetwork_tpu_torch.parallel.batch.batched_tdvp_one_site_sweep_sc`)
is the same loop, and each local evolution is one call for the batch.

Two paths, under the JAX package's names:

* complex dtype (``tdvp_one_site_sweep``, ``tdvp_two_site_sweep``): the
  MPO cast to the state's dtype, gauges by :data:`.dmrg.QR_IMPL`
  (Householder QR), local evolutions by the reorthogonalised Lanczos
  exponential; the fused kernel K2 (:func:`kernels.expm_multiply_fused`)
  only for a real coefficient on a real state (imaginary time).
* ``_sc`` (``tdvp_one_site_sweep_sc``, ``tdvp_two_site_sweep_sc``): the
  algorithm of the JAX package's split-complex path on native complex
  tensors -- a real MPO, full-isometry polar gauges
  (:func:`decompositions.polar_complete`) and, where the resident tier
  admits the realified shape, K2 on the realified operands
  (:func:`kernels.expm_multiply_fused_sc`) for the site and the bond
  steps; else the complex Lanczos with real alphas.  The TPU needed the
  split only for want of complex dtypes; the card has them.

Every bond step is evolved, the turnaround's too with coefficient 0, as in
the JAX package: one K2 launch per site step and per bond step, 4N a
one-site sweep.  Every entry point runs inside
:func:`~tensornetwork_tpu_torch.config.highest_precision`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from tensornetwork_tpu_torch.config import Device, as_tensor, highest_precision
from tensornetwork_tpu_torch.models import dmrg
from tensornetwork_tpu_torch.models.mpo import MPO
from tensornetwork_tpu_torch.ops import decompositions, kernels, krylov

# "fused": K2 where the resident tier admits the shape, as the JAX package
# on its accelerator; "plain": the Lanczos exponential (the JAX "xla").
LANCZOS_IMPL = "fused"
# The split-complex path's gauge: a full isometry also on the
# rank-deficient centers of a product state.
SC_GAUGE = "polar_complete"

_renorm = dmrg._normalize


def _matvec_C(L, R, x):
    """Zero-site H_eff: y[c, d] = L[a,w,c] x[a,b] R[b,w,d]."""
    return torch.einsum("Bawc,Bab,Bbwd->Bcd", L, x, R)


def _is_complex(coeff) -> bool:
    return (coeff.is_complex() if isinstance(coeff, torch.Tensor)
            else isinstance(coeff, complex))


def _check_impl(lanczos_impl: Optional[str]) -> str:
    impl = LANCZOS_IMPL if lanczos_impl is None else lanczos_impl
    if impl not in ("fused", "plain"):
        raise ValueError(f"unknown lanczos_impl {impl!r}")
    return impl


def _eye_couplings(M: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The bond operator L x R as the sandwich with one physical tile and
    identity couplings."""
    return torch.eye(M, dtype=dtype, device=device).reshape(M, M, 1, 1)


def _expm_site(Lenv, W, Renv, v, coeff, m: int, lanczos_impl: str):
    """``exp(coeff H_eff) v`` of the complex-dtype path: K2 for a real
    coefficient on a real state where the resident tier admits (chi, d,
    M, m), else the Lanczos exponential."""
    _, chi, d, _ = v.shape
    if (lanczos_impl == "fused" and not v.is_complex()
            and not _is_complex(coeff)
            and kernels._admits_resident(chi, d, W.shape[-4], m)):
        return kernels.expm_multiply_fused(Lenv, W, Renv, v, coeff, m)
    return krylov.expm_multiply_lanczos(
        functools.partial(dmrg._matvec_1s, Lenv, W, Renv), v, coeff, m)


def _expm_bond(Lenv, Renv, v, coeff, m: int, lanczos_impl: str):
    """Zero-site :func:`_expm_site` on v (B, chi, chi)."""
    chi, M = v.shape[1], Lenv.shape[2]
    if (lanczos_impl == "fused" and not v.is_complex()
            and not _is_complex(coeff)
            and kernels._admits_resident(chi, 1, M, m)):
        W = _eye_couplings(M, v.dtype, v.device)
        return kernels.expm_multiply_fused(Lenv, W, Renv, v[:, :, None],
                                           coeff, m)[:, :, 0]
    return krylov.expm_multiply_lanczos(
        functools.partial(_matvec_C, Lenv, Renv), v, coeff, m)


def _expm_site_sc(Lenv, W, Renv, v, coeff, m: int, lanczos_impl: str):
    """``exp(coeff H_eff) v`` of the ``_sc`` path (W real): K2 on the
    realified operands where the resident tier admits (chi, 2d, 2M, m),
    else the complex Lanczos with real alphas."""
    _, chi, d, _ = v.shape
    M = W.shape[-4]
    if (lanczos_impl == "fused"
            and kernels._admits_resident(chi, 2 * d, 2 * M, m)):
        return kernels.expm_multiply_fused_sc(Lenv, W, Renv, v, coeff, m)
    return krylov.expm_multiply_lanczos_sc(
        functools.partial(dmrg._matvec_1s, Lenv, W.to(v.dtype), Renv), v,
        coeff, m)


def _expm_bond_sc(Lenv, Renv, v, coeff, m: int, lanczos_impl: str):
    """Zero-site :func:`_expm_site_sc` on v (B, chi, chi)."""
    chi, M = v.shape[1], Lenv.shape[2]
    if (lanczos_impl == "fused"
            and kernels._admits_resident(chi, 2, 2 * M, m)):
        W = _eye_couplings(M, v.real.dtype, v.device)
        return kernels.expm_multiply_fused_sc(Lenv, W, Renv, v[:, :, None],
                                              coeff, m)[:, :, 0]
    return krylov.expm_multiply_lanczos_sc(
        functools.partial(_matvec_C, Lenv, Renv), v, coeff, m)


def _boundaries(B: int, chi: int, vL, vR, boundary_envs):
    if boundary_envs is not None:
        return boundary_envs
    return dmrg._boundary_left(B, chi, vL), dmrg._boundary_right(B, chi, vR)


def _one_site_sweep(As, Ws, vL, vR, cf, cb, boundary_envs, qr_impl: str,
                    expm_site, expm_bond):
    """One symmetric one-site sweep of a batch As (B, N, chi, d, chi).
    ``expm_site(Lenv, W, Renv, v, coeff)`` and ``expm_bond(Lenv, Renv, v,
    coeff)`` are the local evolutions; ``Ws`` as they take it (the
    environments take it in the state's dtype).  ``cb * 0`` at the
    turnarounds keeps the coefficient's type."""
    B, N, chi, d, _ = As.shape
    Wc, vLc, vRc = (t.to(As.dtype) for t in (Ws, vL, vR))
    L0, R0 = _boundaries(B, chi, vLc, vRc, boundary_envs)
    As, Renvs = dmrg._right_canonicalize_and_envs(As, Wc, vRc, R0, qr_impl)
    C = torch.eye(chi, dtype=As.dtype, device=As.device).expand(B, -1, -1)
    Lenv, ALs, Lenvs = L0, [None] * N, [None] * N
    for i in range(N):
        AC = _renorm(torch.einsum("Bab,Bbsc->Basc", C, As[:, i]))
        AC = _renorm(expm_site(Lenv, Ws[i], Renvs[:, i], AC, cf))
        ALs[i], C = dmrg._qr_shift_right(AC, qr_impl)
        Lenvs[i] = Lenv
        Lenv = dmrg._update_left(Lenv, ALs[i], Wc[i])
        C = _renorm(expm_bond(Lenv, Renvs[:, i], C,
                              cb if i < N - 1 else cb * 0))

    Renv, ARs = R0, [None] * N
    for i in reversed(range(N)):
        AC = _renorm(torch.einsum("Basb,Bbc->Basc", ALs[i], C))
        AC = _renorm(expm_site(Lenvs[i], Ws[i], Renv, AC, cf))
        C, ARs[i] = dmrg._rq_shift_left(AC, qr_impl)
        Renv = dmrg._update_right(Renv, ARs[i], Wc[i])
        C = _renorm(expm_bond(Lenvs[i], Renv, C, cb if i > 0 else cb * 0))
    # site 0's forward step ends the splitting: absorb the bond matrix
    ARs[0] = torch.einsum("Bab,Bbsc->Basc", C, ARs[0])
    return torch.stack(ARs, 1)


def _two_site_sweep(As, Ws, vL, vR, cf, cb, boundary_envs, qr_impl: str,
                    expm):
    """One symmetric two-site sweep of a batch As (B, N, chi, d, chi):
    each two-site block evolves forward dt/2, is split by the masked SVD
    back to chi, and the new center evolves backward dt/2.
    ``expm(matvec, v, coeff)`` is the Lanczos exponential.  Returns
    (stack, accumulated truncated weight (B,))."""
    B, N, chi, d, _ = As.shape
    Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
    L0, R0 = _boundaries(B, chi, vL, vR, boundary_envs)
    As, Renvs = dmrg._right_canonicalize_and_envs(As, Ws, vR, R0, qr_impl)
    terr = torch.zeros((B,), dtype=As.real.dtype, device=As.device)

    def split(theta):
        res = decompositions.svd_masked(theta.reshape(B, chi * d, d * chi),
                                        max_singular_values=chi)
        return res.u, _renorm(res.s), res.vh, res.trunc_sq_norm

    Lenv, AC = L0, As[:, 0]
    ALs, Lenvs = [None] * (N - 1), [None] * (N - 1)
    for i in range(N - 1):
        W1, W2, Renv = Ws[i], Ws[i + 1], Renvs[:, i + 1]
        theta = _renorm(torch.einsum("Basb,Bbtc->Bastc", AC, As[:, i + 1]))
        theta = _renorm(expm(functools.partial(dmrg._matvec_2s, Lenv, W1, W2,
                                               Renv), theta, cf))
        u, s, vh, tsq = split(theta)
        ALs[i], Lenvs[i] = u.reshape(B, chi, d, chi), Lenv
        Lenv = dmrg._update_left(Lenv, ALs[i], W1)
        AC = (s[:, :, None] * vh).reshape(B, chi, d, chi)
        AC = _renorm(expm(functools.partial(dmrg._matvec_1s, Lenv, W2, Renv),
                          AC, cb if i < N - 2 else cb * 0))
        terr = terr + tsq

    Renv, out = R0, [None] * N
    for i in reversed(range(N - 1)):
        W1, W2, Lenv = Ws[i], Ws[i + 1], Lenvs[i]
        theta = _renorm(torch.einsum("Basb,Bbtc->Bastc", ALs[i], AC))
        theta = _renorm(expm(functools.partial(dmrg._matvec_2s, Lenv, W1, W2,
                                               Renv), theta, cf))
        u, s, vh, tsq = split(theta)
        out[i + 1] = vh.reshape(B, chi, d, chi)
        Renv = dmrg._update_right(Renv, out[i + 1], W2)
        AC = (u * s[:, None, :]).reshape(B, chi, d, chi)
        AC = _renorm(expm(functools.partial(dmrg._matvec_1s, Lenv, W1, Renv),
                          AC, cb if i > 0 else cb * 0))
        terr = terr + tsq
    out[0] = AC
    return torch.stack(out, 1), terr


def _coefficients(dt, imaginary: bool):
    """(forward, backward) half-step coefficients of a scalar dt."""
    return (-0.5 * dt, 0.5 * dt) if imaginary else (-0.5j * dt, 0.5j * dt)


def _coefficients_sc(dt, B: int, dtype: torch.dtype, device):
    """(forward, backward) real-time coefficients as complex (B,) tensors
    of a scalar or (B,) dt."""
    dt = torch.as_tensor(dt, dtype=dtype, device=device).expand(B)
    zero = torch.zeros_like(dt)
    return torch.complex(zero, -0.5 * dt), torch.complex(zero, 0.5 * dt)


def _batched_envs(boundary_envs):
    return (None if boundary_envs is None
            else tuple(e[None] for e in boundary_envs))


def _one_site_sweep_sc(As, Ws, vL, vR, dt, num_krylov_vecs: int,
                       boundary_envs, lanczos_impl: Optional[str]):
    """The ``_sc`` one-site sweep of a batch As (B, N, chi, d, chi),
    complex; ``dt`` scalar or (B,).  Call inside highest_precision()."""
    real = As.real.dtype
    impl, m = _check_impl(lanczos_impl), num_krylov_vecs
    cf, cb = _coefficients_sc(dt, As.shape[0], real, As.device)
    return _one_site_sweep(
        As, Ws.to(real), vL, vR, cf, cb, boundary_envs, SC_GAUGE,
        functools.partial(_expm_site_sc, m=m, lanczos_impl=impl),
        functools.partial(_expm_bond_sc, m=m, lanczos_impl=impl))


def tdvp_one_site_sweep(As, Ws, vL, vR, dt, num_krylov_vecs: int = 20,
                        imaginary: bool = False,
                        boundary_envs: Optional[Tuple] = None,
                        lanczos_impl: Optional[str] = None) -> torch.Tensor:
    """One symmetric one-site TDVP sweep of one stack As (N, chi, d, chi)
    by ``dt``: ``exp(-i H dt)`` (As complex) or, with ``imaginary``,
    ``exp(-H dt)``.  Returns the evolved right-canonical stack.
    ``boundary_envs``: optional (L0, R0), each (chi, M, chi).
    ``lanczos_impl`` (default :data:`LANCZOS_IMPL`): ``"fused"`` takes K2
    for the real coefficient of imaginary time on a real state where the
    resident tier admits the shape.  Counterpart of the JAX package's
    ``tdvp_one_site_sweep``."""
    impl, m = _check_impl(lanczos_impl), num_krylov_vecs
    cf, cb = _coefficients(dt, imaginary)
    with highest_precision():
        out = _one_site_sweep(
            As[None], Ws.to(As.dtype), vL, vR, cf, cb,
            _batched_envs(boundary_envs), dmrg.QR_IMPL,
            functools.partial(_expm_site, m=m, lanczos_impl=impl),
            functools.partial(_expm_bond, m=m, lanczos_impl=impl))
    return out[0]


def tdvp_one_site_sweep_sc(As, Ws, vL, vR, dt, num_krylov_vecs: int = 20,
                           boundary_envs: Optional[Tuple] = None,
                           lanczos_impl: Optional[str] = None
                           ) -> torch.Tensor:
    """One symmetric one-site real-time TDVP sweep, ``exp(-i H dt)``, of a
    complex stack As (N, chi, d, chi) with the real MPO ``Ws``, by the
    algorithm of the JAX package's split-complex ``tdvp_one_site_sweep_sc``:
    full-isometry polar gauges and, with ``"fused"``, K2 on the realified
    operands for every site and bond step the resident tier admits."""
    with highest_precision():
        out = _one_site_sweep_sc(As[None], Ws, vL, vR, dt, num_krylov_vecs,
                                 _batched_envs(boundary_envs), lanczos_impl)
    return out[0]


def tdvp_two_site_sweep(As, Ws, vL, vR, dt, num_krylov_vecs: int = 20,
                        imaginary: bool = False,
                        boundary_envs: Optional[Tuple] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric two-site TDVP sweep (2TDVP) of one stack: two-site
    blocks evolve forward dt/2 by the Lanczos exponential, are truncated
    back to chi by the masked SVD, and the new centers evolve backward
    dt/2.  Returns (evolved stack, accumulated squared truncated weight).
    Counterpart of the JAX package's ``tdvp_two_site_sweep``; no kernel,
    as there."""
    cf, cb = _coefficients(dt, imaginary)

    def expm(mv, v, coeff):
        return krylov.expm_multiply_lanczos(mv, v, coeff, num_krylov_vecs)

    with highest_precision():
        out, terr = _two_site_sweep(As[None], Ws, vL, vR, cf, cb,
                                    _batched_envs(boundary_envs),
                                    dmrg.QR_IMPL, expm)
    return out[0], terr[0]


def tdvp_two_site_sweep_sc(As, Ws, vL, vR, dt, num_krylov_vecs: int = 20,
                           boundary_envs: Optional[Tuple] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tdvp_two_site_sweep` in real time by the algorithm of the JAX
    package's split-complex ``tdvp_two_site_sweep_sc``: polar gauges, the
    complex Lanczos with real alphas, the masked SVD of the complex
    blocks.  Returns (evolved stack, accumulated truncated weight)."""
    cf, cb = _coefficients_sc(dt, 1, As.real.dtype, As.device)

    def expm(mv, v, coeff):
        return krylov.expm_multiply_lanczos_sc(mv, v, coeff, num_krylov_vecs)

    with highest_precision():
        out, terr = _two_site_sweep(As[None], Ws, vL, vR, cf, cb,
                                    _batched_envs(boundary_envs), SC_GAUGE,
                                    expm)
    return out[0], terr[0]


def mps_mpo_expectation_sc(As, Ws, vL, vR) -> torch.Tensor:
    """<psi|H|psi>/<psi|psi> of a complex stack with a real MPO, as a
    complex scalar (imaginary part ~0 for Hermitian H)."""
    return dmrg.mps_mpo_expectation(As, *(t.to(As.dtype)
                                           for t in (Ws, vL, vR)))


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class TDVP:
    """Time evolution of one MPS -- a stack (N, chi, d, chi) or a
    :class:`~tensornetwork_tpu_torch.models.mps.FiniteMPS`, which gets the
    evolved state back (``from_stack``) after every step -- under an
    :class:`MPO`.  For real time pass a complex state, or set
    ``split_complex=True`` to run the ``_sc`` path (a real state is then
    taken as complex; the MPO stays real).  Tensors stay on their device;
    anything else goes to :func:`~tensornetwork_tpu_torch.config.
    default_device`.  Counterpart of the JAX package's ``TDVP``, whose
    ``_sc`` path leaves its ``FiniteMPS`` as it was."""

    def __init__(self, mps, mpo: MPO, split_complex: bool = False,
                 device: Optional[Device] = None):
        self._mps_obj = mps if hasattr(mps, "to_stack") else None
        As = as_tensor(mps.to_stack() if self._mps_obj is not None else mps,
                       device)
        if As.shape[0] != mpo.num_sites:
            raise ValueError(
                f"MPS has {As.shape[0]} sites, MPO {mpo.num_sites}")
        self._sc = split_complex
        if split_complex:
            As = As.to(_complex_dtype(As.dtype))
        self.As = As
        mpo_dtype = As.real.dtype if split_complex else As.dtype
        self._Ws, self._vL, self._vR = (
            t.to(dtype=mpo_dtype, device=As.device)
            for t in (mpo.Ws, mpo.vL, mpo.vR))
        self.mpo = mpo
        self.truncation_errors: list = []

    def step(self, dt, num_krylov_vecs: int = 20, imaginary: bool = False,
             two_site: bool = False) -> None:
        args = (self.As, self._Ws, self._vL, self._vR, dt)
        if self._sc and imaginary:
            raise NotImplementedError(
                "imaginary time needs no complex dtype: run the plain "
                "real-dtype path")
        if two_site:
            fn = tdvp_two_site_sweep_sc if self._sc else functools.partial(
                tdvp_two_site_sweep, imaginary=imaginary)
            self.As, terr = fn(*args, num_krylov_vecs=num_krylov_vecs)
            self.truncation_errors.append(float(terr))
        elif self._sc:
            self.As = tdvp_one_site_sweep_sc(*args,
                                             num_krylov_vecs=num_krylov_vecs)
        else:
            self.As = tdvp_one_site_sweep(*args,
                                          num_krylov_vecs=num_krylov_vecs,
                                          imaginary=imaginary)
        if self._mps_obj is not None:
            self._mps_obj.from_stack(self.As)

    def evolve(self, t: float, num_steps: int, num_krylov_vecs: int = 20,
               imaginary: bool = False, two_site: bool = False
               ) -> torch.Tensor:
        dt = t / num_steps
        for _ in range(num_steps):
            self.step(dt, num_krylov_vecs, imaginary, two_site)
        return self.As

    def energy(self) -> float:
        e = mps_mpo_expectation_sc(self.As, self._Ws, self._vL, self._vR)
        return float(e.real)
