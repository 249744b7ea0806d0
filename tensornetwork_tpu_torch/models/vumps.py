"""VUMPS and iTDVP: uniform MPS of the infinite chain.

Counterpart of :mod:`tensornetwork_tpu.models.vumps`: the VUMPS ground
state (Zauner-Stauber et al., PRB 97, 045145 (2018)) and iTDVP time
evolution of a uniform MPS in mixed canonical form.  One VUMPS iteration
solves the transfer fixed points and the quasi-triangular MPO environments
by restarted GMRES (:func:`krylov.gmres_kernel`), the AC and C effective
Hamiltonians by Lanczos, and the new gauge by two polar splits (SVD).

Where the JAX package compiles the iteration into one XLA program, here it
is eager PyTorch: the GMRES and Ritz loops end on a residual, each pass
with one host check (:data:`krylov.counts` and :data:`counts`).  The AC and C solves run on
K2, the fused Lanczos kernel (:func:`kernels.fused_lanczos_ground_state`,
eigh Ritz), with ``lanczos_impl="fused"`` -- the default for a real state
on the card where the resident tier admits the shape (:data:`counts`
counts their passes) -- or on the reorthogonalised Lanczos
(``"plain"``, the JAX package's ``"xla"``).  The transfer maps, channel sums
and iTDVP's Lanczos exponentials are einsums, as in the JAX package.

Conventions:
  AL/AR/AC[a, s, b]   uniform site tensors, a/b bond, s physical
  C[a, b]             center matrix, AC = AL C = C AR at the fixed point
  W[wl, wr, s, t]     uniform MPO tensor in lower-triangular (Schur) form
                      (W[w, v] = 0 for v > w, W[0, 0] = W[M-1, M-1] = 1):
                      a bulk site of any MPO of :mod:`.mpo`
  LW[a, w, c] / RW[b, v, d]  stacked environments, [ket, mpo, bra]
Every entry point runs inside
:func:`~tensornetwork_tpu_torch.config.highest_precision`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, as_tensor, default_device
from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.ops import decompositions, kernels, krylov


class VUMPSState(NamedTuple):
    AL: torch.Tensor
    AR: torch.Tensor
    C: torch.Tensor
    AC: torch.Tensor


class VUMPSResult(NamedTuple):
    state: VUMPSState
    energy: float
    energies: list            # energy density per iteration
    gradient_norms: list      # ||AC - AL C|| per iteration
    LW: torch.Tensor          # converged left environment (chi, M, chi)
    RW: torch.Tensor          # converged right environment (chi, M, chi)


# Ritz passes of the AC and C solves since the last reset_counts() (one K2
# launch each where the solve is fused), and the host checks of their
# residuals
counts = {"ac_passes": 0, "c_passes": 0, "ritz_checks": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


# ---------------------------------------------------------------------------
# transfer maps and fixed points
# ---------------------------------------------------------------------------


def _transfer_left(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(x| T_A: x'[r,p] = x[a,c] A[a,t,r] conj(A)[c,t,p]."""
    xa = torch.einsum("ac,atr->ctr", x, A)
    return torch.einsum("ctr,ctp->rp", xa, torch.conj(A))


def _transfer_right(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """T_A |x): x'[a,c] = A[a,t,r] conj(A)[c,t,p] x[r,p]."""
    ax = torch.einsum("ctp,rp->ctr", torch.conj(A), x)
    return torch.einsum("atr,ctr->ac", A, ax)


def _trace_normalized(x: torch.Tensor) -> torch.Tensor:
    tr = torch.trace(x)
    return x / torch.where(tr.abs() > 0, tr, 1.0)


def _fixed_point(transfer: Callable, A: torch.Tensor, x0: torch.Tensor,
                 n_iter: int, gmres_m: int, gmres_restarts: int,
                 rtol) -> torch.Tensor:
    """Fixed point (eigenvalue 1) of ``x -> transfer(x, A)``: up to 5
    power steps from ``x0`` (Hermitised, trace-normalised), then the
    deflated system ``(1 - T + q tr(.)) x = q``, q = I/chi, by GMRES
    warm-started there.  Power iteration alone contracts only by the
    transfer gap per step, and its leftover error made H_AC non-Hermitian
    at that level in the JAX package (the critical-TFI gauge error then
    stalled near 1e-4)."""
    x = x0
    for _ in range(min(n_iter, 5)):
        x = transfer(x, A)
        x = _trace_normalized(0.5 * (x + x.mH))
    chi = A.shape[0]
    q = torch.eye(chi, dtype=A.dtype, device=A.device) / chi
    x = _gmres_static(lambda y: y - transfer(y, A) + torch.trace(y) * q,
                      q, x, gmres_m, gmres_restarts, rtol)
    return _trace_normalized(0.5 * (x + x.mH))


def _fixed_point_right(AL, r0, n_iter: int, gmres_m: int = 30,
                       gmres_restarts: int = 2, rtol=1e-7):
    """Right fixed point of T_AL (AL left-isometric)."""
    return _fixed_point(_transfer_right, AL, r0, n_iter, gmres_m,
                        gmres_restarts, rtol)


def _fixed_point_left(AR, l0, n_iter: int, gmres_m: int = 30,
                      gmres_restarts: int = 2, rtol=1e-7):
    """Left fixed point of T_AR (AR right-isometric)."""
    return _fixed_point(_transfer_left, AR, l0, n_iter, gmres_m,
                        gmres_restarts, rtol)


def _gmres_static(op: Callable, b: torch.Tensor, x0: torch.Tensor, m: int,
                  restarts: int, rtol) -> torch.Tensor:
    """``op(x) = b`` on (chi, chi) matrices by GMRES(m), at most
    ``restarts`` cycles, to the residual ``rtol |b|``."""
    shape = b.shape
    bf = b.reshape(-1)
    x, _ = krylov.gmres_kernel(lambda v: op(v.reshape(shape)).reshape(-1),
                               bf, x0.reshape(-1), m, restarts,
                               rtol * torch.linalg.vector_norm(bf))
    return x.reshape(shape)


# ---------------------------------------------------------------------------
# quasi-triangular MPO environments (channel-by-channel geometric sums)
# ---------------------------------------------------------------------------


def mpo_diagonal_coefficients(W) -> Tuple[float, ...]:
    """Host-side: the scalars lambda_w with W[w, w] = lambda_w I.

    ``W``: a tensor on any device, or an array.  Raises ``ValueError`` if a
    diagonal block is not proportional to the identity, if W is not lower
    triangular, or if W[0, 0] or W[M-1, M-1] is not the identity (the
    quasi-triangular solver needs the Schur-form layout of :mod:`.mpo`)."""
    Wn = (W.detach().cpu().numpy() if isinstance(W, torch.Tensor)
          else np.asarray(W))
    M, d = Wn.shape[0], Wn.shape[2]
    lams = []
    eye = np.eye(d)
    for w in range(M):
        blk = Wn[w, w]
        lam = np.trace(blk) / d
        if not np.allclose(blk, lam * eye, atol=1e-12):
            raise ValueError(
                f"MPO diagonal block W[{w},{w}] is not a multiple of the "
                "identity; VUMPS needs a Schur-form (triangular) MPO")
        lams.append(float(np.real(lam)))
    for w in range(M):
        for v in range(w + 1, M):
            if not np.allclose(Wn[w, v], 0.0, atol=1e-12):
                raise ValueError(
                    f"MPO is not lower triangular (W[{w},{v}] != 0); "
                    "VUMPS expects the layout of models.mpo")
    if abs(lams[0] - 1.0) > 1e-12 or abs(lams[-1] - 1.0) > 1e-12:
        raise ValueError("expected identity channels at W[0,0] and "
                         "W[M-1,M-1]")
    return tuple(lams)


def left_mpo_environment(AL, W, r, lams, LW0_guess, gmres_m: int,
                         gmres_restarts: int, rtol=1e-7
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked left environment LW (chi, M, chi) and the energy
    density, from the right fixed point ``r`` of T_AL (trace-normalised).

    Channels descend w = M-1 .. 0: M-1 is the identity start channel, a
    middle channel solves (1 - lam_w T) x = Y_w (or takes Y_w at lam_w =
    0), and channel 0 the regularised geometric sum (1 - T + |r)(1|) x =
    Y_0 - e 1 with the energy density e = (Y_0|r) projected out."""
    chi, M = AL.shape[0], W.shape[0]
    eye = torch.eye(chi, dtype=AL.dtype, device=AL.device)
    Ls = [None] * M
    Ls[M - 1] = eye
    energy = None
    for v in range(M - 2, -1, -1):
        solved = torch.stack(Ls[v + 1:])                 # (n, chi, chi)
        t = torch.einsum("wac,atr->wctr", solved, AL)
        t = torch.einsum("wctr,wst->csr", t, W[v + 1:, v])
        Y = torch.einsum("csr,csp->rp", t, torch.conj(AL))
        lam = lams[v]
        if v == 0:
            energy = (Y * r).sum()
            Ls[0] = _gmres_static(
                lambda x: x - _transfer_left(x, AL) + (x * r).sum() * eye,
                Y - energy * eye, LW0_guess, gmres_m, gmres_restarts, rtol)
        elif lam == 0.0:
            Ls[v] = Y
        else:
            Ls[v] = _gmres_static(
                lambda x, lam=lam: x - lam * _transfer_left(x, AL),
                Y, Y, gmres_m, gmres_restarts, rtol)
    return torch.stack(Ls).permute(1, 0, 2), energy


def right_mpo_environment(AR, W, l, lams, RWlast_guess, gmres_m: int,
                          gmres_restarts: int, rtol=1e-7
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked right environment RW (chi, M, chi) and the energy
    density, from the left fixed point ``l`` of T_AR: channels ascend
    w = 0 .. M-1, as :func:`left_mpo_environment` mirrored."""
    chi, M = AR.shape[0], W.shape[0]
    eye = torch.eye(chi, dtype=AR.dtype, device=AR.device)
    Rs = [None] * M
    Rs[0] = eye
    energy = None
    for w in range(1, M):
        solved = torch.stack(Rs[:w])                     # (n, chi, chi)
        t = torch.einsum("ltb,vbd->lvtd", AR, solved)
        t = torch.einsum("lvtd,vst->lsd", t, W[w, :w])
        Y = torch.einsum("lsd,psd->lp", t, torch.conj(AR))
        lam = lams[w]
        if w == M - 1:
            energy = (l * Y).sum()
            Rs[w] = _gmres_static(
                lambda x: x - _transfer_right(x, AR) + (l * x).sum() * eye,
                Y - energy * eye, RWlast_guess, gmres_m, gmres_restarts,
                rtol)
        elif lam == 0.0:
            Rs[w] = Y
        else:
            Rs[w] = _gmres_static(
                lambda x, lam=lam: x - lam * _transfer_right(x, AR),
                Y, Y, gmres_m, gmres_restarts, rtol)
    return torch.stack(Rs).permute(1, 0, 2), energy


# ---------------------------------------------------------------------------
# effective Hamiltonians, their ground states and the gauge update
# ---------------------------------------------------------------------------


def _matvec_AC(LW, W, RW, x):
    """y[c,s,d] = LW[a,w,c] W[w,v,s,t] x[a,t,b] RW[b,v,d]."""
    t = torch.einsum("awc,atb->wctb", LW, x)
    t = torch.einsum("wctb,wvst->vcsb", t, W)
    return torch.einsum("vcsb,bvd->csd", t, RW)


def _matvec_C(LW, RW, x):
    """y[c,d] = LW[a,w,c] x[a,b] RW[b,w,d]."""
    t = torch.einsum("awc,ab->wcb", LW, x)
    return torch.einsum("wcb,bwd->cd", t, RW)


def _restarted_ritz_to_tol(one_pass: Callable, mv: Callable, v0, max_restarts,
                           solve_tol: float):
    """Repeat ``one_pass`` (an m-step ground-state solve seeded with the
    current vector) until the Ritz residual ``|H v - <v|H|v> v|`` is at
    most ``solve_tol`` or ``max_restarts`` passes ran.  The residual is
    checked before each pass, once on the host (one matvec): late in a
    VUMPS run the warm start already meets it and the solve is one
    matvec.  A fixed pass count let critical chi=64 oscillate at 1e-4..1e-3
    in the JAX package: the AC and C Ritz vectors must be solved well below
    the gauge error, or they rotate apart inside the near-degenerate low
    cluster of H_AC / H_C."""
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(max_restarts):
        Hv = mv(v)
        res = torch.linalg.vector_norm(Hv - torch.vdot(v.reshape(-1),
                                                       Hv.reshape(-1)) * v)
        counts["ritz_checks"] += 1
        if not float(res) > solve_tol:
            break
        v = one_pass(v)
        v = v / torch.linalg.vector_norm(v)
    return v


def _fused(lanczos_impl: str, x: torch.Tensor, nt: int, M: int,
           m: int) -> bool:
    """Whether a solve runs on K2: ``"fused"`` where the resident tier
    admits (chi, nt, M, m), as the JAX package's VMEM rule."""
    return (lanczos_impl == "fused"
            and kernels._admits_resident(x.shape[0], nt, M, m))


def _solve(mv: Callable, fused_pass: Optional[Callable], v0, m: int,
           restarts: int, solve_tol, key: str):
    """The smallest Ritz vector of ``mv``: ``fused_pass`` (K2) or the
    reorthogonalised Lanczos, ``restarts`` passes or, with ``solve_tol``,
    until its residual meets it (:func:`_restarted_ritz_to_tol`)."""
    def one_pass(v):
        counts[key] += 1
        if fused_pass is not None:
            return fused_pass(v)
        _, vec = krylov.eigsh_lanczos(lambda x: mv(x[0])[None], v[None], m,
                                      numeig=1)
        return vec[0, 0]

    if solve_tol is None:
        v = v0 / torch.linalg.vector_norm(v0)
        for _ in range(restarts):
            v = one_pass(v)
            v = v / torch.linalg.vector_norm(v)
        return v
    return _restarted_ritz_to_tol(one_pass, mv, v0, restarts, solve_tol)


def _solve_AC(LW, W, RW, AC, m: int, lanczos_impl: str, restarts: int = 1,
              solve_tol=None):
    """Smallest Ritz vector of H_AC: K2 with eigh Ritz (the DMRG sandwich
    at nt = d) where :func:`_fused`, else the plain Lanczos.  eigh, not
    the power Ritz: its residual is too loose for the residual-targeted
    solves, and the JAX package measured the gauge error oscillating at
    1e-3 with it."""
    fused_pass = None
    if _fused(lanczos_impl, AC, AC.shape[1], W.shape[0], m):
        def fused_pass(v):
            _, evec = kernels.fused_lanczos_ground_state(
                LW[None], W, RW[None], v[None], m, ritz_method="eigh")
            return evec[0]
    return _solve(lambda x: _matvec_AC(LW, W, RW, x), fused_pass, AC, m,
                  restarts, solve_tol, "ac_passes")


def _solve_C(LW, RW, C, m: int, lanczos_impl: str, restarts: int = 1,
             solve_tol=None):
    """Zero-site :func:`_solve_AC`: on K2, the bond operator is the same
    sandwich with one physical tile and identity couplings."""
    M = LW.shape[1]
    fused_pass = None
    if _fused(lanczos_impl, C, 1, M, m):
        W_eye = torch.eye(M, dtype=C.dtype, device=C.device).reshape(
            M, M, 1, 1)

        def fused_pass(v):
            _, evec = kernels.fused_lanczos_ground_state(
                LW[None], W_eye, RW[None], v[None, :, None, :], m,
                ritz_method="eigh")
            return evec[0, :, 0, :]
    return _solve(lambda x: _matvec_C(LW, RW, x), fused_pass, C, m,
                  restarts, solve_tol, "c_passes")


def _polar_split(AC, C):
    """AL, AR from the polar parts of AC C^H and C^H AC (SVDs by
    :func:`decompositions.thin_svd`: gesvd on the card, complex64 on the
    CPU in complex128), and the gauge error ||AC - AL C||."""
    chi, d, _ = AC.shape
    U, _, Vh = decompositions.thin_svd(AC.reshape(chi * d, chi) @ C.mH)
    AL = (U @ Vh).reshape(chi, d, chi)
    U2, _, Vh2 = decompositions.thin_svd(C.mH @ AC.reshape(chi, d * chi))
    AR = (U2 @ Vh2).reshape(chi, d, chi)
    err = torch.linalg.vector_norm(AC - torch.einsum("asb,bc->asc", AL, C))
    return AL, AR, err


def _lanczos_impl(lanczos_impl: Optional[str], x: torch.Tensor) -> str:
    """``None``: ``"fused"`` for a real state on the card, else
    ``"plain"``.  K2 takes real operands only."""
    if lanczos_impl is None:
        return "fused" if x.is_cuda and not x.is_complex() else "plain"
    if lanczos_impl not in ("fused", "plain"):
        raise ValueError(f"unknown lanczos_impl {lanczos_impl!r}")
    if lanczos_impl == "fused" and x.is_complex():
        raise ValueError('lanczos_impl="fused" needs a real state')
    return lanczos_impl


def _guesses(C):
    """Cold transfer fixed-point seeds C C^H and C^T conj(C), exact at the
    fixed point."""
    return (_trace_normalized(C @ C.mH), _trace_normalized(C.mT @ C.conj()))


def vumps_iteration(state: VUMPSState, W, lams: Tuple[float, ...],
                    num_krylov_vecs: int = 25, gmres_m: int = 30,
                    gmres_restarts: int = 2, n_power: int = 10,
                    lanczos_impl: Optional[str] = None, guesses=None,
                    lanczos_restarts: int = 4, solve_tol=None):
    """One VUMPS iteration.  Returns ``(new_state, energy_density,
    gauge_error, LW, RW, guesses)`` (energy and error 0-dim tensors),
    where ``guesses = (r, l)`` are the transfer fixed points to warm-start
    the next iteration with: warm starts accumulate accuracy across the
    loop, which lets a small ``n_power`` converge through the small
    transfer gaps of a critical chain.

    ``solve_tol`` (a number): the AC and C solves repeat passes (at most
    ``lanczos_restarts``) until their Ritz residual meets it, and the
    environment GMRES solves tighten to ``clip(0.1 solve_tol, 20 eps,
    1e-7)``; None: ``lanczos_restarts`` passes and 1e-7.
    ``lanczos_impl``: ``"fused"`` (K2 where the resident tier admits the
    shape; the default for a real state on the card) or ``"plain"``.
    Counterpart of the JAX package's ``vumps_iteration``."""
    AL, AR, C, AC = state
    W = as_tensor(W, C.device).to(C.dtype)
    impl = _lanczos_impl(lanczos_impl, C)
    m = num_krylov_vecs
    if solve_tol is None:
        env_rtol = 1e-7
    else:
        eps = torch.finfo(C.real.dtype).eps
        env_rtol = min(max(0.1 * float(solve_tol), 20 * eps), 1e-7)
    with highest_precision():
        r0, l0 = _guesses(C)
        r_prev, l_prev = (r0, l0) if guesses is None else guesses
        r = _fixed_point_right(AL, 0.5 * (r_prev + r0), n_power, gmres_m,
                               gmres_restarts, env_rtol)
        l = _fixed_point_left(AR, 0.5 * (l_prev + l0), n_power, gmres_m,
                              gmres_restarts, env_rtol)
        zero = torch.zeros_like(C)
        LW, eL = left_mpo_environment(AL, W, r, lams, zero, gmres_m,
                                      gmres_restarts, env_rtol)
        RW, eR = right_mpo_environment(AR, W, l, lams, zero, gmres_m,
                                       gmres_restarts, env_rtol)
        AC_new = _solve_AC(LW, W, RW, AC, m, impl, lanczos_restarts,
                           solve_tol)
        AC_new = AC_new / torch.linalg.vector_norm(AC_new)
        C_new = _solve_C(LW, RW, C, m, impl, lanczos_restarts, solve_tol)
        C_new = C_new / torch.linalg.vector_norm(C_new)
        AL_new, AR_new, err = _polar_split(AC_new, C_new)
        energy = 0.5 * (eL + eR).real
    return (VUMPSState(AL_new, AR_new, C_new, AC_new), energy, err, LW, RW,
            (r, l))


def random_vumps_state(key: Union[torch.Generator, int], chi: int, d: int = 2,
                       dtype: torch.dtype = torch.float64,
                       device: Optional[Device] = None) -> VUMPSState:
    """Random mixed-canonical start: AL an isometry from a Householder QR
    of a normal draw, C a normalised normal draw, AR and AC from one polar
    split.  ``key``: a :class:`torch.Generator` (its device is the
    state's) or an integer seed for one on ``device``.  A generator draws
    other numbers than a JAX key of the same seed."""
    if isinstance(key, torch.Generator):
        gen, dev = key, key.device
    else:
        dev = default_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
    kw = dict(generator=gen, dtype=dtype, device=dev)
    with highest_precision():
        AL, _ = decompositions.qr(torch.randn((chi * d, chi), **kw),
                                  "householder")
        AL = AL.reshape(chi, d, chi)
        C = torch.randn((chi, chi), **kw)
        C = C / torch.linalg.vector_norm(C)
        AC = torch.einsum("asb,bc->asc", AL, C)
        _, AR, _ = _polar_split(AC, C)
    return VUMPSState(AL, AR, C, AC)


def vumps(W, chi: int, d: Optional[int] = None, num_iterations: int = 100,
          tol: float = 1e-8, num_krylov_vecs: int = 25, gmres_m: int = 30,
          gmres_restarts: int = 2, n_power: int = 10, seed: int = 0,
          dtype: torch.dtype = torch.float64,
          initial_state: Optional[VUMPSState] = None, verbose: int = 0,
          lanczos_restarts: int = 20,
          device: Optional[Device] = None) -> VUMPSResult:
    """The uniform-MPS ground state of the infinite chain with uniform MPO
    tensor ``W`` (a bulk site of any MPO of :mod:`.mpo`, e.g.
    ``FiniteTFI(J, h, N=3).Ws[1]``): iterations until the gauge error
    ``||AC - AL C||`` drops below ``tol``.

    Each iteration's solves target a residual of 0.02 times the last gauge
    error (at least 50 eps; the error may grow by at most 4x an iteration
    in that target), and the transfer fixed points are warm-started from
    the last iteration's.  The AC and C solves take
    :func:`vumps_iteration`'s default: K2 for a real state on the card
    where the resident tier admits the shape, else the plain Lanczos.
    ``W`` stays on its device if it is a tensor;
    otherwise it goes to ``device`` (the card by default).  Counterpart of
    the JAX package's ``vumps``."""
    W = as_tensor(W, device, dtype)
    lams = mpo_diagonal_coefficients(W)
    if d is None:
        d = W.shape[2]
    state = (random_vumps_state(seed, chi, d, dtype, W.device)
             if initial_state is None else initial_state)
    rdtype = state.C.real.dtype
    tol_floor = 50 * torch.finfo(rdtype).eps
    energies, errs = [], []
    LW = RW = guesses = None
    prev_err = 0.1
    for it in range(num_iterations):
        # the target in the state's precision, as the JAX package's array
        solve_tol = float(torch.tensor(max(0.02 * prev_err, tol_floor),
                                       dtype=rdtype))
        state, e, err, LW, RW, guesses = vumps_iteration(
            state, W, lams, num_krylov_vecs=num_krylov_vecs,
            gmres_m=gmres_m, gmres_restarts=gmres_restarts,
            n_power=n_power, guesses=guesses,
            lanczos_restarts=lanczos_restarts, solve_tol=solve_tol)
        e, err_f = torch.stack([e.to(rdtype), err.to(rdtype)]).tolist()
        energies.append(e)
        errs.append(err_f)
        if verbose:
            print(f"vumps it {it}: e = {e:.12f}, |AC - AL C| = {err_f:.3e}")
        if err_f < tol:
            break
        prev_err = min(err_f, prev_err * 4.0)
    return VUMPSResult(state, energies[-1], energies, errs, LW, RW)


def correlation_length(AL, num_krylov_vecs: int = 30) -> float:
    """xi = -1 / log|lambda_2|, lambda_2 the second-largest eigenvalue of
    the transfer matrix T_AL (the largest is 1), by :func:`krylov.eigs`."""
    chi = AL.shape[0]
    v0 = torch.ones((chi, chi), dtype=AL.dtype, device=AL.device) / chi
    with highest_precision():
        evals, _ = krylov.eigs(lambda x: _transfer_right(x, AL), v0,
                               num_krylov_vecs=num_krylov_vecs, numeig=2,
                               which="LM")
    lam2 = sorted(np.abs(evals.cpu().numpy()))[0]
    lam2 = min(max(float(lam2), 1e-300), 1.0 - 1e-16)
    return -1.0 / np.log(lam2)


def tfi_exact_energy_density(J: float, h: float, nk: int = 20001) -> float:
    """Exact ground energy density of the infinite chain H = J sum X_i
    X_{i+1} + h sum Z_i (the free-fermion integral): for J = -1, h = -g,
    -(1/4pi) int 2 sqrt(1 + g^2 - 2 g cos k) dk; even in both couplings'
    signs."""
    g = abs(h) / abs(J)
    k = np.linspace(-np.pi, np.pi, nk)
    eps = 2.0 * np.sqrt(1.0 + g * g - 2.0 * g * np.cos(k))
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return -abs(J) * trapezoid(eps, k) / (4.0 * np.pi)


# ---------------------------------------------------------------------------
# iTDVP (Vanderstraeten, Haegeman, Verstraete, SciPost Lect. Notes 7
# (2019), alg. 5): the VUMPS environments, then AC and C evolved by
# Lanczos exponentials of their effective Hamiltonians, then the polar
# splits.
# ---------------------------------------------------------------------------


def itdvp_step(state: VUMPSState, W, lams: Tuple[float, ...], dt,
               num_krylov_vecs: int = 25, gmres_m: int = 30,
               gmres_restarts: int = 2, n_power: int = 10,
               imaginary: bool = False):
    """One iTDVP step of size ``dt``: ``exp(-H dt)`` with ``imaginary``,
    else ``exp(-i H dt)`` (then the state should be complex).  Returns
    ``(new_state, energy_density, gauge_error)``; the energy is that of the
    input state, from the environment solves before the step.
    Counterpart of the JAX package's ``itdvp_step``."""
    AL, AR, C, AC = state
    W = as_tensor(W, C.device).to(C.dtype)
    with highest_precision():
        r0, l0 = _guesses(C)
        r = _fixed_point_right(AL, r0, n_power, gmres_m, gmres_restarts)
        l = _fixed_point_left(AR, l0, n_power, gmres_m, gmres_restarts)
        zero = torch.zeros_like(C)
        LW, eL = left_mpo_environment(AL, W, r, lams, zero, gmres_m,
                                      gmres_restarts)
        RW, eR = right_mpo_environment(AR, W, l, lams, zero, gmres_m,
                                       gmres_restarts)
        coeff = -dt if imaginary else -1j * dt

        def evolve(mv, x):
            y = krylov.expm_multiply_lanczos(lambda v: mv(v[0])[None],
                                             x[None], coeff,
                                             num_krylov_vecs)[0]
            return y / torch.linalg.vector_norm(y)

        AC_new = evolve(lambda x: _matvec_AC(LW, W, RW, x), AC)
        C_new = evolve(lambda x: _matvec_C(LW, RW, x), C)
        AL_new, AR_new, err = _polar_split(AC_new, C_new)
        energy = 0.5 * (eL + eR).real
    return VUMPSState(AL_new, AR_new, C_new, AC_new), energy, err


def itdvp(state: VUMPSState, W, t: float, num_steps: int,
          lams: Optional[Tuple[float, ...]] = None,
          num_krylov_vecs: int = 25, imaginary: bool = False,
          observable: Optional[Callable] = None):
    """Evolve a uniform MPS by total time ``t`` in ``num_steps`` iTDVP
    steps.  Returns ``(final state, energy per step, observable per
    step)``; ``observable(state) -> scalar`` is evaluated after every
    step.  Counterpart of the JAX package's ``itdvp``."""
    W = as_tensor(W, state.C.device)
    if lams is None:
        lams = mpo_diagonal_coefficients(W)
    dt = t / num_steps
    energies, obs = [], []
    for _ in range(num_steps):
        state, e, _ = itdvp_step(state, W, lams, dt,
                                 num_krylov_vecs=num_krylov_vecs,
                                 imaginary=imaginary)
        energies.append(float(e))
        if observable is not None:
            obs.append(observable(state))
    return state, energies, obs


def uniform_expectation_1site(state: VUMPSState, op) -> complex:
    """<op> per site of a uniform MPS in mixed canonical form:
    sum conj(AC)[a,s,b] op[s,t] AC[a,t,b] / |AC|^2 (the mixed gauge's
    environments are identities)."""
    AC = state.AC
    op = as_tensor(op, AC.device).to(AC.dtype)
    val = torch.einsum("asb,st,atb->", torch.conj(AC), op, AC)
    return complex(val / torch.vdot(AC.reshape(-1), AC.reshape(-1)))
