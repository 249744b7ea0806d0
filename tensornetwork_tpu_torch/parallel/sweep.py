"""Chain-distributed DMRG sweeps: the SP analog.

Counterpart of :mod:`tensornetwork_tpu.parallel.sweep`: the chain is cut
into contiguous blocks, one a rank of the ``sp`` mesh dimension, and the
blocks sweep locally in parallel with their neighbours frozen (real-space
parallel DMRG, Stoudenmire-White):

* environments are relayed along the ranks in P-1 neighbour exchanges,
  each one ``batch_isend_irecv`` where the JAX package has a
  ``lax.ppermute`` (:func:`~tensornetwork_tpu_torch.parallel.collectives.
  shift`);
* the norm environments at each block boundary are gauged to the
  identity by a PSD square root that projects out the near-null
  directions (:func:`_psd_factor`), so the in-block Lanczos stays a
  standard eigenproblem; the gauge is local to the active block, and its
  inverse maps the block back;
* blocks of one colour update together: ``num_colors == P`` is the exact
  sequential wave, 2 the red/black schedule.

The in-block sweep is the port's ``_one_site_sweep_impl`` /
``_two_site_sweep_impl`` with ``boundary_envs``, so with the default
``lanczos_impl="fused"`` each block's local solves run K2 on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from tensornetwork_tpu_torch.config import as_tensor, highest_precision
from tensornetwork_tpu_torch.models import dmrg as _dmrg
from tensornetwork_tpu_torch.parallel import collectives as C
from tensornetwork_tpu_torch.parallel.mesh import (
    axis_group, axis_size, local, placements, replicate, shard_array)


def _fold_left_env(L, As_blk, Ws_blk):
    for i in range(As_blk.shape[0]):
        L = _dmrg._update_left(L[None], As_blk[None, i], Ws_blk[i])[0]
    return L


def _fold_right_env(R, As_blk, Ws_blk):
    for i in reversed(range(As_blk.shape[0])):
        R = _dmrg._update_right(R[None], As_blk[None, i], Ws_blk[i])[0]
    return R


def _fold_left_norm(n, As_blk):
    for A in As_blk:
        n = torch.einsum("ac,atr,ctp->rp", n, A, torch.conj(A))
    return n


def _fold_right_norm(n, As_blk):
    for A in reversed(As_blk):
        n = torch.einsum("bd,ltb,ptd->lp", n, A, torch.conj(A))
    return n


def _psd_factor(n, rel_eps: Optional[float] = None):
    """(a, a_inv) with a a^H = n, the near-null directions of n projected
    out (a and a_inv both zero there), as the JAX function: at f32 the
    null eigenvalues of a rank-deficient boundary norm are eigh noise
    (~eps max), and inverting them instead amplified unphysical directions
    by ~1e5 in the JAX package's f32 runs.  The cut is 100 eps of the
    largest eigenvalue."""
    e, v = torch.linalg.eigh(0.5 * (n + torch.conj(n.mT)))
    e = e.real
    if rel_eps is None:
        rel_eps = 100.0 * float(torch.finfo(e.dtype).eps)
    cut = torch.clamp(e.max(), min=0.0) * rel_eps
    keep = e > cut
    sq = torch.sqrt(torch.where(keep, e, 1.0))
    a = v * torch.where(keep, sq, 0.0).to(v.dtype)[None, :]
    a_inv = v * torch.where(keep, 1.0 / sq, 0.0).to(v.dtype)[None, :]
    return a, torch.conj(a_inv.mT)


def _relay(fold, boundary, group, direction: int):
    """Pipeline-fill environment relay: after P-1 neighbour exchanges each
    rank holds the fold of all blocks on its ``direction`` side
    (+1: from the left end, -1: from the right end)."""
    env = boundary
    for _ in range(C.group_size(group) - 1):
        received = C.shift(fold(env), group, direction)
        env = boundary if received is None else received
    return env


def make_distributed_sweep(mesh, num_devices: int,
                           num_krylov_vecs: int = 10,
                           inner_sweeps: int = 1,
                           axis_name: str = "sp",
                           num_colors: int = 2,
                           two_site: bool = False,
                           lanczos_impl: Optional[str] = None):
    """The distributed sweep of ``mesh``: ``one_iteration(As, Ws, vL, vR)
    -> (As, energy)`` runs one phase a colour.  ``As`` (n, chi, d, chi)
    and ``Ws`` (n, M, M, d, d) are this rank's block of the chain (or
    DTensors sharded on their first axis, returned as such); ``energy``
    is the lowest energy an active block found, the same on every rank.
    ``lanczos_impl`` (default :data:`~tensornetwork_tpu_torch.models.dmrg.
    LANCZOS_IMPL`, ``"fused"``) is the in-block local solve."""
    group = axis_group(mesh, axis_name)
    if axis_size(mesh, axis_name) != num_devices:
        raise ValueError(f"mesh dimension {axis_name!r} has "
                         f"{axis_size(mesh, axis_name)} ranks, not "
                         f"{num_devices}")
    rank = C.group_rank(group)
    lanczos_impl = (_dmrg.LANCZOS_IMPL if lanczos_impl is None
                    else lanczos_impl)

    def phase(As, Ws, vL, vR, parity):
        chi = As.shape[1]
        dtype = As.dtype
        eyeL = _dmrg._boundary_left(1, chi, vL)[0]
        eyeR = _dmrg._boundary_right(1, chi, vR)[0]
        ident = torch.eye(chi, dtype=dtype, device=As.device)
        L = _relay(lambda e: _fold_left_env(e, As, Ws), eyeL, group, +1)
        R = _relay(lambda e: _fold_right_env(e, As, Ws), eyeR, group, -1)
        nL = _relay(lambda e: _fold_left_norm(e, As), ident, group, +1)
        nR = _relay(lambda e: _fold_right_norm(e, As), ident, group, -1)
        active = rank % num_colors == parity
        if not active:
            return As, torch.tensor(float("inf"), dtype=As.real.dtype,
                                    device=As.device)
        a, a_inv = _psd_factor(nL)        # nL = a a^H
        b, b_inv = _psd_factor(nR)        # nR = b b^H
        # gauge the block: B' = a^H . B . b (norm envs become identity)
        As_g = As.clone()
        As_g[0] = torch.einsum("ab,bsc->asc", torch.conj(a.mT), As[0])
        As_g[-1] = torch.einsum("asb,bc->asc", As_g[-1], b)
        # the hamiltonian envs in the gauged frame
        Lg = torch.einsum("xa,awc,yc->xwy", a_inv, L, torch.conj(a_inv))
        Rg = torch.einsum("xb,bwd,yd->xwy", b_inv, R, torch.conj(b_inv))
        benvs = (Lg[None], Rg[None])
        As_new = As_g[None]
        for _ in range(inner_sweeps):
            if two_site:
                res = _dmrg._two_site_sweep_impl(
                    As_new, Ws, vL, vR, num_krylov_vecs, benvs,
                    _dmrg.QR_IMPL, _dmrg.RITZ_IMPL, True, lanczos_impl,
                    _dmrg.TRUNC_IMPL, _dmrg.TRUNC_ITERS, _dmrg.TRUNC_ORTH,
                    None, None)
            else:
                res = _dmrg._one_site_sweep_impl(
                    As_new, Ws, vL, vR, num_krylov_vecs, benvs,
                    _dmrg.QR_IMPL, _dmrg.RITZ_IMPL, True, lanczos_impl,
                    _dmrg.EPILOGUE_IMPL, None)
            As_new = res.As
        As_new = As_new[0].clone()
        # back to the global frame; the back-map is not isometric (a_inv
        # carries 1/sqrt of the kept norm eigenvalues), so the boundary
        # sites are normalised after it, a global change of scale
        A0 = torch.einsum("ab,bsc->asc", torch.conj(a_inv.mT), As_new[0])
        As_new[0] = A0 / torch.clamp(torch.linalg.vector_norm(A0), min=1e-30)
        Al = torch.einsum("asb,bc->asc", As_new[-1], b_inv)
        As_new[-1] = Al / torch.clamp(torch.linalg.vector_norm(Al),
                                      min=1e-30)
        return As_new, res.energy[0].real

    def one_iteration(As, Ws, vL, vR):
        out_dtensor = hasattr(As, "to_local")
        spec = As.placements if out_dtensor else None
        As, Ws, vL, vR = (local(t) for t in (As, Ws, vL, vR))
        e_best = None
        with highest_precision():
            Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
            for color in range(num_colors):
                As, e = phase(As, Ws, vL, vR, color)
                e = C.all_gather(e.reshape(1), 0, group).min()
                e_best = e if e_best is None else torch.minimum(e_best, e)
        if out_dtensor:
            from torch.distributed.tensor import DTensor
            As = DTensor.from_local(As, mesh, spec, run_check=False)
        return As, e_best

    return one_iteration


class DistributedDMRG:
    """Ground-state search with the chain distributed over the mesh
    dimension ``axis_name``.

    ``num_colors``: blocks of one colour update together.  ``num_colors ==
    num_devices`` (the default) is the exact sequential wave, one active
    block at a time; ``2`` (red/black) updates half the blocks a phase,
    converging approximately (stale far-block environments).  ``As`` (N,
    chi, d, chi), the whole chain on every rank (rank 0's is distributed)
    or a DTensor sharded on its first axis; N must divide over the ranks.
    ``lanczos_impl`` as in :func:`make_distributed_sweep`."""

    def __init__(self, As, mpo, mesh, axis_name: str = "sp",
                 num_krylov_vecs: int = 10, inner_sweeps: int = 1,
                 num_colors: Optional[int] = None,
                 two_site: bool = False,
                 lanczos_impl: Optional[str] = None):
        self.mesh = mesh
        self.axis_name = axis_name
        num_devices = axis_size(mesh, axis_name)
        N = As.shape[0]
        if N % num_devices != 0:
            raise ValueError(
                f"chain length {N} not divisible by {num_devices} devices")
        spec = placements(mesh, {axis_name: 0})
        if not hasattr(As, "to_local"):
            As = shard_array(as_tensor(As, mesh.device_type), mesh, spec)
        self.As = As
        self.Ws = shard_array(mpo.Ws, mesh, spec)
        self.vL = replicate(mpo.vL, mesh)
        self.vR = replicate(mpo.vR, mesh)
        if num_colors is None:
            num_colors = num_devices
        self._step = make_distributed_sweep(
            mesh, num_devices, num_krylov_vecs, inner_sweeps, axis_name,
            num_colors, two_site, lanczos_impl)
        self.energies = []

    def run(self, num_iterations: int = 10, tol: float = 1e-10) -> float:
        e_prev = None
        for _ in range(num_iterations):
            self.As, e = self._step(self.As, self.Ws, self.vL, self.vR)
            e = float(e)
            self.energies.append(e)
            if e_prev is not None and abs(e - e_prev) < tol:
                break
            e_prev = e
        return self.energies[-1]

    def full_state(self) -> torch.Tensor:
        """The whole chain (N, chi, d, chi), gathered on every rank."""
        return C.all_gather(local(self.As), 0,
                            axis_group(self.mesh, self.axis_name))

    def energy(self) -> float:
        """Exact <H> of the current distributed state."""
        As = self.full_state()
        Ws = C.all_gather(local(self.Ws), 0,
                          axis_group(self.mesh, self.axis_name))
        return float(_dmrg.mps_mpo_expectation(
            As, Ws.to(As.dtype), local(self.vL).to(As.dtype),
            local(self.vR).to(As.dtype)))
