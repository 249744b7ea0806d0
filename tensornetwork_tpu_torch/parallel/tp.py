"""Bond-dimension sharding of one large-chi chain: the TP analog.

Counterpart of :mod:`tensornetwork_tpu.parallel.tp`.  The JAX package lays
the MPS out with its right bond split over a ``model`` mesh axis and lets
XLA partition the unchanged sweep; here the sweep is written out on the
local blocks, with its collectives explicit over the ``model`` group:

* layout: site tensors A[a, s, b] keep the left bond a whole and hold the
  rank's block of the right bond b (chi/P of it); the left environments
  are whole on every rank, the right environments R[b, v, d] hold the
  rank's rows b (all d);
* the local matvec y[c,s,d] = L[a,w,c] W[w,v,s,t] x[a,t,b] R[b,v,d]: K1
  (:func:`~tensornetwork_tpu_torch.ops.kernels.heff_matvec`) on the
  block contract, the partial sum over this rank's b for every d, then one
  ``reduce_scatter`` over d; the Lanczos inner products and norms are
  local partials and one ``all_reduce`` each.  The fused Lanczos kernels
  cannot take a collective inside a launch, so the solve is the plain
  recurrence (the JAX package's ``"xla"`` route, reorthogonalised);
* the gauge QR / RQ, the Ritz solve and the two-site truncation run on the
  panel gathered with one ``all_gather``, every rank alike, and are
  sliced back; the environment growth runs on the rank's block (a left
  env's rows gathered, a right env's partial reduce-scattered).

Sweeps chain ``renvs`` and keep the energies on the device, one host sync
at the end unless ``tol`` is given, as in the JAX package's.  A leading batch
axis is kept, so a ``("data", "model")`` mesh runs many instances, each
bond-sharded (dp x tp).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from tensornetwork_tpu_torch.config import as_tensor, highest_precision
from tensornetwork_tpu_torch.models import dmrg as _dmrg
from tensornetwork_tpu_torch.models.mpo import MPO
from tensornetwork_tpu_torch.ops import kernels, krylov
from tensornetwork_tpu_torch.parallel import collectives as C
from tensornetwork_tpu_torch.parallel.mesh import (
    axis_group, local, placements, replicate, shard_array)


def shard_mps_for_tp(As, mesh, axis: str = "model",
                     batch_axis: Optional[str] = None):
    """The stacked MPS as a DTensor with its right bond (last axis) split
    over ``axis``; the left bond stays whole, so QR panels gather along
    one axis.  With ``batch_axis`` the leading (batch) axis is split over
    that mesh dimension too."""
    shards = {axis: As.dim() - 1}
    if batch_axis is not None:
        shards[batch_axis] = 0
    return shard_array(As, mesh, placements(mesh, shards))


def replicate_mpo(mpo: MPO, mesh) -> MPO:
    """The MPO's tensors as replicated DTensors."""
    return MPO(replicate(mpo.Ws, mesh), replicate(mpo.vL, mesh),
               replicate(mpo.vR, mesh))


def _block(group, chi: int):
    size = C.group_size(group)
    if chi % size:
        raise ValueError(f"chi={chi} does not split over {size} ranks")
    cb = chi // size
    lo = C.group_rank(group) * cb
    return lo, lo + cb


def _dnormalize(A, group):
    """:func:`~tensornetwork_tpu_torch.models.dmrg._normalize` of a stack
    whose instances are split over the group's ranks."""
    sq = (torch.conj(A) * A).real.sum(dim=tuple(range(1, A.dim())))
    nrm = torch.sqrt(C.all_reduce(sq, group)).to(A.dtype)
    nrm = nrm.reshape((-1,) + (1,) * (A.dim() - 1))
    return A / torch.where(nrm > 0, nrm, 1.0)


def _update_left_rows(L, Q_blk, Q, W):
    """This rank's rows r of _update_left(L, Q, W): the first Q leg on
    the block Q_blk[a, t, r], its conjugate on the whole Q."""
    ws = _dmrg._ws(W)
    X = torch.einsum("Bawc,Batr->Bwctr", L, Q_blk)
    Y = torch.einsum(f"Bwctr,{ws}->Bcrvs", X, W)
    return torch.einsum("Bcrvs,Bcsp->Brvp", Y, torch.conj(Q))


def _update_right_partial(R_blk, Q_blk, Q, W):
    """This rank's partial of _update_right(R, Q, W): the sum over its
    rows b of R[b, v, d] and its block Q_blk[l, t, b]; summed over the
    ranks it is the whole new environment."""
    ws = _dmrg._ws(W)
    X = torch.einsum("Bbvd,Bltb->Bvdlt", R_blk, Q_blk)
    Y = torch.einsum(f"Bvdlt,{ws}->Bdlws", X, W)
    return torch.einsum("Bdlws,Bpsd->Blwp", Y, torch.conj(Q))


def _solve(Lenv, W, Renv_blk, x_blk, group, num_krylov_vecs: int,
           ritz_impl: str, reorth: bool):
    """Smallest Ritz pair of H_eff on a state split over its right bond:
    x_blk (B, chi, nt, cb), W the couplings (M, M, nt, nt), Renv_blk (B,
    cb, M, chi).  Each matvec is one K1 launch on the block contract and
    one reduce-scatter."""
    Lt = Lenv.permute(0, 2, 3, 1).contiguous()       # (B, w, c, a)
    Rt = Renv_blk.permute(0, 2, 1, 3).contiguous()   # (B, v, b, d)
    Wc = W.contiguous()

    def mv(x):
        y = kernels.heff_matvec(Lt, Wc, Rt, x.permute(0, 2, 1, 3).contiguous())
        return kernels.finalize_output(C.reduce_scatter(y, -1, group))

    evals, evecs = krylov.eigsh_lanczos(
        mv, x_blk, num_krylov_vecs=num_krylov_vecs, numeig=1,
        ritz_method=ritz_impl, reorthogonalize=reorth,
        reduce=functools.partial(C.all_reduce, group=group))
    return evals[:, 0], evecs[:, 0]


def _right_canonicalize(As, Ws, vR, group, qr_impl: str):
    """The prepass on local blocks As (B, N, chi, d, cb): right-canonical
    sites and the right environments (B, N, cb, M, chi)."""
    B, N, chi, d, _ = As.shape
    lo, hi = _block(group, chi)
    Renv = _dmrg._boundary_right(B, chi, vR)[:, lo:hi]
    Lm = torch.eye(chi, dtype=As.dtype, device=As.device).expand(B, -1, -1)
    Qs, Renvs = [None] * N, [None] * N
    for i in reversed(range(N)):
        A = _dmrg._normalize(torch.einsum(
            "Basb,Bbc->Basc", C.all_gather(As[:, i], -1, group), Lm))
        Renvs[i] = Renv
        Lm, Q = _dmrg._rq_shift_left(A, qr_impl)
        Qs[i] = Q[..., lo:hi]
        Renv = C.reduce_scatter(
            _update_right_partial(Renv, Qs[i], Q, _dmrg._site(Ws, i)), 1,
            group)
    Qs[0] = torch.einsum("Bab,Bbsc->Basc", Lm, Qs[0])
    return torch.stack(Qs, 1), torch.stack(Renvs, 1)


def tp_one_site_sweep(As, Ws, vL, vR, group, num_krylov_vecs: int = 10,
                      qr_impl: Optional[str] = None,
                      ritz_impl: Optional[str] = None, reorth: bool = True,
                      renvs=None) -> _dmrg.SweepResult:
    """One one-site sweep of a batch whose right bonds are split over the
    ranks of ``group``: As (B, N, chi, d, chi/P), this rank's blocks.
    Returns the :class:`~tensornetwork_tpu_torch.models.dmrg.SweepResult`
    of the local blocks (``renvs`` (B, N, chi/P, M, chi)).  The algorithm
    of :func:`~tensornetwork_tpu_torch.models.dmrg.one_site_sweep` with
    ``lanczos_impl="plain"``; ``qr_impl``/``ritz_impl`` default to its
    module defaults."""
    qr_impl = _dmrg.QR_IMPL if qr_impl is None else qr_impl
    ritz_impl = _dmrg.RITZ_IMPL if ritz_impl is None else ritz_impl
    B, N, chi, d, _ = As.shape
    lo, hi = _block(group, chi)
    solve = functools.partial(_solve, group=group,
                              num_krylov_vecs=num_krylov_vecs,
                              ritz_impl=ritz_impl, reorth=reorth)
    with highest_precision():
        Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
        if renvs is None:
            As, Renvs = _right_canonicalize(As, Ws, vR, group, qr_impl)
        else:
            Renvs = renvs
        Lenv = _dmrg._boundary_left(B, chi, vL)
        Rm = torch.eye(chi, dtype=As.dtype, device=As.device).expand(B, -1, -1)
        As1, Lenvs = [None] * N, [None] * N
        for i in range(N):
            W = _dmrg._site(Ws, i)
            A = _dnormalize(torch.einsum("Bab,Bbsc->Basc", Rm, As[:, i]),
                            group)
            _, A_opt = solve(Lenv, W, Renvs[:, i], A)
            Lenvs[i] = Lenv
            Q, Rm = _dmrg._qr_shift_right(C.all_gather(A_opt, -1, group),
                                          qr_impl)
            As1[i] = Q[..., lo:hi]
            Lenv = C.all_gather(_update_left_rows(Lenv, As1[i], Q, W), 1,
                                group)
        Renv = _dmrg._boundary_right(B, chi, vR)[:, lo:hi]
        Lm = Rm
        As2, Es, Renvs_out = [None] * N, [None] * N, [None] * N
        for i in reversed(range(N)):
            W = _dmrg._site(Ws, i)
            A = _dmrg._normalize(torch.einsum(
                "Basb,Bbc->Basc", C.all_gather(As1[i], -1, group), Lm))
            Es[i], A_opt = solve(Lenvs[i], W, Renv, A[..., lo:hi])
            Renvs_out[i] = Renv
            Lm, Q = _dmrg._rq_shift_left(C.all_gather(A_opt, -1, group),
                                         qr_impl)
            As2[i] = Q[..., lo:hi]
            Renv = C.reduce_scatter(
                _update_right_partial(Renv, As2[i], Q, W), 1, group)
        As2[0] = torch.einsum("Bab,Bbsc->Basc", Lm, As2[0])
        Es = torch.stack(Es, 1)
        return _dmrg.SweepResult(
            torch.stack(As2, 1), Es[:, 0], Es,
            torch.zeros((B,), dtype=Es.dtype, device=Es.device),
            torch.stack(Renvs_out, 1))


def tp_two_site_sweep(As, Ws, vL, vR, group, num_krylov_vecs: int = 10,
                      qr_impl: Optional[str] = None,
                      ritz_impl: Optional[str] = None, reorth: bool = True,
                      trunc_impl: Optional[str] = None,
                      trunc_iters: Optional[int] = None,
                      trunc_orth: Optional[str] = None,
                      trunc_polar_fast=None,
                      renvs=None) -> _dmrg.SweepResult:
    """One two-site sweep of a batch whose right bonds are split over the
    ranks of ``group`` (layout as :func:`tp_one_site_sweep`): the
    algorithm of :func:`~tensornetwork_tpu_torch.models.dmrg.
    two_site_sweep` with ``lanczos_impl="plain"``; each bond's two-site
    block is gathered for its truncation.  ``renvs`` (B, N-1, chi/P, M,
    chi) chains sweeps."""
    qr_impl = _dmrg.QR_IMPL if qr_impl is None else qr_impl
    ritz_impl = _dmrg.RITZ_IMPL if ritz_impl is None else ritz_impl
    trunc_impl = _dmrg.TRUNC_IMPL if trunc_impl is None else trunc_impl
    trunc_iters = _dmrg.TRUNC_ITERS if trunc_iters is None else trunc_iters
    trunc_orth = _dmrg.TRUNC_ORTH if trunc_orth is None else trunc_orth
    B, N, chi, d, cb = As.shape
    lo, hi = _block(group, chi)
    trunc = functools.partial(_dmrg._truncate, chi=chi, trunc_impl=trunc_impl,
                              trunc_iters=trunc_iters, trunc_orth=trunc_orth,
                              trunc_polar_fast=trunc_polar_fast)

    def solve(Lenv, W1, W2, Renv, theta):
        e, x = _solve(Lenv, kernels.fuse_mpo_pair(W1, W2), Renv,
                      theta.reshape(B, chi, d * d, cb), group,
                      num_krylov_vecs, ritz_impl, reorth)
        return e, x.reshape(theta.shape)

    def gather(x):
        return C.all_gather(x, -1, group)

    with highest_precision():
        Ws, vL, vR = (t.to(As.dtype) for t in (Ws, vL, vR))
        if renvs is None:
            As, Renvs = _right_canonicalize(As, Ws, vR, group, qr_impl)
            step_renvs = Renvs[:, 1:]
        else:
            step_renvs = renvs
        terr = torch.zeros((B,), dtype=As.dtype, device=As.device)
        Lenv = _dmrg._boundary_left(B, chi, vL)
        pending = gather(As[:, 0])
        As1, Lenvs = [None] * N, [None] * (N - 1)
        for i in range(N - 1):
            W1, W2 = _dmrg._site(Ws, i), _dmrg._site(Ws, i + 1)
            theta = _dnormalize(torch.einsum("Basb,Bbtc->Bastc", pending,
                                             As[:, i + 1]), group)
            _, th = solve(Lenv, W1, W2, step_renvs[:, i], theta)
            U, SV, tsq = trunc(gather(th).reshape(B, chi * d, d * chi),
                               pending.reshape(B, chi * d, chi))
            Lenvs[i] = Lenv
            U = U.reshape(B, chi, d, chi)
            As1[i] = U[..., lo:hi]
            Lenv = C.all_gather(_update_left_rows(Lenv, As1[i], U, W1), 1,
                                group)
            pending = SV.reshape(B, chi, d, chi)
            terr = terr + tsq
        As1[N - 1] = pending[..., lo:hi]

        Renv = _dmrg._boundary_right(B, chi, vR)[:, lo:hi]
        As2, Es, Renvs_out = [None] * N, [None] * (N - 1), [None] * (N - 1)
        pending = As1[N - 1]
        for i in reversed(range(N - 1)):
            W1, W2 = _dmrg._site(Ws, i), _dmrg._site(Ws, i + 1)
            theta = _dnormalize(torch.einsum(
                "Basb,Bbtc->Bastc", gather(As1[i]), pending), group)
            Es[i], th = solve(Lenvs[i], W1, W2, Renv, theta)
            q, rest, tsq = trunc(
                gather(th).reshape(B, chi * d, d * chi).mT,
                gather(pending).reshape(B, chi, d * chi).mT)
            Renvs_out[i] = Renv
            Q = q.mT.reshape(B, chi, d, chi)
            As2[i + 1] = Q[..., lo:hi]
            Renv = C.reduce_scatter(
                _update_right_partial(Renv, As2[i + 1], Q, W2), 1, group)
            pending = rest.mT.reshape(B, chi, d, chi)[..., lo:hi]
            terr = terr + tsq
        As2[0] = pending
        Es = torch.stack(Es, 1)
        return _dmrg.SweepResult(torch.stack(As2, 1), Es[:, 0], Es, terr,
                                 torch.stack(Renvs_out, 1))


class TPShardedDMRG:
    """One large-chi DMRG instance (or a batch) with the right bonds
    split over the mesh dimension ``axis``.

    ``As``: (N, chi, d, chi) or a batch (B, N, chi, d, chi), the whole
    state on every rank (rank 0's is distributed), or a DTensor in the
    layout of :func:`shard_mps_for_tp`.  With ``batch_axis`` a dimension
    of the mesh (a ``("data", "model")`` mesh), the batch is split over it
    too (dp x tp).  ``run_one_site``/``run_two_site`` mirror
    :class:`~tensornetwork_tpu_torch.models.dmrg.FiniteDMRG`, keep the
    state in the TP layout between sweeps, chain ``renvs``, and sync with
    the host once at the end unless ``tol`` is given.  ``self.As`` is the
    state as a DTensor (``self.As.to_local()``: this rank's block)."""

    def __init__(self, As, mpo: MPO, mesh, axis: str = "model",
                 num_krylov_vecs: int = 10, batch_axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.group = axis_group(mesh, axis)
        self.num_krylov_vecs = num_krylov_vecs
        self.batch_axis = (batch_axis if batch_axis in mesh.mesh_dim_names
                           and batch_axis != axis else None)
        if hasattr(As, "to_local"):
            self.As = As
        else:
            As = as_tensor(As, mesh.device_type)
            self.As = shard_mps_for_tp(As, mesh, axis, self.batch_axis)
        self._batched = self.As.dim() == 5
        self.mpo = replicate_mpo(mpo, mesh)
        self.energies = []

    def _ws(self):
        return tuple(local(t) for t in (self.mpo.Ws, self.mpo.vL,
                                        self.mpo.vR))

    def _run(self, sweep_fn, num_sweeps: int, tol: Optional[float], **kw):
        As = local(self.As)
        if not self._batched:
            As = As[None]
        spec = self.As.placements
        Ws, vL, vR = self._ws()
        renvs, pending, e_prev = None, [], None
        for _ in range(num_sweeps):
            res = sweep_fn(As, Ws, vL, vR, self.group,
                           num_krylov_vecs=self.num_krylov_vecs,
                           renvs=renvs, **kw)
            As, renvs = res.As, res.renvs
            pending.append(res.energy)
            if tol is not None:
                e = float(res.energy.mean())   # explicit opt-in sync
                if e_prev is not None and abs(e - e_prev) < tol:
                    break
                e_prev = e
        from torch.distributed.tensor import DTensor
        self.As = DTensor.from_local(As if self._batched else As[0],
                                     self.mesh, spec, run_check=False)
        energies = torch.stack(pending)           # (sweeps, B_local)
        if self.batch_axis is not None:
            energies = C.all_gather(energies, 1,
                                    axis_group(self.mesh, self.batch_axis))
        # ONE host sync for the whole chained run
        energies = energies.cpu().numpy()
        if self._batched:
            self.energies.extend(list(energies))
        else:
            self.energies.extend(float(e[0]) for e in energies)
        return self.energies[-1]

    def run_one_site(self, num_sweeps: int = 4, tol: Optional[float] = None,
                     **kw):
        """Chained one-site sweeps; returns the last energy (per instance,
        (B,), for a batch).  Extra kwargs (``qr_impl``/``ritz_impl``/
        ``reorth``) pass through to :func:`tp_one_site_sweep`."""
        return self._run(tp_one_site_sweep, num_sweeps, tol, **kw)

    def run_two_site(self, num_sweeps: int = 4, tol: Optional[float] = None,
                     **kw):
        """Chained two-site sweeps (truncation included); extra kwargs
        (``trunc_impl``/``trunc_orth``/...) pass through to
        :func:`tp_two_site_sweep`."""
        return self._run(tp_two_site_sweep, num_sweeps, tol, **kw)
