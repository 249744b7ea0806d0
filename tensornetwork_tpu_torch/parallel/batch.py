"""Batched one- and two-site DMRG, and batched real-time TDVP, over many
independent instances.

Counterpart of the DMRG and TDVP part of
:mod:`tensornetwork_tpu.parallel.batch`.
The instances are a leading dimension of every tensor; in the local solve
that dimension is the fused-Lanczos kernel's grid (one block per
instance).  There is one route: the JAX package's paired/unpaired split
and its VMEM admission exist for the TPU only.  Its paired entry points
(:func:`batched_one_site_sweep_paired`, :func:`batched_two_site_sweep_paired`)
keep their names, defaults and the check that ``pair`` divides the batch,
and compute on that one route.
"""
from __future__ import annotations

from typing import Optional

import torch

from tensornetwork_tpu_torch.config import Device, as_tensor, highest_precision
from tensornetwork_tpu_torch.models import dmrg as _dmrg
from tensornetwork_tpu_torch.models import tdvp as _tdvp
from tensornetwork_tpu_torch.models.mpo import MPO
from tensornetwork_tpu_torch.parallel import collectives
from tensornetwork_tpu_torch.parallel import mesh as _mesh
from tensornetwork_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_spec, make_mesh)  # the JAX module's names


def batched_one_site_sweep(As_batch, Ws, vL, vR, num_krylov_vecs: int = 10,
                           qr_impl: str = "polar",
                           ritz_impl: str = "power",
                           reorth: bool = False,
                           lanczos_impl: str = "fused",
                           epilogue_impl: Optional[str] = None,
                           renvs=None,
                           matvec_prec: Optional[str] = None
                           ) -> _dmrg.SweepResult:
    """One one-site sweep over a batch As_batch (B, N, chi, d, chi) with
    one MPO shared by the batch.  Returns a batched
    :class:`~tensornetwork_tpu_torch.models.dmrg.SweepResult` (energy (B,),
    energies (B, N), renvs (B, N, chi, M, chi)).

    The batched defaults are the JAX package's: the matmul-only gauge
    (``qr_impl="polar"``), the power Ritz solve and no reorthogonalisation;
    pass ``qr_impl="householder", ritz_impl="eigh"`` for the
    single-instance choices.  ``epilogue_impl`` (default
    :data:`~tensornetwork_tpu_torch.models.dmrg.EPILOGUE_IMPL`, ``"xla"``):
    ``"fused"`` runs each site's polar gauge and environment growth as one
    launch of the fused epilogue kernel, the batch on its grid.
    ``matvec_prec`` is the JAX package's argument, accepted and ignored
    (see :data:`~tensornetwork_tpu_torch.models.dmrg.MATVEC_PRECISION`)."""
    if epilogue_impl is None:
        epilogue_impl = _dmrg.EPILOGUE_IMPL
    with highest_precision():
        return _dmrg._one_site_sweep_impl(
            As_batch, Ws, vL, vR, num_krylov_vecs, None, qr_impl, ritz_impl,
            reorth, lanczos_impl, epilogue_impl, renvs)


def _check_pair(B: int, pair: int) -> None:
    if B % pair:
        raise ValueError(f"batch {B} not divisible by pair={pair}")


def batched_one_site_sweep_paired(As_batch, Ws, vL, vR,
                                  num_krylov_vecs: int = 10,
                                  qr_impl: str = "polar",
                                  ritz_impl: str = "power",
                                  pair: int = 2,
                                  renvs=None) -> _dmrg.SweepResult:
    """The JAX package's paired one-site entry point: its defaults
    (``qr_impl="polar"``, ``ritz_impl="power"``, ``pair=2``), its
    semantics (the fused Lanczos, no reorthogonalisation, the plain site
    epilogue) and its ``ValueError`` when ``pair`` does not divide the
    batch.  ``pair`` packs that many instances into one TPU program; on
    the card every instance has its own block of K2's grid whatever
    ``pair`` is, so this is :func:`batched_one_site_sweep` with those
    settings."""
    _check_pair(As_batch.shape[0], pair)
    return batched_one_site_sweep(
        As_batch, Ws, vL, vR, num_krylov_vecs=num_krylov_vecs,
        qr_impl=qr_impl, ritz_impl=ritz_impl, reorth=False,
        lanczos_impl="fused", epilogue_impl="xla", renvs=renvs)


def batched_one_site_sweep_multi_mpo(As_batch, Ws_batch, vL, vR,
                                     num_krylov_vecs: int = 10,
                                     qr_impl: str = "polar",
                                     ritz_impl: str = "power",
                                     renvs=None) -> _dmrg.SweepResult:
    """As :func:`batched_one_site_sweep` with one MPO per instance
    (disorder realizations): ``Ws_batch`` (B, N, M, M, d, d).  The site
    epilogue is the plain one, as in the JAX package: the fused kernel
    takes one W shared by the batch."""
    with highest_precision():
        return _dmrg._one_site_sweep_impl(
            As_batch, Ws_batch, vL, vR, num_krylov_vecs, None, qr_impl,
            ritz_impl, False, "fused", "xla", renvs)


def batched_two_site_sweep(As_batch, Ws, vL, vR, num_krylov_vecs: int = 10,
                           qr_impl: str = "polar",
                           ritz_impl: str = "power",
                           reorth: bool = False,
                           lanczos_impl: str = "fused",
                           trunc_impl: str = "subspace",
                           trunc_iters: int = 2,
                           trunc_orth: str = "polar",
                           trunc_polar_fast=None,
                           renvs=None,
                           matvec_prec: Optional[str] = None
                           ) -> _dmrg.SweepResult:
    """One two-site sweep over a batch As_batch (B, N, chi, d, chi) with
    one MPO shared by the batch.  Returns a batched
    :class:`~tensornetwork_tpu_torch.models.dmrg.SweepResult` (energy (B,),
    energies (B, N-1), trunc_err (B,), renvs (B, N-1, chi, M, chi)).

    The defaults are the JAX package's batched accelerator ones: the
    matmul-only gauge, the power Ritz solve, no reorthogonalisation, the
    fused Lanczos (K2 at nt = d*d for the resident tier, the batch on its
    grid), and bond truncation by 2 warm-started subspace iterations with
    the Newton-Schulz polar orthonormaliser.  Pass ``trunc_impl="svd"``
    for the exact masked SVD.  ``matvec_prec`` as in
    :func:`batched_one_site_sweep`."""
    with highest_precision():
        return _dmrg._two_site_sweep_impl(
            As_batch, Ws, vL, vR, num_krylov_vecs, None, qr_impl, ritz_impl,
            reorth, lanczos_impl, trunc_impl, trunc_iters, trunc_orth,
            trunc_polar_fast, renvs)


def batched_two_site_sweep_paired(As_batch, Ws, vL, vR,
                                  num_krylov_vecs: int = 10,
                                  qr_impl: str = "polar",
                                  ritz_impl: str = "power",
                                  trunc_iters: int = 2,
                                  trunc_orth: str = "polar",
                                  pair: int = 2,
                                  renvs=None) -> _dmrg.SweepResult:
    """The JAX package's paired two-site entry point: its defaults
    (``qr_impl="polar"``, ``ritz_impl="power"``, ``trunc_iters=2``,
    ``trunc_orth="polar"``, ``pair=2``), its semantics (the fused Lanczos
    at nt = d*d, no reorthogonalisation, the subspace truncation only) and
    its ``ValueError`` when ``pair`` does not divide the batch.  As
    :func:`batched_one_site_sweep_paired`, ``pair`` has no meaning on the
    card: this is :func:`batched_two_site_sweep` with those settings."""
    _check_pair(As_batch.shape[0], pair)
    return batched_two_site_sweep(
        As_batch, Ws, vL, vR, num_krylov_vecs=num_krylov_vecs,
        qr_impl=qr_impl, ritz_impl=ritz_impl, reorth=False,
        lanczos_impl="fused", trunc_impl="subspace",
        trunc_iters=trunc_iters, trunc_orth=trunc_orth, renvs=renvs)


class BatchedDMRG:
    """Ground-state search over many instances at once.

    Without ``mesh``, on one device: tensors stay on their device,
    anything else goes to
    :func:`~tensornetwork_tpu_torch.config.default_device`.  With a mesh
    (:func:`~tensornetwork_tpu_torch.parallel.mesh.make_mesh`), the
    instances ride its ``batch_axis``: each rank sweeps its B/P instances
    (``As_batch`` is the whole batch, rank 0's distributed, or a DTensor
    sharded on its leading axis), the MPO is replicated, and the energies
    are gathered over ``batch_axis`` once, at the end of a run.  The
    sweeps themselves run no collective: instances do not interact."""

    def __init__(self, As_batch, mpo: MPO, mesh=None,
                 batch_axis: str = "data", device: Optional[Device] = None):
        self.mesh = mesh
        self.batch_axis = batch_axis
        if mesh is None:
            self.As = as_tensor(As_batch, device)
        else:
            if not hasattr(As_batch, "to_local"):
                As_batch = _mesh.shard_array(
                    as_tensor(As_batch, device or mesh.device_type), mesh,
                    batch_spec(mesh, batch_axis, As_batch.dim()))
                mpo = MPO(*(_mesh.local(_mesh.replicate(t, mesh))
                            for t in (mpo.Ws, mpo.vL, mpo.vR)))
            self.As = _mesh.local(As_batch)
        self.mpo = mpo
        self.energies = None

    def _gather(self, energies: torch.Tensor) -> torch.Tensor:
        """The (B,) energies of the whole batch: the local ones without a
        mesh, else one all_gather over ``batch_axis``."""
        if self.mesh is None:
            return energies
        return collectives.all_gather(
            energies, 0, _mesh.axis_group(self.mesh, self.batch_axis))

    def run_one_site(self, num_sweeps: int = 4,
                     num_krylov_vecs: int = 10,
                     epilogue_impl: Optional[str] = None) -> torch.Tensor:
        """Chained sweeps; returns the per-instance energies (B,).
        ``epilogue_impl`` as in :func:`batched_one_site_sweep`."""
        renvs = None
        for _ in range(num_sweeps):
            res = batched_one_site_sweep(
                self.As, self.mpo.Ws, self.mpo.vL, self.mpo.vR,
                num_krylov_vecs=num_krylov_vecs,
                epilogue_impl=epilogue_impl, renvs=renvs)
            self.As, renvs = res.As, res.renvs
        self.energies = self._gather(res.energy)
        return self.energies

    def run_two_site(self, num_sweeps: int = 4,
                     num_krylov_vecs: int = 10) -> torch.Tensor:
        """Chained two-site sweeps with the batched defaults; returns the
        per-instance energies (B,)."""
        renvs = None
        for _ in range(num_sweeps):
            res = batched_two_site_sweep(
                self.As, self.mpo.Ws, self.mpo.vL, self.mpo.vR,
                num_krylov_vecs=num_krylov_vecs, renvs=renvs)
            self.As, renvs = res.As, res.renvs
        self.energies = self._gather(res.energy)
        return self.energies


def batched_tdvp_one_site_sweep_sc(As_batch, Ws, vL, vR, dt,
                                   num_krylov_vecs: int = 10,
                                   lanczos_impl: Optional[str] = None
                                   ) -> torch.Tensor:
    """One real-time TDVP sweep of a batch of complex stacks As_batch (B,
    N, chi, d, chi) under one real MPO -- many quenches at once -- by the
    algorithm of :func:`~tensornetwork_tpu_torch.models.tdvp.
    tdvp_one_site_sweep_sc`.  ``dt``: a scalar or (B,) per-instance time
    steps.  Where the JAX package vmaps the single-instance sweep, this is
    one sweep over the batch axis: with ``"fused"`` (the default) every
    site step and every bond step is one K2 launch for all B instances,
    4N a sweep.  Returns the evolved batch."""
    with highest_precision():
        return _tdvp._one_site_sweep_sc(As_batch, Ws, vL, vR, dt,
                                        num_krylov_vecs, None, lanczos_impl)
