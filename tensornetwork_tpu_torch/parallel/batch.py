"""Batched one- and two-site DMRG over many independent instances.

Counterpart of the DMRG part of :mod:`tensornetwork_tpu.parallel.batch`.
The instances are a leading dimension of every tensor; in the local solve
that dimension is the fused-Lanczos kernel's grid (one block per
instance).  There is one route: the JAX package's paired/unpaired split
and its VMEM admission exist for the TPU only.
"""
from __future__ import annotations

from typing import Optional

import torch

from tensornetwork_tpu_torch.config import Device, as_tensor, highest_precision
from tensornetwork_tpu_torch.models import dmrg as _dmrg
from tensornetwork_tpu_torch.models.mpo import MPO


def batched_one_site_sweep(As_batch, Ws, vL, vR, num_krylov_vecs: int = 10,
                           qr_impl: str = "polar",
                           ritz_impl: str = "power",
                           reorth: bool = False,
                           lanczos_impl: str = "fused",
                           epilogue_impl: Optional[str] = None,
                           renvs=None) -> _dmrg.SweepResult:
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
    launch of the fused epilogue kernel, the batch on its grid."""
    if epilogue_impl is None:
        epilogue_impl = _dmrg.EPILOGUE_IMPL
    with highest_precision():
        return _dmrg._one_site_sweep_impl(
            As_batch, Ws, vL, vR, num_krylov_vecs, None, qr_impl, ritz_impl,
            reorth, lanczos_impl, epilogue_impl, renvs)


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
                           renvs=None) -> _dmrg.SweepResult:
    """One two-site sweep over a batch As_batch (B, N, chi, d, chi) with
    one MPO shared by the batch.  Returns a batched
    :class:`~tensornetwork_tpu_torch.models.dmrg.SweepResult` (energy (B,),
    energies (B, N-1), trunc_err (B,), renvs (B, N-1, chi, M, chi)).

    The defaults are the JAX package's batched accelerator ones: the
    matmul-only gauge, the power Ritz solve, no reorthogonalisation, the
    fused Lanczos (K2 at nt = d*d for the resident tier, the batch on its
    grid), and bond truncation by 2 warm-started subspace iterations with
    the Newton-Schulz polar orthonormaliser.  Pass ``trunc_impl="svd"``
    for the exact masked SVD."""
    with highest_precision():
        return _dmrg._two_site_sweep_impl(
            As_batch, Ws, vL, vR, num_krylov_vecs, None, qr_impl, ritz_impl,
            reorth, lanczos_impl, trunc_impl, trunc_iters, trunc_orth,
            trunc_polar_fast, renvs)


class BatchedDMRG:
    """Ground-state search over many instances at once on one device.
    Tensors stay on their device; anything else goes to
    :func:`~tensornetwork_tpu_torch.config.default_device`."""

    def __init__(self, As_batch, mpo: MPO, device: Optional[Device] = None):
        self.As = as_tensor(As_batch, device)
        self.mpo = mpo
        self.energies = None

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
            self.As, self.energies, renvs = res.As, res.energy, res.renvs
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
            self.As, self.energies, renvs = res.As, res.energy, res.renvs
        return self.energies
