"""Trotterized time evolution: TEBD on a :class:`FiniteMPS`, and the exact
evolution of a dense state.

Counterpart of :mod:`tensornetwork_tpu.models.tebd`.  The MPS sweep applies
the two-site gate to every bond with the orthogonality center and the
masked-SVD truncation of
:meth:`~tensornetwork_tpu_torch.models.mps.FiniteMPS.apply_two_site_gate`;
its truncated weight is summed on the device and read once a sweep.  The
dense state is an N-axis tensor; a gate is one ``tensordot`` and a
``movedim``.  Gates have legs (o1, o2, i1, i2).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (Device, as_tensor,
                                            highest_precision)
from tensornetwork_tpu_torch.models.mps import (FiniteMPS, _left_norm_envs,
                                                _norm_update_left,
                                                _right_norm_envs)


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.complex64)


@highest_precision()
def trotter_gate(h2, dt: float, imaginary: bool = False,
                 device: Optional[Device] = None) -> torch.Tensor:
    """Two-site Trotter gate exp(-i dt h) (exp(-dt h) in imaginary time)
    by ``torch.linalg.matrix_exp``.  ``h2``: (d^2, d^2) or (d, d, d, d);
    returns (o1, o2, i1, i2), complex in real time.  A tensor stays on its
    device; anything else goes to ``device``."""
    h2 = as_tensor(h2, device)
    if h2.dim() == 4:
        d = h2.shape[0]
        h_mat = h2.reshape(d * d, d * d)
    else:
        h_mat = h2
        d = int(np.sqrt(h_mat.shape[0]))
    if imaginary:
        gate = torch.linalg.matrix_exp(-dt * h_mat)
    else:
        gate = torch.linalg.matrix_exp(-1j * dt * h_mat.to(
            _complex_of(h_mat.dtype)))
    return gate.reshape(d, d, d, d)


def _tebd_sweep(mps: FiniteMPS, gate, max_singular_values,
                max_truncation_err) -> torch.Tensor:
    N = mps.num_sites
    mps.position(0)
    total = torch.zeros((), dtype=mps.As.real.dtype, device=mps.device)
    for b in range(N - 1):
        total = total + mps.apply_two_site_gate(
            gate, b, b + 1, max_singular_values=max_singular_values,
            max_truncation_err=max_truncation_err, center_position=b + 1)
    mps.position(0)
    return total


@highest_precision()
def tebd_sweep(mps: FiniteMPS, gate,
               max_singular_values: Optional[int] = None,
               max_truncation_err: Optional[float] = None) -> float:
    """Apply ``gate`` to every bond, left to right with the orthogonality
    center, then move the center back to 0.  Returns the summed truncated
    squared weight (one device-to-host read a sweep)."""
    return float(_tebd_sweep(mps, gate, max_singular_values,
                             max_truncation_err))


@highest_precision()
def evolve_mps(mps: FiniteMPS, h2, dt: float, num_steps: int,
               imaginary: bool = False,
               max_singular_values: Optional[int] = None,
               normalize: bool = True) -> Tuple[List[float], float]:
    """TEBD evolution of ``mps`` in place under a uniform two-site
    hamiltonian ``h2``: ``num_steps`` sweeps of :func:`tebd_sweep`, each
    followed (with ``normalize``) by dividing site 0 by the norm.  A real
    state becomes complex for a real-time (complex) gate.  Returns (the
    energy after each step in imaginary time, else [], the total truncated
    weight)."""
    gate = trotter_gate(h2, dt, imaginary=imaginary, device=mps.device)
    if gate.is_complex() and not mps.As.is_complex():
        mps.As = mps.As.to(_complex_of(mps.As.dtype))
    energies: List[float] = []
    total = torch.zeros((), dtype=mps.As.real.dtype, device=mps.device)
    for _ in range(num_steps):
        total = total + _tebd_sweep(mps, gate, max_singular_values, None)
        if normalize:
            nrm = mps.norm()
            mps.As = torch.cat([mps.As[:1] / torch.where(nrm > 0, nrm, 1.0),
                                mps.As[1:]])
        if imaginary:
            energies.append(measure_energy(mps, h2))
    return energies, float(total)


@highest_precision()
def measure_energy(mps: FiniteMPS, h2) -> float:
    """<H>/<psi|psi> of H = the two-site term ``h2`` on every bond."""
    h2 = as_tensor(h2, mps.device, mps.dtype)
    if h2.dim() == 2:
        d = mps.phys_dim
        h2 = h2.reshape(d, d, d, d)
    As = mps.As
    nLs = _left_norm_envs(As)
    nRs = _right_norm_envs(As)
    den = torch.trace(_norm_update_left(nLs[-1], As[-1]))
    total = torch.zeros((), dtype=As.dtype, device=As.device)
    for b in range(mps.num_sites - 1):
        A1, A2 = As[b], As[b + 1]
        X = torch.einsum("ac,asb->csb", nLs[b], A1)
        X = torch.einsum("csb,btq->cstq", X, A2)
        X = torch.einsum("cstq,uvst->cuvq", X, h2)
        X = torch.einsum("cuvq,cue->vqe", X, torch.conj(A1))
        X = torch.einsum("vqe,evr->qr", X, torch.conj(A2))
        total = total + (X * nRs[b + 1]).sum() / den
    return float(total.real)


# Exact evolution of a dense state psi[(d,) * N]
# ---------------------------------------------------------------------------


@highest_precision()
def apply_two_site_gate_exact(psi: torch.Tensor, gate: torch.Tensor,
                              site: int) -> torch.Tensor:
    """``gate`` applied to axes (site, site+1) of the dense state."""
    N = psi.dim()
    out = torch.tensordot(psi, gate, dims=([site, site + 1], [2, 3]))
    return torch.movedim(out, (N - 2, N - 1), (site, site + 1))


@highest_precision()
def evolve_exact(psi, h2, dt: float, num_steps: int,
                 imaginary: bool = False,
                 device: Optional[Device] = None) -> torch.Tensor:
    """``num_steps`` even/odd Trotter steps of the dense state, each
    normalised, in the wider of the state's and the gate's dtypes (so a
    real state becomes complex in real time).  A tensor stays
    on its device; anything else goes to ``device``."""
    psi = as_tensor(psi, device)
    gate = trotter_gate(h2, dt, imaginary=imaginary, device=psi.device)
    dtype = torch.promote_types(psi.dtype, gate.dtype)
    psi, gate = psi.to(dtype), gate.to(dtype)
    N = psi.dim()
    for _ in range(num_steps):
        for b in range(0, N - 1, 2):
            psi = apply_two_site_gate_exact(psi, gate, b)
        for b in range(1, N - 1, 2):
            psi = apply_two_site_gate_exact(psi, gate, b)
        psi = psi / torch.linalg.vector_norm(psi)
    return psi


@highest_precision()
def inner_exact(psi1: torch.Tensor, psi2: torch.Tensor) -> torch.Tensor:
    """<psi1|psi2> of two dense states."""
    return torch.vdot(psi1.reshape(-1), psi2.reshape(-1))
