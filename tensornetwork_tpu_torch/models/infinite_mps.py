"""Infinite (unit-cell) matrix-product states.

Counterpart of :mod:`tensornetwork_tpu.models.infinite_mps`.  The unit cell
is a stack ``(N, chi, d, chi)`` repeated infinitely.  The transfer map of
the cell acts on (ket, bra) bond matrices: the left fixed point l has
l T = eta l (a left environment carried right through the cell), the right
fixed point r has T r = eta r.  Its dominant eigenpairs come from the
implicitly restarted Arnoldi of :func:`~tensornetwork_tpu_torch.ops.
krylov.eigs`, whose eigenvectors are complex with an arbitrary phase: the
fixed points have that phase removed before they are made Hermitian.  The
square roots of a fixed point come from one set of its eigenpairs, in
float64.
Every contraction is a chain of two-tensor einsums in a fixed order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device, as_tensor,
                                            default_device, highest_precision)
from tensornetwork_tpu_torch.ops import krylov


def _carry_right(m: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """m'[c, d] = m[a, b] A[a, s, c] conj(A)[b, s, d]."""
    return torch.einsum("bsc,bsd->cd", torch.einsum("ab,asc->bsc", m, A),
                        torch.conj(A))


def _carry_left(m: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """m'[a, b] = m[c, d] A[a, s, c] conj(A)[b, s, d]."""
    return torch.einsum("das,bsd->ab", torch.einsum("cd,asc->das", m, A),
                        torch.conj(A))


def _with_op(m: torch.Tensor, A: torch.Tensor, op: torch.Tensor
             ) -> torch.Tensor:
    """m'[c, d] = m[a, b] A[a, s, c] op[t, s] conj(A)[b, t, d]."""
    X = torch.einsum("ab,asc->bsc", m, A)
    X = torch.einsum("bsc,ts->btc", X, op)
    return torch.einsum("btc,btd->cd", X, torch.conj(A))


class InfiniteMPS:
    """Unit-cell MPS ``(N, chi, d, chi)`` repeated infinitely.  A tensor
    stays on its device; a list of site tensors is stacked; anything else
    goes to ``device`` or :func:`~tensornetwork_tpu_torch.config.
    default_device`.  Counterpart of the JAX package's ``InfiniteMPS``."""

    def __init__(self, tensors, device: Optional[Device] = None):
        if isinstance(tensors, (list, tuple)):
            tensors = torch.stack([as_tensor(t, device) for t in tensors])
        self.As = as_tensor(tensors, device)
        if self.As.dim() != 4:
            raise ValueError("expected stacked (N, chi, d, chi) tensors")

    @classmethod
    def random(cls, num_sites: int, bond_dim: int, phys_dim: int = 2,
               dtype: Optional[torch.dtype] = None, seed=0,
               device: Optional[Device] = None) -> "InfiniteMPS":
        """Standard normal entries over sqrt(chi d).  ``seed``: a
        ``torch.Generator`` on the target device, or an integer seed of a
        new one there (other numbers than the JAX package's)."""
        dtype = DEFAULT_DTYPE if dtype is None else dtype
        if isinstance(seed, torch.Generator):
            gen = seed
            device = gen.device if device is None else device
        device = default_device(device)
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        As = torch.randn((num_sites, bond_dim, phys_dim, bond_dim),
                         generator=gen, dtype=dtype, device=device)
        return cls(As / float(np.sqrt(bond_dim * phys_dim)))

    @property
    def num_sites(self) -> int:
        return self.As.shape[0]

    @property
    def bond_dim(self) -> int:
        return self.As.shape[1]

    @property
    def phys_dim(self) -> int:
        return self.As.shape[2]

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.bond_dim, dtype=self.As.dtype,
                         device=self.As.device)

    # -- transfer maps -----------------------------------------------------

    def _propagate_right(self, m: torch.Tensor) -> torch.Tensor:
        """Left environment m -> m T (one unit cell to the right)."""
        for A in self.As:
            m = _carry_right(m, A)
        return m

    def _propagate_left(self, m: torch.Tensor) -> torch.Tensor:
        """Right environment m -> T m (one unit cell to the left)."""
        for i in reversed(range(self.num_sites)):
            m = _carry_left(m, self.As[i])
        return m

    @highest_precision()
    def transfer_matrix_eigs(self, direction: str = "left",
                             numeig: int = 1, num_krylov_vecs: int = 30,
                             maxiter: int = 5, tol: float = 1e-10
                             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Dominant eigenpair(s) of the cell's transfer matrix by
        :func:`~tensornetwork_tpu_torch.ops.krylov.eigs` ("iram") from the
        identity: ``direction='left'`` gives the left fixed point,
        ``'right'`` the right one.  Returns (evals, [eigenvectors])."""
        fn = (self._propagate_right if direction in ("left", "l")
              else self._propagate_left)
        return krylov.eigs(fn, self._eye(), num_krylov_vecs=num_krylov_vecs,
                           numeig=numeig, which="LM", maxiter=maxiter,
                           tol=tol)

    # -- canonicalization --------------------------------------------------

    @highest_precision()
    def canonicalize(self, num_krylov_vecs: int = 30
                     ) -> Tuple[float, torch.Tensor]:
        """Gauge the cell to right-canonical form (the right fixed point
        becomes the identity) at the cell boundary, A_0 <- r^-1/2 A_0,
        A_{N-1} <- A_{N-1} r^1/2, and scale every site by eta^(-1/(2N)).
        Returns (eta, the old right fixed point at unit trace)."""
        eta_arr, vr = self.transfer_matrix_eigs("right", 1, num_krylov_vecs)
        eta = float(eta_arr[0].real)
        r = _hermitize_psd(vr[0], self.As.dtype)
        r = r / torch.trace(r)
        Y, Yi = _psd_roots(r)
        N = self.num_sites
        first = torch.einsum("ab,bsc->asc", Yi, self.As[0])
        new = torch.cat([first[None], self.As[1:]])
        last = torch.einsum("asb,bc->asc", new[N - 1], Y)
        new = torch.cat([new[:N - 1], last[None]])
        self.As = new / eta ** (1.0 / (2.0 * N))
        return eta, r

    @highest_precision()
    def check_right_canonical(self) -> float:
        """|T 1 - 1| of the cell (0 when right-canonical)."""
        return float(torch.linalg.vector_norm(
            self._propagate_left(self._eye()) - self._eye()))

    def roll(self, num_sites: int) -> "InfiniteMPS":
        """The cell shifted cyclically by ``num_sites``."""
        return InfiniteMPS(torch.roll(self.As, -num_sites, dims=0))

    # -- measurements ------------------------------------------------------

    def _fixed_points(self) -> Tuple[torch.Tensor, torch.Tensor]:
        _, vl = self.transfer_matrix_eigs("left", 1)
        _, vr = self.transfer_matrix_eigs("right", 1)
        return (_hermitize_psd(vl[0], self.As.dtype),
                _hermitize_psd(vr[0], self.As.dtype))

    @highest_precision()
    def measure_local_operator(self, op, site: int = 0) -> torch.Tensor:
        """<O_site> in the thermodynamic limit, between the dominant left
        and right fixed points."""
        l, r = self._fixed_points()
        m = l
        for k in range(site):
            m = _carry_right(m, self.As[k])
        mr = r
        for k in range(self.num_sites - 1, site, -1):
            mr = _carry_left(mr, self.As[k])
        A = self.As[site]
        op = as_tensor(op, A.device, A.dtype)
        num = (_with_op(m, A, op) * mr).sum()
        den = (_carry_right(m, A) * mr).sum()
        return num / den

    @highest_precision()
    def measure_two_body_correlator(self, op1, op2, site1: int,
                                    sites2: Sequence[int]
                                    ) -> List[torch.Tensor]:
        """<op1_{site1} op2_j> in the thermodynamic limit for the absolute
        sites j >= site1 in ``sites2`` (op1 @ op2 at j = site1); sites
        beyond the cell repeat it.  Each is closed with the right fixed
        point and divided by the norm carried alongside.  As in the JAX
        package, the operators enter transposed (op[s, t] with s the ket
        leg, where :meth:`measure_local_operator` takes op[t, s]): the same
        for real symmetric operators such as X and Z, the transpose of
        op1 @ op2 at j = site1."""
        if len(sites2) == 0:
            return []
        l, r = self._fixed_points()
        op1 = as_tensor(op1, self.As.device, self.As.dtype).mT
        op2 = as_tensor(op2, self.As.device, self.As.dtype).mT
        N = self.num_sites
        wanted = set(int(j) for j in sites2)
        m = l
        for k in range(site1):
            m = _carry_right(m, self.As[k % N])
        results = {}
        A1 = self.As[site1 % N]
        if site1 in wanted:
            results[site1] = ((_with_op(m, A1, op2 @ op1) * r).sum()
                              / (_carry_right(m, A1) * r).sum())
        E = _with_op(m, A1, op1)
        n_env = _carry_right(m, A1)
        for pos in range(site1 + 1, max(wanted) + 1):
            A = self.As[pos % N]
            if pos in wanted:
                results[pos] = ((_with_op(E, A, op2) * r).sum()
                                / (_carry_right(n_env, A) * r).sum())
            E = _carry_right(E, A)
            n_env = _carry_right(n_env, A)
        return [results[int(j)] for j in sites2]


def _hermitize_psd(m: torch.Tensor, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """The Hermitian part of a fixed point after removing the
    eigensolver's global phase (the phase of its trace) -- in that order:
    made Hermitian first, a phase near +-i would collapse it.  Cast to the
    real ``dtype`` when one is given."""
    tr = torch.trace(m)
    mag = tr.abs()
    phase = torch.where(mag > 0, tr / torch.where(mag > 0, mag, 1.0),
                        torch.ones_like(tr))
    m = m * torch.conj(phase)
    m = 0.5 * (m + m.mH)
    if dtype is not None and not dtype.is_complex:
        m = m.real.to(dtype)
    return m


def _psd_roots(m: torch.Tensor, eps: float = 1e-12
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m^1/2, m^-1/2) of the small Hermitian fixed point ``m`` from one
    eigendecomposition, eigenvalues clamped at 0 and at ``eps``.  The
    eigenpairs are computed in float64 (complex128) whatever ``m``'s dtype
    and cast back: on an NVIDIA H100 80GB HBM3 at 700 W, cuSOLVER's float32
    eigenvectors of a chi=64 fixed point left the canonicalised float32
    cell 3.2e-4 from right-canonical, float64's 1.1e-5 (the float32 fixed
    point itself was within 5e-8)."""
    e, v = torch.linalg.eigh(m.to(torch.promote_types(m.dtype,
                                                      torch.float64)))
    e, v = e.to(m.real.dtype), v.to(m.dtype)
    sqrt = torch.sqrt(torch.clamp(e, min=0.0)).to(v.dtype)
    inv_sqrt = (1.0 / torch.sqrt(torch.clamp(e, min=eps))).to(v.dtype)
    return (v * sqrt[None, :]) @ v.mH, (v * inv_sqrt[None, :]) @ v.mH
