"""Finite matrix-product states on uniform stacked tensors.

Counterpart of :mod:`tensornetwork_tpu.models.mps`.  The site tensors are
one tensor ``(N, chi, d, chi)`` on one device.  The boundaries are
auxiliary legs: the object is the block state psi[a, s_0..s_{N-1}, b] =
(A_0[s_0] ... A_{N-1}[s_{N-1}])_ab, inner products and expectation values
sum over a and b, every boundary environment is the identity, and an
open-boundary MPS embeds by zero-padding its boundary tensors to ``chi``.
Truncating operations keep the static ``chi`` (the masked SVD, re-padded)
and report the truncated weight.

Where the JAX package scans over the sites, the methods here loop over
them in Python.  Every contraction of more than two tensors is written as
a chain of two-tensor einsums in a fixed order, so that the order (and with
it the rounding and the cost) is the same whether or not ``opt_einsum`` is
installed.  The Householder QR of the gauge moves goes through
:func:`~tensornetwork_tpu_torch.ops.decompositions.qr` (complex64 on the CPU
in complex128: the CPU LAPACK's complex64 QR returns NaN on some
rank-deficient panels of a product state).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device, as_tensor,
                                            default_device, highest_precision)
from tensornetwork_tpu_torch.ops import decompositions


def _norm_update_left(nL: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """nL'[r, p] = nL[a, c] A[a, t, r] conj(A)[c, t, p]."""
    X = torch.einsum("ac,atr->ctr", nL, A)
    return torch.einsum("ctr,ctp->rp", X, torch.conj(A))


def _norm_update_right(nR: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """nR'[l, p] = nR[b, d] A[l, t, b] conj(A)[p, t, d]."""
    X = torch.einsum("bd,ltb->dlt", nR, A)
    return torch.einsum("dlt,ptd->lp", X, torch.conj(A))


def _left_norm_envs(As: torch.Tensor) -> torch.Tensor:
    """(N, chi, chi): entry i is the norm environment of the sites < i (the
    identity at i = 0)."""
    env = torch.eye(As.shape[1], dtype=As.dtype, device=As.device)
    envs = []
    for A in As:
        envs.append(env)
        env = _norm_update_left(env, A)
    return torch.stack(envs)


def _right_norm_envs(As: torch.Tensor) -> torch.Tensor:
    """(N, chi, chi): entry i is the norm environment of the sites > i (the
    identity at i = N-1)."""
    env = torch.eye(As.shape[1], dtype=As.dtype, device=As.device)
    envs = [None] * As.shape[0]
    for i in reversed(range(As.shape[0])):
        envs[i] = env
        env = _norm_update_right(env, As[i])
    return torch.stack(envs)


def _sandwich(nL, A, op) -> torch.Tensor:
    """E[b, d] = nL[a, c] A[a, t, b] op[s, t] conj(A)[c, s, d]: a left
    environment carried over one site with ``op`` between ket and bra."""
    X = torch.einsum("ac,atb->ctb", nL, A)
    X = torch.einsum("ctb,st->csb", X, op)
    return torch.einsum("csb,csd->bd", X, torch.conj(A))


def _sandwich_right(nR, A, op) -> torch.Tensor:
    """E[a, c] = nR[b, d] A[a, t, b] op[s, t] conj(A)[c, s, d]."""
    X = torch.einsum("bd,atb->dat", nR, A)
    X = torch.einsum("dat,st->das", X, op)
    return torch.einsum("das,csd->ac", X, torch.conj(A))


def _close(E: torch.Tensor, nR: torch.Tensor) -> torch.Tensor:
    """sum_bd E[b, d] nR[b, d]."""
    return (E * nR).sum()


def _canon_step_left(A: torch.Tensor, Lm: Optional[torch.Tensor] = None,
                     normalize: bool = True):
    """Right-canonicalise A Lm (A when ``Lm`` is None): returns (lm, q,
    nrm) with A Lm = lm q, q right-isometric and nrm the Frobenius norm of
    lm, which is divided out of lm when ``normalize``."""
    chi, d, _ = A.shape
    if Lm is not None:
        A = torch.einsum("asb,bc->asc", A, Lm)
    qt, rt = decompositions.qr(A.reshape(chi, d * chi).mT, "householder")
    lm, q = rt.mT, qt.mT.reshape(chi, d, chi)
    nrm = torch.linalg.vector_norm(lm)
    if normalize:
        lm = lm / torch.where(nrm > 0, nrm, 1.0)
    return lm, q, nrm


def _right_canonicalize(As: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-canonicalise every site from the right end; the residual
    factor (a scalar times a unitary-like matrix) goes into site 0, so the
    state is unchanged up to its norm.  Returns the stack and the norm."""
    N, chi = As.shape[0], As.shape[1]
    lm = torch.eye(chi, dtype=As.dtype, device=As.device)
    norm = torch.ones((), dtype=As.real.dtype, device=As.device)
    Qs = [None] * N
    for i in reversed(range(N)):
        lm, Qs[i], nrm = _canon_step_left(As[i], lm)
        norm = norm * nrm
    Qs[0] = torch.einsum("ab,bsc->asc", lm, Qs[0])
    return torch.stack(Qs), norm


class FiniteMPS:
    """A finite MPS with uniform bond dimension and trace boundaries.

    ``tensors``: a stacked (N, chi, d, chi) tensor (it stays on its
    device; anything else goes to ``device`` or
    :func:`~tensornetwork_tpu_torch.config.default_device`), or a list of
    open-boundary site tensors of ragged bond dimensions, zero-padded to
    the largest.  ``canonicalize`` right-canonicalises with the center at
    site 0.  Counterpart of the JAX package's ``FiniteMPS``."""

    def __init__(self, tensors: Union[torch.Tensor, Sequence],
                 center_position: Optional[int] = None,
                 canonicalize: bool = True, device: Optional[Device] = None):
        if isinstance(tensors, (list, tuple)):
            tensors = self._pad_ragged(tensors, device)
        self.As = as_tensor(tensors, device)
        if self.As.dim() != 4:
            raise ValueError(
                f"expected stacked (N, chi, d, chi) tensors, got shape "
                f"{tuple(self.As.shape)}")
        self.center_position: Optional[int] = center_position
        if canonicalize:
            self.canonicalize()

    # -- construction -----------------------------------------------------

    @staticmethod
    def _pad_ragged(tensors: Sequence, device: Optional[Device]
                    ) -> torch.Tensor:
        """Embed a ragged open-boundary tensor list into a uniform stack."""
        tensors = [as_tensor(t, device) for t in tensors]
        chi = max(max(t.shape[0], t.shape[2]) for t in tensors)
        return torch.stack([torch.nn.functional.pad(
            t, (0, chi - t.shape[2], 0, 0, 0, chi - t.shape[0]))
            for t in tensors])

    @classmethod
    def random(cls, num_sites: int, bond_dim: int, phys_dim: int = 2,
               dtype: Optional[torch.dtype] = None, seed=0,
               canonicalize: bool = True,
               device: Optional[Device] = None) -> "FiniteMPS":
        """Random MPS: standard normal entries (real and imaginary parts
        for a complex dtype) over sqrt(chi d).  ``seed``: a
        ``torch.Generator`` on the target device, or an integer seed of a
        new one there.  The numbers differ from the JAX package's for the
        same seed."""
        dtype = DEFAULT_DTYPE if dtype is None else dtype
        if isinstance(seed, torch.Generator):
            gen = seed
            device = gen.device if device is None else device
        device = default_device(device)
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        shape = (num_sites, bond_dim, phys_dim, bond_dim)
        if dtype.is_complex:
            real = torch.empty((), dtype=dtype).real.dtype
            As = torch.complex(
                torch.randn(shape, generator=gen, dtype=real, device=device),
                torch.randn(shape, generator=gen, dtype=real, device=device))
        else:
            As = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return cls(As / float(np.sqrt(bond_dim * phys_dim)),
                   canonicalize=canonicalize)

    # -- basic properties -------------------------------------------------

    @property
    def num_sites(self) -> int:
        return self.As.shape[0]

    def __len__(self) -> int:
        return self.num_sites

    @property
    def bond_dim(self) -> int:
        return self.As.shape[1]

    @property
    def phys_dim(self) -> int:
        return self.As.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.As.dtype

    @property
    def device(self) -> torch.device:
        return self.As.device

    @property
    def tensors(self) -> List[torch.Tensor]:
        return list(self.As)

    @property
    def bond_dimensions(self) -> List[int]:
        return [self.bond_dim] * (self.num_sites + 1)

    @property
    def physical_dimensions(self) -> List[int]:
        return [self.phys_dim] * self.num_sites

    def to_stack(self) -> torch.Tensor:
        return self.As

    def from_stack(self, As: torch.Tensor) -> None:
        """Take ``As`` as the state; the center is then unknown."""
        self.As = As
        self.center_position = None

    def _op(self, op) -> torch.Tensor:
        return as_tensor(op, self.device, self.dtype)

    # -- canonicalization -------------------------------------------------

    @highest_precision()
    def canonicalize(self, normalize: bool = True) -> torch.Tensor:
        """Bring every site to right-canonical form with the center at 0;
        returns the norm, which stays in site 0 unless ``normalize``."""
        self.As, norm = _right_canonicalize(self.As)
        if not normalize:
            self.As = torch.cat([self.As[:1] * norm, self.As[1:]])
        self.center_position = 0
        return norm

    @highest_precision()
    def position(self, site: int, normalize: bool = True) -> torch.Tensor:
        """Move the orthogonality center to ``site`` by Householder QR
        steps (a site at a time); returns the product of the norms moved
        (divided out of the center when ``normalize``)."""
        if site < 0 or site >= self.num_sites:
            raise ValueError(
                f"site = {site} not between 0 and {self.num_sites - 1}")
        if self.center_position is None:
            self.canonicalize()
        norm = torch.ones((), dtype=self.As.real.dtype, device=self.device)
        As = list(self.As)
        chi, d = self.bond_dim, self.phys_dim
        while self.center_position < site:
            i = self.center_position
            q, r = decompositions.qr(As[i].reshape(chi * d, chi),
                                     "householder")
            nrm = torch.linalg.vector_norm(r)
            if normalize:
                r = r / torch.where(nrm > 0, nrm, 1.0)
            norm = norm * nrm
            As[i] = q.reshape(chi, d, chi)
            As[i + 1] = torch.einsum("ab,bsc->asc", r, As[i + 1])
            self.center_position = i + 1
        while self.center_position > site:
            i = self.center_position
            lm, As[i], nrm = _canon_step_left(As[i], normalize=normalize)
            norm = norm * nrm
            As[i - 1] = torch.einsum("asb,bc->asc", As[i - 1], lm)
            self.center_position = i - 1
        self.As = torch.stack(As)
        return norm

    @highest_precision()
    def check_orthonormality(self, which: str, site: int) -> torch.Tensor:
        """Frobenius norm of the deviation of ``site`` from left (``"l"``)
        or right (``"r"``) canonical form."""
        A = self.As[site]
        chi, d, _ = A.shape
        eye = torch.eye(chi, dtype=A.dtype, device=A.device)
        if which in ("l", "left"):
            m = A.reshape(chi * d, chi)
            dev = m.mH @ m - eye
        elif which in ("r", "right"):
            m = A.reshape(chi, d * chi)
            dev = m @ m.mH - eye
        else:
            raise ValueError(f"which = {which!r} must be 'l' or 'r'")
        return torch.linalg.vector_norm(dev)

    @highest_precision()
    def check_canonical(self) -> torch.Tensor:
        """Sum of the sites' deviations from canonical form about the
        center (left of it left-canonical, right of it right-canonical)."""
        if self.center_position is None:
            raise ValueError("MPS has no orthogonality center")
        total = torch.zeros((), dtype=self.As.real.dtype, device=self.device)
        for i in range(self.num_sites):
            if i < self.center_position:
                total = total + self.check_orthonormality("l", i)
            elif i > self.center_position:
                total = total + self.check_orthonormality("r", i)
        return total

    # -- linear algebra ---------------------------------------------------

    def _norm_sq(self, nLs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """<psi|psi> from the left norm environments."""
        if nLs is None:
            nLs = _left_norm_envs(self.As)
        return torch.trace(_norm_update_left(nLs[-1], self.As[-1]))

    @highest_precision()
    def norm(self) -> torch.Tensor:
        return torch.sqrt(torch.abs(self._norm_sq()))

    @highest_precision()
    def inner(self, other: "FiniteMPS") -> torch.Tensor:
        """<other|self>, the auxiliary boundary legs identified pairwise, in
        the wider of the two dtypes."""
        if self.bond_dim != other.bond_dim:
            raise ValueError("inner product requires equal bond dims")
        dtype = torch.promote_types(self.dtype, other.dtype)
        E = torch.eye(self.bond_dim, dtype=dtype, device=self.device)
        for A, B in zip(self.As.to(dtype), other.As.to(dtype)):
            X = torch.einsum("ac,atr->ctr", E, A)
            E = torch.einsum("ctr,ctp->rp", X, torch.conj(B))
        return torch.trace(E)

    # -- environments / transfer ------------------------------------------

    @highest_precision()
    def left_envs(self, sites: Sequence[int]) -> Dict[int, torch.Tensor]:
        """Left norm environments (of the sites < s) for the given sites."""
        envs = _left_norm_envs(self.As)
        return {int(s): envs[int(s)] for s in sites}

    @highest_precision()
    def right_envs(self, sites: Sequence[int]) -> Dict[int, torch.Tensor]:
        """Right norm environments (of the sites > s) for the given sites."""
        envs = _right_norm_envs(self.As)
        return {int(s): envs[int(s)] for s in sites}

    @highest_precision()
    def apply_transfer_operator(self, site: int, direction,
                                matrix: torch.Tensor) -> torch.Tensor:
        """``matrix`` carried over one site: rightward for ``direction`` in
        (1, 'l', 'left'), leftward for (-1, 'r', 'right')."""
        A = self.As[site]
        if direction in (1, "l", "left"):
            return _norm_update_left(matrix, A)
        if direction in (-1, "r", "right"):
            return _norm_update_right(matrix, A)
        raise ValueError(f"unknown direction {direction!r}")

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the state with ``torch.save`` as ``{"As": the stack on the
        CPU, "center_position": int or None}``.  The JAX package writes an
        orbax checkpoint: the two file formats differ."""
        torch.save({"As": self.As.detach().cpu(),
                    "center_position": self.center_position}, path)

    @classmethod
    def load(cls, path: str, device: Optional[Device] = None) -> "FiniteMPS":
        """Read a state written by :meth:`save` onto ``device`` (default
        :func:`~tensornetwork_tpu_torch.config.default_device`)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        return cls(state["As"].to(default_device(device)),
                   center_position=state["center_position"],
                   canonicalize=False)

    # -- measurements -----------------------------------------------------

    @highest_precision()
    def measure_local_operator(self, ops, sites) -> List[torch.Tensor]:
        """<O_i>/<psi|psi> for each (op, site) pair."""
        if len(ops) != len(sites):
            raise ValueError("measure_local_operator: len(ops) != len(sites)")
        nLs = _left_norm_envs(self.As)
        nRs = _right_norm_envs(self.As)
        den = self._norm_sq(nLs)
        out = []
        for op, site in zip(ops, sites):
            A = self.As[site]
            out.append(_close(_sandwich(nLs[site], A, self._op(op)),
                              nRs[site]) / den)
        return out

    @highest_precision()
    def measure_two_body_correlator(self, op1, op2, site1: int,
                                    sites2: Sequence[int]
                                    ) -> List[torch.Tensor]:
        """<op1_{site1} op2_j>/<psi|psi> for j in ``sites2`` (op1 @ op2 at
        j = site1)."""
        op1, op2 = self._op(op1), self._op(op2)
        N = self.num_sites
        nLs = _left_norm_envs(self.As)
        nRs = _right_norm_envs(self.As)
        den = self._norm_sq(nLs)
        A1 = self.As[site1]
        wanted = set(int(j) for j in sites2)
        results = {}
        if site1 in wanted:
            results[site1] = _close(_sandwich(nLs[site1], A1, op1 @ op2),
                                    nRs[site1]) / den
        # j > site1: the left environment with op1 inserted, carried right
        E = _sandwich(nLs[site1], A1, op1)
        for j in range(site1 + 1, N):
            A = self.As[j]
            if j in wanted:
                results[j] = _close(_sandwich(E, A, op2), nRs[j]) / den
            E = _norm_update_left(E, A)
        # j < site1: the right environment with op1 inserted, carried left
        E = _sandwich_right(nRs[site1], A1, op1)
        for j in range(site1 - 1, -1, -1):
            A = self.As[j]
            if j in wanted:
                results[j] = _close(_sandwich_right(E, A, op2),
                                    nLs[j]) / den
            E = _norm_update_right(E, A)
        return [results[int(j)] for j in sites2]

    # -- gates ------------------------------------------------------------

    @highest_precision()
    def apply_one_site_gate(self, gate, site: int) -> None:
        """A'[a, s, b] = gate[s, t] A[a, t, b] at ``site``."""
        A = torch.einsum("st,atb->asb", self._op(gate), self.As[site])
        self.As = torch.cat([self.As[:site], A[None], self.As[site + 1:]])

    @highest_precision()
    def apply_two_site_gate(self, gate, site1: int,
                            site2: Optional[int] = None,
                            max_singular_values: Optional[int] = None,
                            max_truncation_err: Optional[float] = None,
                            center_position: Optional[int] = None
                            ) -> torch.Tensor:
        """Apply a two-site gate (legs (o1, o2, i1, i2)) to the neighbours
        site1, site2 = site1 + 1 and split the result by the masked SVD
        (:func:`~tensornetwork_tpu_torch.ops.decompositions.svd_masked`),
        re-padded to the static ``chi``; the singular values go to
        ``center_position`` (default site2).  If the state has a center
        outside the window, it is moved in first.  Returns the truncated
        squared weight (a tensor)."""
        if site2 is None:
            site2 = site1 + 1
        if site2 != site1 + 1:
            raise ValueError("gate must act on neighboring sites")
        gate = self._op(gate)
        if self.center_position is not None:
            if self.center_position < site1:
                self.position(site1)
            elif self.center_position > site2:
                self.position(site2)
        chi, d = self.bond_dim, self.phys_dim
        T = torch.einsum("asb,btc->astc", self.As[site1], self.As[site2])
        theta = torch.einsum("astc,uvst->auvc", T, gate)
        res = decompositions.svd_masked(
            theta.reshape(chi * d, d * chi),
            max_singular_values=max_singular_values or chi,
            max_truncation_error=max_truncation_err)
        u, s, vh = res.u, res.s, res.vh
        k = s.shape[0]
        if k < chi:     # re-pad to the static chi
            u = torch.nn.functional.pad(u, (0, chi - k))
            s = torch.nn.functional.pad(s, (0, chi - k))
            vh = torch.nn.functional.pad(vh, (0, 0, 0, chi - k))
        s = s.to(u.dtype)
        if center_position is None:
            center_position = site2
        if center_position == site2:
            A1 = u.reshape(chi, d, chi)
            A2 = (s[:, None] * vh).reshape(chi, d, chi)
        else:
            A1 = (u * s[None, :]).reshape(chi, d, chi)
            A2 = vh.reshape(chi, d, chi)
        self.As = torch.cat([self.As[:site1], A1[None], A2[None],
                             self.As[site2 + 1:]])
        if self.center_position in (site1, site2):
            self.center_position = center_position
        return res.trunc_sq_norm

    # -- dense state (small systems) --------------------------------------

    @highest_precision()
    def to_dense(self) -> torch.Tensor:
        """The block state psi[a, s_0, ..., s_{N-1}, b] with its auxiliary
        boundary legs (small N only)."""
        acc = self.As[0]
        for A in self.As[1:]:
            acc = torch.tensordot(acc, A, dims=([acc.dim() - 1], [0]))
        return acc
