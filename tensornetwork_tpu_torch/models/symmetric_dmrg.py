"""U(1)-symmetric DMRG on block-sparse tensors.

Counterpart of :mod:`tensornetwork_tpu.models.symmetric_dmrg` (reference
``examples/dmrg/symmetric_dmrg.py:16-135`` and the symmetric backend's
Krylov solvers ``backends/symmetric/symmetric_backend.py:170-291``):
charge-conserving MPS/MPO, environment contractions through the sector
tensordot, and local ground-state solves by scipy's ARPACK Lanczos on the
host, acting on the flat block data, as in the JAX package.  Its matvec
copies the data to the tensors' device, contracts there, and copies the
result back.

Conventions (flows: False = charge counts +, True = dual):
  MPS tensor  A[l, s, r]    flows (False, False, True)
  MPO tensor  W[wl, wr, s, t] flows (False, True, False, True)
  Left env    L[l_ket, wl, l_bra] flows (True, True, False)
  Right env   R[r_ket, wr, r_bra] flows (False, False, True)
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse.linalg as spla
import torch

from tensornetwork_tpu_torch.blocksparse import (
    BaseCharge, BlockSparseTensor, Index, U1Charge, norm as bs_norm,
    qr as bs_qr, randn, tensordot)
from tensornetwork_tpu_torch.blocksparse.linalg import truncated_svd
from tensornetwork_tpu_torch.blocksparse.tensor import (
    _expand_indices, nonzero_dense_coords, torch_dtype)
from tensornetwork_tpu_torch.config import Device, default_device

ENGINES = ("numpy", "device")


def _trivial_index(flow: bool) -> Index:
    return Index(U1Charge(np.array([0])), flow)


def u1_xxz_mpo(Jz: float, Jxy: float, Bz: float, N: int,
               dtype=torch.float64, device: Optional[Device] = None
               ) -> List[BlockSparseTensor]:
    """U(1) XXZ MPO as charge-conserving block-sparse tensors (reference
    ``blocksparse_XXZ_mpo``, ``examples/dmrg/symmetric_dmrg.py:16-43``),
    built from the port's :func:`~tensornetwork_tpu_torch.models.mpo.FiniteXXZ`
    in float64 on the host, then cast to ``dtype`` on ``device`` (default:
    the card).

    Physical charge = n_down in {0, 1} (basis index 1 = down carries one
    unit); S+ maps index 1 -> 0, so its channel carries charge +1 and the
    S- channel -1: channel charges [0, +1, -1, 0, 0] for
    [idle-done, S+, S-, Sz, start].
    """
    from tensornetwork_tpu_torch.models.mpo import FiniteXXZ
    dense = FiniteXXZ(Jz, Jxy, Bz, N, dtype=torch.float64,
                      device="cpu").Ws.numpy()   # (N, 5, 5, 2, 2)
    dev = default_device(device)
    dtype = torch_dtype(dtype)
    phys = U1Charge(np.array([0, 1]))
    chan = U1Charge(np.array([0, 1, -1, 0, 0]))
    vL = np.zeros(5)
    vL[4] = 1.0
    vR = np.zeros(5)
    vR[0] = 1.0
    mpos = []
    for site in range(N):
        W = dense[site]
        if site == 0:
            W = np.tensordot(vL, W, [[0], [0]])[None, ...]  # (1,5,2,2)
            wl_idx = _trivial_index(False)
        else:
            wl_idx = Index(chan, False)
        if site == N - 1:
            W = np.tensordot(W, vR, [[1], [0]])[:, None, ...]
            wr_idx = _trivial_index(True)
        else:
            wr_idx = Index(chan, True)
        indices = [wl_idx, wr_idx, Index(phys, False), Index(phys, True)]
        W = torch.from_numpy(np.ascontiguousarray(W)).to(dtype).to(dev)
        mpos.append(BlockSparseTensor.fromdense(indices, W))
    return mpos


def half_filled_mps(N: int, chi: int, seed: int = 0,
                    n_total: Optional[int] = None, dtype=torch.float64,
                    device: Optional[Device] = None
                    ) -> List[BlockSparseTensor]:
    """Random U(1) MPS at fixed total particle number (default N//2),
    mirroring the reference construction (``symmetric_dmrg.py:46-74``):
    the JAX package's host draws from ``seed``, on ``device`` (default:
    the card)."""
    if n_total is None:
        n_total = N // 2
    rng = np.random.default_rng(seed)
    phys = U1Charge(np.array([0, 1]))
    # bond k (after site k-1) carries charges near the mean filling
    bond_charges: List[BaseCharge] = [U1Charge(np.array([0]))]
    for k in range(1, N):
        mean = int(round(n_total * k / N))
        # bond charge c is bounded by what the left block can hold (<= k)
        # and what the right block can still absorb (>= n_total - (N - k))
        lo = max(mean - 2, n_total - (N - k), 0)
        hi = min(mean + 2, k, n_total)
        vals = list(range(lo, hi + 1))
        if not vals:
            vals = [max(0, min(mean, n_total))]
        charges = rng.choice(vals, size=chi)
        bond_charges.append(U1Charge(np.sort(charges)))
    bond_charges.append(U1Charge(np.array([n_total])))
    tensors = []
    for site in range(N):
        indices = [Index(bond_charges[site], False),
                   Index(phys, False),
                   Index(bond_charges[site + 1], True)]
        t = randn(indices, dtype=dtype, seed=int(rng.integers(0, 2 ** 31)),
                  device=device)
        if t.data.shape[0] == 0:
            raise ValueError(
                f"bond charges at site {site} admit no states; retry with "
                f"a different seed or larger chi")
        tensors.append(t)
    return tensors


def _normalize_flows(t: BlockSparseTensor,
                     target: Sequence[bool]) -> BlockSparseTensor:
    """Re-express legs in the target flow convention.  A leg
    (charges c, flow f) equals (dual(c), not f), and the data layout only
    depends on the effective charges, so this is a metadata-only change."""
    charges = [c.copy() for c in t.flat_charges]
    flows = list(t.flat_flows)
    for i, tf in enumerate(target):
        if flows[i] != tf:
            charges[i] = charges[i].dual()
            flows[i] = tf
    return BlockSparseTensor(t.data, charges, flows,
                             [list(g) for g in t._order])


def _add_left(L, A, W, td=tensordot):
    """L' = L·A·W·conj(A)."""
    t = td(L, A, [[0], [0]])          # (wl, lb, s, r)
    t = td(t, W, [[0, 2], [0, 3]])    # (lb, r, wr, sout)
    t = td(t, A.conj(), [[0, 3], [0, 1]])  # (r, wr, rb)
    return t


def _add_right(R, A, W, td=tensordot):
    """R' = A·W·R·conj(A)."""
    t = td(A, R, [[2], [0]])          # (l, s, wr, rb)
    t = td(t, W, [[1, 2], [3, 1]])    # (l, rb, wl, sout)
    t = td(t, A.conj(), [[1, 3], [2, 1]])  # (l, wl, lb)
    return t


def _matvec_1s(L, W, R, x, td=tensordot):
    """y = L·W·R·x for x[l, s, r]."""
    t = td(L, x, [[0], [0]])          # (wl, lb, s, r)
    t = td(t, W, [[0, 2], [0, 3]])    # (lb, r, wr, sout)
    t = td(t, R, [[1, 2], [0, 1]])    # (lb, sout, rb)
    return t


def _boundary_left(dtype, device) -> BlockSparseTensor:
    idx = [_trivial_index(True), _trivial_index(True),
           _trivial_index(False)]
    return BlockSparseTensor(torch.ones(1, dtype=dtype, device=device),
                             *_expand_indices(idx))


def _boundary_right(last_bond: BaseCharge, dtype, device
                    ) -> BlockSparseTensor:
    """The rightmost MPS bond carries the conserved total charge, so the
    boundary environment leg must match it."""
    idx = [Index(last_bond, False), _trivial_index(False),
           Index(last_bond, True)]
    charges, flows, order = _expand_indices(idx)
    return BlockSparseTensor(
        torch.ones(last_bond.dim, dtype=dtype, device=device), charges,
        flows, order)


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


class SymmetricFiniteDMRG:
    """One-/two-site DMRG over block-sparse U(1) tensors."""

    def __init__(self, mps: List[BlockSparseTensor],
                 mpo: List[BlockSparseTensor], engine: str = "numpy"):
        """``engine="numpy"``: the per-sector loop
        (:func:`~tensornetwork_tpu_torch.blocksparse.tensor.tensordot`);
        ``engine="device"``: the bucketed executor
        (:func:`~tensornetwork_tpu_torch.blocksparse.torch_engine
        .tensordot_device`).
        Both run on the tensors' device; the names are the JAX package's."""
        if len(mps) != len(mpo):
            raise ValueError("MPS and MPO must have equal length")
        if engine == "device":
            from tensornetwork_tpu_torch.blocksparse.torch_engine import (
                tensordot_device)
            self._td = tensordot_device
        elif engine == "numpy":
            self._td = tensordot
        else:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{ENGINES}")
        self.engine = engine
        self.mps = list(mps)
        self.mpo = list(mpo)
        self.N = len(mps)
        self.energies: List[float] = []

    @property
    def _dtype(self) -> torch.dtype:
        return torch.promote_types(self.mps[0].dtype, self.mpo[0].dtype)

    @property
    def _device(self) -> torch.device:
        return self.mps[0].device

    def _boundaries(self):
        return (_boundary_left(self._dtype, self._device),
                _boundary_right(self.mps[-1].flat_charges[-1], self._dtype,
                                self._device))

    # -- canonicalization --------------------------------------------------
    def _shift_right(self, site: int):
        """QR at ``site``, absorb R into site+1."""
        A = self.mps[site]
        m = A.reshape([A.shape[0] * A.shape[1], A.shape[2]])
        q, r = bs_qr(m)
        self.mps[site] = q.reshape([A.shape[0], A.shape[1], q.shape[1]])
        self.mps[site + 1] = tensordot(r, self.mps[site + 1], [[1], [0]])

    def _shift_left(self, site: int):
        """RQ at ``site`` via qr of the transpose, absorb L into site-1."""
        A = self.mps[site]
        m = A.reshape([A.shape[0], A.shape[1] * A.shape[2]])
        q, r = bs_qr(m.transpose([1, 0]))
        qT = q.transpose([1, 0])
        rT = r.transpose([1, 0])
        self.mps[site] = _normalize_flows(
            qT.reshape([qT.shape[0], A.shape[1], A.shape[2]]),
            (False, False, True))
        self.mps[site - 1] = _normalize_flows(
            tensordot(self.mps[site - 1], rT, [[2], [0]]),
            (False, False, True))

    def right_canonicalize(self):
        for site in range(self.N - 1, 0, -1):
            self._shift_left(site)
        n = bs_norm(self.mps[0])
        if n > 0:
            self.mps[0] = self.mps[0] / n

    # -- local solver ------------------------------------------------------
    def _eigsh(self, mv, x0: BlockSparseTensor, num_krylov_vecs: int):
        """Lowest eigenpair by scipy's ARPACK Lanczos on the host, started
        from ``x0``'s data; ``mv`` maps a tensor of ``x0``'s structure to
        the product's data (reference symmetric backend strategy,
        ``symmetric_backend.py:291``)."""
        structure = (x0.flat_charges, x0.flat_flows,
                     [list(g) for g in x0._order])
        n = x0.data.shape[0]
        dev, dtype = x0.device, x0.dtype

        def host_mv(v):
            x = BlockSparseTensor(
                torch.from_numpy(np.asarray(v)).to(dtype).to(dev),
                *structure)
            return mv(x).cpu().numpy()

        if n == 1:
            e = float(host_mv(np.ones(1))[0])
            return e, x0 / bs_norm(x0)
        op = spla.LinearOperator((n, n), matvec=host_mv,
                                 dtype=_numpy_dtype(dtype))
        k = min(num_krylov_vecs, n - 1)
        evals, evecs = spla.eigsh(op, k=1, which="SA",
                                  v0=x0.data.cpu().numpy(),
                                  ncv=min(max(2 * k, 20), n))
        vec = BlockSparseTensor(
            torch.from_numpy(evecs[:, 0]).to(dtype).to(dev), *structure)
        return float(evals[0]), vec

    def _solve_local(self, L, W, R, x0, num_krylov_vecs=20):
        return self._eigsh(
            lambda x: _matvec_1s(L, W, R, x, self._td).data, x0,
            num_krylov_vecs)

    # -- sweeps ------------------------------------------------------------
    def run_one_site(self, num_sweeps: int = 4, num_krylov_vecs: int = 20,
                     tol: float = 1e-10, verbose: int = 0) -> float:
        self.right_canonicalize()
        L0, R0 = self._boundaries()
        Rs: List[BlockSparseTensor] = [None] * (self.N + 1)
        Rs[self.N] = R0
        for site in range(self.N - 1, 0, -1):
            Rs[site] = _add_right(Rs[site + 1], self.mps[site],
                                  self.mpo[site], self._td)
        e_prev = None
        e = np.inf
        for sweep in range(num_sweeps):
            Ls: List[BlockSparseTensor] = [None] * (self.N + 1)
            Ls[0] = L0
            # left-to-right
            for site in range(self.N):
                e, vec = self._solve_local(Ls[site], self.mpo[site],
                                           Rs[site + 1], self.mps[site],
                                           num_krylov_vecs)
                self.mps[site] = vec
                if site < self.N - 1:
                    self._shift_right(site)
                    Ls[site + 1] = _add_left(Ls[site], self.mps[site],
                                             self.mpo[site], self._td)
            # right-to-left
            Rs[self.N] = self._boundaries()[1]
            for site in range(self.N - 1, -1, -1):
                e, vec = self._solve_local(Ls[site], self.mpo[site],
                                           Rs[site + 1], self.mps[site],
                                           num_krylov_vecs)
                self.mps[site] = vec
                if site > 0:
                    self._shift_left(site)
                    Rs[site] = _add_right(Rs[site + 1], self.mps[site],
                                          self.mpo[site], self._td)
            self.energies.append(e)
            if verbose:
                print(f"sweep {sweep}: E = {e:.12f}")
            if e_prev is not None and abs(e - e_prev) < tol:
                break
            e_prev = e
        return e

    def run_two_site(self, max_bond_dim: int, num_sweeps: int = 4,
                     num_krylov_vecs: int = 20, tol: float = 1e-10,
                     verbose: int = 0) -> float:
        """Two-site sweeps with global cross-sector truncation."""
        self.right_canonicalize()
        L0, R0 = self._boundaries()
        Rs: List[BlockSparseTensor] = [None] * (self.N + 1)
        Rs[self.N] = R0
        for site in range(self.N - 1, 1, -1):
            Rs[site] = _add_right(Rs[site + 1], self.mps[site],
                                  self.mpo[site], self._td)
        e_prev = None
        e = np.inf
        for sweep in range(num_sweeps):
            Ls: List[BlockSparseTensor] = [None] * (self.N + 1)
            Ls[0] = L0
            for site in range(self.N - 1):
                e = self._two_site_update(site, Ls, Rs, max_bond_dim,
                                          num_krylov_vecs, "right")
                Ls[site + 1] = _add_left(Ls[site], self.mps[site],
                                         self.mpo[site], self._td)
            Rs[self.N] = self._boundaries()[1]
            for site in range(self.N - 2, -1, -1):
                e = self._two_site_update(site, Ls, Rs, max_bond_dim,
                                          num_krylov_vecs, "left")
                Rs[site + 1] = _add_right(Rs[site + 2], self.mps[site + 1],
                                          self.mpo[site + 1], self._td)
            self.energies.append(e)
            if verbose:
                print(f"sweep {sweep}: E = {e:.12f}")
            if e_prev is not None and abs(e - e_prev) < tol:
                break
            e_prev = e
        return e

    def _two_site_update(self, site, Ls, Rs, max_bond_dim,
                         num_krylov_vecs, direction) -> float:
        theta = tensordot(self.mps[site], self.mps[site + 1], [[2], [0]])
        W2 = tensordot(self.mpo[site], self.mpo[site + 1], [[1], [0]])
        # W2 legs: (wl, s1, t1, wr, s2, t2) -> reorder to
        # (wl, wr, s1, s2, t1, t2)
        W2 = W2.transpose([0, 3, 1, 4, 2, 5])
        L, R = Ls[site], Rs[site + 2]

        def mv(x):
            # the engine's tensordot (the JAX package's two-site matvec
            # takes the numpy loop whatever the engine)
            t = self._td(L, x, [[0], [0]])         # (wl, lb, s1, s2, r)
            t = self._td(t, W2, [[0, 2, 3], [0, 4, 5]])
            # -> (lb, r, wr, s1out, s2out)
            t = self._td(t, R, [[1, 2], [0, 1]])   # (lb, s1o, s2o, rb)
            return t.data

        n = theta.data.shape[0]
        if n <= 1:
            e = float(mv(theta / bs_norm(theta))[0]) if n else 0.0
            vec = theta
        else:
            e, vec = self._eigsh(mv, theta, num_krylov_vecs)
        d0, d1, d2, d3 = vec.shape
        m = vec.reshape([d0 * d1, d2 * d3])
        u, s, v, _ = truncated_svd(m, max_singular_values=max_bond_dim)
        s_arr = s.data / torch.linalg.vector_norm(s.data)
        # absorb singular values toward the sweep direction
        if direction == "right":
            # scale v rows by s: v's first leg enumerates the bond
            v_scaled = _scale_bond(v, s_arr, side="left")
            self.mps[site] = u.reshape([d0, d1, u.shape[1]])
            self.mps[site + 1] = v_scaled.reshape([v.shape[0], d2, d3])
        else:
            u_scaled = _scale_bond(u, s_arr, side="right")
            self.mps[site] = u_scaled.reshape([d0, d1, u.shape[1]])
            self.mps[site + 1] = v.reshape([v.shape[0], d2, d3])
        return e


def _scale_bond(t: BlockSparseTensor, s: torch.Tensor,
                side: str) -> BlockSparseTensor:
    """Multiply the bond leg (first leg if side='left', last if 'right')
    elementwise by the singular values ``s`` (indexed by dense bond
    position)."""
    coords = nonzero_dense_coords(t.flat_charges, t.flat_flows)
    # the bond is an elementary leg at the boundary by construction
    flat_axis = 0 if side == "left" else len(t.flat_charges) - 1
    pos = torch.from_numpy(coords[:, flat_axis]).to(s.device)
    return BlockSparseTensor(t.data * s[pos].to(t.dtype), t.flat_charges,
                             t.flat_flows, [list(g) for g in t._order])
