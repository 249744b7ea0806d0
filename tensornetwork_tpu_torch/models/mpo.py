"""Matrix-product operators as uniform stacks of tensors.

Counterpart of :mod:`tensornetwork_tpu.models.mpo`: every site tensor has
the shape ``(M, M, d, d)``, so the chain is one ``(N, M, M, d, d)``
tensor; the open boundaries are the vectors ``vL``/``vR``.  Index
convention ``W[wl, wr, s, t]``, ``s`` the bra and ``t`` the ket index.
The tensors are built in numpy (float64) and then moved to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.config import DEFAULT_DTYPE, Device, default_device


@dataclasses.dataclass
class MPO:
    """A finite MPO as a uniform stack.

    Attributes:
      Ws: (N, M, M, d, d) stacked site tensors.
      vL: (M,) left boundary vector.
      vR: (M,) right boundary vector.
    """
    Ws: torch.Tensor
    vL: torch.Tensor
    vR: torch.Tensor

    @property
    def num_sites(self) -> int:
        return self.Ws.shape[0]

    @property
    def bond_dim(self) -> int:
        return self.Ws.shape[1]

    @property
    def phys_dim(self) -> int:
        return self.Ws.shape[3]

    def roll(self, n: int) -> "MPO":
        """The sites shifted cyclically by ``n`` (site n comes first), as
        an MPO of this one's class."""
        return type(self)(torch.roll(self.Ws, -n, dims=0), self.vL, self.vR)


# Reference-compatible aliases (reference ``matrixproductstates/mpo.py:25,
# 77,105``): every MPO here is a uniform stack; finite and infinite differ
# only in how the solver uses them (InfiniteMPO adds roll()).
BaseMPO = MPO
FiniteMPO = MPO


class InfiniteMPO(MPO):
    """A unit-cell MPO: the same uniform stack, read as the repeating cell
    of an infinite chain (counterpart of
    ``tensornetwork_tpu.models.mpo.InfiniteMPO``); :meth:`roll` shifts the
    cell."""


def _paulis():
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.array([[1.0, 0.0], [0.0, -1.0]])
    return X, Z, np.eye(2)


def FiniteTFI(Jx: Union[float, Sequence[float]],
              Bz: Union[float, Sequence[float]],
              N: Optional[int] = None,
              dtype: Optional[torch.dtype] = None,
              device: Optional[Device] = None) -> MPO:
    """Transverse-field Ising MPO, H = sum_i Jx[i] X_i X_{i+1} + sum_i
    Bz[i] Z_i (counterpart of ``tensornetwork_tpu.models.mpo.FiniteTFI``).
    ``Jx`` has length N-1 and ``Bz`` length N (scalars broadcast given N).
    """
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    device = default_device(device)
    if N is None:
        Bz = np.asarray(Bz, dtype=np.float64)
        if Bz.ndim == 0:
            raise ValueError("pass N for scalar couplings")
        N = len(Bz)
    Jx = np.broadcast_to(np.asarray(Jx, np.float64), (N - 1,)).copy()
    Bz = np.broadcast_to(np.asarray(Bz, np.float64), (N,)).copy()
    X, Z, I = _paulis()
    M = 3
    Ws = np.zeros((N, M, M, 2, 2))
    # lower-triangular layout: vL selects row M-1, vR selects column 0
    Jpad = np.concatenate([Jx, [0.0]])
    for i in range(N):
        Ws[i, 0, 0] = I
        Ws[i, 1, 0] = X
        Ws[i, 2, 0] = Bz[i] * Z
        Ws[i, 2, 1] = Jpad[i] * X
        Ws[i, 2, 2] = I
    vL = np.zeros(M)
    vL[M - 1] = 1.0
    vR = np.zeros(M)
    vR[0] = 1.0
    return MPO(*(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (Ws, vL, vR)))


def _spin_half():
    Sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    Sm = np.array([[0.0, 0.0], [1.0, 0.0]])
    Sz = np.diag([0.5, -0.5])
    return Sp, Sm, Sz, np.eye(2)


def FiniteXXZ(Jz: Union[float, Sequence[float]],
              Jxy: Union[float, Sequence[float]],
              Bz: Union[float, Sequence[float]],
              N: Optional[int] = None,
              dtype: Optional[torch.dtype] = None,
              device: Optional[Device] = None) -> MPO:
    """Heisenberg XXZ MPO, H = sum_i Jz[i] Sz_i Sz_{i+1} + sum_i Jxy[i]/2
    (S+_i S-_{i+1} + S-_i S+_{i+1}) - sum_i Bz[i] Sz_i, spin-1/2 operators
    (Sz = diag(1/2, -1/2)), M = 5 (counterpart of
    ``tensornetwork_tpu.models.mpo.FiniteXXZ``).  ``Jz``, ``Jxy`` have
    length N-1 and ``Bz`` length N (scalars broadcast given N)."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    device = default_device(device)
    if N is None:
        Bz = np.asarray(Bz, dtype=np.float64)
        if Bz.ndim == 0:
            raise ValueError("pass N for scalar couplings")
        N = len(Bz)
    Jz = np.broadcast_to(np.asarray(Jz, np.float64), (N - 1,)).copy()
    Jxy = np.broadcast_to(np.asarray(Jxy, np.float64), (N - 1,)).copy()
    Bz = np.broadcast_to(np.asarray(Bz, np.float64), (N,)).copy()
    Sp, Sm, Sz, I = _spin_half()
    M = 5
    Ws = np.zeros((N, M, M, 2, 2))
    Jzp = np.concatenate([Jz, [0.0]])
    Jxyp = np.concatenate([Jxy, [0.0]])
    for i in range(N):
        Ws[i, 0, 0] = I
        Ws[i, 1, 0] = Sp
        Ws[i, 2, 0] = Sm
        Ws[i, 3, 0] = Sz
        Ws[i, 4, 0] = -Bz[i] * Sz
        Ws[i, 4, 1] = Jxyp[i] / 2.0 * Sm
        Ws[i, 4, 2] = Jxyp[i] / 2.0 * Sp
        Ws[i, 4, 3] = Jzp[i] * Sz
        Ws[i, 4, 4] = I
    vL = np.zeros(M)
    vL[M - 1] = 1.0
    vR = np.zeros(M)
    vR[0] = 1.0
    return MPO(*(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (Ws, vL, vR)))


def FiniteFreeFermion2D(t1: float, t2: float, mu: float, N1: int, N2: int,
                        dtype: Optional[torch.dtype] = None,
                        device: Optional[Device] = None) -> MPO:
    """Free fermions on an N1 x N2 cylinder, snake-ordered into a chain:
    H = -t1 sum_<ij>_row c+_i c_j - t2 sum_<ij>_col c+_i c_j + h.c. - mu
    sum n_i, with Jordan-Wigner strings along the snake (even rows run
    right, odd rows left).  A hopping of range r starts in a channel that
    counts the r sites to its end, so M = 2 + 2 max(r).  Counterpart of
    ``tensornetwork_tpu.models.mpo.FiniteFreeFermion2D``."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    device = default_device(device)
    N = N1 * N2
    d = 2
    # occupation basis |0>, |1>
    sp = np.array([[0.0, 0.0], [1.0, 0.0]])   # c-dagger at a site
    sm = sp.T.copy()                          # c at a site
    n = np.diag([0.0, 1.0])
    Zjw = np.diag([1.0, -1.0])
    I = np.eye(2)

    def site(x, y):
        return x * N2 + (y if x % 2 == 0 else N2 - 1 - y)

    bonds = []  # (i, j, amplitude) with i < j in chain order
    for x in range(N1):
        for y in range(N2):
            if y + 1 < N2:
                i, j = sorted((site(x, y), site(x, y + 1)))
                bonds.append((i, j, -t2))
            if x + 1 < N1:
                i, j = sorted((site(x, y), site(x + 1, y)))
                bonds.append((i, j, -t1))
    max_range = max(j - i for i, j, _ in bonds)
    # channel (string type, sites k to the end): a term amp (sp_i Z..Z sm_j
    # + sm_i Z..Z sp_j) starts at i, passes through Zjw and ends at j
    M = 2 + 2 * max_range
    DONE, IDLE = 0, M - 1

    def chan_a(k):  # started by sp
        return k

    def chan_b(k):  # started by sm
        return max_range + k

    Ws = np.zeros((N, M, M, d, d))
    for s in range(N):
        Ws[s, DONE, DONE] = I
        Ws[s, IDLE, IDLE] = I
        Ws[s, IDLE, DONE] = -mu * n
        for k in range(2, max_range + 1):
            Ws[s, chan_a(k), chan_a(k - 1)] = Zjw
            Ws[s, chan_b(k), chan_b(k - 1)] = Zjw
        Ws[s, chan_a(1), DONE] = sm
        Ws[s, chan_b(1), DONE] = sp
    for i, j, amp in bonds:
        Ws[i, IDLE, chan_a(j - i)] += amp * sp
        Ws[i, IDLE, chan_b(j - i)] += amp * sm
    vL = np.zeros(M)
    vL[IDLE] = 1.0
    vR = np.zeros(M)
    vR[DONE] = 1.0
    return MPO(*(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (Ws, vL, vR)))


def mpo_to_dense(mpo: MPO) -> np.ndarray:
    """The full (d^N, d^N) operator as a numpy array: the
    exact-diagonalisation oracle of the tests."""
    Ws = mpo.Ws.detach().cpu().numpy()
    vL = mpo.vL.detach().cpu().numpy()
    vR = mpo.vR.detach().cpu().numpy()
    N = Ws.shape[0]
    acc = np.tensordot(vL, Ws[0], axes=[[0], [0]])  # (M, d, d)
    for i in range(1, N):
        acc = np.einsum("mst,mkuv->ksutv", acc, Ws[i])
        k = acc.shape[0]
        acc = acc.reshape(k, acc.shape[1] * acc.shape[2],
                          acc.shape[3] * acc.shape[4])
    return np.tensordot(acc, vR, axes=[[0], [0]])
