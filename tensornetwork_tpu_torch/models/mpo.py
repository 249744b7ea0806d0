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
