"""The spin-1/2 XXZ chain, H = sum_i Jz Sz_i Sz_{i+1} + Jxy/2 (S+_i S-_{i+1}
+ S-_i S+_{i+1}) - Bz sum_i Sz_i, open.  Configuration keys: ``N``, ``Jz``
(or a realization's own ``Jz`` in ``params``), ``Jxy``, ``Bz``.  No closed
form: the output check takes its ground energies from the workload's
``reference`` sweep."""
from __future__ import annotations

import numpy as np

I2 = np.eye(2)
SP = np.array([[0.0, 1.0], [0.0, 0.0]])   # S+ : index 1 (down) -> 0 (up)
SM = SP.T
SZ = 0.5 * np.array([[1.0, 0.0], [0.0, -1.0]])


def xxz_mpo(N: int, Jz: float, Jxy: float, Bz: float):
    """H = sum_i Jz Sz_i Sz_{i+1} + Jxy/2 (S+_i S-_{i+1} + S-_i S+_{i+1})
    - Bz sum_i Sz_i, open: (Ws (N, 5, 5, 2, 2), vL, vR), float64."""
    W = np.zeros((5, 5, 2, 2))
    W[0, 0] = I2
    W[1, 0] = SP
    W[2, 0] = SM
    W[3, 0] = SZ
    W[4, 0] = -Bz * SZ
    W[4, 1] = 0.5 * Jxy * SM
    W[4, 2] = 0.5 * Jxy * SP
    W[4, 3] = Jz * SZ
    W[4, 4] = I2
    return np.repeat(W[None], N, 0), np.eye(5)[4], np.eye(5)[0]


def mpo(cfg: dict, params: dict, instance: int):
    jz = params["Jz"][instance] if "Jz" in params else cfg["Jz"]
    return xxz_mpo(cfg["N"], float(jz), cfg["Jxy"], cfg["Bz"])
