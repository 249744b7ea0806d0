"""The transverse-field Ising chain, H = sum_i Jx X_i X_{i+1} + sum_i Bz Z_i,
open, Z = diag(1, -1); its exact ground energy by Jordan-Wigner free
fermions.  Configuration keys: ``N``, ``Jx``, ``Bz``."""
from __future__ import annotations

import numpy as np

X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.array([[1.0, 0.0], [0.0, -1.0]])
I2 = np.eye(2)


def tfi_mpo(N: int, Jx: float, Bz: float):
    """H = sum_i Jx X_i X_{i+1} + sum_i Bz Z_i, open: (Ws (N, 3, 3, 2, 2),
    vL, vR), float64."""
    W = np.zeros((3, 3, 2, 2))
    W[0, 0] = I2
    W[1, 0] = X
    W[2, 0] = Bz * Z
    W[2, 1] = Jx * X
    W[2, 2] = I2
    return np.repeat(W[None], N, 0), np.eye(3)[2], np.eye(3)[0]


def tfi_exact_energy(N: int, Jx: float, Bz: float) -> float:
    """Ground energy of the open chain by Jordan-Wigner free fermions:
    minus the sum of the singular values of the bidiagonal matrix with Bz
    on its diagonal and Jx above it."""
    m = np.diag(np.full(N, float(Bz))) + np.diag(np.full(N - 1, float(Jx)),
                                                 1)
    return -float(np.linalg.svd(m, compute_uv=False).sum())


def mpo(cfg: dict, params: dict, instance: int):
    return tfi_mpo(cfg["N"], cfg["Jx"], cfg["Bz"])


def exact_energy(cfg: dict) -> float:
    return tfi_exact_energy(cfg["N"], cfg["Jx"], cfg["Bz"])
