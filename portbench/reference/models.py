"""The configurations' Hamiltonians as dense MPOs, written from their
equations, and their exact ground energies where a closed form or a
small diagonalisation gives one.

MPO convention: W[w, v, s, t] = <s| O |t> on the left (w) and right (v)
MPO bonds; vL picks the left boundary's row, vR the right one's column.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

X = np.array([[0.0, 1.0], [1.0, 0.0]])
Z = np.array([[1.0, 0.0], [0.0, -1.0]])
I2 = np.eye(2)
SP = np.array([[0.0, 1.0], [0.0, 0.0]])   # S+ : index 1 (down) -> 0 (up)
SM = SP.T
SZ = 0.5 * Z


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


def tfi_exact_energy(N: int, Jx: float, Bz: float) -> float:
    """Ground energy of the open chain by Jordan-Wigner free fermions:
    minus the sum of the singular values of the bidiagonal matrix with Bz
    on its diagonal and Jx above it."""
    m = np.diag(np.full(N, float(Bz))) + np.diag(np.full(N - 1, float(Jx)),
                                                 1)
    return -float(np.linalg.svd(m, compute_uv=False).sum())


def dense_hamiltonian(Ws, vL, vR) -> np.ndarray:
    """The 2^N x 2^N matrix of an MPO (small N only)."""
    N = Ws.shape[0]
    cur = np.einsum("w,wvst->vst", vL, Ws[0])
    for i in range(1, N):
        cur = np.einsum("vab,vust->uasbt", cur, Ws[i])
        m = cur.shape[0]
        dim = cur.shape[1] * cur.shape[2]
        cur = cur.reshape(m, dim, dim)
    return np.einsum("vab,v->ab", cur, vR)


def ground_energy(Ws, vL, vR, sector: Optional[int] = None) -> float:
    """Lowest eigenvalue by dense diagonalisation; ``sector``: only the
    basis states with that many 1s (down spins)."""
    H = dense_hamiltonian(Ws, vL, vR)
    if sector is not None:
        N = Ws.shape[0]
        keep = [sum(1 << (N - 1 - i) for i in c)
                for c in itertools.combinations(range(N), sector)]
        H = H[np.ix_(keep, keep)]
    return float(np.linalg.eigvalsh(H)[0])


def mpo(cfg: dict, params: Optional[dict] = None, instance: int = 0):
    """The dense MPO of configuration ``cfg`` for one instance; ``params``
    holds per-instance couplings (arrays of length B) where the
    configuration draws them."""
    params = params or {}
    if cfg["model"] == "tfi":
        return tfi_mpo(cfg["N"], cfg["Jx"], cfg["Bz"])
    if cfg["model"] == "xxz":
        jz = params["Jz"][instance] if "Jz" in params else cfg["Jz"]
        return xxz_mpo(cfg["N"], float(jz), cfg["Jxy"], cfg["Bz"])
    raise ValueError(f"no reference Hamiltonian for {cfg['model']!r}")


def exact_energy(cfg: dict) -> Optional[float]:
    """The exact ground energy where a closed form gives it."""
    if cfg["model"] == "tfi":
        return tfi_exact_energy(cfg["N"], cfg["Jx"], cfg["Bz"])
    return None
