"""The configurations' Hamiltonians as dense MPOs and their exact ground
energies, each found in the file of the configuration's ``model``
(``reference/hamiltonians/<model>.py``, which holds the convention), and
the dense matrix and ground energy of a small MPO by diagonalisation."""
from __future__ import annotations

import itertools
from types import ModuleType
from typing import Optional

import numpy as np

from portbench.core import registry


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
    basis states with that many 1s (down spins, occupied sites)."""
    H = dense_hamiltonian(Ws, vL, vR)
    if sector is not None:
        N = Ws.shape[0]
        keep = [sum(1 << (N - 1 - i) for i in c)
                for c in itertools.combinations(range(N), sector)]
        H = H[np.ix_(keep, keep)]
    return float(np.linalg.eigvalsh(H)[0])


def hamiltonian(cfg: dict) -> ModuleType:
    """The file ``reference/hamiltonians/<model>.py`` of the configuration's
    ``model``, under the root it was loaded from."""
    return registry.hamiltonian(cfg["model"], cfg.get("root", registry.ROOT))


def mpo(cfg: dict, params: Optional[dict] = None, instance: int = 0):
    """The dense MPO of configuration ``cfg`` for one instance; ``params``
    holds per-instance couplings (arrays of length B) where the
    configuration draws them."""
    return hamiltonian(cfg).mpo(cfg, params or {}, instance)


def exact_energy(cfg: dict) -> Optional[float]:
    """The exact ground energy where the model's file gives a closed form."""
    fn = getattr(hamiltonian(cfg), "exact_energy", None)
    return None if fn is None else fn(cfg)
