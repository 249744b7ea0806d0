"""Spinless free fermions on an N1 x N2 strip, open in both directions:

    H = -t1 sum_<ij>_x (c+_i c_j + h.c.) - t2 sum_<ij>_y (c+_i c_j + h.c.)
        - mu sum_i n_i,

with sites (x, y), x < N1, y < N2: t1 couples (x, y) and (x + 1, y), t2
couples (x, y) and (x, y + 1).  The chain runs along y in a snake (even x
up, odd x down), so site (x, y) is x N2 + y or x N2 + N2 - 1 - y, and a
hopping i < j carries the Jordan-Wigner string Z_{i+1} ... Z_{j-1}:
c+_i c_j = a+_i Z..Z a_j in the occupation basis |0>, |1>, Z = diag(1, -1).
Its exact ground energy is the sum of the negative single-particle
energies, taken from the open rectangle's standing waves, which need no
site order and no list of bonds.  Configuration keys: ``N1``, ``N2``, ``N`` (=
N1 N2), ``t1``, ``t2``, ``mu``.

MPO layout: channel 0 has placed nothing, channel M - 1 has closed its
term; channel 1 + 2 (k - 1) + a carries a hopping opened k sites before
its end, by c+ (a = 0) or by c (a = 1), through Z at each site passed.  R
is the longest hopping along the chain (2 N2 - 1 where N1 > 1), so M =
2 + 2 R.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

CDAG = np.array([[0.0, 0.0], [1.0, 0.0]])   # a+ : |0> -> |1>
C = CDAG.T                                  # a  : |1> -> |0>
NUM = np.diag([0.0, 1.0])
ZJW = np.diag([1.0, -1.0])
I2 = np.eye(2)


def _site(x: int, y: int, N2: int) -> int:
    return x * N2 + (y if x % 2 == 0 else N2 - 1 - y)


def hoppings(N1: int, N2: int, t1: float, t2: float
             ) -> List[Tuple[int, int, float]]:
    """(i, j, amplitude) of every nearest-neighbour pair, i < j along the
    snake."""
    out = []
    for x in range(N1):
        for y in range(N2):
            if x + 1 < N1:
                i, j = sorted((_site(x, y, N2), _site(x + 1, y, N2)))
                out.append((i, j, -float(t1)))
            if y + 1 < N2:
                i, j = sorted((_site(x, y, N2), _site(x, y + 1, N2)))
                out.append((i, j, -float(t2)))
    return out


def ff2d_mpo(N1: int, N2: int, t1: float, t2: float, mu: float):
    """(Ws (N, M, M, 2, 2), vL, vR), float64, M = 2 + 2 R."""
    N = N1 * N2
    hops = hoppings(N1, N2, t1, t2)
    R = max((j - i for i, j, _ in hops), default=1)
    M = 2 + 2 * R
    start, done = 0, M - 1

    def chan(k: int, a: int) -> int:
        return 1 + 2 * (k - 1) + a

    W = np.zeros((M, M, 2, 2))
    W[start, start] = I2
    W[done, done] = I2
    W[start, done] = -float(mu) * NUM
    for a, close in ((0, C), (1, CDAG)):
        W[chan(1, a), done] = close
        for k in range(2, R + 1):
            W[chan(k, a), chan(k - 1, a)] = ZJW
    Ws = np.repeat(W[None], N, 0)
    for i, j, amp in hops:
        Ws[i, start, chan(j - i, 0)] += amp * CDAG
        Ws[i, start, chan(j - i, 1)] += amp * C
    return Ws, np.eye(M)[start], np.eye(M)[done]


def band(N1: int, N2: int, t1: float, t2: float, mu: float
         ) -> np.ndarray:
    """The N1 N2 single-particle energies, ascending: the standing waves
    of the open rectangle, eps(k, l) = -2 t1 cos(pi k / (N1 + 1))
    - 2 t2 cos(pi l / (N2 + 1)) - mu, 1 <= k <= N1, 1 <= l <= N2."""
    ex = -2.0 * float(t1) * np.cos(np.pi * np.arange(1, N1 + 1) / (N1 + 1))
    ey = -2.0 * float(t2) * np.cos(np.pi * np.arange(1, N2 + 1) / (N2 + 1))
    return np.sort((ex[:, None] + ey[None, :]).ravel() - float(mu))


def filled_energy(eps: np.ndarray, particles: Optional[int] = None
                  ) -> float:
    """The ground energy of free fermions with single-particle energies
    ``eps`` (ascending): the sum of the negative ones, or of the
    ``particles`` lowest in that sector."""
    return float(eps[eps < 0].sum() if particles is None
                 else eps[:particles].sum())


def _args(cfg: dict):
    N1, N2 = int(cfg["N1"]), int(cfg["N2"])
    if cfg["N"] != N1 * N2:
        raise ValueError(f"N = {cfg['N']} is not N1 N2 = {N1 * N2}")
    return N1, N2, cfg["t1"], cfg["t2"], cfg["mu"]


def mpo(cfg: dict, params: dict, instance: int):
    return ff2d_mpo(*_args(cfg))


def exact_energy(cfg: dict) -> float:
    return filled_energy(band(*_args(cfg)))
