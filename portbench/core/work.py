"""The algorithmic operations and bytes of the dense one-site sweep,
counted from its shapes and frozen here, whatever implements them.

Per site visit: ``m`` matvecs of the effective Hamiltonian, each the two
chi^3 d M contractions of L and R and the fold with W; one environment
update (a matvec's worth); one panel factorisation of the (chi d, chi)
site.  A sweep visits every site twice.  The Ritz solve of an m x m
tridiagonal and the Lanczos vector updates are left out of the sweep's
count (they are under 0.1% of it at chi=64, m=10).
"""
from __future__ import annotations


def matvec_flops(chi: int, d: int, M: int) -> int:
    """One instance's H_eff x: L[a,w,c] W[w,v,s,t] x[a,t,b] R[b,v,d]."""
    return 2 * (2 * chi ** 3 * d * M + chi ** 2 * d ** 2 * M ** 2)


def sweep_flops(N: int, chi: int, d: int, M: int, m: int) -> int:
    """One instance's one-site sweep: 2N site visits of m matvecs, one
    environment update and one panel factorisation (2 (chi d) chi^2 for
    Q, as much again for R)."""
    mv = matvec_flops(chi, d, M)
    per_site = m * mv + mv + 2 * 2 * (chi * d) * chi ** 2
    return 2 * N * per_site


def solve_work(B: int, chi: int, d: int, M: int, m: int,
               elem: int = 4):
    """(flops, bytes) of one batched local solve of B instances: m
    matvecs and ~10 vector flops an element a Lanczos step; its inputs
    L, R, W and x read once and its output, the ground vector, written
    once (the Krylov basis is an intermediate)."""
    n = d * chi * chi
    flops = B * m * (matvec_flops(chi, d, M) + 10 * n)
    nbytes = elem * (B * (2 * M * chi * chi + n + n) + M * M * d * d)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float):
    """(seconds, "operations" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
