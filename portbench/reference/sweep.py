"""A plain batched one-site DMRG sweep: einsum environments, a Lanczos
with full reorthogonalisation and a dense eigh of its tridiagonal,
Householder QR gauge shifts.  It is the reference put in the program's
place for the control (run with TF32 on, the precision below the
configurations' float32), and the sweep order is the dense program's:
right-canonicalise, sites 0..N-1 left to right, then N-1..0 back, the
last bond factor absorbed into site 0; the energy is the last solve's.
In float64 it also gives the ground energies that the output check
holds a configuration without a closed form to (:func:`ground_energies`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from portbench.reference import mps


def _normalize(A: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(A.reshape(A.shape[0], -1), dim=1)
    return A / torch.where(n > 0, n, 1.0).reshape((-1,) + (1,) * (A.dim() - 1))


def _w(W: torch.Tensor) -> str:
    return "wvst" if W.dim() == 4 else "Bwvst"


def update_left(L, A, W):
    X = torch.einsum("Bawc,Batr->Bwctr", L, A)
    Y = torch.einsum(f"Bwctr,{_w(W)}->Bcrvs", X, W)
    return torch.einsum("Bcrvs,Bcsp->Brvp", Y, A.conj())


def update_right(R, A, W):
    X = torch.einsum("Bbvd,Bltb->Bvdlt", R, A)
    Y = torch.einsum(f"Bvdlt,{_w(W)}->Bdlws", X, W)
    return torch.einsum("Bdlws,Bpsd->Blwp", Y, A.conj())


def matvec(L, W, R, x):
    X = torch.einsum("Bawc,Batb->Bwctb", L, x)
    Y = torch.einsum(f"Bwctb,{_w(W)}->Bcbvs", X, W)
    return torch.einsum("Bcbvs,Bbvd->Bcsd", Y, R)


def lanczos_ground(mv, x0: torch.Tensor, m: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest Ritz pair of each instance after m Lanczos steps from x0."""
    B, shape = x0.shape[0], x0.shape[1:]
    n = x0[0].numel()
    m = min(m, n)
    v = x0.reshape(B, n)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    basis, alphas, betas = [v], [], []
    for j in range(m):
        w = mv(basis[j].reshape((B,) + shape)).reshape(B, n)
        a = (basis[j] * w).sum(1)
        alphas.append(a)
        if j == m - 1:
            break
        V = torch.stack(basis, 1)
        w = w - torch.einsum("bk,bkn->bn", torch.einsum("bkn,bn->bk", V, w), V)
        w = w - torch.einsum("bk,bkn->bn", torch.einsum("bkn,bn->bk", V, w), V)
        b = torch.linalg.vector_norm(w, dim=1)
        betas.append(b)
        ok = b > 1e-30
        basis.append(torch.where(ok[:, None], w / torch.where(ok, b, 1.0)[:, None],
                                 torch.zeros_like(w)))
    T = torch.diag_embed(torch.stack(alphas, 1))
    if betas:
        off = torch.diag_embed(torch.stack(betas, 1), offset=1)
        T = T + off + off.mT
    evals, evecs = torch.linalg.eigh(T)
    x = torch.einsum("bk,bkn->bn", evecs[:, :, 0], torch.stack(basis, 1))
    return evals[:, 0], x.reshape((B,) + shape)


def _qr_right(A):
    """A (B, l, d, r) = Q Rm, Q left-isometric."""
    B, l, d, r = A.shape
    q, rm = torch.linalg.qr(A.reshape(B, l * d, r))
    return q.reshape(B, l, d, q.shape[-1]), rm


def _rq_left(A):
    """A (B, l, d, r) = Lm Q, Q right-isometric."""
    B, l, d, r = A.shape
    qt, rt = torch.linalg.qr(A.reshape(B, l, d * r).mT)
    return rt.mT, qt.mT.reshape(B, qt.shape[-1], d, r)


def _boundary(chi: int, v: torch.Tensor, B: int, left: bool):
    eye = torch.eye(chi, dtype=v.dtype, device=v.device)
    e = torch.einsum("ac,w->awc", eye, v)
    return e.expand(B, -1, -1, -1)


def _site_w(Ws, i):
    return Ws[i] if Ws.dim() == 5 else Ws[:, i]


def right_canonicalize(sites: List[torch.Tensor], Ws, vR):
    """Sites N-1..1 to right-canonical form (site 0 keeps the rest) and the
    right environments R[i] of the sites > i."""
    N, B = len(sites), sites[0].shape[0]
    sites = list(sites)
    R = [None] * N
    env = _boundary(sites[-1].shape[3], vR, B, False)
    for i in reversed(range(N)):
        R[i] = env
        if i == 0:
            break
        Lm, Q = _rq_left(_normalize(sites[i]))
        sites[i] = Q
        sites[i - 1] = torch.einsum("Basb,Bbc->Basc", sites[i - 1], Lm)
        env = update_right(env, Q, _site_w(Ws, i))
    sites[0] = _normalize(sites[0])
    return sites, R


def one_site_sweep(sites: List[torch.Tensor], Ws, vL, vR, m: int,
                   R: Optional[List[torch.Tensor]] = None):
    """One sweep; returns (sites, energy (B,), right environments for the
    next sweep)."""
    if R is None:
        sites, R = right_canonicalize(sites, Ws, vR)
    sites = list(sites)
    N, B = len(sites), sites[0].shape[0]
    L = [None] * N
    env = _boundary(sites[0].shape[1], vL, B, True)
    for i in range(N):
        L[i] = env
        W = _site_w(Ws, i)
        _, x = lanczos_ground(lambda y: matvec(env, W, R[i], y),
                              _normalize(sites[i]), m)
        if i == N - 1:
            sites[i] = x
            break
        Q, Rm = _qr_right(x)
        sites[i] = Q
        sites[i + 1] = torch.einsum("Bab,Bbsc->Basc", Rm, sites[i + 1])
        env = update_left(env, Q, W)
    env = _boundary(sites[-1].shape[3], vR, B, False)
    Rout = [None] * N
    energy = None
    for i in reversed(range(N)):
        Rout[i] = env
        W = _site_w(Ws, i)
        energy, x = lanczos_ground(lambda y: matvec(L[i], W, env, y),
                                   _normalize(sites[i]), m)
        if i == 0:
            sites[0] = x
            break
        Lm, Q = _rq_left(x)
        sites[i] = Q
        sites[i - 1] = torch.einsum("Basb,Bbc->Basc", sites[i - 1], Lm)
        env = update_right(env, Q, W)
    return sites, energy, Rout


def ground_energies(Ws, vL, vR, B: int, d: int, chi: int, sweeps: int,
                    m: int, seed: int = 0) -> torch.Tensor:
    """Float64 ground energies (B,) of the MPOs ``Ws`` ((N, M, M, d, d)
    shared, or (B, N, M, M, d, d) one an instance): ``sweeps`` plain
    sweeps from a fixed random open-chain MPS of bond ``chi``, then
    <H> of the returned state, so that each is an upper bound on the
    exact ground energy."""
    N, dev = Ws.shape[-5], Ws.device
    if Ws.dim() == 5:
        B = 1
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dims = [min(chi, d ** i, d ** (N - i)) for i in range(N + 1)]
    sites = [torch.randn((B, dims[i], d, dims[i + 1]), generator=g,
                         dtype=torch.float64, device=dev) for i in range(N)]
    R = None
    for _ in range(sweeps):
        sites, _, R = one_site_sweep(sites, Ws, vL, vR, m, R)
    return mps.energies(sites, Ws, vL, vR)
