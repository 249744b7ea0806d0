"""Float64 energies and canonical forms of batched MPS.

An MPS here is a list of N site tensors (B, chi_l, d, chi_r), or a
uniform stack (B, N, chi, d, chi), with trace boundaries: the left and
right environments are the identity on the boundary bond times the MPO's
boundary vector (on a bond of dimension 1, the open chain).  Instances
are worked in blocks, so that the reference fits beside what is left.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def sites_of(state) -> List[torch.Tensor]:
    if isinstance(state, torch.Tensor):
        return list(state.unbind(1))
    return list(state)


def _block(sites: Sequence[torch.Tensor], M: int, budget: float) -> int:
    """Instances a block: the largest (chi_l, M, d, chi_r) float64
    temporary of one instance, three of them, within ``budget`` bytes."""
    big = max(s.shape[1] * s.shape[3] * s.shape[2] for s in sites)
    per = 3 * 8 * M * big * max(s.shape[1] for s in sites)
    return max(1, int(budget // max(per, 1)))


def energies(state, Ws, vL, vR, budget: float = 4e9) -> torch.Tensor:
    """<psi|H|psi> / <psi|psi> of every instance, float64 (B,).

    ``Ws``: (N, M, M, d, d) shared by the batch or (B, N, M, M, d, d);
    W[w, v, s, t] with s the bra's and t the ket's physical index."""
    sites = sites_of(state)
    B, dev = sites[0].shape[0], sites[0].device
    Ws = torch.as_tensor(Ws, dtype=torch.float64, device=dev)
    vL = torch.as_tensor(vL, dtype=torch.float64, device=dev)
    vR = torch.as_tensor(vR, dtype=torch.float64, device=dev)
    M = Ws.shape[-3]
    step = _block(sites, M, budget)
    out = []
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        chi0 = sites[0].shape[1]
        eye = torch.eye(chi0, dtype=torch.float64, device=dev)
        L = torch.einsum("ac,w->awc", eye, vL).expand(b1 - b0, -1, -1, -1)
        nL = eye.expand(b1 - b0, -1, -1)
        for i, s in enumerate(sites):
            A = s[b0:b1].to(torch.float64)
            W = Ws[i] if Ws.dim() == 5 else Ws[b0:b1, i]
            wsub = "wvst" if W.dim() == 4 else "bwvst"
            X = torch.einsum("bawc,batr->bwctr", L, A)
            Y = torch.einsum(f"bwctr,{wsub}->bcrvs", X, W)
            L = torch.einsum("bcrvs,bcsp->brvp", Y, A.conj())
            T = torch.einsum("bac,batr->bctr", nL, A)
            nL = torch.einsum("bctr,bctp->brp", T, A.conj())
            del X, Y, T
        chiN = sites[-1].shape[3]
        eyeN = torch.eye(chiN, dtype=torch.float64, device=dev)
        num = torch.einsum("brvp,rp,v->b", L, eyeN, vR)
        den = torch.einsum("brp,rp->b", nL, eyeN)
        out.append(num / den)
    return torch.cat(out)


def right_canonical_error(state, first: int = 1) -> torch.Tensor:
    """max |sum_s A_s A_s^T - I| over sites ``first``.. of each instance,
    float64 (B,): how far the returned tensors are from right-canonical
    form."""
    sites = sites_of(state)
    errs = []
    for s in sites[first:]:
        A = s.to(torch.float64)
        G = torch.einsum("bltr,bmtr->blm", A, A.conj())
        eye = torch.eye(G.shape[-1], dtype=torch.float64, device=G.device)
        errs.append((G - eye).abs().amax((1, 2)))
    return torch.stack(errs, 1).amax(1)
