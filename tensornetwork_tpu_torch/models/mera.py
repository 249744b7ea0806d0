"""Scale-invariant binary MERA ground-state optimizer.

Counterpart of :mod:`tensornetwork_tpu.models.mera`.  One coarse site comes
from an isometry ``w[out, a, b]`` over two fine sites, with disentanglers
``u[a', b', a, b]`` between blocks; three-site operators stay three-site
under the ascending superoperator, whose two fine placements are averaged.
The descending superoperator is the adjoint of the ascending one, taken by
``torch.func.vjp``; the environments of the polar updates are gradients of
the energy by autograd.

Each ascending network (11 tensors) is contracted pair by pair in a fixed
order that holds at most eight legs at once, so that neither the cost nor
the rounding depends on whether ``opt_einsum`` is installed (without it,
``torch.einsum`` contracts left to right).

Complex tensors: the JAX package's gradient of a real function of a complex
input is the complex conjugate of PyTorch's, and its vjp of a linear map is
the plain transpose where PyTorch's is the conjugate transpose.  The
functions here conjugate so as to return what the JAX package returns.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device, as_tensor,
                                            default_device, highest_precision)
from tensornetwork_tpu_torch.ops.decompositions import thin_svd


@highest_precision()
def ascend(h: torch.Tensor, u: torch.Tensor, w: torch.Tensor
           ) -> torch.Tensor:
    """Ascending superoperator for 3-site operators.

    ``h``: (d,d,d, d,d,d) with (out, in) triples; ``u``: (d,d,d,d)
    (out, out, in, in); ``w``: (d, d, d) (coarse_out, fine_a, fine_b).
    """
    uc, wc = torch.conj(u), torch.conj(w)
    # w[A,a,x] conj(w)[D,a,X] and w[C,o,p] conj(w)[F,O,p]: the outer blocks
    P0 = torch.einsum("Aax,DaX->AxDX", w, wc)
    P2 = torch.einsum("Cop,FOp->CoFO", w, wc)
    return 0.5 * (_ascend_L(h, u, uc, w, wc, P0, P2)
                  + _ascend_R(h, u, uc, w, wc, P0, P2))


def _ascend_L(h, u, uc, w, wc, P0, P2):
    """h on fine sites (1, 2, 3): u0[x,m,y,z] u1[n,o,s,c] h[y,z,s,i,j,k]
    u0*[X,M,i,j] u1*[N,O,k,c], closed by the three isometry pairs."""
    T = torch.einsum("yzsijk,xmyz->sijkxm", h, u)
    T = torch.einsum("sijkxm,XMij->skxmXM", T, uc)
    T = torch.einsum("skxmXM,AxDX->skmMAD", T, P0)
    Q = torch.einsum("nosc,NOkc->nosNOk", u, uc)
    Q = torch.einsum("nosNOk,CoFO->nsNkCF", Q, P2)
    T = torch.einsum("skmMAD,nsNkCF->mMADnNCF", T, Q)
    T = torch.einsum("mMADnNCF,Bmn->MADNCFB", T, w)
    T = torch.einsum("MADNCFB,EMN->ADCFBE", T, wc)
    return T.permute(0, 4, 2, 1, 5, 3)


def _ascend_R(h, u, uc, w, wc, P0, P2):
    """h on fine sites (2, 3, 4): u0[x,m,t,y] (t passes through)
    u1[n,o,s,c] h[y,s,c,j,k,l] u0*[X,M,t,j] u1*[N,O,k,l]."""
    T = torch.einsum("yscjkl,nosc->yjklno", h, u)
    T = torch.einsum("yjklno,NOkl->yjnoNO", T, uc)
    T = torch.einsum("yjnoNO,CoFO->yjnNCF", T, P2)
    Q = torch.einsum("xmty,XMtj->xmyXMj", u, uc)
    Q = torch.einsum("xmyXMj,AxDX->myMjAD", Q, P0)
    T = torch.einsum("yjnNCF,myMjAD->nNCFmMAD", T, Q)
    T = torch.einsum("nNCFmMAD,Bmn->NCFMADB", T, w)
    T = torch.einsum("NCFMADB,EMN->CFADBE", T, wc)
    return T.permute(2, 4, 0, 3, 5, 1)


@highest_precision()
def descend(rho: torch.Tensor, u: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
    """Descending superoperator: the adjoint of :func:`ascend`, by
    ``torch.func.vjp``.  For complex tensors the cotangent is conjugated,
    which returns the JAX package's conj(vjp) of its plain transpose."""
    primal = torch.zeros(rho.shape, dtype=rho.dtype, device=rho.device)
    _, vjp_fn = torch.func.vjp(lambda h: ascend(h, u, w), primal)
    (out,) = vjp_fn(torch.conj(rho) if rho.is_complex() else rho)
    return out


def _trace3(rho: torch.Tensor) -> torch.Tensor:
    D = int(round(rho.numel() ** 0.5))
    return torch.trace(rho.reshape(D, D))


@highest_precision()
def energy(h: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """<h> = Tr[rho h] / Tr[rho] for 3-site operators and densities."""
    D = int(round(rho.numel() ** 0.5))
    num = torch.einsum("ij,ji->", rho.reshape(D, D), h.reshape(D, D))
    return (num / _trace3(rho)).real


def _polar(m: torch.Tensor) -> torch.Tensor:
    u_svd, _, vh = thin_svd(m)
    return u_svd @ vh


def _environment(fn, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's gradient of the real function ``fn`` at ``x``
    (the conjugate of PyTorch's for a complex ``x``)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x), x)
    return torch.conj(g) if g.is_complex() else g


@highest_precision()
def update_disentangler(h, rho, u, w) -> torch.Tensor:
    """The SVD-polar update of u: minus the polar factor of the energy's
    gradient with respect to u, as a (d^2, d^2) matrix."""
    env = _environment(lambda uu: energy(ascend(h, uu, w), rho), u)
    d = u.shape[0]
    return (-_polar(env.reshape(d * d, d * d))).reshape(u.shape)


@highest_precision()
def update_isometry(h, rho, u, w) -> torch.Tensor:
    """The SVD-polar update of w: minus the polar factor of the energy's
    gradient with respect to w, as a (d, d^2) matrix."""
    env = _environment(lambda ww: energy(ascend(h, u, ww), rho), w)
    dc, da, db = w.shape
    return (-_polar(env.reshape(dc, da * db).mT).mT).reshape(w.shape)


class MERAState(NamedTuple):
    us: List[torch.Tensor]
    ws: List[torch.Tensor]


def initialize_mera(chi: int, num_layers: int,
                    dtype: Optional[torch.dtype] = None,
                    device: Optional[Device] = None) -> MERAState:
    """Identity disentanglers, truncated-identity isometries."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    eye2 = torch.eye(chi * chi, dtype=dtype, device=default_device(device))
    u = eye2.reshape(chi, chi, chi, chi)
    w = eye2[:, :chi].mT.reshape(chi, chi, chi)
    return MERAState([u] * num_layers, [w] * num_layers)


@highest_precision()
def top_density(h_top: torch.Tensor, u, w, num_iters: int = 20
                ) -> torch.Tensor:
    """Scale-invariant fixed point of the descending superoperator by
    power iteration from the identity, at unit trace."""
    d = h_top.shape[0]
    rho = torch.eye(d ** 3, dtype=h_top.dtype,
                    device=h_top.device).reshape((d,) * 6)
    for _ in range(num_iters):
        rho = descend(rho, u, w)
        rho = rho / _trace3(rho)
    return rho


@highest_precision()
def optimize_mera(h_base: torch.Tensor, state: MERAState,
                  num_iterations: int = 100, num_top_iters: int = 10
                  ) -> Tuple[MERAState, float]:
    """Alternating polar updates layer by layer: ascend the (spectrum-
    shifted) hamiltonian through the layers, descend the densities from
    the scale-invariant top, update every u and then w.  Returns the state
    and the energy of the last iteration."""
    d = h_base.shape[0]
    h_mat = h_base.reshape(d ** 3, d ** 3)
    shift = float(torch.linalg.eigvalsh(h_mat)[-1])
    eye = torch.eye(d ** 3, dtype=h_base.dtype, device=h_base.device)
    h_shifted = (h_mat - shift * eye).reshape(h_base.shape)
    us, ws = list(state.us), list(state.ws)
    L = len(us)
    e = np.inf
    for _ in range(num_iterations):
        hams = [h_shifted]
        for k in range(L):
            hams.append(ascend(hams[-1], us[k], ws[k]))
        rhos = [top_density(hams[-1], us[-1], ws[-1], num_top_iters)]
        for k in reversed(range(L)):
            rhos.insert(0, descend(rhos[0], us[k], ws[k]))
        for k in range(L):
            us[k] = update_disentangler(hams[k], rhos[k + 1], us[k], ws[k])
            ws[k] = update_isometry(hams[k], rhos[k + 1], us[k], ws[k])
        e = float(energy(hams[0], rhos[0])) + shift
    return MERAState(us, ws), e


def blocked_ising_hamiltonian(dtype: Optional[torch.dtype] = None,
                              device: Optional[Device] = None
                              ) -> torch.Tensor:
    """Critical TFI (H = -sum XX - sum Z) with two spins blocked per site
    (chi=4): the 3-site block hamiltonian density, whose expectation per
    spin is half the per-block value; the critical ground energy per spin
    is -4/pi.  Built in float64 with numpy, as the JAX package builds it."""
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    I = np.eye(2)

    def kron(*ops):
        out = np.array([[1.0]])
        for o in ops:
            out = np.kron(out, o)
        return out

    # two-block (4-spin) density: internal terms at half weight
    h_internal = (-kron(X, X, I, I) - kron(I, I, X, X)
                  - kron(Z, I, I, I) - kron(I, Z, I, I)
                  - kron(I, I, Z, I) - kron(I, I, I, Z))
    h_coupling = -kron(I, X, X, I)
    h2 = 0.5 * h_internal + h_coupling
    # three-block density: h2 on (A,B) and (B,C), half weight each
    h2t = h2.reshape(4, 4, 4, 4)
    h3 = (0.5 * np.einsum("ABab,Cc->ABCabc", h2t, np.eye(4))
          + 0.5 * np.einsum("Aa,BCbc->ABCabc", np.eye(4), h2t))
    return as_tensor(h3, device, DEFAULT_DTYPE if dtype is None else dtype)
