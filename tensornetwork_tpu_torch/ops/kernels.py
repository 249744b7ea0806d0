"""Hand-written CUDA kernels of the one-site DMRG solve, with their twins.

Counterpart of the one-site resident part of
:mod:`tensornetwork_tpu.ops.kernels`.  Index conventions:
  L[a, w, c]   W[w, v, s, t]   R[b, v, d]   x[a, t, b]  ->  y[c, s, d]
and the kernel layout of :func:`prepare_operands`:
  Lt (B, M, chi, chi) [w, c, a]   Rt (B, M, chi, chi) [v, b, d]
  xt (B, d, chi, chi) [t, a, b]   y  (B, d, chi, chi) [s, c, d]
  W  (M, M, d, d) shared by the batch, or (B, M, M, d, d) one per instance.

Two kernels (sources in ``csrc/``, built by :mod:`._build`):

* :func:`heff_matvec` -- one batched H_eff matvec (replaces
  ``make_heff_matvec``).  Per instance, P_wt = Lt_w x_t, then
  y_s = sum_v (sum_wt W[w,v,s,t] P_wt) Rt_v.
* :func:`fused_lanczos` -- m matvecs plus the three-term recurrence per
  instance (replaces ``make_fused_lanczos``), emitting the basis V and
  (alpha, beta) with +1e10 sentinels on dead steps.

Each wrapper runs its plain-PyTorch twin (same algorithm) when handed CPU
tensors, and launches its kernel, or raises, when handed CUDA tensors.
``launch_counts`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tensornetwork_tpu_torch.ops import _build, krylov

LARGE = krylov.LARGE

# kernel launches since the last reset_launch_counts(); twins do not count
launch_counts: Dict[str, int] = {"heff_matvec": 0, "fused_lanczos": 0}

_MAX_COUPLINGS = 1024  # heff::MAX_COUPLINGS in csrc/heff.cuh
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "tn_heff_matvec": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _P],
    "tn_fused_lanczos": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, ctypes.c_double, _P],
}
_SOURCES = {"tn_heff_matvec": "heff_matvec.cu",
            "tn_fused_lanczos": "fused_lanczos.cu"}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernel_fn(name: str, dtype: torch.dtype):
    fn = getattr(_build.load(_SOURCES[name]), name + _SUFFIX[dtype])
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args):
    fn = _kernel_fn(name, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def prepare_operands(L, W, R, x):
    """Solver layout -> kernel layout (contiguous copies).

    L: (B, a, w, c) -> (B, w, c, a);  R: (B, b, v, d) -> (B, v, b, d);
    x: (B, a, t, b) -> (B, t, a, b);  W unchanged."""
    return (L.permute(0, 2, 3, 1).contiguous(), W,
            R.permute(0, 2, 1, 3).contiguous(),
            x.permute(0, 2, 1, 3).contiguous())


def finalize_output(y):
    """Kernel layout (B, s, c, d) -> solver layout (B, c, s, d)."""
    return y.permute(0, 2, 1, 3)


def heff_matvec_reference(L, W, R, x):
    """One-einsum reference of the matvec on solver-layout operands."""
    return torch.einsum("Bawc,wvst,Batb,Bbvd->Bcsd", L, W, x, R)


def _wspec(W) -> str:
    return "wvst" if W.dim() == 4 else "Bwvst"


def _validate(Lt, W, Rt, xt) -> Tuple[int, int, int, int, int]:
    """Shapes, dtypes, devices and contiguity the kernels take.  Returns
    (B, chi, d, M, stride of W between instances)."""
    if xt.dim() != 4 or Lt.dim() != 4 or Rt.dim() != 4:
        raise ValueError("Lt, Rt, xt must be (B, *, chi, chi)")
    B, d, chi, chi2 = xt.shape
    M = Lt.shape[1]
    if chi != chi2 or Lt.shape != (B, M, chi, chi) or Rt.shape != Lt.shape:
        raise ValueError(f"shape mismatch: Lt {tuple(Lt.shape)}, Rt "
                         f"{tuple(Rt.shape)}, xt {tuple(xt.shape)}")
    if W.shape == (M, M, d, d):
        w_stride = 0
    elif W.shape == (B, M, M, d, d):
        w_stride = M * M * d * d
    else:
        raise ValueError(f"W must be {(M, M, d, d)} or {(B, M, M, d, d)}, "
                         f"got {tuple(W.shape)}")
    if M * M * d * d > _MAX_COUPLINGS:
        raise ValueError(f"{M * M * d * d} couplings exceed the kernel's "
                         f"{_MAX_COUPLINGS}")
    ts = (Lt, W, Rt, xt)
    if xt.dtype not in _SUFFIX or any(t.dtype != xt.dtype for t in ts):
        raise TypeError("Lt, W, Rt, xt must share one dtype, float32 or "
                        f"float64; got {[t.dtype for t in ts]}")
    if any(t.device != xt.device for t in ts):
        raise ValueError("Lt, W, Rt, xt must lie on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("Lt, W, Rt, xt must be contiguous")
    if xt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xt.device}")
    return B, chi, d, M, w_stride


# ---------------------------------------------------------------------------
# K1: one H_eff matvec
# ---------------------------------------------------------------------------


def heff_matvec_plain(Lt, W, Rt, xt):
    """Plain-PyTorch twin of :func:`heff_matvec` (same two stages)."""
    P = torch.matmul(Lt[:, :, None], xt[:, None])            # (B, w, t, c, b)
    Q = torch.einsum(f"{_wspec(W)},Bwtcb->Bvscb", W, P)      # (B, v, s, c, b)
    return torch.matmul(Q, Rt[:, :, None]).sum(1)            # (B, s, c, d)


def heff_matvec(Lt, W, Rt, xt):
    """Batched one-site H_eff matvec on kernel-layout operands; returns
    y (B, d, chi, chi).  Counterpart of ``make_heff_matvec``."""
    B, chi, d, M, w_stride = _validate(Lt, W, Rt, xt)
    if xt.device.type == "cpu":
        return heff_matvec_plain(Lt, W, Rt, xt)
    P = torch.empty((B, M * d, chi, chi), dtype=xt.dtype, device=xt.device)
    y = torch.empty_like(xt)
    _launch("tn_heff_matvec", xt.dtype, xt.device,
            W.data_ptr(), w_stride, Lt.data_ptr(), Rt.data_ptr(),
            xt.data_ptr(), P.data_ptr(), y.data_ptr(), B, chi, d, M)
    launch_counts["heff_matvec"] += 1
    return y


# ---------------------------------------------------------------------------
# K2: the whole Lanczos factorization of one site
# ---------------------------------------------------------------------------


def fused_lanczos_plain(Lt, W, Rt, x0, num_krylov_vecs: int,
                        delta: float = 1e-8):
    """Plain-PyTorch twin of :func:`fused_lanczos` (same recurrence, same
    masks and sentinels, matvec by :func:`heff_matvec_plain`)."""
    m = num_krylov_vecs
    B = x0.shape[0]

    def vdot(a, b):
        return (a * b).sum(dim=(1, 2, 3))

    def bc(s):  # (B,) -> (B, 1, 1, 1)
        return s[:, None, None, None]

    nrm = torch.sqrt(vdot(x0, x0))
    alive = nrm > delta
    inv = torch.where(alive, 1.0 / torch.where(nrm > 0, nrm, 1.0), 0.0)
    v = x0 * bc(inv)
    v_prev = torch.zeros_like(x0)
    beta_prev = torch.zeros_like(nrm)
    V = torch.empty((B, m) + tuple(x0.shape[1:]), dtype=x0.dtype,
                    device=x0.device)
    ab = torch.zeros((B, 2, m), dtype=x0.dtype, device=x0.device)
    for j in range(m):
        V[:, j] = v
        w = heff_matvec_plain(Lt, W, Rt, v)
        alpha = vdot(v, w)
        ab[:, 0, j] = torch.where(alive, alpha, LARGE)
        w = w - bc(alpha) * v - bc(beta_prev) * v_prev
        beta = torch.sqrt(vdot(w, w))
        alive_next = alive & (beta > delta)
        if j < m - 1:
            ab[:, 1, j] = torch.where(alive_next, beta, 0.0)
        inv = torch.where(beta > delta,
                          1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
        v_prev = v
        v = w * bc(inv) * bc(alive_next.to(w.dtype))
        beta_prev = torch.where(alive_next, beta, 0.0)
        alive = alive_next
    return V, ab


def fused_lanczos(Lt, W, Rt, x0, num_krylov_vecs: int,
                  delta: float = 1e-8):
    """Whole Lanczos factorization of every instance on kernel-layout
    operands.  Returns ``V`` (B, m, d, chi, chi), the Krylov basis, and
    ``ab`` (B, 2, m): ``ab[:, 0]`` the alphas (+1e10 on dead steps),
    ``ab[:, 1, :-1]`` the betas (0 on dead steps).  Counterpart of
    ``make_fused_lanczos`` (plain three-term recurrence, no
    reorthogonalisation)."""
    B, chi, d, M, w_stride = _validate(Lt, W, Rt, x0)
    m = num_krylov_vecs
    if m < 1:
        raise ValueError("num_krylov_vecs must be >= 1")
    if x0.device.type == "cpu":
        return fused_lanczos_plain(Lt, W, Rt, x0, m, delta)
    kw = dict(dtype=x0.dtype, device=x0.device)
    V = torch.empty((B, m, d, chi, chi), **kw)
    ab = torch.empty((B, 2, m), **kw)
    P = torch.empty((B, M * d, chi, chi), **kw)
    w = torch.empty((B, d, chi, chi), **kw)
    _launch("tn_fused_lanczos", x0.dtype, x0.device,
            W.data_ptr(), w_stride, Lt.data_ptr(), Rt.data_ptr(),
            x0.data_ptr(), V.data_ptr(), ab.data_ptr(), P.data_ptr(),
            w.data_ptr(), B, chi, d, M, m, float(delta))
    launch_counts["fused_lanczos"] += 1
    return V, ab


def fused_lanczos_ground_state(L, W, R, x0, num_krylov_vecs: int,
                               ritz_method: str = "power",
                               power_iters: int = 60,
                               delta: float = 1e-8):
    """Batched ground-state Lanczos through :func:`fused_lanczos`.

    Solver-layout operands: L (B, a, M, c), W (M, M, d, d) or
    (B, M, M, d, d), R (B, b, M, d), x0 (B, a, t, b).  Returns ``(evals
    (B,), evecs (B, a, t, b))``, the smallest Ritz pair per instance, as
    ``krylov.eigsh_lanczos(..., numeig=1, reorthogonalize=False)``."""
    m = num_krylov_vecs
    Lt, W, Rt, xt = prepare_operands(L, W.contiguous(), R, x0)
    V, ab = fused_lanczos(Lt, W, Rt, xt, m, delta)
    evals, weights = krylov.tridiag_ritz(ab[:, 0, :], ab[:, 1, :m - 1],
                                         ritz_method, power_iters)
    y = torch.einsum("Bm,Bmtab->Btab", weights.to(V.dtype), V)
    nrm = torch.sqrt((y * y).sum(dim=(1, 2, 3), keepdim=True))
    y = y / torch.where(nrm > delta, nrm, 1.0)
    return evals, y.permute(0, 2, 1, 3)
