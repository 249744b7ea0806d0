"""Hand-written CUDA kernels of the DMRG local solve, with their twins.

Counterpart of the DMRG part of :mod:`tensornetwork_tpu.ops.kernels`.
Index conventions:
  L[a, w, c]   W[w, v, s, t]   R[b, v, d]   x[a, t, b]  ->  y[c, s, d]
and the kernel layout of :func:`prepare_operands`:
  Lt (B, M, chi, chi) [w, c, a]   Rt (B, M, chi, chi) [v, b, d]
  xt (B, d, chi, chi) [t, a, b]   y  (B, d, chi, chi) [s, c, d]
  W  (M, M, d, d) shared by the batch, or (B, M, M, d, d) one per instance.
The two-site solve is the same sandwich with nt = d*d physical tiles and
the MPO pair pre-fused into couplings C (M, M, nt, nt)
(:func:`fuse_mpo_pair`); every kernel takes any number of tiles.

The local solve is a ladder of tiers chosen by bond dimension
(:func:`one_site_tier`, :func:`two_site_tier`), each with its kernels
(sources in ``csrc/``, built by :mod:`._build`):

* resident (chi <= 256): :func:`fused_lanczos` -- m matvecs plus the
  three-term recurrence, one block per instance (replaces
  ``make_fused_lanczos``), emitting the basis V and (alpha, beta) with
  +1e10 sentinels on dead steps.  Beside it :func:`heff_matvec`, one
  batched H_eff matvec (replaces ``make_heff_matvec``), the matvec of the
  plain route.
* two_pass (chi = 384): :func:`fused_lanczos_fact` emits (alpha, beta)
  only, :func:`fused_lanczos_replay` reruns the recurrence and accumulates
  the Ritz vector (replace ``make_fused_lanczos_2pass``).
* streamed (chi = 512): :func:`fused_lanczos_streamed`, K2's function with
  the whole card on each instance (replaces
  ``make_fused_lanczos_streamed``).
* streamed_matvec (one-site chi = 1024, two-site chi = 128...512):
  :func:`streamed_matvec` returns (H x, <x, H x>) (replaces
  ``make_streamed_matvec``); the recurrence runs in PyTorch
  (:func:`streamed_lanczos`).
* streamed_matvec_xl (one-site chi = 2048, two-site chi = 1024):
  :func:`streamed_matvec_xl`, the same function with the contraction of
  stage 1 split into K3 chunks (replaces ``make_streamed_matvec_xl``),
  under the same recurrence.

In f32 these two are two tensor-core GEMMs in 3xTF32 and a coupling fold
(``csrc/gemm_tc32.cuh``; :func:`tc32_tile` picks each GEMM's tile,
:func:`tf32x3_matmul_plain` models the product), and so are the resident
tier's :func:`fused_lanczos`, with the same GEMMs as tile streams inside
one block per instance, and the two-pass and streamed tiers' grid-wide
matvecs (K3, K4: the tile jobs spread over every block of the card,
stage 2 split over the MPO bond, :func:`lgrid_plan`), and K5's resident
route (the panel in one block's shared memory for all its polar steps),
and K1 in f32 (:func:`heff_matvec_route`: K7's three launches without
<x, y>); K5's grid route, and every f64 instance, are fp32/fp64 SIMT.

Two-site, the resident tier is :func:`fused_lanczos` at nt = d*d
(:func:`fused_lanczos_ground_state_2s`).  TDVP's local evolutions
``exp(coeff H_eff) v`` run :func:`fused_lanczos` too: on real states
(:func:`expm_multiply_fused`, imaginary time, nt = d or 1 at the bond)
and on complex ones through the realified operands, M and nt doubled
(:func:`realify_sandwich_operands`, :func:`expm_multiply_fused_sc`).

The Ritz step of every power-Ritz solve, in each tier and in the plain
Lanczos, is :func:`tridiag_ritz_power` (K10, ``csrc/tridiag_ritz.cu``):
the 60 steepest-descent iterations of every instance's tridiagonal
projection in one launch, one warp an instance.  It replaces no TPU
kernel (the JAX package leaves that loop to XLA); it replaces the ~2,500
eager operations a solve of the loop on (B, m) tensors.

Beside the local solve:

* :func:`fused_gauge_env_left` / :func:`fused_gauge_env_right` -- the
  one-site sweep's polar gauge shift and environment growth in one launch
  (:func:`fused_gauge_env`, replaces ``make_fused_gauge_env``), taken by
  the sweep with ``epilogue_impl="fused"`` where
  :func:`gauge_epilogue_admitted` admits the shape; one block per instance
  where the panel fits its shared memory, else one cooperative launch
  over the batch (:func:`gauge_env_route`).
* :func:`transfer_chain` -- the batched MPS norm/overlap environment over
  a whole chain (replaces ``make_transfer_chain``), bf16 or f32 in, f32
  out, any chi: bf16 on the tensor cores with E resident on the SM across
  sites where it fits (:func:`transfer_chain_route`), else two batched
  GEMM launches per site.
* :func:`gemm_chain` -- chained bf16 GEMMs, the kernel of the issue-rate
  probe :mod:`tensornetwork_tpu_torch.benchmarks.mxu_micro` (replaces
  ``benchmarks/mxu_micro.py``'s ``make_chain_kernel``): ``wgmma`` with its
  operands brought in by TMA and mbarriers, one block per 64-row panel
  (:func:`gemm_chain_plan`), or WMMA for the shapes that plan does not
  take (:func:`gemm_chain_route`).

Each wrapper runs its plain-PyTorch twin (same algorithm) when handed CPU
tensors, and launches its kernel, or raises, when handed CUDA tensors.
``launch_counts`` counts kernel launches only; ``last_grid`` keeps the
blocks of the last launch of the grid-wide kernels.
"""
from __future__ import annotations

import ctypes
import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.ops import _build, krylov
from tensornetwork_tpu_torch.utils import tracing

LARGE = krylov.LARGE

# kernel launches since the last reset_launch_counts(); twins do not count
launch_counts: Dict[str, int] = {
    "heff_matvec": 0, "fused_lanczos": 0, "fused_lanczos_fact": 0,
    "fused_lanczos_replay": 0, "fused_lanczos_streamed": 0,
    "streamed_matvec": 0, "streamed_matvec_xl": 0, "fused_gauge_env": 0,
    "transfer_chain": 0, "gemm_chain": 0, "tridiag_ritz": 0}
# the route of each kernel launch of transfer_chain (transfer_chain_route),
# fused_gauge_env (gauge_env_route), gemm_chain (gemm_chain_route) and
# heff_matvec (heff_matvec_route), and the instance of each launch of
# fused_lanczos (fused_lanczos_instance)
route_counts: Dict[str, int] = {"heff_matvec_tc32": 0,
                                "heff_matvec_simt": 0,
                                "heff_matvec_rect": 0,
                                "fused_lanczos_tc<3,2>": 0,
                                "fused_lanczos_tc<3,4>": 0,
                                "fused_lanczos_tc<0,0>": 0,
                                "fused_lanczos_simt": 0,
                                "transfer_chain_resident": 0,
                                "transfer_chain_tiled": 0,
                                "fused_gauge_env_resident": 0,
                                "fused_gauge_env_grid": 0,
                                "gemm_chain_wgmma": 0,
                                "gemm_chain_wmma": 0}
# blocks of the last launch of each grid-wide (cooperative) kernel
last_grid: Dict[str, int] = {}

_MAX_COUPLINGS = 1024  # heff::MAX_COUPLINGS in csrc/heff.cuh
_TILE = 64             # heff::TILE: output tile edge
_SEG = 1024            # lgrid::SEG in csrc/lanczos_grid.cuh: segment length
_SMEM_BYTES = 232_448  # shared memory one H100 block may use
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_ARGTYPES = {
    "tn_heff_matvec": [_P, _L] + [_P] * 6 + [_I] * 7 + [_P],
    "tn_fused_lanczos": [_P, _L, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _D, _P],
    "tn_fused_lanczos_streamed": [_P, _L] + [_P] * 10 + [_I] * 7
                                 + [_D, _P, _P],
    "tn_fused_lanczos_fact": [_P, _L] + [_P] * 10 + [_I] * 7 + [_D, _P, _P],
    "tn_fused_lanczos_replay": [_P, _L] + [_P] * 11 + [_I] * 7
                               + [_D, _P, _P],
    "tn_streamed_matvec": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
    "tn_streamed_matvec_xl": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _P],
    "tn_fused_gauge_env": [_P] * 11 + [_I] * 7 + [_P, _P],
    "tn_transfer_chain": [_P] * 6 + [_I] * 5 + [_P],
    "tn_gemm_chain": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "tn_tridiag_ritz": [_P, _L, _P, _L, _P, _P, _I, _I, _I, _P],
}
_SOURCES = {"tn_heff_matvec": "heff_matvec.cu",
            "tn_fused_lanczos": "fused_lanczos.cu",
            "tn_fused_lanczos_streamed": "fused_lanczos_streamed.cu",
            "tn_fused_lanczos_fact": "fused_lanczos_2pass.cu",
            "tn_fused_lanczos_replay": "fused_lanczos_2pass.cu",
            "tn_streamed_matvec": "streamed_matvec.cu",
            "tn_streamed_matvec_xl": "streamed_matvec_xl.cu",
            "tn_fused_gauge_env": "fused_gauge_env.cu",
            "tn_transfer_chain": "transfer_chain.cu",
            "tn_gemm_chain": "gemm_chain.cu",
            "tn_tridiag_ritz": "tridiag_ritz.cu"}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64",
           torch.bfloat16: "_bf16"}
# the input types each C entry point has an instance for
_TYPES = {name: (torch.float32, torch.float64) for name in _SOURCES}
_TYPES["tn_transfer_chain"] = (torch.bfloat16, torch.float32)
_TYPES["tn_gemm_chain"] = (torch.bfloat16,)


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for k in counts:
            counts[k] = 0


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


def _launch_grid(name: str, dtype: torch.dtype, device: torch.device, *args):
    """Launch a cooperative kernel (its C function takes ``int* grid``
    before the stream) and record the blocks it launched."""
    grid = ctypes.c_int(0)
    _launch(name, dtype, device, *args, ctypes.addressof(grid))
    last_grid[name[3:]] = grid.value


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
    B, chi, d, M, w_stride, chib, chid = _validate_rect(Lt, W, Rt, xt)
    if chib != chi or chid != chi:
        raise ValueError(f"shape mismatch: Lt {tuple(Lt.shape)}, Rt "
                         f"{tuple(Rt.shape)}, xt {tuple(xt.shape)}")
    return B, chi, d, M, w_stride


def _validate_rect(Lt, W, Rt, xt) -> Tuple[int, int, int, int, int, int,
                                            int]:
    """:func:`_validate` for K1's contract, whose right bond may be a
    block: xt (B, d, chi, chib), Rt (B, M, chib, chid) -> y (B, d, chi,
    chid).  Returns (B, chi, d, M, stride of W, chib, chid)."""
    if xt.dim() != 4 or Lt.dim() != 4 or Rt.dim() != 4:
        raise ValueError("Lt, Rt, xt must be (B, *, chi, chi)")
    B, d, chi, chib = xt.shape
    M = Lt.shape[1]
    chid = Rt.shape[3]
    if Lt.shape != (B, M, chi, chi) or Rt.shape != (B, M, chib, chid):
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
    return B, chi, d, M, w_stride, chib, chid


# ---------------------------------------------------------------------------
# K1: one H_eff matvec
# ---------------------------------------------------------------------------


def heff_matvec_plain(Lt, W, Rt, xt):
    """Plain-PyTorch twin of :func:`heff_matvec` (same two stages), on
    the square and the block contract alike."""
    P = torch.matmul(Lt[:, :, None], xt[:, None])            # (B, w, t, c, b)
    Q = torch.einsum(f"{_wspec(W)},Bwtcb->Bvscb", W, P)      # (B, v, s, c, b)
    return torch.matmul(Q, Rt[:, :, None]).sum(1)            # (B, s, c, d)


_HEFF_ROUTES = ("simt", "tc32", "rect")


def heff_matvec_route(chi: int, nt: int, M: int, B: int,
                      dtype: torch.dtype, chib: Optional[int] = None,
                      chid: Optional[int] = None) -> str:
    """The kernel route of :func:`heff_matvec` for CUDA tensors.  The
    square contract (``chib = chid = chi``, the default): f64 ->
    ``"simt"`` (heff.cuh's fp64 tile GEMM, unchanged); f32 -> ``"tc32"``
    (the 3xTF32 tensor-core core in three launches, 64 x 64 tiles spread
    over the card) at every shape.  ``benchmarks/k1_routes.py`` (device
    time by torch.profiler, H100 80GB HBM3 at 700 W, M=3) found it faster
    than the f32 SIMT kernel at all 32 points of B 1/8/64/256, chi
    32/64/128/256, nt 2/4.  A right bond cut to a block (the bond-sharded
    sweep's local partial, ``chib`` or ``chid`` != ``chi``) takes
    ``"rect"``, a SIMT tile GEMM with the block's extents, in either
    dtype."""
    del nt, M, B  # one route a dtype and contract
    if (chib is not None and chib != chi) or (chid is not None
                                              and chid != chi):
        return "rect"
    return "tc32" if dtype == torch.float32 else "simt"


def heff_matvec(Lt, W, Rt, xt):
    """Batched H_eff matvec on kernel-layout operands with any number of
    physical tiles (d one-site; d*d two-site with W the fused couplings);
    returns y (B, d, chi, chid).  Counterpart of ``make_heff_matvec``.
    The right bond may be a block (the bond-sharded sweep's local
    partial): xt (B, d, chi, chib) and Rt (B, M, chib, chid) give the sum
    over this block of b.  CUDA tensors take the route
    :func:`heff_matvec_route` picks: f32 on the 3xTF32 tensor-core core,
    f64 on the SIMT core, a block contract on the rectangular SIMT GEMM."""
    return _heff_launch(Lt, W, Rt, xt, None)


def heff_matvec_simt(Lt, W, Rt, xt):
    """The first port's SIMT kernel of :func:`heff_matvec`, in either
    dtype.  No path takes it for f32 (:func:`heff_matvec_route` never
    does): it is the yardstick that ``chip_smoke.py`` and
    ``benchmarks/k1_routes.py`` time the 3xTF32 route against."""
    return _heff_launch(Lt, W, Rt, xt, "simt")


def _heff_launch(Lt, W, Rt, xt, route):
    """K1 on ``route``, or the route :func:`heff_matvec_route` picks for
    None; the twin for CPU tensors."""
    B, chi, d, M, w_stride, chib, chid = _validate_rect(Lt, W, Rt, xt)
    if xt.device.type == "cpu":
        return heff_matvec_plain(Lt, W, Rt, xt)
    rect = heff_matvec_route(chi, d, M, B, xt.dtype, chib, chid) == "rect"
    if route is None:
        route = heff_matvec_route(chi, d, M, B, xt.dtype, chib, chid)
    elif rect:
        raise ValueError(f"route {route!r} takes the square contract only")
    P = torch.empty((B, M * d, chi, chib), dtype=xt.dtype, device=xt.device)
    Q = torch.empty_like(P) if route in ("tc32", "rect") else None
    y = torch.empty((B, d, chi, chid), dtype=xt.dtype, device=xt.device)
    _launch("tn_heff_matvec", xt.dtype, xt.device,
            W.data_ptr(), w_stride, Lt.data_ptr(), Rt.data_ptr(),
            xt.data_ptr(), P.data_ptr(), _ptr(Q), y.data_ptr(), B, chi, d, M,
            chib, chid, _HEFF_ROUTES.index(route))
    launch_counts["heff_matvec"] += 1
    route_counts["heff_matvec_" + route] += 1
    return y


# ---------------------------------------------------------------------------
# The tier router
# ---------------------------------------------------------------------------

# The JAX package's TPU budgets (its ops/vmem.py: 12 MB for the resident and
# two-pass kernels, 14 MB for the chunked planners, and for nt > 2 resident
# kernels a measured 6.36x inflation against the 16 MB physical limit), and
# the (chi, nt, M) shapes whose streamed-matvec plans it pins from TPU
# measurements (admitted whatever the byte count says).
_RESIDENT_BYTES = 12 * 2 ** 20
_STREAMED_BYTES = 14_000_000
_WIDE_INFLATION, _PHYSICAL_BYTES = 6.36, 16 * 2 ** 20
_PINNED_MATVEC_SHAPES = {(512, 4, 3), (1024, 2, 3)}


def _chunk_counts(chi: int, min_chunk: int):
    """Power-of-two counts K that divide chi into chunks >= min_chunk."""
    K = 1
    while chi // K >= min_chunk:
        if chi % K == 0:
            yield K
        K *= 2


def _admits_resident(chi: int, nt: int, M: int, m: int) -> bool:
    """The whole-Lanczos kernel with its basis resident (``vmem.
    admit_resident_lanczos``)."""
    need = 4 * chi * chi * (2 * M + nt * (m + 4 + M))
    return (need <= _RESIDENT_BYTES if nt <= 2
            else need * _WIDE_INFLATION <= _PHYSICAL_BYTES)


def _admits_streamed_matvec(chi: int, nt: int, M: int) -> bool:
    """Both output axes chunked (rows K ways, columns K2 ways), x resident;
    L, R, Q and y in chunks (``vmem.streamed_matvec_plan``)."""
    if (chi, nt, M) in _PINNED_MATVEC_SHAPES:
        return True
    plane = 4 * chi * chi
    for K in _chunk_counts(chi, 32):
        for K2 in _chunk_counts(chi, 128):
            cs, ds = chi // K, chi // K2
            need = (plane * nt + 8 * M * cs * chi
                    + (2 if K2 > 1 else 1) * 4 * M * chi * ds
                    + 4 * M * nt * cs * chi + 8 * nt * cs * ds)
            if need <= _STREAMED_BYTES:
                return True
    return False


def _admits_streamed_matvec_xl(chi: int, nt: int, M: int) -> bool:
    """All three axes chunked: x streamed in contraction chunks through
    kernel A, Q staged in device memory (``vmem.streamed_matvec_xl_plan``,
    the same search and the same early exit)."""
    for K in _chunk_counts(chi, 32):
        cs = chi // K
        for K3 in _chunk_counts(chi, 128):
            a = chi // K3
            if 8 * nt * a * chi + 8 * M * cs * a + 4 * M * nt * cs * chi \
                    > _STREAMED_BYTES:
                continue
            for K2 in _chunk_counts(chi, 128):
                ds = chi // K2
                if (8 * M * nt * cs * chi + 8 * M * chi * ds + 4 * nt * cs * ds
                        + 8 * nt * cs * ds) <= _STREAMED_BYTES:
                    return True
            break  # kernel A fits but no K2 does: shrink the row chunk
    return False


def one_site_tier(chi: int, d: int, M: int, m: int) -> str:
    """The kernel tier of the one-site fused local solve at bond dimension
    ``chi``, physical dimension ``d``, MPO bond ``M`` and ``m`` Krylov
    vectors: ``"resident"``, ``"two_pass"``, ``"streamed"``,
    ``"streamed_matvec"`` or ``"streamed_matvec_xl"``.

    The thresholds are the TPU's: the byte counts of the JAX package's VMEM
    admission (``ops/vmem.py``) against its 12 MB and 14 MB budgets, kept so
    that both packages take the same tier at the same shape.  They say
    nothing about this card; a later change re-picks them from the card's
    measured tier times.  Raises ``NotImplementedError`` beyond the XL tier
    (one-site chi=4096 at d=2, M=3), where the JAX package takes its plain
    Lanczos; it never takes another tier instead."""
    plane = 4 * chi * chi  # one f32 chi x chi tile
    if _admits_resident(chi, d, M, m):
        return "resident"
    if plane * (2 * M + 6 * d) <= _RESIDENT_BYTES:
        return "two_pass"
    # chi chunked K ways: Rt, x0, v, v_prev, w resident; L (two buffers),
    # P and the basis out in chunks
    for K in _chunk_counts(chi, 64):
        if K > 1 and (plane * (M + 4 * d) + plane * (2 * M + M * d + 2 * d) // K
                      <= _STREAMED_BYTES):
            return "streamed"
    if _admits_streamed_matvec(chi, d, M):
        return "streamed_matvec"
    if _admits_streamed_matvec_xl(chi, d, M):
        return "streamed_matvec_xl"
    raise NotImplementedError(
        f"one-site chi={chi}, d={d}, M={M}: beyond the XL tier the JAX "
        "package takes its plain Lanczos; the port has no such tier")


def two_site_tier(chi: int, d: int, M: int, m: int) -> str:
    """The kernel tier of the two-site fused local solve (nt = d*d physical
    tiles, the MPO pair pre-fused): ``"resident"`` (K2), ``"streamed_matvec"``
    (K7) or ``"streamed_matvec_xl"`` (K8), where the JAX package's
    ``_local_solve_2s`` takes that tier -- at d=2, M=3, m=6: resident up to
    chi~100, streamed matvec for chi=128...512, XL at chi=1024 and 2048.

    As :func:`one_site_tier`, the thresholds are the TPU's VMEM admission
    (with the 6.36x inflation of nt >= 4 resident kernels and the pinned
    chi=512 plan), kept so that both packages take the same tier; a later
    change re-picks them from the card's times.  Raises
    ``NotImplementedError`` beyond the XL tier."""
    nt = d * d
    if _admits_resident(chi, nt, M, m):
        return "resident"
    if _admits_streamed_matvec(chi, nt, M):
        return "streamed_matvec"
    if _admits_streamed_matvec_xl(chi, nt, M):
        return "streamed_matvec_xl"
    raise NotImplementedError(
        f"two-site chi={chi}, d={d}, M={M}: beyond the XL tier the JAX "
        "package takes its plain Lanczos; the port has no such tier")


# ---------------------------------------------------------------------------
# The plain three-term recurrence, shared by the twins
# ---------------------------------------------------------------------------


def _vdot(a, b):
    return (a * b).sum(dim=(1, 2, 3))


def _bc(s):  # (B,) -> (B, 1, 1, 1)
    return s[:, None, None, None]


def _start(x0, delta: float):
    """v0 = x0/|x0|, zero and dead where |x0| <= delta."""
    nrm = torch.sqrt(_vdot(x0, x0))
    alive = nrm > delta
    inv = torch.where(alive, 1.0 / torch.where(nrm > 0, nrm, 1.0), 0.0)
    return x0 * _bc(inv), alive


def _lanczos_recurrence(matvec, x0, m: int, delta: float):
    """Plain three-term Lanczos, no reorthogonalisation, on (B, nt, chi,
    chi) vectors: ``matvec(v)`` returns (H v, <v, H v>).  Returns (V (B, m,
    nt, chi, chi), ab (B, 2, m)): alphas with +1e10 on dead steps, betas
    with 0 on dead steps and in the last slot, zero vectors once dead."""
    B = x0.shape[0]
    v, alive = _start(x0, delta)
    v_prev = torch.zeros_like(x0)
    beta_prev = torch.zeros((B,), dtype=x0.dtype, device=x0.device)
    V = torch.empty((B, m) + tuple(x0.shape[1:]), dtype=x0.dtype,
                    device=x0.device)
    ab = torch.zeros((B, 2, m), dtype=x0.dtype, device=x0.device)
    for j in range(m):
        V[:, j] = v
        w, alpha = matvec(v)
        ab[:, 0, j] = torch.where(alive, alpha, LARGE)
        w = w - _bc(alpha) * v - _bc(beta_prev) * v_prev
        beta = torch.sqrt(_vdot(w, w))
        alive_next = alive & (beta > delta)
        if j < m - 1:
            ab[:, 1, j] = torch.where(alive_next, beta, 0.0)
        inv = torch.where(beta > delta,
                          1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
        v_prev = v
        v = w * _bc(inv) * _bc(alive_next.to(w.dtype))
        beta_prev = torch.where(alive_next, beta, 0.0)
        alive = alive_next
    return V, ab


def _check_krylov(m: int) -> None:
    if m < 1:
        raise ValueError("num_krylov_vecs must be >= 1")


# The block tiles (BM, BN) of the f32 grid-wide Lanczos kernels' GEMM
# stages (csrc/lanczos_grid.cuh), largest first, each with the blocks an
# SM it launches at (its register budget, tc32::min_blocks).
_GRID_TILES = {(128, 128): 1, (64, 64): 2}


class GridPlan(NamedTuple):
    """The f32 grid Lanczos's matvec plan: the block tile (BM, BN) of both
    GEMM stages, the split of stage 2 over the MPO bond into ``split``
    slots, the tile jobs of each stage and the resident blocks."""
    tile: Tuple[int, int]
    split: int
    jobs1: int
    jobs2: int
    blocks: int


def lgrid_plan(chi: int, d: int, M: int, B: int, sms: int,
               tile: Optional[Tuple[int, int]] = None) -> GridPlan:
    """The plan of the f32 grid-wide Lanczos kernels (K3 fact and replay,
    K4).  Stage 1, P = [Lt_w] @ [v_t], has (M chi) x chi outputs per (t,
    instance); stage 2, w_s = sum_v Q_vs Rt_v, chi x chi per (s,
    instance), and is split over v into M slots when its unsplit grid
    gives less than 7/8 of the resident blocks a job (:func:`tc32_tile`'s
    rule).  The tile: 128x128 (one block an SM) where its stage-1 grid
    gives at least half the SMs a job, else 64x64 (two blocks an SM), or
    ``tile``.  Never a function of the mode, so replay and K4 run fact's
    jobs."""
    def jobs(tile, rows, groups):
        return -(-rows // tile[0]) * -(-chi // tile[1]) * groups

    if tile is None:
        big = next(iter(_GRID_TILES))
        tile = big if 2 * jobs(big, M * chi, d * B) >= sms else (64, 64)
    blocks = _GRID_TILES[tile] * sms
    split = 1 if 8 * jobs(tile, chi, d * B) >= 7 * blocks else M
    return GridPlan(tile, split, jobs(tile, M * chi, d * B),
                    jobs(tile, chi, d * B * split), blocks)


def _grid_scratch(B: int, chi: int, d: int, M: int, split: int, **kw):
    """Scratch of the grid-wide Lanczos kernels (csrc/lanczos_grid.cuh):
    P (stage 1, then the fold in place), the ``split`` slots of stage 2
    (slot 0 then holds w), the <v, w> and norm partials of each segment
    (float64) and the start flags."""
    nseg = -(-(d * chi * chi) // _SEG)
    f64 = dict(kw, dtype=torch.float64)
    return (torch.empty((B, M * d * chi * chi), **kw),
            torch.empty((B, split, d, chi, chi), **kw),
            torch.empty((B, nseg), **f64),
            torch.empty((B, nseg), **f64),
            torch.empty((B,), **kw))


def _launch_lanczos_grid(name: str, Lt, W, Rt, x0, m: int, delta: float,
                         io) -> None:
    """One launch of a grid-wide Lanczos kernel: ``io`` are the mode's own
    tensors (V or the ring, ab; replay: weights, ab, y, ring).  f32 takes
    the split of :func:`lgrid_plan` at the tensors' SM count, the same for
    every mode; f64 (the SIMT core) takes none."""
    B, chi, d, M, w_stride = _validate(Lt, W, Rt, x0)
    tile, split = _TC32_TILES[-1], 1
    if x0.dtype == torch.float32:
        tile, split = lgrid_plan(chi, d, M, B, _sm_count(x0.device))[:2]
    P, slots, apart, bpart, alive0 = _grid_scratch(
        B, chi, d, M, split, dtype=x0.dtype, device=x0.device)
    partials = (bpart,) if name == "tn_fused_lanczos_replay" else (apart, bpart)
    _launch_grid(name, x0.dtype, x0.device,
                 W.data_ptr(), w_stride, Lt.data_ptr(), Rt.data_ptr(),
                 x0.data_ptr(), *(t.data_ptr() for t in io), P.data_ptr(),
                 slots.data_ptr(), *(t.data_ptr() for t in partials),
                 alive0.data_ptr(), B, chi, d, M, m,
                 _TC32_TILES.index(tile), split, float(delta))


# ---------------------------------------------------------------------------
# K2: the whole Lanczos factorization of one site, one block per instance
# ---------------------------------------------------------------------------


def fused_lanczos_plain(Lt, W, Rt, x0, num_krylov_vecs: int,
                        delta: float = 1e-8):
    """Plain-PyTorch twin of :func:`fused_lanczos` and of
    :func:`fused_lanczos_streamed` (the same recurrence, masks and
    sentinels, matvec by :func:`heff_matvec_plain`)."""
    def matvec(v):
        w = heff_matvec_plain(Lt, W, Rt, v)
        return w, _vdot(v, w)
    return _lanczos_recurrence(matvec, x0, num_krylov_vecs, delta)


def fused_lanczos_instance(M: int, nt: int, dtype: torch.dtype) -> str:
    """The kernel instance ``tn_fused_lanczos`` runs (M, nt) on
    (``csrc/fused_lanczos.cu``): in f32 the 3xTF32 kernel compiled for
    (M, nt) = (3, 2) or (3, 4), ``"tc<3,2>"``/``"tc<3,4>"``, else its
    run-time instance ``"tc<0,0>"``; in f64 the SIMT kernel, ``"simt"``."""
    if dtype != torch.float32:
        return "simt"
    return f"tc<{M},{nt}>" if (M, nt) in ((3, 2), (3, 4)) else "tc<0,0>"


def fused_lanczos(Lt, W, Rt, x0, num_krylov_vecs: int,
                  delta: float = 1e-8):
    """Whole Lanczos factorization of every instance on kernel-layout
    operands.  Returns ``V`` (B, m, d, chi, chi), the Krylov basis, and
    ``ab`` (B, 2, m): ``ab[:, 0]`` the alphas (+1e10 on dead steps),
    ``ab[:, 1, :-1]`` the betas (0 on dead steps).  Counterpart of
    ``make_fused_lanczos`` (plain three-term recurrence, no
    reorthogonalisation).  f32 runs its products on the tensor cores in
    3xTF32 (fp32-accurate; ``csrc/gemm_tc32.cuh``), f64 on the SIMT
    core."""
    B, chi, d, M, w_stride = _validate(Lt, W, Rt, x0)
    m = num_krylov_vecs
    _check_krylov(m)
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
    route_counts["fused_lanczos_"
                 + fused_lanczos_instance(M, d, x0.dtype)] += 1
    return V, ab


# ---------------------------------------------------------------------------
# K2's exponential callers: TDVP's local evolutions
# ---------------------------------------------------------------------------


def _sc_triple_signs() -> np.ndarray:
    """G[rho, sigma, kappa, tau]: the sign of the triple product of the
    rho part of L, the sigma part of x and the kappa part of R (0 real, 1
    imaginary) in component tau of L x R, where tau is the parity of the
    imaginary factors (i^2 = -1); zero elsewhere."""
    g = np.zeros((2, 2, 2, 2))
    for r, s, k in itertools.product(range(2), repeat=3):
        n_im = r + s + k
        g[r, s, k, n_im % 2] = -1.0 if (n_im // 2) % 2 else 1.0
    return g


_SC_TRIPLE_SIGNS = _sc_triple_signs()


def realify_sandwich_operands(L, W, R, x):
    """Complex solver-layout operands -- L (B, a, M, c), R (B, b, M, d), x
    (B, a, t, b) -- and a real W (M, M, d, d) as the real kernel-layout
    operands of the realified H_eff, with both M and d doubled.  Hermitian
    H has real tridiagonal coefficients, so the complex Lanczos equals the
    real three-term Lanczos of the realified operator, which K2 runs.

    Index doubling: w' = 2w+rho, v' = 2v+kappa, t' = 2t+sigma (rho, kappa,
    sigma: 0 the real part, 1 the imaginary part); the couplings W'[(w,
    rho), (v, kappa), (s, tau), (t, sigma)] = W[w, v, s, t] G[rho, sigma,
    kappa, tau] encode the complex triple product (:func:`_sc_triple_signs`).
    Returns (Lt', W', Rt', xt') as :func:`prepare_operands` lays them out.
    Counterpart of the JAX package's ``_realify_sandwich_operands``."""
    B, chi, M, _ = L.shape
    d = x.shape[2]

    def split(t, n):
        return torch.stack([t.real, t.imag], dim=3).reshape(B, chi, 2 * n, chi)

    g = torch.as_tensor(_SC_TRIPLE_SIGNS, dtype=W.dtype, device=W.device)
    Wp = (W[:, None, :, None, :, None, :, None]
          * g.permute(0, 2, 3, 1)[None, :, None, :, None, :, None, :])
    return prepare_operands(split(L, M), Wp.reshape(2 * M, 2 * M, 2 * d, 2 * d),
                            split(R, M), split(x, d))


def _floor_delta(delta: float, dtype: torch.dtype) -> float:
    """The breakdown tolerance above the accumulation noise: plain
    three-term betas bottom out near 1e-6 in f32, and a chain continued on
    noise feeds wrong Ritz directions into the exponential's weights."""
    return max(delta, 50 * torch.finfo(dtype).eps)


def fused_lanczos_factorization_sc(L, W, R, x0, num_krylov_vecs: int,
                                   delta: float = 1e-8):
    """Lanczos factorization of every instance's complex H_eff by
    :func:`fused_lanczos` on the realified operands
    (:func:`realify_sandwich_operands`).  Operands: complex L (B, a, M,
    c), real W (M, M, d, d), complex R (B, b, M, d), complex x0 (B, a, t,
    b).  Returns (V (B, m, a, t, b) complex, alphas (B, m), betas (B,
    m-1)), real coefficients with K2's sentinels: the semantics of
    :func:`krylov.lanczos_factorization_sc` without reorthogonalisation.
    Counterpart of the JAX package's ``fused_lanczos_factorization_sc``."""
    m = num_krylov_vecs
    Lt, Wp, Rt, xt = realify_sandwich_operands(L, W, R, x0)
    Vp, ab = fused_lanczos(Lt, Wp, Rt, xt, m, _floor_delta(delta, xt.dtype))
    B, chi, d = x0.shape[:3]
    # kernel layout [t'](a, b), t' = 2t + sigma -> solver layout (a, t, b)
    Vp = Vp.reshape(B, m, d, 2, chi, chi)
    V = torch.complex(Vp[:, :, :, 0], Vp[:, :, :, 1]).permute(0, 1, 3, 2, 4)
    return V, ab[:, 0], ab[:, 1, :m - 1]


def expm_multiply_fused_sc(L, W, R, v, coeff, num_krylov_vecs: int,
                           delta: float = 1e-8):
    """``exp(coeff H_eff) v`` of every instance's complex state through
    :func:`fused_lanczos_factorization_sc` (operands as there; ``coeff`` a
    number or a (B,) tensor, real time ``-1j * dt``).  Returns (B, a, t,
    b), complex.  Counterpart of the JAX package's
    ``expm_multiply_fused_sc``: :func:`krylov.expm_multiply_lanczos_sc`
    with the plain three-term recurrence, norm-preserving up to the
    projection error."""
    nrm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1)
    V, alphas, betas = fused_lanczos_factorization_sc(L, W, R, v,
                                                      num_krylov_vecs, delta)
    return krylov.combine_basis(V, krylov.expm_weights(alphas, betas, coeff),
                                nrm)


def expm_multiply_fused(L, W, R, v, coeff, num_krylov_vecs: int,
                        delta: float = 1e-8):
    """``exp(coeff H_eff) v`` of every instance's real state through
    :func:`fused_lanczos`: solver-layout L (B, a, M, c), W (M, M, d, d), R
    (B, b, M, d), v (B, a, t, b); ``coeff`` a number or a (B,) tensor
    (imaginary time: real).  Counterpart of the JAX package's
    ``expm_multiply_fused``."""
    m = num_krylov_vecs
    nrm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1)
    Lt, W, Rt, xt = prepare_operands(L, W.contiguous(), R, v)
    V, ab = fused_lanczos(Lt, W, Rt, xt, m, _floor_delta(delta, xt.dtype))
    y = krylov.combine_basis(
        V, krylov.expm_weights(ab[:, 0], ab[:, 1, :m - 1], coeff), nrm)
    return finalize_output(y)


# ---------------------------------------------------------------------------
# K4: the same factorization with the whole card on each instance
# ---------------------------------------------------------------------------


def fused_lanczos_streamed(Lt, W, Rt, x0, num_krylov_vecs: int,
                           delta: float = 1e-8):
    """:func:`fused_lanczos`'s function -- the same ``(V, ab)`` from the
    same operands -- as one cooperative launch in which every block of
    the card works on every instance's matvec tiles and recurrence.
    Counterpart of ``make_fused_lanczos_streamed``, the one-site chi=512
    tier; its ``n_chunks`` (the TPU's VMEM chunking) has no meaning here.
    f32 runs its matvecs on the tensor cores in 3xTF32 (fp32-accurate;
    ``csrc/lanczos_grid.cuh``, tiles by :func:`lgrid_plan`), f64 on the
    SIMT core.  The twin is :func:`fused_lanczos_plain`."""
    B, chi, d, _, _ = _validate(Lt, W, Rt, x0)
    m = num_krylov_vecs
    _check_krylov(m)
    if x0.device.type == "cpu":
        return fused_lanczos_plain(Lt, W, Rt, x0, m, delta)
    kw = dict(dtype=x0.dtype, device=x0.device)
    V = torch.empty((B, m, d, chi, chi), **kw)
    ab = torch.empty((B, 2, m), **kw)
    _launch_lanczos_grid("tn_fused_lanczos_streamed", Lt, W, Rt, x0, m,
                         delta, (V, ab))
    launch_counts["fused_lanczos_streamed"] += 1
    return V, ab


# ---------------------------------------------------------------------------
# K3: two-pass Lanczos (no basis storage)
# ---------------------------------------------------------------------------


def fused_lanczos_fact_plain(Lt, W, Rt, x0, num_krylov_vecs: int,
                             delta: float = 1e-8):
    """Plain-PyTorch twin of :func:`fused_lanczos_fact`: the recurrence of
    :func:`fused_lanczos_plain`, whose basis it drops."""
    return fused_lanczos_plain(Lt, W, Rt, x0, num_krylov_vecs, delta)[1]


def fused_lanczos_fact(Lt, W, Rt, x0, num_krylov_vecs: int,
                       delta: float = 1e-8):
    """Pass 1 of the two-pass Lanczos: the ``ab`` (B, 2, m) of
    :func:`fused_lanczos` without storing the basis.  Counterpart of
    ``make_fused_lanczos_2pass``'s ``fact``, the one-site chi=384 tier.
    Its matvecs and sums are :func:`fused_lanczos_streamed`'s, so its
    ``ab`` is that kernel's, bit for bit."""
    B, chi, d, _, _ = _validate(Lt, W, Rt, x0)
    m = num_krylov_vecs
    _check_krylov(m)
    if x0.device.type == "cpu":
        return fused_lanczos_fact_plain(Lt, W, Rt, x0, m, delta)
    kw = dict(dtype=x0.dtype, device=x0.device)
    ring = torch.empty((B, 2, d, chi, chi), **kw)
    ab = torch.empty((B, 2, m), **kw)
    _launch_lanczos_grid("tn_fused_lanczos_fact", Lt, W, Rt, x0, m, delta,
                         (ring, ab))
    launch_counts["fused_lanczos_fact"] += 1
    return ab


def fused_lanczos_replay_plain(Lt, W, Rt, x0, weights, ab,
                               delta: float = 1e-8):
    """Plain-PyTorch twin of :func:`fused_lanczos_replay` (the same
    recurrence, coefficients read from ``ab``)."""
    return _replay_recurrence(lambda v: heff_matvec_plain(Lt, W, Rt, v), x0,
                              weights, ab, delta)


def _replay_recurrence(matvec, x0, weights, ab, delta: float):
    """:func:`_lanczos_recurrence` rerun with the coefficients ``ab`` of a
    first pass, around ``matvec(v) -> H v``: returns ``y = sum_j
    weights[:, j] v_j``."""
    m = ab.shape[-1]
    v, _ = _start(x0, delta)
    v_prev = torch.zeros_like(x0)
    y = torch.zeros_like(x0)
    for j in range(m):
        y = y + _bc(weights[:, j]) * v
        if j == m - 1:
            break
        w = matvec(v)
        # a dead step's +1e10 sentinel never reaches the update (its v is
        # zero); clamped all the same
        alpha = ab[:, 0, j]
        alpha = torch.where(alpha.abs() >= LARGE, 0.0, alpha)
        beta_prev = ab[:, 1, j - 1] if j > 0 else torch.zeros_like(alpha)
        w = w - _bc(alpha) * v - _bc(beta_prev) * v_prev
        beta = ab[:, 1, j]
        inv = torch.where(beta > delta,
                          1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
        v_prev = v
        v = w * _bc(inv)
    return y


def fused_lanczos_replay(Lt, W, Rt, x0, weights, ab, delta: float = 1e-8):
    """Pass 2 of the two-pass Lanczos: reruns :func:`fused_lanczos_fact`'s
    recurrence with its ``ab`` and returns ``y = sum_j weights[:, j] v_j``
    (B, d, chi, chi), unnormalised.  ``weights`` (B, m).  Counterpart of
    ``make_fused_lanczos_2pass``'s ``replay``.  It regenerates fact's
    basis bit for bit: with ``weights`` e_j it returns
    :func:`fused_lanczos_streamed`'s v_j."""
    B, chi, d, _, _ = _validate(Lt, W, Rt, x0)
    m = ab.shape[-1]
    _check_krylov(m)
    if ab.shape != (B, 2, m) or weights.shape != (B, m):
        raise ValueError(f"ab {tuple(ab.shape)} and weights "
                         f"{tuple(weights.shape)} must be (B, 2, m), (B, m)")
    ab, weights = ab.to(x0.dtype).contiguous(), weights.to(x0.dtype).contiguous()
    if x0.device.type == "cpu":
        return fused_lanczos_replay_plain(Lt, W, Rt, x0, weights, ab, delta)
    kw = dict(dtype=x0.dtype, device=x0.device)
    y = torch.empty((B, d, chi, chi), **kw)
    ring = torch.empty((B, 2, d, chi, chi), **kw)
    _launch_lanczos_grid("tn_fused_lanczos_replay", Lt, W, Rt, x0, m, delta,
                         (weights, ab, y, ring))
    launch_counts["fused_lanczos_replay"] += 1
    return y


# ---------------------------------------------------------------------------
# The f32 core of K7 and K8: 3xTF32 tensor-core GEMMs (csrc/gemm_tc32.cuh)
# ---------------------------------------------------------------------------

# the block tiles (BM, BN) of tc32::TileCode 0, 1, 2, largest first
_TC32_TILES = ((128, 128), (128, 64), (64, 64))


def tc32_tile(rows: int, cols: int, groups: int, sms: int) -> int:
    """The tile code of a GEMM stage of ``groups`` independent rows x cols
    outputs: the largest tile of :data:`_TC32_TILES` whose grid gives at
    least 7/8 of the ``sms`` SMs a block (one wave, less a tail that a
    larger tile's efficiency repays: at one-site chi=1024 stage 2 takes
    128 blocks of 128x128 on 132 SMs, faster on an H100 than 256 of
    128x64), else the smallest."""
    for code, (bm, bn) in enumerate(_TC32_TILES):
        if 8 * -(-rows // bm) * -(-cols // bn) * groups >= 7 * sms:
            return code
    return len(_TC32_TILES) - 1


def tc32_grids(chi: int, nt: int, M: int, B: int, K3: int,
               sms: int) -> Dict[str, Tuple[int, int, int]]:
    """The f32 streamed matvec's two GEMM stages: per stage (BM, BN,
    blocks).  Stage 1, P = Lt @ [x_0 .. x_nt-1], has (M chi) x chi outputs
    per (t, instance, chunk); stage 2, y_s = Q_s @ Rt, chi x chi per (s,
    instance)."""
    out = {}
    for stage, rows, groups in (("stage1", M * chi, nt * B * K3),
                                ("stage2", chi, nt * B)):
        bm, bn = _TC32_TILES[tc32_tile(rows, chi, groups, sms)]
        out[stage] = (bm, bn, -(-rows // bm) * -(-chi // bn) * groups)
    return out


def tf32_rna(a):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32``: half of the 13 dropped bits added to
    the magnitude on the int32 view, then the 13 bits cleared (finite
    inputs)."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul_plain(a, b):
    """Plain model of the kernels' 3xTF32 product ``a @ b`` (float32): each
    operand split into big = tf32(a) and small = tf32(a - big), and
    a_small b_big + a_big b_small + a_big b_big summed, small terms first
    (each product of TF32 values exact in float32).  Not called on any
    path; the CPU tests state the scheme's error with it."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    with highest_precision():
        return as_ @ bb + ab @ bs + ab @ bb


def _matvec_scratch(x, B: int, chi: int, nt: int, M: int, K3: int,
                    xl: bool):
    """Scratch of the streamed matvecs' C entry points: (P, Q, part,
    tile1, tile2).  f32 (gemm_tc32.cuh): P (B, K3, M chi, nt chi), Q (B,
    nt, chi, M chi), one <x, y> slot per stage-2 block.  f64 (heff.cuh's
    SIMT kernels): K7's Q (B, M nt, chi, chi) or K8's partial slots in P
    (B, K3, M nt, chi, chi), one slot per 64 x 64 output tile; the tiles
    are not read."""
    kw = dict(dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        sms = _sm_count(x.device)
        grids = tc32_grids(chi, nt, M, B, K3, sms)
        P = torch.empty((B, K3, M * chi, nt * chi), **kw)
        Q = torch.empty((B, nt, chi, M * chi), **kw)
        part = torch.empty((B, grids["stage2"][2] // B), **kw)
        tiles = [_TC32_TILES.index(grids[k][:2]) for k in ("stage1", "stage2")]
        return (P, Q, part, *tiles)
    ntl = -(-chi // _TILE)
    slots = torch.empty((B, K3, M * nt, chi, chi), **kw)
    part = torch.empty((B, nt * ntl * ntl), **kw)
    return (slots, None, part, 0, 0) if xl else (None, slots, part, 0, 0)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K7: one matvec returning <x, H x>; the recurrence runs around it
# ---------------------------------------------------------------------------


def streamed_matvec_plain(Lt, C, Rt, x):
    """Plain-PyTorch twin of :func:`streamed_matvec`: the stages of
    :func:`heff_matvec_plain` (the couplings folded into Q[v, s] after
    stage 1) with nt physical tiles, and <x, y>."""
    y = heff_matvec_plain(Lt, C, Rt, x)
    return y, _vdot(x, y)


def streamed_matvec(Lt, C, Rt, x):
    """One H_eff matvec with ``nt`` physical tiles and its Rayleigh
    quotient on kernel-layout operands: Lt, Rt (B, M, chi, chi), C (M, M,
    nt, nt) or (B, M, M, nt, nt), x (B, nt, chi, chi).  Returns ``(y (B,
    nt, chi, chi), alpha (B,))`` with alpha = <x, y> summed in the kernel.
    Counterpart of ``make_streamed_matvec``; its chunk counts (the TPU's
    VMEM plan) have no meaning here."""
    B, chi, nt, M, c_stride = _validate(Lt, C, Rt, x)
    if x.device.type == "cpu":
        return streamed_matvec_plain(Lt, C, Rt, x)
    P, Q, part, tile1, tile2 = _matvec_scratch(x, B, chi, nt, M, 1, False)
    y = torch.empty_like(x)
    alpha = torch.empty((B,), dtype=x.dtype, device=x.device)
    _launch("tn_streamed_matvec", x.dtype, x.device,
            C.data_ptr(), c_stride, Lt.data_ptr(), Rt.data_ptr(),
            x.data_ptr(), _ptr(P), _ptr(Q), y.data_ptr(), part.data_ptr(),
            alpha.data_ptr(), B, chi, nt, M, tile1, tile2)
    launch_counts["streamed_matvec"] += 1
    return y, alpha


# ---------------------------------------------------------------------------
# K8: the same matvec with the contraction of stage 1 split into K3 chunks
# ---------------------------------------------------------------------------

_XL_MIN_CHUNK = 32   # tc32::BK: a chunk holds at least one ring stage
_H100_SMS = 132      # the tile and K3 rules' SM count for CPU tensors


def xl_chunk_count(chi: int, nt: int, M: int, B: int, sms: int) -> int:
    """K3 of :func:`streamed_matvec_xl`: the smallest power of two that
    divides ``chi`` and gives stage 1 (one block per 128 x 128 tile of the
    (M chi) x (nt chi) product, contraction chunk and instance) at least
    two blocks per SM -- two waves, one such block fitting an SM; where
    none does, the largest with chunks of at least 32 rows.  On 132 SMs at
    M=3, B=1: 1 at two-site chi=1024 (768 blocks) and one-site chi=2048
    (1536), where the function is :func:`streamed_matvec`'s."""
    bm, bn = _TC32_TILES[0]
    tiles = -(-M * chi // bm) * nt * -(-chi // bn)
    counts = list(_chunk_counts(chi, _XL_MIN_CHUNK)) or [1]
    for K3 in counts:
        if tiles * K3 * B >= 2 * sms:
            return K3
    return counts[-1]


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return _H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def streamed_matvec_xl_plain(Lt, C, Rt, x, K3: int):
    """Plain-PyTorch twin of :func:`streamed_matvec_xl`, in the kernel's
    order: for each of the K3 contraction chunks the chunk's products
    L_w x_t, summed in chunk order into P; then the fold Q[v, s] = sum_{w,t}
    C[w, v, s, t] P[w, t], y_s = sum_v Q[v, s] R_v and <x, y>.  With K3 = 1
    these are :func:`heff_matvec_plain`'s steps."""
    chi = x.shape[-1]
    a = chi // K3
    P = None
    for k in range(K3):
        sl = slice(k * a, (k + 1) * a)
        Pk = torch.matmul(Lt[:, :, None, :, sl], x[:, None, :, sl, :])
        P = Pk if P is None else P + Pk
    Q = torch.einsum(f"{_wspec(C)},Bwtcb->Bvscb", C, P)
    y = torch.matmul(Q, Rt[:, :, None]).sum(1)
    return y, _vdot(x, y)


def streamed_matvec_xl(Lt, C, Rt, x, K3: Optional[int] = None):
    """:func:`streamed_matvec`'s function -- (y, alpha = <x, y>) from the
    same kernel-layout operands -- with the contraction of stage 1 split
    into ``K3`` chunks, each written to its own partial slot in device
    memory, and the slots summed in chunk order (in f32 by the fold pass,
    in f64 by the GEMM stage).  ``K3`` (dividing chi) defaults to
    :func:`xl_chunk_count` for the tensors' card.  Counterpart of
    ``make_streamed_matvec_xl``; its row and column chunk counts (the
    TPU's VMEM plan) have no meaning here."""
    B, chi, nt, M, c_stride = _validate(Lt, C, Rt, x)
    if K3 is None:
        K3 = xl_chunk_count(chi, nt, M, B, _sm_count(x.device))
    if K3 < 1 or chi % K3:
        raise ValueError(f"K3={K3} must be >= 1 and divide chi={chi}")
    if x.device.type == "cpu":
        return streamed_matvec_xl_plain(Lt, C, Rt, x, K3)
    P, Q, part, tile1, tile2 = _matvec_scratch(x, B, chi, nt, M, K3, True)
    y = torch.empty_like(x)
    alpha = torch.empty((B,), dtype=x.dtype, device=x.device)
    _launch("tn_streamed_matvec_xl", x.dtype, x.device,
            C.data_ptr(), c_stride, Lt.data_ptr(), Rt.data_ptr(),
            x.data_ptr(), _ptr(P), _ptr(Q), y.data_ptr(), part.data_ptr(),
            alpha.data_ptr(), B, chi, nt, M, K3, tile1, tile2)
    launch_counts["streamed_matvec_xl"] += 1
    return y, alpha


def streamed_lanczos(Lt, C, Rt, xt, num_krylov_vecs: int,
                     delta: float = 1e-8,
                     matvec: Optional[Callable] = None):
    """Plain three-term Lanczos with the recurrence in PyTorch around
    ``matvec(Lt, C, Rt, v) -> (H v, <v, H v>)``: :func:`streamed_matvec`
    (K7, the default) or :func:`streamed_matvec_xl` (K8) -- the JAX
    package's ``_streamed_lanczos_core`` without and with ``K3``.  Returns
    ``(V, ab)`` as :func:`fused_lanczos` (+1e10 alpha sentinels, zeroed
    betas and vectors on dead steps); with C as W, its plain twin is
    :func:`fused_lanczos_plain`."""
    _check_krylov(num_krylov_vecs)
    matvec = streamed_matvec if matvec is None else matvec
    return _lanczos_recurrence(lambda v: matvec(Lt, C, Rt, v), xt,
                               num_krylov_vecs, delta)


# ---------------------------------------------------------------------------
# Ground-state wrappers (solver layout), one per tier
# ---------------------------------------------------------------------------


def _normalized(y, delta: float):
    """Normalise kernel-layout (B, t, a, b) vectors and return them in
    solver layout (B, a, t, b)."""
    nrm = torch.sqrt((y * y).sum(dim=(1, 2, 3), keepdim=True))
    return (y / torch.where(nrm > delta, nrm, 1.0)).permute(0, 2, 1, 3)


def _ritz_pair(V, ab, ritz_method: str, power_iters: int, delta: float):
    m = ab.shape[-1]
    evals, weights = krylov.tridiag_ritz(ab[:, 0, :], ab[:, 1, :m - 1],
                                         ritz_method, power_iters)
    y = torch.einsum("Bm,Bmtab->Btab", weights.to(V.dtype), V)
    return evals, _normalized(y, delta)


def fused_lanczos_ground_state(L, W, R, x0, num_krylov_vecs: int,
                               ritz_method: str = "power",
                               power_iters: int = 60,
                               delta: float = 1e-8,
                               two_pass: bool = False):
    """Batched ground-state Lanczos through :func:`fused_lanczos` or, with
    ``two_pass``, through :func:`fused_lanczos_fact` and
    :func:`fused_lanczos_replay` (no basis stored).

    Solver-layout operands: L (B, a, M, c), W (M, M, d, d) or
    (B, M, M, d, d), R (B, b, M, d), x0 (B, a, t, b).  Returns ``(evals
    (B,), evecs (B, a, t, b))``, the smallest Ritz pair per instance, as
    ``krylov.eigsh_lanczos(..., numeig=1, reorthogonalize=False)``."""
    m = num_krylov_vecs
    with tracing.span("lanczos"):
        Lt, W, Rt, xt = prepare_operands(L, W.contiguous(), R, x0)
        if two_pass:
            ab = fused_lanczos_fact(Lt, W, Rt, xt, m, delta)
        else:
            V, ab = fused_lanczos(Lt, W, Rt, xt, m, delta)
    if not two_pass:
        return _ritz_pair(V, ab, ritz_method, power_iters, delta)
    evals, weights = krylov.tridiag_ritz(ab[:, 0, :], ab[:, 1, :m - 1],
                                         ritz_method, power_iters)
    with tracing.span("lanczos"):
        y = fused_lanczos_replay(Lt, W, Rt, xt, weights, ab, delta)
    return evals, _normalized(y, delta)


def fused_lanczos_ground_state_streamed(L, W, R, x0, num_krylov_vecs: int,
                                        ritz_method: str = "power",
                                        power_iters: int = 60,
                                        delta: float = 1e-8):
    """:func:`fused_lanczos_ground_state` through
    :func:`fused_lanczos_streamed` (same operands and returns).  The JAX
    package's ``n_chunks`` has no meaning on the card and is not taken."""
    with tracing.span("lanczos"):
        Lt, W, Rt, xt = prepare_operands(L, W.contiguous(), R, x0)
        V, ab = fused_lanczos_streamed(Lt, W, Rt, xt, num_krylov_vecs, delta)
    return _ritz_pair(V, ab, ritz_method, power_iters, delta)


def fused_lanczos_ground_state_streamed2(L, W, R, x0, num_krylov_vecs: int,
                                         ritz_method: str = "eigh",
                                         power_iters: int = 60,
                                         delta: float = 1e-8,
                                         xl: bool = False):
    """One-site ground-state Lanczos through :func:`streamed_lanczos`
    (operands and returns of :func:`fused_lanczos_ground_state`): the
    chi=1024 tier on :func:`streamed_matvec`, or with ``xl`` the chi=2048
    tier on :func:`streamed_matvec_xl`.  The JAX package's ``plan`` (its
    VMEM chunking) has no meaning on the card and is not taken."""
    with tracing.span("lanczos"):
        Lt, W, Rt, xt = prepare_operands(L, W.contiguous(), R, x0)
        V, ab = streamed_lanczos(
            Lt, W, Rt, xt, num_krylov_vecs, delta,
            streamed_matvec_xl if xl else streamed_matvec)
    return _ritz_pair(V, ab, ritz_method, power_iters, delta)


def fuse_mpo_pair(W1, W2):
    """The two-site couplings ``C[w, v, (s, u), (t, z)] = sum_m W1[w, m, s,
    t] W2[m, v, u, z]``, (M, M, d*d, d*d) (or with a leading batch axis
    on both).  Computed in full fp32 (:func:`highest_precision`): a TF32
    product would put ~1e-3 of error into every coupling, as the JAX
    package measured for its bf16 default on the TPU."""
    M, d = W1.shape[-4], W1.shape[-1]
    with highest_precision():
        C = torch.einsum("...wmst,...mvuz->...wvsutz", W1, W2)
    return C.reshape(C.shape[:-6] + (M, M, d * d, d * d)).contiguous()


def prepare_operands_2s(L, W1, W2, R, x0):
    """Solver-layout two-site operands -> kernel layout (Lt, C, Rt, xt)
    with nt = d*d tiles and the couplings of :func:`fuse_mpo_pair`; x0
    (B, a, t, z, b)."""
    B, chi, d = x0.shape[0], x0.shape[1], x0.shape[2]
    return prepare_operands(L, fuse_mpo_pair(W1, W2), R,
                            x0.reshape(B, chi, d * d, chi))


def fused_lanczos_ground_state_2s(L, W1, W2, R, x0, num_krylov_vecs: int,
                                  ritz_method: str = "power",
                                  power_iters: int = 60,
                                  delta: float = 1e-8):
    """Two-site batched ground-state Lanczos through :func:`fused_lanczos`
    with nt = d*d tiles and the MPO pair pre-fused
    (:func:`fuse_mpo_pair`).  Operands: L (B, a, M, c), W1/W2 (M, M, d,
    d), R (B, b, M, d), x0 (B, a, t, z, b).  Returns ``(evals (B,), evecs
    (B, a, t, z, b))``.  Counterpart of the JAX package's
    ``fused_lanczos_ground_state_2s``."""
    with tracing.span("lanczos"):
        Lt, C, Rt, xt = prepare_operands_2s(L, W1, W2, R, x0)
        V, ab = fused_lanczos(Lt, C, Rt, xt, num_krylov_vecs, delta)
    evals, y = _ritz_pair(V, ab, ritz_method, power_iters, delta)
    return evals, y.reshape(x0.shape)


def fused_lanczos_ground_state_2s_streamed(L, W1, W2, R, x0,
                                           num_krylov_vecs: int,
                                           ritz_method: str = "eigh",
                                           power_iters: int = 60,
                                           delta: float = 1e-8,
                                           xl: bool = False):
    """:func:`fused_lanczos_ground_state_2s` (same operands and returns)
    with the recurrence in PyTorch around :func:`streamed_matvec` (the
    chi=128...512 tier) or, with ``xl``, :func:`streamed_matvec_xl` (the
    chi=1024 tier).  Counterpart of the JAX package's
    ``fused_lanczos_ground_state_2s_streamed``; its ``plan`` has no
    meaning on the card."""
    with tracing.span("lanczos"):
        Lt, C, Rt, xt = prepare_operands_2s(L, W1, W2, R, x0)
        V, ab = streamed_lanczos(
            Lt, C, Rt, xt, num_krylov_vecs, delta,
            streamed_matvec_xl if xl else streamed_matvec)
    evals, y = _ritz_pair(V, ab, ritz_method, power_iters, delta)
    return evals, y.reshape(x0.shape)


# ---------------------------------------------------------------------------
# K10: the power Ritz step of the tridiagonal projections, one launch
# ---------------------------------------------------------------------------

_RITZ_MAX_M = 64  # one warp an instance, two entries a lane


def _ritz_rows(t, B: int, n: int):
    """``t`` as (B, n) rows with unit stride along a row (copied only
    where it has none), and the row stride in elements."""
    t = t.reshape(B, n)
    if n > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def tridiag_ritz_power(alphas, betas, power_iters: int = 60):
    """K10: ``krylov.tridiag_ritz(alphas, betas, "power", power_iters)``
    in one launch, all iterations of every instance.  ``alphas`` (..., m),
    ``betas`` (..., m-1), real f32 or f64 on one CUDA device, m <= 64; any
    leading shape (flattened), strided rows taken as they are.  Returns
    ``(lam (...,), w (..., m))``.  CPU tensors run the twin,
    :func:`krylov.tridiag_ritz_power_plain`."""
    if alphas.device.type == "cpu" and betas.device.type == "cpu":
        return krylov.tridiag_ritz_power_plain(alphas, betas, power_iters)
    if alphas.device != betas.device or alphas.device.type != "cuda":
        raise ValueError(f"tridiag_ritz_power: alphas on {alphas.device}, "
                         f"betas on {betas.device}; both on one CUDA device")
    dtype = alphas.dtype
    if dtype not in _TYPES["tn_tridiag_ritz"] or betas.dtype != dtype:
        raise TypeError(f"tridiag_ritz_power takes real float32 or float64 "
                        f"alphas and betas of one dtype, not {dtype} and "
                        f"{betas.dtype}")
    m, lead = alphas.shape[-1], alphas.shape[:-1]
    if not 1 <= m <= _RITZ_MAX_M or betas.shape != lead + (m - 1,):
        raise ValueError(f"tridiag_ritz_power takes alphas (..., m), m <= "
                         f"{_RITZ_MAX_M}, and betas (..., m-1): got "
                         f"{tuple(alphas.shape)} and {tuple(betas.shape)}")
    lam = torch.empty(lead, dtype=dtype, device=alphas.device)
    w = torch.empty(lead + (m,), dtype=dtype, device=alphas.device)
    B = lam.numel()
    if B == 0:
        return lam, w
    a, sa = _ritz_rows(alphas, B, m)
    b, sb = _ritz_rows(betas, B, m - 1)
    _launch("tn_tridiag_ritz", dtype, alphas.device, a.data_ptr(), sa,
            b.data_ptr(), sb, lam.data_ptr(), w.data_ptr(), B, m,
            int(power_iters))
    launch_counts["tridiag_ritz"] += 1
    return lam, w


# ---------------------------------------------------------------------------
# K5: the fused gauge-and-environment epilogue of the one-site sweep
# ---------------------------------------------------------------------------

_QUINTIC = (3.4445, -4.7750, 2.0315)  # the Newton-Schulz quintic coefficients


def gauge_epilogue_admitted(chi: int, d: int, M: int) -> bool:
    """Whether the one-site sweep takes the fused epilogue (K5) at bond
    dimension ``chi``: ``4 chi^2 (2M + 4d + 2Md) <= 12 MiB``.  This is the
    JAX package's TPU VMEM admission (``vmem.admit_gauge_epilogue``), copied
    and kept for parity, so that both packages take the same route at the
    same shape: at d=2, M=3 it admits chi <= 347 (chi=64 and 256 run K5,
    chi >= 384 the gauge factorization and the env einsums).  It says
    nothing of the card; re-picking it from the card's times belongs with
    the tier thresholds (ROADMAP)."""
    return 4 * chi * chi * (2 * M + 4 * d + 2 * M * d) <= _RESIDENT_BYTES


# the resident route (csrc/fused_gauge_env.cu, namespace res): chi padded
# to a multiple of 32, instances up to 128, and the bytes of its footprint
_GAUGE_GRAN, _GAUGE_MAX_CP, _GAUGE_RED_BYTES = 32, 128, 272
_GAUGE_SEG = 4096  # the grid route's norm segment: SEG = THREADS * 16


def _gauge_cp(chi: int) -> int:
    """chi padded with zeros to the resident route's multiple of 32."""
    return -(-chi // _GAUGE_GRAN) * _GAUGE_GRAN


def gauge_env_resident_bytes(chi: int, d: int, M: int) -> int:
    """Shared memory of one block of K5's resident route (``res::smem_bytes``
    in ``csrc/fused_gauge_env.cu``): at chi padded to CP, a multiple of 32,
    the panel X (d CP rows at pitch CP + 8), G (CP rows at pitch CP + 4),
    the M^2 d^2 couplings and 272 bytes of block sums."""
    cp = _gauge_cp(chi)
    return _GAUGE_RED_BYTES + 4 * (d * cp * (cp + 8) + cp * (cp + 4)
                                   + M * M * d * d)


def gauge_env_resident_fits(chi: int, d: int, M: int, dtype: torch.dtype) -> bool:
    """Whether K5's resident route takes the shape: f32, chi <= 128 and
    :func:`gauge_env_resident_bytes` <= 232,448."""
    return (dtype == torch.float32 and _gauge_cp(chi) <= _GAUGE_MAX_CP
            and gauge_env_resident_bytes(chi, d, M) <= _SMEM_BYTES)


# The least batch at which the resident route beats the grid route, by
# padded chi: one instance is one SM's work there, while the grid route
# spreads it over the card.  benchmarks/k5_routes.py, d=2, M=3, on an
# H100 80GB HBM3 at 700 W: resident / grid ms at chi=96 B=4 0.782 / 0.668,
# B=8 0.786 / 1.063; at chi=128 B=32 1.572 / 1.475, B=64 1.605 / 2.036;
# at chi <= 64 the resident route wins from B=1 (0.303 / 0.464 at chi=64).
_GAUGE_MIN_BATCH = {96: 8, 128: 64}


def gauge_env_route(chi: int, d: int, M: int, dtype: torch.dtype,
                    batch: Optional[int] = None) -> str:
    """The kernel route of :func:`fused_gauge_env` for CUDA tensors:
    ``"resident"`` -- f32 whose panel, G and couplings fit one block's
    shared memory (:func:`gauge_env_resident_bytes` <= 232,448 bytes, chi
    <= 128; d=2, M=3: chi <= 128, the sweep's chi=64 at two blocks an SM),
    one block per instance, at a ``batch`` (when given) of at least 8
    instances at chi padded to 96 and 64 at 128 -- else ``"grid"`` (the
    cooperative launch over the whole batch; every f64 call)."""
    if not gauge_env_resident_fits(chi, d, M, dtype) or (
            batch is not None
            and batch < _GAUGE_MIN_BATCH.get(_gauge_cp(chi), 1)):
        return "grid"
    return "resident"


def polar_iters(dtype: torch.dtype) -> Tuple[int, int]:
    """(quintic, cubic) Newton-Schulz steps of the fused epilogue: (14, 7)
    in float32, (20, 10) in float64, as the JAX package's sweep takes."""
    return (14, 7) if dtype == torch.float32 else (20, 10)


def _validate_gauge_env(W, E, A) -> Tuple[int, int, int, int]:
    """Shapes, dtypes, devices and contiguity K5 takes; returns (B, chi, d,
    M)."""
    if A.dim() != 3 or E.dim() != 4 or W.dim() != 4:
        raise ValueError("W (M,M,d,d), E (B,M,chi,chi) and A (B,d*chi,chi) "
                         "expected; K5 takes one W shared by the batch")
    B, dchi, chi = A.shape
    M, d = E.shape[1], W.shape[-1]
    if (dchi != d * chi or E.shape != (B, M, chi, chi)
            or W.shape != (M, M, d, d)):
        raise ValueError(f"shape mismatch: W {tuple(W.shape)}, E "
                         f"{tuple(E.shape)}, A {tuple(A.shape)}")
    if M * M * d * d > _MAX_COUPLINGS:
        raise ValueError(f"{M * M * d * d} couplings exceed the kernel's "
                         f"{_MAX_COUPLINGS}")
    ts = (W, E, A)
    if A.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != A.dtype for t in ts):
        raise TypeError("W, E, A must share one dtype, float32 or float64; "
                        f"got {[t.dtype for t in ts]}")
    if any(t.device != A.device for t in ts):
        raise ValueError("W, E, A must lie on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("W, E, A must be contiguous")
    return B, chi, d, M


def fused_gauge_env_plain(W, E, A, quintic_iters: int = 14,
                          cubic_iters: int = 7):
    """Plain-PyTorch twin of :func:`fused_gauge_env` (the TPU kernel's
    steps, in its order)."""
    B, dchi, chi = A.shape
    d = dchi // chi
    qa, qb, qc = _QUINTIC
    with highest_precision():
        nrm = torch.sqrt((A * A).sum(dim=(1, 2), keepdim=True))
        X = A * (1.0 / (nrm * 1.01 + 1e-30))
        for _ in range(quintic_iters):
            G = X.mT @ X
            X = qa * X + X @ (qb * G + qc * (G @ G))
        for _ in range(cubic_iters):
            G = X.mT @ X
            X = 1.5 * X - 0.5 * (X @ G)
        P = X.mT @ A
        Xs = X.reshape(B, d, chi, chi)
        U = torch.einsum("Btar,Bwac->Bwtrc", Xs, E)          # X_t^T E_w
        Qvs = torch.einsum("wvst,Bwtrc->Bvsrc", W, U)
        Enew = torch.einsum("Bvsrc,Bscp->Bvrp", Qvs, Xs)
    return X, P, Enew


def fused_gauge_env(W, E, A, quintic_iters: int = 14, cubic_iters: int = 7,
                    route: Optional[str] = None):
    """The fused epilogue on kernel-layout operands: W (M, M, d, d) shared
    by the batch, E (B, M, chi, chi) [w](in, out), A (B, d*chi, chi) with
    rows s-major.  Newton-Schulz polar of each panel (``quintic_iters``
    quintic then ``cubic_iters`` cubic steps), P = X^T A and the grown
    environment; returns ``(Q (B, d*chi, chi), P (B, chi, chi), Enew (B, M,
    chi, chi))``.  Counterpart of ``make_fused_gauge_env``.  CUDA tensors
    take the kernel route :func:`gauge_env_route` picks, or ``route``
    ("resident" or "grid", to time one against the other)."""
    B, chi, d, M = _validate_gauge_env(W, E, A)
    if route not in (None, "resident", "grid"):
        raise ValueError(f"unknown route {route!r}")
    if A.device.type == "cpu":
        return fused_gauge_env_plain(W, E, A, quintic_iters, cubic_iters)
    if route is None:
        route = gauge_env_route(chi, d, M, A.dtype, B)
    if route == "resident" and not gauge_env_resident_fits(chi, d, M, A.dtype):
        raise ValueError(f"the resident route does not take chi={chi}, d={d}, "
                         f"M={M}, {A.dtype}")
    kw = dict(dtype=A.dtype, device=A.device)
    Q, P = torch.empty_like(A), torch.empty((B, chi, chi), **kw)
    Enew = torch.empty((B, M, chi, chi), **kw)
    U = torch.empty((B, M * d, chi, chi), **kw)
    if route == "grid":
        X2 = torch.empty_like(A)
        G, Mx = (torch.empty((B, chi, chi), **kw) for _ in range(2))
        part = torch.empty((B, -(-(d * chi * chi) // _GAUGE_SEG)), **kw)
    else:   # the panel and its iterates stay in shared memory
        X2 = G = Mx = part = None
    _launch_grid("tn_fused_gauge_env", A.dtype, A.device,
                 *(_ptr(t) for t in (W, E, A, Q, P, Enew, X2, G, Mx, U,
                                     part)),
                 B, chi, d, M, quintic_iters, cubic_iters,
                 int(route == "resident"))
    launch_counts["fused_gauge_env"] += 1
    route_counts["fused_gauge_env_" + route] += 1
    return Q, P, Enew


def fused_gauge_env_left(L, W, A, quintic_iters: int = 14,
                         cubic_iters: int = 7):
    """Batched left-moving epilogue: ``A = Q Rm`` (Q left-isometric) and
    ``Lnew = update_left(L, Q, W)``.  Solver layouts: L (B, a, M, c), W
    (M, M, s, t), A (B, a, s, b).  Returns ``(Q (B, a, s, r), Rm (B, r,
    b), Lnew (B, r, M, p))``.  Counterpart of the JAX package's
    ``fused_gauge_env_left``."""
    B, chi, M, _ = L.shape
    d = A.shape[2]
    E = L.permute(0, 2, 1, 3).contiguous()                   # [w](a, c)
    Ap = A.permute(0, 2, 1, 3).reshape(B, d * chi, chi)      # rows (s, a)
    Qp, P, Enew = fused_gauge_env(W.contiguous(), E, Ap.contiguous(),
                                  quintic_iters, cubic_iters)
    Q = Qp.reshape(B, d, chi, chi).permute(0, 2, 1, 3)
    return Q, P, Enew.permute(0, 2, 1, 3)


def fused_gauge_env_right(R, W, A, quintic_iters: int = 14,
                          cubic_iters: int = 7):
    """Batched right-moving epilogue: ``A = Lm Q`` (Q right-isometric) and
    ``Rnew = update_right(R, Q, W)``.  Solver layouts: R (B, b, M, d), W
    (M, M, s, t), A (B, a, s, b).  Returns ``(Q (B, l, s, b), Lm (B, a,
    l), Rnew (B, l, M, p))``.  The kernel sums the first coupling index
    and emits the second; update_right sums v and emits w, so W's bond
    pair is swapped.  Counterpart of the JAX package's
    ``fused_gauge_env_right``."""
    B, chi, M, _ = R.shape
    d = A.shape[2]
    E = R.permute(0, 2, 1, 3).contiguous()                   # [v](b, d)
    Ap = A.permute(0, 2, 3, 1).reshape(B, d * chi, chi)      # rows (t, b)
    Weff = W.permute(1, 0, 2, 3).contiguous()
    Qp, P, Enew = fused_gauge_env(Weff, E, Ap.contiguous(), quintic_iters,
                                  cubic_iters)
    Q = Qp.reshape(B, d, chi, chi).permute(0, 3, 1, 2)
    return Q, P.mT, Enew.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# K6: the batched MPS transfer chain
# ---------------------------------------------------------------------------

_CHAIN_GRAN = 16        # transfer_chain.cu GRAN: the bf16 kernels' chi step


def _chain_chi(chi: int, dtype: torch.dtype) -> int:
    """The chi the kernels run at: bf16 padded with zeros to a multiple of
    16 (the m16n8k16 fragment), f32 as it is."""
    if dtype == torch.bfloat16:
        return -(-chi // _CHAIN_GRAN) * _CHAIN_GRAN
    return chi


def transfer_chain_route(chi: int, d: int, dtype: torch.dtype) -> str:
    """The kernel route of :func:`transfer_chain` for CUDA tensors:
    ``"resident"`` -- bf16 whose T(E), two site tensors and Y, (1 + 3d)
    chi^2 elements at the padded chi, fit one block's shared memory (d=2:
    chi <= 128, the bench shape) -- else ``"tiled"`` (two batched GEMM
    launches per site; every f32 chain)."""
    c = _chain_chi(chi, dtype)
    if dtype == torch.bfloat16 and (1 + 3 * d) * c * c * 2 <= _SMEM_BYTES:
        return "resident"
    return "tiled"


def transfer_chain_plain(As, E0, accum_dtype: torch.dtype = torch.float32):
    """The chain ``E <- sum_{a,c,s} E[a,c] A_n[a,s,b] A_n[c,s,p]`` over all
    sites in PyTorch: the counterpart of the JAX package's
    ``transfer_chain_xla`` and the twin of :func:`transfer_chain`'s kernel.
    It rounds where the TPU kernel rounds: E is carried in
    ``accum_dtype`` and cast to the input type before stage 1 at every
    site, the stage-1 product Y is cast to the input type before stage 2,
    and the products accumulate in ``accum_dtype`` (the input is widened,
    so a bf16 x bf16 product is exact)."""
    in_dt = As.dtype
    E = E0.to(accum_dtype)
    with highest_precision():
        for n in range(As.shape[1]):
            A = As[:, n].to(accum_dtype)                      # (B, a, s, b)
            Eb = E.to(in_dt).to(accum_dtype)
            Y = torch.einsum("Bac,Basb->Bscb", Eb, A).to(in_dt).to(accum_dtype)
            E = torch.einsum("Bscb,Bcsp->Bbp", Y, A)
    return E


def transfer_chain(As, E0, impl: str = "kernel",
                   accum_dtype: torch.dtype = torch.float32):
    """Batched MPS norm/overlap environment over a whole chain.  As (B, N,
    chi, d, chi) stacked MPS (solver layout), E0 (B, chi, chi); returns E_N
    (B, chi, chi) in ``accum_dtype``.

    ``impl="kernel"`` launches K6 for CUDA tensors (bf16 or float32 in,
    float32 accumulation, any chi and d) on the route
    :func:`transfer_chain_route` picks, and runs its twin for CPU tensors;
    ``impl="plain"`` is :func:`transfer_chain_plain`.  Counterpart of the
    JAX package's ``transfer_chain``; its ``tile_b``, ``variant`` and
    ``interpret`` choose the layout of the TPU program and are not taken
    (the variants compute one function)."""
    if impl == "plain":
        return transfer_chain_plain(As, E0, accum_dtype)
    if impl != "kernel":
        raise ValueError(f"unknown impl {impl!r}")
    if As.dim() != 5 or As.shape[2] != As.shape[4]:
        raise ValueError(f"As must be (B, N, chi, d, chi), got {tuple(As.shape)}")
    B, N, chi, d, _ = As.shape
    if E0.shape != (B, chi, chi):
        raise ValueError(f"E0 must be {(B, chi, chi)}, got {tuple(E0.shape)}")
    if As.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"As must be bfloat16 or float32, got {As.dtype}")
    if E0.device != As.device:
        raise ValueError("As and E0 must lie on one device")
    if As.device.type == "cpu":
        return transfer_chain_plain(As, E0, accum_dtype)
    if accum_dtype != torch.float32:
        raise TypeError("the kernel accumulates in float32")
    route = transfer_chain_route(chi, d, As.dtype)
    c = _chain_chi(chi, As.dtype)
    As, E0 = As.contiguous(), E0.to(torch.float32).contiguous()
    if c != chi:   # zero rows and columns leave every sum unchanged
        As = torch.nn.functional.pad(As, (0, c - chi, 0, 0, 0, c - chi))
        E0 = torch.nn.functional.pad(E0, (0, c - chi, 0, c - chi))
    if As.data_ptr() % 16:   # 16-byte cp.async of the site tensors
        As = As.clone()
    out = torch.empty((B, c, c), dtype=torch.float32, device=As.device)
    tiled = route == "tiled"
    # the tiled route's T(E0) and scratch: T(E) and Y of a site
    Et, Ebuf, Ybuf = ((E0.to(As.dtype),
                       torch.empty((B, c, c), dtype=As.dtype, device=As.device),
                       torch.empty((B, c, d, c), dtype=As.dtype,
                                   device=As.device))
                      if tiled else (None, None, None))
    _launch("tn_transfer_chain", As.dtype, As.device, As.data_ptr(),
            E0.data_ptr(), _ptr(Et), _ptr(Ebuf), _ptr(Ybuf), out.data_ptr(),
            B, N, c, d, int(tiled))
    launch_counts["transfer_chain"] += 1
    route_counts["transfer_chain_" + route] += 1
    return out if c == chi else out[:, :chi, :chi].contiguous()


# ---------------------------------------------------------------------------
# K9: chained bf16 GEMMs (the issue-rate probe's kernel)
# ---------------------------------------------------------------------------


def gemm_chain_plain(x, b, c, reps: int):
    """Plain-PyTorch twin of :func:`gemm_chain`: each product in float32
    on the widened operands (exact bf16 x bf16 products), rounded to the
    input type."""
    with highest_precision():
        bf, cf = b.float(), c.float()
        for _ in range(reps):
            y = (x.float() @ bf).to(x.dtype)
            x = (y.float() @ cf).to(x.dtype)
    return x


# the wgmma route (csrc/gemm_chain.cu, namespace wg): a 128-byte swizzle
# span of 64 bf16 columns, at most 4 ring stages, the barriers and the
# alignment slack of its dynamic shared memory
_WG_SPAN, _WG_MAX_STAGES = 64, 4
_WG_FIXED_BYTES = 1024 + 8 * (1 + 2 * _WG_MAX_STAGES)


class ChainPlan(NamedTuple):
    """The wgmma route's plan of one (M, K, N): b and c ``"resident"`` or
    ``"streamed"`` through a ring of ``stages`` slabs ``kd`` rows deep;
    the output chunk (one wgmma's N) of each product, ``nc1`` of x @ b
    (N wide) and ``nc2`` of y @ c (K wide); the block's dynamic shared
    memory."""
    mode: str
    kd: int
    stages: int
    nc1: int
    nc2: int
    smem_bytes: int


def _chain_chunk(width: int) -> int:
    return 256 if width % 256 == 0 else 128 if width % 128 == 0 else 64


def gemm_chain_plan(M: int, K: int, N: int) -> Optional[ChainPlan]:
    """The wgmma route's plan, the one place that picks its slab depth and
    ring stages (``csrc/gemm_chain.cu`` lays them out, ``wg::smem_bytes``),
    or None where the route does not take the shape (M % 32, K % 64 or N %
    64 not 0, or no plan fits 232,448 bytes).  The panels x (64 x K) and y
    (64 x N) take 128 (K + N) bytes; b and c stay resident (4 K N bytes,
    64-deep slabs) where they fit beside them, else stream through the
    deepest ring of 64-deep slabs, then of 32-deep, that holds at least 2
    stages (at most 4) of the wider chunk's slab."""
    if M % 32 or K % _WG_SPAN or N % _WG_SPAN:
        return None
    nc1, nc2 = _chain_chunk(N), _chain_chunk(K)
    fixed = _WG_FIXED_BYTES + 128 * (K + N)
    if fixed + 4 * K * N <= _SMEM_BYTES:
        return ChainPlan("resident", 64, 0, nc1, nc2, fixed + 4 * K * N)
    for kd in (64, 32):
        slot = 2 * kd * max(nc1, nc2)
        stages = min(_WG_MAX_STAGES, (_SMEM_BYTES - fixed) // slot)
        if stages >= 2:
            return ChainPlan("streamed", kd, stages, nc1, nc2,
                             fixed + stages * slot)
    return None


def gemm_chain_route(M: int, K: int, N: int, P: int) -> str:
    """The kernel route of :func:`gemm_chain` for CUDA tensors: ``"wgmma"``
    (TMA + mbarrier + ``wgmma``, one block per 64-row panel) wherever
    :func:`gemm_chain_plan` has a plan -- every shape of the probe's
    ladder -- else ``"wmma"`` (the shapes the wrapper admits with K or N
    not a multiple of 64, or panels too wide for the plan)."""
    del P  # the same route for any number of chains
    return "wgmma" if gemm_chain_plan(M, K, N) is not None else "wmma"


def gemm_chain(x, b, c, reps: int, route: Optional[str] = None):
    """P independent chains ``y = bf16(x @ b); x = bf16(y @ c)``, ``reps``
    times, on x (P, M, K), b (K, N), c (N, K), bfloat16, float32
    accumulation; returns the last x (P, M, K).  The kernel takes M % 32 ==
    0 and K, N % 16 == 0, on the route :func:`gemm_chain_route` picks or
    ``route`` ("wgmma" or "wmma", to time one against the other).
    Counterpart of the Pallas program of the repo's
    ``benchmarks/mxu_micro.py`` ``make_chain_kernel`` (which sums |x| after
    it; :mod:`tensornetwork_tpu_torch.benchmarks.mxu_micro` does the
    same)."""
    if x.dim() != 3 or b.dim() != 2 or c.dim() != 2:
        raise ValueError("x (P, M, K), b (K, N), c (N, K) expected")
    P, M, K = x.shape
    N = b.shape[1]
    if b.shape != (K, N) or c.shape != (N, K):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    ts = (x, b, c)
    if any(t.dtype not in _TYPES["tn_gemm_chain"] for t in ts):
        raise TypeError(f"x, b, c must be bfloat16, got {[t.dtype for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("x, b, c must lie on one device")
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if route not in (None, "wgmma", "wmma"):
        raise ValueError(f"unknown route {route!r}")
    if x.device.type == "cpu":
        return gemm_chain_plain(x, b, c, reps)
    if M % 32 or K % 16 or N % 16:
        raise ValueError(f"the kernel takes M % 32 == 0 and K, N % 16 == 0; "
                         f"got M={M}, K={K}, N={N}")
    if route is None:
        route = gemm_chain_route(M, K, N, P)
    plan = gemm_chain_plan(M, K, N)
    if route == "wgmma" and plan is None:
        raise ValueError(f"the wgmma route does not take M={M}, K={K}, N={N}")
    if route == "wmma" and 64 * (K + N) + 8192 > _SMEM_BYTES:
        raise ValueError(f"K + N = {K + N} exceeds the kernel's shared memory")
    # contiguous, 16-byte aligned starts: the TMA maps, the 16-byte copies
    x, b, c = (t.contiguous() for t in ts)
    x, b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, b, c))
    out = torch.empty_like(x)
    kd, stages = (plan.kd, plan.stages) if route == "wgmma" else (0, 0)
    _launch("tn_gemm_chain", torch.bfloat16, x.device, x.data_ptr(),
            b.data_ptr(), c.data_ptr(), out.data_ptr(), P, M, K, N, reps,
            int(route == "wmma"), kd, stages)
    launch_counts["gemm_chain"] += 1
    route_counts["gemm_chain_" + route] += 1
    return out
