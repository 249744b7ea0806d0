#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tensornetwork_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch twin at the shapes its path gives it, and runs the paths of DMRG
on the transverse-field Ising chain, N=32, d=2, M=3, f32 -- one-site (m=10
Krylov vectors) at chi=64 single instance and a batch of 256 (resident
tier), each also with the fused gauge-and-environment epilogue; single
instance at chi=384, 512, 1024 and 2048 (two-pass, streamed,
streamed-matvec and XL streamed-matvec tiers); two-site (m=6, subspace
truncation) on a batch of 256 at chi=64 (resident tier, nt=4) and single
instance at chi=512 and 1024 (streamed-matvec and XL tiers) -- and checks
the energies against the converged reference and a small chain against
exact diagonalisation.  Then the batched MPS transfer chain at bench.py's
shape (B=256, N=32, chi=128, bf16, 8 chained applications; route
"resident") and on its route "tiled" (chi=256 bf16 and f32, chi=128 and
64 f32), and the chained-GEMM probe's 11-shape ladder.
Every phase prints one JSON line; a failed check exits non-zero.  Needs
one CUDA card and nvcc; without a card it exits 1 before printing any
result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np

REFERENCE_ENERGY = -40.384313161218365  # TFI N=32 chi=64, converged
N, CHI, D, M, KRYLOV, BATCH = 32, 64, 2, 3, 10, 256
SINGLE_SWEEPS, BATCH_SWEEPS = 8, 8
# The large-chi one-site paths: (chi, the tier the router must take,
# sweeps from a random state).
LARGE_CHI = ((384, "two_pass", 3), (512, "streamed", 3),
             (1024, "streamed_matvec", 3), (2048, "streamed_matvec_xl", 3))
# Kernel launches per large-chi sweep: every site is solved twice.
TIER_LAUNCHES = {
    "two_pass": {"fused_lanczos_fact": 2 * N, "fused_lanczos_replay": 2 * N},
    "streamed": {"fused_lanczos_streamed": 2 * N},
    "streamed_matvec": {"streamed_matvec": 2 * N * KRYLOV},
    "streamed_matvec_xl": {"streamed_matvec_xl": 2 * N * KRYLOV}}
TIER_CHI = {tier: chi for chi, tier, _ in LARGE_CHI}
NT4_CHI = 512  # K7 at nt=4: the two-site chi=512 path shape
# Two-site DMRG, the JAX package's settings: m=6 Krylov vectors, bonds
# truncated by 2 warm-started subspace iterations with the polar
# orthonormaliser.  Batched: B=256 at chi=64 (resident tier, K2 at nt=4).
# Single instance: (chi, the tier two_site_tier must take, sweeps).
KRYLOV_2S, TRUNC_2S = 6, dict(trunc_impl="subspace", trunc_iters=2,
                              trunc_orth="polar")
BATCH_SWEEPS_2S = 6
LARGE_2S = ((512, "streamed_matvec", 3), (1024, "streamed_matvec_xl", 3))
# Kernel launches per two-site sweep: every bond is solved twice.
TIER_LAUNCHES_2S = {tier: {tier: 2 * (N - 1) * KRYLOV_2S}
                    for tier in ("streamed_matvec", "streamed_matvec_xl")}
XL_CHI_2S = 1024   # K8's two-site path shape (nt=4); one-site: TIER_CHI
DEV = "cuda"
# Accepted window of E - REFERENCE_ENERGY, where E is the energy of the
# returned f32 state evaluated in f64 (<psi|H|psi>/<psi|psi>).  The sweep's
# own f32 Ritz value is printed beside it: its environments sum 32 sites'
# energies in f32, which leaves it ~1e-4 of noise either side.
DE_LO, DE_HI = -1e-5, 1e-4
# The large-chi sweeps start from a random state and run 3-4 sweeps: the
# state must be variational (DE_LO) and converged to DE_LARGE_HI.  On an
# H100 80GB HBM3 at 700 W the states ended at +8e-9 (chi=384), +1.2e-8
# (512) and +2.0e-8 (1024), while the first sweep's own Ritz value still
# sat 8e-4 to 4e-3 above; 1e-6 keeps a 50x margin and fails a state that
# stalls.
DE_LARGE_HI = 1e-6
# The two-site single-instance states, 3 sweeps from a random state with
# the 2-iteration subspace truncation, ended at +4.3e-6 (chi=512) and
# +1.1e-5 (chi=1024) on an H100 80GB HBM3 at 700 W, not at the one-site
# tiers' 1e-8 class; a 50x margin would exceed the chi=64 window, so they
# keep it: [DE_LO, DE_HI].
DE_2S_HI = DE_HI
# fp32 kernel against its fp32 twin: the same products summed in other
# orders, a few ulp of 768-term sums; 1e-4 relative leaves headroom and
# still catches a TF32 product (~1e-3).
KERNEL_RTOL = 1e-4
FP32_PEAK = 67e12   # H100 SXM fp32 outside the tensor cores, FLOP/s
FP64_PEAK = 34e12   # H100 SXM fp64 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12  # H100 SXM bf16 tensor cores, dense, FLOP/s
TF32_PEAK = 495e12  # H100 SXM TF32 tensor cores, dense, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
# The fused epilogue (K5) on the one-site sweep: one launch per site and
# direction, and one per site of the first sweep's prepass.
K5_PER_SWEEP = 2 * N
# K5 against its twin at the batched path's shape, at B=1, chi=256, the
# edge of the shapes the route rule admits (chi <= 347 at d=2, M=3), and at
# B=1, chi=64, the single-instance fused path's shape.
K5_SHAPES = ((BATCH, CHI), (1, 256), (1, CHI))
# The transfer chain (K6) at bench.py's shape: B=256, N=32, chi=128, bf16,
# E0 = I, R=8 chained applications.
CHAIN_B, CHAIN_CHI, CHAIN_R = 256, 128, 8
# K6's route "tiled" against its twin: (chi, dtype) at B=16, N=8 -- the
# shapes the resident route cannot hold (chi > 128; f32)
CHAIN_TILED = ((256, "bfloat16"), (256, "float32"), (128, "float32"),
               (64, "float32"))
CHAIN_TILED_B, CHAIN_TILED_N = 16, 8
# A bf16 kernel against its twin: the same exact products summed in
# another order, so a bf16 rounding between steps flips on a near-tie;
# one bf16 ulp is 2^-8 = 3.9e-3 of the entry, and the later steps carry
# it.  2e-2 of the largest entry (~5 ulps) still fails a wrong term.
BF16_RTOL = 2e-2
# The K9 ladder shape whose times stand in the kernels line: P=16
# independent 128-tile chains, the TPU transfer-chain kernel's tile
# structure (benchmarks/mxu_micro.py).
K9_SHAPE = (128, 128, 128, 16, 60)
# kernels listed per traced sweep (device time by kernel)
DEVICE_TOP = 8


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, what):
    if not cond:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device time of fn() in ms, by CUDA events over reps calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def hermitian_operands(torch, B, chi, d, M, seed):
    from tensornetwork_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, chi, M, chi))
    L = (L + L.transpose(0, 3, 2, 1)) / (2 * chi)
    R = rng.standard_normal((B, chi, M, chi))
    R = (R + R.transpose(0, 3, 2, 1)) / (2 * chi)
    W = rng.standard_normal((M, M, d, d))
    W = (W + W.transpose(1, 0, 3, 2)) / 2
    x = rng.standard_normal((B, chi, d, chi))
    dev = torch.device(DEV)
    solver = [torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (L, W, R, x)]
    return solver, K.prepare_operands(*solver)


def breakdown_operands(torch, B, chi, nt=D):
    """A diagonal operator in kernel layout with nt physical tiles and B
    starts: B-1 product states (eigenvectors, so the chain dies at step 0)
    and a zero start (dead from step 0)."""
    dev = torch.device(DEV)
    Wd = torch.zeros((M, M, nt, nt), device=dev)
    Wd[0, 0] = torch.eye(nt, device=dev)
    Ld = torch.zeros((B, M, chi, chi), device=dev)
    Ld[:, 0] = torch.diag(torch.arange(1.0, chi + 1.0, device=dev))
    Rd = torch.zeros((B, M, chi, chi), device=dev)
    Rd[:, 0] = torch.eye(chi, device=dev)
    xd = torch.zeros((B, nt, chi, chi), device=dev)
    xd[:, 0, 0, 0] = 3.0
    xd[B - 1] = 0.0
    return Ld, Wd, Rd, xd


def breakdown_sentinels(ab, V=None):
    """The +1e10 alphas, zero betas and zero vectors of breakdown_operands'
    chains (the alpha of a live step 0 is exactly 1)."""
    ok = bool((ab[:-1, 0, 1:] == 1e10).all() and (ab[-1, 0] == 1e10).all()
              and (ab[:, 1] == 0).all() and (ab[:-1, 0, 0] == 1.0).all())
    return ok and (V is None or bool((V[:, 1:] == 0).all()
                                     and (V[-1] == 0).all()))


def matvec_work(B, chi, d, M):
    """(flops, bytes) of one batched H_eff matvec: the 2*M*d GEMMs, the
    coupling folds; L, R, x read once and y written once (f32)."""
    flops = B * (4 * M * d * chi ** 3 + 2 * M * M * d * d * chi ** 2)
    nbytes = 4 * (B * (2 * M + 2 * d) * chi ** 2 + M * M * d * d)
    return flops, nbytes


def lanczos_work(B, chi, matvecs, out_vectors):
    """(flops, bytes) of a Lanczos factorization of B instances: `matvecs`
    matvecs plus ~10 vector flops per element per step; L, R, x0 and W
    read once, `out_vectors` d*chi^2 vectors and (alpha, beta) written
    (f32)."""
    mv_flops, _ = matvec_work(B, chi, D, M)
    flops = matvecs * (mv_flops + 10 * B * D * chi * chi)
    nbytes = 4 * (B * (2 * M * chi ** 2 + D * chi ** 2
                       + out_vectors * D * chi ** 2 + 2 * KRYLOV) + M * M * D * D)
    return flops, nbytes


def dmrg_sweep_flops(N, chi, d, M, m):
    """FLOPs of one one-site sweep on uniform stacks, the formula of the JAX
    package's utils/profiling.py dmrg_sweep_flops: per site m matvecs, one
    QR and one env update; every site is visited twice."""
    matvec = 2 * (2 * chi ** 3 * d * M + chi ** 2 * d ** 2 * M ** 2)
    per_site = m * matvec + 2 * 2 * (chi * d) * chi ** 2 + matvec
    return 2 * N * per_site


def bound(flops, nbytes, peak=FP32_PEAK):
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_tc(flops, nbytes):
    """(ms, by) of the least time of an fp32-accurate product by 3xTF32 on
    the tensor cores: three TF32 products per fp32 product, the route K7
    and K8 take in f32."""
    return bound(3 * flops, nbytes, TF32_PEAK)


def f64_errors(torch, sol, y, y_twin, y_lib):
    """Relative (Frobenius) errors against an f64 torch.einsum of the same
    f32 solver-layout operands ``sol``: of the kernel's y and the twin's
    (kernel layout) and of the f32 einsum's (solver layout)."""
    from tensornetwork_tpu_torch.ops import kernels as K
    ref = K.heff_matvec_reference(*(t.double() for t in sol))

    def err(a):
        return float((a.double() - ref).norm() / ref.norm())

    out = dict(kernel=err(K.finalize_output(y)),
               twin=err(K.finalize_output(y_twin)), einsum=err(y_lib))
    del ref
    return out


def lanczos_f64_errors(torch, ops, V, ab, V0, ab0, m):
    """Relative (Frobenius) errors of the kernel's (V, ab) and the f32
    twin's against an f64 run of fused_lanczos_plain on the same f32
    kernel-layout operands ``ops``."""
    from tensornetwork_tpu_torch.ops import kernels as K
    V64, ab64 = K.fused_lanczos_plain(*(t.double() for t in ops), m)

    def err(a, ref):
        return float((a.double() - ref).norm() / ref.norm())

    out = dict(kernel_ab=err(ab, ab64), twin_ab=err(ab0, ab64),
               kernel_V=err(V, V64), twin_V=err(V0, V64))
    del V64
    return out


def grid_plan(torch, K, chi):
    """The grid Lanczos plan at B=1 (tiles, split, jobs) for this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return K.lgrid_plan(chi, D, M, 1, sms)._asdict()


def route_times(torch, K, sol, tier_solve):
    """ms of one ground-state solve (m=KRYLOV, eigh Ritz) on the
    solver-layout operands ``sol`` through the tier's own wrapper
    ``tier_solve`` and through the K7 tier (streamed_lanczos and the Ritz
    pair), with the two Ritz values."""
    k7 = lambda: K.fused_lanczos_ground_state_streamed2(  # noqa: E731
        *sol, KRYLOV, ritz_method="eigh")
    tier = lambda: tier_solve(*sol, KRYLOV, ritz_method="eigh")  # noqa: E731
    e_tier, e_k7 = float(tier()[0][0]), float(k7()[0][0])
    return dict(tier_solve_ms=cuda_ms(torch, tier, 5),
                k7_route_ms=cuda_ms(torch, k7, 5),
                tier_ritz=e_tier, k7_route_ritz=e_k7)


def device_phase(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


def build_phase():
    from tensornetwork_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build_all()
    ptxas = {src: [ln.strip() for ln in info["log"].splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, info in log.items()}
    emit(phase="build", seconds=time.perf_counter() - t0, key=_build.build_key(),
         ptxas=ptxas)


def k1_phase(torch):
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    (L, W, R, x), (Lt, W_, Rt, xt) = hermitian_operands(torch, BATCH, CHI, D,
                                                        M, seed=1)
    with highest_precision():
        y = K.heff_matvec(Lt, W_, Rt, xt)
        y_plain = K.heff_matvec_plain(Lt, W_, Rt, xt)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), "K1 output not finite")
        rel, err = max_rel(y, y_plain), float((y - y_plain).abs().max())
        ms = cuda_ms(torch, lambda: K.heff_matvec(Lt, W_, Rt, xt), 20)
        plain_ms = cuda_ms(torch, lambda: K.heff_matvec_plain(Lt, W_, Rt, xt), 20)
        lib_ms = cuda_ms(torch, lambda: K.heff_matvec_reference(L, W, R, x), 20)
        lib_err = max_rel(K.finalize_output(y), K.heff_matvec_reference(L, W, R, x))
    bound_ms, bound_by = bound(*matvec_work(BATCH, CHI, D, M))
    emit(phase="k1_heff_matvec", shape=[BATCH, CHI, D, M], max_rel_err=rel,
         max_abs_err=err, einsum_rel_err=lib_err, ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    check(rel <= KERNEL_RTOL, f"K1 disagrees with its twin: {rel}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def k2_phase(torch):
    """K2, the fused Lanczos, at the batched one-site path's shape (B=256,
    chi=64, m=10): against its twin and against an f64 run of the twin
    (the 3xTF32 kernel within 4x the f32 twin's error), a repeat launch
    bit for bit, the breakdown chains bit for bit."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    _, ops = hermitian_operands(torch, BATCH, CHI, D, M, seed=2)
    Lt, W, Rt, xt = ops
    with highest_precision():
        V, ab = K.fused_lanczos(Lt, W, Rt, xt, KRYLOV)
        V0, ab0 = K.fused_lanczos_plain(Lt, W, Rt, xt, KRYLOV)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(V).all() and torch.isfinite(ab).all()),
              "K2 output not finite")
        rel_ab, rel_V = max_rel(ab, ab0), max_rel(V, V0)
        err = max(float((ab - ab0).abs().max()), float((V - V0).abs().max()))
        V2, ab2 = K.fused_lanczos(Lt, W, Rt, xt, KRYLOV)
        repeat = bool(torch.equal(V, V2) and torch.equal(ab, ab2))
        del V2, ab2
        f64 = lanczos_f64_errors(torch, ops, V, ab, V0, ab0, KRYLOV)
        ms = cuda_ms(torch, lambda: K.fused_lanczos(Lt, W, Rt, xt, KRYLOV), 10)
        plain_ms = cuda_ms(
            torch, lambda: K.fused_lanczos_plain(Lt, W, Rt, xt, KRYLOV), 3)

        Ld, Wd, Rd, xd = breakdown_operands(torch, 4, CHI)
        Vd, abd = K.fused_lanczos(Ld, Wd, Rd, xd, KRYLOV)
        Vd0, abd0 = K.fused_lanczos_plain(Ld, Wd, Rd, xd, KRYLOV)
    sentinels = breakdown_sentinels(abd, Vd)
    same = bool(torch.equal(abd, abd0) and torch.equal(Vd, Vd0))
    flops, nbytes = lanczos_work(BATCH, CHI, KRYLOV, KRYLOV)
    bound_ms, bound_by = bound(flops, nbytes)
    bound_tc_ms = bound_tc(flops, nbytes)[0]
    emit(phase="k2_fused_lanczos", shape=[BATCH, CHI, D, M, KRYLOV],
         max_rel_err_ab=rel_ab, max_rel_err_V=rel_V, max_abs_err=err,
         f64_rel_err=f64, repeat_same_bits=repeat,
         breakdown_sentinels=sentinels, breakdown_equals_twin=same, ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         bound_tc_ms=bound_tc_ms, tflops_per_s=flops / ms / 1e9)
    check(rel_ab <= KERNEL_RTOL and rel_V <= KERNEL_RTOL,
          f"K2 disagrees with its twin: ab {rel_ab}, V {rel_V}")
    check(f64["kernel_ab"] <= 4 * f64["twin_ab"]
          and f64["kernel_V"] <= 4 * f64["twin_V"],
          f"K2 against f64 beyond 4x its f32 twin: {f64}")
    check(repeat, "K2: a repeat launch gave other bits")
    check(sentinels and same, "K2 breakdown sentinels wrong")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_tc_ms=bound_tc_ms)


def k3_phase(torch):
    """K3, the two-pass Lanczos (fact, then replay with the Ritz weights),
    at the chi=384 path's shapes: against its twins and against an f64 run
    of them (within 4x the f32 twins' error), a repeat launch and the
    breakdown chains bit for bit, fact's ab bit for bit K4's on the same
    operands; timed beside the same solve through the K7 tier."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    from tensornetwork_tpu_torch.ops.krylov import tridiag_ritz
    t0 = time.perf_counter()
    chi = TIER_CHI["two_pass"]
    sol, ops = hermitian_operands(torch, 1, chi, D, M, seed=3)
    Lt, W, Rt, xt = ops

    def ritz_weights(ab):
        return tridiag_ritz(ab[:, 0], ab[:, 1, :-1], "eigh")[1].contiguous()

    with highest_precision():
        ab = K.fused_lanczos_fact(Lt, W, Rt, xt, KRYLOV)
        ab0 = K.fused_lanczos_fact_plain(Lt, W, Rt, xt, KRYLOV)
        wts = ritz_weights(ab)
        y = K.fused_lanczos_replay(Lt, W, Rt, xt, wts, ab)
        y0 = K.fused_lanczos_replay_plain(Lt, W, Rt, xt, wts, ab)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(ab).all() and torch.isfinite(y).all()),
              "K3 output not finite")
        rel_ab, rel_y = max_rel(ab, ab0), max_rel(y, y0)
        err = max(float((ab - ab0).abs().max()), float((y - y0).abs().max()))
        ab2 = K.fused_lanczos_fact(Lt, W, Rt, xt, KRYLOV)
        y2 = K.fused_lanczos_replay(Lt, W, Rt, xt, wts, ab)
        repeat = bool(torch.equal(ab, ab2) and torch.equal(y, y2))
        fact_equals_k4 = bool(torch.equal(
            ab, K.fused_lanczos_streamed(Lt, W, Rt, xt, KRYLOV)[1]))
        # each pass pipeline against f64 with the same Ritz weights
        ops64 = [t.double() for t in ops]
        ab64 = K.fused_lanczos_fact_plain(*ops64, KRYLOV)
        y64 = K.fused_lanczos_replay_plain(*ops64, wts.double(), ab64)
        y0_own = K.fused_lanczos_replay_plain(Lt, W, Rt, xt, wts, ab0)

        def ferr(a, ref):
            return float((a.double() - ref).norm() / ref.norm())

        f64 = dict(kernel_ab=ferr(ab, ab64), twin_ab=ferr(ab0, ab64),
                   kernel_y=ferr(y, y64), twin_y=ferr(y0_own, y64))
        del ops64, y64, y0_own
        fact_ms = cuda_ms(torch, lambda: K.fused_lanczos_fact(
            Lt, W, Rt, xt, KRYLOV), 5)
        replay_ms = cuda_ms(torch, lambda: K.fused_lanczos_replay(
            Lt, W, Rt, xt, wts, ab), 5)
        plain_ms = cuda_ms(torch, lambda: K.fused_lanczos_replay_plain(
            Lt, W, Rt, xt, wts, K.fused_lanczos_fact_plain(
                Lt, W, Rt, xt, KRYLOV)), 3)

        Ld, Wd, Rd, xd = breakdown_operands(torch, 2, chi)
        abd = K.fused_lanczos_fact(Ld, Wd, Rd, xd, KRYLOV)
        abd0 = K.fused_lanczos_fact_plain(Ld, Wd, Rd, xd, KRYLOV)
        wd = torch.ones((2, KRYLOV), device=xd.device)  # dead v_j add 0
        yd = K.fused_lanczos_replay(Ld, Wd, Rd, xd, wd, abd)
        yd0 = K.fused_lanczos_replay_plain(Ld, Wd, Rd, xd, wd, abd0)
        routes = route_times(torch, K, sol, lambda *a, **kw:
                             K.fused_lanczos_ground_state(*a, two_pass=True,
                                                          **kw))
    sentinels = breakdown_sentinels(abd) and bool(
        torch.equal(yd[0], xd[0] / 3) and (yd[1] == 0).all())
    same = bool(torch.equal(abd, abd0) and torch.equal(yd, yd0))
    work = lanczos_work(1, chi, 2 * KRYLOV - 1, 1)
    bound_ms, bound_by = bound(*work)
    bound_tc_ms = bound_tc(*work)[0]
    ms = fact_ms + replay_ms
    emit(phase="k3_two_pass", shape=[1, chi, D, M, KRYLOV],
         max_rel_err_ab=rel_ab, max_rel_err_y=rel_y, max_abs_err=err,
         f64_rel_err=f64, repeat_same_bits=repeat,
         fact_equals_k4_ab=fact_equals_k4,
         breakdown_sentinels=sentinels, breakdown_equals_twin=same,
         fact_ms=fact_ms, replay_ms=replay_ms, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=bound_tc_ms,
         tflops_per_s=work[0] / ms / 1e9, plan=grid_plan(torch, K, chi),
         grid={k: K.last_grid[k] for k in ("fused_lanczos_fact",
                                           "fused_lanczos_replay")},
         seconds=time.perf_counter() - t0, **routes)
    check(rel_ab <= KERNEL_RTOL and rel_y <= KERNEL_RTOL,
          f"K3 disagrees with its twins: ab {rel_ab}, y {rel_y}")
    check(f64["kernel_ab"] <= 4 * f64["twin_ab"]
          and f64["kernel_y"] <= 4 * f64["twin_y"],
          f"K3 against f64 beyond 4x its f32 twins: {f64}")
    check(repeat, "K3: a repeat launch gave other bits")
    check(fact_equals_k4, "K3's fact ab differs from K4's")
    check(sentinels and same, "K3 breakdown sentinels wrong")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_tc_ms=bound_tc_ms)


def k4_phase(torch):
    """K4, the streamed whole-Lanczos kernel, at the chi=512 path's shapes,
    against its twin and an f64 run of it (within 4x the f32 twin's
    error) and against K2 (the same function) on the same operands, a
    repeat launch and the breakdown chains bit for bit; timed beside the
    same solve through the K7 tier."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    chi = TIER_CHI["streamed"]
    sol, ops = hermitian_operands(torch, 1, chi, D, M, seed=4)
    Lt, W, Rt, xt = ops
    with highest_precision():
        V, ab = K.fused_lanczos_streamed(Lt, W, Rt, xt, KRYLOV)
        V0, ab0 = K.fused_lanczos_plain(Lt, W, Rt, xt, KRYLOV)
        V2, ab2 = K.fused_lanczos(Lt, W, Rt, xt, KRYLOV)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(V).all() and torch.isfinite(ab).all()),
              "K4 output not finite")
        rel_ab, rel_V = max_rel(ab, ab0), max_rel(V, V0)
        k2_rel_ab, k2_rel_V = max_rel(ab, ab2), max_rel(V, V2)
        err = max(float((ab - ab0).abs().max()), float((V - V0).abs().max()))
        del V2, ab2
        V3, ab3 = K.fused_lanczos_streamed(Lt, W, Rt, xt, KRYLOV)
        repeat = bool(torch.equal(V, V3) and torch.equal(ab, ab3))
        del V3, ab3
        f64 = lanczos_f64_errors(torch, ops, V, ab, V0, ab0, KRYLOV)
        ms = cuda_ms(torch, lambda: K.fused_lanczos_streamed(
            Lt, W, Rt, xt, KRYLOV), 5)
        k2_ms = cuda_ms(torch, lambda: K.fused_lanczos(
            Lt, W, Rt, xt, KRYLOV), 2, warmup=0)
        plain_ms = cuda_ms(
            torch, lambda: K.fused_lanczos_plain(Lt, W, Rt, xt, KRYLOV), 3)

        Ld, Wd, Rd, xd = breakdown_operands(torch, 2, chi)
        Vd, abd = K.fused_lanczos_streamed(Ld, Wd, Rd, xd, KRYLOV)
        Vd0, abd0 = K.fused_lanczos_plain(Ld, Wd, Rd, xd, KRYLOV)
        grid = K.last_grid["fused_lanczos_streamed"]
        routes = route_times(torch, K, sol,
                             K.fused_lanczos_ground_state_streamed)
    sentinels = breakdown_sentinels(abd, Vd)
    same = bool(torch.equal(abd, abd0) and torch.equal(Vd, Vd0))
    flops, nbytes = lanczos_work(1, chi, KRYLOV, KRYLOV)
    bound_ms, bound_by = bound(flops, nbytes)
    bound_tc_ms = bound_tc(flops, nbytes)[0]
    emit(phase="k4_fused_lanczos_streamed", shape=[1, chi, D, M, KRYLOV],
         max_rel_err_ab=rel_ab, max_rel_err_V=rel_V, max_abs_err=err,
         k2_rel_err_ab=k2_rel_ab, k2_rel_err_V=k2_rel_V, f64_rel_err=f64,
         repeat_same_bits=repeat, breakdown_sentinels=sentinels,
         breakdown_equals_twin=same, grid=grid, plan=grid_plan(torch, K, chi),
         ms=ms, k2_ms=k2_ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, bound_tc_ms=bound_tc_ms,
         tflops_per_s=flops / ms / 1e9, seconds=time.perf_counter() - t0,
         **routes)
    check(rel_ab <= KERNEL_RTOL and rel_V <= KERNEL_RTOL,
          f"K4 disagrees with its twin: ab {rel_ab}, V {rel_V}")
    check(k2_rel_ab <= KERNEL_RTOL and k2_rel_V <= KERNEL_RTOL,
          f"K4 disagrees with K2: ab {k2_rel_ab}, V {k2_rel_V}")
    check(f64["kernel_ab"] <= 4 * f64["twin_ab"]
          and f64["kernel_V"] <= 4 * f64["twin_V"],
          f"K4 against f64 beyond 4x its f32 twin: {f64}")
    check(repeat, "K4: a repeat launch gave other bits")
    check(grid > 1, f"K4 ran one instance on {grid} block(s)")
    check(sentinels and same, "K4 breakdown sentinels wrong")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_tc_ms=bound_tc_ms)


def k7_phase(torch):
    """K7, the streamed matvec, at the one-site chi=1024 path's shapes
    (nt=2) and at the two-site chi=512 path's (nt=4): against its twin and
    against an f64 einsum beside the twin and the f32 einsum, with the
    stage grids of its f32 GEMMs; the breakdown through the recurrence
    around it."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    chi = TIER_CHI["streamed_matvec"]
    (L, W, R, x), (Lt, W_, Rt, xt) = hermitian_operands(torch, 1, chi, D, M,
                                                        seed=7)
    with highest_precision():
        y, alpha = K.streamed_matvec(Lt, W_, Rt, xt)
        y0, alpha0 = K.streamed_matvec_plain(Lt, W_, Rt, xt)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(alpha).all()),
              "K7 output not finite")
        rel = max_rel(y, y0)
        scale = float(xt.norm() * y0.norm())  # alpha may cancel
        rel_alpha = float((alpha - alpha0).abs().max()) / scale
        own_alpha = float((alpha - (xt * y).sum()).abs().max()) / scale
        err = max(float((y - y0).abs().max()),
                  float((alpha - alpha0).abs().max()))
        ms = cuda_ms(torch, lambda: K.streamed_matvec(Lt, W_, Rt, xt), 10)
        plain_ms = cuda_ms(torch, lambda: K.streamed_matvec_plain(
            Lt, W_, Rt, xt), 10)
        lib_ms = cuda_ms(torch, lambda: K.heff_matvec_reference(L, W, R, x), 10)
        y_lib = K.heff_matvec_reference(L, W, R, x)
        lib_err = max_rel(K.finalize_output(y), y_lib)
        f64 = f64_errors(torch, (L, W, R, x), y, y0, y_lib)

        # nt=4, the two-site chi=512 path's shape
        g = torch.Generator(device=DEV).manual_seed(8)
        kw = dict(device=DEV, generator=g)
        L4, R4 = (torch.randn((1, M, NT4_CHI, NT4_CHI), **kw) / NT4_CHI ** 0.5
                  for _ in range(2))
        C4 = torch.randn((M, M, 4, 4), **kw)
        x4 = torch.randn((1, 4, NT4_CHI, NT4_CHI), **kw)
        y4, a4 = K.streamed_matvec(L4, C4, R4, x4)
        y40, a40 = K.streamed_matvec_plain(L4, C4, R4, x4)
        rel4 = max(max_rel(y4, y40),
                   float((a4 - a40).abs().max() / (x4.norm() * y40.norm())))
        nt4_ms = cuda_ms(torch, lambda: K.streamed_matvec(L4, C4, R4, x4), 10)
        nt4_plain_ms = cuda_ms(torch, lambda: K.streamed_matvec_plain(
            L4, C4, R4, x4), 10)
        # the same matvec as one torch.einsum on solver-layout views
        sol4 = (L4.permute(0, 3, 1, 2), C4, R4.permute(0, 2, 1, 3),
                x4.permute(0, 2, 1, 3))
        nt4_lib_ms = cuda_ms(torch, lambda: K.heff_matvec_reference(*sol4), 10)
        f64_4 = f64_errors(torch, sol4, y4, y40, K.heff_matvec_reference(*sol4))

        Ld, Wd, Rd, xd = breakdown_operands(torch, 2, chi)
        Vd, abd = K.streamed_lanczos(Ld, Wd, Rd, xd, KRYLOV)
        Vd0, abd0 = K.fused_lanczos_plain(Ld, Wd, Rd, xd, KRYLOV)
    sentinels = breakdown_sentinels(abd, Vd)
    same = bool(torch.equal(abd, abd0) and torch.equal(Vd, Vd0))
    work = matvec_work(1, chi, D, M)
    bound_ms, bound_by = bound(*work)
    bound_tc_ms = bound_tc(*work)[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit(phase="k7_streamed_matvec", shape=[1, chi, D, M], max_rel_err=rel,
         alpha_rel_err=rel_alpha, alpha_vs_own_y=own_alpha, max_abs_err=err,
         einsum_rel_err=lib_err, f64_rel_err=f64,
         grids=K.tc32_grids(chi, D, M, 1, 1, sms), nt4_rel_err=rel4,
         nt4_chi=NT4_CHI, nt4_f64_rel_err=f64_4,
         nt4_grids=K.tc32_grids(NT4_CHI, 4, M, 1, 1, sms),
         nt4_ms=nt4_ms, nt4_plain_ms=nt4_plain_ms, nt4_library_ms=nt4_lib_ms,
         nt4_bound_ms=bound(*matvec_work(1, NT4_CHI, 4, M))[0],
         nt4_bound_tc_ms=bound_tc(*matvec_work(1, NT4_CHI, 4, M))[0],
         breakdown_sentinels=sentinels, breakdown_equals_twin=same, ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
         bound_by=bound_by, bound_tc_ms=bound_tc_ms,
         tflops_per_s=work[0] / ms / 1e9)
    check(max(rel, rel_alpha, own_alpha, rel4) <= KERNEL_RTOL,
          f"K7 disagrees with its twin: y {rel}, alpha {rel_alpha}, "
          f"alpha vs its y {own_alpha}, nt=4 {rel4}")
    check(f64["kernel"] <= 4 * f64["twin"]
          and f64_4["kernel"] <= 4 * f64_4["twin"],
          f"K7 against f64 beyond 4x its f32 twin: {f64}, nt=4 {f64_4}")
    check(sentinels and same, "K7 breakdown sentinels wrong")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
                bound_tc_ms=bound_tc_ms), nt4_ms


def k8_phase(torch):
    """K8, the XL streamed matvec, at both of its path shapes -- two-site
    chi=1024 (nt=4) and one-site chi=2048 (nt=2), B=1 -- for K3 = 1, the
    wrapper's pick and 4, against its twin and against an f64 einsum
    beside the twin and the f32 einsum; timed beside K7 on the same
    operands, the twin and one torch.einsum of the matvec, with the stage
    grids of its f32 GEMMs.  Then the breakdown through the recurrence
    around it."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    out, ret = {}, None
    for label, chi, nt in (("two_site", XL_CHI_2S, D * D),
                           ("one_site", TIER_CHI["streamed_matvec_xl"], D)):
        (L, W, R, x), (Lt, C, Rt, xt) = hermitian_operands(
            torch, 1, chi, nt, M, seed=chi + nt)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        pick = K.xl_chunk_count(chi, nt, M, 1, sms)
        errs = {}
        with highest_precision():
            y_lib = K.heff_matvec_reference(L, W, R, x)
            for K3 in sorted({1, pick, 4}):
                y, alpha = K.streamed_matvec_xl(Lt, C, Rt, xt, K3=K3)
                y0, alpha0 = K.streamed_matvec_xl_plain(Lt, C, Rt, xt, K3)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(y).all() and torch.isfinite(alpha).all()),
                      f"K8 ({label}, K3={K3}) output not finite")
                scale = float(xt.norm() * y0.norm())  # alpha may cancel
                errs[K3] = dict(
                    y_rel=max_rel(y, y0),
                    alpha_rel=float((alpha - alpha0).abs().max()) / scale,
                    alpha_vs_own_y=float((alpha - (xt * y).sum()).abs().max())
                    / scale,
                    max_abs_err=max(float((y - y0).abs().max()),
                                    float((alpha - alpha0).abs().max())),
                    f64_rel_err=f64_errors(torch, (L, W, R, x), y, y0, y_lib))
                del y, y0
            ms = cuda_ms(torch, lambda: K.streamed_matvec_xl(Lt, C, Rt, xt), 10)
            k7_ms = cuda_ms(torch, lambda: K.streamed_matvec(Lt, C, Rt, xt), 10)
            k7_plain_ms = cuda_ms(torch, lambda: K.streamed_matvec_plain(
                Lt, C, Rt, xt), 5)
            plain_ms = cuda_ms(torch, lambda: K.streamed_matvec_xl_plain(
                Lt, C, Rt, xt, pick), 5)
            lib_ms = cuda_ms(torch, lambda: K.heff_matvec_reference(L, W, R, x),
                             5)
        work = matvec_work(1, chi, nt, M)
        bound_ms, bound_by = bound(*work)
        bound_tc_ms = bound_tc(*work)[0]
        emit(phase="k8_streamed_matvec_xl", path=label, shape=[1, chi, nt, M],
             k3_pick=pick, grids={K3: K.tc32_grids(chi, nt, M, 1, K3, sms)
                                  for K3 in errs},
             errors=errs, ms=ms, k7_ms=k7_ms,
             k7_plain_ms=k7_plain_ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
             bound_tc_ms=bound_tc_ms, tflops_per_s=work[0] / ms / 1e9)
        worst = max(max(e["y_rel"], e["alpha_rel"], e["alpha_vs_own_y"])
                    for e in errs.values())
        check(worst <= KERNEL_RTOL,
              f"K8 ({label}) disagrees with its twin: {errs}")
        check(all(e["f64_rel_err"]["kernel"] <= 4 * e["f64_rel_err"]["twin"]
                  for e in errs.values()),
              f"K8 ({label}) against f64 beyond 4x its f32 twin: {errs}")
        out[label] = ms
        if label == "two_site":
            ret = dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms,
                       bound_tc_ms=bound_tc_ms)
        del L, W, R, x, Lt, C, Rt, xt, y_lib
        torch.cuda.empty_cache()

    with highest_precision():
        Ld, Wd, Rd, xd = breakdown_operands(torch, 2, XL_CHI_2S)
        Vd, abd = K.streamed_lanczos(Ld, Wd, Rd, xd, KRYLOV,
                                     matvec=K.streamed_matvec_xl)
        Vd0, abd0 = K.fused_lanczos_plain(Ld, Wd, Rd, xd, KRYLOV)
    sentinels = breakdown_sentinels(abd, Vd)
    same = bool(torch.equal(abd, abd0) and torch.equal(Vd, Vd0))
    emit(phase="k8_breakdown", chi=XL_CHI_2S, breakdown_sentinels=sentinels,
         breakdown_equals_twin=same)
    check(sentinels and same, "K8 breakdown sentinels wrong")
    return ret, out


def k2_nt4_phase(torch):
    """K2 with nt=4 physical tiles, the two-site resident tier: B=256,
    chi=64, m=6, against its twin and an f64 run of it, a repeat launch
    and the breakdown chains, bit for bit."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    nt = D * D
    _, ops = hermitian_operands(torch, BATCH, CHI, nt, M, seed=24)
    Lt, C, Rt, xt = ops
    with highest_precision():
        V, ab = K.fused_lanczos(Lt, C, Rt, xt, KRYLOV_2S)
        V0, ab0 = K.fused_lanczos_plain(Lt, C, Rt, xt, KRYLOV_2S)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(V).all() and torch.isfinite(ab).all()),
              "K2 (nt=4) output not finite")
        rel_ab, rel_V = max_rel(ab, ab0), max_rel(V, V0)
        V2, ab2 = K.fused_lanczos(Lt, C, Rt, xt, KRYLOV_2S)
        repeat = bool(torch.equal(V, V2) and torch.equal(ab, ab2))
        del V2, ab2
        f64 = lanczos_f64_errors(torch, ops, V, ab, V0, ab0, KRYLOV_2S)
        ms = cuda_ms(torch, lambda: K.fused_lanczos(Lt, C, Rt, xt, KRYLOV_2S), 10)
        plain_ms = cuda_ms(torch, lambda: K.fused_lanczos_plain(
            Lt, C, Rt, xt, KRYLOV_2S), 3)
        Ld, Cd, Rd, xd = breakdown_operands(torch, 4, CHI, nt)
        Vd, abd = K.fused_lanczos(Ld, Cd, Rd, xd, KRYLOV_2S)
        Vd0, abd0 = K.fused_lanczos_plain(Ld, Cd, Rd, xd, KRYLOV_2S)
    sentinels = breakdown_sentinels(abd, Vd)
    same = bool(torch.equal(abd, abd0) and torch.equal(Vd, Vd0))
    flops, _ = matvec_work(BATCH, CHI, nt, M)
    flops = KRYLOV_2S * (flops + 10 * BATCH * nt * CHI * CHI)
    nbytes = 4 * (BATCH * ((2 * M + nt + KRYLOV_2S * nt) * CHI ** 2
                           + 2 * KRYLOV_2S) + M * M * nt * nt)
    bound_ms, bound_by = bound(flops, nbytes)
    bound_tc_ms = bound_tc(flops, nbytes)[0]
    emit(phase="k2_fused_lanczos_nt4", shape=[BATCH, CHI, nt, M, KRYLOV_2S],
         max_rel_err_ab=rel_ab, max_rel_err_V=rel_V, f64_rel_err=f64,
         repeat_same_bits=repeat, breakdown_sentinels=sentinels,
         breakdown_equals_twin=same, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bound_tc_ms=bound_tc_ms,
         tflops_per_s=flops / ms / 1e9)
    check(rel_ab <= KERNEL_RTOL and rel_V <= KERNEL_RTOL,
          f"K2 (nt=4) disagrees with its twin: ab {rel_ab}, V {rel_V}")
    check(f64["kernel_ab"] <= 4 * f64["twin_ab"]
          and f64["kernel_V"] <= 4 * f64["twin_V"],
          f"K2 (nt=4) against f64 beyond 4x its f32 twin: {f64}")
    check(repeat, "K2 (nt=4): a repeat launch gave other bits")
    check(sentinels and same, "K2 (nt=4) breakdown sentinels wrong")
    return ms


def gauge_env_work(B, chi, d, M, qi, ci, elem=4):
    """(flops, bytes) of one fused epilogue (K5): per instance qi quintic
    steps ((4d+2) chi^3 each), ci cubic (4d chi^3), P (2d chi^3), U and
    Enew (4Md chi^3); W, E, A read once and Q, P, Enew written once."""
    per = (qi * (4 * d + 2) + ci * 4 * d + 2 * d + 4 * M * d) * chi ** 3
    nbytes = elem * (B * (2 * M + 2 * d + 1) * chi ** 2 + M * M * d * d)
    return B * per, nbytes


def k5_phase(torch):
    """K5, the fused gauge-and-environment epilogue, against its twin: at
    the batched path's shape (B=256, chi=64) and at B=1, chi=256, in both
    directions, f32; and in f64 at a small shape.  The solver-layout
    wrappers are checked to return the kernel-layout call's bits."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    ret = None
    cases = [(B, chi, torch.float32) for B, chi in K5_SHAPES]
    cases.append((3, 40, torch.float64))
    for B, chi, dtype in cases:
        t0 = time.perf_counter()
        rng = np.random.default_rng(chi + B)
        dev = torch.device(DEV)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        env = as_t(rng.standard_normal((B, chi, M, chi)) / chi)
        W = as_t(rng.standard_normal((M, M, D, D)))
        A = as_t(rng.standard_normal((B, chi, D, chi)))
        qi, ci = K.polar_iters(dtype)
        for side in ("left", "right"):
            # the operands as the wrappers prepare them
            if side == "left":
                Wk, Ak = W, A.permute(0, 2, 1, 3).reshape(B, D * chi, chi)
            else:
                Wk = W.permute(1, 0, 2, 3).contiguous()
                Ak = A.permute(0, 2, 3, 1).reshape(B, D * chi, chi)
            Ek, Ak = env.permute(0, 2, 1, 3).contiguous(), Ak.contiguous()
            with highest_precision():
                out = K.fused_gauge_env(Wk, Ek, Ak, qi, ci)
                ref = K.fused_gauge_env_plain(Wk, Ek, Ak, qi, ci)
                wrapped = getattr(K, f"fused_gauge_env_{side}")(env, W, A, qi,
                                                                ci)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(t).all()) for t in out),
                      f"K5 ({side}, B={B}, chi={chi}) output not finite")
                rels = [max_rel(o, r) for o, r in zip(out, ref)]
                err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
                Q, P = out[0], out[1]
                eye = torch.eye(chi, dtype=dtype, device=dev)
                iso = float((Q.mT @ Q - eye).abs().max())
                recon = float((Q @ P - Ak).norm() / Ak.norm())
                ms = cuda_ms(torch, lambda: K.fused_gauge_env(Wk, Ek, Ak, qi,
                                                              ci), 5)
                plain_ms = cuda_ms(torch, lambda: K.fused_gauge_env_plain(
                    Wk, Ek, Ak, qi, ci), 3)
            Qw = wrapped[0].permute(0, 2, 1, 3) if side == "left" else \
                wrapped[0].permute(0, 2, 3, 1)
            Pw = wrapped[1] if side == "left" else wrapped[1].mT
            same = bool(torch.equal(Qw.reshape(B, D * chi, chi), out[0])
                        and torch.equal(Pw, out[1])
                        and torch.equal(wrapped[2].permute(0, 2, 1, 3), out[2]))
            elem = torch.finfo(dtype).bits // 8
            flops, nbytes = gauge_env_work(B, chi, D, M, qi, ci, elem)
            bound_ms, bound_by = bound(flops, nbytes,
                                       FP32_PEAK if dtype == torch.float32
                                       else FP64_PEAK)
            emit(phase="k5_fused_gauge_env", side=side, dtype=str(dtype),
                 shape=[B, chi, D, M], iters=[qi, ci],
                 max_rel_err_Q_P_Enew=rels, max_abs_err=err,
                 isometry_err=iso, reconstruction_rel_err=recon,
                 wrappers_equal_kernel=same, grid=K.last_grid["fused_gauge_env"],
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 tflops_per_s=flops / ms / 1e9,
                 seconds_since_case_start=time.perf_counter() - t0)
            tol = KERNEL_RTOL if dtype == torch.float32 else 1e-10
            check(max(rels) <= tol,
                  f"K5 ({side}, B={B}, chi={chi}, {dtype}) disagrees with "
                  f"its twin: {rels}")
            check(iso <= 1e-4 and recon <= 1e-4,
                  f"K5 ({side}, B={B}, chi={chi}): |Q^T Q - I| {iso}, "
                  f"|QP - A|/|A| {recon}")
            check(same, f"K5 {side} wrapper does not return the kernel's bits")
            if ret is None:
                ret = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
    return ret


def chain_work(B, N, chi, d, elem):
    """(flops, bytes) of one transfer chain: 4 d chi^3 per site and
    instance; the site tensors (elem bytes) and E0 read once (in the input
    type), E_N written once in f32."""
    return (B * N * 4 * d * chi ** 3,
            B * N * d * chi * chi * elem + B * chi * chi * (elem + 4))


def einsum_chain_step(torch, As, E):
    """The chain as per-site torch.einsum calls in the input type (cuBLAS,
    f32 accumulation), the yardstick of K6."""
    E = E.to(As.dtype)
    for n in range(As.shape[1]):
        Y = torch.einsum("Bac,Basb->Bscb", E, As[:, n])
        E = torch.einsum("Bscb,Bcsp->Bbp", Y, As[:, n])
    return E


def k6_phase(torch):
    """K6, the transfer chain, at bench.py's shape (B=256, N=32, chi=128,
    bf16, E0 = I) on its route "resident", against its twin, timed per
    application beside the twin and the same chain as per-site
    torch.einsum calls in bf16.  The R=8 chain is the path: the counts are
    set to 0 just before it runs once and read just after.  Then the
    route "tiled" at CHAIN_TILED against the twin, each timed beside the
    twin and the einsum chain, with its bound."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    B, chi, R = CHAIN_B, CHAIN_CHI, CHAIN_R
    route = K.transfer_chain_route(chi, D, torch.bfloat16)
    check(route == "resident", f"K6 at bench.py's shape takes {route}")
    g = torch.Generator(device=DEV).manual_seed(3)
    As = (torch.randn((B, N, chi, D, chi), generator=g, device=DEV)
          / np.sqrt(D * chi)).to(torch.bfloat16)
    E0 = torch.eye(chi, device=DEV, dtype=torch.bfloat16).expand(B, chi, chi)

    def chain(step):
        E = E0
        for _ in range(R):
            E = step(As, E.to(torch.bfloat16))
        return E

    K.reset_launch_counts()
    E = chain(K.transfer_chain)
    launches = K.launch_counts["transfer_chain"]
    routes = dict(K.route_counts)
    E_plain = chain(K.transfer_chain_plain)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(E).all()) and E.shape == (B, chi, chi),
          "K6 output not finite or misshapen")
    rel = max_rel(E, E_plain)
    lib = chain(lambda A, E: einsum_chain_step(torch, A, E)).float()
    lib_rel = max_rel(E, lib)
    one = K.transfer_chain(As, E0)
    one_plain = K.transfer_chain_plain(As, E0)
    one_rel = max_rel(one, one_plain)
    err = float((one - one_plain).abs().max())
    repeat = bool(torch.equal(one, K.transfer_chain(As, E0)))
    ms = cuda_ms(torch, lambda: chain(K.transfer_chain), 2) / R
    plain_ms = cuda_ms(torch, lambda: K.transfer_chain_plain(As, E0), 1)
    lib_ms = cuda_ms(torch, lambda: einsum_chain_step(torch, As, E0), 2)
    flops, nbytes = chain_work(B, N, chi, D, 2)
    bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
    del As, E0, E, E_plain, lib, one, one_plain

    tiled = []
    for c, dt in CHAIN_TILED:
        dtype = getattr(torch, dt)
        rt = K.transfer_chain_route(c, D, dtype)
        A2 = (torch.randn((CHAIN_TILED_B, CHAIN_TILED_N, c, D, c), generator=g,
                          device=DEV) / np.sqrt(D * c)).to(dtype)
        E2 = torch.eye(c, device=DEV).expand(CHAIN_TILED_B, c, c)
        K.reset_launch_counts()
        out = K.transfer_chain(A2, E2)
        counted = dict(K.route_counts)
        ref = K.transfer_chain_plain(A2, E2)
        rel2 = max_rel(out, ref)
        same2 = bool(torch.equal(out, K.transfer_chain(A2, E2)))
        t = cuda_ms(torch, lambda: K.transfer_chain(A2, E2), 5)
        t_plain = cuda_ms(torch, lambda: K.transfer_chain_plain(A2, E2), 2)
        with highest_precision():
            t_lib = cuda_ms(torch, lambda: einsum_chain_step(torch, A2, E2), 3)
        fl, nb = chain_work(CHAIN_TILED_B, CHAIN_TILED_N, c, D,
                            A2.element_size())
        b_ms, b_by = bound(fl, nb, BF16_PEAK if dtype == torch.bfloat16
                           else FP32_PEAK)
        tol = BF16_RTOL if dtype == torch.bfloat16 else KERNEL_RTOL
        tiled.append(dict(chi=c, dtype=dt, route=rt, max_rel_err=rel2,
                          repeat_same_bits=same2, ms=t, plain_ms=t_plain,
                          library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                          tflops_per_s=fl / t / 1e9))
        check(rt == "tiled" and counted["transfer_chain_tiled"] == 1,
              f"K6 at chi={c} {dt}: route {rt}, counted {counted}")
        check(rel2 <= tol and same2,
              f"K6 tiled (chi={c}, {dt}) disagrees with its twin: {rel2}, "
              f"repeat same bits {same2}")
        del A2, E2, out, ref
    emit(phase="k6_transfer_chain", shape=[B, N, chi, D], dtype="bfloat16",
         route=route, chained=R, launches=launches, route_counts=routes,
         max_rel_err_chain=rel, max_rel_err_one=one_rel, max_abs_err=err,
         repeat_same_bits=repeat, einsum_rel_err=lib_rel, ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
         bound_by=bound_by, tflops_per_s=flops / ms / 1e9,
         tiled=tiled, tiled_shape=[CHAIN_TILED_B, CHAIN_TILED_N])
    check(launches == R and routes["transfer_chain_resident"] == R,
          f"K6 launches in the chain {launches} ({routes}), expected {R} "
          "on the resident route")
    check(max(rel, one_rel) <= BF16_RTOL and repeat,
          f"K6 (bf16) disagrees with its twin: chain {rel}, one {one_rel}, "
          f"repeat same bits {repeat}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms), launches


def k9_phase(torch):
    """K9, the chained-GEMM probe: every ladder shape of
    benchmarks/mxu_micro.py against its twin at reps=2, then timed at its
    own reps.  The probe's entry point over the ladder is the path: the
    counts are set to 0 just before and read just after."""
    from tensornetwork_tpu_torch.benchmarks import mxu_micro as mx
    from tensornetwork_tpu_torch.ops import kernels as K
    ladder, ret = [], None
    inputs = {shape: mx.chain_inputs(*shape[:4], device=DEV)
              for shape in mx.LADDER}
    K.reset_launch_counts()
    sums = []
    for shape in mx.LADDER:
        M_, K_, N_, P_, reps = shape
        sums.append(float(mx.make_chain_kernel(M_, K_, N_, reps, P_)(
            *inputs[shape])))
    launches = K.launch_counts["gemm_chain"]
    check(launches == len(mx.LADDER),
          f"K9 launches over the ladder {launches}, expected {len(mx.LADDER)}")
    for shape, total in zip(mx.LADDER, sums):
        M_, K_, N_, P_, reps = shape
        x, b, c = inputs[shape]
        out = K.gemm_chain(x, b, c, 2)
        ref = K.gemm_chain_plain(x, b, c, 2)
        torch.cuda.synchronize()
        rel = max_rel(out.float(), ref.float())
        err = float((out.float() - ref.float()).abs().max())
        ms = cuda_ms(torch, lambda: K.gemm_chain(x, b, c, reps), 3)
        flops = mx.chain_flops(M_, K_, N_, P_, reps)
        row = dict(shape=list(shape), rel_err=rel, max_abs_err=err, ms=ms,
                   tflops_per_s=flops / ms / 1e9, sum_abs=total)
        ladder.append(row)
        check(rel <= BF16_RTOL and np.isfinite(total),
              f"K9 {shape} disagrees with its twin: {rel} (sum {total})")
        if shape == K9_SHAPE:
            plain_ms = cuda_ms(torch, lambda: K.gemm_chain_plain(x, b, c,
                                                                 reps), 1)
            nbytes = 2 * (2 * P_ * M_ * K_ + 2 * K_ * N_)
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            ret = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    emit(phase="k9_gemm_chain", launches=launches, ladder=ladder,
         shape_in_kernels_line=list(K9_SHAPE))
    return ret, launches


def state_delta_e(torch, As, mpo64):
    """E - REFERENCE_ENERGY of an MPS stack, evaluated in f64."""
    from tensornetwork_tpu_torch.models.dmrg import mps_mpo_expectation
    return float(mps_mpo_expectation(As.double(), mpo64.Ws, mpo64.vL,
                                     mpo64.vR)) - REFERENCE_ENERGY


def single_phase(torch):
    from tensornetwork_tpu_torch import FiniteTFI, one_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    # (qr_impl, lanczos_impl, epilogue_impl)
    runs = [("householder", "fused", "xla"), ("polar", "fused", "xla"),
            ("polar", "fused", "fused"), ("householder", "plain", "xla")]
    for qr_impl, lanczos_impl, epilogue_impl in runs:
        sweeps = SINGLE_SWEEPS if lanczos_impl == "fused" else 2
        As = random_mps_stack(0, N, CHI, D, dtype=torch.float32)
        renvs, times, energies = None, [], []
        for _ in range(sweeps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                 num_krylov_vecs=KRYLOV, qr_impl=qr_impl,
                                 lanczos_impl=lanczos_impl,
                                 epilogue_impl=epilogue_impl, renvs=renvs)
            e = float(res.energy)       # synchronises
            times.append(time.perf_counter() - t0)
            energies.append(e)
            As, renvs = res.As, res.renvs
        check(bool(torch.isfinite(As).all()) and As.shape == (N, CHI, D, CHI),
              "single-instance state not finite or misshapen")
        de = state_delta_e(torch, As, mpo64)
        rate = (len(times) - 1) / sum(times[1:])
        traced = {}
        if lanczos_impl == "fused":   # device time by kernel, one sweep
            busy_ms, top = device_busy_ms(torch, lambda: one_site_sweep(
                As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=KRYLOV,
                qr_impl=qr_impl, lanczos_impl=lanczos_impl,
                epilogue_impl=epilogue_impl, renvs=renvs), top=DEVICE_TOP)
            traced = dict(device_busy_ms=busy_ms, device_top=top)
        emit(phase="single_instance", qr_impl=qr_impl,
             lanczos_impl=lanczos_impl, epilogue_impl=epilogue_impl,
             sweeps=sweeps, delta_E=de,
             ritz_delta_E_per_sweep=[x - REFERENCE_ENERGY for x in energies],
             sweeps_per_s=rate, first_sweep_s=times[0], **traced)
        if lanczos_impl == "fused":
            check(DE_LO <= de <= DE_HI,
                  f"single instance ({qr_impl}, {epilogue_impl} epilogue) "
                  f"delta E {de} outside window")
        else:
            check(de >= DE_LO, f"plain route non-variational: {de}")


def device_busy_ms(torch, fn, top=0):
    """Sum of device time (kernels, copies) of fn() by torch.profiler; with
    ``top``, also the ``top`` entries that took the most device time, as
    [name, ms, count]."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            rows.append((us, ev.key[:60], ev.count))
    del prof
    gc.collect()   # the trace's ~10^5 event objects
    total_ms = sum(r[0] for r in rows) / 1e3
    if not top:
        return total_ms
    return total_ms, [[k, us / 1e3, n] for us, k, n in sorted(rows)[::-1][:top]]


def batched_phase(torch, epilogue_impl="xla"):
    """Chained one-site sweeps of B=256 TFI N=32 chains at chi=64 with the
    batched defaults, from the same random states for either site
    epilogue; with ``"fused"`` every site's gauge and environment growth
    is one K5 launch."""
    from tensornetwork_tpu_torch import FiniteTFI, batched_one_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    As = random_mps_stack(1, BATCH * N, CHI, D, dtype=torch.float32).reshape(
        BATCH, N, CHI, D, CHI)
    renvs, times, per_sweep, k5_per_sweep = None, [], [], []
    for _ in range(BATCH_SWEEPS):
        before = dict(K.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=KRYLOV,
                                     epilogue_impl=epilogue_impl, renvs=renvs)
        energy = res.energy.cpu().numpy()   # synchronises
        times.append(time.perf_counter() - t0)
        per_sweep.append(K.launch_counts["fused_lanczos"]
                         - before["fused_lanczos"])
        k5_per_sweep.append(K.launch_counts["fused_gauge_env"]
                            - before["fused_gauge_env"])
        As, renvs = res.As, res.renvs
    check(bool(torch.isfinite(As).all()) and res.energies.shape == (BATCH, N),
          "batched state not finite or misshapen")
    check(all(c == 2 * N for c in per_sweep),
          f"K2 launches per batched sweep {per_sweep}, expected {2 * N}")
    k5_want = ([K5_PER_SWEEP + N] + [K5_PER_SWEEP] * (BATCH_SWEEPS - 1)
               if epilogue_impl == "fused" else [0] * BATCH_SWEEPS)
    check(k5_per_sweep == k5_want,
          f"K5 launches per batched sweep {k5_per_sweep}, expected {k5_want}")
    ritz = energy.astype(np.float64) - REFERENCE_ENERGY
    de = np.array([state_delta_e(torch, a, mpo64) for a in As])
    sweep_s = statistics.median(times[1:])
    emit(phase="batched", epilogue_impl=epilogue_impl, batch=BATCH,
         sweeps=BATCH_SWEEPS,
         delta_E_median=float(np.median(de)), delta_E_min=float(de.min()),
         delta_E_max=float(de.max()),
         instances_in_window=int(np.sum((de >= DE_LO) & (de <= DE_HI))),
         ritz_delta_E_median=float(np.median(ritz)),
         ritz_delta_E_min=float(ritz.min()), ritz_delta_E_max=float(ritz.max()),
         instance_sweeps_per_s=BATCH / sweep_s, sweep_s=times,
         k2_launches_per_sweep=per_sweep, k5_launches_per_sweep=k5_per_sweep)
    check(bool(np.all((de >= DE_LO) & (de <= DE_HI))),
          f"batched ({epilogue_impl} epilogue) delta E in [{de.min()}, "
          f"{de.max()}], outside window")
    return As, renvs, mpo, sweep_s


def host_share_phase(torch, As, renvs, mpo, sweep_s, k2_ms,
                     epilogue_impl="xla", k5_ms=0.0):
    """Device time of one more batched sweep by torch.profiler; returns the
    device's idle share of the median sweep."""
    from tensornetwork_tpu_torch import batched_one_site_sweep

    def one_sweep():
        batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                               num_krylov_vecs=KRYLOV,
                               epilogue_impl=epilogue_impl, renvs=renvs)

    t0 = time.perf_counter()
    busy_ms, top = device_busy_ms(torch, one_sweep, top=DEVICE_TOP)
    idle = 1 - busy_ms / (1e3 * sweep_s)
    emit(phase="batched_device_time", epilogue_impl=epilogue_impl,
         sweep_ms=1e3 * sweep_s, device_busy_ms=busy_ms,
         device_idle_share=idle, k2_share=2 * N * k2_ms / (1e3 * sweep_s),
         k5_share=K5_PER_SWEEP * k5_ms / (1e3 * sweep_s), device_top=top,
         profile_seconds=time.perf_counter() - t0)
    return idle


def epilogue_ab_phase(torch, mpo, states):
    """The two site epilogues in turns on one card, so that the host's
    load, which drifts within a run, falls on both alike: chained B=256
    sweeps in the order xla, fused, fused, xla, xla, fused, each chain
    continuing from its own state ``states[impl] = (As, renvs)``.  Per
    sweep the host's enqueue time (until the sweep function returns) and
    the wall time (until its energy is on the host)."""
    from tensornetwork_tpu_torch import batched_one_site_sweep
    wall, enqueue = {"xla": [], "fused": []}, {"xla": [], "fused": []}
    for impl in ("xla", "fused", "fused", "xla", "xla", "fused"):
        As, renvs = states[impl]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=KRYLOV,
                                     epilogue_impl=impl, renvs=renvs)
        t1 = time.perf_counter()
        res.energy.cpu()   # synchronises
        wall[impl].append(time.perf_counter() - t0)
        enqueue[impl].append(t1 - t0)
        states[impl] = (res.As, res.renvs)
    out = {f"{impl}_{k}": v for impl in wall
           for k, v in (("wall_s", wall[impl]), ("enqueue_s", enqueue[impl]))}
    rates = {impl: BATCH / statistics.median(wall[impl]) for impl in wall}
    emit(phase="epilogue_ab", batch=BATCH, chi=CHI, **out,
         xla_instance_sweeps_per_s=rates["xla"],
         fused_instance_sweeps_per_s=rates["fused"],
         fused_over_xla=rates["fused"] / rates["xla"])
    return rates


def two_site_batched_phase(torch, k2_ms):
    """Two-site sweeps of B=256 TFI N=32 chains at chi=64 with the batched
    defaults (polar gauge, power Ritz, K2 at nt=4, subspace truncation),
    chained from random states; one more sweep is traced for the device's
    busy time.  ``k2_ms``: K2's time at this shape (k2_nt4_phase)."""
    from tensornetwork_tpu_torch import FiniteTFI, batched_two_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    As = random_mps_stack(2, BATCH * N, CHI, D, dtype=torch.float32).reshape(
        BATCH, N, CHI, D, CHI)

    def sweep(As, renvs):
        return batched_two_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                      num_krylov_vecs=KRYLOV_2S, renvs=renvs,
                                      **TRUNC_2S)

    renvs, times, per_sweep, terr = None, [], [], []
    for _ in range(BATCH_SWEEPS_2S):
        before = K.launch_counts["fused_lanczos"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(As, renvs)
        energy = res.energy.cpu().numpy()   # synchronises
        times.append(time.perf_counter() - t0)
        per_sweep.append(K.launch_counts["fused_lanczos"] - before)
        terr.append(float(res.trunc_err.max()))
        As, renvs = res.As, res.renvs
    check(bool(torch.isfinite(As).all()) and res.energies.shape == (BATCH, N - 1),
          "two-site batched state not finite or misshapen")
    check(all(c == 2 * (N - 1) for c in per_sweep),
          f"K2 launches per two-site sweep {per_sweep}, expected {2 * (N - 1)}")
    ritz = energy.astype(np.float64) - REFERENCE_ENERGY
    de = np.array([state_delta_e(torch, a, mpo64) for a in As])
    sweep_s = statistics.median(times[1:])
    busy_ms, top = device_busy_ms(torch, lambda: sweep(As, renvs),
                                  top=DEVICE_TOP)
    emit(phase="two_site_batched", batch=BATCH, chi=CHI, sweeps=BATCH_SWEEPS_2S,
         delta_E_median=float(np.median(de)), delta_E_min=float(de.min()),
         delta_E_max=float(de.max()),
         instances_in_window=int(np.sum((de >= DE_LO) & (de <= DE_HI))),
         ritz_delta_E_median=float(np.median(ritz)),
         trunc_err_max_per_sweep=terr,
         instance_sweeps_per_s=BATCH / sweep_s, sweep_s=times,
         device_busy_ms=busy_ms, device_top=top,
         device_idle_share=1 - busy_ms / (1e3 * sweep_s),
         k2_share=2 * (N - 1) * k2_ms / (1e3 * sweep_s),
         k2_launches_per_sweep=per_sweep)
    check(bool(np.all((de >= DE_LO) & (de <= DE_HI))),
          f"two-site batched delta E in [{de.min()}, {de.max()}], outside "
          "window")


def two_site_large_phase(torch, chi, tier, sweeps, matvec_ms):
    """Two-site sweeps of one TFI N=32 chain at bond dimension chi through
    the tier two_site_tier picks, from a random state.  The launch counts
    are set to 0 just before and read just after; returns them.
    ``matvec_ms``: the tier's kernel time of one matvec at this shape."""
    from tensornetwork_tpu_torch import FiniteTFI, two_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    taken = K.two_site_tier(chi, D, M, KRYLOV_2S)
    check(taken == tier, f"two-site chi={chi}: the router takes {taken}, "
          f"not {tier}")
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    As = random_mps_stack(chi + 1, N, chi, D, dtype=torch.float32)

    def sweep(As, renvs):
        return two_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                              num_krylov_vecs=KRYLOV_2S, renvs=renvs,
                              **TRUNC_2S)

    renvs, times, energies, terr, per_sweep = None, [], [], [], []
    K.reset_launch_counts()
    for _ in range(sweeps):
        before = dict(K.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(As, renvs)
        energies.append(float(res.energy))   # synchronises
        times.append(time.perf_counter() - t0)
        per_sweep.append({k: K.launch_counts[k] - before[k]
                          for k in K.launch_counts if K.launch_counts[k] - before[k]})
        terr.append(float(res.trunc_err))
        As, renvs = res.As, res.renvs
    launches = dict(K.launch_counts)
    check(bool(torch.isfinite(As).all()) and As.shape == (N, chi, D, chi),
          f"two-site chi={chi}: state not finite or misshapen")
    de = state_delta_e(torch, As, mpo64)
    sweep_s = statistics.median(times[1:])
    busy_ms, top = device_busy_ms(torch, lambda: sweep(As, renvs), top=6)
    matvecs = 2 * (N - 1) * KRYLOV_2S
    emit(phase="two_site_large", chi=chi, tier=tier, sweeps=sweeps,
         delta_E=de, ritz_delta_E_per_sweep=[e - REFERENCE_ENERGY
                                             for e in energies],
         trunc_err_per_sweep=terr, sweeps_per_s=1 / sweep_s,
         first_sweep_s=times[0], sweep_s=times,
         matvec_tflops_per_s=matvecs * matvec_work(1, chi, D * D, M)[0]
         / sweep_s / 1e12,
         kernel_share=matvecs * matvec_ms / (1e3 * sweep_s),
         device_busy_ms=busy_ms, device_top=top,
         device_idle_share=1 - busy_ms / (1e3 * sweep_s),
         launches_per_sweep=per_sweep)
    check(all(c == TIER_LAUNCHES_2S[tier] for c in per_sweep),
          f"two-site chi={chi}: launches per sweep {per_sweep}, expected "
          f"{TIER_LAUNCHES_2S[tier]}")
    check(DE_LO <= de <= DE_2S_HI,
          f"two-site chi={chi}: delta E {de} outside [{DE_LO}, {DE_2S_HI}]")
    del As, renvs, res
    torch.cuda.empty_cache()
    return launches


def variational_phase(torch):
    from tensornetwork_tpu_torch import FiniteDMRG, FiniteTFI, mpo_to_dense
    from tensornetwork_tpu_torch.models.dmrg import (mps_mpo_expectation,
                                                     random_mps_stack)
    n, chi = 10, 16
    mpo64 = FiniteTFI(1.0, 1.0, N=n, dtype=torch.float64)
    dense = torch.as_tensor(mpo_to_dense(mpo64), device=mpo64.Ws.device)
    exact = float(torch.linalg.eigvalsh(dense)[0])
    for dtype, tol in ((torch.float32, 5e-5), (torch.float64, 1e-9)):
        mpo = FiniteTFI(1.0, 1.0, N=n, dtype=dtype)
        for run in ("run_one_site", "run_two_site"):
            dm = FiniteDMRG(random_mps_stack(5, n, chi, D, dtype=dtype), mpo)
            e = getattr(dm, run)(num_sweeps=4, num_krylov_vecs=KRYLOV, tol=0.0)
            state = float(mps_mpo_expectation(dm.As.double(), mpo64.Ws,
                                              mpo64.vL, mpo64.vR))
            emit(phase="variational", run=run, N=n, chi=chi, dtype=str(dtype),
                 E=e, exact=exact, delta=e - exact,
                 state_delta_f64=state - exact)
            check(e >= exact - tol and abs(e - exact) < tol
                  and state >= exact - tol and abs(state - exact) < tol,
                  f"N={n} {dtype} {run}: E {e}, state {state} vs exact "
                  f"{exact}")


def large_chi_phase(torch, chi, tier, sweeps, solve_ms):
    """One-site sweeps of one TFI N=32 chain at bond dimension chi, through
    the tier the router picks.  The launch counts are set to 0 just before
    and read just after; returns them.  ``solve_ms``: the tier's kernel
    time of one local solve, measured by its kernel phase; one more sweep,
    after the counts are read, is traced for the device's busy time."""
    from tensornetwork_tpu_torch import FiniteTFI, one_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    taken = K.one_site_tier(chi, D, M, KRYLOV)
    check(taken == tier, f"chi={chi}: the router takes {taken}, not {tier}")
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    As = random_mps_stack(chi, N, chi, D, dtype=torch.float32)
    renvs, times, energies, per_sweep = None, [], [], []
    K.reset_launch_counts()
    for _ in range(sweeps):
        before = dict(K.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                             num_krylov_vecs=KRYLOV, renvs=renvs)
        energies.append(float(res.energy))   # synchronises
        times.append(time.perf_counter() - t0)
        per_sweep.append({k: K.launch_counts[k] - before[k]
                          for k in K.launch_counts if K.launch_counts[k] - before[k]})
        As, renvs = res.As, res.renvs
    launches = dict(K.launch_counts)
    check(bool(torch.isfinite(As).all()) and As.shape == (N, chi, D, chi),
          f"chi={chi}: state not finite or misshapen")
    de = state_delta_e(torch, As, mpo64)
    sweep_s = statistics.median(times[1:])
    busy_ms, top = device_busy_ms(torch, lambda: one_site_sweep(
        As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=KRYLOV, renvs=renvs),
        top=6)
    emit(phase="large_chi", chi=chi, tier=tier, sweeps=sweeps, delta_E=de,
         ritz_delta_E_per_sweep=[e - REFERENCE_ENERGY for e in energies],
         sweeps_per_s=1 / sweep_s, first_sweep_s=times[0], sweep_s=times,
         tflops_per_s=dmrg_sweep_flops(N, chi, D, M, KRYLOV) / sweep_s / 1e12,
         kernel_share=2 * N * solve_ms / (1e3 * sweep_s),
         device_busy_ms=busy_ms, device_top=top,
         device_idle_share=1 - busy_ms / (1e3 * sweep_s),
         launches_per_sweep=per_sweep)
    check(all(c == TIER_LAUNCHES[tier] for c in per_sweep),
          f"chi={chi}: launches per sweep {per_sweep}, expected "
          f"{TIER_LAUNCHES[tier]}")
    check(DE_LO <= de <= DE_LARGE_HI,
          f"chi={chi}: delta E {de} outside [{DE_LO}, {DE_LARGE_HI}]")
    del As, renvs, res
    torch.cuda.empty_cache()
    return launches


_KP = "tensornetwork_tpu/ops/kernels.py:"
KERNELS = (  # name, source, the TPU kernel it replaces
    ("heff_matvec", "heff_matvec.cu", _KP + "48"),
    ("fused_lanczos", "fused_lanczos.cu", _KP + "138"),
    ("fused_lanczos_2pass", "fused_lanczos_2pass.cu", _KP + "278"),
    ("fused_lanczos_streamed", "fused_lanczos_streamed.cu", _KP + "437"),
    ("fused_gauge_env", "fused_gauge_env.cu", _KP + "921"),
    ("transfer_chain", "transfer_chain.cu", _KP + "1081"),
    ("streamed_matvec", "streamed_matvec.cu", _KP + "1257"),
    ("streamed_matvec_xl", "streamed_matvec_xl.cu", _KP + "1380"),
    ("gemm_chain", "gemm_chain.cu", "benchmarks/mxu_micro.py:30"))


def main():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    from tensornetwork_tpu_torch.ops import kernels as K
    t_start = time.perf_counter()
    card = device_phase(torch)
    build_phase()
    meas = {"heff_matvec": k1_phase(torch), "fused_lanczos": k2_phase(torch),
            "fused_lanczos_2pass": k3_phase(torch),
            "fused_lanczos_streamed": k4_phase(torch)}
    meas["streamed_matvec"], k7_nt4_ms = k7_phase(torch)
    meas["streamed_matvec_xl"], k8_ms = k8_phase(torch)
    k2_nt4_ms = k2_nt4_phase(torch)
    meas["fused_gauge_env"] = k5_phase(torch)
    k2_ms, k5_ms = meas["fused_lanczos"]["ms"], meas["fused_gauge_env"]["ms"]

    # the chi=64 path: every count at 0 just before, read just after
    K.reset_launch_counts()
    single_phase(torch)
    As, renvs, mpo, sweep_s = batched_phase(torch)
    launches = dict(K.launch_counts)
    emit(phase="main_path_launches", chi=CHI, **launches)
    check(launches["fused_lanczos"] > 0 and launches["heff_matvec"] > 0
          and launches["fused_gauge_env"] > 0,
          f"a kernel of the main path never launched: {launches}")

    states = {"xla": (As, renvs)}

    # the batched chi=64 path with the fused epilogue, with its own counts
    K.reset_launch_counts()
    As, renvs, _, fused_s = batched_phase(torch, "fused")
    counts = dict(K.launch_counts)
    emit(phase="fused_epilogue_launches", chi=CHI, **counts)
    check(counts["fused_gauge_env"] > 0 and counts["fused_lanczos"] > 0,
          f"a kernel of the fused-epilogue path never launched: {counts}")
    launches["fused_gauge_env"] += counts["fused_gauge_env"]
    launches["fused_lanczos"] += counts["fused_lanczos"]
    states["fused"] = (As, renvs)
    # the two epilogues in turns, then each one's device time: the traced
    # sweeps come last, so that no timed sweep runs after a trace
    ab = epilogue_ab_phase(torch, mpo, states)
    xla_idle = host_share_phase(torch, *states["xla"], mpo, sweep_s, k2_ms)
    fused_idle = host_share_phase(torch, *states["fused"], mpo, fused_s,
                                  k2_ms, "fused", k5_ms)
    emit(phase="epilogue_compare", batch=BATCH, chi=CHI,
         xla_instance_sweeps_per_s=BATCH / sweep_s,
         fused_instance_sweeps_per_s=BATCH / fused_s,
         fused_over_xla=sweep_s / fused_s,
         in_turns_fused_over_xla=ab["fused"] / ab["xla"],
         xla_device_idle_share=xla_idle, fused_device_idle_share=fused_idle)
    del As, renvs, states
    torch.cuda.empty_cache()
    variational_phase(torch)

    # the two-site batched path, with its own counts
    K.reset_launch_counts()
    two_site_batched_phase(torch, k2_nt4_ms)
    counts = dict(K.launch_counts)
    emit(phase="two_site_batched_launches", chi=CHI, **counts)
    check(counts["fused_lanczos"] > 0, f"K2 never launched: {counts}")
    launches["fused_lanczos"] += counts["fused_lanczos"]

    # the large-chi paths, each with its own counts
    solve_ms = {"two_pass": meas["fused_lanczos_2pass"]["ms"],
                "streamed": meas["fused_lanczos_streamed"]["ms"],
                "streamed_matvec": KRYLOV * meas["streamed_matvec"]["ms"],
                "streamed_matvec_xl": KRYLOV * k8_ms["one_site"]}
    matvec_2s_ms = {"streamed_matvec": k7_nt4_ms,
                    "streamed_matvec_xl": k8_ms["two_site"]}
    launches["streamed_matvec_xl"] = 0
    for chi, tier, sweeps in LARGE_2S:
        counts = two_site_large_phase(torch, chi, tier, sweeps,
                                      matvec_2s_ms[tier])
        launches[tier] += counts[tier]
    for chi, tier, sweeps in LARGE_CHI:
        counts = large_chi_phase(torch, chi, tier, sweeps, solve_ms[tier])
        for name in TIER_LAUNCHES[tier]:
            launches[name] = launches.get(name, 0) + counts[name]
    launches["fused_lanczos_2pass"] = (launches.pop("fused_lanczos_fact")
                                       + launches.pop("fused_lanczos_replay"))

    # the transfer chain and the chained-GEMM probe, each its own path
    meas["transfer_chain"], launches["transfer_chain"] = k6_phase(torch)
    meas["gemm_chain"], launches["gemm_chain"] = k9_phase(torch)

    kernels = [dict(name=name, route="cuda",
                    source="tensornetwork_tpu_torch/csrc/" + src,
                    replaces=replaces, launches=launches[name], **meas[name])
               for name, src, replaces in KERNELS]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel never launched on its path: {launches}")
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
