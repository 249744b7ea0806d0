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
exact diagonalisation.  TDVP: K2 at the three shapes TDVP gives it
(the realified site and bond steps of the quench, the real bond step of
imaginary time); bench.py's batched real-time quench (B=64 chains at
chi=64, complex64, dt=0.05; K2 on realified operands, 4N launches a
sweep); N=10 against scipy's expm of the dense Hamiltonian; and
imaginary time at chi=64.  VUMPS on the infinite critical TFI chain
(bench.py's probe and convergence run): K2 at the two shapes its AC and C
solves give it (B=1, chi=64, m=25: nt=2 on <3,2>, nt=1 on <0,0>);
vumps_iteration's rate from a random chi=64 f32 state; vumps() from random
to a gauge error of 1e-4 in f32 and 1e-5 in f64 against the exact energy
density, and the f64 state's correlation length; then iTDVP of that state
in complex128 (no kernel), stationary in energy and <Z>.  Then ncon and
the graph core, where no kernel runs: the reference's README network (an
N=20, chi=32 MPS inner product in f32 and f64, by the zip con_order,
"greedy" and, at N=5, "optimal") against a float64 loop of transfer
matrices; B=256 MPS norms at N=32, chi=128, f32 as one batched ncon,
beside K6 on the same operands; the N=20 network as Nodes through
contractors.greedy and auto, a 4x4 double-layer PEPS norm through the
native path solver (built by g++ there) and greedy, split_node's p50
latency at 256x256 and 1024x1024, the QR/RQ/full-SVD splits and the JSON
round trip.  Then block-sparse U(1) DMRG, where no kernel runs either:
the bucketed executor against the per-sector loop at the chi=1024 middle
site; BASELINE.json's batched one-site XXZ sweeps at N=32, chi=1024, B=8
with per-realization couplings (plan build, rate, idle share, device
events, a two-site sweep, B=32); N=16 and SymmetricFiniteDMRG against
exact diagonalisation; block-sparse ncon and split_node.  Then the batched
MPS transfer chain at bench.py's
shape (B=256, N=32, chi=128, bf16, 8 chained applications; route
"resident") and on its route "tiled" (chi=256 bf16 and f32, chi=128 and
64 f32), and the chained-GEMM probe's 11-shape ladder (route "wgmma",
timed beside its WMMA route and a torch.matmul chain).  K1 runs at chi=64
for B=256 and the plain path's B=1, nt=2 and 4, on the route
heff_matvec_route picks, timed in turns with the first port's SIMT
kernel; its row of the kernels line is the path's shape, B=1, nt=2.
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
# K1 at chi=64: (B, nt) -- the batch at one- and two-site widths, and
# the single-instance plain path's B=1 (the kernels line takes (BATCH, D)).
K1_CASES = ((BATCH, D), (BATCH, D * D), (1, D), (1, D * D))
# The K9 ladder shape whose times stand in the kernels line: P=16
# independent 128-tile chains, the TPU transfer-chain kernel's tile
# structure (benchmarks/mxu_micro.py).
K9_SHAPE = (128, 128, 128, 16, 60)
# kernels listed per traced sweep (device time by kernel)
DEVICE_TOP = 8
# Batched real-time TDVP, bench.py:175-201: B=64 quenches of the chi=64 TFI
# chain from random real states, dt=0.05, m=10, complex64 on the _sc path
# (K2 on the realified operands: site nt'=4, bond nt'=2, M'=6); 2 warm
# sweeps, then 5 timed.  Every site and bond step is one K2 launch: 4N.
TDVP_B, TDVP_DT, TDVP_WARM, TDVP_TIMED = 64, 0.05, 2, 5
TDVP_PER_SWEEP = 4 * N
# One-site TDVP conserves <H> up to the Krylov error: the largest drift
# accepted over the timed sweeps, per site (a random state's E0 sits near
# 0, so not relative to it); the norm's; the overlap of instances 0-3 with
# the plain complex128 path after the timed sweeps.
TDVP_DRIFT_PER_SITE, TDVP_NORM_TOL, TDVP_OVERLAP_TOL = 1e-4, 1e-5, 1e-3
TDVP_PLAIN_B = 4
# K2 at TDVP's shapes: (case, B, d, M, real): the realified site (nt' = 2d
# = 4, M' = 2M = 6) and bond (nt' = 2) steps of the quench, and the real
# bond step of imaginary time (nt = 1, M = 3).  Each against its twin
# and an f64 run of the twin: the kernel within TDVP_K2_F64X the twin's
# error.
TDVP_K2_SHAPES = (("sc_site", TDVP_B, D, M, False),
                  ("sc_bond", TDVP_B, 1, M, False),
                  ("real_bond", 1, 1, M, True))
TDVP_K2_F64X = 3
# TDVP against scipy's expm of the dense H (tests/test_tdvp.py:48-67's
# bars): TFI (Jx=-1, Bz=-1.2), N=10, chi=32 (the full bond dimension), a
# product state, 25 steps of dt=0.02; (dtype, 1 - fidelity, |dE| or None)
EXACT_N, EXACT_CHI, EXACT_STEPS, EXACT_DT = 10, 32, 25, 0.02
EXACT_TOLS = (("complex128", 1e-8, 1e-8), ("complex64", 1e-4, None))
# Imaginary-time one-site TDVP of one chain (f32, K2 at nt=2 and nt=1):
# 10 sweeps of dt=0.1 from a random state; the f64 energy may rise by at
# most IMAG_RISE a sweep and ends above REFERENCE_ENERGY - IMAG_RISE
IMAG_SWEEPS, IMAG_DT, IMAG_RISE = 10, 0.1, 1e-5
# VUMPS on the infinite critical TFI chain (bench.py:140-173): W the bulk
# site N/2 of FiniteTFI(1, 1, N=32), chi=64, d=2, M=3, m=25 Krylov vectors;
# the AC and C solves run K2 at B=1 (AC nt=2, the compile-time instance
# <3,2>; C nt=1 with identity couplings, the run-time <0,0>).
VUMPS_CHI, VUMPS_KRYLOV = 64, 25
VUMPS_K2_SHAPES = (("ac", D), ("c", 1))
# The probe: vumps_iteration with its defaults (4 Lanczos passes a solve,
# GMRES(30) x 2, cold fixed-point seeds), 1 warm + 10 + 8 timed iterations.
# After 19 iterations from random the energy need not be converged: the
# state must be variational to f32 noise and within VUMPS_PROBE_DE of
# -4/pi.
VUMPS_PROBE = (1, 10, 8)
VUMPS_PROBE_DE = 1e-2
# The convergence runs from random: bench.py:160-171's f32 run (gauge
# error below 1e-4 within 80 iterations, |e - e_exact| below 1e-5), and
# in f64 the bars of tests/test_vumps.py:161-180 (gauge error below 1e-5
# in fewer than 40 iterations, no rise above 2.5x after the third,
# |e - e_exact| below 1e-6).
VUMPS_F32 = dict(num_iterations=80, tol=1e-4, gmres_m=40, gmres_restarts=8)
VUMPS_F32_DE = 1e-5
VUMPS_F64 = dict(num_iterations=60, tol=1e-5, gmres_m=40, gmres_restarts=8)
VUMPS_F64_ITERS, VUMPS_F64_DE, VUMPS_TAIL_RISE = 40, 1e-6, 2.5
# iTDVP of the f64 ground state in complex128, t=0.3 in 6 steps: energy and
# <Z> stationary (tests/test_vumps.py:88-103's bars)
ITDVP_T, ITDVP_STEPS, ITDVP_DE, ITDVP_DZ = 0.3, 6, 1e-6, 1e-3
# TEBD on the FiniteMPS: (a) the mps_dmrg ground state quenched to h=1.2
# (bond term J X X + h/2 (Z 1 + 1 Z)), dt=0.05, 10 real-time steps at
# chi=64, complex64 against complex128 (overlap >= 1 - TDVP_OVERLAP_TOL);
# (b) examples/wavefunctions.py's h2, dt and steps from a product state at
# N=20 against evolve_exact (fidelity above TEBD_EXACT_FID: 0.99939 on an
# NVIDIA H100 80GB HBM3 at 700 W; tests/test_mera_tebd_imps.py's bar at
# N=6 is 0.995); (c) imaginary time from random, dt=0.1, 15 steps, every
# step's energy below the last.
TEBD_QUENCH_H, TEBD_DT, TEBD_STEPS = 1.2, 0.05, 10
TEBD_EXACT_N, TEBD_EXACT_DT, TEBD_EXACT_STEPS, TEBD_EXACT_FID = 20, 0.02, 25, \
    0.999
TEBD_IMAG_DT, TEBD_IMAG_STEPS = 0.1, 15
# <X_0 X_j> of the VUMPS state for j <= 64.  Its transfer matrix's second
# eigenvalue is near -0.9996 (xi ~ 2800): canonicalize's default 30 Krylov
# vectors leave the right fixed point unresolved and eta off 1 (by 9.3e-5
# on an NVIDIA H100 80GB HBM3 at 700 W; reported), 200 resolve it (eta
# within 2e-15 there): the eta bar is on that run.
IMPS_CORR_J, IMPS_KRYLOV = 64, 200
# examples/simple_mera.py's model, 60 iterations as in
# tests/test_mera_tebd_imps.py's test_mera_critical_ising_energy
MERA_LAYERS, MERA_ITERS = 3, 60
# batched sweeps with qr_impl="polar_express"; TDVP of a FiniteMPS on the
# split-complex path (K2 on <0,0>, 4N launches a sweep)
EXPRESS_SWEEPS = 4
SC_TDVP_DT, SC_TDVP_SWEEPS = 0.05, 2
# ncon and the graph core (no kernel on these paths).  The reference's
# README network: <psi|psi> of a random MPS, N=20, chi=32, d=2, each site
# scaled by 1/sqrt(d chi_right) so that the f32 value is O(1) (unscaled it
# is ~5e37, within 10x of f32 overflow); checked against a float64 loop
# of transfer matrices (relative 1e-5 in f32, 1e-12 in f64).
# con_order="optimal" is the exhaustive search of the JAX package
# (opt_einsum's "optimal"): ~15x the host time a site (0.09 s at N=5 on a
# CPU), so it runs at NCON_OPTIMAL_N.
NCON_N, NCON_CHI, NCON_REPS, NCON_OPTIMAL_N = 20, 32, 20, 5
NCON_RTOL = {"float32": 1e-5, "float64": 1e-12}
# BASELINE.json's "batched bond-dim-128 MPS contractions": B=256 norms at
# N=32, chi=128, d=2, f32 (1.07 GB an MPS), one ncon with a batch label
# on every site tensor; against a batched float64 loop (relative 1e-4)
NCON_B, NCON_B_N, NCON_B_CHI, NCON_B_RTOL = 256, 32, 128, 1e-4
# graph core: a 4x4 double-layer PEPS norm (D=2, bonds D^2 = 4; 16
# tensors, so contractors.auto takes the native subset-DP solver;
# contractors.optimal's exhaustive search cannot finish at 16), against a
# row-by-row float64 contraction; split_node p50 latency over SPLIT_REPS
# calls on two-site tensors (chi, d, d, chi) of rank chi, f32, as
# (chi d) x (d chi) matrices, truncated to chi (exact at that rank:
# reconstruction within SPLIT_RTOL)
PEPS_L, PEPS_D = 4, 2
SPLIT_CHIS, SPLIT_REPS, SPLIT_RTOL = (128, 512), 20, 1e-5


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


def k2_instance(M, nt):
    """The f32 template instance tn_fused_lanczos_f32 dispatches (M, nt)
    to (csrc/fused_lanczos.cu): compile-time <3,2> and <3,4>, else the
    run-time <0,0>."""
    import torch
    from tensornetwork_tpu_torch.ops import kernels as K
    return "launch_" + K.fused_lanczos_instance(M, nt, torch.float32)


def k2_work(B, chi, nt, M, m):
    """(flops, bytes) of K2 at nt tiles and MPO bond M (f32): m matvecs
    (2*M*nt chi x chi GEMMs and the coupling fold) and ~10 vector flops per
    element a step; L, R, x0, W read once, V and (alpha, beta) written."""
    mv_flops, _ = matvec_work(B, chi, nt, M)
    flops = m * (mv_flops + 10 * B * nt * chi * chi)
    nbytes = 4 * (B * ((2 * M + nt + m * nt) * chi ** 2 + 2 * m)
                  + M * M * nt * nt)
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
    """K1 at chi=64 for each (B, nt) of K1_CASES on the route
    heff_matvec_route picks, against its twin (and its repeat launch), the
    SIMT kernel of the first port (never routed for f32) timed in turns
    with it on the same operands, with both bounds and the f64 error
    beside the twin's.  Returns the numbers at the main path's shape
    (B=1, nt=D: the single-instance plain path's every K1 launch)."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    cases, ret = [], None
    for B, nt in K1_CASES:
        sol, (Lt, W_, Rt, xt) = hermitian_operands(torch, B, CHI, nt, M,
                                                   seed=1)
        route = K.heff_matvec_route(CHI, nt, M, B, torch.float32)
        with highest_precision():
            K.reset_launch_counts()
            y = K.heff_matvec(Lt, W_, Rt, xt)
            counted = {r: K.route_counts["heff_matvec_" + r]
                       for r in ("tc32", "simt")}
            y_plain = K.heff_matvec_plain(Lt, W_, Rt, xt)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all()), "K1 output not finite")
            rel, err = max_rel(y, y_plain), float((y - y_plain).abs().max())
            same = bool(torch.equal(y, K.heff_matvec(Lt, W_, Rt, xt)))
            calls = {route: lambda: K.heff_matvec(Lt, W_, Rt, xt),
                     "simt": lambda: K.heff_matvec_simt(Lt, W_, Rt, xt)}
            turns = {r: [] for r in calls}
            for r in (route, "simt", "simt", route):
                turns[r].append(cuda_ms(torch, calls[r], 20))
            route_ms = {r: sum(t) / len(t) for r, t in turns.items()}
            plain_ms = cuda_ms(torch, lambda: K.heff_matvec_plain(
                Lt, W_, Rt, xt), 20)
            lib_ms = cuda_ms(torch, lambda: K.heff_matvec_reference(*sol), 20)
            y_lib = K.heff_matvec_reference(*sol)
            lib_err = max_rel(K.finalize_output(y), y_lib)
            errs = f64_errors(torch, sol, y, y_plain, y_lib)
        flops, nbytes = matvec_work(B, CHI, nt, M)
        bound_ms, bound_by = bound(flops, nbytes)
        cases.append(dict(shape=[B, CHI, nt, M], route=route,
                          route_counts=counted, max_rel_err=rel,
                          max_abs_err=err, repeat_same_bits=same,
                          einsum_rel_err=lib_err, f64_rel_err=errs,
                          ms=route_ms[route], route_ms=route_ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          bound_tc_ms=bound_tc(flops, nbytes)[0]))
        check(counted[route] == 1 and sum(counted.values()) == 1,
              f"K1 at B={B} nt={nt} took routes {counted}, expected {route}")
        check(route == "tc32", f"K1 f32 at B={B} nt={nt} left the tensor cores")
        check(rel <= KERNEL_RTOL and same,
              f"K1 (B={B}, nt={nt}) disagrees with its twin: {rel}, repeat "
              f"same bits {same}")
        check(errs["kernel"] <= 2 * errs["twin"],
              f"K1 (B={B}, nt={nt}) f64 error {errs['kernel']} above 2x the "
              f"twin's {errs['twin']}")
        if (B, nt) == (1, D):
            ret = dict(max_abs_err=err, ms=route_ms[route], plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms, k1_route=route,
                       k1_shape=[B, CHI, nt, M], simt_ms=route_ms["simt"])
        del sol, Lt, W_, Rt, xt, y, y_plain, y_lib
    emit(phase="k1_heff_matvec", cases=cases)
    return ret


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
    flops, nbytes = k2_work(BATCH, CHI, nt, M, KRYLOV_2S)
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
    the batched path's shape (B=256, chi=64), at B=1, chi=256 and at B=1,
    chi=64, in both directions, f32; and in f64 at a small shape.  Each
    case runs the route gauge_env_route picks and is timed beside the other
    route on the same operands where that one takes the shape.  The
    solver-layout wrappers are checked to return the kernel-layout call's
    bits, and a repeat launch to give the same bits."""
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
        route = K.gauge_env_route(chi, D, M, dtype, B)
        # the grid route takes every shape; the resident one only its own
        other = ("grid" if route == "resident" else "resident"
                 if K.gauge_env_resident_fits(chi, D, M, dtype) else None)
        for side in ("left", "right"):
            # the operands as the wrappers prepare them
            if side == "left":
                Wk, Ak = W, A.permute(0, 2, 1, 3).reshape(B, D * chi, chi)
            else:
                Wk = W.permute(1, 0, 2, 3).contiguous()
                Ak = A.permute(0, 2, 3, 1).reshape(B, D * chi, chi)
            Ek, Ak = env.permute(0, 2, 1, 3).contiguous(), Ak.contiguous()
            with highest_precision():
                K.reset_launch_counts()
                out = K.fused_gauge_env(Wk, Ek, Ak, qi, ci)
                took = K.route_counts["fused_gauge_env_" + route]
                ref = K.fused_gauge_env_plain(Wk, Ek, Ak, qi, ci)
                wrapped = getattr(K, f"fused_gauge_env_{side}")(env, W, A, qi,
                                                                ci)
                again = K.fused_gauge_env(Wk, Ek, Ak, qi, ci)
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
                other_ms = (cuda_ms(torch, lambda: K.fused_gauge_env(
                    Wk, Ek, Ak, qi, ci, route=other), 5) if other else None)
                grid = K.last_grid["fused_gauge_env"]
                plain_ms = cuda_ms(torch, lambda: K.fused_gauge_env_plain(
                    Wk, Ek, Ak, qi, ci), 3)
            Qw = wrapped[0].permute(0, 2, 1, 3) if side == "left" else \
                wrapped[0].permute(0, 2, 3, 1)
            Pw = wrapped[1] if side == "left" else wrapped[1].mT
            same = bool(torch.equal(Qw.reshape(B, D * chi, chi), out[0])
                        and torch.equal(Pw, out[1])
                        and torch.equal(wrapped[2].permute(0, 2, 1, 3), out[2]))
            repeat = all(bool(torch.equal(a, b)) for a, b in zip(out, again))
            elem = torch.finfo(dtype).bits // 8
            flops, nbytes = gauge_env_work(B, chi, D, M, qi, ci, elem)
            bound_ms, bound_by = bound(flops, nbytes,
                                       FP32_PEAK if dtype == torch.float32
                                       else FP64_PEAK)
            bound_tc_ms = (bound_tc(flops, nbytes)[0]
                           if dtype == torch.float32 else None)
            emit(phase="k5_fused_gauge_env", side=side, dtype=str(dtype),
                 shape=[B, chi, D, M], iters=[qi, ci], route=route,
                 max_rel_err_Q_P_Enew=rels, max_abs_err=err,
                 isometry_err=iso, reconstruction_rel_err=recon,
                 wrappers_equal_kernel=same, repeat_same_bits=repeat,
                 grid=grid, ms=ms, other_route=other, other_route_ms=other_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 bound_tc_ms=bound_tc_ms, tflops_per_s=flops / ms / 1e9,
                 seconds_since_case_start=time.perf_counter() - t0)
            check(took == 1, f"K5 (B={B}, chi={chi}) did not take route {route}")
            tol = KERNEL_RTOL if dtype == torch.float32 else 1e-10
            check(max(rels) <= tol,
                  f"K5 ({side}, B={B}, chi={chi}, {dtype}) disagrees with "
                  f"its twin: {rels}")
            check(iso <= 1e-4 and recon <= 1e-4,
                  f"K5 ({side}, B={B}, chi={chi}): |Q^T Q - I| {iso}, "
                  f"|QP - A|/|A| {recon}")
            check(same, f"K5 {side} wrapper does not return the kernel's bits")
            check(repeat, f"K5 ({side}, B={B}, chi={chi}) repeat launch "
                  "changed the bits")
            if ret is None:
                ret = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None, bound_tc_ms=bound_tc_ms,
                           k5_route=route, other_route_ms=other_ms)
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


def matmul_chain(torch, x, b, c, reps):
    """The chained products as 2 reps bf16 torch.matmul calls over the (P,
    M, K) batch (cuBLAS, f32 accumulation, bf16 out): K9's yardstick."""
    for _ in range(reps):
        x = torch.matmul(torch.matmul(x, b), c)
    return x


def k9_phase(torch):
    """K9, the chained-GEMM probe: every ladder shape of
    benchmarks/mxu_micro.py against its twin at reps=2 (and its repeat
    launch), then timed at its own reps on the route gemm_chain_route
    picks, beside the WMMA route and the torch.matmul chain on the same
    operands.  The probe's entry point over the ladder is the path: the
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
    routes = {r: K.route_counts["gemm_chain_" + r] for r in ("wgmma", "wmma")}
    check(launches == len(mx.LADDER) and routes["wgmma"] == launches,
          f"K9 launches over the ladder {launches} (routes {routes}), "
          f"expected {len(mx.LADDER)} on the wgmma route")
    for shape, total in zip(mx.LADDER, sums):
        M_, K_, N_, P_, reps = shape
        x, b, c = inputs[shape]
        route = K.gemm_chain_route(M_, K_, N_, P_)
        out = K.gemm_chain(x, b, c, 2)
        ref = K.gemm_chain_plain(x, b, c, 2)
        torch.cuda.synchronize()
        rel = max_rel(out.float(), ref.float())
        err = float((out.float() - ref.float()).abs().max())
        same = bool(torch.equal(out, K.gemm_chain(x, b, c, 2)))
        wmma_rel = max_rel(K.gemm_chain(x, b, c, 2, route="wmma").float(),
                           ref.float())
        ms = cuda_ms(torch, lambda: K.gemm_chain(x, b, c, reps), 3)
        wmma_ms = cuda_ms(torch, lambda: K.gemm_chain(x, b, c, reps,
                                                      route="wmma"), 3)
        chain_ms = cuda_ms(torch, lambda: matmul_chain(torch, x, b, c, reps),
                           3)
        flops = mx.chain_flops(M_, K_, N_, P_, reps)
        plan = K.gemm_chain_plan(M_, K_, N_)
        row = dict(shape=list(shape), route=route, plan=plan._asdict(),
                   rel_err=rel, max_abs_err=err, repeat_same_bits=same,
                   wmma_rel_err=wmma_rel, ms=ms,
                   tflops_per_s=flops / ms / 1e9, other_route_ms=wmma_ms,
                   chain_ms=chain_ms, sum_abs=total)
        ladder.append(row)
        check(route == "wgmma", f"K9 {shape} routed to {route}")
        check(rel <= BF16_RTOL and wmma_rel <= BF16_RTOL and same
              and np.isfinite(total),
              f"K9 {shape} disagrees with its twin: {rel} (WMMA {wmma_rel}, "
              f"repeat same bits {same}, sum {total})")
        if shape == K9_SHAPE:
            plain_ms = cuda_ms(torch, lambda: K.gemm_chain_plain(x, b, c,
                                                                 reps), 1)
            nbytes = 2 * (2 * P_ * M_ * K_ + 2 * K_ * N_)
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            ret = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=chain_ms)
    emit(phase="k9_gemm_chain", launches=launches, route_counts=routes,
         ladder=ladder, shape_in_kernels_line=list(K9_SHAPE),
         library_ms_is="chain: 2 reps bf16 torch.matmul calls")
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
        check(DE_LO <= de <= DE_HI,
              f"single instance ({qr_impl}, {lanczos_impl} Lanczos, "
              f"{epilogue_impl} epilogue) delta E {de} outside window")


def device_rows(torch, fn):
    """[(device us, name, count)] of fn()'s device events (kernels,
    copies) by torch.profiler, summed by name from the raw trace (a
    key_averages() of a sweep's ~3e5 events took about a minute)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch._C._autograd.DeviceType.CUDA
    sums = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            row = sums.setdefault(ev.name()[:60], [0.0, 0])
            row[0] += ev.duration_ns() / 1e3
            row[1] += 1
    del prof
    gc.collect()   # the trace's ~10^5 event objects
    return [(us, name, n) for name, (us, n) in sums.items() if us]


def device_busy_ms(torch, fn, top=0):
    """Sum of device time (kernels, copies) of fn() by torch.profiler; with
    ``top``, also the ``top`` entries that took the most device time, as
    [name, ms, count]."""
    rows = device_rows(torch, fn)
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


def tdvp_k2_operands(torch, B, chi, d, Mc, real, seed):
    """K2's kernel-layout operands at a TDVP step: Hermitian complex L, R
    (L[a,w,c] = conj L[c,w,a]) realified with a real symmetric W (d = 2)
    or the identity couplings of the bond step (d = 1); with ``real``, the
    real parts and the real kernel layout."""
    from tensornetwork_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(seed)

    def herm(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return (a + a.transpose(0, 3, 2, 1).conj()) / (2 * chi)

    L, R = herm(B, chi, Mc, chi), herm(B, chi, Mc, chi)
    x = rng.standard_normal((B, chi, d, chi)) + 1j * rng.standard_normal(
        (B, chi, d, chi))
    W = rng.standard_normal((Mc, Mc, d, d))
    W = (W + W.transpose(1, 0, 3, 2)) / 2 if d > 1 else np.eye(Mc).reshape(
        Mc, Mc, 1, 1)
    dev = torch.device(DEV)
    if real:
        return K.prepare_operands(*(torch.as_tensor(
            a.real, dtype=torch.float32, device=dev) for a in (L, W, R, x)))
    cplx = [torch.as_tensor(a, dtype=torch.complex64, device=dev)
            for a in (L, R, x)]
    Wt = torch.as_tensor(W, dtype=torch.float32, device=dev)
    return K.realify_sandwich_operands(cplx[0], Wt, cplx[1], cplx[2])


def k2_tdvp_phase(torch):
    """K2 at the three shapes TDVP gives it (TDVP_K2_SHAPES), f32: against
    its twin and an f64 run of the twin, timed by CUDA events beside the
    twin and the 3xTF32 bound, with the template instance that ran."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    for seed, (case, B, d, Mc, real) in enumerate(TDVP_K2_SHAPES):
        ops = tdvp_k2_operands(torch, B, CHI, d, Mc, real, 100 + seed)
        Mk, nt = ops[1].shape[0], ops[1].shape[2]
        with highest_precision():
            V, ab = K.fused_lanczos(*ops, KRYLOV)
            V0, ab0 = K.fused_lanczos_plain(*ops, KRYLOV)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(V).all() and torch.isfinite(ab).all()),
                  f"K2 ({case}) output not finite")
            rel_ab, rel_V = max_rel(ab, ab0), max_rel(V, V0)
            f64 = lanczos_f64_errors(torch, ops, V, ab, V0, ab0, KRYLOV)
            ms = cuda_ms(torch, lambda: K.fused_lanczos(*ops, KRYLOV), 10)
            plain_ms = cuda_ms(
                torch, lambda: K.fused_lanczos_plain(*ops, KRYLOV), 3)
        flops, nbytes = k2_work(B, CHI, nt, Mk, KRYLOV)
        bound_tc_ms, bound_by = bound_tc(flops, nbytes)
        emit(phase="k2_tdvp", case=case, shape=[B, CHI, nt, Mk, KRYLOV],
             instance=k2_instance(Mk, nt), max_rel_err_ab=rel_ab,
             max_rel_err_V=rel_V, f64_rel_err=f64, ms=ms, plain_ms=plain_ms,
             bound_tc_ms=bound_tc_ms, bound_by=bound_by,
             tflops_per_s=flops / ms / 1e9)
        check(f64["kernel_ab"] <= TDVP_K2_F64X * f64["twin_ab"]
              and f64["kernel_V"] <= TDVP_K2_F64X * f64["twin_V"],
              f"K2 ({case}) against f64 beyond {TDVP_K2_F64X}x its f32 "
              f"twin: {f64}")
        del V, ab, V0, ab0, ops
    torch.cuda.empty_cache()


def mps_overlaps(torch, A, B):
    """<A|B> of each instance of two batched stacks (b, N, chi, d, chi),
    identity boundary environments (the sweeps' convention), complex128."""
    A, B = A.to(torch.complex128), B.to(torch.complex128)
    nb, chi = A.shape[0], A.shape[2]
    E = torch.eye(chi, dtype=A.dtype, device=A.device).expand(nb, chi, chi)
    for i in range(A.shape[1]):
        E = torch.einsum("Bac,Basb,Bcsd->Bbd", E, A[:, i].conj(), B[:, i])
    return E.diagonal(dim1=1, dim2=2).sum(-1)


def tdvp_energies(torch, psi, mpo64):
    """<psi|H|psi>/<psi|psi> of each instance, evaluated in f64."""
    from tensornetwork_tpu_torch.models.tdvp import mps_mpo_expectation_sc
    return np.array([float(mps_mpo_expectation_sc(
        a.to(torch.complex128), mpo64.Ws, mpo64.vL, mpo64.vR).real)
        for a in psi])


def tdvp_batched_phase(torch):
    """bench.py's batched real-time quench on the _sc path: B=64 TFI N=32
    chains at chi=64 from random real states, dt=0.05, m=10, complex64.
    2 warm sweeps, 5 timed by CUDA events with their K2 launches, one more
    traced for the device's busy time; norms, the f64 energy drift per
    site, and instances 0-3 against the plain path in complex128."""
    from tensornetwork_tpu_torch import FiniteTFI
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    from tensornetwork_tpu_torch.parallel.batch import (
        batched_tdvp_one_site_sweep_sc)
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    psi = random_mps_stack(6, TDVP_B * N, CHI, D, dtype=torch.float32).reshape(
        TDVP_B, N, CHI, D, CHI).to(torch.complex64)

    def sweep(p, mpo=mpo, impl=None):
        return batched_tdvp_one_site_sweep_sc(
            p, mpo.Ws, mpo.vL, mpo.vR, TDVP_DT, num_krylov_vecs=KRYLOV,
            lanczos_impl=impl)

    for _ in range(TDVP_WARM):
        psi = sweep(psi)
    start, e0 = psi, tdvp_energies(torch, psi, mpo64)
    ms, per_sweep = [], []
    for _ in range(TDVP_TIMED):
        before = K.launch_counts["fused_lanczos"]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        psi = sweep(psi)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        per_sweep.append(K.launch_counts["fused_lanczos"] - before)
    check(bool(torch.isfinite(torch.view_as_real(psi)).all())
          and psi.shape == (TDVP_B, N, CHI, D, CHI),
          "TDVP batch not finite or misshapen")
    norms = mps_overlaps(torch, psi, psi).real.sqrt().cpu().numpy()
    drift = np.abs(tdvp_energies(torch, psi, mpo64) - e0) / N
    ref = start[:TDVP_PLAIN_B].to(torch.complex128)
    for _ in range(TDVP_TIMED):
        ref = sweep(ref, mpo64, "plain")
    mine = psi[:TDVP_PLAIN_B]
    overlap = (mps_overlaps(torch, mine, ref).abs() / (
        mps_overlaps(torch, mine, mine).real
        * mps_overlaps(torch, ref, ref).real).sqrt()).cpu().numpy()
    sweep_ms = statistics.median(ms)
    t0 = time.perf_counter()
    busy_ms, top = device_busy_ms(torch, lambda: sweep(psi), top=DEVICE_TOP)
    emit(phase="tdvp_batched", batch=TDVP_B, chi=CHI, dt=TDVP_DT,
         sweeps=[TDVP_WARM, TDVP_TIMED], sweep_ms=ms,
         instance_sweeps_per_s=TDVP_B / (sweep_ms / 1e3),
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / sweep_ms,
         device_top=top, profile_seconds=time.perf_counter() - t0,
         k2_launches_per_sweep=per_sweep, norm_err_max=float(
             np.abs(norms - 1).max()), drift_per_site_max=float(drift.max()),
         e0_median=float(np.median(e0)),
         plain_overlap_min=float(overlap.min()))
    check(all(c == TDVP_PER_SWEEP for c in per_sweep),
          f"K2 launches per TDVP sweep {per_sweep}, expected {TDVP_PER_SWEEP}")
    check(bool(np.all(np.abs(norms - 1) <= TDVP_NORM_TOL)),
          f"TDVP norms off 1 by up to {np.abs(norms - 1).max()}")
    check(bool(np.all(drift < TDVP_DRIFT_PER_SITE)),
          f"TDVP energy drift per site up to {drift.max()}")
    check(bool(np.all(overlap >= 1 - TDVP_OVERLAP_TOL)),
          f"TDVP states against the plain complex128 path: {overlap}")


def dense_from_stack(As):
    """The boundary block [0, :, 0] of a stacked MPS as a state vector."""
    acc = As[0]
    for A in As[1:]:
        acc = np.einsum("a...b,bsc->a...sc", acc, A)
    return acc.reshape(As.shape[1], -1, As.shape[1])[0, :, 0]


def tdvp_exact_phase(torch):
    """TDVP from a product state against scipy's expm of the dense H: the
    _sc path (TDVP(split_complex=True), the realified K2 at every step)
    and the complex-dtype path (no kernel in real time), in complex128 and
    complex64."""
    import scipy.linalg as sla
    from tensornetwork_tpu_torch import FiniteTFI, mpo_to_dense
    from tensornetwork_tpu_torch.models.tdvp import TDVP
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(-1.0, -1.2, N=EXACT_N, dtype=torch.float64)
    v = np.array([1.0, 0.6]) / np.hypot(1.0, 0.6)
    psi0 = np.array([1.0])
    for _ in range(EXACT_N):
        psi0 = np.kron(psi0, v)
    t = EXACT_STEPS * EXACT_DT
    psi_t = sla.expm(-1j * t * mpo_to_dense(mpo)) @ psi0
    for name, fid_tol, de_tol in EXACT_TOLS:
        dtype = getattr(torch, name)
        for sc in (True, False):
            As = torch.zeros((EXACT_N, EXACT_CHI, D, EXACT_CHI), dtype=dtype,
                             device=DEV)
            As[:, 0, :, 0] = torch.as_tensor(v, dtype=dtype)
            before = K.launch_counts["fused_lanczos"]
            t0 = time.perf_counter()
            tdvp = TDVP(As, mpo, split_complex=sc)
            e0 = tdvp.energy()
            tdvp.evolve(t, EXACT_STEPS)
            de = tdvp.energy() - e0
            seconds = time.perf_counter() - t0
            launches = K.launch_counts["fused_lanczos"] - before
            vec = dense_from_stack(tdvp.As.cpu().numpy())
            infid = 1 - abs(np.vdot(vec / np.linalg.norm(vec), psi_t))
            emit(phase="tdvp_exact", dtype=name, split_complex=sc, N=EXACT_N,
                 chi=EXACT_CHI, steps=EXACT_STEPS, dt=EXACT_DT,
                 infidelity=float(infid), delta_E=de, k2_launches=launches,
                 seconds=seconds)
            want = EXACT_STEPS * 4 * EXACT_N if sc else 0
            check(launches == want,
                  f"TDVP exact ({name}, sc={sc}): {launches} K2 launches, "
                  f"expected {want}")
            check(infid < fid_tol and (de_tol is None or abs(de) < de_tol),
                  f"TDVP exact ({name}, sc={sc}): 1 - fidelity {infid}, "
                  f"delta E {de}")


def tdvp_imaginary_phase(torch):
    """Imaginary-time one-site TDVP of one TFI N=32 chain at chi=64, f32,
    from a random state: K2 at the site (nt=2) and bond (nt=1) steps, 4N
    launches a sweep; the f64 energy falls and stays variational."""
    from tensornetwork_tpu_torch import FiniteTFI
    from tensornetwork_tpu_torch.models.dmrg import (mps_mpo_expectation,
                                                     random_mps_stack)
    from tensornetwork_tpu_torch.models.tdvp import tdvp_one_site_sweep
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    As = random_mps_stack(7, N, CHI, D, dtype=torch.float32)

    def energy(As):
        return float(mps_mpo_expectation(As.double(), mpo64.Ws, mpo64.vL,
                                         mpo64.vR))

    energies, per_sweep, times = [energy(As)], [], []
    for _ in range(IMAG_SWEEPS):
        before = K.launch_counts["fused_lanczos"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        As = tdvp_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR, IMAG_DT,
                                 num_krylov_vecs=KRYLOV, imaginary=True)
        energies.append(energy(As))    # synchronises
        times.append(time.perf_counter() - t0)
        per_sweep.append(K.launch_counts["fused_lanczos"] - before)
    rise = float(np.max(np.diff(energies)))
    emit(phase="tdvp_imaginary", N=N, chi=CHI, dt=IMAG_DT,
         delta_E_per_sweep=[e - REFERENCE_ENERGY for e in energies],
         largest_rise=rise, sweep_s=times, k2_launches_per_sweep=per_sweep)
    check(all(c == TDVP_PER_SWEEP for c in per_sweep),
          f"K2 launches per imaginary-time sweep {per_sweep}, expected "
          f"{TDVP_PER_SWEEP}")
    check(rise <= IMAG_RISE and energies[-1] >= REFERENCE_ENERGY - IMAG_RISE,
          f"imaginary-time energies {energies}")


def k2_vumps_phase(torch):
    """K2 at the two shapes VUMPS gives it (VUMPS_K2_SHAPES: B=1, chi=64,
    M=3, m=25), f32: against its twin and an f64 run of the twin, timed by
    CUDA events beside the twin and the 3xTF32 bound, with the template
    instance that ran."""
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    m = VUMPS_KRYLOV
    for seed, (case, nt) in enumerate(VUMPS_K2_SHAPES):
        ops = tdvp_k2_operands(torch, 1, VUMPS_CHI, nt, M, True, 200 + seed)
        with highest_precision():
            V, ab = K.fused_lanczos(*ops, m)
            V0, ab0 = K.fused_lanczos_plain(*ops, m)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(V).all() and torch.isfinite(ab).all()),
                  f"K2 (vumps {case}) output not finite")
            rel_ab, rel_V = max_rel(ab, ab0), max_rel(V, V0)
            f64 = lanczos_f64_errors(torch, ops, V, ab, V0, ab0, m)
            ms = cuda_ms(torch, lambda: K.fused_lanczos(*ops, m), 10)
            plain_ms = cuda_ms(torch, lambda: K.fused_lanczos_plain(*ops, m),
                               3)
        flops, nbytes = k2_work(1, VUMPS_CHI, nt, M, m)
        bound_tc_ms, bound_by = bound_tc(flops, nbytes)
        emit(phase="k2_vumps", case=case, shape=[1, VUMPS_CHI, nt, M, m],
             instance=k2_instance(M, nt), max_rel_err_ab=rel_ab,
             max_rel_err_V=rel_V, f64_rel_err=f64, ms=ms, plain_ms=plain_ms,
             bound_tc_ms=bound_tc_ms, bound_by=bound_by,
             tflops_per_s=flops / ms / 1e9)
        check(f64["kernel_ab"] <= TDVP_K2_F64X * f64["twin_ab"]
              and f64["kernel_V"] <= TDVP_K2_F64X * f64["twin_V"],
              f"K2 (vumps {case}) against f64 beyond {TDVP_K2_F64X}x its "
              f"f32 twin: {f64}")
        del V, ab, V0, ab0, ops


def vumps_counts():
    """K2 launches by instance, the AC and C Ritz passes and the host
    checks of their residuals, GMRES restarts and GMRES host checks since
    the last reset_vumps_counts()."""
    from tensornetwork_tpu_torch.models import vumps as V
    from tensornetwork_tpu_torch.ops import kernels as K
    from tensornetwork_tpu_torch.ops import krylov
    return dict(k2=K.launch_counts["fused_lanczos"],
                **{k[len("fused_lanczos_"):]: n
                   for k, n in K.route_counts.items()
                   if k.startswith("fused_lanczos_")},
                **V.counts, **krylov.counts)


def reset_vumps_counts():
    from tensornetwork_tpu_torch.models import vumps as V
    from tensornetwork_tpu_torch.ops import kernels as K
    from tensornetwork_tpu_torch.ops import krylov
    K.reset_launch_counts()
    V.reset_counts()
    krylov.reset_counts()


def per_iteration(before, after, n):
    return {k: (after[k] - before[k]) / n for k in after}


def vumps_w(torch, dtype):
    from tensornetwork_tpu_torch import FiniteTFI
    return FiniteTFI(1.0, 1.0, N=N, dtype=dtype).Ws[N // 2]


def vumps_probe_phase(torch):
    """bench.py's VUMPS probe on the card: vumps_iteration with its
    defaults from a random f32 chi=64 state, 1 warm + 10 + 8 timed
    iterations (CUDA events, and the host's clock to the last sync), the
    device's busy time of one more, traced; per iteration the K2 launches
    by instance, the GMRES restarts and the host checks."""
    from tensornetwork_tpu_torch.models import vumps as V
    W = vumps_w(torch, torch.float32)
    lams = V.mpo_diagonal_coefficients(W)
    state = V.random_vumps_state(4, VUMPS_CHI, D, torch.float32, device=DEV)
    warm, settle, timed = VUMPS_PROBE
    for _ in range(warm + settle):
        state, e, err, _, _, _ = V.vumps_iteration(state, W, lams)
    float(e)
    before = vumps_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(timed):
        state, e, err, _, _, _ = V.vumps_iteration(state, W, lams)
    ev1.record()
    e, err = float(e), float(err)       # synchronises
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    device_ms = ev0.elapsed_time(ev1)
    counts = per_iteration(before, vumps_counts(), timed)
    iteration_ms = 1e3 * host_s / timed
    t1 = time.perf_counter()
    busy_ms, top = device_busy_ms(
        torch, lambda: V.vumps_iteration(state, W, lams), top=DEVICE_TOP)
    de = e + 4 / np.pi
    emit(phase="vumps_probe", chi=VUMPS_CHI, iterations=list(VUMPS_PROBE),
         iterations_per_s=timed / host_s, iteration_ms=iteration_ms,
         event_ms_per_iteration=device_ms / timed, e=e,
         delta_e_vs_minus_4_over_pi=de, gauge_error=err,
         per_iteration=counts, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / iteration_ms, device_top=top,
         profile_seconds=time.perf_counter() - t1)
    check(bool(all(torch.isfinite(x).all() for x in state))
          and np.isfinite(e), "VUMPS probe state not finite")
    check(-VUMPS_F32_DE <= de <= VUMPS_PROBE_DE,
          f"VUMPS probe energy {e}: {de} from -4/pi")


def vumps_converge_phase(torch, dtype):
    """bench.py's VUMPS convergence run (f32) or the JAX package's slow
    test (f64): vumps() from random to the gauge-error target, with its
    iterations, seconds, per-iteration counts and energy error."""
    from tensornetwork_tpu_torch.models import vumps as V
    f32 = dtype == torch.float32
    kw = VUMPS_F32 if f32 else VUMPS_F64
    W = vumps_w(torch, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = V.vumps(W, chi=VUMPS_CHI, dtype=dtype, seed=0, **kw)
    seconds = time.perf_counter() - t0
    errs = res.gradient_norms
    de = res.energy - V.tfi_exact_energy_density(-1.0, -1.0)
    counts = vumps_counts()
    out = dict(phase="vumps_converge", dtype=str(dtype)[6:], chi=VUMPS_CHI,
               iterations=len(errs), seconds=seconds,
               iterations_per_s=len(errs) / seconds, gauge_error=errs[-1],
               gauge_errors=errs, delta_e=de,
               per_iteration=per_iteration(dict.fromkeys(counts, 0), counts,
                                           len(errs)), **kw)
    check(bool(all(torch.isfinite(x).all() for x in res.state)),
          f"VUMPS ({dtype}) state not finite")
    if f32:
        emit(**out)
        check(errs[-1] < kw["tol"] and abs(de) < VUMPS_F32_DE,
              f"VUMPS f32: gauge error {errs[-1]} after {len(errs)} "
              f"iterations, delta e {de}")
        return res
    t1 = time.perf_counter()
    xi = V.correlation_length(res.state.AL)
    emit(**out, correlation_length=xi,
         correlation_length_s=time.perf_counter() - t1)
    tail = errs[3:]
    check(errs[-1] < kw["tol"] and len(errs) < VUMPS_F64_ITERS,
          f"VUMPS f64: gauge error {errs[-1]} after {len(errs)} iterations")
    check(all(b < VUMPS_TAIL_RISE * a for a, b in zip(tail, tail[1:])),
          f"VUMPS f64: the gauge error rose in the tail: {tail}")
    check(abs(de) < VUMPS_F64_DE, f"VUMPS f64: delta e {de}")
    check(bool(np.isfinite(xi)) and xi > 1, f"correlation length {xi}")
    return res


def check_vumps_launches(counts, dtype, what):
    """Every AC pass was one K2 launch on <3,2> (f32) and every C pass one
    on <0,0>; in f64 each on the SIMT kernel."""
    if dtype == "float32":
        ok = (counts["tc<3,2>"] == counts["ac_passes"] > 0
              and counts["tc<0,0>"] == counts["c_passes"] > 0
              and counts["k2"] == counts["ac_passes"] + counts["c_passes"])
    else:
        ok = counts["simt"] == counts["k2"] == (counts["ac_passes"]
                                               + counts["c_passes"]) > 0
    check(ok, f"K2 on the VUMPS path ({what}, {dtype}): {counts}")


def itdvp_phase(torch, state64, W64):
    """iTDVP of the f64 VUMPS ground state taken to complex128: t=0.3 in 6
    real-time steps (Lanczos exponentials, no kernel: K2 takes real
    states); the energy and <Z> stay put."""
    from tensornetwork_tpu_torch.models import vumps as V
    st = V.VUMPSState(*(x.to(torch.complex128) for x in state64))
    Z = np.diag([1.0, -1.0])

    def z(s):
        return V.uniform_expectation_1site(s, Z).real

    m0 = z(st)
    t0 = time.perf_counter()
    st, es, obs = V.itdvp(st, W64, t=ITDVP_T, num_steps=ITDVP_STEPS,
                          observable=z)
    seconds = time.perf_counter() - t0
    de = float(np.max(np.abs(np.array(es) - es[0])))
    dz = float(np.max(np.abs(np.array(obs) - m0)))
    emit(phase="itdvp", chi=VUMPS_CHI, t=ITDVP_T, steps=ITDVP_STEPS,
         seconds=seconds, energy_drift_max=de, z_drift_max=dz, z0=m0)
    check(bool(all(torch.isfinite(torch.view_as_real(x)).all() for x in st)),
          "iTDVP state not finite")
    check(de < ITDVP_DE and dz < ITDVP_DZ,
          f"iTDVP of the ground state: energy drift {de}, <Z> drift {dz}")


def timed(torch, fn):
    """(fn(), seconds) with the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def paulis():
    return np.array([[0.0, 1.0], [1.0, 0.0]]), np.diag([1.0, -1.0])


def tfi_bond_h2(J, h):
    """J X X + h/2 (Z 1 + 1 Z): a TFI bond term with FiniteTFI's signs,
    each site's field split over its two bonds (tests/test_mera_tebd_imps.py
    _tfi_h2)."""
    X, Z = paulis()
    return J * np.kron(X, X) + h / 2 * (np.kron(Z, np.eye(2))
                                        + np.kron(np.eye(2), Z))


def wavefunctions_h2():
    """examples/wavefunctions.py's bond term: -X X - (Z 1 + 1 Z) / 2."""
    return tfi_bond_h2(-1.0, -1.0)


def mps_dmrg_phase(torch):
    """bench.py's chain through the documented entry: FiniteMPS.random ->
    FiniteDMRG(FiniteMPS, FiniteTFI) -> run_one_site, with the "xla" site
    epilogue and then the fused one (K5), each from the same random state;
    the result lands in the FiniteMPS.  Then measurements on the state:
    <Z_i>, <X_i>, <X_16 X_j>, the energy rebuilt from them, and the
    canonical form about site 16.  Returns the FiniteMPS and the K2/K5
    launches."""
    from tensornetwork_tpu_torch import FiniteDMRG, FiniteMPS, FiniteTFI
    from tensornetwork_tpu_torch.models.dmrg import mps_mpo_expectation
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    launches = dict.fromkeys(("fused_lanczos", "fused_gauge_env"), 0)
    for qr_impl, epilogue_impl in (("householder", "xla"),
                                   ("polar", "fused")):
        K.reset_launch_counts()     # each run's counts, summed below
        mps, random_s = timed(torch, lambda: FiniteMPS.random(
            N, CHI, D, dtype=torch.float32, seed=8, device=DEV))
        dm = FiniteDMRG(mps, mpo)
        e, run_s = timed(torch, lambda: dm.run_one_site(
            SINGLE_SWEEPS, KRYLOV, qr_impl=qr_impl,
            epilogue_impl=epilogue_impl))
        counts, routes = dict(K.launch_counts), dict(K.route_counts)
        sweeps = len(dm.energies)
        check(mps.to_stack() is dm.As and mps.center_position is None,
              "FiniteDMRG did not write its result into the FiniteMPS")
        de = state_delta_e(torch, mps.As, mpo64)
        emit(phase="mps_dmrg", qr_impl=qr_impl, epilogue_impl=epilogue_impl,
             sweeps=sweeps, delta_E=de, ritz_delta_E=e - REFERENCE_ENERGY,
             random_s=random_s, run_s=run_s, sweeps_per_s=sweeps / run_s,
             k2_launches=counts["fused_lanczos"],
             k5_launches=counts["fused_gauge_env"])
        check(counts["fused_lanczos"] == 2 * N * sweeps,
              f"mps_dmrg: {counts['fused_lanczos']} K2 launches in {sweeps} "
              f"sweeps, expected {2 * N} a sweep")
        k5_want = N + K5_PER_SWEEP * sweeps if epilogue_impl == "fused" else 0
        check(counts["fused_gauge_env"] == k5_want,
              f"mps_dmrg: {counts['fused_gauge_env']} K5 launches, expected "
              f"{k5_want}")
        if epilogue_impl == "fused":
            check_k5_resident(counts, routes)
        check(DE_LO <= de <= DE_HI,
              f"mps_dmrg ({epilogue_impl}) delta E {de} outside window")
        for k in launches:
            launches[k] += counts[k]
    X, Z = paulis()
    (zs, xs), local_s = timed(torch, lambda: (
        mps.measure_local_operator([Z] * N, range(N)),
        mps.measure_local_operator([X] * N, range(N))))
    xx, corr_s = timed(torch, lambda: mps.measure_two_body_correlator(
        X, X, N // 2, range(N)))
    # the energy from the measurements, on an f64 copy of the state
    m64 = FiniteMPS(mps.As.double(), canonicalize=False)
    bonds = torch.stack([m64.measure_two_body_correlator(X, X, i, [i + 1])[0]
                         for i in range(N - 1)])
    z64 = torch.stack(m64.measure_local_operator([Z] * N, range(N)))
    e_rebuilt = float(bonds.sum() + z64.sum())
    e_mpo = float(mps_mpo_expectation(m64.As, mpo64.Ws, mpo64.vL, mpo64.vR))
    xx16 = float(m64.measure_two_body_correlator(X, X, N // 2,
                                                 [N // 2])[0])
    norm, position_s = timed(torch, lambda: mps.position(N // 2))
    canon = float(mps.check_canonical())
    state_norm = float(mps.norm())
    emit(phase="mps_measure", N=N, chi=CHI,
         z=[float(v) for v in zs], x=[float(v) for v in xs],
         xx_from_16=[float(v) for v in xx], local_s=local_s, corr_s=corr_s,
         energy_rebuilt=e_rebuilt, energy_mpo=e_mpo,
         rebuilt_minus_mpo=e_rebuilt - e_mpo, xx_16_16_f64=xx16,
         xx_16_16_f32=float(xx[N // 2]), position_s=position_s,
         position_norm=float(norm), check_canonical=canon,
         norm_after_position=state_norm)
    check(all(np.isfinite(float(v)) for v in zs + xs + xx),
          "mps measurements not finite")
    check(abs(e_rebuilt - e_mpo) < 1e-9,
          f"energy from <XX> and <Z> {e_rebuilt} against the MPO's {e_mpo}")
    check(abs(xx16 - 1) < 1e-12 and abs(float(xx[N // 2]) - 1) < 1e-5,
          f"<X_16 X_16> = {xx16} (f64), {float(xx[N // 2])} (f32)")
    check(canon < 1e-4 and abs(state_norm - 1) < 1e-5,
          f"after position({N // 2}): check_canonical {canon}, norm "
          f"{state_norm}")
    return mps, launches


def boundary_block(As):
    """The block [0, :, 0] of a stacked MPS as a state vector, on its
    device (FiniteMPS.to_dense keeps every boundary pair: chi^2 times the
    memory)."""
    chi, d = As.shape[1], As.shape[2]
    v = As[0, 0]
    for A in As[1:]:
        v = (v @ A.reshape(chi, d * chi)).reshape(-1, chi)
    return v[:, 0]


def mps_overlap(a, b):
    """|<a|b>| / (|a| |b|) of two FiniteMPS."""
    return float(abs(b.inner(a)) / (a.norm() * b.norm()))


def tebd_phase(torch, ground):
    """(a) the mps_dmrg ground state quenched to h=1.2 at users' width, in
    complex64 against the same steps in complex128; (b) a product state at
    N=20 against evolve_exact on the card; (c) imaginary time from random
    with every step's energy below the previous one."""
    from tensornetwork_tpu_torch import FiniteMPS, tebd
    h2 = tfi_bond_h2(1.0, TEBD_QUENCH_H)

    def quench(dtype):
        mps = FiniteMPS(ground.As.to(dtype), canonicalize=False)
        norms, terr, secs = [], 0.0, []
        for _ in range(TEBD_STEPS):
            (_, w), s = timed(torch, lambda: tebd.evolve_mps(
                mps, h2, TEBD_DT, 1, max_singular_values=CHI,
                normalize=False))
            nrm = float(mps.norm())
            mps.As = torch.cat([mps.As[:1] / nrm, mps.As[1:]])
            norms.append(nrm)
            terr += w
            secs.append(s)
        return mps, norms, terr, secs

    mps, norms, terr, secs = quench(torch.complex64)
    ref, _, terr128, _ = quench(torch.complex128)
    overlap = mps_overlap(mps, ref)
    gate = tebd.trotter_gate(h2, TEBD_DT, device=DEV)
    step_s = statistics.median(secs)
    busy_ms, top = device_busy_ms(
        torch, lambda: tebd.tebd_sweep(mps, gate, max_singular_values=CHI),
        top=DEVICE_TOP)
    emit(phase="tebd_quench", N=N, chi=CHI, h=TEBD_QUENCH_H, dt=TEBD_DT,
         steps=TEBD_STEPS, steps_per_s=1 / step_s, step_s=secs,
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / (
             1e3 * step_s), device_top=top,
         norm_before_renormalization=norms, truncated_weight=terr,
         truncated_weight_c128=terr128, overlap_with_c128=overlap)
    check(bool(torch.isfinite(torch.view_as_real(mps.As)).all()),
          "TEBD quench state not finite")
    check(overlap >= 1 - TDVP_OVERLAP_TOL,
          f"TEBD quench against complex128: overlap {overlap}")

    # (b) against the exact state
    h2 = wavefunctions_h2()
    As = torch.zeros((TEBD_EXACT_N, CHI, D, CHI), dtype=torch.float32,
                     device=DEV)
    As[:, 0, 0, 0] = 1.0
    mps = FiniteMPS(As, canonicalize=False)
    (_, terr), mps_s = timed(torch, lambda: tebd.evolve_mps(
        mps, h2, TEBD_EXACT_DT, TEBD_EXACT_STEPS, max_singular_values=CHI))
    psi0 = torch.zeros((D,) * TEBD_EXACT_N, dtype=torch.float32, device=DEV)
    psi0[(0,) * TEBD_EXACT_N] = 1.0
    psi, exact_s = timed(torch, lambda: tebd.evolve_exact(
        psi0, h2, TEBD_EXACT_DT, TEBD_EXACT_STEPS))
    blk = boundary_block(mps.As)
    fid = float(abs(tebd.inner_exact(blk / torch.linalg.vector_norm(blk),
                                     psi.reshape(-1).to(blk.dtype))))
    emit(phase="tebd_exact", N=TEBD_EXACT_N, chi=CHI, dt=TEBD_EXACT_DT,
         steps=TEBD_EXACT_STEPS, fidelity=fid, truncated_weight=terr,
         mps_s=mps_s, exact_s=exact_s, dtype=str(mps.dtype)[6:])
    check(fid > TEBD_EXACT_FID and terr < 1e-6,
          f"TEBD against the exact state: fidelity {fid}, truncated "
          f"weight {terr}")

    # (c) imaginary time from random
    mps = FiniteMPS.random(N, CHI, D, dtype=torch.float32, seed=9,
                           device=DEV)
    e0 = tebd.measure_energy(mps, h2)
    (energies, terr), imag_s = timed(torch, lambda: tebd.evolve_mps(
        mps, h2, TEBD_IMAG_DT, TEBD_IMAG_STEPS, imaginary=True,
        max_singular_values=CHI))
    es = [e0] + energies
    emit(phase="tebd_imaginary", N=N, chi=CHI, dt=TEBD_IMAG_DT,
         steps=TEBD_IMAG_STEPS, energies=es, truncated_weight=terr,
         seconds=imag_s)
    check(all(b < a for a, b in zip(es, es[1:])),
          f"imaginary-time TEBD energies did not fall every step: {es}")


def imps_phase(torch, state64):
    """(a) random two-site cells at chi=64 canonicalised, f64 and f32; (b)
    the f64 critical VUMPS ground state as an InfiniteMPS of its AL:
    canonicalize with the default and with IMPS_KRYLOV Krylov vectors (eta,
    the residual), and on the AL cell <Z> against VUMPS's, the energy
    density from <X_0 X_1> and <Z> (with FiniteTFI's signs), <X_0 X_j>."""
    from tensornetwork_tpu_torch import InfiniteMPS
    from tensornetwork_tpu_torch.models import vumps as V
    for dtype, bar in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        imps = InfiniteMPS.random(2, CHI, D, dtype=dtype, seed=10, device=DEV)
        on_cpu = InfiniteMPS(imps.As.cpu())
        (eta, _), secs = timed(torch, imps.canonicalize)
        err = imps.check_right_canonical()
        on_cpu.canonicalize()
        emit(phase="imps_random", dtype=str(dtype)[6:], cells=2, chi=CHI,
             eta=eta, check_right_canonical=err, canonicalize_s=secs,
             same_cell_on_the_cpu=on_cpu.check_right_canonical())
        check(np.isfinite(eta) and err < bar,
              f"InfiniteMPS ({dtype}) canonicalize: eta {eta}, residual "
              f"{err}")
    X, Z = paulis()
    imps = InfiniteMPS(state64.AL[None])
    (eta, _), secs = timed(torch, imps.canonicalize)
    err = imps.check_right_canonical()
    resolved = InfiniteMPS(state64.AL[None])
    (eta_r, _), secs_r = timed(torch, lambda: resolved.canonicalize(
        num_krylov_vecs=IMPS_KRYLOV))
    err_r = resolved.check_right_canonical()
    cell = InfiniteMPS(state64.AL[None])     # left-canonical: l = 1 exactly
    z = float(cell.measure_local_operator(Z).real)
    z_vumps = V.uniform_expectation_1site(state64, Z).real
    xx, corr_s = timed(torch, lambda: cell.measure_two_body_correlator(
        X, X, 0, range(1, IMPS_CORR_J + 1)))
    xx = [float(v.real) for v in xx]
    e = xx[0] + z
    emit(phase="imps_vumps", chi=state64.AL.shape[0], eta=eta,
         check_right_canonical=err, canonicalize_s=secs,
         krylov_vecs_resolved=IMPS_KRYLOV, eta_resolved=eta_r,
         check_right_canonical_resolved=err_r,
         canonicalize_resolved_s=secs_r, z=z, z_minus_vumps=z - z_vumps,
         energy_density=e, energy_minus_exact=e + 4 / np.pi,
         xx_from_0=xx, correlator_s=corr_s)
    check(all(np.isfinite(v) for v in [eta, err, eta_r, err_r, z, e] + xx)
          and abs(eta_r - 1) < 1e-6,
          f"InfiniteMPS of the VUMPS state: eta {eta} ({IMPS_KRYLOV} Krylov "
          f"vectors: {eta_r}), e {e}")


def mera_phase(torch):
    """examples/simple_mera.py's model on the card: blocked critical Ising
    (chi=4), 3 layers, f64, 60 iterations; E/spin within 1% of -4/pi and
    every u and w isometric."""
    from tensornetwork_tpu_torch import mera
    h3 = mera.blocked_ising_hamiltonian(device=DEV)
    state = mera.initialize_mera(4, MERA_LAYERS, device=DEV)
    (state, e), secs = timed(torch, lambda: mera.optimize_mera(
        h3, state, num_iterations=MERA_ITERS))
    per_spin = e / 2
    iso = max(max(float(torch.linalg.vector_norm(
        u.reshape(16, 16) @ u.reshape(16, 16).mT - torch.eye(
            16, dtype=u.dtype, device=u.device))) for u in state.us),
        max(float(torch.linalg.vector_norm(
            w.reshape(4, 16) @ w.reshape(4, 16).mT - torch.eye(
                4, dtype=w.dtype, device=w.device))) for w in state.ws))
    rel = abs(per_spin + 4 / np.pi) / (4 / np.pi)
    emit(phase="mera", chi=4, layers=MERA_LAYERS, iterations=MERA_ITERS,
         energy_per_spin=per_spin, relative_error=rel,
         isometry_error=iso, ms_per_iteration=1e3 * secs / MERA_ITERS)
    check(rel < 0.01 and iso < 1e-10,
          f"MERA: E/spin {per_spin} ({rel} from -4/pi), isometry {iso}")


def api_leftovers_phase(torch, ground):
    """The API the ported modules had left out, on the card: a batched
    one-site sweep with qr_impl="polar_express"; batched_one_site_sweep_
    paired bit for bit against batched_one_site_sweep with its defaults;
    TDVP of a FiniteMPS on the split-complex path (K2 on <0,0>)."""
    from tensornetwork_tpu_torch import (TDVP, FiniteMPS, FiniteTFI,
                                         batched_one_site_sweep,
                                         batched_one_site_sweep_paired)
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    start = random_mps_stack(11, BATCH * N, CHI, D,
                             dtype=torch.float32).reshape(BATCH, N, CHI, D, CHI)
    As, renvs, times = start, None, []
    for _ in range(EXPRESS_SWEEPS):
        res, s = timed(torch, lambda: batched_one_site_sweep(
            As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=KRYLOV,
            qr_impl="polar_express", renvs=renvs))
        As, renvs = res.As, res.renvs
        times.append(s)
    de = np.array([state_delta_e(torch, a, mpo64) for a in As])
    emit(phase="polar_express_batched", batch=BATCH, chi=CHI,
         sweeps=EXPRESS_SWEEPS, sweep_s=times,
         instance_sweeps_per_s=BATCH / statistics.median(times[1:]),
         delta_E_median=float(np.median(de)), delta_E_min=float(de.min()),
         delta_E_max=float(de.max()),
         instances_in_window=int(np.sum((de >= DE_LO) & (de <= DE_HI))))
    check(bool(np.all(np.isfinite(de))), "polar_express sweep not finite")

    paired, paired_s = timed(torch, lambda: batched_one_site_sweep_paired(
        start, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=KRYLOV))
    plain, plain_s = timed(torch, lambda: batched_one_site_sweep(
        start, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=KRYLOV,
        qr_impl="polar", ritz_impl="power"))
    same = all(bool(torch.equal(a, b)) for a, b in zip(paired, plain))
    emit(phase="paired_names", batch=BATCH, chi=CHI, bit_for_bit=same,
         paired_s=paired_s, unpaired_s=plain_s)
    check(same, "batched_one_site_sweep_paired differs from the one route")

    mps = FiniteMPS(ground.As.clone(), canonicalize=False)
    before, routes0 = dict(K.launch_counts), dict(K.route_counts)
    tdvp = TDVP(mps, mpo, split_complex=True)
    _, secs = timed(torch, lambda: tdvp.evolve(SC_TDVP_DT * SC_TDVP_SWEEPS,
                                               SC_TDVP_SWEEPS,
                                               num_krylov_vecs=KRYLOV))
    k2 = K.launch_counts["fused_lanczos"] - before["fused_lanczos"]
    routes = {k: v - routes0.get(k, 0) for k, v in K.route_counts.items()}
    norm = float(mps.norm())
    emit(phase="tdvp_finite_mps", N=N, chi=CHI, dt=SC_TDVP_DT,
         sweeps=SC_TDVP_SWEEPS, seconds=secs, norm=norm, k2_launches=k2,
         k2_routes={k: v for k, v in routes.items()
                    if k.startswith("fused_lanczos_")})
    check(mps.to_stack() is tdvp.As and mps.dtype == torch.complex64,
          "TDVP did not write its result into the FiniteMPS")
    check(abs(norm - 1) < TDVP_NORM_TOL, f"TDVP(FiniteMPS) norm {norm}")
    check(k2 == TDVP_PER_SWEEP * SC_TDVP_SWEEPS,
          f"TDVP(FiniteMPS): {k2} K2 launches, expected "
          f"{TDVP_PER_SWEEP * SC_TDVP_SWEEPS}")


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


def check_k5_resident(launches, routes):
    """Every K5 launch of a chi=64 fused sweep took the resident route."""
    check(routes["fused_gauge_env_resident"] == launches["fused_gauge_env"]
          and routes["fused_gauge_env_grid"] == 0,
          f"K5 at chi={CHI} left the resident route: {launches['fused_gauge_env']}"
          f" launches, routes {routes}")


def mps_inner_network(n):
    """<psi|psi> of an open MPS in ncon labels: ket site i (l_i, s_i,
    l_i+1), bra site i (m_i, s_i, m_i+1), the two end bonds shared by ket
    and bra; and the zip con_order (each site's physical label, then the
    ket and bra bonds to the next site)."""
    ket = [[i + 1, 2 * n + 3 + i, i + 2] for i in range(n)]
    bra = [[n + 2 + i, 2 * n + 3 + i, n + 3 + i] for i in range(n)]
    ket[0][0] = bra[0][0] = 3 * n + 3
    ket[-1][2] = bra[-1][2] = 3 * n + 4
    order = [3 * n + 3]
    for i in range(n):
        order.append(2 * n + 3 + i)
        if i < n - 1:
            order += [i + 2, n + 3 + i]
    return ket + bra, order + [3 * n + 4]


def random_mps_sites(torch, n, chi, dtype, seed):
    """Open-MPS sites (1, d, chi) ... (chi, d, 1), each scaled by
    1/sqrt(d chi_right): <psi|psi> is 1 in expectation."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    sites = []
    for i in range(n):
        left, right = 1 if i == 0 else chi, 1 if i == n - 1 else chi
        a = torch.randn((left, D, right), generator=g, device=DEV,
                        dtype=torch.float64) / np.sqrt(D * right)
        sites.append(a.to(dtype))
    return sites


def mps_norm_f64(torch, sites):
    """<psi|psi> by a float64 loop of transfer matrices."""
    E = torch.ones((1, 1), dtype=torch.float64, device=sites[0].device)
    for a in sites:
        a = a.double()
        E = torch.einsum("ac,asb,csd->bd", E, a, a)
    return float(E[0, 0])


def median_ms(torch, fn, reps):
    """(median device ms by CUDA events, median host wall ms to the
    synchronised result) of one call of fn, over reps calls after one."""
    fn()
    torch.cuda.synchronize()
    dev, wall = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(wall)


def ncon_mps_inner_phase(torch, card):
    """The reference's README network through ncon, in f32 and f64, with
    the zip con_order and con_order="greedy" at N=20 and "optimal" at
    NCON_OPTIMAL_N; each against the float64 transfer-matrix loop."""
    import tensornetwork_tpu_torch as tn
    from tensornetwork_tpu_torch.ops import paths
    cases, values = [], {}
    for dt in ("float32", "float64"):
        dtype = getattr(torch, dt)
        for method, n in (("zip", NCON_N), ("greedy", NCON_N),
                          ("optimal", NCON_OPTIMAL_N)):
            sites = random_mps_sites(torch, n, NCON_CHI, dtype, 11)
            ref = mps_norm_f64(torch, sites)
            structure, zip_order = mps_inner_network(n)
            shapes = [tuple(a.shape) for a in sites] * 2
            t0 = time.perf_counter()
            order = (zip_order if method == "zip" else
                     paths.solve_con_order(structure, shapes, method))
            solve_s = time.perf_counter() - t0
            # the value as users call it (the order solved inside ncon);
            # the times per contraction with the solved order
            out = tn.ncon(sites + sites, structure,
                          con_order=zip_order if method == "zip" else method)
            value = float(out)
            rel = abs(value - ref) / abs(ref)
            dev_ms, wall_ms = median_ms(
                torch, lambda: tn.ncon(sites + sites, structure,
                                       con_order=order), NCON_REPS)
            cases.append(dict(
                dtype=dt, con_order=method, n=n, value=value, ref_f64=ref,
                rel_err=rel, ms_cuda_events=dev_ms, ms_wall=wall_ms,
                path_solve_s=solve_s,
                path_flops=paths.path_cost(structure, shapes, order)))
            if method == "zip":  # the device's share of one contraction
                busy = device_busy_ms(torch, lambda: [
                    tn.ncon(sites + sites, structure, con_order=order)
                    for _ in range(NCON_REPS)]) / NCON_REPS
                cases[-1].update(device_busy_ms=busy,
                                 device_idle_share=1 - busy / wall_ms)
            values[dt, method] = value
            check(np.isfinite(value) and out.shape == () and
                  rel <= NCON_RTOL[dt],
                  f"ncon MPS inner product ({dt}, {method}, N={n}): {value} "
                  f"against {ref}, relative {rel}")
    emit(phase="ncon_mps_inner", card=card, chi=NCON_CHI, d=D, cases=cases)
    return values


def ncon_batched_phase(torch, card):
    """B=256 norms at N=32, chi=128, f32 as one ncon: the batch label b
    on every site tensor (positive, on 64 operands: a batch axis until
    the last pair) and on a (B, B) identity that leaves it open.  The end
    bonds are closed (E0 = I, a trace at the end), so that the same
    stacked operands feed K6 (transfer_chain, f32: route "tiled")."""
    import tensornetwork_tpu_torch as tn
    from tensornetwork_tpu_torch.ops import kernels as K
    B, n, chi = NCON_B, NCON_B_N, NCON_B_CHI
    g = torch.Generator(device=DEV).manual_seed(12)
    As = torch.randn((B, n, chi, D, chi), generator=g, device=DEV) / \
        np.sqrt(D * chi)
    sites = [As[:, i] for i in range(n)]
    b, left, right = 1, 2, 3  # the batch label and the two end bonds
    ket = [[b, left if i == 0 else 4 + i, 4 + n + i,
            right if i == n - 1 else 5 + i] for i in range(n)]
    bra = [[b, left if i == 0 else 4 + 2 * n + i, 4 + n + i,
            right if i == n - 1 else 5 + 2 * n + i] for i in range(n)]
    order = [left]
    for i in range(n):
        order.append(4 + n + i)
        if i < n - 1:
            order += [5 + i, 5 + 2 * n + i]
    order += [right, b]
    eye_b = torch.eye(B, device=DEV)

    def run():
        return tn.ncon(sites + sites + [eye_b], ket + bra + [[b, -1]],
                       con_order=order)

    out = run()
    # E'[b, p] = sum_{a, c, s} E[a, c] A[a, s, b] A[c, s, p], in float64
    E = torch.eye(chi, dtype=torch.float64, device=DEV).expand(B, chi, chi)
    for i in range(n):
        a = sites[i].double()
        Y = torch.bmm(E.transpose(1, 2), a.reshape(B, chi, D * chi))
        E = torch.bmm(Y.reshape(B, chi * D, chi).transpose(1, 2),
                      a.reshape(B, chi * D, chi))
    ref = torch.diagonal(E, dim1=1, dim2=2).sum(-1)
    rel = float(((out.double() - ref).abs() / ref.abs()).max())
    dev_ms, wall_ms = median_ms(torch, run, 5)
    flops = 4 * D * chi ** 3 * n * B
    bound_ms = flops / FP32_PEAK * 1e3
    E0 = torch.eye(chi, device=DEV).expand(B, chi, chi).contiguous()
    K.reset_launch_counts()
    k6 = torch.diagonal(K.transfer_chain(As, E0), dim1=1, dim2=2).sum(-1)
    k6_launches = {k: v for k, v in K.route_counts.items() if v}
    k6_ms = cuda_ms(torch, lambda: K.transfer_chain(As, E0), 3)
    busy, top = device_busy_ms(torch, run, top=4)
    emit(phase="ncon_batched", card=card, batch=B, n=n, chi=chi, d=D,
         dtype="float32", stack_gb=As.numel() * 4 / 1e9,
         device_busy_ms=busy, device_top=top,
         max_rel_err_f64=rel, ms_cuda_events=dev_ms, ms_wall=wall_ms,
         flops=flops, tflops_per_s=flops / dev_ms / 1e9,
         bound_ms_fp32=bound_ms, k6_ms=k6_ms,
         k6_route_counts=k6_launches,
         k6_max_rel_diff=float(((k6.double() - ref).abs()
                                / ref.abs()).max()))
    check(out.shape == (B,) and bool(torch.isfinite(out).all())
          and rel <= NCON_B_RTOL,
          f"batched ncon norms: shape {tuple(out.shape)}, relative {rel}")
    del As, sites, E, out


def mps_nodes(sites):
    """The ncon_mps_inner network as Nodes: ket and bra sites joined along
    the chain, by the physical legs and at both ends."""
    import tensornetwork_tpu_torch as tn
    ket = [tn.Node(a) for a in sites]
    bra = [tn.Node(a) for a in sites]
    for i in range(len(sites) - 1):
        ket[i][2] ^ ket[i + 1][0]
        bra[i][2] ^ bra[i + 1][0]
    for k, b in zip(ket, bra):
        k[1] ^ b[1]
    ket[0][0] ^ bra[0][0]
    ket[-1][2] ^ bra[-1][2]
    return ket + bra


def peps_double_layer(torch, L, Dp, seed):
    """An L x L PEPS (physical d=2, bonds Dp, uniform random entries) as
    double-layer tensors with bonds Dp^2 and legs (left, right, up, down)
    where present, and each tensor's bond labels (h: horizontal, v:
    vertical)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    tensors, labels = [], []
    for r in range(L):
        for c in range(L):
            legs = [("h", r, c - 1) if c > 0 else None,
                    ("h", r, c) if c < L - 1 else None,
                    ("v", r - 1, c) if r > 0 else None,
                    ("v", r, c) if r < L - 1 else None]
            legs = [x for x in legs if x is not None]
            k = len(legs)
            a = torch.rand((D,) + (Dp,) * k, generator=g, device=DEV,
                           dtype=torch.float64)
            dl = torch.tensordot(a, a, dims=([0], [0]))  # ket legs, bra legs
            perm = [x for i in range(k) for x in (i, i + k)]
            tensors.append(dl.permute(perm).reshape((Dp * Dp,) * k))
            labels.append(legs)
    return tensors, labels


def peps_norm_rows_f64(torch, tensors, labels):
    """The double-layer network contracted by one torch.einsum over the
    tensors in row-major order (left to right where torch has no path
    optimizer: row by row)."""
    ids = {}
    operands = []
    for t, legs in zip(tensors, labels):
        operands += [t, [ids.setdefault(x, len(ids)) for x in legs]]
    return float(torch.einsum(*operands, []))


def pair_path_flops(input_sets, sizes, path):
    """2 x the index-space size of every pairwise step of a path."""
    sets = [set(x) for x in input_sets]
    total = 0
    for i, j in path:
        union = sets[i] | sets[j]
        total += 2 * int(np.prod([sizes[e] for e in union], dtype=np.float64))
        rest = set().union(*(x for k, x in enumerate(sets)
                             if k not in (i, j)))
        sets = [x for k, x in enumerate(sets) if k not in (i, j)] + [
            union & rest]
    return total


def peps_nodes(tensors, labels):
    import tensornetwork_tpu_torch as tn
    nodes = [tn.Node(t) for t in tensors]
    where = {}
    for node, legs in zip(nodes, labels):
        for axis, leg in enumerate(legs):
            where.setdefault(leg, []).append(node[axis])
    for a, b in where.values():
        a ^ b
    return nodes


def split_latency(torch, chi):
    """split_node on a (chi, d, d, chi) two-site tensor of rank chi, f32,
    as (chi d) x (d chi), truncated to max_singular_values=chi: the p50
    host latency (to the synchronised factors) and the reconstruction."""
    import tensornetwork_tpu_torch as tn
    g = torch.Generator(device=DEV).manual_seed(chi)
    A, B = (torch.randn((chi, D, chi), generator=g, device=DEV)
            / np.sqrt(chi) for _ in range(2))
    theta = torch.tensordot(A, B, dims=([2], [0]))

    def split(fn, **kw):
        node = tn.Node(theta)
        edges = list(node.edges)
        out = fn(node, edges[:2], edges[2:], **kw)
        return edges, [x for x in out if isinstance(x, tn.AbstractNode)], out

    def rebuilt(edges, parts):
        merged = parts[0]
        for part in parts[1:]:
            merged = tn.contract_between(merged, part)
        merged.reorder_edges(edges)
        return float(torch.linalg.vector_norm(merged.tensor - theta)
                     / torch.linalg.vector_norm(theta))

    times = []
    t_end = time.perf_counter() + 10.0
    while len(times) < SPLIT_REPS and (len(times) < 5
                                       or time.perf_counter() < t_end):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        edges, parts, out = split(tn.split_node, max_singular_values=chi)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kept = parts[0].shape[-1]
    res = dict(chi=chi, matrix=[chi * D, D * chi], calls=len(times),
               p50_ms=statistics.median(times), p90_ms=float(
                   np.percentile(times, 90)), first_ms=times[0],
               kept=kept, discarded=int(out[-1].shape[0]),
               rel_err=rebuilt(edges, parts))
    check(kept <= chi and res["rel_err"] <= SPLIT_RTOL,
          f"split_node at chi={chi}: kept {kept}, reconstruction "
          f"{res['rel_err']}")
    for name in ("split_node_qr", "split_node_rq", "split_node_full_svd"):
        edges, parts, _ = split(getattr(tn, name))
        res[name + "_rel_err"] = err = rebuilt(edges, parts)
        check(err <= SPLIT_RTOL, f"{name} at chi={chi}: reconstruction {err}")
    return res


def graph_core_phase(torch, card, values):
    """The ncon_mps_inner network as Nodes through contractors.greedy and
    contractors.auto, each value against ncon's; the 4x4 double-layer
    PEPS norm through contractors.auto (the native subset-DP solver at 16
    tensors) and contractors.greedy against a row-by-row float64
    contraction; split_node's p50 latency and the QR, RQ and full-SVD
    splits; the JSON round trip on the card."""
    import tensornetwork_tpu_torch as tn
    from tensornetwork_tpu_torch import contractors, native
    chains = []
    for dt in ("float32", "float64"):
        sites = random_mps_sites(torch, NCON_N, NCON_CHI, getattr(torch, dt),
                                 11)
        for name in ("greedy", "auto"):
            nodes = mps_nodes(sites)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = float(getattr(contractors, name)(nodes).tensor)
            wall_s = time.perf_counter() - t0
            ref = values[dt, "zip"]
            rel = abs(value - ref) / abs(ref)
            chains.append(dict(dtype=dt, contractor=name, value=value,
                               rel_to_ncon=rel, wall_s=wall_s))
            check(rel <= NCON_RTOL[dt],
                  f"contractors.{name} ({dt}): {value} against ncon's {ref}")
    t0 = time.perf_counter()
    native.load()  # g++ builds the solver here, at its first use
    build_s = time.perf_counter() - t0
    tensors, labels = peps_double_layer(torch, PEPS_L, PEPS_D, 13)
    ref = peps_norm_rows_f64(torch, tensors, labels)
    peps = dict(L=PEPS_L, D=PEPS_D, tensors=len(tensors), ref_f64=ref,
                native_build_s=build_s)
    for name in ("auto", "greedy"):
        nodes = peps_nodes(tensors, labels)
        sets = [{id(e) for e in n.edges} for n in nodes]
        sizes = {id(e): e.dimension for n in nodes for e in n.edges}
        t0 = time.perf_counter()
        path = contractors.path_solver(name, nodes)
        peps[name + "_solve_s"] = time.perf_counter() - t0
        peps[name + "_path_flops"] = pair_path_flops(sets, sizes, path)
        t0 = time.perf_counter()
        value = float(getattr(contractors, name)(nodes).tensor)
        peps[name + "_wall_s"] = time.perf_counter() - t0
        peps[name + "_rel_err"] = rel = abs(value - ref) / abs(ref)
        check(rel <= 1e-10, f"PEPS norm through contractors.{name}: "
              f"{value} against {ref}")
    splits = [split_latency(torch, chi) for chi in SPLIT_CHIS]
    a = tn.Node(torch.randn((3, 4), device=DEV), name="a", axis_names=["x",
                                                                    "y"])
    b = tn.Node(torch.randn((4, 5), device=DEV, dtype=torch.float64),
                name="b")
    bond = a[1] ^ b[0]
    text = tn.nodes_to_json([a, b], edge_binding={"bond": bond})
    loaded, bindings = tn.nodes_from_json(text)
    same = all(x.tensor.device == y.tensor.device
               and x.tensor.dtype == y.tensor.dtype
               and torch.equal(x.tensor, y.tensor)
               for x, y in zip(loaded, [a, b]))
    same = same and [n.name for n in loaded] == ["a", "b"] and \
        loaded[0].axis_names == ["x", "y"] and \
        bindings["bond"][0].node2 is loaded[1]
    emit(phase="graph_core", card=card, mps_chain=chains, peps=peps,
         split_node=splits, json_round_trip_same_bits=same)
    check(same, "nodes_to_json / nodes_from_json changed the nodes")


# Block-sparse U(1) DMRG (no kernel on this path: sector GEMMs are cuBLAS
# under the bucketed executor).  BASELINE.json's headline configuration:
# batched one-site DMRG of the XXZ chain (u1_xxz_mpo, MPO bond 5), m=10
# Krylov vectors, f32, chi=1024 at N=32 (bonds 12-20 reach 1024; at N=16
# the half-filled window caps the largest bond at 236), B=8 realizations,
# each with its own Jz (Jxy = 1, Bz = 0) drawn from SYM_JZ with seed 0
# (realization 0 the clean chain), through mpo_data.
# 1 warm + 3 timed one-site sweeps, one two-site sweep, and B=32 one-site
# for the rate.  N=16 (B=8, 3 sweeps) and SymmetricFiniteDMRG (two-site,
# chi=64, both engines, 1 sweep) against exact diagonalisation in the
# half-filled sector (12,870 states, scipy sparse, f64), in the window
# [DE_LO, DE_HI] of the f32 sweeps.
SYM_N, SYM_CHI, SYM_B, SYM_B_RATE, SYM_TIMED = 32, 1024, 8, 32, 3
SYM_JZ = (0.8, 1.2)
SYM_ED_N, SYM_ED_SWEEPS, SYM_SINGLE_CHI, SYM_SINGLE_SWEEPS = 16, 3, 64, 1
# The executor against the per-sector loop, both f32 with TF32 off: the
# same products summed in other orders
SYM_ENGINE_RTOL = 1e-5


def sector_ground_energy(n, jz, jxy=1.0):
    """Lowest eigenvalue of the open XXZ chain (H = sum Jz Sz Sz + Jxy/2
    (S+S- + S-S+)) in the sector of n/2 down spins, by scipy's sparse
    eigsh in f64."""
    import itertools

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    states = np.array(sorted(sum(1 << i for i in c) for c in
                             itertools.combinations(range(n), n // 2)))
    bits = (states[:, None] >> np.arange(n)) & 1
    sz = 0.5 - bits
    rows, cols = [np.arange(len(states))], [np.arange(len(states))]
    vals = [jz * (sz[:, :-1] * sz[:, 1:]).sum(1)]
    for i in range(n - 1):
        src = np.nonzero(bits[:, i] != bits[:, i + 1])[0]
        rows.append(np.searchsorted(states,
                                    states[src] ^ (3 << i)))
        cols.append(src)
        vals.append(np.full(len(src), 0.5 * jxy))
    H = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(len(states),) * 2)
    return float(spla.eigsh(H, k=1, which="SA")[0][0]), len(states)


def sym_couplings(B):
    """Jz of each realization: the clean chain first, then seeded draws."""
    jz = np.random.default_rng(0).uniform(*SYM_JZ, B)
    jz[0] = 1.0
    return jz


def sym_setup(torch, n, chi, B, seed=0):
    """The skeleton, B random data stacks and the per-realization MPO data
    (Jz from sym_couplings), f32 on the card."""
    from tensornetwork_tpu_torch.blocksparse import batched
    from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
    skel = batched.uniform_skeleton_mps(n, chi, dtype=torch.float32,
                                        device=DEV)
    data = batched.random_data_batch(skel, B, seed=seed, device=DEV)
    jz = sym_couplings(B)
    mpos = [u1_xxz_mpo(j, 1.0, 0.0, n, dtype=torch.float32, device=DEV)
            for j in jz]
    mpo_data = [torch.stack([m[i].data for m in mpos]) for i in range(n)]
    return skel, data, mpos[0], mpo_data, jz


def bs_engine_phase(torch):
    """The three matvec contractions at the chi=1024 middle site with B=8
    (f32, TF32 off): the bucketed executor against the per-sector loop
    (tensordot on each instance), times by CUDA events, TFLOP/s against
    the fp32 bound, padded beside true flops."""
    from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
    from tensornetwork_tpu_torch.blocksparse.tensor import tensordot
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    skel, data, mpo, mpo_data, _ = sym_setup(torch, SYM_N, SYM_CHI, SYM_B)
    d = BatchedSymmetricDMRG(skel, data, mpo, mpo_data=mpo_data)
    site = SYM_N // 2
    prog = d._program(site, "right")
    skels = (d._Lskel[site], d.skeleton[site], d.mpo[site],
             d._Rskel[site + 1])
    g = torch.Generator(device=DEV).manual_seed(3)
    L, A, W, R = (torch.randn((SYM_B, s.data.shape[0]), generator=g,
                              device=DEV) for s in skels)
    mv1, mv2, mv3 = prog.mv
    plans = [TE._get_plan(skels[0], skels[1], [0], [0])]
    t1 = TE.out_skeleton(plans[0])
    plans.append(TE._get_plan(t1, skels[2], [0, 2], [0, 3]))
    plans.append(TE._get_plan(TE.out_skeleton(plans[1]), skels[3], [1, 2],
                              [0, 1]))
    flops = [TE.plan_flops(p) for p in plans]
    true = SYM_B * sum(f[0] for f in flops)
    padded = SYM_B * sum(f[1] for f in flops)

    def executor():
        with highest_precision():
            return mv3(mv2(mv1(L, A), W), R)

    def loop():
        outs = []
        with highest_precision():
            for b in range(SYM_B):
                t = tensordot(skels[0]._like(L[b]), skels[1]._like(A[b]),
                              [[0], [0]])
                t = tensordot(t, skels[2]._like(W[b]), [[0, 2], [0, 3]])
                t = tensordot(t, skels[3]._like(R[b]), [[1, 2], [0, 1]])
                outs.append(t.data)
        return torch.stack(outs)

    y, y_loop = executor(), loop()
    err = max_rel(y, y_loop)
    repeat = bool(torch.equal(executor(), y))
    ms = cuda_ms(torch, executor, 5)
    loop_ms = cuda_ms(torch, loop, 1, warmup=0)  # y_loop was its warm-up
    bound_ms = true / FP32_PEAK * 1e3
    buckets = [[len(p["sectors"]), len(p["buckets"])] for p in plans]
    emit(phase="bs_engine", site=site, chi=SYM_CHI, batch=SYM_B,
         nnz=[int(s.data.shape[0]) for s in skels],
         sectors_buckets=buckets, true_gflop=true / 1e9,
         padded_gflop=padded / 1e9, padded_over_true=padded / true,
         ms=ms, tflops=true / ms / 1e9, bound_ms=bound_ms,
         bound_by="operations", loop_ms=loop_ms, max_rel_err=err,
         repeat_same_bits=repeat)
    check(np.isfinite(err) and err <= SYM_ENGINE_RTOL and repeat,
          f"bs_engine: executor against the per-sector loop {err}, "
          f"repeat bits {repeat}")


def timed_events(torch, fn):
    """(fn(), wall s, CUDA-event s), the card synchronised before and
    after."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def device_profile(torch, fn):
    """(device busy ms, device events: kernel launches and copies) of
    fn()."""
    rows = device_rows(torch, fn)
    return sum(r[0] for r in rows) / 1e3, sum(r[2] for r in rows)


def sym_dmrg_batched_phase(torch):
    """BASELINE.json's configuration at full width: N=32, chi=1024, B=8,
    m=10, f32, per-realization Jz through mpo_data.  The plan build (the
    cold start), the right-canonicalising prepass, 1 warm + SYM_TIMED
    timed one-site sweeps, the device's idle share and kernel launches of
    one traced sweep, one two-site sweep with its discarded weight, and
    B=32 one-site sweeps for the rate."""
    from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    skel, data, mpo, mpo_data, jz = sym_setup(torch, SYM_N, SYM_CHI, SYM_B)
    d = BatchedSymmetricDMRG(skel, data, mpo, mpo_data=mpo_data)
    plan_s = d.precompile()
    cold_s = time.perf_counter() - t0
    R, _, prepass_s = timed_events(torch, d.right_canonicalize)
    warm, _, warm_s = timed_events(torch, lambda: d.sweep_one_site(R))
    energies = [warm.cpu().numpy()]

    def timed():
        return [d.sweep_one_site(R) for _ in range(SYM_TIMED)]

    es, wall, dev = timed_events(torch, timed)
    energies = np.stack(energies + [e.cpu().numpy() for e in es])
    sweep_s = dev / SYM_TIMED
    busy, launches = device_profile(torch, lambda: d.sweep_one_site(R))
    res = dict(N=SYM_N, chi=SYM_CHI, batch=SYM_B,
               max_bond=max(s.flat_charges[2].dim for s in d.skeleton),
               jz=jz.tolist(), plan_build_s=plan_s, cold_start_s=cold_s,
               programs=len(d._programs), plans=len(TE._PLAN_CACHE),
               prepass_s=prepass_s, warm_sweep_s=warm_s, sweep_s=sweep_s,
               sweep_wall_s=wall / SYM_TIMED,
               instance_sweeps_per_s=SYM_B / sweep_s,
               sweep_device_busy_ms=busy,
               device_idle_share=1 - busy / (sweep_s * 1e3),
               launches_per_sweep=launches,
               energies_per_sweep=energies.tolist())
    check(np.all(np.isfinite(energies)) and energies.shape ==
          (1 + SYM_TIMED, SYM_B),
          f"sym_dmrg_batched: energies {energies}")
    # variational sweeps: no realization rises by more than f32 noise
    check(np.all(np.diff(energies, axis=0) <= 1e-4),
          f"sym_dmrg_batched: an energy rose across sweeps: {energies}")
    check(len(set(np.round(energies[-1], 4))) == SYM_B,
          "sym_dmrg_batched: realizations with different couplings gave "
          "equal energies")
    # one two-site sweep: its programs' plans, then the sweep
    t0 = time.perf_counter()
    d.precompile(two_site=True)
    res["two_site_plan_build_s"] = time.perf_counter() - t0
    (e2, terr), wall2, dev2 = timed_events(torch, lambda: d.sweep_two_site(R))
    e2, terr = e2.cpu().numpy(), terr.cpu().numpy()
    res.update(two_site_sweep_s=dev2, two_site_wall_s=wall2,
               two_site_energies=e2.tolist(),
               two_site_discarded_weight=terr.tolist())
    check(np.all(np.isfinite(e2)) and np.all(np.isfinite(terr))
          and np.all(terr >= 0) and np.all(e2 <= energies[-1] + 1e-4),
          f"two-site sweep: {e2}, {terr}")
    res["peak_mem_gb_b8"] = torch.cuda.max_memory_allocated() / 1e9
    del d, data, mpo_data, R
    torch.cuda.empty_cache()
    # B=32 for the rate: the same structures, so every plan is cached
    skel, data, mpo, mpo_data, _ = sym_setup(torch, SYM_N, SYM_CHI,
                                             SYM_B_RATE, seed=1)
    d = BatchedSymmetricDMRG(skel, data, mpo, mpo_data=mpo_data)
    n_plans = len(TE._PLAN_CACHE)
    R = d.right_canonicalize()
    es32, wall32, dev32 = timed_events(torch, lambda: d.sweep_one_site(R))
    res.update(b32_sweep_s=dev32, b32_wall_s=wall32,
               b32_instance_sweeps_per_s=SYM_B_RATE / dev32,
               b32_new_plans=len(TE._PLAN_CACHE) - n_plans,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(np.all(np.isfinite(es32.cpu().numpy())), f"B=32 energies {es32}")
    emit(phase="sym_dmrg_batched", **res)
    del d, data, mpo_data, R
    torch.cuda.empty_cache()


def sym_dmrg_ed_phase(torch):
    """N=16 against exact diagonalisation in the half-filled sector: the
    batched one-site sweeps (chi=1024, capped at 236 by the window; B=8,
    each realization against its own Jz) and SymmetricFiniteDMRG
    (two-site, chi=64, realization 0's MPO) with both engines; every f32
    energy within [DE_LO, DE_HI] of the exact one."""
    from tensornetwork_tpu_torch.models.symmetric_dmrg import (
        SymmetricFiniteDMRG, half_filled_mps, u1_xxz_mpo)
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    n = SYM_ED_N
    skel, data, mpo, mpo_data, jz = sym_setup(torch, n, SYM_CHI, SYM_B)
    t0 = time.perf_counter()
    exact, states = zip(*(sector_ground_energy(n, j) for j in jz))
    ed_s = time.perf_counter() - t0
    d = BatchedSymmetricDMRG(skel, data, mpo, mpo_data=mpo_data)
    plan_s = d.precompile()
    es, wall, dev = timed_events(torch, lambda: d.run_one_site(
        SYM_ED_SWEEPS, tol=-1.0))
    de = es - np.array(exact)
    res = dict(N=n, chi=SYM_CHI, batch=SYM_B,
               max_bond=max(s.flat_charges[2].dim for s in d.skeleton),
               sector_states=states[0], ed_s=ed_s, plan_build_s=plan_s,
               sweeps=SYM_ED_SWEEPS, wall_s=wall, device_s=dev,
               exact=exact, de=de.tolist())
    check(np.all((de >= DE_LO) & (de <= DE_HI)),
          f"sym_dmrg_ed batched N={n}: E - exact {de}")
    single = []
    w = u1_xxz_mpo(1.0, 1.0, 0.0, n, dtype=torch.float32, device=DEV)
    for engine in ("device", "numpy"):
        mps = half_filled_mps(n, SYM_SINGLE_CHI, seed=1,
                              dtype=torch.float32, device=DEV)
        s = SymmetricFiniteDMRG(mps, w, engine=engine)
        e, wall_e, _ = timed_events(torch, lambda: s.run_two_site(
            SYM_SINGLE_CHI, num_sweeps=SYM_SINGLE_SWEEPS, tol=-1.0))
        single.append(dict(engine=engine, de=e - exact[0], wall_s=wall_e,
                           energies=s.energies))
        check(DE_LO <= e - exact[0] <= DE_HI,
              f"SymmetricFiniteDMRG ({engine}) N={n}: E - exact "
              f"{e - exact[0]}")
    res["single_two_site"] = single
    emit(phase="sym_dmrg_ed", **res)


def bs_network_phase(torch):
    """Block-sparse ncon and split_node on the card: the norm of a random
    U(1) MPS (N=16, chi=64, f64) as one ncon against a loop of sector
    tensordots, and split_node / split_node_qr of a two-site block of it
    (chi=64 bonds), each rebuilt."""
    import tensornetwork_tpu_torch as tn
    from tensornetwork_tpu_torch.blocksparse import tensordot
    from tensornetwork_tpu_torch.models.symmetric_dmrg import half_filled_mps
    n = SYM_ED_N
    mps = half_filled_mps(n, SYM_SINGLE_CHI, seed=2, device=DEV)
    tensors = mps + [a.conj() for a in mps]
    structure = []
    for i in range(n):   # ket bonds 1.., bra bonds 100+.., physical 200+
        left = [i] if i else [-1]
        right = [i + 1] if i < n - 1 else [-2]
        structure.append(left + [200 + i] + right)
    for i in range(n):
        left = [100 + i] if i else [-3]
        right = [101 + i] if i < n - 1 else [-4]
        structure.append(left + [200 + i] + right)
    # the zip order: site i's ket, then its bra
    order = [200] + [x for i in range(1, n) for x in (i, 100 + i, 200 + i)]
    t0 = time.perf_counter()
    out = tn.ncon(tensors, structure, con_order=order)
    value = float(out.todense().sum())
    ncon_s = time.perf_counter() - t0
    E = tensordot(mps[0], mps[0].conj(), [[0, 1], [0, 1]])
    for a in mps[1:]:
        E = tensordot(tensordot(E, a, [[0], [0]]), a.conj(),
                      [[0, 1], [0, 1]])
    ref = float(E.todense().sum())
    rel = abs(value - ref) / abs(ref)
    theta = tensordot(mps[n // 2 - 1], mps[n // 2], [[2], [0]])
    dense = theta.todense()
    res = dict(N=n, chi=SYM_SINGLE_CHI, value=value, ref=ref, rel_err=rel,
               ncon_s=ncon_s)
    for name in ("split_node", "split_node_qr"):
        node = tn.Node(theta)
        edges = list(node.edges)
        t0 = time.perf_counter()
        parts = getattr(tn, name)(node, edges[:2], edges[2:])
        merged = tn.contract_between(parts[0], parts[1])
        merged.reorder_edges(edges)
        res[name + "_s"] = time.perf_counter() - t0
        res[name + "_rel_err"] = err = float(
            torch.linalg.vector_norm(merged.tensor.todense() - dense)
            / torch.linalg.vector_norm(dense))
        check(err <= 1e-12, f"block-sparse {name}: reconstruction {err}")
    emit(phase="bs_network", **res)
    check(rel <= 1e-12, f"block-sparse ncon norm {value} against {ref}")


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
    routes = dict(K.route_counts)
    emit(phase="main_path_launches", chi=CHI, **launches, routes=routes)
    check(launches["fused_lanczos"] > 0 and launches["heff_matvec"] > 0
          and launches["fused_gauge_env"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(routes["heff_matvec_simt"] == 0
          and routes["heff_matvec_tc32"] == launches["heff_matvec"],
          f"K1 on the chi={CHI} path left the tensor cores: {routes}")
    check_k5_resident(launches, routes)

    states = {"xla": (As, renvs)}

    # the batched chi=64 path with the fused epilogue, with its own counts
    K.reset_launch_counts()
    As, renvs, _, fused_s = batched_phase(torch, "fused")
    counts = dict(K.launch_counts)
    routes = dict(K.route_counts)
    emit(phase="fused_epilogue_launches", chi=CHI, **counts, routes=routes)
    check(counts["fused_gauge_env"] > 0 and counts["fused_lanczos"] > 0,
          f"a kernel of the fused-epilogue path never launched: {counts}")
    check_k5_resident(counts, routes)
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

    # TDVP: K2 at its shapes, then its paths, each with its own counts
    k2_tdvp_phase(torch)
    for tdvp_path in (tdvp_batched_phase, tdvp_exact_phase,
                      tdvp_imaginary_phase):
        K.reset_launch_counts()
        tdvp_path(torch)
        counts = dict(K.launch_counts)
        emit(phase=tdvp_path.__name__[:-6] + "_launches", **counts)
        check(counts["fused_lanczos"] > 0, f"K2 never launched: {counts}")
        launches["fused_lanczos"] += counts["fused_lanczos"]

    # VUMPS: K2 at its shapes, then its paths, each with its own counts
    k2_vumps_phase(torch)
    reset_vumps_counts()
    vumps_probe_phase(torch)
    counts = vumps_counts()
    emit(phase="vumps_probe_launches", **counts)
    check_vumps_launches(counts, "float32", "probe")
    launches["fused_lanczos"] += counts["k2"]
    for dtype in (torch.float32, torch.float64):
        reset_vumps_counts()
        res = vumps_converge_phase(torch, dtype)
        counts = vumps_counts()
        emit(phase="vumps_converge_launches", dtype=str(dtype)[6:], **counts)
        check_vumps_launches(counts, str(dtype)[6:], "convergence run")
        launches["fused_lanczos"] += counts["k2"]
    reset_vumps_counts()
    itdvp_phase(torch, res.state, vumps_w(torch, torch.float64))
    counts = vumps_counts()
    emit(phase="itdvp_launches", **counts)
    check(counts["k2"] == 0, f"K2 launched on a complex state: {counts}")
    state64 = res.state
    del res

    # the MPS object layer, each path with its own counts
    K.reset_launch_counts()
    ground, counts = mps_dmrg_phase(torch)
    emit(phase="mps_dmrg_launches", **counts)
    check(counts["fused_lanczos"] > 0 and counts["fused_gauge_env"] > 0,
          f"a kernel of the FiniteMPS path never launched: {counts}")
    for name in counts:
        launches[name] += counts[name]
    tebd_phase(torch, ground)
    imps_phase(torch, state64)
    mera_phase(torch)
    K.reset_launch_counts()
    api_leftovers_phase(torch, ground)
    counts = dict(K.launch_counts)
    emit(phase="api_leftovers_launches", **counts)
    check(counts["fused_lanczos"] > 0, f"K2 never launched: {counts}")
    launches["fused_lanczos"] += counts["fused_lanczos"]
    del ground, state64
    torch.cuda.empty_cache()

    # ncon and the graph core: no kernel runs on these paths
    K.reset_launch_counts()
    values = ncon_mps_inner_phase(torch, card)
    graph_core_phase(torch, card, values)
    counts = dict(K.launch_counts)
    emit(phase="ncon_graph_core_launches", **counts)
    check(not any(counts.values()),
          f"a kernel launched on the ncon / graph-core path: {counts}")
    ncon_batched_phase(torch, card)
    torch.cuda.empty_cache()

    # block-sparse U(1) DMRG, ncon and split_node: no kernel on this path
    K.reset_launch_counts()
    for bs_path in (bs_engine_phase, sym_dmrg_batched_phase,
                    sym_dmrg_ed_phase, bs_network_phase):
        t0 = time.perf_counter()
        bs_path(torch)
        emit(phase=bs_path.__name__[:-6] + "_seconds",
             seconds=time.perf_counter() - t0)
    counts = dict(K.launch_counts)
    emit(phase="block_sparse_launches", **counts)
    check(not any(counts.values()),
          f"a kernel launched on the block-sparse path: {counts}")

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
