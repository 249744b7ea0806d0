#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tensornetwork_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch twin at the main path's shapes, runs the main path -- one-site
DMRG of the transverse-field Ising chain, N=32, chi=64, d=2, M=3, m=10
Krylov vectors, f32, single instance and a batch of 256 -- and checks the
energies against the converged reference and a small chain against exact
diagonalisation.  Every phase prints one JSON line; a failed check exits
non-zero.  Needs one CUDA card and nvcc; without a card it exits 1 before
printing any result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

REFERENCE_ENERGY = -40.384313161218365  # TFI N=32 chi=64, converged
N, CHI, D, M, KRYLOV, BATCH = 32, 64, 2, 3, 10, 256
SINGLE_SWEEPS, BATCH_SWEEPS = 8, 8
# Accepted window of E - REFERENCE_ENERGY, where E is the energy of the
# returned f32 state evaluated in f64 (<psi|H|psi>/<psi|psi>).  The sweep's
# own f32 Ritz value is printed beside it: its environments sum 32 sites'
# energies in f32, which leaves it ~1e-4 of noise either side.
DE_LO, DE_HI = -1e-5, 1e-4
# fp32 kernel against its fp32 twin: the same products summed in other
# orders, a few ulp of 768-term sums; 1e-4 relative leaves headroom and
# still catches a TF32 product (~1e-3).
KERNEL_RTOL = 1e-4
FP32_PEAK = 67e12   # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s


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
    dev = torch.device("cuda")
    solver = [torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (L, W, R, x)]
    return solver, K.prepare_operands(*solver)


def matvec_work(B, chi, d, M):
    """(flops, bytes) of one batched H_eff matvec: the 2*M*d GEMMs, the
    coupling folds; L, R, x read once and y written once (f32)."""
    flops = B * (4 * M * d * chi ** 3 + 2 * M * M * d * d * chi ** 2)
    nbytes = 4 * (B * (2 * M + 2 * d) * chi ** 2 + M * M * d * d)
    return flops, nbytes


def bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K
    _, (Lt, W, Rt, xt) = hermitian_operands(torch, BATCH, CHI, D, M, seed=2)
    with highest_precision():
        V, ab = K.fused_lanczos(Lt, W, Rt, xt, KRYLOV)
        V0, ab0 = K.fused_lanczos_plain(Lt, W, Rt, xt, KRYLOV)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(V).all() and torch.isfinite(ab).all()),
              "K2 output not finite")
        rel_ab, rel_V = max_rel(ab, ab0), max_rel(V, V0)
        err = max(float((ab - ab0).abs().max()), float((V - V0).abs().max()))
        ms = cuda_ms(torch, lambda: K.fused_lanczos(Lt, W, Rt, xt, KRYLOV), 5)
        plain_ms = cuda_ms(
            torch, lambda: K.fused_lanczos_plain(Lt, W, Rt, xt, KRYLOV), 3)

        # breakdown: a product state on a diagonal operator dies at step 0
        dev = torch.device("cuda")
        Wd = torch.zeros((M, M, D, D), device=dev)
        Wd[0, 0] = torch.eye(D, device=dev)
        Ld = torch.zeros((4, M, CHI, CHI), device=dev)
        Ld[:, 0] = torch.diag(torch.arange(1.0, CHI + 1.0, device=dev))
        Rd = torch.zeros((4, M, CHI, CHI), device=dev)
        Rd[:, 0] = torch.eye(CHI, device=dev)
        xd = torch.zeros((4, D, CHI, CHI), device=dev)
        xd[:, 0, 0, 0] = 3.0
        xd[3] = 0.0                    # a zero start is dead from step 0
        Vd, abd = K.fused_lanczos(Ld, Wd, Rd, xd, KRYLOV)
        Vd0, abd0 = K.fused_lanczos_plain(Ld, Wd, Rd, xd, KRYLOV)
    sentinels = bool((abd[:3, 0, 1:] == 1e10).all() and (abd[3, 0] == 1e10).all()
                     and (abd[:, 1] == 0).all() and (Vd[:, 1:] == 0).all()
                     and (abd[:3, 0, 0] == 1.0).all())
    same = bool(torch.equal(abd, abd0) and torch.equal(Vd, Vd0))
    mv_flops, _ = matvec_work(BATCH, CHI, D, M)
    flops = KRYLOV * (mv_flops + 10 * BATCH * D * CHI * CHI)
    nbytes = 4 * (BATCH * (2 * M * CHI ** 2 + D * CHI ** 2
                           + KRYLOV * D * CHI ** 2 + 2 * KRYLOV) + M * M * D * D)
    bound_ms, bound_by = bound(flops, nbytes)
    emit(phase="k2_fused_lanczos", shape=[BATCH, CHI, D, M, KRYLOV],
         max_rel_err_ab=rel_ab, max_rel_err_V=rel_V, max_abs_err=err,
         breakdown_sentinels=sentinels, breakdown_equals_twin=same, ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         gflops_per_s=flops / ms / 1e6)
    check(rel_ab <= KERNEL_RTOL and rel_V <= KERNEL_RTOL,
          f"K2 disagrees with its twin: ab {rel_ab}, V {rel_V}")
    check(sentinels and same, "K2 breakdown sentinels wrong")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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
    runs = [("householder", "fused"), ("polar", "fused"),
            ("householder", "plain")]
    out = {}
    for qr_impl, lanczos_impl in runs:
        sweeps = SINGLE_SWEEPS if lanczos_impl == "fused" else 3
        As = random_mps_stack(0, N, CHI, D, dtype=torch.float32)
        renvs, times, energies = None, [], []
        for _ in range(sweeps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                 num_krylov_vecs=KRYLOV, qr_impl=qr_impl,
                                 lanczos_impl=lanczos_impl, renvs=renvs)
            e = float(res.energy)       # synchronises
            times.append(time.perf_counter() - t0)
            energies.append(e)
            As, renvs = res.As, res.renvs
        check(bool(torch.isfinite(As).all()) and As.shape == (N, CHI, D, CHI),
              "single-instance state not finite or misshapen")
        de = state_delta_e(torch, As, mpo64)
        rate = (len(times) - 1) / sum(times[1:])
        emit(phase="single_instance", qr_impl=qr_impl,
             lanczos_impl=lanczos_impl, sweeps=sweeps, delta_E=de,
             ritz_delta_E_per_sweep=[x - REFERENCE_ENERGY for x in energies],
             sweeps_per_s=rate, first_sweep_s=times[0])
        if lanczos_impl == "fused":
            check(DE_LO <= de <= DE_HI,
                  f"single instance ({qr_impl}) delta E {de} outside window")
        else:
            check(de >= DE_LO, f"plain route non-variational: {de}")


def device_busy_ms(torch, fn):
    """Sum of device time (kernels, copies) of fn() by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / 1e3


def batched_phase(torch):
    from tensornetwork_tpu_torch import FiniteTFI, batched_one_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    mpo64 = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64)
    As = random_mps_stack(1, BATCH * N, CHI, D, dtype=torch.float32).reshape(
        BATCH, N, CHI, D, CHI)
    renvs, times, per_sweep = None, [], []
    for _ in range(BATCH_SWEEPS):
        before = K.launch_counts["fused_lanczos"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=KRYLOV, renvs=renvs)
        energy = res.energy.cpu().numpy()   # synchronises
        times.append(time.perf_counter() - t0)
        per_sweep.append(K.launch_counts["fused_lanczos"] - before)
        As, renvs = res.As, res.renvs
    check(bool(torch.isfinite(As).all()) and res.energies.shape == (BATCH, N),
          "batched state not finite or misshapen")
    check(all(c == 2 * N for c in per_sweep),
          f"K2 launches per batched sweep {per_sweep}, expected {2 * N}")
    ritz = energy.astype(np.float64) - REFERENCE_ENERGY
    de = np.array([state_delta_e(torch, a, mpo64) for a in As])
    sweep_s = statistics.median(times[1:])
    emit(phase="batched", batch=BATCH, sweeps=BATCH_SWEEPS,
         delta_E_median=float(np.median(de)), delta_E_min=float(de.min()),
         delta_E_max=float(de.max()),
         instances_in_window=int(np.sum((de >= DE_LO) & (de <= DE_HI))),
         ritz_delta_E_median=float(np.median(ritz)),
         ritz_delta_E_min=float(ritz.min()), ritz_delta_E_max=float(ritz.max()),
         instance_sweeps_per_s=BATCH / sweep_s, sweep_s=times,
         k2_launches_per_sweep=per_sweep)
    check(bool(np.all((de >= DE_LO) & (de <= DE_HI))),
          f"batched delta E in [{de.min()}, {de.max()}], outside window")
    return As, renvs, mpo, sweep_s


def host_share_phase(torch, As, renvs, mpo, sweep_s, k2_ms):
    from tensornetwork_tpu_torch import batched_one_site_sweep

    def one_sweep():
        batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                               num_krylov_vecs=KRYLOV, renvs=renvs)

    t0 = time.perf_counter()
    busy_ms = device_busy_ms(torch, one_sweep)
    emit(phase="batched_device_time", sweep_ms=1e3 * sweep_s,
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / (1e3 * sweep_s),
         k2_share=2 * N * k2_ms / (1e3 * sweep_s),
         profile_seconds=time.perf_counter() - t0)


def variational_phase(torch):
    from tensornetwork_tpu_torch import FiniteDMRG, FiniteTFI, mpo_to_dense
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    n, chi = 10, 16
    mpo64 = FiniteTFI(1.0, 1.0, N=n, dtype=torch.float64)
    dense = torch.as_tensor(mpo_to_dense(mpo64), device=mpo64.Ws.device)
    exact = float(torch.linalg.eigvalsh(dense)[0])
    for dtype, tol in ((torch.float32, 5e-5), (torch.float64, 1e-9)):
        mpo = FiniteTFI(1.0, 1.0, N=n, dtype=dtype)
        dm = FiniteDMRG(random_mps_stack(5, n, chi, D, dtype=dtype), mpo)
        e = dm.run_one_site(num_sweeps=4, num_krylov_vecs=KRYLOV, tol=0.0)
        emit(phase="variational", N=n, chi=chi, dtype=str(dtype), E=e,
             exact=exact, delta=e - exact)
        check(e >= exact - tol and abs(e - exact) < tol,
              f"N={n} {dtype}: E {e} vs exact {exact}")


def main():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    from tensornetwork_tpu_torch.ops import kernels as K
    t_start = time.perf_counter()
    card = device_phase(torch)
    build_phase()
    k1 = k1_phase(torch)
    k2 = k2_phase(torch)

    # the main path: every count at 0 just before, read just after
    K.reset_launch_counts()
    single_phase(torch)
    As, renvs, mpo, sweep_s = batched_phase(torch)
    launches = dict(K.launch_counts)
    emit(phase="main_path_launches", **launches)
    check(launches["fused_lanczos"] > 0 and launches["heff_matvec"] > 0,
          f"a kernel of the main path never launched: {launches}")

    host_share_phase(torch, As, renvs, mpo, sweep_s, k2["ms"])
    del As, renvs
    variational_phase(torch)

    kernels = []
    for name, meas, src, replaces in (
            ("heff_matvec", k1, "tensornetwork_tpu_torch/csrc/heff_matvec.cu",
             "tensornetwork_tpu/ops/kernels.py:48"),
            ("fused_lanczos", k2, "tensornetwork_tpu_torch/csrc/fused_lanczos.cu",
             "tensornetwork_tpu/ops/kernels.py:138")):
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name], **meas))
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
