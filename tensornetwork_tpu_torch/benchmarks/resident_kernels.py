"""Times of the resident Lanczos kernel (K2) and the transfer chain (K6),
and the device time by kernel of one batched chi=64 sweep.

    python tensornetwork_tpu_torch/benchmarks/resident_kernels.py [ROOT ...]

For each ROOT, a checkout that holds ``tensornetwork_tpu_torch/`` (by
default the checkout this file is in), a fresh process times, by CUDA
events, ``fused_lanczos`` in f32 at the batched paths' shapes (one-site
nt=2, m=10 and two-site nt=4, m=6; chi=64, M=3; B=256, and B=132, one
instance per SM) and ``transfer_chain`` at bench.py's shape (B=256, N=32,
chi=128, d=2, bf16); then it runs three batched one-site sweeps of B=256
TFI N=32 chains at chi=64 (m=10) and traces one more with torch.profiler:
the sweep time, the device's busy time and the kernels that took the most
device time.  One JSON line per ROOT.  Given two checkouts in turns
(``OLD NEW NEW OLD``), it compares two versions of the package on one
card.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CHI, M, TOP = 64, 3, 6


def _one(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tensornetwork_tpu_torch as pkg
    from tensornetwork_tpu_torch import FiniteTFI, batched_one_site_sweep
    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    from tensornetwork_tpu_torch.ops import kernels as K

    def cuda_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"package": pkg.__file__,
           "card": torch.cuda.get_device_name(0)}
    rng = np.random.default_rng(0)
    with highest_precision():
        for nt, m in ((2, 10), (4, 6)):
            for B in (256, 132):
                ops = [rng.standard_normal(s) for s in
                       ((B, CHI, M, CHI), (M, M, nt, nt), (B, CHI, M, CHI),
                        (B, CHI, nt, CHI))]
                L, W, R, x = (torch.as_tensor(a, dtype=torch.float32,
                                              device="cuda") for a in ops)
                L = (L + L.permute(0, 3, 2, 1)) / (2 * CHI)
                R = (R + R.permute(0, 3, 2, 1)) / (2 * CHI)
                W = (W + W.permute(1, 0, 3, 2)) / 2
                Lt, W, Rt, xt = K.prepare_operands(L, W, R, x)
                out[f"k2_nt{nt}_B{B}_ms"] = cuda_ms(
                    lambda: K.fused_lanczos(Lt, W, Rt, xt, m), 10)
    g = torch.Generator(device="cuda").manual_seed(3)
    As = (torch.randn((256, 32, 128, 2, 128), generator=g, device="cuda")
          / 16.0).to(torch.bfloat16)
    E0 = torch.eye(128, device="cuda").expand(256, 128, 128)
    out["k6_bench_shape_ms"] = cuda_ms(lambda: K.transfer_chain(As, E0), 5)
    del As, E0

    mpo = FiniteTFI(1.0, 1.0, N=32, dtype=torch.float32)
    As = random_mps_stack(1, 256 * 32, CHI, 2, dtype=torch.float32).reshape(
        256, 32, CHI, 2, CHI)
    renvs, times = None, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=10, renvs=renvs)
        res.energy.cpu()   # synchronises
        times.append(time.perf_counter() - t0)
        As, renvs = res.As, res.renvs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                               num_krylov_vecs=10, renvs=renvs)
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.self_device_time_total), reverse=True)
    out["batched_sweep_s"] = times
    out["batched_device_busy_ms"] = sum(r[0] for r in rows) / 1e3
    out["batched_device_top"] = [[key[:60], us / 1e3, count]
                                 for us, key, count in rows[:TOP]]
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        _one(argv[1])
        return 0
    rc = 0
    for root in argv or [str(HERE)]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              str(Path(root).resolve())]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
