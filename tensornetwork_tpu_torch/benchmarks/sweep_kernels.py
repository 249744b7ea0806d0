"""Device time by kernel of the large-chi single-instance sweeps.

    python tensornetwork_tpu_torch/benchmarks/sweep_kernels.py [ROOT ...]

For each ROOT, a checkout that holds ``tensornetwork_tpu_torch/`` (by
default the checkout this file is in), a fresh process runs three sweeps of
one TFI N=32 chain, f32, from a random state: two-site at chi=1024 (m=6, two
warm-started subspace iterations with the polar orthonormaliser) and
one-site at chi=1024 (m=10); then it traces one more sweep of each with
torch.profiler and prints the sweep times, the device's busy time and the
kernels that took the most device time.  Given two checkouts in turns
(``OLD NEW NEW OLD``), it compares two versions of the package on one card.
Needs a CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
N, TOP = 32, 8


def _one(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tensornetwork_tpu_torch as pkg
    from tensornetwork_tpu_torch import FiniteTFI, one_site_sweep, two_site_sweep
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack

    print("package", pkg.__file__, flush=True)
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32)
    runs = (("two_site", 1024, two_site_sweep,
             dict(num_krylov_vecs=6, trunc_impl="subspace", trunc_iters=2,
                  trunc_orth="polar")),
            ("one_site", 1024, one_site_sweep, dict(num_krylov_vecs=10)))
    for label, chi, sweep, kw in runs:
        As = random_mps_stack(chi + 1, N, chi, 2, dtype=torch.float32)
        renvs, times = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sweep(As, mpo.Ws, mpo.vL, mpo.vR, renvs=renvs, **kw)
            float(res.energy)   # synchronises
            times.append(time.perf_counter() - t0)
            As, renvs = res.As, res.renvs
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sweep(As, mpo.Ws, mpo.vL, mpo.vR, renvs=renvs, **kw)
            torch.cuda.synchronize()
        rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                       for ev in prof.key_averages()
                       if ev.self_device_time_total), reverse=True)
        print(f"{label} chi={chi} sweep_s={[round(t, 3) for t in times]} "
              f"device_busy_ms={sum(r[0] for r in rows) / 1e3:.1f}",
              flush=True)
        for us, key, count in rows[:TOP]:
            print(f"  {us / 1e3:9.1f} ms  x{count:<6d} {key[:90]}", flush=True)
        del As, renvs, res, prof
        torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        _one(argv[1])
        return 0
    rc = 0
    for root in argv or [str(HERE)]:
        print(f"== {root}", flush=True)
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              str(Path(root).resolve())]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
