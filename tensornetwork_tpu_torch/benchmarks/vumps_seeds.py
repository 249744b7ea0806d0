"""Iterations of VUMPS to its gauge-error target over random starts.

    python -m tensornetwork_tpu_torch.benchmarks.vumps_seeds [--seeds 0,1,2,3,4]
        [--dtypes float32,float64]

The convergence runs of ``chip_smoke.py``'s ``vumps_converge`` phase
(critical TFI, the bulk tensor of ``FiniteTFI(1, 1, N=32)``, chi=64,
gmres_m=40, 8 restarts; f32 to gauge error 1e-4 in at most 80
iterations, f64 to 1e-5 in at most 60), each from the random state of
every seed: whether and when the gauge error crossed the target, its
last and smallest values, the energy density against the exact one,
and the seconds the run took.  One JSON line per (dtype, seed), the
card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

CHI, N = 64, 32
RUNS = {"float32": dict(num_iterations=80, tol=1e-4, gmres_m=40,
                        gmres_restarts=8),
        "float64": dict(num_iterations=60, tol=1e-5, gmres_m=40,
                        gmres_restarts=8)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--dtypes", default="float32,float64")
    args = ap.parse_args()

    import torch

    from tensornetwork_tpu_torch import FiniteTFI
    from tensornetwork_tpu_torch.models import vumps as V

    if not torch.cuda.is_available():
        raise SystemExit("vumps_seeds: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0]}), flush=True)
    e_exact = V.tfi_exact_energy_density(-1.0, -1.0)
    for name in args.dtypes.split(","):
        dtype, kw = getattr(torch, name), RUNS[name]
        W = FiniteTFI(1.0, 1.0, N=N, dtype=dtype, device="cuda").Ws[N // 2]
        for seed in (int(s) for s in args.seeds.split(",")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = V.vumps(W, chi=CHI, dtype=dtype, seed=seed, **kw)
            seconds = time.perf_counter() - t0
            errs = res.gradient_norms
            print(json.dumps(dict(
                dtype=name, seed=seed, chi=CHI, **kw,
                crossed=errs[-1] < kw["tol"], iterations=len(errs),
                gauge_error=errs[-1], gauge_error_min=min(errs),
                gauge_errors_last5=errs[-5:],
                delta_e=res.energy - e_exact, seconds=seconds)), flush=True)


if __name__ == "__main__":
    main()
