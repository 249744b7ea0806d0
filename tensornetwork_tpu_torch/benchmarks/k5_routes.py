"""Times of the fused epilogue (K5) on both kernel routes over batch and chi.

    python -m tensornetwork_tpu_torch.benchmarks.k5_routes [--chis 64,96,128]
        [--batches 1,2,4,8,16,32,64,128,256]

For each (chi, B), f32, d=2, M=3, 14 quintic and 7 cubic steps, random
operands from a seed: the mean time of ``fused_gauge_env`` by CUDA events
on the route ``"resident"`` (where it takes chi) and on the route
``"grid"``, and the route :func:`~tensornetwork_tpu_torch.ops.kernels.
gauge_env_route` picks.  One JSON line per chi, the card's name and power
limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

D, M = 2, 3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chis", default="64,96,128")
    ap.add_argument("--batches", default="1,2,4,8,16,32,64,128,256")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        raise SystemExit("k5_routes: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0]}), flush=True)

    def cuda_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    for chi in (int(c) for c in args.chis.split(",")):
        rows = []
        for B in (int(b) for b in args.batches.split(",")):
            g = torch.Generator(device="cuda").manual_seed(chi + B)
            kw = dict(dtype=torch.float32, device="cuda", generator=g)
            W = torch.randn((M, M, D, D), **kw)
            E = torch.randn((B, M, chi, chi), **kw) / chi
            A = torch.randn((B, D * chi, chi), **kw)
            row = {"B": B, "picked": K.gauge_env_route(chi, D, M,
                                                       torch.float32, B)}
            with highest_precision():
                for route in ("resident", "grid"):
                    if route == "resident" and not K.gauge_env_resident_fits(
                            chi, D, M, torch.float32):
                        continue
                    row[route + "_ms"] = cuda_ms(lambda: K.fused_gauge_env(
                        W, E, A, route=route))
            rows.append(row)
            del W, E, A
        print(json.dumps({"chi": chi, "d": D, "M": M, "rows": rows}),
              flush=True)


if __name__ == "__main__":
    main()
