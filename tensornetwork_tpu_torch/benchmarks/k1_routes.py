"""Times of the batched H_eff matvec (K1) on each kernel route over batch,
chi and the number of physical tiles.

    python -m tensornetwork_tpu_torch.benchmarks.k1_routes [--batches 1,8,64,256]
        [--chis 32,64,128,256] [--nts 2,4]

For each (nt, chi, B), f32, M=3, random Hermitian operands from a seed,
on the route ``"tc32"`` (the 3xTF32 tensor-core core, ``heff_matvec``)
and on ``"simt"`` (the fp32 SIMT kernel of the first port,
``heff_matvec_simt``, never routed for f32): the mean time of one call
by CUDA events (``*_ms``; at small sizes the host's launch rate), timed
in turns tc32, simt, simt, tc32 so that a drift of the card's clock
falls on both, and its device time by torch.profiler (``*_dev_ms``: the
kernels alone, which the router follows), with the route
:func:`~tensornetwork_tpu_torch.ops.kernels.heff_matvec_route` picks.
One JSON line per (nt, chi), the card's name and power limit first.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

M = 3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,8,64,256")
    ap.add_argument("--chis", default="32,64,128,256")
    ap.add_argument("--nts", default="2,4")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    from tensornetwork_tpu_torch.config import highest_precision
    from tensornetwork_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        raise SystemExit("k1_routes: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0]}), flush=True)

    def dev_ms(fn):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages())
        return us / 1e3 / args.reps

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

    for nt in (int(t) for t in args.nts.split(",")):
        for chi in (int(c) for c in args.chis.split(",")):
            rows = []
            for B in (int(b) for b in args.batches.split(",")):
                g = torch.Generator(device="cuda").manual_seed(chi + B + nt)
                kw = dict(dtype=torch.float32, device="cuda", generator=g)
                L = torch.randn((B, chi, M, chi), **kw)
                L = (L + L.permute(0, 3, 2, 1)) / (2 * chi)
                R = torch.randn((B, chi, M, chi), **kw)
                R = (R + R.permute(0, 3, 2, 1)) / (2 * chi)
                W = torch.randn((M, M, nt, nt), **kw)
                W = (W + W.permute(1, 0, 3, 2)) / 2
                x = torch.randn((B, chi, nt, chi), **kw)
                ops = K.prepare_operands(L, W, R, x)
                row = {"B": B, "picked": K.heff_matvec_route(
                    chi, nt, M, B, torch.float32)}
                calls = {"tc32": lambda: K.heff_matvec(*ops),
                         "simt": lambda: K.heff_matvec_simt(*ops)}
                with highest_precision():
                    turns = {r: [] for r in calls}
                    for r in ("tc32", "simt", "simt", "tc32"):
                        turns[r].append(cuda_ms(calls[r]))
                    for r, call in calls.items():
                        row[r + "_ms"] = sum(turns[r]) / len(turns[r])
                        row[r + "_dev_ms"] = dev_ms(call)
                rows.append(row)
                del L, R, W, x, ops
            print(json.dumps({"nt": nt, "chi": chi, "M": M, "rows": rows}),
                  flush=True)


if __name__ == "__main__":
    main()
