"""Where the time of an eager ``ncon`` goes: host replay against device work.

    python -m tensornetwork_tpu_torch.benchmarks.ncon_replay [--reps 10]

Two networks of chip_smoke.py, random operands from a seed: the
reference README's MPS inner product (N=20, chi=32, d=2, f32, the zip
con_order) and the B=256 batched norms (N=32, chi=128, d=2, f32, a batch
label on every site tensor, left open by a (B, B) identity).  For each:
the median ms of one contraction by CUDA events and by wall clock, with
Python's garbage collector on and off; the device time of one
contraction summed by torch.profiler in a fresh process, and its kernels
by name.  One JSON line per network, the card's name and power limit
first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import time

D = 2


def mps_inner(torch, n, chi, g):
    """Sites and labels of <psi|psi>, with the zip con_order."""
    sites = []
    for i in range(n):
        left, right = 1 if i == 0 else chi, 1 if i == n - 1 else chi
        sites.append(torch.randn((left, D, right), generator=g, device="cuda")
                     / (D * right) ** 0.5)
    ket = [[i + 1, 2 * n + 3 + i, i + 2] for i in range(n)]
    bra = [[n + 2 + i, 2 * n + 3 + i, n + 3 + i] for i in range(n)]
    ket[0][0] = bra[0][0] = 3 * n + 3
    ket[-1][2] = bra[-1][2] = 3 * n + 4
    order = [3 * n + 3]
    for i in range(n):
        order.append(2 * n + 3 + i)
        if i < n - 1:
            order += [i + 2, n + 3 + i]
    return sites + sites, ket + bra, order + [3 * n + 4]


def batched_norms(torch, B, n, chi, g):
    """Operands and labels of B norms as one ncon, end bonds closed."""
    As = torch.randn((B, n, chi, D, chi), generator=g, device="cuda") / (
        D * chi) ** 0.5
    sites = [As[:, i] for i in range(n)]
    b, left, right = 1, 2, 3
    ket = [[b, left if i == 0 else 4 + i, 4 + n + i,
            right if i == n - 1 else 5 + i] for i in range(n)]
    bra = [[b, left if i == 0 else 4 + 2 * n + i, 4 + n + i,
            right if i == n - 1 else 5 + 2 * n + i] for i in range(n)]
    order = [left]
    for i in range(n):
        order.append(4 + n + i)
        if i < n - 1:
            order += [5 + i, 5 + 2 * n + i]
    eye = torch.eye(B, device="cuda")
    return (sites + sites + [eye], ket + bra + [[b, -1]],
            order + [right, b])


def median_ms(torch, fn, reps):
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


def device_kernels(torch, fn, reps):
    """(device ms of one call, [[kernel, ms a call, launches a call]])."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3 / reps,
                    ev.count / reps, ev.key[:60])
                   for ev in prof.key_averages()
                   if ev.self_device_time_total), reverse=True)
    return sum(r[0] for r in rows), [[k, ms, n] for ms, n, k in rows[:6]]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    import tensornetwork_tpu_torch as tn

    if not torch.cuda.is_available():
        raise SystemExit("ncon_replay: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0]}),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    nets = {"mps_inner_n20_chi32": mps_inner(torch, 20, 32, g),
            "batched_norms_b256_n32_chi128": batched_norms(torch, 256, 32,
                                                           128, g)}
    for name, (tensors, structure, order) in nets.items():
        def run():
            return tn.ncon(tensors, structure, con_order=order)
        busy, top = device_kernels(torch, run, 3)
        gc_on = median_ms(torch, run, args.reps)
        gc.disable()
        try:
            gc_off = median_ms(torch, run, args.reps)
        finally:
            gc.enable()
        print(json.dumps(dict(
            network=name, ms_cuda_events=gc_on[0], ms_wall=gc_on[1],
            gc_off_ms_cuda_events=gc_off[0], gc_off_ms_wall=gc_off[1],
            device_busy_ms=busy, device_idle_share=1 - busy / gc_on[1],
            device_top=top)), flush=True)


if __name__ == "__main__":
    main()
