"""Chained-GEMM issue-rate probe: the counterpart of the repo's
``benchmarks/mxu_micro.py``.

The TPU's probe chains GEMMs of one shape inside one Pallas program, with
the operands resident, to measure the issue rate of its matrix unit (the
MXU) per matmul shape.  The H100 has no MXU: on Hopper the same ladder
probes the issue rate and latency of dependent bf16 tensor-core GEMMs
(``wgmma``, its operands brought in by TMA), through the hand-written
kernel ``csrc/gemm_chain.cu``
(:func:`tensornetwork_tpu_torch.ops.kernels.gemm_chain`, one launch per
call).  P=1 measures the latency of one dependent GEMM, larger P the
issue rate with P independent chains in flight.

    python -m tensornetwork_tpu_torch.benchmarks.mxu_micro

prints one line per shape of the ladder with its TFLOP/s, timed with CUDA
events; it needs a CUDA card.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from tensornetwork_tpu_torch.config import Device, default_device
from tensornetwork_tpu_torch.ops import kernels

# (M, K, N, P, reps): the ladder of the repo's benchmarks/mxu_micro.py
LADDER: Tuple[Tuple[int, int, int, int, int], ...] = (
    (128, 128, 128, 1, 300), (128, 128, 128, 4, 150),
    (128, 128, 128, 8, 100), (128, 128, 128, 16, 60),
    (128, 128, 256, 8, 100), (128, 128, 512, 8, 60),
    (128, 256, 256, 8, 60), (256, 256, 256, 8, 60),
    (256, 256, 512, 4, 60), (512, 512, 512, 4, 30),
    (512, 512, 1024, 2, 30))


def make_chain_kernel(M: int, K: int, N: int, reps: int,
                      P: int = 1) -> Callable:
    """``f(x, b, c) -> sum |out|``: P independent chains of GEMM pairs,
    x_p (M, K) @ b (K, N) folded back through c (N, K), ``reps`` times,
    bf16 between the steps and f32 accumulation (2 * reps * P GEMMs in
    one launch of :func:`~tensornetwork_tpu_torch.ops.kernels.gemm_chain`
    for CUDA tensors, its twin for CPU tensors).  Returns a float32
    scalar."""
    def f(x, b, c):
        if x.shape != (P, M, K) or b.shape != (K, N) or c.shape != (N, K):
            raise ValueError(f"expected x {(P, M, K)}, b {(K, N)}, c "
                             f"{(N, K)}; got {tuple(x.shape)}, "
                             f"{tuple(b.shape)}, {tuple(c.shape)}")
        out = kernels.gemm_chain(x, b, c, reps)
        return out.float().abs().sum()
    return f


def chain_flops(M: int, K: int, N: int, P: int, reps: int) -> int:
    """Operations of one call: 2 reps P GEMMs of 2 M K N each."""
    return P * reps * 2 * (M * K * N + M * N * K)


def chain_inputs(M: int, K: int, N: int, P: int, seed: int = 0,
                 device: Optional[Device] = None):
    """bf16 inputs x (P, M, K), b (K, N), c (N, K) with unit-variance rows
    after each product, from ``seed`` on the device."""
    device = default_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    x = torch.randn((P, M, K), **kw) / math.sqrt(K)
    b = torch.randn((K, N), **kw) / math.sqrt(K)
    c = torch.randn((N, K), **kw) / math.sqrt(N)
    return tuple(t.to(torch.bfloat16) for t in (x, b, c))


def time_ms(fn: Callable, iters: int = 3) -> float:
    """Mean ms of ``fn()`` on the card by CUDA events, after one warm-up
    call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    device = default_device()
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    for M, K, N, P, reps in LADDER:
        f = make_chain_kernel(M, K, N, reps, P=P)
        x, b, c = chain_inputs(M, K, N, P, device=device)
        ms = time_ms(lambda: f(x, b, c))
        tf = chain_flops(M, K, N, P, reps) / ms / 1e9
        print(f"({M:4d},{K:4d})x({K:4d},{N:4d}) P={P:2d} reps={reps:3d}: "
              f"{ms:8.3f} ms {tf:7.2f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
