"""Profiling, FLOP accounting and utilization reporting.

Counterpart of :mod:`tensornetwork_tpu.utils.profiling`: per-phase wall
timers, the contraction plan's FLOP model, a timing helper that reports
achieved FLOP/s against the card's published peak, and a
``torch.profiler`` trace.  On the card, :func:`benchmark` times with CUDA
events after a synchronise; on the CPU it uses the host clock and reports
no utilization, since no CPU peak is published here.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

# Published dense peaks (FLOP/s) by the name torch.cuda.get_device_name
# gives: NVIDIA's H100 SXM data sheet, without sparsity, at the 700 W
# power limit.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12,
                              "bfloat16": 989e12},
}


def detect_chip() -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


@dataclass
class Timer:
    """Accumulating per-phase wall timers."""
    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.phases.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:30s} {total:10.4f}s  x{n}  "
                         f"({total / n * 1e3:8.3f} ms/call)")
        return "\n".join(lines)


def ncon_flops(network_structure, shapes, con_order=None) -> int:
    """Analytic FLOP count of an ncon contraction, from the compiled
    plan's cost model (the reference's path solvers expose the same
    quantity as log10 cost, ``custom_path_solvers/pathsolvers.py:91-145``).
    """
    from tensornetwork_tpu_torch.ops.ncon import (canonicalize_structure,
                                                  compile_plan)
    structure, mapping = canonicalize_structure(network_structure)
    if con_order is not None:
        con_order = tuple(mapping.get(l, l) if isinstance(l, str) else int(l)
                          for l in con_order)
    plan = compile_plan(structure, con_order, None)
    return plan.flops([tuple(s) for s in shapes])


def _sync(chip: str) -> None:
    if chip != "cpu":
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1,
              flops: Optional[int] = None,
              chip: Optional[str] = None) -> Dict[str, float]:
    """First-call and steady-state time of ``fn(*args)``.

    ``compile_s`` is the first call (a kernel's build at first use), by
    the host clock to the synchronised result; ``per_call_s`` the mean of
    ``iters`` chained calls after ``warmup``, by CUDA events on the card.
    With ``flops``: ``flops_per_s`` and ``mxu_utilization``, the share of
    the card's published peak (``PEAK_FLOPS``) for the dtype of the first
    tensor argument, bfloat16 or else float32 (None where the chip has no
    published peak, as the CPU)."""
    chip = chip or detect_chip()
    _sync(chip)
    t0 = time.perf_counter()
    fn(*args)
    _sync(chip)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        fn(*args)
    if chip == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        per_call = (time.perf_counter() - t0) / iters
    else:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        per_call = start.elapsed_time(end) / 1e3 / iters
    result = {"compile_s": compile_s, "per_call_s": per_call}
    if flops is not None:
        achieved = flops / per_call
        dtype = next((a.dtype for a in args if isinstance(a, torch.Tensor)),
                     torch.float32)
        peak = PEAK_FLOPS.get(chip, {}).get(
            "bfloat16" if dtype == torch.bfloat16 else "float32")
        result["flops_per_s"] = achieved
        result["mxu_utilization"] = None if peak is None else achieved / peak
        result["chip"] = chip
    return result


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the block (host, and the card's
    kernels and copies where there is one), written to
    ``logdir/trace.json`` in Chrome's trace format."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def dmrg_sweep_flops(N: int, chi: int, d: int, M: int,
                     num_krylov_vecs: int) -> int:
    """Analytic FLOPs of one one-site DMRG sweep on uniform stacks:
    per site, the Lanczos runs m matvecs (each ~ two chi²·d·M·chi
    contractions), plus one QR (~2·chi³·d) and one env update; a full
    sweep visits every site twice."""
    matvec = 2 * (2 * chi ** 3 * d * M + chi ** 2 * d ** 2 * M ** 2)
    per_site = (num_krylov_vecs * matvec
                + 2 * 2 * (chi * d) * chi ** 2     # QR
                + matvec)                          # env update
    return 2 * N * per_site
