"""What the port's tracing spans cost, on one card.

    python -m tensornetwork_tpu_torch.benchmarks.span_cost [--rounds 2]
        [--cells tfi,xxz] [--cpu]

One JSON line a step, the card's name and power limit first.  Two
batched one-site sweeps are timed: the critical TFI chain (N=32, chi=64,
B=4096, ``batched_one_site_sweep`` defaults) and the U(1) XXZ chain
(N=32, chi=1024, B=32, ``BatchedSymmetricDMRG.sweep_one_site`` after
``precompile``), in turns A, B, B, A a round: host seconds from the call
to its return and wall seconds to the synchronised result.  With no
profiler running, A is the port as built and B the port with every span
and counter taken out (the decorated functions and executor runs
unwrapped, the counters no-ops): the off cost.  Inside one
``torch.profiler`` session, A is the spans as built and B
``tracing.span`` always the shared null context: the on cost, with the
number of spans a sweep.  Then, for the XXZ chain, the executors' counted flops of one
sweep against the sum of each visited program's ``plan_flops``
(``min(m, nnz)`` matvec chains, the bond absorption, the environment
growth), and whether the spans open under
``torch.autograd.profiler.emit_nvtx`` (Nsight Systems' ranges).  Last,
microseconds a span opened and closed on the host: with no profiler (the
check alone), an ungated ``record_function`` with no profiler, and a span
inside a ``torch.profiler`` session.  ``--cells ""`` runs that alone;
``--cpu`` runs tiny sizes on the CPU, to rehearse.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time
from unittest import mock

import torch

from tensornetwork_tpu_torch.utils import tracing


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _card() -> dict:
    if not torch.cuda.is_available():
        return dict(card="cpu")
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return dict(card=torch.cuda.get_device_name(0), power=limit)


def tfi(N: int, chi: int, B: int, device):
    """A chained-sweep function of the TFI batch (its first sweep done)."""
    from tensornetwork_tpu_torch.models.mpo import FiniteTFI
    from tensornetwork_tpu_torch.parallel.batch import batched_one_site_sweep
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    As = torch.randn((B, N, chi, 2, chi), generator=g, dtype=torch.float32,
                     device=device) / (2 * chi) ** 0.5
    state = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR)

    def sweep():
        nonlocal state
        state = batched_one_site_sweep(state.As, mpo.Ws, mpo.vL, mpo.vR,
                                       renvs=state.renvs)
    sweep()
    return sweep, None


def xxz(N: int, chi: int, B: int, device):
    """A chained-sweep function of the XXZ batch after its plan build and
    prepass, and the solver."""
    from tensornetwork_tpu_torch.blocksparse import batched
    from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    skel = batched.uniform_skeleton_mps(N, chi, dtype=torch.float32,
                                        device=device)
    data = batched.random_data_batch(skel, B, seed=0, device=device)
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float32, device=device)
    d = BatchedSymmetricDMRG(skel, data, mpo)
    d.precompile()
    R = d.right_canonicalize()

    def sweep():
        d.sweep_one_site(R)
    sweep()
    return sweep, d


def _timed(sweep, sync):
    t0 = time.perf_counter()
    sweep()
    host = time.perf_counter() - t0
    sync()
    return host, time.perf_counter() - t0


def _null(name):
    return tracing._NULL


@contextlib.contextmanager
def stripped(solver=None):
    """The port without its spans and counters for the block: every
    function ``tracing.spanned`` wraps unwrapped, the executor runs of the
    solver's programs unwrapped, the counters no-ops and ``tracing.span``
    the null context."""
    from tensornetwork_tpu_torch.blocksparse import batched
    from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
    from tensornetwork_tpu_torch.models import dmrg, symmetric_dmrg_batched
    from tensornetwork_tpu_torch.ops import krylov
    wrapped = {dmrg: ("_local_solve_1s", "_local_solve_2s", "_gauge_env_left",
                      "_gauge_env_right", "_right_canonicalize_and_envs",
                      "_one_site_sweep_impl", "_two_site_sweep_impl"),
               krylov: ("_lanczos", "tridiag_ritz"),
               batched.ShiftPlan: ("__call__",),
               symmetric_dmrg_batched.BatchedSymmetricDMRG: (
                   "right_canonicalize", "sweep_one_site", "sweep_two_site")}
    with contextlib.ExitStack() as stack:
        def unwrap(owner, attr):
            stack.enter_context(mock.patch.object(
                owner, attr, getattr(owner, attr).__wrapped__))
        for owner, attrs in wrapped.items():
            for attr in attrs:
                unwrap(owner, attr)
        for prog in (solver._programs.values() if solver else ()):
            for attr in ("mv", "grow", "absorb", "theta"):
                fn = getattr(prog, attr, None)
                if hasattr(fn, "__wrapped__"):
                    unwrap(prog, attr)
                    continue
                # a chain of plan runs keeps them in a list in its closure
                for cell in getattr(fn, "__closure__", None) or ():
                    runs = cell.cell_contents
                    if isinstance(runs, list) and runs and all(
                            hasattr(r, "__wrapped__") for r in runs):
                        stack.callback(runs.__setitem__, slice(None),
                                       list(runs))
                        runs[:] = [r.__wrapped__ for r in runs]
        stack.enter_context(mock.patch.object(TE, "_count_work",
                                              lambda B, work: None))
        stack.enter_context(mock.patch.object(tracing, "add",
                                              lambda name, n=1: None))
        stack.enter_context(mock.patch.object(tracing, "span", _null))
        yield


def timing(cell: str, sweep, solver, rounds: int, sync,
           profiled: bool) -> None:
    if profiled:
        on, off = "spans", "null"

        def without():
            return mock.patch.object(tracing, "span", _null)
    else:
        on, off = "built", "stripped"

        def without():
            return stripped(solver)
    out = {on: [], off: []}
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        for mode in [on, off, off, on] * rounds:
            with without() if mode == off else contextlib.nullcontext():
                out[mode].append(_timed(sweep, sync))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    line = dict(step="profiled" if profiled else "unprofiled", cell=cell)
    for mode, xs in out.items():
        line[mode + "_host_s"] = [h for h, _ in xs]
        line[mode + "_wall_s"] = [w for _, w in xs]
    line["host_median_gap_ms"] = 1e3 * (
        statistics.median(line[on + "_host_s"])
        - statistics.median(line[off + "_host_s"]))
    if prof is not None:
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() != torch._C._autograd.DeviceType.CUDA
                 and e.name().startswith(tracing.PREFIX)]
        sweeps = len(out[on])
        line["spans_a_sweep"] = len(names) / sweeps
        counts = {}
        for n in names:
            counts[n] = counts.get(n, 0) + 1
        line["by_name_a_sweep"] = {k: v / sweeps for k, v in counts.items()}
    emit(**line)


def plan_work(d) -> tuple:
    """(true, padded) executor flops of one one-site sweep of ``d``, from
    the plans of the programs it visits."""
    from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
    true = padded = 0
    visits = ([(s, "right") for s in range(d.N - 1)]
              + [(s, "left") for s in range(d.N - 1, 0, -1)])
    for site, direction in visits:
        prog = d._program(site, direction)
        plans = [p for _, p in prog.plans]
        if len(plans) != 7:
            raise AssertionError(f"{len(plans)} plans in a site program")
        m = min(d.m, d.skeleton[site].data.shape[0])
        for k, plan in enumerate(plans):
            t, p = TE.plan_flops(plan)
            reps = m if k < 3 else 1     # the matvec chain, then absorb, grow
            true += reps * t
            padded += reps * p
    return d.B * true, d.B * padded


def flops(d, sweep, sync) -> None:
    sync()
    before = tracing.snapshot()
    sweep()
    sync()
    after = tracing.snapshot()
    counted = {k: after[k] - before[k] for k in
               ("bs_true_flops", "bs_padded_flops", "bs_gemms")}
    true, padded = plan_work(d)
    emit(step="xxz_flops", counted=counted, plan_true=true,
         plan_padded=padded, counted_share=100 * counted["bs_true_flops"]
         / counted["bs_padded_flops"], plan_share=100 * true / padded)


def nvtx(sweep) -> None:
    try:
        with torch.autograd.profiler.emit_nvtx():
            on = tracing.enabled()
            kind = type(tracing.span("sweep")).__name__
            sweep()
        emit(step="nvtx", profiler_enabled=on, span_type=kind)
    except RuntimeError as e:
        emit(step="nvtx", error=str(e))


def _per_span_us(n: int, make) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with make("sweep"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def micro(n: int = 20000) -> None:
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    line = dict(step="micro", spans=n,
                off_us=_per_span_us(n, tracing.span),
                ungated_off_us=_per_span_us(n, record_function))
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        line["on_us"] = _per_span_us(n, tracing.span)
    emit(**line)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cells", default="tfi,xxz")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    emit(step="card", **_card(), torch=torch.__version__)
    sizes = {"tfi": (8, 16, 4), "xxz": (8, 16, 3)} if a.cpu else \
        {"tfi": (32, 64, 4096), "xxz": (32, 1024, 32)}
    makers = {"tfi": tfi, "xxz": xxz}
    for cell in filter(None, a.cells.split(",")):
        t0 = time.perf_counter()
        sweep, solver = makers[cell](*sizes[cell], device)
        sync()
        emit(step="setup", cell=cell, seconds=time.perf_counter() - t0)
        timing(cell, sweep, solver, a.rounds, sync, profiled=False)
        timing(cell, sweep, solver, a.rounds, sync, profiled=True)
        if solver is not None:
            flops(solver, sweep, sync)
        if cell == "tfi" and device == "cuda":
            nvtx(sweep)
        del sweep, solver
        if device == "cuda":
            torch.cuda.empty_cache()
    micro()


if __name__ == "__main__":
    main()
