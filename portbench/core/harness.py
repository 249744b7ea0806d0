"""One run of one cell: set-up, the measured window, the traced sweeps
(``--trace 1``), the output check against the reference, and the result
line.  Nothing here names a cell, a configuration or a metric: they are
found by the names in ``BENCHMARK.json`` (see :mod:`registry`)."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import List, Optional

from portbench.core import registry
from portbench.core import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "tensornetwork_tpu")


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX, its libraries or the JAX package, compared
    by whole top-level names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What the metric readers read."""

    def __init__(self, cfg, wl, kind):
        self.cfg, self.wl, self.kind = cfg, wl, kind
        self.batch = wl["batch"]
        self.setup_s = self.window_s = None
        self.build_s = 0.0
        self.sweeps = 0
        self.host_s: List[float] = []
        self.sweep_s: List[float] = []
        self.flops_per_sweep = None
        self.solve_work = None
        self.trace = None
        self.trace_sweeps = 0

    def peak(self, key: str) -> Optional[float]:
        from portbench.core.peaks import PEAKS
        return PEAKS.get(self.kind, {}).get(key)


def _build_seconds() -> float:
    """Seconds of the port's nvcc build in this process (0 where the
    checkout's build directory held every library): part of ``setup_s``,
    recorded apart as well, since only a checkout's first run pays it."""
    build = sys.modules.get("tensornetwork_tpu_torch.ops._build")
    log = getattr(build, "build_log", {}) if build else {}
    return max((float(e["seconds"]) for e in log.values()), default=0.0)


def _window(drv, state, seconds: float, card: bool, run: Run) -> None:
    """Back-to-back chained sweeps until the first that returns after
    ``seconds``, then a synchronise: sweep_rate's window."""
    import torch
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    marks = []
    if card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    t0 = time.perf_counter()
    host_marks = [t0]
    while True:
        h0 = time.perf_counter()
        drv.sweep(state)
        h1 = time.perf_counter()
        run.host_s.append(h1 - h0)
        host_marks.append(h1)
        if card:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        run.sweeps += 1
        if h1 - t0 >= seconds:
            break
    sync()
    run.window_s = time.perf_counter() - t0
    if card:
        run.sweep_s = [a.elapsed_time(b) / 1e3
                       for a, b in zip(marks[:-1], marks[1:])]
    else:
        run.sweep_s = [b - a for a, b in zip(host_marks[:-1],
                                             host_marks[1:])]


def _traced(drv, state, metrics, run: Run, card: bool) -> None:
    """Profile ``trace_sweeps`` more sweeps with every metric's spans
    installed, and reduce the trace."""
    spans = tr.Spans()
    seen = set()
    for name, mod in metrics.items():
        targets = getattr(mod, "spans", None)
        if targets is None:
            continue
        try:
            for label, pairs in targets(state).items():
                for owner, attr in pairs:
                    key = (label, id(owner), attr)
                    if key not in seen:
                        seen.add(key)
                        spans.wrap(owner, attr, label)
        except (AttributeError, ImportError) as e:
            _err(f"metric {name}: a wrapped function is gone ({e}); "
                 f"it is left out")
    n = int(run.wl.get("trace_sweeps", 1))
    try:
        with tr.profiled(card) as holder:
            for _ in range(n):
                drv.sweep(state)
    finally:
        spans.remove()
    t0 = time.perf_counter()
    run.trace = tr.reduce_events(holder.events)
    run.trace_sweeps = n
    del holder
    gc.collect()
    _err(f"trace: {n} sweeps, {run.trace['device_events']} device events "
         f"({run.trace['unlinked_device_events']} unlinked), span calls "
         f"{run.trace['span_calls']}, reduced in "
         f"{time.perf_counter() - t0:.3f} s")


def execute(argv: Optional[List[str]] = None, t_start: Optional[float] = None,
            root: str = registry.ROOT, bench_path: Optional[str] = None,
            device: Optional[str] = None, require_card: bool = True):
    """Run one cell; returns (exit code, result dict or None).  The
    command line always requires the card; a test passes ``device="cpu"``
    and ``require_card=False`` to drive the rest of a run."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    wl = registry.workload(args.workload, root)
    cfg = registry.config(wl["config"], root)
    bench = registry.benchmark(bench_path)
    import torch
    if require_card:
        if not torch.cuda.is_available():
            _err("no CUDA card: torch.cuda.is_available() is false")
            return 2, None
        if torch.cuda.device_count() < wl["chips"]:
            _err(f"the cell needs {wl['chips']} cards, "
                 f"{torch.cuda.device_count()} found")
            return 2, None
    device = device or "cuda"
    card = device == "cuda"
    kind = torch.cuda.get_device_name(0) if card else "cpu"
    section = "per_layer" if args.trace else "end_to_end"
    names = registry.metrics_of(bench, args.workload, section)
    metrics = {n: registry.metric(n, root) for n in names}
    drv = registry.driver(wl["driver"], root)
    run = Run(cfg, wl, kind)
    for attr, fn in (("flops_per_sweep", "flops_per_sweep"),
                     ("solve_work", "solve_work_per_sweep")):
        if hasattr(drv, fn):
            setattr(run, attr, getattr(drv, fn)(cfg, wl))

    if card:
        torch.cuda.reset_peak_memory_stats()
    state = drv.setup(cfg, wl, args.seed, device)
    if card:
        torch.cuda.synchronize()
    # what set-up left is kept out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - t_start
    run.build_s = _build_seconds()
    _window(drv, state, args.seconds, card, run)
    _err(f"window: {run.sweeps} sweeps in {run.window_s:.6f} s; set-up "
         f"{run.setup_s:.6f} s, of it the nvcc build {run.build_s:.6f} s")
    _err("sweep device s: " + " ".join(f"{x:.6f}" for x in run.sweep_s))
    _err("sweep host s:   " + " ".join(f"{x:.6f}" for x in run.host_s))
    if args.trace:
        _traced(drv, state, metrics, run, card)
    peak = torch.cuda.max_memory_allocated() if card else 0

    out = drv.outputs(state)
    del state
    gc.unfreeze()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from portbench.reference import judge
    checks, attempted, failed, info = judge.judge(cfg, wl, out)
    del out
    _err(f"reference: {time.perf_counter() - t0:.3f} s; not compared: "
         + json.dumps(info))

    found = forbidden_modules()
    if found:
        _err("loaded in the measuring process: " + ", ".join(found))
        return 3, None

    values = {}
    for name, mod in metrics.items():
        v = mod.read(run)
        if v is None:
            _err(f"metric {name}: nothing to read; left out")
            continue
        values[name] = {"value": float(v), "unit": mod.UNIT}
    result = {
        "correct": failed == 0 and bool(checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": values,
        "device": {"platform": "gpu" if card else "cpu", "kind": kind,
                   "count": int(wl["chips"]), "memory_peak_bytes": int(peak)},
    }
    if args.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["build_s"] = {"value": run.build_s, "unit": "s"}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        _err(f"check {n} {v!r} limit {lim!r}")
    return 0, result


def main(t_start: float) -> int:
    code, result = execute(sys.argv[1:], t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
