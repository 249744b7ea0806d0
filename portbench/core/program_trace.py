"""The port's own spans and counters in a traced run.

The port opens ``record_function("tnt.<layer>")`` spans while a profiler
collects (``tensornetwork_tpu_torch.utils.tracing``) and keeps counters
beside them.  :func:`install`, called from the ``spans(state)`` hook of a
metric that reads them (the harness calls the hooks just before the
profiled sweeps), takes the counters' snapshot and wraps
:func:`portbench.core.trace.reduce_events` for that one reduction, which
then also returns, from the same events and window:

  prog_device_s    device seconds under each program span, linked by
                   correlation id as ``span_device_s`` is (a nested span's
                   operations count in each enclosing one)
  prog_device_ops  device operations under each program span
  prog_calls       intervals of each program span
  prog_idle_s      every idle gap of the window, summed by the innermost
                   program span open at its start ("(none)" for none)
  counters         the port's counters after the sweeps less before them
                   (None where the port has no tracing module)

and prints them a sweep on standard error.  The card's mirrors of the
program's annotations are no operations.  The benchmark's own reduction
is handed the events without the program's spans, so its keys read as
they do for a port without them.  A port without the spans gives empty
dicts, and the metrics that read them read nothing.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

from portbench.core import trace as tr

PROGRAM = "tnt."
NONE = "(none)"


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def reduce_program(events) -> dict:
    """The program-span keys of the module docstring, over the window of
    the benchmark's profiled sweeps."""
    import torch
    cuda = torch._C._autograd.DeviceType.CUDA
    window = None
    spans: List[Tuple[int, int, str, int]] = []
    by_corr: Dict[int, int] = {}
    device: List[Tuple[int, int, int]] = []
    for ev in events:
        start, dur, name = ev.start_ns(), ev.duration_ns(), ev.name()
        if ev.device_type() == cuda:
            if not (name.startswith((tr.PREFIX, PROGRAM))
                    or tr._annotation(ev)):
                device.append((start, start + dur,
                               ev.linked_correlation_id()
                               or ev.correlation_id()))
            continue
        if name == tr.WINDOW:
            window = (start, start + dur, ev.start_thread_id())
        elif name.startswith(PROGRAM):
            spans.append((start, start + dur, name[len(PROGRAM):],
                          ev.start_thread_id()))
        by_corr[ev.correlation_id()] = start
    if window is None:
        raise RuntimeError("the profiled window left no trace")
    w0, w1, main = window
    device = [(max(s, w0), min(e, w1), c) for s, e, c in device
              if e > w0 and s < w1]

    by_name: Dict[str, List[Tuple[int, int]]] = {}
    for s, e, n, _ in spans:
        by_name.setdefault(n, []).append((s, e))
    calls = {n: len(v) for n, v in by_name.items()}
    merged = {n: tr._union(v) for n, v in by_name.items()}
    starts = {n: [s for s, _ in v] for n, v in merged.items()}
    dev_ns = dict.fromkeys(merged, 0)
    dev_ops = dict.fromkeys(merged, 0)
    for s, e, corr in device:
        t = by_corr.get(corr)
        if t is None:
            continue
        for n in merged:
            if tr._contains(merged[n], starts[n], t):
                dev_ns[n] += e - s
                dev_ops[n] += 1

    # idle gaps of the window, each put down to the innermost program
    # span open at its start: the spans nest on the main thread, so a
    # stack of the open ones is walked along the gaps in order
    busy = tr._union([(s, e) for s, e, _ in device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    nested = sorted(((s, e, n) for s, e, n, t in spans if t == main),
                    key=lambda o: (o[0], -o[1]))
    idle: Dict[str, int] = {}
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for g0, g1 in gaps:
        while j < len(nested) and nested[j][0] <= g0:
            while stack and stack[-1][1] < nested[j][0]:
                stack.pop()
            stack.append(nested[j])
            j += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        label = stack[-1][2] if stack else NONE
        idle[label] = idle.get(label, 0) + (g1 - g0)
    return {
        "prog_device_s": {n: v / 1e9 for n, v in dev_ns.items()},
        "prog_device_ops": dev_ops,
        "prog_calls": calls,
        "prog_idle_s": {n: v / 1e9 for n, v in
                        sorted(idle.items(), key=lambda kv: -kv[1])},
        "prog_window_device_ops": len(device),
    }


def _snapshot() -> Optional[Dict[str, int]]:
    try:
        from tensornetwork_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def _delta(before, after) -> Optional[Dict[str, int]]:
    if before is None or after is None:
        return None
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _report(out: dict) -> None:
    n = out["prog_calls"].get("sweep", 0)
    if not n:
        _err("program spans: none in the trace")
    else:
        def a_sweep(d, scale=1.0):
            return json.dumps({k: round(scale * v / n, 6)
                               for k, v in d.items()})
        idle = sum(out["prog_idle_s"].values())
        named = idle - out["prog_idle_s"].get(NONE, 0.0)
        ops = out["prog_window_device_ops"]
        in_sweep = out["prog_device_ops"].get("sweep", 0)
        _err(f"program spans: {n} sweeps; idle under a program span "
             f"{100 * named / idle if idle else 0.0:.3f}%, device "
             f"operations under the sweep span "
             f"{100 * in_sweep / ops if ops else 0.0:.3f}%")
        _err("program idle ms a sweep, by innermost span: "
             + a_sweep(out["prog_idle_s"], 1e3))
        _err("program device ms a sweep: "
             + a_sweep(out["prog_device_s"], 1e3))
        _err("program device operations a sweep: "
             + a_sweep(out["prog_device_ops"]))
        _err("program spans a sweep: " + a_sweep(out["prog_calls"]))
    if out["counters"] is not None and n:
        _err("program counters a sweep: "
             + json.dumps({k: v / n for k, v in out["counters"].items()}))


def install() -> None:
    """Wrap the next :func:`trace.reduce_events` (once, however many
    metrics ask) and take the counters' snapshot now."""
    if getattr(tr.reduce_events, "program_trace", False):
        return
    original = tr.reduce_events
    before = _snapshot()

    def reduce_events(events, top: int = 10) -> dict:
        tr.reduce_events = original
        events = list(events)
        # the benchmark's own keys as a port without spans gives them
        out = original([ev for ev in events
                        if not ev.name().startswith(PROGRAM)], top)
        out.update(reduce_program(events))
        out["counters"] = _delta(before, _snapshot())
        _report(out)
        return out

    reduce_events.program_trace = True
    tr.reduce_events = reduce_events
