"""Spans from the benchmark's own wrappers, and the reduction of a
``torch.profiler`` trace to device time: busy time, device time under
each span label, the operations that took most device time, and the idle
gaps by what the host was doing.

A span is a ``torch.profiler.record_function`` around a port function,
installed only while the profiled sweeps run.  A device operation belongs
to a span when the host op that launched it (its linked correlation id)
started inside one of the span's intervals.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from typing import Dict, Iterable, List, Tuple

PREFIX = "portbench:"
WINDOW = PREFIX + "window"


def resolve(target: str):
    """``"package.module:Name.attr"`` -> (owner object, attribute name)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parts, attr = path.split(".")
    for p in parts:
        owner = getattr(owner, p)
    getattr(owner, attr)   # AttributeError when it no longer exists
    return owner, attr


class Spans:
    """Installed wrappers, undone by :meth:`remove`."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object, bool]] = []

    def wrap(self, owner, attr: str, label: str) -> None:
        from torch.profiler import record_function
        had = attr in vars(owner)
        fn = getattr(owner, attr)
        name = PREFIX + label

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        self._undo.append((owner, attr, vars(owner).get(attr)
                           if had else None, had))
        setattr(owner, attr, wrapped)

    def remove(self) -> None:
        for owner, attr, orig, had in reversed(self._undo):
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()


@contextlib.contextmanager
def profiled(card: bool = True):
    """Profile host and card; yields a holder whose ``events`` are the
    raw kineto events once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    class Holder:
        events = ()

    holder = Holder()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
            if card:
                torch.cuda.synchronize()
    holder.events = list(prof.profiler.kineto_results.events())


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _contains(sorted_spans: List[Tuple[int, int]], starts: List[int],
              t: int) -> bool:
    """Whether t lies in one of the (start-sorted, disjoint) intervals."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and sorted_spans[i][1] >= t


def reduce_events(events: Iterable, top: int = 10) -> dict:
    """busy_s, window_s, span device seconds by label, the top device
    operations and the longest idle gaps (summed by the innermost host op
    running when each began)."""
    import torch
    cuda = torch._C._autograd.DeviceType.CUDA
    window = None
    spans: Dict[str, List[Tuple[int, int]]] = {}
    host_ops: List[Tuple[int, int, str, int]] = []
    by_corr: Dict[int, int] = {}
    device: List[Tuple[int, int, str, int]] = []
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == cuda:
            # the profiler mirrors each host annotation onto the card's
            # timeline; those are no operations
            if not (name.startswith(PREFIX) or _annotation(ev)):
                device.append((start, start + dur, name,
                               ev.linked_correlation_id()
                               or ev.correlation_id()))
            continue
        if name == WINDOW:
            window = (start, start + dur, ev.start_thread_id())
        elif name.startswith(PREFIX):
            spans.setdefault(name[len(PREFIX):], []).append(
                (start, start + dur))
        by_corr[ev.correlation_id()] = start
        host_ops.append((start, start + dur, name, ev.start_thread_id()))
    if window is None:
        raise RuntimeError("the profiled window left no trace")
    w0, w1, main = window
    device = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in device
              if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _, _ in device])
    busy_ns = sum(e - s for s, e in busy)

    labels = {k: _union(v) for k, v in spans.items()}
    starts = {k: [s for s, _ in v] for k, v in labels.items()}
    span_ns = {k: 0 for k in labels}
    unlinked = 0
    for s, e, _, corr in device:
        t = by_corr.get(corr)
        if t is None:
            unlinked += 1
            continue
        for k in labels:
            if _contains(labels[k], starts[k], t):
                span_ns[k] += e - s

    ops: Dict[str, float] = {}
    for s, e, n, _ in device:
        ops[n] = ops.get(n, 0) + (e - s)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]

    # idle gaps inside the window, each named by the spans and the
    # innermost host op (not a CUDA runtime call) running when it began
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # the main thread's ops nest: walk the gaps in order with a stack of
    # the ops open at each gap's start
    main_ops = sorted(((s, e, n) for s, e, n, t in host_ops if t == main),
                      key=lambda o: (o[0], -o[1]))
    idle: Dict[str, int] = {}
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for g0, g1 in gaps:
        while j < len(main_ops) and main_ops[j][0] <= g0:
            while stack and stack[-1][1] < main_ops[j][0]:
                stack.pop()
            stack.append(main_ops[j])
            j += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        open_ = [n for _, e, n in stack if e >= g0]
        span = [n[len(PREFIX):] for n in open_
                if n.startswith(PREFIX) and n != WINDOW]
        ops_ = [n for n in open_ if not n.startswith((PREFIX, "cuda"))]
        label = "/".join(span + [ops_[-1] if ops_ else "none"])
        idle[label] = idle.get(label, 0) + (g1 - g0)
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "span_device_s": {k: v / 1e9 for k, v in span_ns.items()},
        "span_calls": {k: len(v) for k, v in spans.items()},
        "device_events": len(device),
        "unlinked_device_events": unlinked,
        "device_ops": [[n[:80], v / 1e9] for n, v in top_ops],
        "idle_gaps": [[n[:80], v / 1e9] for n, v in top_idle],
    }
