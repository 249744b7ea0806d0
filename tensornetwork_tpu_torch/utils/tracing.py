"""Spans and counters of the port's hot path.

A span names one layer of a sweep on the profiler's own timeline:
``with span("local_solve"):`` (or ``@spanned("local_solve")`` around a
whole function) opens
``torch.profiler.record_function("tnt.local_solve")`` while a profiler is
collecting -- ``torch.profiler.profile``, or
``torch.autograd.profiler.emit_nvtx`` under Nsight Systems -- and is one
shared null context otherwise, at the cost of one check of the profiler's
state.  The spans are host events of the same trace as the card's
kernels, so the device operations each one launched, and the card's idle
gaps while it was open, are read from the trace itself; spans nest on the
host thread, which gives each its parent.  The port keeps no clock of its
own.

The spans (:data:`SPANS`), outermost first:

  sweep           a whole one- or two-site sweep (dense or block-sparse)
  canon           the right-canonicalising prepass
  program_lookup  a block-sparse sweep's program lookup by structure
  local_solve     one site's (or bond's) ground-state solve
  lanczos         the Krylov factorization (fused kernel or plain loop)
  ritz            the small tridiagonal eigenproblem
  gauge_env       the gauge shift and environment growth of one site
                  (two-site: the truncation and environment growth)
  shift           a block-sparse sector polar shift
  bs_exec         one run of a block-sparse contraction executor

Counters: :data:`counts` (``add``) holds ``solve_tier.<tier>``, the local
solves by the tier they took (``plain`` for the unfused Lanczos),
``ritz.kernel`` / ``ritz.plain``, the power Ritz steps run by K10 or by
its CPU twin, and ``bs_true_flops`` / ``bs_padded_flops`` / ``bs_gemms``,
the block-sparse executors' useful and padded multiply-add flops (B x the
plan's, per run) and bucket GEMMs.  :func:`snapshot` returns them
together with the port's other counters, under their module's name;
:func:`reset` zeroes them all.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict

import torch
from torch.autograd.profiler import record_function

PREFIX = "tnt."
SPANS = ("sweep", "canon", "program_lookup", "local_solve", "lanczos",
         "ritz", "gauge_env", "shift", "bs_exec")
_BS_KEYS = ("bs_true_flops", "bs_padded_flops", "bs_gemms")
_NULL = contextlib.nullcontext()

# since the last reset(); solve_tier.<tier> keys appear as tiers are taken
counts: Dict[str, int] = dict.fromkeys(_BS_KEYS, 0)


def enabled() -> bool:
    """Whether a profiler is collecting on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A ``record_function("tnt." + name)`` while a profiler collects,
    else one shared null context."""
    if not enabled():
        return _NULL
    return record_function(PREFIX + name)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function inside ``span(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return decorate


def add(name: str, n: int = 1) -> None:
    counts[name] = counts.get(name, 0) + n


def _counters() -> Dict[str, dict]:
    """The port's counter dicts, by module and name."""
    from tensornetwork_tpu_torch.blocksparse import torch_engine
    from tensornetwork_tpu_torch.models import vumps
    from tensornetwork_tpu_torch.ops import kernels, krylov
    from tensornetwork_tpu_torch.parallel import collectives
    return {"kernels.launch_counts": kernels.launch_counts,
            "kernels.route_counts": kernels.route_counts,
            "krylov.counts": krylov.counts,
            "collectives.counts": collectives.counts,
            "vumps.counts": vumps.counts,
            "torch_engine.build_counts": torch_engine.build_counts}


def snapshot() -> Dict[str, int]:
    """One flat dict: :data:`counts`, every counter of
    :func:`_counters` as ``<module>.<dict>.<key>``, and
    ``_build.build_log``, the number of CUDA libraries built or found."""
    from tensornetwork_tpu_torch.ops import _build
    out = dict(counts)
    for prefix, d in _counters().items():
        out.update((f"{prefix}.{k}", v) for k, v in d.items())
    out["_build.build_log"] = len(_build.build_log)
    return out


def reset() -> None:
    """Zero every counter of :func:`snapshot` (the build log is a record
    of the libraries loaded, not a counter, and stays)."""
    from tensornetwork_tpu_torch.models import vumps
    from tensornetwork_tpu_torch.ops import kernels, krylov
    from tensornetwork_tpu_torch.parallel import collectives
    counts.clear()
    counts.update(dict.fromkeys(_BS_KEYS, 0))
    kernels.reset_launch_counts()
    krylov.reset_counts()
    collectives.reset_counts()
    vumps.reset_counts()
    build = _counters()["torch_engine.build_counts"]
    for k in build:
        build[k] = 0
