"""Idle ms a sweep of the card in the gaps that begin while the port's
``tnt.ritz`` span (ops/krylov.py tridiag_ritz, the small tridiagonal
eigenproblem of each local solve) is the innermost program span open:
the host running the Ritz step's small operations while the card waits
(core/program_trace.py)."""
from portbench.core import program_trace

UNIT = "ms"
LAYER = "local solve: Ritz step (ops/krylov.py tridiag_ritz)"
MOVES = "sweep_rate"
SOURCE = "device_trace"
SPAN = "ritz"


def spans(state):
    program_trace.install()
    return {}


def read(run):
    t = run.trace
    if (not t or not t.get("prog_calls", {}).get(SPAN)
            or not t["device_events"] or not run.trace_sweeps):
        return None
    return 1e3 * t["prog_idle_s"].get(SPAN, 0.0) / run.trace_sweeps
