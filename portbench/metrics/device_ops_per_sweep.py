"""Device operations a sweep: the card's kernels and copies launched
inside the port's ``tnt.sweep`` span, each eager dispatch the host makes
(core/program_trace.py)."""
from portbench.core import program_trace

UNIT = "ops"
LAYER = "sweep loop on the host"
MOVES = "sweep_rate"
SOURCE = "device_trace"
SPAN = "sweep"


def spans(state):
    program_trace.install()
    return {}


def read(run):
    t = run.trace
    if (not t or not t.get("prog_device_ops", {}).get(SPAN)
            or not run.trace_sweeps):
        return None
    return t["prog_device_ops"][SPAN] / run.trace_sweeps
