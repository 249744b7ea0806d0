"""Host ms from a sweep call's start to its return, before any
synchronise: the median over the window's sweeps (outside the
profiler)."""
import statistics

UNIT = "ms"
LAYER = "sweep loop on the host"
MOVES = "sweep_rate"
SOURCE = "host_clock"


def read(run):
    return 1e3 * statistics.median(run.host_s) if run.host_s else None
