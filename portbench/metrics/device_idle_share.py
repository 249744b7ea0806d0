"""1 - the union of device-busy intervals over the traced window, both
from the same profiled sweeps."""
UNIT = "%"
LAYER = "device"
MOVES = "sweep_rate"
SOURCE = "device_trace"


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
