"""The local solves' share of their roofline: the least time of their
work (core/work.py solve_work: m matvecs and the Lanczos vector updates;
L, W, R and x read once, the ground vector written once), the larger of
operations over 495 TFLOP/s and bytes over 3.35 TB/s, over the device
time under the local-solve spans.  The bound that decides is named on
standard error."""
import sys

from portbench.core import work

UNIT = "%"
LAYER = "kernels"
MOVES = "sweep_rate"
SOURCE = "device_trace"
LABEL = "local_solve"


def spans(state):
    from portbench.core.trace import resolve
    return {LABEL: [resolve("tensornetwork_tpu_torch.models.dmrg:"
                            "_local_solve_1s")]}


def read(run):
    t = run.trace
    if (not t or run.solve_work is None or not run.trace_sweeps
            or not t["span_device_s"].get(LABEL)):
        return None
    flops, nbytes = run.solve_work
    pf, pb = run.peak("tf32_flops"), run.peak("hbm_bytes")
    if pf is None or pb is None:
        return None
    least, by = work.least_seconds(flops, nbytes, pf, pb)
    print(f"solve_roofline: bound by {by}, {least * 1e3:.6f} ms a sweep",
          file=sys.stderr)
    return 100.0 * least * run.trace_sweeps / t["span_device_s"][LABEL]
