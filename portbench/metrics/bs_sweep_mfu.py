"""The block-sparse sweep's share of the card's TF32 peak: the sectors'
true GEMM flops of a traced sweep (the port's ``bs_true_flops`` counter)
times the window's sweeps, over the window's wall seconds, over 495
TFLOP/s, as ``sweep_mfu`` does for the dense sweep.  The sector polars
and the Lanczos vector work are left out of the count."""
from portbench.core import program_trace

UNIT = "%"
LAYER = "sweep (models/symmetric_dmrg_batched.py)"
MOVES = "sweep_rate"
SOURCE = "host_clock"


def spans(state):
    program_trace.install()
    return {}


def read(run):
    c = (run.trace or {}).get("counters")
    peak = run.peak("tf32_flops")
    if not c or not c.get("bs_true_flops") or peak is None \
            or not run.trace_sweeps:
        return None
    per_sweep = c["bs_true_flops"] / run.trace_sweeps
    return 100.0 * per_sweep * run.sweeps / run.window_s / peak
