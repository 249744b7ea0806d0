"""The whole sweep's share of the card's TF32 peak: the frozen count of
the dense one-site sweep's operations (core/work.py) of the window's
sweeps, over the window's wall seconds, over 495 TFLOP/s."""
UNIT = "%"
LAYER = "sweep (parallel/batch.py, models/dmrg.py)"
MOVES = "sweep_rate"
SOURCE = "host_clock"


def read(run):
    peak = run.peak("tf32_flops")
    if run.flops_per_sweep is None or peak is None:
        return None
    return 100.0 * run.flops_per_sweep * run.sweeps / run.window_s / peak
