"""Instance-sweeps a second: B x the sweeps completed in the window over
the window's wall seconds, all the work over all the time."""
UNIT = "inst-sweeps/s"
LAYER = "entry"
MOVES = "sweep_rate"
SOURCE = "host_clock"


def read(run):
    return run.batch * run.sweeps / run.window_s
