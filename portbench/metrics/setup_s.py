"""Seconds from the start of the process to the first timed sweep:
imports, the CUDA build (first run in a checkout), inputs, plan build,
the right-canonicalising prepass and the warm sweep.  The build's own
seconds are also given apart, under ``build_s`` in the result line."""
UNIT = "s"
LAYER = "entry"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
