"""The block-sparse executors' useful share of their GEMM work over the
traced sweeps: the sectors' true multiply-add flops over those of the
padded bucket GEMMs that run them (the port's counters ``bs_true_flops``
and ``bs_padded_flops``, B x each plan's ``plan_flops`` a run; the bucket
rounding is blocksparse/torch_engine.py ``_round_dim``)."""
from portbench.core import program_trace

UNIT = "%"
LAYER = "block-sparse executor"
MOVES = "sweep_rate"
SOURCE = "program_counter"


def spans(state):
    program_trace.install()
    return {}


def read(run):
    c = (run.trace or {}).get("counters")
    if not c or not c.get("bs_padded_flops"):
        return None
    return 100.0 * c.get("bs_true_flops", 0) / c["bs_padded_flops"]
