"""Device ms a sweep under the local solves
(models/dmrg.py _local_solve_1s -> ops/kernels.py tiers -> ops/krylov.py
Ritz)."""
UNIT = "ms"
LAYER = "local solve"
MOVES = "sweep_rate"
SOURCE = "device_trace"
LABEL = "local_solve"


def spans(state):
    from portbench.core.trace import resolve
    return {LABEL: [resolve("tensornetwork_tpu_torch.models.dmrg:"
                            "_local_solve_1s")]}


def read(run):
    t = run.trace
    if not t or LABEL not in t["span_device_s"] or not run.trace_sweeps:
        return None
    s = t["span_device_s"][LABEL]
    return 1e3 * s / run.trace_sweeps if s > 0 else None
