"""Device ms a sweep under the block-sparse executors: each one-site
program's bucketed contraction chains (matvec, environment growth,
bond-factor absorption; blocksparse/torch_engine.py) and the sector
polar shifts (blocksparse/batched.py ShiftPlan)."""
UNIT = "ms"
LABEL = "bs_exec"
LAYER = "block-sparse executor"
MOVES = "sweep_rate"
SOURCE = "device_trace"


def spans(state):
    from portbench.core.trace import resolve
    pairs = [resolve("tensornetwork_tpu_torch.blocksparse.batched:"
                     "ShiftPlan.__call__")]
    for prog in state.solver._programs.values():
        if type(prog).__name__ != "_SiteProgram":
            continue     # the prepass's programs run in set-up only
        for attr in ("mv", "grow", "absorb"):
            getattr(prog, attr)
            pairs.append((prog, attr))
    return {LABEL: pairs}


def read(run):
    t = run.trace
    if not t or not t["span_device_s"].get(LABEL) or not run.trace_sweeps:
        return None
    return 1e3 * t["span_device_s"][LABEL] / run.trace_sweeps
