"""Device ms a sweep under the gauge shifts and environment growth
(models/dmrg.py _gauge_env_left/_gauge_env_right -> ops/decompositions.py
or the fused epilogue kernel)."""
UNIT = "ms"
LAYER = "gauge + environments"
MOVES = "sweep_rate"
SOURCE = "device_trace"
LABEL = "gauge_env"


def spans(state):
    from portbench.core.trace import resolve
    mod = "tensornetwork_tpu_torch.models.dmrg:"
    return {LABEL: [resolve(mod + "_gauge_env_left"),
                    resolve(mod + "_gauge_env_right")]}


def read(run):
    t = run.trace
    if not t or not t["span_device_s"].get(LABEL) or not run.trace_sweeps:
        return None
    return 1e3 * t["span_device_s"][LABEL] / run.trace_sweeps
