"""The reduction of the port's own spans and counters
(core/program_trace.py): on a hand-built trace, each idle gap goes to the
innermost program span open at its start, the card's mirrors of the
spans are no operations, and the benchmark's own keys read as without
the spans; on the tiny cells, the new metrics appear where their entries
list the cell, and a port without spans or counters leaves them out."""
import pytest
import torch

from portbench.core import program_trace, registry
from portbench.core import trace as tr

from conftest import run_cell

CPU = torch._C._autograd.DeviceType.CPU
CUDA = torch._C._autograd.DeviceType.CUDA
NEW = ("ritz_idle_ms", "device_ops_per_sweep", "bs_gemm_useful_share",
       "bs_sweep_mfu")


class Ev:
    """A kineto event: what the reductions read of one."""

    def __init__(self, name, start, end, device=CPU, corr=0, linked=0,
                 annotation=False):
        self._v = (name, start, end - start, device, corr, linked,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self._v[6]


def _launch(corr, at, k0, k1):
    """A host launch at ``at`` and its kernel on the card."""
    return [Ev("cudaLaunchKernel", at, at + 2, corr=corr),
            Ev(f"kernel{corr}", k0, k1, CUDA, corr=corr, linked=corr)]


def _events():
    """Window 0..1000; tnt.sweep 100..900 > local_solve 150..500 > ritz
    300..480; kernels busy 160..250 (launched in local_solve), 290..310
    (in ritz) and 600..700 (in sweep); the benchmark's own span around the
    first launch; the card's mirror of tnt.sweep, unflagged."""
    base = [Ev(tr.WINDOW, 0, 1000), Ev(tr.PREFIX + "local_solve", 152, 158)]
    base += _launch(1, 155, 160, 250)
    base += _launch(2, 302, 290, 310)
    base += _launch(3, 550, 600, 700)
    program = [Ev("tnt.sweep", 100, 900), Ev("tnt.local_solve", 150, 500),
               Ev("tnt.ritz", 300, 480), Ev("tnt.sweep", 100, 900, CUDA)]
    return base, program


def test_gaps_go_to_the_innermost_program_span():
    base, program = _events()
    out = program_trace.reduce_program(base + program)
    idle = {k: round(v * 1e9) for k, v in out["prog_idle_s"].items()}
    # gaps 0..160 (no span), 250..290 (local_solve), 310..600 (ritz open
    # at 310), 700..1000 (sweep open at 700)
    assert idle == {"(none)": 160, "local_solve": 40, "ritz": 290,
                    "sweep": 300}
    assert out["prog_device_ops"] == {"sweep": 3, "local_solve": 2,
                                      "ritz": 1}
    assert round(out["prog_device_s"]["local_solve"] * 1e9) == 110
    assert out["prog_calls"] == {"sweep": 1, "local_solve": 1, "ritz": 1}
    assert out["prog_window_device_ops"] == 3


def test_the_benchmark_keys_read_as_without_program_spans(monkeypatch):
    base, program = _events()
    original = tr.reduce_events
    monkeypatch.setattr(tr, "reduce_events", original)
    want = original(list(base))
    program_trace.install()
    program_trace.install()       # a second metric asking: one wrapper
    got = tr.reduce_events(base + program)
    assert tr.reduce_events is original     # for that one reduction
    for k, v in want.items():
        assert got[k] == v, k
    assert got["device_events"] == 3 and got["unlinked_device_events"] == 0
    assert set(got) - set(want) == {"prog_device_s", "prog_device_ops",
                                    "prog_calls", "prog_idle_s",
                                    "prog_window_device_ops", "counters"}


def _listed(cell, root):
    bench = registry.benchmark(root[1])
    return {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ())}


@pytest.mark.parametrize("cell", ["tfi.tiny", "xxz.tiny"])
def test_new_metrics_only_in_the_cells_that_list_them(tiny_root, cell):
    code, res = run_cell(tiny_root, cell, trace=1)
    assert code == 0 and res["correct"]
    new = set(NEW) & set(res["metrics"])
    assert new <= _listed(cell, tiny_root)
    # on the CPU no device operation is traced and no peak is known: the
    # counter-read share alone appears, where it is listed
    if cell == "xxz.tiny":
        assert new == {"bs_gemm_useful_share"}
        assert 0 < res["metrics"]["bs_gemm_useful_share"]["value"] <= 100
    else:
        assert new == set()


def test_a_port_without_spans_or_counters_reads_nothing(tiny_root,
                                                        monkeypatch):
    from tensornetwork_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "span", lambda name: tracing._NULL)
    monkeypatch.setattr(program_trace, "_snapshot", lambda: None)
    code, res = run_cell(tiny_root, "xxz.tiny", trace=1)
    assert code == 0 and res["correct"]
    assert not set(NEW) & set(res["metrics"])
    assert "host_enqueue_ms" in res["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tfi.tiny", "xxz.tiny"])
def test_new_metrics_on_the_card(tiny_root, cell):
    """On the card every new metric its entry lists is read, and the
    program spans hold the window's device operations and idle time."""
    from portbench.core import harness
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    root, path = tiny_root
    code, res = harness.execute(
        ["--workload", cell, "--seed", "2147483777", "--seconds", "1",
         "--trace", "1"], root=root, bench_path=path)
    assert code == 0 and res["correct"] is True
    assert set(NEW) & set(res["metrics"]) == set(NEW) & _listed(cell,
                                                                tiny_root)
