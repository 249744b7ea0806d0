"""On the card: each driver through a whole run of its tiny cell, a cell of
a model added as new files, and the control, which has to come out not
correct.  Marked ``cuda``; each test
decides inside itself whether there is a card.  On the card:
``python -m pytest portbench/tests -m cuda -q``."""
import pytest

from portbench.core import harness, registry

from conftest import add_cell
from test_portbench_layout import FF2D, FF2D_CELL

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", ["tfi.tiny", "xxz.tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_on_the_card(tiny_root, card, cell, trace):
    root, path = tiny_root
    code, res = harness.execute(
        ["--workload", cell, "--seed", "2147483777", "--seconds", "1",
         "--trace", str(trace)], root=root, bench_path=path)
    assert code == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert res["device"]["busy_s"] > 0
        assert "device_idle_share" in res["metrics"]


def test_a_new_hamiltonian_cell_on_the_card(tiny_root, tmp_path, card):
    """The 2 x 3 free-fermion strip's cell, new files only: the port's MPO
    from the configuration's ``program_mpo``, K2 at M = 12, correct
    against the model's exact energy."""
    root, path = add_cell(tiny_root, tmp_path / "BENCHMARK.json",
                          "ff2d_2x3", FF2D, "ff2d.tiny", FF2D_CELL)
    code, res = harness.execute(
        ["--workload", "ff2d.tiny", "--seed", "2147483791", "--seconds", "1",
         "--trace", "0"], root=root, bench_path=path)
    assert code == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell,batch", [("tfi_n32.chi64_b4096", 256),
                                        ("xxz_u1_n32.chi1024_b32", 4)])
def test_control_is_not_correct(card, cell, batch):
    """The TF32 control of each cell at its own chi, at a batch a test run
    holds (the cell's own size is run by control.py); with TF32 off the
    same reference is correct."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_control", registry.ROOT + "/control.py")
    ctl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctl)
    wl = registry.workload(cell)
    wl["batch"] = batch
    cfg = registry.config(wl["config"])
    res = ctl.control(wl, cfg, 11, 5, "tf32", batch, card)
    assert res["correct"] is False
    res = ctl.control(wl, cfg, 11, 5, "fp32", batch, card)
    assert res["correct"] is True
