"""Every cell, configuration, driver, metric and model is a file found by
name; the harness names none of them; a new one needs only new files;
nothing imports JAX or the JAX package."""
import ast
import glob
import os
import re
import sys

import pytest
import torch

from portbench.core import harness, registry
from portbench.reference import models

from conftest import add_cell, run_cell
from test_portbench_output import _dense_fault

FORBIDDEN = {"jax", "jaxlib", "flax", "tensornetwork_tpu"}


def _bench():
    return registry.benchmark()


def test_every_name_has_its_file():
    bench = _bench()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(registry.CHECKOUT, c["file"]))
        assert registry.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert registry.driver(wl["driver"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        assert mod.MOVES == m["moves"] if "moves" in m else True


def _stem(path):
    return os.path.splitext(os.path.basename(path))[0]


def test_harness_names_no_cell_config_or_metric():
    """No file of the harness, the drivers or the reference quotes a cell,
    configuration, traffic, metric, driver or model, or names the port's
    MPO builder that a configuration gives; a model's own Hamiltonian file
    alone knows its model."""
    bench = _bench()
    cfgs = [registry.config(c["name"]) for c in bench["configs"]]
    hams = glob.glob(os.path.join(registry.ROOT, "reference", "hamiltonians",
                                  "[!_]*.py"))
    model_names = {c["model"] for c in cfgs} | {_stem(p) for p in hams}
    assert {"tfi", "xxz", "ff2d"} <= model_names
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [_stem(p) for p in glob.glob(
                 os.path.join(registry.ROOT, "drivers", "*.py"))]
             + sorted(model_names))
    builders = {c["program_mpo"]["builder"] for c in cfgs
                if "program_mpo" in c}
    assert builders
    files = [os.path.join(registry.ROOT, f) for f in ("run.py", "control.py")]
    for kind in ("core", "drivers", "reference",
                 os.path.join("reference", "hamiltonians")):
        files += glob.glob(os.path.join(registry.ROOT, kind, "*.py"))
    for path in files:
        src = open(path).read()
        own = _stem(path) if os.sep + "hamiltonians" + os.sep in path \
            else None
        for n in names:
            if n != own:
                assert f'"{n}"' not in src and f"'{n}'" not in src, (path, n)
        for b in builders:
            assert not re.search(rf"\b{b}\b", src), (path, b)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(registry.ROOT, "**", "*.py"),
                      recursive=True)
    assert files
    for path in files:
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(registry.ROOT, "reference", "**", "*.py"),
                      recursive=True)
    assert any(os.sep + "hamiltonians" + os.sep in p for p in files)
    for path in files:
        tops = set(_imports(path))
        assert "tensornetwork_tpu_torch" not in tops, path
        assert not FORBIDDEN & tops, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensornetwork_tpu_torch_fake",
                        object())
    assert "tensornetwork_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tensornetwork_tpu.fake", object())
    assert harness.forbidden_modules() == ["tensornetwork_tpu.fake"]


def test_a_new_cell_config_and_metric_are_new_files(tiny_root, tmp_path):
    """A throwaway configuration, cell and per-layer metric, each a new
    file in a temporary copy, run without an edit to any file there."""
    root, path = tiny_root
    cfg = registry.config(registry.workload("tfi.tiny", root)["config"],
                          root)
    del cfg["name"], cfg["root"]
    cfg.update(N=6, Bz=0.7)
    wl = registry.workload("tfi.tiny", root)
    wl.pop("name")
    wl.update(chi=8, batch=2)
    with open(os.path.join(root, "metrics", "sweeps_counted.py"), "w") as f:
        f.write('UNIT = "sweeps"\nLAYER = "entry"\nMOVES = "sweep_rate"\n'
                'SOURCE = "host_clock"\n\n\ndef read(run):\n'
                '    return run.sweeps\n')
    metric = {"name": "sweeps_counted", "unit": "sweeps", "better": "higher",
              "source": "host_clock", "layer": "entry", "moves": "sweep_rate",
              "workloads": ["tfi.new"]}
    new = add_cell(tiny_root, tmp_path / "BENCHMARK.json", "tfi_n6_new", cfg,
                   "tfi.new", wl, [metric])
    code, res = run_cell(new, "tfi.new", trace=1)
    assert code == 0 and res["correct"]
    assert res["metrics"]["sweeps_counted"]["value"] >= 1


def test_the_ports_mpo_and_the_state_agree_in_length(tiny_root):
    """``batched_dense`` calls the port's builder with the configuration's
    own values (a tiny copy's N too), and refuses an MPO whose length is
    not the state's N."""
    root, _ = tiny_root
    cfg = registry.config(registry.workload("tfi.tiny", root)["config"],
                          root)
    drv = registry.driver("batched_dense", root)
    mpo = drv._mpo(cfg, torch.float32, "cpu")
    assert mpo.Ws.shape[0] == cfg["N"] == 8
    cfg.update(Bz=[1.0] * 6)          # per-site fields: 6 sites, N says 8
    cfg["program_mpo"] = dict(cfg["program_mpo"], args=["Jx", "Bz"])
    with pytest.raises(ValueError, match="sites for a state of N = 8"):
        drv._mpo(cfg, torch.float32, "cpu")


def test_a_hamiltonian_is_found_by_its_model_under_the_root(tmp_path):
    """A model added as a file under a temporary root gives the reference's
    MPO and exact energy; a model with no file raises, naming the path
    where its file was looked for."""
    ham = tmp_path / "reference" / "hamiltonians"
    ham.mkdir(parents=True)
    (ham / "zfield.py").write_text(
        "import numpy as np\n\n\ndef mpo(cfg, params, instance):\n"
        "    W = np.zeros((2, 2, 2, 2))\n"
        "    W[0, 0] = W[1, 1] = np.eye(2)\n"
        "    W[1, 0] = cfg['Bz'] * np.diag([1.0, -1.0])\n"
        "    return np.repeat(W[None], cfg['N'], 0), np.eye(2)[1], "
        "np.eye(2)[0]\n\n\ndef exact_energy(cfg):\n"
        "    return -cfg['N'] * abs(cfg['Bz'])\n")
    cfg = {"model": "zfield", "N": 4, "Bz": 0.5, "root": str(tmp_path)}
    assert models.exact_energy(cfg) == -2.0
    assert models.ground_energy(*models.mpo(cfg)) == pytest.approx(-2.0,
                                                                   abs=1e-12)
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(ham / "absent.py"))):
        models.mpo(dict(cfg, model="absent"))


FF2D = {"source": "https://github.com/google/TensorNetwork/blob/v0.4.6/"
                  "tensornetwork/matrixproductstates/mpo.py",
        "model": "ff2d", "N1": 2, "N2": 3, "N": 6, "t1": 1.0, "t2": 0.7,
        "mu": 0.2, "d": 2, "mpo_bond": 12, "dtype": "float32",
        "program_mpo": {"builder": "FiniteFreeFermion2D",
                        "args": ["t1", "t2", "mu", "N1", "N2"]},
        "reduced": []}
FF2D_CELL = {"driver": "batched_dense", "chi": 8, "batch": 2, "krylov": 10,
             "chips": 1, "trace_sweeps": 1,
             "limits": {"ritz_gap": 5e-3, "excess": 2e-3}}


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_a_new_hamiltonian_cell_is_new_files(tiny_root, tmp_path,
                                             monkeypatch, fault):
    """A 2 x 3 free-fermion strip (chi=8, B=2) through the whole harness on
    the CPU from a new configuration, a new cell and a BENCHMARK.json that
    lists them: correct against the model's exact energy, and not correct
    with a fault planted in the timed sweep."""
    new = add_cell(tiny_root, tmp_path / "BENCHMARK.json", "ff2d_2x3", FF2D,
                   "ff2d.tiny", FF2D_CELL)
    if fault is not None:
        limit = FF2D_CELL["limits"]["ritz_gap"]
        monkeypatch.setattr(*_dense_fault(fault, limit))
    code, res = run_cell(new, "ff2d.tiny")
    assert code == 0 and res["attempted"] == 2
    if fault is None:
        assert res["correct"] is True and res["failed"] == 0
        for c in res["checks"].values():
            assert 0 <= c["value"] <= c["limit"]
    else:
        assert res["correct"] is False and res["failed"] >= 1
        caught = res["checks"]["excess"]
        assert caught["value"] > caught["limit"]


def test_the_command_refuses_without_a_card(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, path = tiny_root
    code, res = harness.execute(
        ["--workload", "tfi.tiny", "--seed", "1", "--seconds", "1",
         "--trace", "0"], root=root, bench_path=path)
    assert code != 0 and res is None
