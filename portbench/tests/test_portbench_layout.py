"""Every cell, configuration, driver and metric is a file found by name;
the harness names none of them; a new one needs only new files; nothing
imports JAX or the JAX package."""
import ast
import glob
import json
import os
import sys

import pytest

from portbench.core import harness, registry

from conftest import run_cell

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


def test_harness_names_no_cell_config_or_metric():
    bench = _bench()
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + ["batched_dense", "batched_blocksparse"])
    for path in [os.path.join(registry.ROOT, "run.py")] + glob.glob(
            os.path.join(registry.ROOT, "core", "*.py")):
        src = open(path).read()
        for n in names:
            assert f'"{n}"' not in src and f"'{n}'" not in src, (path, n)


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
    for path in glob.glob(os.path.join(registry.ROOT, "reference", "*.py")):
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
    cfg.pop("name")
    cfg.update(N=6, Bz=0.7)
    with open(os.path.join(root, "configs", "tfi_n6_new.json"), "w") as f:
        json.dump(cfg, f)
    wl = registry.workload("tfi.tiny", root)
    wl.pop("name")
    wl.update(config="tfi_n6_new", chi=8, batch=2)
    with open(os.path.join(root, "workloads", "tfi.new.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "metrics", "sweeps_counted.py"), "w") as f:
        f.write('UNIT = "sweeps"\nLAYER = "entry"\nMOVES = "sweep_rate"\n'
                'SOURCE = "host_clock"\n\n\ndef read(run):\n'
                '    return run.sweeps\n')
    bench = registry.benchmark(path)
    bench["per_layer"].append({"name": "sweeps_counted", "unit": "sweeps",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "sweep_rate",
                               "workloads": ["tfi.new"]})
    new_path = str(tmp_path / "BENCHMARK.json")
    with open(new_path, "w") as f:
        json.dump(bench, f)
    code, res = run_cell((root, new_path), "tfi.new", trace=1)
    assert code == 0 and res["correct"]
    assert res["metrics"]["sweeps_counted"]["value"] >= 1


def test_the_command_refuses_without_a_card(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, path = tiny_root
    code, res = harness.execute(
        ["--workload", "tfi.tiny", "--seed", "1", "--seconds", "1",
         "--trace", "0"], root=root, bench_path=path)
    assert code != 0 and res is None
