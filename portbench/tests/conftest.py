"""Tiny copies of the benchmark's cells for the CPU: the whole folder
copied to a temporary root, with small configurations and cells beside
the real ones, and a BENCHMARK.json that lists them."""
import json
import os
import shutil

import pytest

from portbench.core import registry

TINY = {  # cell -> (real cell, N, chi, batch)
    "tfi.tiny": ("tfi_n32.chi64_b4096", 8, 16, 4),
    "xxz.tiny": ("xxz_u1_n32.chi1024_b32", 8, 16, 3),
}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """(root, BENCHMARK.json path) of a copy of the benchmark with the
    tiny cells added as new files."""
    base = tmp_path_factory.mktemp("portbench")
    root = os.path.join(base, "portbench")
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = registry.benchmark()
    for cell, (real, N, chi, B) in TINY.items():
        wl = registry.workload(real)
        cfg = registry.config(wl["config"])
        cfg.update(N=N)
        del cfg["root"]
        cfg_name = cfg.pop("name") + "_tiny"
        with open(os.path.join(root, "configs", cfg_name + ".json"), "w") as f:
            json.dump(cfg, f)
        wl.pop("name")
        wl.update(config=cfg_name, chi=chi, batch=B)
        with open(os.path.join(root, "workloads", cell + ".json"), "w") as f:
            json.dump(wl, f)
        for m in bench["per_layer"] + bench["end_to_end"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    path = os.path.join(base, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root, path


def add_cell(tiny_root, new_path, cfg_name, cfg, cell, wl, metrics=()):
    """Write a configuration, a cell and the per-layer ``metrics`` entries
    as new files under the tiny root, with a BENCHMARK.json at
    ``new_path`` that lists them beside what the tiny root's lists:
    (root, new BENCHMARK.json path)."""
    root, path = tiny_root
    with open(os.path.join(root, "configs", cfg_name + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "workloads", cell + ".json"), "w") as f:
        json.dump(dict(wl, config=cfg_name), f)
    bench = registry.benchmark(path)
    bench["per_layer"].extend(metrics)
    with open(new_path, "w") as f:
        json.dump(bench, f)
    return root, str(new_path)


def run_cell(tiny_root, cell, seed=3000000019, seconds=1.0, trace=0):
    """One CPU run of a tiny cell: (exit code, result)."""
    from portbench.core import harness
    root, path = tiny_root
    return harness.execute(
        ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], root=root, bench_path=path, device="cpu",
        require_card=False)
