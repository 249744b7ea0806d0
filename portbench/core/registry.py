"""Everything that belongs to one cell, configuration, driver or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

    workloads/<cell>.json      the cell: its configuration, driver, sizes,
                               limits of the output check
    configs/<config>.json      the configuration as it is run
    drivers/<driver>.py        one per entry kind of the port
    metrics/<metric>.py        one per metric: what it wraps, its reader
    reference/hamiltonians/<model>.py
                               one per model: the reference's MPO and
                               exact energy of a configuration's ``model``

A later cell, configuration, metric or model is a new file; no file here
names one.  ``root`` is the benchmark's folder (a test passes a temporary one).
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(ROOT)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: str = ROOT) -> dict:
    wl = _json(os.path.join(root, "workloads", name + ".json"))
    wl["name"] = name
    return wl


def config(name: str, root: str = ROOT) -> dict:
    """The configuration's file, with its ``name`` and the ``root`` it was
    found under (where its model's Hamiltonian file is looked up)."""
    cfg = _json(os.path.join(root, "configs", name + ".json"))
    cfg["name"] = name
    cfg["root"] = root
    return cfg


def _module(kind: str, name: str, root: str) -> ModuleType:
    """The module ``<root>/<kind>/<name>.py``, loaded from its path (so
    that a temporary folder's files load as the benchmark's do)."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{name!r}: no file {path}")
    key = (f"portbench_{kind.replace('/', '_')}_{abs(hash(path))}_"
           f"{name.replace('.', '_')}")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: str = ROOT) -> ModuleType:
    return _module("drivers", name, root)


def metric(name: str, root: str = ROOT) -> ModuleType:
    return _module("metrics", name, root)


def hamiltonian(model: str, root: str = ROOT) -> ModuleType:
    return _module("reference/hamiltonians", model, root)


def benchmark(path: Optional[str] = None) -> dict:
    return _json(path or os.path.join(CHECKOUT, "BENCHMARK.json"))


def metrics_of(bench: dict, cell: str, section: str) -> List[str]:
    """Names of the ``section`` ("end_to_end" or "per_layer") metrics that
    ``cell`` reports: those that list it, or list no cells."""
    return [m["name"] for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
