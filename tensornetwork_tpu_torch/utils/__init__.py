"""Serialization, topology and visualization of node graphs, loaded on
first use (PEP 562): the graph core they import is itself still importing
when the block-sparse engine imports :mod:`.tracing`."""
import importlib

_LAZY = {"save_nodes": "serialization", "load_nodes": "serialization",
         "from_topology": "topology", "to_graphviz": "visualization"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
