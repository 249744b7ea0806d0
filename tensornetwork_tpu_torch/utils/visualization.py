"""Graphviz rendering of node networks
(reference ``visualization/graphviz.py:22-69``).  Counterpart of
:mod:`tensornetwork_tpu.utils.visualization`; ``graphviz`` is imported
when the function runs, so that importing the port does not need it."""
from __future__ import annotations

from typing import Sequence, Set

from tensornetwork_tpu_torch.core.network import AbstractNode


def to_graphviz(nodes: Sequence[AbstractNode], graph=None,
                include_all_names: bool = False, engine: str = "neato"):
    """Render a network as a ``graphviz.Graph``; dangling edges appear as
    invisible endpoint nodes (reference ``visualization/graphviz.py:60-67``).
    """
    import graphviz
    if graph is None:
        graph = graphviz.Graph("tensornetwork", engine=engine)
    seen: Set[int] = set()
    ids = {id(n): f"n{i}" for i, n in enumerate(nodes)}
    for n in nodes:
        label = n.name if not n.name.startswith("__") or include_all_names \
            else ""
        graph.node(ids[id(n)], label=label)
    invis = 0
    for n in nodes:
        for e in n.edges:
            if id(e) in seen:
                continue
            seen.add(id(e))
            label = e.name if not e.name.startswith("__") or \
                include_all_names else ""
            if e.is_dangling():
                ghost = f"invis{invis}"
                invis += 1
                graph.node(ghost, label="", style="invis")
                graph.edge(ids[id(e.node1)], ghost, label=label)
            elif id(e.node2) in ids:
                graph.edge(ids[id(e.node1)], ids[id(e.node2)], label=label)
    return graph
