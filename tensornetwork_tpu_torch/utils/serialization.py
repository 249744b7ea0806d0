"""Whole-network HDF5 snapshots.

Counterpart of :mod:`tensornetwork_tpu.utils.serialization` (reference
``utils.py:28-125``, per-node/edge groups ``network_components.py:469,
1177``, type registry ``component_factory.py:10``), in the JAX package's
HDF5 layout, so that a file written by either package loads in the other.
``h5py`` is imported when a function runs, so that importing the port
does not need it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tensornetwork_tpu_torch.config import Device, as_tensor
from tensornetwork_tpu_torch.core.network import (
    AbstractNode, CopyNode, Edge, Node)


def _numpy(t) -> np.ndarray:
    return t.detach().resolve_conj().cpu().numpy()


def save_nodes(nodes: Sequence[AbstractNode], path) -> None:
    """Save a (sub)network to HDF5 (reference ``utils.py:28``).  An edge
    to a node outside ``nodes`` is saved dangling on the inside node."""
    import h5py
    string_type = h5py.string_dtype(encoding="utf-8")
    nodes = list(nodes)
    index = {n: i for i, n in enumerate(nodes)}
    if len(index) < len(nodes):
        raise ValueError("duplicate nodes in input")
    with h5py.File(path, "w") as f:
        nodes_group = f.create_group("nodes")
        edges_group = f.create_group("edges")
        seen_edges = set()
        for i, node in enumerate(nodes):
            g = nodes_group.create_group(str(i))
            g.attrs["type"] = type(node).__name__
            g.attrs["name"] = node.name
            g.create_dataset("tensor", data=_numpy(node.tensor))
            g.create_dataset(
                "axis_names",
                data=np.array(node.axis_names, dtype=object),
                dtype=string_type)
            if isinstance(node, CopyNode):
                g.attrs["rank"] = node.rank
                g.attrs["dimension"] = node.dimension
        k = 0
        for node in nodes:
            for e in node.edges:
                if id(e) in seen_edges:
                    continue
                seen_edges.add(id(e))
                eg = edges_group.create_group(str(k))
                k += 1
                eg.attrs["name"] = e.name
                if e.node1 in index:
                    eg.attrs["node1"] = index[e.node1]
                    eg.attrs["axis1"] = e.axis1
                    if e.node2 is not None and e.node2 in index:
                        eg.attrs["node2"] = index[e.node2]
                        eg.attrs["axis2"] = e.axis2
                else:
                    # cross-boundary edge: store as dangling on the inside
                    # endpoint
                    eg.attrs["node1"] = index[e.node2]
                    eg.attrs["axis1"] = e.axis2


def load_nodes(path, device: Optional[Device] = None) -> List[AbstractNode]:
    """Load a network saved by :func:`save_nodes` (reference
    ``utils.py:90``), its tensors on ``device`` (default: the card)."""
    import h5py
    nodes = []
    with h5py.File(path, "r") as f:
        node_ids = sorted(f["nodes"].keys(), key=int)
        for nid in node_ids:
            g = f["nodes"][nid]
            tensor = as_tensor(np.asarray(g["tensor"]), device)
            axis_names = [s.decode() if isinstance(s, bytes) else s
                          for s in g["axis_names"][()]]
            if g.attrs["type"] == "CopyNode":
                node = CopyNode(rank=int(g.attrs["rank"]),
                                dimension=int(g.attrs["dimension"]),
                                name=g.attrs["name"], dtype=tensor.dtype,
                                device=tensor.device)
                node.tensor = tensor
            else:
                node = Node(tensor, name=g.attrs["name"],
                            axis_names=axis_names or None)
            nodes.append(node)
        for eid in sorted(f["edges"].keys(), key=int):
            eg = f["edges"][eid]
            n1 = nodes[int(eg.attrs["node1"])]
            a1 = int(eg.attrs["axis1"])
            if "node2" in eg.attrs:
                n2 = nodes[int(eg.attrs["node2"])]
                a2 = int(eg.attrs["axis2"])
                e = Edge(node1=n1, axis1=a1, node2=n2, axis2=a2,
                         name=eg.attrs["name"])
                n1.edges[a1] = e
                n2.edges[a2] = e
            else:
                n1.edges[a1].set_name(eg.attrs["name"])
    return nodes
