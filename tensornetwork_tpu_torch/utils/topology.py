"""Build connected networks from einsum-like topology strings
(reference ``utils.py:127-157``).  Counterpart of
:mod:`tensornetwork_tpu.utils.topology`."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from tensornetwork_tpu_torch.core.network import Node, connect


def from_topology(topology: str, tensors: Sequence[Any],
                  backend=None) -> List[Node]:
    """``from_topology("ab,bc,cd", [A, B, C])`` connects repeated letters;
    uppercase letters stay dangling (reference ``utils.py:127``).
    ``backend`` is accepted for the reference's signature and read by
    nothing: the port's one backend is PyTorch."""
    edge_dict: Dict[str, Any] = {}
    nodes = []
    split = topology.split(",")
    if len(split) != len(tensors):
        raise ValueError("number of tensor strings does not match number "
                         "of tensors")
    for local, t in zip(split, tensors):
        local = local.strip()
        node = Node(t, axis_names=list(local))
        nodes.append(node)
        for i, c in enumerate(local):
            if c.islower():
                if c in edge_dict:
                    edge_dict[c] = connect(edge_dict[c], node[i], name=c)
                else:
                    edge_dict[c] = node[i]
            else:
                node[i].set_name(c)
    return nodes
