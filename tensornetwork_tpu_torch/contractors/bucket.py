"""Copy-tensor bucket elimination (arXiv:1712.05384).

Capability parity with the reference bucket contractor
(reference ``contractors/bucket_contractor.py:21``): eliminate the COPY
tensors of a counting/#SAT-style network one bucket at a time, contracting
each COPY star in a single einsum instead of materializing the delta
tensor.
"""
from __future__ import annotations

from typing import List, Sequence

from tensornetwork_tpu_torch.core.network import (
    AbstractNode, CopyNode, contract_copy_node)


def bucket(nodes: Sequence[AbstractNode],
           copy_nodes: Sequence[CopyNode]) -> List[AbstractNode]:
    """Eliminate ``copy_nodes`` in order; returns the remaining nodes."""
    remaining = list(nodes)
    for cn in copy_nodes:
        partners = cn.get_partners()
        new_node = contract_copy_node(cn)
        remaining = [n for n in remaining
                     if n is not cn and n not in partners]
        remaining.append(new_node)
    return remaining
