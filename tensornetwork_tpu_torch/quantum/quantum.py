"""Lazy quantum vectors and operators on Node networks.

Counterpart of :mod:`tensornetwork_tpu.quantum.quantum` (reference
``quantum/quantum.py:64-657``: ``QuOperator/QuVector/QuAdjointVector/
QuScalar``, CopyNode-backed lazy identities, ``eliminate_identities``).
An operator is a set of nodes plus ordered ``out_edges``/``in_edges``;
composition copies both networks host-side and connects them, and
evaluation contracts with the port's greedy contractor, one eager
``torch.tensordot`` a pair.  Tensors stay on their device: a lazy identity
goes to :func:`config.default_device` unless given ``device``, and a
scalar factor joins its operand's device.
"""
from __future__ import annotations

from typing import Collection, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.config import (DEFAULT_DTYPE, Device,
                                            as_tensor, default_device)
from tensornetwork_tpu_torch.core.network import (AbstractNode, CopyNode,
                                                  Edge, Node, connect)
from tensornetwork_tpu_torch.core.operations import (copy as copy_nodes,
                                                     reachable)
from tensornetwork_tpu_torch import contractors


def quantum_constructor(
    out_edges: Sequence[Edge],
    in_edges: Sequence[Edge],
    ref_nodes: Optional[Collection[AbstractNode]] = None,
    ignore_edges: Optional[Collection[Edge]] = None,
) -> "QuOperator":
    """Build the right Qu* subclass from edge signature (reference
    ``quantum/quantum.py:32``)."""
    if len(out_edges) == 0 and len(in_edges) == 0:
        return QuScalar(ref_nodes, ignore_edges)
    if len(out_edges) == 0:
        return QuAdjointVector(in_edges, ref_nodes, ignore_edges)
    if len(in_edges) == 0:
        return QuVector(out_edges, ref_nodes, ignore_edges)
    return QuOperator(out_edges, in_edges, ref_nodes, ignore_edges)


def identity(space: Sequence[int], dtype: torch.dtype = DEFAULT_DTYPE,
             device: Optional[Device] = None) -> "QuOperator":
    """Lazy identity via rank-2 CopyNodes (reference
    ``quantum/quantum.py:64``), on ``device`` (default: the card)."""
    device = default_device(device)
    nodes = [CopyNode(rank=2, dimension=d, dtype=dtype, device=device)
             for d in space]
    out_edges = [n[0] for n in nodes]
    in_edges = [n[1] for n in nodes]
    return quantum_constructor(out_edges, in_edges)


def check_spaces(edges_1: Sequence[Edge], edges_2: Sequence[Edge]) -> None:
    """(reference ``quantum/quantum.py:90``)"""
    if len(edges_1) != len(edges_2):
        raise ValueError(f"hilbert-space mismatch: {len(edges_1)} subsystems "
                         f"vs {len(edges_2)}")
    for i, (e1, e2) in enumerate(zip(edges_1, edges_2)):
        if e1.dimension != e2.dimension:
            raise ValueError(
                f"hilbert-space mismatch on subsystem {i}: "
                f"{e1.dimension} != {e2.dimension}")


def eliminate_identities(nodes: Collection[AbstractNode]
                         ) -> Tuple[dict, dict]:
    """Remove rank-2 CopyNodes by rewiring (reference
    ``quantum/quantum.py:107``)."""
    nodes_dict = {}
    dangling_edges_dict = {}
    for n in nodes:
        if isinstance(n, CopyNode) and n.get_rank() == 2 and \
                not (n[0].is_dangling() and n[1].is_dangling()):
            old_edges = [n[0], n[1]]
            _, new_edges = _remove_copy(n)
            if new_edges:
                # one side was dangling: both of the copy node's edges
                # collapse onto the single new dangling edge
                dangling_edges_dict[old_edges[0]] = new_edges[0]
                dangling_edges_dict[old_edges[1]] = new_edges[0]
        else:
            nodes_dict[n] = n
    # chained identities map edges transitively (edge -> intermediate
    # dangling edge -> final edge); resolve to the fixpoint
    resolved = {}
    for k in dangling_edges_dict:
        v = dangling_edges_dict[k]
        seen = {id(k)}
        while id(v) not in seen and v in dangling_edges_dict:
            seen.add(id(v))
            v = dangling_edges_dict[v]
        resolved[k] = v
    return nodes_dict, resolved


def _remove_copy(n: CopyNode):
    e0, e1 = n[0], n[1]
    if not e0.is_dangling() and not e1.is_dangling():
        # splice: connect the two neighbors directly
        n0, a0 = (e0.node2, e0.axis2) if e0.node1 is n else (e0.node1,
                                                             e0.axis1)
        n1, a1 = (e1.node2, e1.axis2) if e1.node1 is n else (e1.node1,
                                                             e1.axis1)
        new_e = Edge(node1=n0, axis1=a0, node2=n1, axis2=a1)
        n0.edges[a0] = new_e
        n1.edges[a1] = new_e
        return n, []
    # one side dangling: neighbor's edge becomes dangling
    live, dang = (e0, e1) if not e0.is_dangling() else (e1, e0)
    other, ax = (live.node2, live.axis2) if live.node1 is n else (
        live.node1, live.axis1)
    new_e = Edge(node1=other, axis1=ax)
    other.edges[ax] = new_e
    return n, [new_e]


class QuOperator:
    """A lazy operator: network + ordered out/in edges (reference
    ``quantum/quantum.py:146``)."""

    __array_priority__ = 100.0

    def __init__(self, out_edges: Sequence[Edge], in_edges: Sequence[Edge],
                 ref_nodes: Optional[Collection[AbstractNode]] = None,
                 ignore_edges: Optional[Collection[Edge]] = None):
        self.out_edges = list(out_edges)
        self.in_edges = list(in_edges)
        self.ignore_edges = set(ignore_edges) if ignore_edges else set()
        self.ref_nodes = set(ref_nodes) if ref_nodes else set()
        self.check_network()

    @classmethod
    def from_tensor(cls, tensor, out_axes: Optional[Sequence[int]] = None,
                    in_axes: Optional[Sequence[int]] = None) -> "QuOperator":
        """A torch tensor (kept on its device) or a numpy array (put on
        the card) as one node (reference ``quantum/quantum.py:210``)."""
        arr = as_tensor(tensor)
        if out_axes is None and in_axes is None:
            n = arr.ndim // 2
            out_axes = range(n)
            in_axes = range(n, arr.ndim)
        node = Node(arr)
        return cls([node[i] for i in out_axes], [node[i] for i in in_axes])

    @property
    def nodes(self) -> Set[AbstractNode]:
        """All nodes of the network (reference ``quantum/quantum.py:241``)."""
        all_nodes = set()
        for e in self.out_edges + self.in_edges + list(self.ignore_edges):
            if e.node1 is not None:
                all_nodes |= reachable(e.node1)
        all_nodes |= set(self.ref_nodes)
        return all_nodes

    @property
    def in_space(self) -> List[int]:
        return [e.dimension for e in self.in_edges]

    @property
    def out_space(self) -> List[int]:
        return [e.dimension for e in self.out_edges]

    def is_scalar(self) -> bool:
        return not self.out_edges and not self.in_edges

    def is_vector(self) -> bool:
        return bool(self.out_edges) and not self.in_edges

    def is_adjoint_vector(self) -> bool:
        return not self.out_edges and bool(self.in_edges)

    def check_network(self) -> None:
        """(reference ``quantum/quantum.py:253``)"""
        for e in self.out_edges + self.in_edges:
            if not e.is_dangling():
                raise ValueError(f"edge {e.name} is not dangling")
        known = set(self.out_edges) | set(self.in_edges) | self.ignore_edges
        for n in self.nodes:
            for e in n.edges:
                if e.is_dangling() and e not in known:
                    raise ValueError(
                        f"dangling edge {e.name} is not an in/out/ignored "
                        f"edge of the operator")

    def adjoint(self) -> "QuOperator":
        """(reference ``quantum/quantum.py:268``)"""
        nodes_dict, edge_dict = self.copy(conjugate=True)
        out_edges = [edge_dict[e] for e in self.in_edges]
        in_edges = [edge_dict[e] for e in self.out_edges]
        ref = [nodes_dict[n] for n in self.nodes]
        ignore = {edge_dict[e] for e in self.ignore_edges}
        return quantum_constructor(out_edges, in_edges, ref, ignore)

    def copy(self, conjugate: bool = False):
        return copy_nodes(list(self.nodes), conjugate=conjugate)

    def trace(self) -> "QuOperator":
        """Full trace (reference ``quantum/quantum.py:281``)."""
        return self.partial_trace(range(len(self.in_edges)))

    def norm(self) -> "QuOperator":
        """Hilbert-Schmidt norm-squared network (reference
        ``quantum/quantum.py:285``)."""
        return (self.adjoint() @ self).trace()

    def partial_trace(self, subsystems_to_trace_out: Collection[int]
                      ) -> "QuOperator":
        """(reference ``quantum/quantum.py:293``)"""
        out_idx = set(subsystems_to_trace_out)
        nodes_dict, edge_dict = self.copy()
        for i in out_idx:
            e_in = edge_dict[self.in_edges[i]]
            e_out = edge_dict[self.out_edges[i]]
            connect(e_in, e_out)
        out_edges = [edge_dict[e] for i, e in enumerate(self.out_edges)
                     if i not in out_idx]
        in_edges = [edge_dict[e] for i, e in enumerate(self.in_edges)
                    if i not in out_idx]
        ref = [nodes_dict[n] for n in self.nodes]
        ignore = {edge_dict[e] for e in self.ignore_edges}
        return quantum_constructor(out_edges, in_edges, ref, ignore)

    def __matmul__(self, other) -> "QuOperator":
        """Composition self @ other (reference
        ``quantum/quantum.py:330``)."""
        if not isinstance(other, QuOperator):
            other = QuOperator.from_tensor(other)
        check_spaces(self.in_edges, other.out_edges)
        nodes1, edges1 = self.copy()
        nodes2, edges2 = other.copy()
        for e1, e2 in zip(self.in_edges, other.out_edges):
            connect(edges1[e1], edges2[e2])
        out_edges = [edges1[e] for e in self.out_edges]
        in_edges = [edges2[e] for e in other.in_edges]
        ref = ([nodes1[n] for n in self.nodes]
           + [nodes2[n] for n in other.nodes])
        ignore = ({edges1[e] for e in self.ignore_edges}
                  | {edges2[e] for e in other.ignore_edges})
        return quantum_constructor(out_edges, in_edges, ref, ignore)

    def __rmatmul__(self, other) -> "QuOperator":
        return QuOperator.from_tensor(other) @ self

    def __mul__(self, scalar) -> "QuOperator":
        """Scalar multiplication (reference ``quantum/quantum.py:364``).

        Accepts python/numpy scalars, 0-d torch tensors and numpy arrays,
        and ``QuScalar`` operands (the reference multiplies lazy scalars
        by network composition).  A python scalar takes the operand's
        dtype as far as it can hold it (JAX's weak typing); the scalar's
        node goes to the operand's device."""
        if isinstance(scalar, QuOperator):
            if not (scalar.is_scalar() or self.is_scalar()):
                raise ValueError(
                    "can only multiply by scalars (QuScalar or numeric)")
            return self.tensor_product(scalar)
        if isinstance(scalar, Node):
            # reference convenience path (quantum/quantum.py:374-382):
            # a scalar-shaped Node operand wraps into a lazy QuScalar
            if scalar.tensor.ndim != 0:
                raise ValueError("can only multiply by scalars")
            return self.tensor_product(QuScalar([scalar.copy()]))
        if isinstance(scalar, (torch.Tensor, np.ndarray)):
            if scalar.ndim != 0:
                raise ValueError("can only multiply by scalars")
        elif not np.isscalar(scalar):
            raise ValueError("can only multiply by scalars")
        nodes_dict, edge_dict = self.copy()
        s_node = Node(_scalar_tensor(scalar, self.nodes))
        ref = [nodes_dict[n] for n in self.nodes] + [s_node]
        return quantum_constructor(
            [edge_dict[e] for e in self.out_edges],
            [edge_dict[e] for e in self.in_edges],
            ref, {edge_dict[e] for e in self.ignore_edges})

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return self * (1.0 / scalar)

    def tensor_product(self, other: "QuOperator") -> "QuOperator":
        """(reference ``quantum/quantum.py:398``)"""
        nodes1, edges1 = self.copy()
        nodes2, edges2 = other.copy()
        out_edges = ([edges1[e] for e in self.out_edges]
                     + [edges2[e] for e in other.out_edges])
        in_edges = ([edges1[e] for e in self.in_edges]
                    + [edges2[e] for e in other.in_edges])
        ref = ([nodes1[n] for n in self.nodes]
               + [nodes2[n] for n in other.nodes])
        ignore = ({edges1[e] for e in self.ignore_edges}
                  | {edges2[e] for e in other.ignore_edges})
        return quantum_constructor(out_edges, in_edges, ref, ignore)

    def __or__(self, other: "QuOperator") -> "QuOperator":
        return self.tensor_product(other)

    def contract(self, final_edge_order: Optional[Sequence[Edge]] = None
                 ) -> Node:
        """Contract the network into one node (reference
        ``quantum/quantum.py:428``)."""
        nodes_dict, dangling_dict = eliminate_identities(self.nodes)
        self.out_edges = [dangling_dict.get(e, e) for e in self.out_edges]
        self.in_edges = [dangling_dict.get(e, e) for e in self.in_edges]
        self.ignore_edges = {dangling_dict.get(e, e)
                             for e in self.ignore_edges}
        self.ref_nodes = set(nodes_dict.values())
        nodes = list(self.nodes)
        if final_edge_order:
            final_edge_order = [dangling_dict.get(e, e)
                                for e in final_edge_order]
            return contractors.greedy(nodes,
                                      output_edge_order=final_edge_order)
        return contractors.greedy(nodes, ignore_edge_order=True)

    def eval(self, final_edge_order: Optional[Sequence[Edge]] = None):
        """Contract and return the dense tensor (reference
        ``quantum/quantum.py:462``)."""
        if final_edge_order is None:
            final_edge_order = self.out_edges + self.in_edges
        node = self.contract(final_edge_order)
        return node.tensor


class QuVector(QuOperator):
    """Ket (reference ``quantum/quantum.py:495``)."""

    def __init__(self, subsystem_edges: Sequence[Edge],
                 ref_nodes=None, ignore_edges=None):
        super().__init__(subsystem_edges, [], ref_nodes, ignore_edges)

    @classmethod
    def from_tensor(cls, tensor, subsystem_axes=None) -> "QuVector":
        arr = as_tensor(tensor)
        node = Node(arr)
        if subsystem_axes is None:
            subsystem_axes = range(arr.ndim)
        return cls([node[i] for i in subsystem_axes])

    @property
    def subsystem_edges(self):
        return self.out_edges

    @property
    def space(self):
        return self.out_space

    def projector(self) -> QuOperator:
        return self @ self.adjoint()

    def reduced_density(self, subsystems_to_trace_out) -> QuOperator:
        return self.projector().partial_trace(subsystems_to_trace_out)


class QuAdjointVector(QuOperator):
    """Bra (reference ``quantum/quantum.py:560``)."""

    def __init__(self, subsystem_edges: Sequence[Edge],
                 ref_nodes=None, ignore_edges=None):
        super().__init__([], subsystem_edges, ref_nodes, ignore_edges)

    @classmethod
    def from_tensor(cls, tensor, subsystem_axes=None) -> "QuAdjointVector":
        arr = as_tensor(tensor)
        node = Node(arr)
        if subsystem_axes is None:
            subsystem_axes = range(arr.ndim)
        return cls([node[i] for i in subsystem_axes])

    @property
    def subsystem_edges(self):
        return self.in_edges

    @property
    def space(self):
        return self.in_space

    def projector(self) -> QuOperator:
        return self.adjoint() @ self

    def reduced_density(self, subsystems_to_trace_out) -> QuOperator:
        return self.projector().partial_trace(subsystems_to_trace_out)


class QuScalar(QuOperator):
    """(reference ``quantum/quantum.py:625``)"""

    def __init__(self, ref_nodes, ignore_edges=None):
        super().__init__([], [], ref_nodes, ignore_edges)

    @classmethod
    def from_tensor(cls, tensor) -> "QuScalar":
        node = Node(as_tensor(tensor).reshape(()))
        return cls({node})


def _scalar_tensor(scalar, nodes: Collection[AbstractNode]) -> torch.Tensor:
    """``scalar`` as a 0-d tensor on the device of ``nodes``: a tensor or
    numpy value keeps its dtype, a python number takes the operand's
    dtype as far as it can hold it."""
    tensors = [n for n in nodes if not isinstance(n, CopyNode)]
    if tensors:
        device, dtype = tensors[0].tensor.device, tensors[0].tensor.dtype
    elif nodes:
        n = next(iter(nodes))
        device, dtype = default_device(n.device), n.copy_dtype
    else:
        device, dtype = default_device(), DEFAULT_DTYPE
    if isinstance(scalar, torch.Tensor):
        return scalar.to(device).reshape(())
    if isinstance(scalar, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(scalar), device=device)
    dtype = torch.result_type(torch.empty((), dtype=dtype), scalar)
    return torch.tensor(scalar, dtype=dtype, device=device)
