"""Node/Edge tensor-network graph.

Counterpart of :mod:`tensornetwork_tpu.core.network` (reference
``network_components.py:36-2189``: ``AbstractNode/Node/CopyNode/Edge``,
edge algebra, pairwise contraction).  Nodes hold torch tensors; the graph
surgery is host-side Python and every compute step is one eager torch op
(a pairwise contraction is one ``torch.tensordot`` under the config's
precision).  A node's tensor follows :func:`config.as_tensor`: a tensor
stays on its device, a numpy array goes to the card.  A node may also hold
a :class:`~tensornetwork_tpu_torch.blocksparse.BlockSparseTensor`: the
graph operations dispatch on it (transpose, conjugation, the sector
tensordot, partial traces), so symmetric tensors flow through the same
Node/Edge API as dense ones.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.tensor import (
    is_blocksparse as _is_blocksparse)
from tensornetwork_tpu_torch.config import (Device, as_tensor,
                                            default_device, get_config)

Tensor = torch.Tensor

_NAME_COUNTER = itertools.count()


def _as_node_tensor(t):
    return t if _is_blocksparse(t) else as_tensor(t)


def _transpose(t, perm):
    perm = tuple(int(p) for p in perm)
    return t.transpose(perm) if _is_blocksparse(t) else t.permute(perm)


def conj(t):
    """The complex conjugate as a tensor of its own (no lazy conj view);
    a block-sparse tensor's also flips its flows."""
    return t.conj() if _is_blocksparse(t) else t.conj().resolve_conj()


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ("float32", "complex128", ...)."""
    return str(dtype).removeprefix("torch.")


def _fresh_name(prefix: str) -> str:
    return f"__{prefix}_{next(_NAME_COUNTER)}"


class NodeCollection:
    """Context manager collecting nodes created inside a ``with`` block
    (reference ``network_components.py:2189``, stack in ``ops.py:16-30``)."""

    _STACK: List["NodeCollection"] = []

    def __init__(self, container: Union[list, set, None] = None):
        self.container = container if container is not None else []

    def add(self, node: "AbstractNode"):
        if isinstance(self.container, set):
            self.container.add(node)
        else:
            self.container.append(node)

    def __enter__(self):
        NodeCollection._STACK.append(self)
        return self

    def __exit__(self, *a):
        NodeCollection._STACK.pop()


def _register_node(node: "AbstractNode"):
    if NodeCollection._STACK:
        NodeCollection._STACK[-1].add(node)


class AbstractNode:
    """Base node (reference ``network_components.py:36``)."""

    def __init__(self, name: Optional[str] = None,
                 axis_names: Optional[Sequence[str]] = None):
        self.name = name if name is not None else _fresh_name("node")
        self._axis_names = list(axis_names) if axis_names else None
        self.edges: List[Edge] = []
        _register_node(self)

    # -- tensor interface (subclass responsibility) ------------------------
    @property
    def tensor(self) -> Tensor:
        raise NotImplementedError

    @tensor.setter
    def tensor(self, t: Tensor):
        raise NotImplementedError

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self):
        return self.tensor.dtype

    def get_rank(self) -> int:
        return len(self.shape)

    @property
    def axis_names(self) -> List[str]:
        if self._axis_names is None:
            return [str(i) for i in range(self.get_rank())]
        return list(self._axis_names)

    @axis_names.setter
    def axis_names(self, names: Sequence[str]):
        if len(names) != self.get_rank():
            raise ValueError("axis_names length does not match rank")
        self._axis_names = list(names)

    def add_axis_names(self, axis_names: Sequence[str]):
        self.axis_names = axis_names

    # -- edges -------------------------------------------------------------
    def _init_edges(self):
        self.edges = [Edge(node1=self, axis1=i, name=f"{self.name}[{i}]")
                      for i in range(self.get_rank())]

    def get_edge(self, axis: Union[int, str]) -> "Edge":
        return self.edges[self.get_axis_number(axis)]

    def get_all_edges(self) -> List["Edge"]:
        return list(self.edges)

    def get_all_dangling(self) -> List["Edge"]:
        return [e for e in self.edges if e.is_dangling()]

    def get_all_nondangling(self) -> List["Edge"]:
        return [e for e in self.edges if not e.is_dangling()]

    def has_dangling_edge(self) -> bool:
        return any(e.is_dangling() for e in self.edges)

    def has_nondangling_edge(self) -> bool:
        return any(not e.is_dangling() for e in self.edges)

    def fresh_edges(self, axis_names: Optional[Sequence[str]] = None):
        """Replace all edges with new dangling edges (reference
        ``network_components.py:524``)."""
        for i in range(self.get_rank()):
            new_edge = Edge(node1=self, axis1=i)
            self.add_edge(new_edge, i, override=True)
        if axis_names:
            self.axis_names = axis_names

    def get_axis_number(self, axis: Union[int, str]) -> int:
        if isinstance(axis, int):
            return axis
        if self._axis_names and axis in self._axis_names:
            return self._axis_names.index(axis)
        try:
            return int(axis)
        except ValueError:
            raise ValueError(
                f"axis {axis!r} not found in node {self.name}") from None

    def get_dimension(self, axis: Union[int, str]) -> int:
        return self.shape[self.get_axis_number(axis)]

    def add_edge(self, edge: "Edge", axis: Union[int, str],
                 override: bool = False):
        axis_num = self.get_axis_number(axis)
        if not self.edges[axis_num].is_dangling() and not override:
            raise ValueError(
                f"axis {axis_num} of node {self.name} already has a "
                f"non-dangling edge")
        self.edges[axis_num] = edge

    # -- reordering --------------------------------------------------------
    def reorder_edges(self, edge_order: Sequence["Edge"]) -> "AbstractNode":
        """Transpose so edges appear in ``edge_order``
        (reference ``network_components.py:202``)."""
        if set(edge_order) != set(self.edges) or \
                len(edge_order) != len(self.edges):
            raise ValueError("edge_order must be a permutation of the "
                             "node's edges")
        if any(e.is_trace() for e in edge_order):
            # a trace edge occupies two axes; its position is ambiguous
            # (reference raises the same way, network_components.py:202-217)
            raise ValueError(
                "reorder_edges does not support nodes with trace edges; "
                "contract the trace first")
        perm = [self.edges.index(e) for e in edge_order]
        self.tensor = _transpose(self.tensor, perm)
        for new_axis, e in enumerate(edge_order):
            e.update_axis(perm[new_axis], self, new_axis, self)
        self.edges = list(edge_order)
        if self._axis_names:
            self._axis_names = [self._axis_names[p] for p in perm]
        return self

    def reorder_axes(self, perm: Sequence[int]) -> "AbstractNode":
        """Transpose by axis permutation (reference
        ``network_components.py:255``)."""
        if sorted(perm) != list(range(len(self.edges))):
            raise ValueError(f"perm {perm} is not a permutation")
        self.tensor = _transpose(self.tensor, perm)
        new_edges = [self.edges[p] for p in perm]
        for new_axis, e in enumerate(new_edges):
            e.update_axis(perm[new_axis], self, new_axis, self)
        self.edges = new_edges
        if self._axis_names:
            self._axis_names = [self._axis_names[p] for p in perm]
        return self

    def tensor_from_edge_order(self, order: Sequence["Edge"]) -> Tensor:
        """Tensor transposed to the given edge order without mutating the
        node (reference ``network_components.py:290``)."""
        perm = []
        for e in order:
            if e.node1 is self:
                perm.append(e.axis1)
            elif e.node2 is self:
                perm.append(e.axis2)
            else:
                raise ValueError(f"edge {e.name} not connected to node "
                                 f"{self.name}")
        return _transpose(self.tensor, perm)

    # -- dunder algebra ----------------------------------------------------
    def __matmul__(self, other: "AbstractNode") -> "Node":
        return contract_between(self, other)

    def _binary_op(self, other, op):
        if isinstance(other, AbstractNode):
            other = other.tensor
        return Node(op(self.tensor, other), name=_fresh_name("op"))

    def __add__(self, other):
        return self._binary_op(other, torch.add)

    def __sub__(self, other):
        return self._binary_op(other, torch.subtract)

    def __mul__(self, other):
        return self._binary_op(other, torch.multiply)

    def __truediv__(self, other):
        return self._binary_op(other, torch.divide)

    def __getitem__(self, key):
        if isinstance(key, (int, str)):
            return self.get_edge(key)
        return Node(self.tensor[key])

    def __xor__(self, other):
        raise TypeError("use edge ^ edge to connect")

    def copy(self, conjugate: bool = False) -> "Node":
        t = self.tensor
        if conjugate:
            t = conj(t)
        return Node(t, name=self.name, axis_names=self._axis_names)

    def to_serial_dict(self) -> dict:
        return {
            "name": self.name,
            "axis_names": self.axis_names,
            "shape": list(self.shape),
            "dtype": dtype_name(self.dtype),
        }

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"shape={self.shape})")


class Node(AbstractNode):
    """Concrete tensor-holding node (reference
    ``network_components.py:534``)."""

    def __init__(self, tensor: Tensor, name: Optional[str] = None,
                 axis_names: Optional[Sequence[str]] = None):
        if isinstance(tensor, AbstractNode):
            tensor = tensor.tensor
        self._tensor = _as_node_tensor(tensor)
        super().__init__(name=name, axis_names=axis_names)
        if axis_names is not None and len(axis_names) != self._tensor.ndim:
            raise ValueError("axis_names length does not match tensor rank")
        self._init_edges()

    @property
    def tensor(self) -> Tensor:
        return self._tensor

    @tensor.setter
    def tensor(self, t: Tensor):
        self._tensor = _as_node_tensor(t)

    @classmethod
    def from_serial_dict(cls, d: dict, tensor) -> "Node":
        return cls(tensor, name=d["name"], axis_names=d.get("axis_names"))


class CopyNode(AbstractNode):
    """Delta/COPY tensor node with lazily-materialized tensor (reference
    ``network_components.py:737``).  The tensor is made on ``device``
    (default: the card) when first read."""

    def __init__(self, rank: int, dimension: int,
                 name: Optional[str] = None,
                 axis_names: Optional[Sequence[str]] = None,
                 dtype: torch.dtype = torch.float64,
                 device: Optional[Device] = None):
        self.rank = rank
        self.dimension = dimension
        self.copy_dtype = dtype
        self.device = device
        self._tensor: Optional[Tensor] = None
        super().__init__(name=name, axis_names=axis_names)
        self.edges = [Edge(node1=self, axis1=i) for i in range(rank)]

    @property
    def shape(self):
        return (self.dimension,) * self.rank

    @property
    def dtype(self):
        return self.copy_dtype

    def get_rank(self) -> int:
        return self.rank

    @property
    def tensor(self) -> Tensor:
        if self._tensor is None:
            self._tensor = self.make_copy_tensor(
                self.rank, self.dimension, self.copy_dtype, self.device)
        return self._tensor

    @tensor.setter
    def tensor(self, t: Tensor):
        self._tensor = as_tensor(t)

    def copy(self, conjugate: bool = False) -> "CopyNode":
        """Preserve CopyNode-ness (and laziness): the delta tensor is real,
        so conjugation is a no-op (reference ``CopyNode.copy``,
        ``network_components.py:800``)."""
        new = CopyNode(rank=self.rank, dimension=self.dimension,
                       name=self.name, axis_names=self._axis_names,
                       dtype=self.copy_dtype, device=self.device)
        new._tensor = self._tensor
        return new

    @staticmethod
    def make_copy_tensor(rank: int, dimension: int, dtype,
                         device: Optional[Device] = None) -> Tensor:
        """delta_{i i ... i} (reference ``network_components.py:842``)."""
        device = default_device(device)
        idx = torch.arange(dimension, device=device)
        t = torch.zeros((dimension,) * rank, dtype=dtype, device=device)
        t[(idx,) * rank] = 1
        return t

    def get_partners(self) -> Dict[AbstractNode, Set[int]]:
        """Neighboring nodes and the axes they connect to (reference
        ``network_components.py:860``)."""
        partners: Dict[AbstractNode, Set[int]] = {}
        for e in self.edges:
            if e.is_dangling():
                raise ValueError("CopyNode with dangling edges cannot be "
                                 "contracted efficiently")
            other = e.node2 if e.node1 is self else e.node1
            axis = e.axis2 if e.node1 is self else e.axis1
            partners.setdefault(other, set()).add(axis)
        return partners

    def compute_contracted_tensor(self) -> Tensor:
        """Contract the COPY star in one ``torch.einsum`` (reference
        ``network_components.py:903``), the operands promoted to one
        dtype."""
        partners = self.get_partners()
        letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
        copy_letter = next(letters)
        operand_strs = []
        operands = []
        out_letters: Dict[Tuple[int, int], str] = {}
        axis_letters: Dict[Tuple[int, int], str] = {}
        for node, axes in partners.items():
            s = []
            for ax in range(node.get_rank()):
                if ax in axes:
                    s.append(copy_letter)
                else:
                    letter = next(letters)
                    axis_letters[(id(node), ax)] = letter
                    s.append(letter)
            operand_strs.append("".join(s))
            operands.append(node.tensor)
        out = "".join(axis_letters.values())
        expr = ",".join(operand_strs) + "->" + out
        dtype = functools.reduce(torch.promote_types,
                                 (t.dtype for t in operands))
        with get_config().precision():
            return torch.einsum(expr, *(t.to(dtype) for t in operands))


class Edge:
    """Directed pair (node1, axis1)–(node2, axis2)
    (reference ``network_components.py:963``)."""

    def __init__(self, node1: AbstractNode, axis1: int,
                 node2: Optional[AbstractNode] = None,
                 axis2: Optional[int] = None,
                 name: Optional[str] = None):
        self.node1 = node1
        self.axis1 = axis1
        self.node2 = node2
        self.axis2 = axis2
        self.name = name if name is not None else _fresh_name("edge")

    def is_dangling(self) -> bool:
        return self.node2 is None

    def is_trace(self) -> bool:
        return self.node2 is not None and self.node1 is self.node2

    def is_being_used(self) -> bool:
        result = self is self.node1.edges[self.axis1]
        if self.node2 is not None:
            result = result and self is self.node2.edges[self.axis2]
        return result

    @property
    def dimension(self) -> int:
        return self.node1.shape[self.axis1]

    def set_name(self, name: str):
        self.name = name

    def update_axis(self, old_axis: int, old_node: AbstractNode,
                    new_axis: int, new_node: AbstractNode):
        """Redirect one side of the edge (reference
        ``network_components.py:1083``)."""
        if self.axis1 == old_axis and self.node1 is old_node:
            self.axis1 = new_axis
            self.node1 = new_node
        elif self.axis2 == old_axis and self.node2 is old_node:
            self.axis2 = new_axis
            self.node2 = new_node
        else:
            raise ValueError(f"edge {self.name} not connected to "
                             f"{old_node.name} at axis {old_axis}")

    def get_nodes(self) -> List[Optional[AbstractNode]]:
        return [self.node1, self.node2]

    def __xor__(self, other: "Edge") -> "Edge":
        return connect(self, other)

    def __or__(self, other: "Edge"):
        if self is other:
            return disconnect(self)
        raise ValueError("can only disconnect an edge from itself: "
                         "use `edge | edge`")

    def disconnect(self, edge1_name: Optional[str] = None,
                   edge2_name: Optional[str] = None):
        return disconnect(self, edge1_name, edge2_name)

    def __repr__(self):
        if self.is_dangling():
            return (f"Edge(name={self.name!r}, dangling at "
                    f"{self.node1.name}[{self.axis1}])")
        return (f"Edge(name={self.name!r}, {self.node1.name}[{self.axis1}]"
                f" -- {self.node2.name}[{self.axis2}])")


# ---------------------------------------------------------------------------
# Free functions: connect / disconnect / edge algebra
# ---------------------------------------------------------------------------


def connect(edge1: Edge, edge2: Edge, name: Optional[str] = None) -> Edge:
    """Connect two dangling edges (reference
    ``network_components.py:1943``)."""
    if edge1 is edge2:
        raise ValueError(f"cannot connect edge {edge1.name} to itself")
    if not edge1.is_dangling() or not edge2.is_dangling():
        raise ValueError("both edges must be dangling to connect them")
    if edge1.dimension != edge2.dimension:
        raise ValueError(
            f"cannot connect edges of unequal dimension: "
            f"{edge1.dimension} != {edge2.dimension}")
    node1, axis1 = edge1.node1, edge1.axis1
    node2, axis2 = edge2.node1, edge2.axis1
    new_edge = Edge(node1=node1, axis1=axis1, node2=node2, axis2=axis2,
                    name=name)
    node1.add_edge(new_edge, axis1, override=True)
    node2.add_edge(new_edge, axis2, override=True)
    return new_edge


def disconnect(edge: Edge, edge1_name: Optional[str] = None,
               edge2_name: Optional[str] = None) -> Tuple[Edge, Edge]:
    """Break an edge into two dangling edges (reference
    ``network_components.py:1233``)."""
    if edge.is_dangling():
        raise ValueError(f"cannot disconnect dangling edge {edge.name}")
    e1 = Edge(node1=edge.node1, axis1=edge.axis1, name=edge1_name)
    e2 = Edge(node1=edge.node2, axis1=edge.axis2, name=edge2_name)
    edge.node1.add_edge(e1, edge.axis1, override=True)
    edge.node2.add_edge(e2, edge.axis2, override=True)
    return e1, e2


def get_shared_edges(node1: AbstractNode, node2: AbstractNode) -> Set[Edge]:
    """(reference ``network_components.py:1282``)"""
    return {e for e in node1.edges
            if (e.node1 is node1 and e.node2 is node2)
            or (e.node1 is node2 and e.node2 is node1)}


def get_parallel_edges(edge: Edge) -> Set[Edge]:
    if edge.is_dangling() or edge.is_trace():
        raise ValueError("edge must connect two distinct nodes")
    return get_shared_edges(edge.node1, edge.node2)


def get_all_edges(nodes: Sequence[AbstractNode]) -> Set[Edge]:
    edges: Set[Edge] = set()
    for n in nodes:
        edges |= set(n.edges)
    return edges


def get_all_dangling(nodes: Sequence[AbstractNode]) -> List[Edge]:
    return [e for e in get_all_edges(nodes) if e.is_dangling()]


def get_all_nondangling(nodes: Sequence[AbstractNode]) -> Set[Edge]:
    return {e for e in get_all_edges(nodes) if not e.is_dangling()}


def flatten_edges(edges: Sequence[Edge],
                  new_edge_name: Optional[str] = None) -> Edge:
    """Merge parallel edges into one by reshaping both endpoint nodes
    (reference ``network_components.py:1367``)."""
    if len(edges) == 0:
        raise ValueError("at least one edge required")
    if len(edges) == 1:
        return edges[0]
    if any(e.is_dangling() for e in edges):
        # flatten dangling edges on one node
        nodes = {e.node1 for e in edges}
        if len(nodes) != 1 or any(not e.is_dangling() for e in edges):
            raise ValueError("edges must all be dangling on one node or "
                             "all shared between the same two nodes")
        (node,) = nodes
        return _flatten_edges_on(node, edges, new_edge_name, dangling=True)
    node_pairs = {frozenset([e.node1, e.node2]) for e in edges}
    if len(node_pairs) != 1:
        raise ValueError("edges must connect the same pair of nodes")
    node1 = edges[0].node1
    node2 = edges[0].node2
    if node1 is node2:  # trace edges
        return _flatten_trace_edges(node1, edges, new_edge_name)
    e1 = _flatten_edges_on(node1, edges, new_edge_name, dangling=False)
    e2 = _flatten_edges_on(node2, edges, new_edge_name, dangling=False)
    return connect(e1, e2, name=new_edge_name)


def _axes_on(node: AbstractNode, edges: Sequence[Edge]) -> List[int]:
    axes = []
    for e in edges:
        if e.node1 is node:
            axes.append(e.axis1)
        if e.node2 is node and not e.is_trace():
            axes.append(e.axis2)
    return axes


def _flatten_edges_on(node: AbstractNode, edges: Sequence[Edge],
                      name: Optional[str], dangling: bool) -> Edge:
    axes = _axes_on(node, edges)
    other_axes = [i for i in range(node.get_rank()) if i not in axes]
    perm = other_axes + axes
    t = _transpose(node.tensor, perm)
    flat_dim = int(np.prod([node.shape[a] for a in axes], dtype=np.int64))
    t = t.reshape(tuple(node.shape[a] for a in other_axes) + (flat_dim,))
    old_edges = [node.edges[i] for i in other_axes]
    node.tensor = t
    new_edge = Edge(node1=node, axis1=len(other_axes), name=name)
    for new_axis, e in enumerate(old_edges):
        e.update_axis(perm[new_axis], node, new_axis, node)
    node.edges = old_edges + [new_edge]
    node._axis_names = None
    return new_edge


def _flatten_trace_edges(node: AbstractNode, edges: Sequence[Edge],
                         name: Optional[str]) -> Edge:
    ax1s = [e.axis1 for e in edges]
    ax2s = [e.axis2 for e in edges]
    other = [i for i in range(node.get_rank())
             if i not in ax1s and i not in ax2s]
    perm = other + ax1s + ax2s
    t = _transpose(node.tensor, perm)
    d = int(np.prod([node.shape[a] for a in ax1s], dtype=np.int64))
    t = t.reshape(tuple(node.shape[a] for a in other) + (d, d))
    old_edges = [node.edges[i] for i in other]
    node.tensor = t
    k = len(other)
    new_edge = Edge(node1=node, axis1=k, node2=node, axis2=k + 1, name=name)
    for new_axis, e in enumerate(old_edges):
        e.update_axis(perm[new_axis], node, new_axis, node)
    node.edges = old_edges + [new_edge, new_edge]
    node._axis_names = None
    return new_edge


def flatten_edges_between(node1: AbstractNode,
                          node2: AbstractNode) -> Optional[Edge]:
    """(reference ``network_components.py:1459``)"""
    shared = get_shared_edges(node1, node2)
    if shared:
        return flatten_edges(sorted(shared, key=lambda e: e.name))
    return None


def flatten_all_edges(nodes: Sequence[AbstractNode]) -> List[Edge]:
    """Flatten every group of parallel (or trace) edges so any pair of
    nodes shares at most one edge (reference
    ``network_components.py:1480``)."""
    flattened = []
    done: Set[frozenset] = set()
    for e in list(get_all_nondangling(nodes)):
        if not e.is_being_used():
            continue
        key = frozenset([id(e.node1), id(e.node2)])
        if key in done:
            continue
        done.add(key)
        if e.is_trace():
            group = list({id(x): x for x in e.node1.edges
                          if x.is_trace()}.values())
            if len(group) > 1:
                flattened.append(_flatten_trace_edges(e.node1, group, None))
            else:
                flattened.append(e)
        else:
            group = sorted(get_shared_edges(e.node1, e.node2),
                           key=lambda x: x.name)
            if len(group) > 1:
                flattened.append(flatten_edges(group))
            else:
                flattened.append(e)
    return flattened


def split_edge(edge: Edge, shape: Tuple[int, ...],
               new_edge_names: Optional[List[str]] = None) -> List[Edge]:
    """Reshape one edge into several (reference
    ``network_components.py:1539``)."""
    if int(np.prod(shape, dtype=np.int64)) != edge.dimension:
        raise ValueError(f"shape {shape} is incompatible with edge "
                         f"dimension {edge.dimension}")
    if len(shape) == 1:
        return [edge]
    names = new_edge_names or [None] * len(shape)

    def split_on(node, axis):
        other = [i for i in range(node.get_rank()) if i != axis]
        perm = other + [axis]
        t = _transpose(node.tensor, perm)
        t = t.reshape(tuple(node.shape[i] for i in other) + tuple(shape))
        old_edges = [node.edges[i] for i in other]
        node.tensor = t
        new_edges = [Edge(node1=node, axis1=len(other) + k, name=names[k])
                     for k in range(len(shape))]
        for new_axis, e in enumerate(old_edges):
            e.update_axis(perm[new_axis], node, new_axis, node)
        node.edges = old_edges + new_edges
        node._axis_names = None
        return new_edges

    if edge.is_dangling():
        return split_on(edge.node1, edge.axis1)
    if edge.is_trace():
        raise ValueError("cannot split a trace edge")
    e1s = split_on(edge.node1, edge.axis1)
    e2s = split_on(edge.node2, edge.axis2)
    return [connect(a, b, name=names[i])
            for i, (a, b) in enumerate(zip(e1s, e2s))]


def slice_edge(edge: Edge, start_index: int, length: int,
               new_edge_name: Optional[str] = None) -> Edge:
    """Restrict an edge to a slice (reference
    ``network_components.py:1636``)."""

    def do_slice(node, axis):
        idx = [slice(None)] * node.get_rank()
        idx[axis] = slice(start_index, start_index + length)
        node.tensor = node.tensor[tuple(idx)]

    do_slice(edge.node1, edge.axis1)
    if not edge.is_dangling() and not edge.is_trace():
        do_slice(edge.node2, edge.axis2)
    elif edge.is_trace():
        do_slice(edge.node1, edge.axis2)
    if new_edge_name:
        edge.set_name(new_edge_name)
    return edge


# ---------------------------------------------------------------------------
# Contraction
# ---------------------------------------------------------------------------


def _tensordot(a, b, axes):
    """``torch.tensordot`` of the promoted operands under the config's
    precision; the sector tensordot of two block-sparse operands."""
    if _is_blocksparse(a) or _is_blocksparse(b):
        if not (_is_blocksparse(a) and _is_blocksparse(b)):
            raise TypeError(
                "cannot contract a BlockSparseTensor with a dense tensor")
        from tensornetwork_tpu_torch.blocksparse.tensor import tensordot
        return tensordot(a, b, axes)
    dtype = torch.promote_types(a.dtype, b.dtype)
    with get_config().precision():
        return torch.tensordot(a.to(dtype), b.to(dtype), dims=axes)


def _contract_trace(edge: Edge, name: Optional[str] = None) -> "Node":
    node = edge.node1
    ax1, ax2 = edge.axis1, edge.axis2
    if _is_blocksparse(node.tensor):
        from tensornetwork_tpu_torch.blocksparse import linalg as bsl
        t = bsl.trace(node.tensor, axes=(ax1, ax2))
    else:
        t = torch.diagonal(node.tensor, dim1=ax1, dim2=ax2).sum(-1)
    new_node = Node(t, name=name)
    rest = [e for i, e in enumerate(node.edges) if i not in (ax1, ax2)]
    for new_axis, e in enumerate(rest):
        old_axis = e.axis1 if e.node1 is node else e.axis2
        e.update_axis(old_axis, node, new_axis, new_node)
    new_node.edges = rest
    return new_node


def contract(edge: Edge, name: Optional[str] = None,
             axis_names: Optional[List[str]] = None) -> "Node":
    """Contract a single edge (reference ``network_components.py:1834``)."""
    if edge.is_dangling():
        raise ValueError(f"cannot contract dangling edge {edge.name}")
    if edge.node1 is edge.node2:
        node = _contract_trace(edge, name)
    else:
        node1, node2 = edge.node1, edge.node2
        t = _tensordot(node1.tensor, node2.tensor,
                       [[edge.axis1], [edge.axis2]])
        node = Node(t, name=name)
        rest1 = [e for i, e in enumerate(node1.edges) if i != edge.axis1]
        rest2 = [e for i, e in enumerate(node2.edges) if i != edge.axis2]
        _rewire(node, [(node1, rest1), (node2, rest2)])
    if axis_names:
        node.axis_names = axis_names
    return node


def _rewire(new_node: Node, groups: List[Tuple[AbstractNode, List[Edge]]]):
    """Point the surviving edges of contracted nodes at the new node.
    Edges connecting the two contracted nodes (or trace edges on one of
    them) appear twice in the surviving list and become trace edges on the
    new node."""
    new_edges: List[Edge] = []
    for _, rest in groups:
        new_edges.extend(rest)
    old_nodes = [n for n, _ in groups]
    handled: Set[int] = set()
    for new_axis, e in enumerate(new_edges):
        if id(e) in handled:
            # second occurrence → second endpoint of a new trace edge
            e.node2 = new_node
            e.axis2 = new_axis
            continue
        internal = (not e.is_dangling() and e.node1 in old_nodes
                    and e.node2 in old_nodes)
        if internal:
            e.node1 = new_node
            e.axis1 = new_axis
            handled.add(id(e))
        else:
            old_node = e.node1 if e.node1 in old_nodes else e.node2
            old_axis = e.axis1 if e.node1 is old_node else e.axis2
            e.update_axis(old_axis, old_node, new_axis, new_node)
    new_node.edges = new_edges


def contract_copy_node(copy_node: CopyNode,
                       name: Optional[str] = None) -> Node:
    """Contract a COPY node with all its neighbors at once (reference
    ``network_components.py:1888``)."""
    partners = copy_node.get_partners()
    t = copy_node.compute_contracted_tensor()
    new_node = Node(t, name=name)
    new_edges = []
    for node, axes in partners.items():
        for ax in range(node.get_rank()):
            if ax not in axes:
                new_edges.append((node, ax, node.edges[ax]))
    for new_axis, (node, old_axis, e) in enumerate(new_edges):
        e.update_axis(old_axis, node, new_axis, new_node)
    new_node.edges = [e for (_, _, e) in new_edges]
    return new_node


def contract_parallel(edge: Edge, name: Optional[str] = None) -> Node:
    """Contract all edges parallel to ``edge``
    (reference ``network_components.py:1923``)."""
    if edge.is_dangling():
        raise ValueError("cannot contract dangling edge")
    return contract_between(edge.node1, edge.node2, name=name)


def outer_product(node1: AbstractNode, node2: AbstractNode,
                  name: Optional[str] = None,
                  axis_names: Optional[List[str]] = None) -> Node:
    """(reference ``network_components.py:2127``)"""
    t = _tensordot(node1.tensor, node2.tensor, 0)
    node = Node(t, name=name)
    _rewire(node, [(node1, list(node1.edges)), (node2, list(node2.edges))])
    if axis_names:
        node.axis_names = axis_names
    return node


def contract_between(
    node1: AbstractNode,
    node2: AbstractNode,
    name: Optional[str] = None,
    allow_outer_product: bool = False,
    output_edge_order: Optional[Sequence[Edge]] = None,
    axis_names: Optional[List[str]] = None,
) -> Node:
    """Contract all shared edges between two nodes in one tensordot
    (reference ``network_components.py:1984``)."""
    if node1 is node2:
        # contract all trace edges
        node = node1
        trace_edges = [e for e in node.edges if e.is_trace()]
        out = node
        for e in {id(e): e for e in trace_edges}.values():
            out = _contract_trace(e)
        if output_edge_order:
            out.reorder_edges(list(output_edge_order))
        if name:
            out.name = name
        return out
    shared = get_shared_edges(node1, node2)
    if not shared:
        if allow_outer_product:
            node = outer_product(node1, node2, name=name)
            if output_edge_order:
                node.reorder_edges(list(output_edge_order))
            return node
        raise ValueError(f"no edges found between nodes {node1.name} and "
                         f"{node2.name}")
    axes1, axes2 = [], []
    for e in shared:
        if e.node1 is node1:
            axes1.append(e.axis1)
            axes2.append(e.axis2)
        else:
            axes1.append(e.axis2)
            axes2.append(e.axis1)
    order = np.argsort(axes1)
    axes1 = [axes1[i] for i in order]
    axes2 = [axes2[i] for i in order]
    t = _tensordot(node1.tensor, node2.tensor, [axes1, axes2])
    node = Node(t, name=name)
    rest1 = [e for i, e in enumerate(node1.edges) if i not in axes1]
    rest2 = [e for i, e in enumerate(node2.edges) if i not in axes2]
    _rewire(node, [(node1, rest1), (node2, rest2)])
    if output_edge_order:
        node.reorder_edges(list(output_edge_order))
    if axis_names:
        node.axis_names = axis_names
    return node


def get_neighbors(node: AbstractNode) -> List[AbstractNode]:
    """All nodes directly connected to ``node`` (never includes ``node``
    itself, even via trace edges).  Reference
    ``network_operations.py:823``; insertion order, deduplicated."""
    neighbors: List[AbstractNode] = []
    seen = set()
    for edge in node.edges:
        if edge.is_dangling() or edge.is_trace():
            continue
        other = edge.node2 if edge.node1 is node else edge.node1
        if id(other) not in seen:
            neighbors.append(other)
            seen.add(id(other))
    return neighbors


def outer_product_final_nodes(nodes, edge_order) -> AbstractNode:
    """Outer product of fully-contracted remaining nodes, reordered to
    ``edge_order`` (reference ``network_components.py:2098``)."""
    nodes = list(nodes)
    for node in nodes:
        if node.has_nondangling_edge():
            raise ValueError(
                f"Node '{node}' has a non-dangling edge remaining.")
    final_node = nodes[0]
    for node in nodes[1:]:
        final_node = outer_product(final_node, node)
    return final_node.reorder_edges(edge_order)
