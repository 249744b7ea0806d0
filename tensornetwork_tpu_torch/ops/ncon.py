"""Declarative tensor-network contraction (``ncon``).

Counterpart of :mod:`tensornetwork_tpu.ops.ncon`, with the same label
semantics (reference ``ncon_interface.py:523-556``): positive labels are
contracted, negative labels are open output axes, and a positive label on
more than two operands -- or a negative label on two -- is a *batch* label.

The network is compiled on the host into a static :class:`ContractionPlan`
of pair merges with explicit contracted and batch axes, cached per
(structure, con_order, out_order), and replayed eagerly on torch tensors:
each pair step is one ``torch.tensordot``, or, with batch axes, one
batched ``torch.matmul`` of the permuted and reshaped operands; partial
traces are ``torch.diagonal`` and a sum.  Complex networks run on native
complex tensors.  Block-sparse operands (the JAX package's
``_execute_plan_blocksparse``) wait for the port's block-sparse slice.
"""
from __future__ import annotations

import functools
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.config import as_tensor, get_config

Label = Union[int, str]


# ---------------------------------------------------------------------------
# Canonicalization & validation (host-side, mirrors reference
# ``ncon_interface.py:69-238`` behavior)
# ---------------------------------------------------------------------------


def canonicalize_structure(
    network_structure: Sequence[Sequence[Label]],
) -> Tuple[Tuple[Tuple[int, ...], ...], dict]:
    """Map int/str labels to canonical integers.

    Integer labels keep their value.  String labels are assigned fresh
    integers: strings starting with ``'-'`` become new negative (output)
    labels, other strings become new positive (contracted) labels.  Fresh
    labels are assigned in sorted string order beyond the extremes of the
    integer labels already present, so mixed int/str networks are stable.
    """
    flat = [l for labels in network_structure for l in labels]
    int_labels = [l for l in flat if not isinstance(l, str)]
    str_labels = {l for l in flat if isinstance(l, str)}
    neg_strs = sorted(s for s in str_labels if s.startswith("-"))
    pos_strs = sorted(s for s in str_labels if not s.startswith("-"))
    max_int = max([l for l in int_labels if l > 0], default=0)
    min_int = min([l for l in int_labels if l < 0], default=0)
    mapping: dict = {}
    for i, s in enumerate(pos_strs):
        mapping[s] = max_int + 1 + i
    for i, s in enumerate(neg_strs):
        mapping[s] = min_int - 1 - i
    canonical = tuple(
        tuple(mapping.get(l, l) if isinstance(l, str) else int(l) for l in labels)
        for labels in network_structure
    )
    for labels in canonical:
        if any(l == 0 for l in labels):
            raise ValueError("label 0 is not allowed in ncon network structures")
    return canonical, mapping


def check_network(
    structure: Sequence[Sequence[int]],
    shapes: Sequence[Tuple[int, ...]],
    con_order: Optional[Sequence[int]],
    out_order: Optional[Sequence[int]],
) -> None:
    """Validate a canonicalized network (reference ``_check_network``,
    ``ncon_interface.py:118-238``)."""
    if len(structure) != len(shapes):
        raise ValueError(
            f"got {len(shapes)} tensors but network_structure has "
            f"{len(structure)} label lists")
    for i, (labels, shape) in enumerate(zip(structure, shapes)):
        if len(labels) != len(shape):
            raise ValueError(
                f"tensor {i} has rank {len(shape)} but {len(labels)} labels")
    flat = [l for labels in structure for l in labels]
    pos = sorted({l for l in flat if l > 0})
    neg = sorted({l for l in flat if l < 0})
    # dimension consistency per label
    dims: dict = {}
    for labels, shape in zip(structure, shapes):
        for l, d in zip(labels, shape):
            if l in dims and dims[l] != d:
                raise ValueError(
                    f"label {l} has inconsistent dimensions {dims[l]} and {d}")
            dims[l] = d
    counts = {l: flat.count(l) for l in set(flat)}
    for l in neg:
        if counts[l] > 2:
            raise ValueError(
                f"output label {l} appears {counts[l]} times (max 2 for batch)")
    for i, labels in enumerate(structure):
        for l in set(labels):
            c = labels.count(l)
            if l < 0 and c > 1:
                raise ValueError(
                    f"output label {l} appears {c} times on tensor {i}")
            if l > 0 and c > 2:
                raise ValueError(
                    f"label {l} appears {c} times on tensor {i} (max 2)")
            if l > 0 and c == 2 and counts[l] > 2:
                raise ValueError(
                    f"traced label {l} on tensor {i} also appears on other "
                    f"tensors; this is not supported")
    if con_order is not None:
        if sorted(con_order) != sorted(set(con_order)):
            raise ValueError(f"duplicate labels in con_order {list(con_order)}")
        if set(con_order) != set(pos):
            raise ValueError(
                f"con_order = {list(con_order)} is not a permutation of the "
                f"contracted labels {pos}")
    if out_order is not None:
        if sorted(out_order) != sorted(set(out_order)):
            raise ValueError(f"duplicate labels in out_order {list(out_order)}")
        if set(out_order) != set(neg):
            raise ValueError(
                f"out_order = {list(out_order)} is not a permutation of the "
                f"open labels {neg}")


# ---------------------------------------------------------------------------
# Plan compilation (host-side)
# ---------------------------------------------------------------------------


class _Op:
    """One step of a contraction plan. Targets refer to a slot list that
    mirrors the execution-time operand stack."""
    __slots__ = ("kind", "a", "b", "cont_a", "cont_b", "batch_a", "batch_b",
                 "axes", "perm", "labels")

    def __init__(self, kind, **kw):
        self.kind = kind
        for k in self.__slots__[1:]:
            setattr(self, k, kw.get(k))

    def __repr__(self):
        fields = {k: getattr(self, k) for k in self.__slots__[1:]
                  if getattr(self, k) is not None}
        return f"_Op({self.kind}, {fields})"


class ContractionPlan:
    """A static, replayable contraction schedule.

    ``steps`` is a list of :class:`_Op`:
      * ``trace``:   partial-trace repeated labels on slot ``a`` (axes pairs)
      * ``sum``:     sum slot ``a`` over ``axes``
      * ``pair``:    dot_general(slots a, b) with contracting axes
                     (cont_a, cont_b) and batch axes (batch_a, batch_b);
                     result replaces slot ``a``, slot ``b`` is dropped
      * ``final``:   transpose the single remaining slot by ``perm``
    """

    def __init__(self, steps: List[_Op], n_inputs: int,
                 out_labels: Tuple[int, ...]):
        self.steps = steps
        self.n_inputs = n_inputs
        self.out_labels = out_labels

    # -- introspection used by the profiler / cost model ------------------
    def flops(self, shapes: Sequence[Tuple[int, ...]]) -> int:
        """Analytic FLOP count (2*multiply-add) of executing this plan."""
        shapes = [tuple(s) for s in shapes]
        slots: List[Optional[Tuple[int, ...]]] = list(shapes)
        total = 0
        for op in self.steps:
            if op.kind == "trace":
                # mirror execute_plan: sequential diagonals (axes computed
                # against the evolving shape), then the trailing diag axes
                # are summed away
                shape = list(slots[op.a])
                for (ax1, ax2) in op.axes:
                    dd = shape[ax1]
                    for idx in sorted((ax1, ax2), reverse=True):
                        del shape[idx]
                    shape.append(dd)
                total += int(np.prod(slots[op.a], dtype=np.int64))
                shape = shape[:len(shape) - len(op.axes)]
                slots[op.a] = tuple(shape)
            elif op.kind == "sum":
                total += int(np.prod(slots[op.a], dtype=np.int64))
                slots[op.a] = tuple(
                    d for i, d in enumerate(slots[op.a]) if i not in op.axes)
            elif op.kind == "pair":
                sa, sb = slots[op.a], slots[op.b]
                batch = [sa[i] for i in op.batch_a]
                cont = [sa[i] for i in op.cont_a]
                free_a = [d for i, d in enumerate(sa)
                          if i not in op.cont_a and i not in op.batch_a]
                free_b = [d for i, d in enumerate(sb)
                          if i not in op.cont_b and i not in op.batch_b]
                total += 2 * int(
                    np.prod(batch + cont + free_a + free_b, dtype=np.int64))
                slots[op.a] = tuple(batch + free_a + free_b)
                slots[op.b] = None
            elif op.kind == "final":
                pass
        return total


def _needed_elsewhere(label: int, skip: Tuple[int, int],
                      slot_labels: List[Optional[List[int]]]) -> bool:
    if label < 0:
        return True
    for k, labels in enumerate(slot_labels):
        if labels is None or k in skip:
            continue
        if label in labels:
            return True
    return False


def compile_plan(
    structure: Sequence[Sequence[int]],
    con_order: Optional[Sequence[int]] = None,
    out_order: Optional[Sequence[int]] = None,
) -> ContractionPlan:
    """Compile a canonical network structure into a static plan.

    Pair-merge schedule follows the reference semantics: labels are resolved
    in ``con_order``; when a pair of operands is merged every shared label
    not needed elsewhere is contracted at once, shared labels still needed
    (batch labels, open batch labels) ride through as dot_general batch
    dimensions (reference ``ncon_interface.py:431-494``).
    """
    slot_labels: List[Optional[List[int]]] = [list(l) for l in structure]
    flat = [l for labels in structure for l in labels]
    pos = sorted({l for l in flat if l > 0})
    neg = sorted({l for l in flat if l < 0})
    if out_order is None:
        out_order = sorted(neg, reverse=True)
    out_order = tuple(out_order)
    steps: List[_Op] = []

    # 1. partial traces (positive label repeated within one tensor)
    for i, labels in enumerate(slot_labels):
        repeated = sorted({l for l in labels if l > 0 and labels.count(l) == 2})
        if repeated:
            # only trace labels that appear nowhere else
            traceable = [
                l for l in repeated
                if not _needed_elsewhere(l, (i, i), [
                    lab if k != i else None
                    for k, lab in enumerate(slot_labels)])
            ]
            if traceable:
                new_labels = [l for l in labels if l not in traceable]
                # torch.diagonal removes (dim1, dim2) and appends the diag
                # axis at the end, so compute axis pairs by sequential
                # simulation; the trailing diag axes are summed by the op.
                axes = []
                sim = list(labels)
                for l in traceable:
                    ax1 = sim.index(l)
                    ax2 = sim.index(l, ax1 + 1)
                    axes.append((ax1, ax2))
                    sim = [x for x in sim if x != l] + [None]
                steps.append(_Op("trace", a=i, axes=tuple(axes)))
                slot_labels[i] = new_labels
    if con_order is None:
        con_order_l = [l for l in pos]
    else:
        con_order_l = list(con_order)
    # drop traced labels from con_order
    con_order_l = [
        l for l in con_order_l
        if any(labels is not None and l in labels for labels in slot_labels)
    ]

    # 2. sum over positive labels appearing exactly once in the whole network
    for i, labels in enumerate(slot_labels):
        if labels is None:
            continue
        lone = [
            l for l in set(labels)
            if l > 0 and labels.count(l) == 1 and not _needed_elsewhere(
                l, (i, i),
                [lab if k != i else None for k, lab in enumerate(slot_labels)])
        ]
        if lone:
            axes = tuple(sorted(labels.index(l) for l in lone))
            steps.append(_Op("sum", a=i, axes=axes))
            slot_labels[i] = [l for j, l in enumerate(labels) if j not in axes]
            con_order_l = [l for l in con_order_l if l not in lone]

    def emit_pair(i: int, j: int):
        la, lb = slot_labels[i], slot_labels[j]
        shared = [l for l in dict.fromkeys(la) if l in lb]
        cont = [l for l in shared
                if l > 0 and not _needed_elsewhere(l, (i, j), slot_labels)]
        batch = [l for l in shared if l not in cont]
        cont_a = tuple(la.index(l) for l in cont)
        cont_b = tuple(lb.index(l) for l in cont)
        batch_a = tuple(la.index(l) for l in batch)
        batch_b = tuple(lb.index(l) for l in batch)
        free_a = [l for k, l in enumerate(la)
                  if k not in cont_a and k not in batch_a]
        free_b = [l for k, l in enumerate(lb)
                  if k not in cont_b and k not in batch_b]
        steps.append(_Op("pair", a=i, b=j, cont_a=cont_a, cont_b=cont_b,
                         batch_a=batch_a, batch_b=batch_b))
        slot_labels[i] = batch + free_a + free_b
        slot_labels[j] = None
        return cont

    # 3. pairwise merges driven by con_order
    while con_order_l:
        l = con_order_l[0]
        holders = [k for k, labels in enumerate(slot_labels)
                   if labels is not None and l in labels]
        if len(holders) == 1:
            # label appears once (can occur after batch merges collapsed the
            # other holders): sum it away if fully resolved
            i = holders[0]
            labels = slot_labels[i]
            if labels.count(l) == 2:
                ax1 = labels.index(l)
                ax2 = labels.index(l, ax1 + 1)
                steps.append(_Op("trace", a=i, axes=((ax1, ax2),)))
                slot_labels[i] = [x for x in labels if x != l]
            else:
                ax = labels.index(l)
                steps.append(_Op("sum", a=i, axes=(ax,)))
                slot_labels[i] = [x for k, x in enumerate(labels) if k != ax]
            con_order_l = [x for x in con_order_l if x != l]
            continue
        i, j = holders[0], holders[1]
        cont = emit_pair(i, j)
        if cont:
            con_order_l = [x for x in con_order_l if x not in cont]
        # if nothing was contracted (pure batch merge) the label stays in
        # con_order; the merge reduced the operand count so we make progress.

    # 4. outer/batch products of the remaining operands
    remaining = [k for k, labels in enumerate(slot_labels) if labels is not None]
    while len(remaining) > 1:
        emit_pair(remaining[0], remaining[1])
        remaining = [k for k, labels in enumerate(slot_labels)
                     if labels is not None]

    final_slot = remaining[0]
    final_labels = slot_labels[final_slot]
    if sorted(final_labels) != sorted(out_order):
        raise ValueError(
            f"network reduces to labels {sorted(final_labels)} but out_order "
            f"is {list(out_order)}")
    perm = tuple(final_labels.index(l) for l in out_order)
    steps.append(_Op("final", a=final_slot, perm=perm))
    return ContractionPlan(steps, len(structure), out_order)


# ---------------------------------------------------------------------------
# Execution (eager torch)
# ---------------------------------------------------------------------------


def dot_general(a: torch.Tensor, b: torch.Tensor, cont_a, cont_b, batch_a,
                batch_b) -> torch.Tensor:
    """``lax.dot_general`` on torch tensors: the result's axes are the
    batch axes, then a's free axes, then b's, each in operand order.  The
    operands are promoted to one dtype (or computed in the config's
    ``preferred_element_type``) and multiplied under its precision."""
    cfg = get_config()
    dtype, out_dtype = cfg.result_dtype(a, b)
    a, b = a.to(dtype), b.to(dtype)
    free_a = [i for i in range(a.ndim) if i not in cont_a and i not in batch_a]
    free_b = [i for i in range(b.ndim) if i not in cont_b and i not in batch_b]
    with cfg.precision():
        if not batch_a:
            out = torch.tensordot(a, b, dims=(list(cont_a), list(cont_b)))
        else:
            bdims = [a.shape[i] for i in batch_a]
            fa = [a.shape[i] for i in free_a]
            fb = [b.shape[i] for i in free_b]
            k = int(np.prod([a.shape[i] for i in cont_a], dtype=np.int64))
            nb = int(np.prod(bdims, dtype=np.int64))
            at = a.permute(list(batch_a) + free_a + list(cont_a)).reshape(
                nb, int(np.prod(fa, dtype=np.int64)), k)
            bt = b.permute(list(batch_b) + list(cont_b) + free_b).reshape(
                nb, k, int(np.prod(fb, dtype=np.int64)))
            out = torch.matmul(at, bt).reshape(bdims + fa + fb)
    return out.to(out_dtype)


def execute_plan(plan: ContractionPlan, tensors: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """Replay a plan on torch tensors, one eager op per step."""
    slots: List[Any] = list(tensors)
    for op in plan.steps:
        if op.kind == "trace":
            t = slots[op.a]
            for (ax1, ax2) in op.axes:
                t = torch.diagonal(t, dim1=ax1, dim2=ax2)
            n = len(op.axes)
            slots[op.a] = t.sum(dim=tuple(range(t.ndim - n, t.ndim)))
        elif op.kind == "sum":
            slots[op.a] = slots[op.a].sum(dim=op.axes)
        elif op.kind == "pair":
            slots[op.a] = dot_general(slots[op.a], slots[op.b], op.cont_a,
                                      op.cont_b, op.batch_a, op.batch_b)
            slots[op.b] = None
        elif op.kind == "final":
            t = slots[op.a]
            if op.perm != tuple(range(t.ndim)):
                t = t.permute(op.perm)
            return t
    raise AssertionError("plan had no final step")


@functools.lru_cache(maxsize=None)
def _cached_plan(structure, con_order, out_order):
    return compile_plan(structure, con_order, out_order)


def _relabel(order, mapping):
    return [mapping.get(l, l) if isinstance(l, str) else int(l)
            for l in order]


def ncon(
    tensors: Sequence[Any],
    network_structure: Sequence[Sequence[Label]],
    con_order: Optional[Union[str, Sequence[Label]]] = None,
    out_order: Optional[Sequence[Label]] = None,
    check_network: bool = True,
    backend: Optional[str] = None,
    jit: bool = True,
) -> torch.Tensor:
    """Contract a tensor network given in ncon label notation.

    ``tensors`` may be torch tensors (they stay on their device), numpy
    arrays (they go to the card: :func:`config.as_tensor`), ``Node``\\ s or
    ``Tensor``\\ s.  ``con_order`` may also be the string ``"greedy"`` or
    ``"optimal"`` (or any name of :func:`paths.get_pair_path`) to solve
    the order on the host from the operand shapes.  ``backend`` and ``jit``
    are accepted for the JAX package's signature: there is one execution
    layer, and the plan, cached per network, is replayed eagerly either
    way."""
    tensors = [t.tensor if hasattr(t, "tensor") and hasattr(t, "edges")
               else (t.array if hasattr(t, "array") else t)
               for t in tensors]
    tensors = [as_tensor(t) for t in tensors]
    structure, mapping = canonicalize_structure(network_structure)
    shapes = [tuple(t.shape) for t in tensors]
    if isinstance(con_order, str):
        from tensornetwork_tpu_torch.ops import paths
        con_order = paths.solve_con_order(structure, shapes, method=con_order)
    elif con_order is not None:
        con_order = _relabel(con_order, mapping)
    if out_order is not None:
        out_order = _relabel(out_order, mapping)
    if check_network:
        globals()["check_network"](structure, shapes, con_order, out_order)
    plan = _cached_plan(structure,
                        tuple(con_order) if con_order is not None else None,
                        tuple(out_order) if out_order is not None else None)
    return execute_plan(plan, tensors)


def finalize(builder) -> Any:
    """Execute an :class:`~tensornetwork_tpu_torch.core.tensor.NconBuilder`;
    returns a :class:`~tensornetwork_tpu_torch.core.tensor.Tensor`."""
    from tensornetwork_tpu_torch.core.tensor import Tensor
    return Tensor(ncon(builder.tensors, builder.axes))
