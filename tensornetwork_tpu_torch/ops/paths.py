"""Host-side contraction-order solvers.

Counterpart of :mod:`tensornetwork_tpu.ops.paths`, with the path
algorithms written here instead of taken from ``opt_einsum``, which the
card's machine does not have.  ``optimal``, ``greedy`` and the ``branch``
family follow opt_einsum 3.4's ``paths.optimal``, ``paths.greedy`` and
``paths.branch`` (the functions the JAX package calls), their cost model,
their search order and their tie-breaking, so that both packages pick
paths of the same cost.  Every algorithm takes opt_einsum's path-function
arguments ``(inputs, output, size_dict, memory_limit=None)`` and returns
a path in its convention: at each step the listed operands of the current
list are removed and their result is appended.  ``memory_limit`` is
accepted for that signature; no caller sets one, and a finite one raises.
"""
from __future__ import annotations

import bisect
import functools
import heapq
import itertools
from collections import defaultdict
from typing import (Callable, Dict, FrozenSet, List, Sequence, Set, Tuple,
                    Union)

import numpy as np

PathAlgorithm = Union[str, Callable]
Path = List[Tuple[int, ...]]

# networks this large go to the Python algorithm (the JAX package's bound)
NATIVE_MAX_OPERANDS = 22


def _size(indices, size_dict) -> int:
    out = 1
    for i in indices:
        out *= size_dict[i]
    return out


def _flop_count(indices, inner: bool, num_terms: int, size_dict) -> int:
    """opt_einsum's cost of one contraction: the size of the index space
    times (terms - 1, one more for an inner product)."""
    return _size(indices, size_dict) * (max(1, num_terms - 1) + int(inner))


def _check_memory_limit(memory_limit) -> None:
    if memory_limit not in (None, -1, float("inf")):
        raise ValueError("memory_limit is not supported by the port's path "
                         "solvers")


def ssa_to_linear(ssa_path: Sequence[Tuple[int, ...]]) -> Path:
    """A path of static single-assignment ids (inputs 0..n-1, each result
    the next id) in the current-list convention."""
    n = sum(map(len, ssa_path)) - len(ssa_path) + 1
    ids = list(range(n))
    path = []
    for ssa, scon in enumerate(ssa_path, start=n):
        con = sorted(bisect.bisect_left(ids, s) for s in scon)
        for j in reversed(con):
            ids.pop(j)
        ids.append(ssa)
        path.append(tuple(con))
    return path


def _pair(inputs, output, remaining, i, j, size_dict
          ) -> Tuple[FrozenSet, int]:
    """Result indices and cost of contracting operands i and j while the
    operands ``remaining`` are left (opt_einsum's ``calc_k12_flops``)."""
    k1, k2 = inputs[i], inputs[j]
    either = k1 | k2
    keep = frozenset.union(output, *(inputs[k] for k in remaining - {i, j}))
    return either & keep, _flop_count(either, bool((k1 & k2) - keep), 2,
                                      size_dict)


def optimal(inputs, output, size_dict, memory_limit=None) -> Path:
    """Exhaustive depth-first search over all pairwise orders, pruned by the
    best total cost found so far (opt_einsum 3.4 ``paths.optimal``)."""
    _check_memory_limit(memory_limit)
    output = frozenset(output)
    best = {"flops": float("inf"), "path": (tuple(range(len(inputs))),)}
    cache: Dict[Tuple[FrozenSet, FrozenSet], Tuple[FrozenSet, int]] = {}

    def walk(path, inputs, remaining, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(remaining, 2):
            if i > j:
                i, j = j, i
            key = (inputs[i], inputs[j])
            if key not in cache:
                cache[key] = _pair(inputs, output, remaining, i, j, size_dict)
            k12, flops12 = cache[key]
            if flops + flops12 >= best["flops"]:
                continue
            walk(path + ((i, j),), inputs + (k12,),
                 remaining - {i, j} | {len(inputs)}, flops + flops12)

    walk((), tuple(map(frozenset, inputs)), set(range(len(inputs))), 0)
    return ssa_to_linear(best["path"])


def branch(inputs, output, size_dict, memory_limit=None, nbranch=None,
           cutoff_flops_factor: int = 4) -> Path:
    """Depth-first search that follows, at each step, the ``nbranch``
    (``None``: all) pairs that shrink memory the most, pruned by the best
    (flops, largest intermediate) found so far and by paths that cost more
    than ``cutoff_flops_factor`` times the best seen at the same depth;
    outer products only where no pair shares an index (opt_einsum 3.4
    ``paths.branch``, its ``BranchBound`` with the "memory-removed"
    cost)."""
    _check_memory_limit(memory_limit)
    if nbranch is not None and nbranch < 1:
        raise ValueError(f"nbranch must be at least 1, got {nbranch}")
    inputs = tuple(map(frozenset, inputs))
    output = frozenset(output)
    sizes = {k: _size(k, size_dict) for k in inputs}
    cache: Dict[Tuple[FrozenSet, FrozenSet], Tuple[FrozenSet, int]] = {}
    best = {"flops": float("inf"), "size": float("inf"), "path": None}
    progress: Dict[int, float] = defaultdict(lambda: float("inf"))

    def walk(path, inputs, remaining, flops, size):
        if len(remaining) == 1:
            best.update(flops=flops, size=size, path=path)
            return

        def assess(i, j):
            k1, k2 = inputs[i], inputs[j]
            if (k1, k2) not in cache:
                cache[k1, k2] = _pair(inputs, output, remaining, i, j,
                                      size_dict)
            k12, flops12 = cache[k1, k2]
            if k12 not in sizes:
                sizes[k12] = _size(k12, size_dict)
            new_flops, new_size = flops + flops12, max(size, sizes[k12])
            if not (new_flops, new_size) < (best["flops"], best["size"]):
                return None
            if new_flops < progress[len(inputs)]:
                progress[len(inputs)] = new_flops
            elif new_flops > cutoff_flops_factor * progress[len(inputs)]:
                return None
            cost = sizes[k12] - sizes[k1] - sizes[k2]
            return cost, flops12, new_flops, new_size, (i, j), k12

        candidates: list = []
        for outer in (False, True):
            for i, j in itertools.combinations(remaining, 2):
                if i > j:
                    i, j = j, i
                if not outer and inputs[i].isdisjoint(inputs[j]):
                    continue
                candidate = assess(i, j)
                if candidate:
                    heapq.heappush(candidates, candidate)
            if candidates:
                break
        taken = 0
        while (nbranch is None or taken < nbranch) and candidates:
            _, _, new_flops, new_size, (i, j), k12 = heapq.heappop(
                candidates)
            walk(path + ((i, j),), inputs + (k12,),
                 (remaining - {i, j}) | {len(inputs)}, new_flops, new_size)
            taken += 1

    walk((), inputs, set(range(len(inputs))), 0, 0)
    return ssa_to_linear(best["path"])


branch_all = functools.partial(branch, nbranch=None)
branch_2 = functools.partial(branch, nbranch=2)
branch_1 = functools.partial(branch, nbranch=1)


def greedy(inputs, output, size_dict, memory_limit=None) -> Path:
    """Three stages (opt_einsum 3.4 ``paths.greedy`` with its default
    chooser and "memory-removed" cost): Hadamard products of operands with
    equal index sets; then, repeatedly, the pair sharing an index whose
    result shrinks memory the most (ties to the lower ids); then outer
    products, smallest first."""
    _check_memory_limit(memory_limit)
    if len(inputs) == 1:
        return [(0,)]
    fs = [frozenset(x) for x in inputs]
    # an index on every operand cannot be contracted before the last step
    output = frozenset(output) | frozenset.intersection(*fs)
    remaining: Dict[FrozenSet, int] = {}
    ssa_ids = itertools.count(len(fs))
    ssa_path: List[Tuple[int, int]] = []
    for ssa_id, key in enumerate(fs):
        if key in remaining:
            ssa_path.append((remaining[key], ssa_id))
            remaining[key] = next(ssa_ids)
        else:
            remaining[key] = ssa_id
    dim_to_keys: Dict[object, Set[FrozenSet]] = defaultdict(set)
    for key in remaining:
        for dim in key - output:
            dim_to_keys[dim].add(key)
    ref = {count: {d for d, keys in dim_to_keys.items()
                   if len(keys) >= count} - output for count in (2, 3)}
    footprints = {key: _size(key, size_dict) for key in remaining}
    queue: list = []

    def candidate(k1, k2):
        either, two = k1 | k2, k1 & k2
        k12 = (either & output) | (two & ref[3]) | ((either - two) & ref[2])
        cost = _size(k12, size_dict) - footprints[k1] - footprints[k2]
        id1, id2 = remaining[k1], remaining[k2]
        if id1 > id2:
            k1, id1, k2, id2 = k2, id2, k1, id1
        return (cost, id2, id1), k1, k2, k12

    def push(k1, k2s):
        heapq.heappush(queue, min(candidate(k1, k2) for k2 in k2s))

    for keys in dim_to_keys.values():
        keys = sorted(keys, key=remaining.__getitem__)
        for i, k1 in enumerate(keys[:-1]):
            push(k1, keys[i + 1:])
    while queue:
        _, k1, k2, k12 = heapq.heappop(queue)
        if k1 not in remaining or k2 not in remaining:
            continue  # an operand of this candidate is already merged
        ssa_path.append((remaining.pop(k1), remaining.pop(k2)))
        for dim in k1 - output:
            dim_to_keys[dim].remove(k1)
        for dim in k2 - output:
            dim_to_keys[dim].remove(k2)
        if k12 in remaining:
            ssa_path.append((remaining[k12], next(ssa_ids)))
        else:
            for dim in k12 - output:
                dim_to_keys[dim].add(k12)
        remaining[k12] = next(ssa_ids)
        for dim in (k1 | k2) - output:
            count = len(dim_to_keys[dim])
            for c in (2, 3):
                if count >= c:
                    ref[c].add(dim)
                else:
                    ref[c].discard(dim)
        footprints[k12] = _size(k12, size_dict)
        k2s = {k for dim in k12 for k in dim_to_keys[dim]} - {k12}
        if k2s:
            push(k12, k2s)
    final = [(_size(key & output, size_dict), ssa_id, key)
             for key, ssa_id in remaining.items()]
    heapq.heapify(final)
    _, id1, k1 = heapq.heappop(final)
    while final:
        _, id2, k2 = heapq.heappop(final)
        ssa_path.append((min(id1, id2), max(id1, id2)))
        k12 = (k1 | k2) & output
        _, id1, k1 = heapq.heappushpop(
            final, (_size(k12, size_dict), next(ssa_ids), k12))
    return ssa_to_linear(ssa_path)


_ALGORITHMS = {"optimal": optimal, "greedy": greedy, "branch": branch_all,
               "branch-2": branch_2, "branch-1": branch_1}


def _resolve_algorithm(algorithm: PathAlgorithm) -> Callable:
    if callable(algorithm):
        return algorithm
    if algorithm == "auto":
        raise ValueError("resolve 'auto' via auto_algorithm() first")
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown path algorithm {algorithm!r}")
    return _ALGORITHMS[algorithm]


def native_optimal_path(input_sets, output_set, size_dict,
                        memory_limit=None):
    """Exact optimal path from the native (C++) subset-DP scheduler
    (:mod:`tensornetwork_tpu_torch.native`), in the path convention above.
    Returns ``None`` for networks the adjacency model cannot represent:
    more than :data:`NATIVE_MAX_OPERANDS` operands, or hyper-edges (a
    symbol shared by 3+ operands, or an output symbol shared by 2)."""
    from tensornetwork_tpu_torch import native
    n = len(input_sets)
    if n > NATIVE_MAX_OPERANDS:
        return None
    adj = np.zeros((n, n))
    for sym in {x for g in input_sets for x in g}:
        holders = [k for k in range(n) if sym in input_sets[k]]
        ld = np.log10(size_dict[sym])
        if len(holders) == 1:
            adj[holders[0], holders[0]] += ld
        elif len(holders) == 2 and sym not in output_set:
            i, k = holders
            adj[i, k] += ld
            adj[k, i] += ld
        else:
            return None
    merges, _ = native.optimal_order_masks(adj)
    current = [1 << i for i in range(n)]
    path = []
    for (ma, mb) in merges:
        i = current.index(int(ma))
        j = current.index(int(mb))
        path.append(tuple(sorted((i, j))))
        current = [c for k, c in enumerate(current) if k not in (i, j)]
        current.append(int(ma) | int(mb))
    return path


def _native_or(fallback: Callable) -> Callable:
    def algo(input_sets, output_set, size_dict, memory_limit=None):
        path = native_optimal_path(input_sets, output_set, size_dict,
                                   memory_limit)
        if path is not None:
            return path
        return fallback(input_sets, output_set, size_dict, memory_limit)
    return algo


def auto_algorithm(n_operands: int) -> Callable:
    """The JAX package's size policy: the native exact solver wherever the
    network fits it, else by size ``optimal`` (< 5 operands), ``branch``
    (< 7), ``branch-2`` (< 9), ``branch-1`` (< 15), ``greedy``."""
    if n_operands < 5:
        return _native_or(optimal)
    if n_operands < 7:
        return _native_or(branch_all)
    if n_operands < 9:
        return _native_or(branch_2)
    if n_operands < 15:
        return _native_or(branch_1)
    if n_operands < 19:
        return _native_or(greedy)
    return greedy


def get_pair_path(
    input_sets: Sequence[Set],
    output_set: Set,
    size_dict: dict,
    algorithm: PathAlgorithm = "auto",
) -> List[Tuple[int, int]]:
    """Pairwise contraction path [(i, j), ...] over operand indices.

    Indices refer to the *current* operand list at each step, where the two
    contracted operands are removed and their result is appended.  A
    single-operand step (i,) becomes (i, i)."""
    if len(input_sets) == 1:
        return []
    if isinstance(algorithm, str) and algorithm == "auto":
        algorithm = auto_algorithm(len(input_sets))
    fn = _resolve_algorithm(algorithm)
    path = fn([set(s) for s in input_sets], set(output_set), dict(size_dict))
    out = []
    for step in path:
        if len(step) == 2:
            out.append((step[0], step[1]))
        elif len(step) == 1:
            out.append((step[0], step[0]))
        else:
            raise ValueError("non-pairwise path steps are not supported")
    return out


def solve_con_order(
    structure: Sequence[Sequence[int]],
    shapes: Sequence[Tuple[int, ...]],
    method: str = "greedy",
) -> List[int]:
    """Turn a pairwise path into an ncon ``con_order`` label sequence.

    The ncon engine resolves labels front-to-back, contracting all shared
    labels of the holding pair at once, so emitting each path step's shared
    labels in step order reproduces the solved pair schedule.
    """
    input_sets = []
    size_dict: dict = {}
    for labels, shape in zip(structure, shapes):
        input_sets.append(set(labels))
        for l, d in zip(labels, shape):
            size_dict[l] = max(size_dict.get(l, 1), int(d))
    output_set = {l for l in size_dict if l < 0}
    pairs = get_pair_path(input_sets, output_set, size_dict, method)
    pools: List[Set] = [set(s) for s in input_sets]
    con_order: List[int] = []
    seen: Set[int] = set()
    for (i, j) in pairs:
        a, b = pools[i], pools[j]
        if i == j:
            pools = [p for k, p in enumerate(pools) if k != i] + [a]
            continue
        rest: Set = set().union(*(p for k, p in enumerate(pools)
                                  if k not in (i, j))) | output_set
        shared = {l for l in (a & b) if l > 0 and l not in rest}
        for l in sorted(shared):
            if l not in seen:
                con_order.append(l)
                seen.add(l)
        pools = [p for k, p in enumerate(pools) if k not in (i, j)] + [
            (a | b) - shared]
    # positive labels no step covers (traces, sums, batch leftovers)
    for l in sorted({l for labels in structure for l in labels if l > 0}):
        if l not in seen:
            con_order.append(l)
            seen.add(l)
    return con_order


def path_cost(
    structure: Sequence[Sequence[int]],
    shapes: Sequence[Tuple[int, ...]],
    con_order: Sequence[int],
) -> float:
    """FLOP count of an ncon contraction order (the plan's own count)."""
    from tensornetwork_tpu_torch.ops.ncon import compile_plan
    plan = compile_plan(tuple(tuple(l) for l in structure),
                        tuple(con_order), None)
    return float(plan.flops([tuple(s) for s in shapes]))
