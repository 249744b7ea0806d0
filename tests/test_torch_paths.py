"""The port's contraction-path solvers against the JAX package's, on the
CPU.

The port writes ``optimal``, ``greedy`` and the ``branch`` family itself
(the card's machine has no opt_einsum).  On every test network its path
costs no more than the JAX package's path from the same algorithm name
(the same cost for ``optimal``), and on random networks it is the very
path opt_einsum 3.4 returns.  The native C++ solver is the port's own
copy, built by g++ into the port's build directory; a failed build
raises.
"""
import importlib

import numpy as np
import opt_einsum
import pytest

from tensornetwork_tpu.contractors import custom_path_solvers as JS
from tensornetwork_tpu_torch import native
from tensornetwork_tpu_torch.contractors import custom_path_solvers as TS
from tensornetwork_tpu_torch.ops import paths as TP

JP = importlib.import_module("tensornetwork_tpu.ops.paths")
ALGORITHMS = ("optimal", "greedy", "branch", "branch-2", "branch-1", "auto")


def _mps_norm(N, chi, d=2):
    """<psi|psi> of an open MPS: ket bonds 1..N+1, bra bonds N+2..2N+2,
    physical 2N+3.., the end bonds of dimension 1."""
    structure, shapes = [], []
    for bond0, phys in ((1, 2 * N + 3), (N + 2, 2 * N + 3)):
        for i in range(N):
            structure.append((bond0 + i, phys + i, bond0 + i + 1))
            shapes.append((1 if i == 0 else chi, d,
                           1 if i == N - 1 else chi))
    return structure, shapes


def _peps_norm(L, D):
    """An L x L double-layer PEPS norm: one tensor per site, bonds D^2."""
    def h(r, c):
        return 1 + r * (L - 1) + c

    def v(r, c):
        return 1 + L * (L - 1) + r * L + c
    structure, shapes = [], []
    for r in range(L):
        for c in range(L):
            labels = [x for x in (h(r, c - 1) if c else None,
                                  h(r, c) if c < L - 1 else None,
                                  v(r - 1, c) if r else None,
                                  v(r, c) if r < L - 1 else None)
                      if x is not None]
            structure.append(tuple(labels))
            shapes.append((D * D,) * len(labels))
    return structure, shapes


def _random_network(seed, n):
    """n tensors, labels shared by 2 (contracted), 3 (batch) or 1 (open)."""
    rng = np.random.default_rng(seed)
    structure = [[] for _ in range(n)]
    dims = {}
    for label in range(1, 3 * n):
        holders = rng.choice(n, size=min(n, int(rng.choice([2, 2, 2, 3]))),
                             replace=False)
        for k in holders:
            structure[k].append(label)
        dims[label] = int(rng.integers(2, 6))
    for k in range(n):
        if rng.random() < 0.4 or not structure[k]:
            structure[k].append(-1 - k)
            dims[-1 - k] = int(rng.integers(2, 4))
    shapes = [tuple(dims[l] for l in labels) for labels in structure]
    return [tuple(s) for s in structure], shapes


NETWORKS = {
    "mps4": _mps_norm(4, 8),
    "peps3": _peps_norm(3, 2),
    "ring": ([(i + 1, (i + 1) % 6 + 1) for i in range(6)],
             [(2, 3), (3, 4), (4, 2), (2, 5), (5, 3), (3, 2)]),
    "star": ([(1, 2, 3, 4), (1, -1), (2, 5), (3, 5), (4, -2)],
             [(2, 3, 4, 5), (2, 3), (3, 6), (4, 6), (5, 2)]),
    "random5": _random_network(1, 5),
    "random6": _random_network(2, 6),
    "random9": _random_network(3, 9),
}


def _cost(pkg, name, method):
    structure, shapes = NETWORKS[name]
    order = pkg.solve_con_order(structure, shapes, method=method)
    return pkg.path_cost(structure, shapes, order)


# the exhaustive search takes minutes at 9 tensors, in both packages
CASES = [(name, method) for name in sorted(NETWORKS) for method in ALGORITHMS
         if not (method == "optimal" and len(NETWORKS[name][0]) > 8)]


@pytest.mark.parametrize("name, method", CASES)
def test_path_cost_no_higher_than_jax(name, method):
    port, ref = _cost(TP, name, method), _cost(JP, name, method)
    if method == "optimal":
        assert port == ref
    else:
        assert port <= ref


OE = {"optimal": opt_einsum.paths.optimal, "greedy": opt_einsum.paths.greedy,
      "branch": opt_einsum.paths.branch_all,
      "branch-2": opt_einsum.paths.branch_2,
      "branch-1": opt_einsum.paths.branch_1}


@pytest.mark.parametrize("method", sorted(OE))
def test_same_path_as_opt_einsum(method):
    """The port's algorithms take opt_einsum 3.4's own path, ties and all,
    on 60 random networks of 2-6 tensors (batch and open labels too)."""
    rng = np.random.default_rng(11)
    for trial in range(60):
        n = int(rng.integers(2, 7))
        structure, shapes = _random_network(100 + trial, n)
        inputs = [set(labels) for labels in structure]
        sizes = {l: d for labels, s in zip(structure, shapes)
                 for l, d in zip(labels, s)}
        output = {l for l in sizes if l < 0}
        want = [tuple(p) for p in OE[method](inputs, output, sizes)]
        assert TP._resolve_algorithm(method)(inputs, output, sizes) == want


def test_ssa_to_linear_and_memory_limit():
    assert TP.ssa_to_linear([(0, 3), (2, 4), (1, 5)]) == [(0, 3), (1, 2),
                                                          (0, 1)]
    with pytest.raises(ValueError, match="memory_limit"):
        TP.greedy([{1}, {1}], set(), {1: 2}, memory_limit=10)
    with pytest.raises(ValueError, match="unknown"):
        TP.get_pair_path([{1}, {1}], set(), {1: 2}, "bogus")


def test_native_solver_matches_jax_native():
    """The port's copy of the C++ solver gives the JAX package's orders
    and costs, and lands in the port's own build directory."""
    JNat = importlib.import_module("tensornetwork_tpu.native")
    rng = np.random.default_rng(5)
    for n in (3, 6, 10, 14):
        adj = np.zeros((n, n))
        for i in range(1, n):
            for j in rng.choice(i, size=min(i, 2), replace=False):
                adj[i, j] = adj[j, i] = np.log10(float(rng.integers(2, 33)))
        mt, ct = native.optimal_order_masks(adj)
        mj, cj = JNat.optimal_order_masks(adj)
        np.testing.assert_array_equal(mt, mj)
        assert ct == cj
        np.testing.assert_array_equal(native.masks_to_index_pairs(mt, n),
                                      JNat.masks_to_index_pairs(mj, n))
    assert native.lib_path().is_file()
    assert native.lib_path().parent.parent == native.BUILD_ROOT
    assert "tensornetwork_tpu_torch" in str(native.BUILD_ROOT)


def test_failed_build_raises(tmp_path, monkeypatch):
    """g++'s errors surface; nothing falls back to the Python solvers."""
    bad = tmp_path / "pathsolver.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.optimal_order_masks(np.ones((3, 3)))
    structure, shapes = NETWORKS["ring"]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TP.solve_con_order(structure, shapes, method="auto")


def test_native_fallback_rules():
    """Hyper-edges (a label on 3 operands, an open label on 2) and more
    than 22 operands go to the Python algorithm, as in the JAX package."""
    inputs = [{1, 2}, {1, 3}, {1, 4}]
    sizes = {1: 2, 2: 3, 3: 3, 4: 3}
    assert TP.native_optimal_path(inputs, {2, 3, 4}, sizes) is None
    assert TP.native_optimal_path([{-1, 2}, {-1, 2}], {-1},
                                  {-1: 2, 2: 3}) is None
    ring = [{i, (i + 1) % 23} for i in range(23)]
    assert TP.native_optimal_path(ring, set(), dict.fromkeys(range(23),
                                                             2)) is None
    assert TP.auto_algorithm(30) is TP.greedy
    for n in (3, 6, 8, 12, 16):
        assert TP.auto_algorithm(n).__name__ == "algo"


def _replay(adj, order):
    costs = []
    for (i, j) in np.asarray(order).T:
        costs.append(TS._pair_cost(adj, i, j))
        adj = TS._contract_rows(adj, int(i), int(j))
    return TS._log10_sum(costs)


@pytest.mark.parametrize("n", [4, 6, 7])
def test_custom_path_solvers_match_jax(n):
    rng = np.random.default_rng(n)
    adj = np.zeros((n, n))
    for i in range(1, n):
        j = int(rng.integers(0, i))
        adj[i, j] = adj[j, i] = np.log10(float(rng.integers(2, 32)))
    adj[0, 0] = np.log10(3.0)
    for fn in ("greedy_size_solve", "greedy_cost_solve"):
        ot, ct = getattr(TS, fn)(adj)
        oj, cj = getattr(JS, fn)(adj)
        np.testing.assert_array_equal(ot, oj)
        assert ct == cj
    for kw in ({}, {"max_branch": 3}, {"cost_bound": 1e9}):
        ot, ct, optt = TS.full_solve_complete(adj, **kw)
        oj, cj, optj = JS.full_solve_complete(adj, **kw)
        np.testing.assert_array_equal(ot, oj)
        assert (ct, optt) == (cj, optj)
        assert abs(_replay(adj, ot) - ct) < 1e-9


def test_ncon_adapters_match_jax():
    structure, shapes = _mps_norm(3, 4)
    tensors = [np.zeros(s) for s in shapes]
    np.testing.assert_array_equal(TS.ncon_to_adj(tensors, structure),
                                  JS.ncon_to_adj(tensors, structure))
    ct, cost_t, opt_t = TS.ncon_solver(tensors, structure)
    cj, cost_j, opt_j = JS.ncon_solver(tensors, structure)
    np.testing.assert_array_equal(ct, cj)
    assert (cost_t, opt_t) == (cost_j, opt_j)
    assert TS.ncon_cost_check(tensors, structure, ct) == \
        JS.ncon_cost_check(tensors, structure, cj)
    order = np.array([[0, 0], [1, 1]])
    np.testing.assert_array_equal(TS.ord_to_ncon(structure[:3], order),
                                  JS.ord_to_ncon(structure[:3], order))
