"""The port's utils against the JAX package's, on the CPU.

HDF5 snapshots cross between the packages both ways (CopyNodes and edges
to nodes left out included); ``from_topology`` and ``to_graphviz`` give
what the JAX package's give; checkpoints round-trip, and the numpy dict
of the JAX package's ``load_dmrg_state`` restores into the port;
``ncon_flops`` and ``dmrg_sweep_flops`` equal the JAX counts; ``Timer``,
``benchmark`` and ``device_trace`` on the CPU.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import tensornetwork_tpu as J
import tensornetwork_tpu_torch as T
from tensornetwork_tpu.utils import checkpoint as jckpt
from tensornetwork_tpu.utils import profiling as jprof
from tensornetwork_tpu_torch.utils import checkpoint as tckpt
from tensornetwork_tpu_torch.utils import profiling as tprof


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(P, a):
    return torch.from_numpy(np.array(a)) if P is T else a


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _network(P, outside=True):
    """Four nodes, one a CopyNode, and a fifth outside the saved set:
    [a, b, copy, v], with f32/c128/f64 tensors and named edges."""
    rng = np.random.default_rng(7)
    kw = {"device": "cpu"} if P is T else {}
    a = P.Node(_t(P, rng.standard_normal((3, 4)).astype(np.float32)),
               name="a", axis_names=["x", "y"])
    b = P.Node(_t(P, rng.standard_normal((4, 2, 5))
                  + 1j * rng.standard_normal((4, 2, 5))), name="b")
    cn = P.CopyNode(rank=3, dimension=2, name="copy", **kw)
    v = P.Node(_t(P, rng.standard_normal(2)), name="v")
    P.connect(a[1], b[0], name="bond")
    P.connect(b[1], cn[0], name="to_copy")
    P.connect(v[0], cn[1])
    if outside:
        out = P.Node(_t(P, rng.standard_normal(5)), name="outside")
        P.connect(out[0], b[2], name="boundary")
    return [a, b, cn, v]


def _structure(nodes):
    """Everything a snapshot keeps, in plain python and numpy; an edge
    to a node outside ``nodes`` counts as dangling."""
    index = {n: i for i, n in enumerate(nodes)}
    out = []
    for n in nodes:
        edges = []
        for e in n.edges:
            other = e.node2 if e.node1 is n else e.node1
            edges.append((e.name if not e.name.startswith("__") else "",
                          e.is_dangling() or other not in index,
                          index.get(other)))
        out.append((type(n).__name__, n.name, list(n.axis_names),
                    _np(n.tensor), edges))
    return out


def _same_structure(s, r):
    assert len(s) == len(r)
    for (t1, n1, ax1, x1, e1), (t2, n2, ax2, x2, e2) in zip(s, r):
        assert (t1, n1, ax1, e1) == (t2, n2, ax2, e2)
        assert x1.dtype == x2.dtype and x1.shape == x2.shape
        np.testing.assert_array_equal(x1, x2)


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J), (T, T)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_hdf5_crosses_between_the_packages(tmp_path, writer, reader):
    path = str(tmp_path / "net.h5")
    nodes = _network(writer)
    writer.save_nodes(nodes, path)
    kw = {"device": "cpu"} if reader is T else {}
    loaded = reader.load_nodes(path, **kw)
    _same_structure(_structure(loaded), _structure(nodes))
    # the boundary edge comes back dangling, and named
    assert loaded[1][2].is_dangling() and loaded[1][2].name == "boundary"
    assert isinstance(loaded[2], reader.CopyNode) and loaded[2].rank == 3


def test_hdf5_tensors_stay_on_the_device_asked_for(tmp_path):
    path = str(tmp_path / "net.h5")
    T.save_nodes(_network(T), path)
    loaded = T.load_nodes(path, device="meta")
    assert {n.tensor.device.type for n in loaded} == {"meta"}


def _topology(P):
    rng = np.random.default_rng(3)
    A, B, C = (rng.standard_normal(s) for s in ((3, 4), (4, 5), (5, 6)))
    nodes = P.from_topology("Ab,bc,cD", [_t(P, x) for x in (A, B, C)])
    out = P.contractors.greedy(nodes,
                               output_edge_order=[nodes[0][0], nodes[2][1]])
    names = [[e.name for e in n.edges] for n in nodes]
    return _np(out.tensor), names, [n.axis_names for n in nodes]


def test_from_topology_matches_jax():
    (tv, tn_, ta), (jv, jn, ja) = _topology(T), _topology(J)
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    assert (tn_, ta) == (jn, ja)
    with pytest.raises(ValueError):
        T.from_topology("ab,bc", [torch.ones(2, 2)])


@pytest.mark.parametrize("include_all_names", [False, True])
def test_to_graphviz_gives_the_same_source(include_all_names):
    def source(P):
        nodes = _network(P, outside=False)
        nodes[3].name = "__hidden"
        return P.to_graphviz(nodes,
                             include_all_names=include_all_names).source
    t, j = source(T), source(J)
    if include_all_names:   # default edge names count per package
        import re
        t, j = (re.sub(r"__edge_\d+", "__edge", x) for x in (t, j))
    assert t == j


def test_pytree_round_trip(tmp_path):
    tree = {"a": np.random.default_rng(0).standard_normal((3, 3)),
            "nested": {"b": np.arange(5), "c": [torch.ones(2), 3.5]}}
    path = str(tmp_path / "tree.pt")
    tckpt.save_pytree(path, tree)
    out = tckpt.load_pytree(path)
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(out["nested"]["b"].numpy(), np.arange(5))
    assert torch.equal(out["nested"]["c"][0], torch.ones(2))
    assert out["nested"]["c"][1] == 3.5


def test_dmrg_checkpoint_round_trip_and_resume(tmp_path):
    N, chi = 6, 4
    mpo = T.FiniteTFI(-1.0, -1.0, N=N, device="cpu")
    As = T.random_mps_stack(0, N, chi, device="cpu")
    dmrg = T.FiniteDMRG(As, mpo)
    e = dmrg.run_one_site(num_sweeps=2, num_krylov_vecs=8)
    g = torch.Generator().manual_seed(7)
    path = str(tmp_path / "ckpt.pt")
    tckpt.save_dmrg_state(path, dmrg, sweep=2, generator=g)
    state = tckpt.load_dmrg_state(path)
    assert set(state) == {"As", "Ws", "vL", "vR", "energies", "sweep",
                          "rng_state"}
    assert torch.equal(state["rng_state"], g.get_state())
    dmrg2, sweep = tckpt.restore_dmrg(path, device="cpu")
    assert sweep == 2 and dmrg2.energies == dmrg.energies
    assert torch.equal(dmrg2.As, dmrg.As)
    assert torch.equal(dmrg2.mpo.Ws, dmrg.mpo.Ws)
    e2 = dmrg2.run_one_site(num_sweeps=1, num_krylov_vecs=8)
    assert abs(e2 - e) < 1e-6


def test_jax_dmrg_state_restores_into_the_port(tmp_path):
    N, chi = 4, 4
    jmpo = J.models.FiniteTFI(Jx=-1.0, Bz=-0.7, N=N)
    As = np.random.default_rng(2).standard_normal((N, chi, 2, chi))
    jdmrg = J.FiniteDMRG(jax.numpy.asarray(As), jmpo)
    jdmrg.energies = [-1.5, -1.75]
    path = os.path.join(tmp_path, "jax_ckpt")
    jckpt.save_dmrg_state(path, jdmrg, sweep=3)
    state = jckpt.load_dmrg_state(path)
    dmrg, sweep = tckpt.restore_dmrg(state, device="cpu")
    assert sweep == 3 and dmrg.energies == [-1.5, -1.75]
    np.testing.assert_array_equal(dmrg.As.numpy(), As)
    for k in ("Ws", "vL", "vR"):
        np.testing.assert_array_equal(getattr(dmrg.mpo, k).numpy(),
                                      np.asarray(getattr(jmpo, k)))


NETWORKS = [
    ([(-1, 1), (1, -2)], [(4, 5), (5, 6)], None),
    ([(1, -1, 2), (2, 3), (3, 1, -2)], [(3, 4, 5), (5, 6), (6, 3, 7)],
     None),
    ([(1, 2), (2, 3), (3, 1)], [(4, 5), (5, 6), (6, 4)], [3, 1, 2]),
    ([("a", "-x"), ("a", "b"), ("b", "-y")], [(3, 4), (3, 5), (5, 2)],
     ["b", "a"]),
    ([(1, 1, -1)], [(3, 3, 4)], None),
]


@pytest.mark.parametrize("structure,shapes,order", NETWORKS,
                         ids=[f"net{i}" for i in range(len(NETWORKS))])
def test_ncon_flops_equal_the_jax_count(structure, shapes, order):
    assert tprof.ncon_flops(structure, shapes, order) == \
        jprof.ncon_flops(structure, shapes, order)


@pytest.mark.parametrize("args", [(32, 64, 2, 3, 10), (8, 16, 3, 5, 6),
                                  (100, 1024, 2, 3, 10)])
def test_dmrg_sweep_flops_equal_the_jax_count(args):
    assert tprof.dmrg_sweep_flops(*args) == jprof.dmrg_sweep_flops(*args)


def test_timer():
    t = tprof.Timer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    assert t.counts == {"a": 2, "b": 1}
    assert set(t.phases) == {"a", "b"}
    assert "a" in t.report() and "x2" in t.report()


def test_benchmark_keeps_the_jax_keys():
    a = torch.randn(32, 32, dtype=torch.float64)
    res = tprof.benchmark(lambda x: x @ x, a, iters=3, flops=2 * 32 ** 3)
    jres = jprof.benchmark(lambda x: x @ x, np.ones((8, 8)), iters=2,
                           flops=2 * 8 ** 3)
    assert set(res) == set(jres)
    assert res["chip"] == tprof.detect_chip() == "cpu"
    assert res["per_call_s"] > 0 and res["flops_per_s"] > 0
    assert res["mxu_utilization"] is None   # no CPU peak is published
    assert set(tprof.benchmark(lambda: None, iters=1)) == {"compile_s",
                                                           "per_call_s"}


def test_peak_flops_are_the_card_names():
    for name, peaks in tprof.PEAK_FLOPS.items():
        assert name.startswith("NVIDIA")
        assert peaks == {"float32": 67e12, "tf32": 495e12,
                         "bfloat16": 989e12}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        torch.ones(4) @ torch.ones(4)
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
