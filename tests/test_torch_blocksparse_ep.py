"""The port's sector-sharded (EP) block-sparse layer against the JAX
package's (counterparts of tests/test_blocksparse_distributed.py,
test_ep_chain.py and test_ep_capacity.py).

Two spawns of gloo ranks (``torch_ranks.spawn``): world 3 runs
``tensordot_sharded``, ``truncated_svd_distributed`` (both outputs), the
fused chain executor (its all_reduce and its ``reduce="none"``
partials), the per-contraction EP executors, the stored env layout and the
distributed two-site split; world 2 runs ``BatchedSymmetricDMRG`` over an
ep mesh, in the capacity layout and over a dp mesh, with the capacity
layout's collectives counted.  The JAX package runs the same functions on
a ``jax.devices()[:P]`` sub-mesh on the same float64 tensors (its
``randn`` draws the port's bits).  The sector sums have disjoint support,
so the EP results equal the port's single-device ones exactly.  In
process: the chain partition against the JAX package's for any rank
count, the stored layout, the validation errors, and world 1."""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import tensornetwork_tpu.blocksparse as J
import torch_ranks
from tensornetwork_tpu.blocksparse import batched as JBt
from tensornetwork_tpu.blocksparse import distributed as JD
from tensornetwork_tpu.blocksparse import jax_engine as JE
from tensornetwork_tpu.parallel.mesh import make_mesh as jmake_mesh
from tensornetwork_tpu_torch.blocksparse import batched as TBt
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG, _td_skeleton)
from tensornetwork_tpu_torch.parallel import collectives as C
from tensornetwork_tpu_torch.parallel import mesh as Mm

SVD_KWARGS = ({"max_singular_values": 8}, {"max_truncation_error": 0.5},
              {"max_truncation_error": 0.2, "relative": True},
              {"max_singular_values": 5, "max_truncation_error": 0.3})


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _spec(rng, dims, flows, seed):
    return ([rng.integers(-2, 3, d) for d in dims], flows, seed)


def _jax(spec):
    charges, flows, seed = spec
    return J.randn([J.Index(J.U1Charge(c), f) for c, f in zip(charges, flows)],
                   seed=seed, dtype=np.float64)


def _chain_specs(rng, dims):
    cs = [rng.integers(-2, 3, d) for d in dims]
    return [([cs[i], cs[i + 1]], [False, True], 10 + i)
            for i in range(len(dims) - 1)]


def _jmesh(n):
    return jmake_mesh((n,), ("ep",), devices=jax.devices()[:n])


def _run_jax_chain(n, run, datas):
    fn = jax.jit(jax.shard_map(lambda *d: run(*d), mesh=_jmesh(n),
                               in_specs=(P(),) * len(datas), out_specs=P(),
                               check_vma=False))
    return np.asarray(fn(*[jnp.asarray(d) for d in datas]))


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


def test_ep_functions_on_three_ranks(tmp_path):
    rng = np.random.default_rng(0)
    tensordot = [
        (_spec(rng, (6, 7), [False, True], 1),
         None, [[1], [0]]),
        (_spec(rng, (4, 5, 6), [False, True, True], 3),
         None, [[1, 2], [0, 1]])]
    # the second operands share the first ones' contracted charges
    a0 = tensordot[0][0]
    tensordot[0] = (a0, ([a0[0][1], rng.integers(-2, 3, 5)], [False, True],
                         2), [[1], [0]])
    a1 = tensordot[1][0]
    tensordot[1] = (a1, ([a1[0][1], a1[0][2], rng.integers(-2, 3, 3)],
                         [False, False, True], 4), [[1, 2], [0, 1]])
    svd_matrix = _spec(rng, (20, 18), [False, True], 7)
    chain = _chain_specs(np.random.default_rng(21), (8, 9, 7, 8))
    env_parts = np.random.default_rng(1).standard_normal((3, 2, 37))
    res = torch_ranks.spawn("ep_ops", 3, tmp_path, dict(
        tensordot=tensordot, svd_matrix=svd_matrix,
        svd_kwargs=list(SVD_KWARGS), chain=chain, env_nnz=(1, 5, 37),
        env_parts=env_parts, split_seed=3))
    r0 = res[0]
    for r in res[1:]:                      # every rank holds the result
        for key in ("td0_data", "td1_data", "chain", "masked_s"):
            np.testing.assert_array_equal(r[key], r0[key])

    mesh = _jmesh(3)
    for i, (sa, sb, axes) in enumerate(tensordot):
        ja, jb = _jax(sa), _jax(sb)
        oracle = np.tensordot(ja.todense(), jb.todense(), axes)
        np.testing.assert_allclose(r0[f"td{i}"], oracle, rtol=0, atol=1e-12)
        # disjoint sectors: the all_reduce adds exact zeros
        np.testing.assert_array_equal(r0[f"td{i}_data"], r0[f"td{i}_single"])
        jt = JD.tensordot_sharded(ja, jb, axes, mesh)
        np.testing.assert_allclose(r0[f"td{i}_data"], np.asarray(jt.data),
                                   rtol=0, atol=1e-12)

    jm = _jax(svd_matrix)
    for i, kw in enumerate(SVD_KWARGS):
        U, S, V, rest = JD.truncated_svd_distributed(jm, mesh, **kw)
        want = np.sort(np.asarray(S.data))[::-1]
        np.testing.assert_allclose(np.sort(r0[f"svd{i}_S"])[::-1], want,
                                   atol=1e-10)
        np.testing.assert_allclose(np.sort(r0[f"svd{i}_S0"])[::-1], want,
                                   atol=1e-10)
        np.testing.assert_allclose(r0[f"svd{i}_rest"], np.asarray(rest),
                                   atol=1e-10)
        np.testing.assert_allclose(r0[f"svd{i}_rest"], r0[f"svd{i}_rest0"],
                                   atol=1e-10)
        np.testing.assert_allclose(r0[f"svd{i}_rec"], r0[f"svd{i}_rec0"],
                                   atol=1e-10)
        # only the kept triplets (and the discarded tail) reach the host
        k = len(r0[f"svd{i}_S"])
        Rm, Cm = 20, 18
        assert int(r0[f"svd{i}_bytes"]) <= (k * (Rm + Cm + 2)
                                            + len(r0[f"svd{i}_rest"])) * 8
    u, s, vh, kept = JD.truncated_svd_distributed(
        jm, mesh, output="masked", **SVD_KWARGS[0])
    np.testing.assert_array_equal(r0["masked_kept"], np.asarray(kept))
    np.testing.assert_allclose(r0["masked_s"], np.asarray(s), atol=1e-10)
    rec = np.einsum("gij,gj,gjk->gik", r0["masked_u"], r0["masked_s"],
                    r0["masked_vh"])
    jrec = np.einsum("gij,gj,gjk->gik", np.asarray(u), np.asarray(s),
                     np.asarray(vh))
    np.testing.assert_allclose(rec, jrec, atol=1e-10)
    assert int(r0["masked_kept"].sum()) == 8

    # the fused chain: one all_reduce, equal to the single-device chain and
    # to the per-contraction EP executors; its partials have disjoint
    # support and sum to it
    assert int(r0["chain_all_reduces"]) == 1
    np.testing.assert_array_equal(r0["chain"], r0["chain_seq"])
    np.testing.assert_array_equal(r0["chain"], r0["chain_seq_ep"])
    partials = np.stack([r["chain_partial"] for r in res])
    assert (partials != 0).sum(axis=0).max() <= 1
    np.testing.assert_array_equal(partials.sum(axis=0), r0["chain"])
    jmats = [_jax(s) for s in chain]
    stages = [(jmats[0], jmats[1], [[1], [0]])] + [
        (None, m, [[1], [0]]) for m in jmats[2:]]
    jrun, _ = JBt.chain_contraction_plan(stages, ep=(3, "ep"))
    np.testing.assert_allclose(
        r0["chain"], _run_jax_chain(3, jrun, [m.data for m in jmats]),
        rtol=0, atol=1e-12)

    # the stored env layout: reduce-scatter then all-gather is the sum
    for nnz in (1, 5, 37):
        want = env_parts[:, :, :nnz].sum(axis=0)
        L = TBt.env_block_len(nnz, 3)
        for rank, r in enumerate(res):
            np.testing.assert_allclose(r[f"env{nnz}_full"], want, atol=1e-12)
            assert r[f"env{nnz}_stored"].shape == (2, L)
            stored = TBt.env_to_stored(torch.from_numpy(want), 3)
            np.testing.assert_allclose(r[f"env{nnz}_stored"],
                                       stored[:, rank].numpy(), atol=1e-12)

    # the distributed split: the kept blocks exactly, the weights summed
    for absorb in ("right", "left"):
        for k in range(2):
            np.testing.assert_array_equal(r0[f"split_{absorb}{k}_ep"],
                                          r0[f"split_{absorb}{k}"])
        np.testing.assert_allclose(r0[f"split_{absorb}2_ep"],
                                   r0[f"split_{absorb}2"], rtol=1e-12)


def test_symmetric_dmrg_ep_capacity_dp_on_two_ranks(tmp_path):
    N, chi = 6, 10
    res = torch_ranks.spawn("ep_solver", 2, tmp_path, dict(
        N=N, chi=chi, B=2, m=8, seed=0, sweeps=2))
    r0, r1 = res
    for r in res:
        # disjoint sector sums: every sharded mode is the single-device run
        for mode in ("ep", "cap"):
            np.testing.assert_array_equal(r[f"{mode}_E"], r["single_E"])
            np.testing.assert_array_equal(r[f"{mode}_E2"], r["single_E2"])
            np.testing.assert_allclose(r[f"{mode}_terr"], r["single_terr"],
                                       rtol=1e-10, atol=1e-14)
        # dp: each rank one realization, the energies gathered
        np.testing.assert_allclose(r["dp_E"], r["single_E"], rtol=1e-10)
        # capacity: the canon step's env traffic is one all-gather in and
        # one reduce-scatter out, no all_reduce
        assert tuple(r["canon_counts"]) == (0, 1, 1)
        assert int(r["canon_stored_len"]) == -(-int(r["canon_nnz"]) // 2)
        np.testing.assert_array_equal(r["canon_env_cap"], r["canon_env_rep"])
    # the boundary env: rank 0 stores its single entry, rank 1 padding
    np.testing.assert_array_equal(r0["cap_boundary"], np.ones((2, 1)))
    np.testing.assert_array_equal(r1["cap_boundary"], np.zeros((2, 1)))


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def _chain_raws(E, mats, out_skel):
    raws, prev = [], None
    for k in range(len(mats) - 1):
        raw = E._build_plan(mats[0] if k == 0 else prev, mats[k + 1], [1],
                            [0])
        raws.append(raw)
        prev = out_skel(raw)
    return raws


@pytest.mark.parametrize("ndev", [1, 2, 3, 5, 8, 16])
def test_partition_matches_jax(ndev):
    specs = _chain_specs(np.random.default_rng(4), (12, 12, 12, 12))
    tr = _chain_raws(TE, [torch_ranks.bst_from_spec(s) for s in specs],
                     TE.out_skeleton)
    jr = _chain_raws(JE, [_jax(s) for s in specs], JE._out_skel_of_raw)
    ta, tb = TE._partition_chain(tr, ndev)
    ja, jb = JE._partition_chain(jr, ndev)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tb, jb)
    for a in ta:
        live = a[a >= 0]
        assert ((live >= 0) & (live < ndev)).all()


@pytest.mark.parametrize("nnz", [1, 7, 8, 37, 256])
def test_env_stored_layout_roundtrip(nnz):
    full = np.random.default_rng(nnz).standard_normal((3, nnz))
    stored = TBt.env_to_stored(torch.from_numpy(full), 8)
    jstored = JBt.env_to_stored(jnp.asarray(full), 8)
    assert stored.shape == (3, 8, TBt.env_block_len(nnz, 8))
    np.testing.assert_array_equal(stored.numpy(), np.asarray(jstored))
    np.testing.assert_array_equal(TBt.env_from_stored(stored, nnz).numpy(),
                                  full)


def test_chain_validation_errors(world1):
    mats = [torch_ranks.bst_from_spec(s)
            for s in _chain_specs(np.random.default_rng(2), (5, 6, 5))]
    group = Mm.axis_group(Mm.make_mesh((1,), ("ep",), device="cpu"), "ep")
    with pytest.raises(ValueError, match="explicit axes"):
        TBt.chain_contraction_plan([(mats[0], mats[1], 1)], ep=(1, group))
    with pytest.raises(ValueError, match="stage 0"):
        TE.make_chain_executor([(None, mats[1], [1], [0])], 1, group)
    v1 = torch_ranks.bst_from_spec(([np.arange(-2, 3)], [False], 1))
    v2 = torch_ranks.bst_from_spec(([np.arange(-2, 3)], [True], 2))
    with pytest.raises(ValueError, match="produce tensors"):
        TE.make_chain_executor([(v1, v2, [0], [0])], 1, group)
    run, _ = TBt.chain_contraction_plan(
        [(mats[0], mats[1], [[1], [0]])], ep=(1, group))
    with pytest.raises(TypeError, match="data vectors"):
        run(torch.zeros(3))
    # one executor a structure and rank count
    run2, _ = TBt.chain_contraction_plan(
        [(mats[0], mats[1], [[1], [0]])], ep=(1, group))
    assert run2 is run


def test_ep_executors_on_world_one(world1):
    """At one rank every EP executor is the single-device one, bit for bit,
    and issues its one collective."""
    group = Mm.axis_group(Mm.make_mesh((1,), ("ep",), device="cpu"), "ep")
    mats = [torch_ranks.bst_from_spec(s)
            for s in _chain_specs(np.random.default_rng(9), (6, 7, 6, 5))]
    f1, t1 = TBt.contraction_plan(mats[0], mats[1], [[1], [0]])
    f2, _ = TBt.contraction_plan(t1, mats[2], [[1], [0]])
    seq = f2(f1(mats[0].data, mats[1].data), mats[2].data)
    e1, _ = TBt.contraction_plan(mats[0], mats[1], [[1], [0]], ep=(1, group))
    C.reset_counts()
    np.testing.assert_array_equal(e1(mats[0].data, mats[1].data).numpy(),
                                  f1(mats[0].data, mats[1].data).numpy())
    assert C.counts["all_reduce"] == 1
    stages = [(mats[0], mats[1], [[1], [0]]), (None, mats[2], [[1], [0]])]
    for reduce in ("psum", "none"):
        run, _ = TBt.chain_contraction_plan(stages, (1, group),
                                            reduce=reduce)
        np.testing.assert_array_equal(
            run(*(m.data for m in mats)).numpy(), seq.numpy())
    skel = TBt.uniform_skeleton_mps(6, 10, dtype=torch.float64,
                                    device="cpu")
    tp = TBt.TwoSiteSplitPlan(_td_skeleton(skel[2], skel[3], [[2], [0]]),
                              skel[2], skel[3])
    theta = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, _td_skeleton(skel[2], skel[3], [[2], [0]]).data.shape[0])))
    for got, want in zip(tp(theta, "right", ep=(1, group)),
                         tp(theta, "right")):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_capacity_requires_ep_mesh():
    N, chi = 4, 6
    skel = TBt.uniform_skeleton_mps(N, chi, dtype=torch.float64,
                                    device="cpu")
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float64, device="cpu")
    data = TBt.random_data_batch(skel, 2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="ep_mesh"):
        BatchedSymmetricDMRG(skel, data, mpo, ep_capacity=True)
