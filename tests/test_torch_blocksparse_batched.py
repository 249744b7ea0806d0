"""The port's batched-realization block-sparse plans against the JAX
package's, on the CPU, at N <= 8 and chi <= 24.

The same skeleton and the same seeded data stacks go through both
packages: the bond-charge profile exactly, the data draws bit for bit,
the batched contraction plan (the port's native batch axis against the
JAX plan under ``vmap``), and the sector polar shift and two-site split
(the port's ``polar_complete`` and ``thin_svd`` on (B, nr, nc) stacks
against the JAX ``ns_polar_complete`` and ``jnp.linalg.svd``): Q and P,
and the split factors, within 1e-10 in float64 (4e-5 in float32), up to
the singular vectors' signs, which are compared through their products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu.blocksparse import batched as JBt
from tensornetwork_tpu_torch.blocksparse import batched as TBt
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stacks(N, chi, B, seed, dtype=np.float64):
    jskel = JBt.uniform_skeleton_mps(N, chi, dtype=dtype)
    tskel = TBt.uniform_skeleton_mps(N, chi, dtype=getattr(torch, np.dtype(
        dtype).name), device="cpu")
    jd = JBt.random_data_batch(jskel, B, seed=seed)
    td = TBt.random_data_batch(tskel, B, seed=seed, device="cpu")
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jskel, tskel, jd, td


def test_bond_profile_and_skeleton_match():
    for N, chi in ((8, 24), (6, 16), (32, 1024)):
        for a, b in zip(JBt.canonical_bond_charges(N, chi),
                        TBt.canonical_bond_charges(N, chi)):
            np.testing.assert_array_equal(a, b)
    jskel, tskel, _, _ = _stacks(8, 24, 2, 0, np.float32)
    assert [t.data.shape[0] for t in jskel] == \
        [t.data.shape[0] for t in tskel]
    assert all(t.dtype == torch.float32 for t in tskel)


@pytest.mark.parametrize("case", ["next site", "gram"])
def test_batched_contraction_plan_matches_vmapped_jax_plan(case):
    jskel, tskel, jd, td = _stacks(6, 16, 3, 1)
    if case == "next site":      # A_2 A_3 over their shared bond
        t2, j2, d2, jd2, axes = (tskel[3], jskel[3], td[3], jd[3],
                                 [[2], [0]])
    else:                        # A_2 with its conjugate: the (l, l') gram
        t2, j2, d2, jd2, axes = (tskel[2].conj(), jskel[2].conj(), td[2],
                                 jd[2], [[1, 2], [1, 2]])
    run, out = TBt.contraction_plan(tskel[2], t2, axes)
    jrun, jout = JBt.contraction_plan(jskel[2], j2, axes)
    got = run(td[2], d2)
    want = jax.vmap(jrun)(jd[2], jd2)
    assert out.data.shape[0] == jout.data.shape[0]
    assert out.data.device.type == "meta"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    # the sector-sharded executor runs on a process group (none here)
    with pytest.raises(RuntimeError, match="process group"):
        TBt.contraction_plan(tskel[2], t2, axes, ep=(2, "ep"))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 4e-5)])
@pytest.mark.parametrize("direction", ["right", "left"])
def test_shift_plan_matches_jax(direction, dtype, tol):
    jskel, tskel, jd, td = _stacks(8, 24, 3, 2, dtype)
    site = 3
    jp = JBt.ShiftPlan(jskel[site], direction)
    tp = TBt.ShiftPlan(tskel[site], direction)
    with jax.default_matmul_precision("highest"):
        jq, jpd = jp(jd[site])
    tq, tpd = tp(td[site])
    assert tq.dtype == td[site].dtype
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=tol)
    np.testing.assert_allclose(tpd.numpy(), np.asarray(jpd), rtol=0,
                               atol=tol)
    # the polar factor of a full-rank block is unique: Q·P rebuilds A
    run, _ = TBt.contraction_plan(
        *((tskel[site], tp.bond_skel, [[2], [0]]) if direction == "right"
          else (tp.bond_skel, tskel[site], [[1], [0]])))
    rec = run(tq, tpd) if direction == "right" else run(tpd, tq)
    np.testing.assert_allclose(rec.numpy(), td[site].numpy(), rtol=0,
                               atol=10 * tol)


def test_shift_plan_keeps_the_isometry_checks():
    # a left-heavy skeleton (bond charges off the canonical profile)
    # violates the right shift's rows >= cols: both packages refuse it
    from tensornetwork_tpu_torch.blocksparse import Index, U1Charge, zeros
    t = zeros([Index(U1Charge(np.array([0])), False),
               Index(U1Charge(np.array([0, 1])), False),
               Index(U1Charge(np.array([0, 0, 1, 1, 1])), True)],
              device="cpu")
    with pytest.raises(ValueError, match="not isometric"):
        TBt.ShiftPlan(t, "right")
    with pytest.raises(ValueError):
        TBt.ShiftPlan(t, "up")


@pytest.mark.parametrize("absorb", ["right", "left"])
def test_two_site_split_plan_matches_jax(absorb):
    jskel, tskel, jd, td = _stacks(6, 16, 3, 4)
    bond = 2
    run, theta_skel = TBt.contraction_plan(tskel[bond], tskel[bond + 1],
                                           [[2], [0]])
    jrun, jtheta = JBt.contraction_plan(jskel[bond], jskel[bond + 1],
                                        [[2], [0]])
    rng = np.random.default_rng(5)
    theta = rng.standard_normal((3, theta_skel.data.shape[0]))
    tp = TBt.TwoSiteSplitPlan(theta_skel, tskel[bond], tskel[bond + 1])
    jp = JBt.TwoSiteSplitPlan(jtheta, jskel[bond], jskel[bond + 1])
    ld, rd, terr = tp(torch.from_numpy(theta), absorb)
    jld, jrd, jterr = jp(jnp.asarray(theta), absorb)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jterr), rtol=1e-10)
    # signs of singular vectors are free: compare the rebuilt blocks
    np.testing.assert_allclose(run(ld, rd).numpy(),
                               np.asarray(jax.vmap(jrun)(jld, jrd)),
                               rtol=0, atol=1e-10)
    # the isometric side is an isometry in both
    iso, skel = (ld, tskel[bond]) if absorb == "right" else \
        (rd, tskel[bond + 1])
    axes = [[0, 1], [0, 1]] if absorb == "right" else [[1, 2], [1, 2]]
    gram, _ = TBt.contraction_plan(skel, skel.conj(), axes)
    g = gram(iso, iso)
    gskel = TE.skeleton(*_gram_structure(skel, axes))
    eye = torch.eye(gskel.shape[0], dtype=g.dtype)
    dense = torch.stack([_dense(gskel, g[b]) for b in range(3)])
    np.testing.assert_allclose(dense.numpy(), eye.expand(3, -1, -1).numpy(),
                               atol=1e-10)
    # the distributed split runs on a process group (none here)
    with pytest.raises(RuntimeError, match="process group"):
        tp(torch.from_numpy(theta), absorb, ep=(2, "ep"))


def _gram_structure(skel, axes):
    from tensornetwork_tpu_torch.blocksparse.tensor import (
        tensordot_structure)
    st = tensordot_structure(skel, skel.conj(), *axes)
    return st["out_charges"], st["out_flows"], st["out_order"]


def _dense(skel, data):
    from tensornetwork_tpu_torch.blocksparse.tensor import BlockSparseTensor
    return BlockSparseTensor(data, skel.flat_charges, skel.flat_flows,
                             skel._order).todense()
