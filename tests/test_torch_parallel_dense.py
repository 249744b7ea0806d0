"""The port's multi-device layer on dense MPS against the JAX package's.

dp (``BatchedDMRG(mesh=)``), tp (``TPShardedDMRG``, one- and two-site),
sp (``DistributedDMRG``, the sequential wave and red/black, one- and
two-site) and dp x tp run on gloo ranks spawned by ``torch_ranks.spawn``
(two spawns: world 2 and world 4); the JAX package runs the same
functions on a ``jax.devices()[:P]`` sub-mesh of the 8-device virtual
mesh, on the same float64 inputs made with numpy, with the same Lanczos
and Ritz methods (the port's sp and tp solve with the plain recurrence,
the JAX package's off-TPU ``"xla"`` route).  Energies agree to 1e-10
relative with the JAX package and with the port's unsharded sweeps.  In
process, on a world-1 gloo group: the sharded paths against the unsharded
ones, and K1's block contract against ``heff_matvec_reference``.
"""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from tensornetwork_tpu.models import FiniteTFI as JTFI
from tensornetwork_tpu.parallel import batch as jbatch
from tensornetwork_tpu.parallel.mesh import make_mesh as jmake_mesh
from tensornetwork_tpu.parallel.sweep import DistributedDMRG as JDist
from tensornetwork_tpu.parallel.tp import TPShardedDMRG as JTP
from tensornetwork_tpu_torch import FiniteTFI
from tensornetwork_tpu_torch.models import dmrg as tdmrg
from tensornetwork_tpu_torch.ops import kernels as K
from tensornetwork_tpu_torch.parallel import mesh as Mm
from tensornetwork_tpu_torch.parallel.batch import (BatchedDMRG,
                                                    batched_one_site_sweep)
from tensornetwork_tpu_torch.parallel.sweep import DistributedDMRG
from tensornetwork_tpu_torch.parallel.tp import TPShardedDMRG

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank, for this test only."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _state(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) / np.sqrt(shape[-2] * shape[-1])


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return jmake_mesh(shape, names, devices=jax.devices()[:n])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _tp_unsharded(As, mpo, m, sweeps, fn):
    res, out = None, []
    for _ in range(sweeps):
        res = fn(torch.from_numpy(As) if res is None else res.As, mpo.Ws,
                 mpo.vL, mpo.vR, num_krylov_vecs=m, lanczos_impl="plain",
                 renvs=None if res is None else res.renvs)
        out.append(float(res.energy))
    return out


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


def test_dp_tp_sp_on_two_ranks(tmp_path):
    """World 2: dp, tp (one- and two-site) and the sequential sp wave
    (one- and two-site), each against the JAX package at P=2 and the
    port's unsharded path."""
    dp = dict(As=_state(0, (4, 6, 8, 2, 8)), mpo=(1.0, 0.8), m=8, sweeps=2)
    tp = dict(As=_state(1, (8, 16, 2, 16)), mpo=(1.0, 0.7), m=8, sweeps=2)
    sp = {"seq": dict(As=_state(2, (8, 8, 2, 8)), mpo=(-1.0, -0.6), m=10,
                      inner=1, colors=2, two_site=False, iters=2),
          "two": dict(As=_state(3, (8, 8, 2, 8)), mpo=(-1.0, -0.8), m=8,
                      inner=1, colors=2, two_site=True, iters=2)}
    res = torch_ranks.spawn("dense", 2, tmp_path,
                            dict(dp=dp, tp=tp, sp=sp))
    r0, r1 = res

    # dp: each rank swept B/2, the energies gathered on both
    assert int(r0["dp_local_B"]) == int(r1["dp_local_B"]) == 2
    np.testing.assert_array_equal(r0["dp_E"], r1["dp_E"])
    jm = JTFI(*dp["mpo"], N=6)
    je = jbatch.BatchedDMRG(jnp.asarray(dp["As"]), jm,
                            mesh=_jmesh((2,), ("data",))).run_one_site(
        num_sweeps=dp["sweeps"], num_krylov_vecs=dp["m"])
    assert _rel(r0["dp_E"], je) < RTOL
    mpo = FiniteTFI(*dp["mpo"], N=6, device="cpu")
    te = BatchedDMRG(torch.from_numpy(dp["As"]), mpo).run_one_site(
        num_sweeps=dp["sweeps"], num_krylov_vecs=dp["m"])
    assert _rel(r0["dp_E"], te.numpy()) < RTOL

    # tp: the right bond split, the energies of every sweep
    N, chi = 8, 16
    assert tuple(r0["tp_shape_before"]) == (N, chi, 2, chi // 2)
    assert tuple(r1["tp_shape_after"]) == (N, chi, 2, chi // 2)
    np.testing.assert_array_equal(r0["tp_E"], r1["tp_E"])
    np.testing.assert_array_equal(r0["tp_state"], r1["tp_state"])
    jm = JTFI(*tp["mpo"], N=N)
    jtp = JTP(jnp.asarray(tp["As"]), jm, _jmesh((2,), ("model",)),
              num_krylov_vecs=tp["m"])
    jtp.run_one_site(num_sweeps=tp["sweeps"], tol=0)
    assert _rel(r0["tp_E"], jtp.energies) < RTOL
    jtp2 = JTP(jnp.asarray(tp["As"]), jm, _jmesh((2,), ("model",)),
               num_krylov_vecs=tp["m"])
    jtp2.run_two_site(num_sweeps=tp["sweeps"])
    assert _rel(r0["tp2_E"], jtp2.energies) < RTOL
    mpo = FiniteTFI(*tp["mpo"], N=N, device="cpu")
    assert _rel(r0["tp_E"], _tp_unsharded(tp["As"], mpo, tp["m"],
                                          tp["sweeps"],
                                          tdmrg.one_site_sweep)) < RTOL
    assert _rel(r0["tp2_E"], _tp_unsharded(tp["As"], mpo, tp["m"],
                                           tp["sweeps"],
                                           tdmrg.two_site_sweep)) < RTOL
    # the collectives of a rank: a site's panel gathered for its QR (and
    # in the reverse pass for the product with Lm) and its left env's rows,
    # a reduce-scatter a matvec and a right env, the Lanczos dots (4 a
    # step, 2 more a solve) and a norm a left-to-right site; the first
    # sweep's prepass adds a gather and a reduce-scatter a site
    m, S = tp["m"], tp["sweeps"]
    assert tuple(r0["tp_counts"]) == (S * N * (5 + 8 * m),
                                      S * N * (2 * m + 1) + N,
                                      S * 4 * N + N)

    # sp: the sequential wave (num_colors = P), one- and two-site
    for name, t in sp.items():
        jm = JTFI(*t["mpo"], N=8)
        jd = JDist(jnp.asarray(t["As"]), jm, _jmesh((2,), ("sp",)),
                   num_krylov_vecs=t["m"], inner_sweeps=t["inner"],
                   num_colors=t["colors"], two_site=t["two_site"])
        jd.run(num_iterations=t["iters"], tol=0)
        np.testing.assert_array_equal(r0[f"sp_{name}_E"], r1[f"sp_{name}_E"])
        assert _rel(r0[f"sp_{name}_E"], jd.energies) < RTOL, name
        assert _rel(r0[f"sp_{name}_energy"], jd.energy()) < RTOL, name


def test_dptp_shards_and_red_black_on_four_ranks(tmp_path):
    """World 4: dp x tp on a ("data", "model") 2 x 2 mesh against the JAX
    dry run's sharded batched sweep, the tp shards (N, chi, d, chi/P)
    before and after a sweep at chi=32, and red/black sp."""
    dptp = dict(As=_state(4, (2, 6, 8, 2, 8)), mpo=(-1.0, -1.0), m=6,
                shape=(2, 2))
    tp_shape = dict(As=_state(5, (6, 32, 2, 32)), mpo=(1.0, 1.0), m=5)
    # chi=4: two-site blocks make full-rank boundary norms (a rank-
    # deficient one puts its eigenvalues near the projection cut, where
    # 1/sqrt amplifies rounding past 1e-10 in either package)
    sp = {"rb": dict(As=_state(6, (8, 4, 2, 4)), mpo=(-1.0, -1.0), m=8,
                     inner=2, colors=2, two_site=False, iters=2)}
    res = torch_ranks.spawn("dense", 4, tmp_path,
                            dict(dptp=dptp, tp_shape=tp_shape, sp=sp))
    for r in res:
        assert tuple(r["tps_before"]) == (6, 32, 2, 8)
        assert tuple(r["tps_after"]) == (6, 32, 2, 8)
        assert tuple(r["dptp_local_shape"]) == (1, 6, 8, 2, 4)
        np.testing.assert_array_equal(r["dptp_E"], res[0]["dptp_E"])
    # the JAX dry run's dp x tp sweep: batch over "data", right bond over
    # "model", its batched defaults (polar gauge, power Ritz, no reorth)
    mesh = _jmesh((2, 2), ("data", "model"))
    jm = JTFI(*dptp["mpo"], N=6)
    rep = NamedSharding(mesh, P())
    with mesh:
        jres = jbatch.batched_one_site_sweep(
            jax.device_put(jnp.asarray(dptp["As"]), NamedSharding(
                mesh, P("data", None, None, None, "model"))),
            jax.device_put(jm.Ws, rep), jax.device_put(jm.vL, rep),
            jax.device_put(jm.vR, rep), num_krylov_vecs=dptp["m"])
    assert _rel(res[0]["dptp_E"], jres.energy) < RTOL
    mpo = FiniteTFI(*dptp["mpo"], N=6, device="cpu")
    tres = batched_one_site_sweep(
        torch.from_numpy(dptp["As"]), mpo.Ws, mpo.vL, mpo.vR,
        num_krylov_vecs=dptp["m"], lanczos_impl="plain")
    assert _rel(res[0]["dptp_E"], tres.energy.numpy()) < RTOL
    # red/black: half the blocks a phase, two inner sweeps
    t = sp["rb"]
    jd = JDist(jnp.asarray(t["As"]), JTFI(*t["mpo"], N=8),
               _jmesh((4,), ("sp",)), num_krylov_vecs=t["m"],
               inner_sweeps=t["inner"], num_colors=t["colors"])
    jd.run(num_iterations=t["iters"], tol=0)
    assert _rel(res[0]["sp_rb_E"], jd.energies) < RTOL
    assert _rel(res[0]["sp_rb_energy"], jd.energy()) < RTOL


# ---------------------------------------------------------------------------
# in process: K1's block contract, world 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chi,P,nt", [(16, 2, 2), (16, 4, 4), (12, 3, 2)])
def test_k1_block_contract_twin_matches_reference(chi, P, nt):
    """K1's twin on the block contract (xt (B, d, chi, chi/P), Rt (B, M,
    chi/P, chi)) against heff_matvec_reference on the same blocks; the
    blocks' partial sums add up to the square matvec."""
    rng = np.random.default_rng(chi + P)
    B, M = 2, 3
    L = torch.from_numpy(rng.standard_normal((B, chi, M, chi)))
    W = torch.from_numpy(rng.standard_normal((M, M, nt, nt)))
    R = torch.from_numpy(rng.standard_normal((B, chi, M, chi)))
    x = torch.from_numpy(rng.standard_normal((B, chi, nt, chi)))
    cb = chi // P
    total = 0
    for r in range(P):
        Rb, xb = R[:, r * cb:(r + 1) * cb], x[..., r * cb:(r + 1) * cb]
        Lt, Wc, Rt, xt = K.prepare_operands(L, W, Rb, xb)
        assert xt.shape == (B, nt, chi, cb) and Rt.shape == (B, M, cb, chi)
        y = K.finalize_output(K.heff_matvec(Lt, Wc, Rt, xt))
        want = K.heff_matvec_reference(L, W, Rb, xb)
        assert y.shape == (B, chi, nt, chi)
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * float(want.abs().max()))
        total = total + y
    full = K.heff_matvec_reference(L, W, R, x)
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=0,
                               atol=1e-12 * float(full.abs().max()))
    assert K.heff_matvec_route(chi, nt, M, B, torch.float32, cb,
                               chi) == "rect"
    assert K.heff_matvec_route(chi, nt, M, B, torch.float32) == "tc32"


def test_k1_contract_is_still_checked():
    B, M, d, chi = 1, 3, 2, 8
    Lt = torch.zeros(B, M, chi, chi)
    W = torch.zeros(M, M, d, d)
    with pytest.raises(ValueError, match="shape mismatch"):
        K.heff_matvec(Lt, W, torch.zeros(B, M, 4, chi),
                      torch.zeros(B, d, chi, 2))
    # the fused kernels keep the square contract
    with pytest.raises(ValueError, match="shape mismatch"):
        K._validate(Lt, W, torch.zeros(B, M, 4, chi),
                    torch.zeros(B, d, chi, 4))


def test_world_one_tp_matches_unsharded(world1):
    N, chi, m = 6, 8, 8
    As = _state(7, (N, chi, 2, chi))
    mpo = FiniteTFI(1.0, 0.9, N=N, device="cpu")
    mesh = Mm.make_mesh((1,), ("model",), device="cpu")
    d = TPShardedDMRG(torch.from_numpy(As), mpo, mesh, num_krylov_vecs=m)
    d.run_one_site(num_sweeps=2)
    assert d.As.shape == (N, chi, 2, chi)
    assert d.As.to_local().shape == (N, chi, 2, chi)
    want = _tp_unsharded(As, mpo, m, 2, tdmrg.one_site_sweep)
    assert _rel(d.energies, want) < RTOL
    e = tdmrg.mps_mpo_expectation(d.As.to_local(), mpo.Ws, mpo.vL, mpo.vR)
    assert abs(float(e) - want[-1]) < 1e-8


def test_world_one_sp_is_the_unsharded_sweep(world1):
    """One block is the whole chain: its boundary norms are the identity,
    and the sweep is the unsharded one."""
    N, chi, m = 6, 8, 8
    As = _state(8, (N, chi, 2, chi))
    mpo = FiniteTFI(-1.0, -0.7, N=N, device="cpu")
    mesh = Mm.make_mesh((-1,), ("sp",), device="cpu")
    d = DistributedDMRG(torch.from_numpy(As), mpo, mesh, num_krylov_vecs=m)
    e = d.run(num_iterations=1)
    want = tdmrg.one_site_sweep(torch.from_numpy(As), mpo.Ws, mpo.vL,
                                mpo.vR, num_krylov_vecs=m)
    assert _rel(e, float(want.energy)) < RTOL


def test_world_one_dp_matches_unsharded(world1):
    As = torch.from_numpy(_state(10, (3, 6, 6, 2, 6)))
    mpo = FiniteTFI(1.0, 1.0, N=6, device="cpu")
    mesh = Mm.make_mesh((1,), ("data",), device="cpu")
    e = BatchedDMRG(As, mpo, mesh=mesh).run_one_site(num_sweeps=2,
                                                    num_krylov_vecs=6)
    want = BatchedDMRG(As.clone(), mpo).run_one_site(num_sweeps=2,
                                                     num_krylov_vecs=6)
    np.testing.assert_array_equal(e.numpy(), want.numpy())


def test_sharded_entry_points_raise_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        Mm.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Mm.pod_layout(device="cpu")
