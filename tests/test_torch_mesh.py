"""The port's meshes against the JAX package's (counterpart of
tests/test_mesh.py), in process on a world-1 gloo group that a fixture
creates and destroys for each test: ``make_mesh``/``make_hybrid_mesh``/
``pod_layout`` shapes, names and errors against the JAX functions on the
same inputs, DTensor placements, ``initialize_distributed``'s no-op, and
the batched sweep on the pod layout against the JAX sweep on its hybrid
mesh."""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from tensornetwork_tpu.models import FiniteTFI as JTFI
from tensornetwork_tpu.parallel import mesh as JM
from tensornetwork_tpu.parallel.batch import batched_one_site_sweep as jsweep
from tensornetwork_tpu_torch import FiniteTFI
from tensornetwork_tpu_torch.parallel import mesh as TM
from tensornetwork_tpu_torch.parallel.batch import BatchedDMRG


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


def _no_launcher_env(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)


def test_initialize_distributed_noop_single_process(monkeypatch):
    # nothing configured: neither package starts anything
    _no_launcher_env(monkeypatch)
    assert JM.initialize_distributed() is False
    assert TM.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_initialize_distributed_starts_gloo(monkeypatch, tmp_path):
    _no_launcher_env(monkeypatch)
    try:
        assert TM.initialize_distributed(
            f"file://{tmp_path}/rendezvous", num_processes=1, process_id=0,
            device="cpu", timeout=datetime.timedelta(seconds=60)) is True
        assert dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        # already up: a second call changes nothing
        assert TM.initialize_distributed(device="cpu") is True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("shape,names", [((-1,), ("data",)),
                                         ((1, -1), ("data", "model")),
                                         ((1, 1, 1), ("a", "b", "c"))])
def test_make_mesh_infers_and_names_like_jax(world1, shape, names):
    mesh = TM.make_mesh(shape, names, device="cpu")
    jmesh = JM.make_mesh(shape, names, devices=jax.devices()[:1])
    assert mesh.mesh_dim_names == jmesh.axis_names
    assert tuple(mesh.mesh.shape) == jmesh.devices.shape
    assert mesh.device_type == "cpu"
    for name in names:
        assert TM.axis_size(mesh, name) == jmesh.shape[name]
        assert mesh.get_local_rank(name) == 0


@pytest.mark.parametrize("shape,names", [((2,), ("data",)),
                                         ((1,), ("data", "model"))])
def test_make_mesh_validates_like_jax(world1, shape, names):
    with pytest.raises(ValueError):
        JM.make_mesh(shape, names, devices=jax.devices()[:1])
    with pytest.raises(ValueError):
        TM.make_mesh(shape, names, device="cpu")


def test_hybrid_mesh_axes_and_shape(world1):
    mesh = TM.make_hybrid_mesh((1,), (1,), ("host", "model"), device="cpu")
    jmesh = JM.make_hybrid_mesh((1,), (1,), ("host", "model"),
                                devices=jax.devices()[:1])
    assert mesh.mesh_dim_names == jmesh.axis_names == ("host", "model")
    assert tuple(mesh.mesh.shape) == jmesh.devices.shape == (1, 1)


@pytest.mark.parametrize("ici,dcn,names", [((4,), (3,), ("host", "model")),
                                           ((1,), (1,), ("host",))])
def test_hybrid_mesh_validates(world1, ici, dcn, names):
    with pytest.raises(ValueError):
        JM.make_hybrid_mesh(ici, dcn, names, devices=jax.devices()[:1])
    with pytest.raises(ValueError):
        TM.make_hybrid_mesh(ici, dcn, names, device="cpu")


def test_pod_layout_dp_over_host_tp_over_model(world1):
    mesh = TM.pod_layout(n_hosts=1, device="cpu")
    assert mesh.mesh_dim_names == ("host", "model")
    with pytest.raises(ValueError, match="do not split"):
        TM.pod_layout(n_hosts=2, device="cpu")
    B, chi = 4, 16
    x = torch.arange(B * chi * chi, dtype=torch.float64).reshape(B, chi, chi)
    xs = TM.shard_array(x, mesh, TM.placements(mesh, {"host": 0,
                                                      "model": 2}))
    assert xs.placements == (Shard(0), Shard(2))
    assert xs.to_local().shape == (B, chi, chi)      # one host, one card
    y = torch.einsum("bij,bkj->bik", xs.to_local(), xs.to_local())
    np.testing.assert_allclose(y.numpy(), np.einsum("bij,bkj->bik", x, x),
                               rtol=1e-12)


def test_batch_spec_and_replicate(world1):
    mesh = TM.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert TM.batch_spec(mesh) == [Shard(0), Replicate()]
    assert TM.batch_spec(mesh, "model") == [Replicate(), Shard(0)]
    with pytest.raises(ValueError, match="no dimension"):
        TM.batch_spec(mesh, "host")
    x = torch.randn(3, 4, dtype=torch.float64)
    r = TM.replicate(x, mesh)
    assert r.placements == (Replicate(), Replicate())
    np.testing.assert_array_equal(r.full_tensor().numpy(), x.numpy())
    np.testing.assert_array_equal(TM.local(r).numpy(), x.numpy())
    assert TM.local(x) is x


def test_batched_sweep_on_hybrid_mesh(world1):
    """The dp-batched sweeps with the batch over the pod layout's host axis
    against the JAX sweeps on its 2 x 4 hybrid mesh (the same function: no
    instance talks to another).  Two chained sweeps: the first sweep's
    power Ritz solves stop short of convergence where the last bits of
    the tridiagonal matrix decide (see test_torch_dmrg.py)."""
    N, chi, B = 8, 8, 4
    rng = np.random.default_rng(0)
    As = rng.standard_normal((B, N, chi, 2, chi)) / np.sqrt(2 * chi)
    jmesh = JM.pod_layout(n_hosts=2)
    jmpo = JTFI(1.0, 1.0, N=N)
    repl = NamedSharding(jmesh, P())
    with jmesh:
        jAs, renvs = jax.device_put(jnp.asarray(As), NamedSharding(
            jmesh, P("host", None, None, None, None))), None
        for _ in range(2):
            jres = jsweep(jAs, jax.device_put(jmpo.Ws, repl),
                          jax.device_put(jmpo.vL, repl),
                          jax.device_put(jmpo.vR, repl), num_krylov_vecs=8,
                          renvs=renvs)
            jAs, renvs = jres.As, jres.renvs
    mesh = TM.pod_layout(device="cpu")
    e = BatchedDMRG(torch.from_numpy(As), FiniteTFI(1.0, 1.0, N=N,
                                                    device="cpu"),
                    mesh=mesh, batch_axis="host").run_one_site(
        num_sweeps=2, num_krylov_vecs=8)
    assert e.shape == (B,)
    np.testing.assert_allclose(e.numpy(), np.asarray(jres.energy),
                               rtol=1e-10)


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    for make in (lambda: TM.make_mesh((1,), ("data",), device="cpu"),
                 lambda: TM.make_hybrid_mesh((1,), (1,), ("host", "model"),
                                             device="cpu"),
                 lambda: TM.pod_layout(device="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            make()
