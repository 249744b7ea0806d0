"""The cold-start cache of the port's ``BatchedSymmetricDMRG``
(``export_programs``, ``export_programs_parallel``, ``load_programs``;
counterpart of the JAX class's serialized traces) on the CPU at N = 6,
chi = 10, B = 3, in float32 and float64.

A solver that loads the files builds no plan (``torch_engine.
build_counts``) and sweeps to the same bits as one that built them; two
worker processes write the very bytes of a serial export; a file whose
stored key is not the solver's raises, and the sharded solvers refuse to
export.  The loaded solver's energies agree with the JAX class's
``run_one_site`` on the same numpy data (float64, one sweep, rtol 1e-9 as
``tests/test_torch_symmetric_dmrg_batched.py``), at N = 4, where XLA
compiles fewer programs.  The JAX class's own
export is not run here: its test costs ~220 s."""
import datetime
import filecmp
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tensornetwork_tpu.blocksparse import batched as JBt
from tensornetwork_tpu.models import symmetric_dmrg as JS
from tensornetwork_tpu.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG as JBatched)
from tensornetwork_tpu_torch.blocksparse import batched as TBt
from tensornetwork_tpu_torch.blocksparse import plan_store
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.models import symmetric_dmrg as TS
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)
from tensornetwork_tpu_torch.parallel import mesh as TM

N, CHI, B = 6, 10, 3
DTYPES = (torch.float32, torch.float64)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _solver(dtype, n=N, **kw):
    skel = TBt.uniform_skeleton_mps(n, CHI, dtype=dtype, device="cpu")
    data = TBt.random_data_batch(skel, B, seed=0, device="cpu")
    mpo = TS.u1_xxz_mpo(1.0, 1.0, 0.0, n, dtype=dtype, device="cpu")
    return BatchedSymmetricDMRG(skel, data, mpo, **kw)


def _sweeps(d, n=2):
    R = d.right_canonicalize()
    return [d.sweep_one_site(R) for _ in range(n)], d.data


def _builds():
    return dict(TE.build_counts)


def _built_since(before):
    return {k: TE.build_counts[k] - before[k] for k in before}


@pytest.fixture(scope="module")
def export_of(tmp_path_factory):
    """dtype -> (dtype, export dir, energies and data of two sweeps with
    built plans, the number of programs), made once a dtype."""
    made = {}

    def get(dtype):
        if dtype not in made:
            path = str(tmp_path_factory.mktemp(f"plans_{str(dtype)[6:]}"))
            TE.clear_plan_cache()
            d = _solver(dtype)
            d.precompile()
            n = d.export_programs(path)
            es, data = _sweeps(d)
            made[dtype] = (dtype, path, es, data, n)
        return made[dtype]

    return get


@pytest.fixture(params=DTYPES, ids=["f32", "f64"])
def exported(request, export_of):
    return export_of(request.param)


def test_export_writes_one_file_a_program(exported):
    dtype, path, _, _, n = exported
    keys = list(_solver(dtype)._iter_program_keys())
    assert n == len(keys) == len(os.listdir(path))
    kinds = [k for k, _, _ in keys]
    assert kinds.count("canon") >= 1 and kinds.count("site") >= 2
    # a second export finds every file and writes none
    assert _solver(dtype).export_programs(path) == 0


def test_loaded_plans_sweep_to_the_same_bits(exported):
    dtype, path, es, data, n = exported
    TE.clear_plan_cache()
    before = _builds()
    d = _solver(dtype)
    assert d.load_programs(path) == n
    d.precompile()
    assert _built_since(before) == {"plans": 0, "shift_plans": 0}
    assert len(d._programs) == n
    es2, data2 = _sweeps(d)
    assert _built_since(before) == {"plans": 0, "shift_plans": 0}
    for a, b in zip(es + data, es2 + data2):
        assert a.dtype == b.dtype == dtype
        assert torch.equal(a, b)


def test_parallel_export_writes_the_same_bytes(exported, tmp_path):
    dtype, path, _, _, n = exported
    assert _solver(dtype).export_programs_parallel(str(tmp_path),
                                                   workers=2) == n
    names = sorted(os.listdir(path))
    assert sorted(os.listdir(tmp_path)) == names
    for f in names:
        assert filecmp.cmp(os.path.join(path, f), tmp_path / f,
                           shallow=False)
    # nothing missing: no worker starts
    assert _solver(dtype).export_programs_parallel(str(tmp_path)) == 0


def test_parallel_export_raises_when_a_worker_is_cut(tmp_path):
    # workers killed at the deadline, before they could export anything
    with pytest.raises(RuntimeError, match="timed out"):
        _solver(torch.float32).export_programs_parallel(
            str(tmp_path), workers=2, timeout=0.2)
    assert not list(tmp_path.glob("*.tnplan"))


def test_a_file_of_another_program_raises(exported, tmp_path):
    dtype, path, _, _, _ = exported
    names = sorted(os.listdir(path))
    for f in names:
        shutil.copy(os.path.join(path, f), tmp_path / f)
    # the first program's file under the second's name
    shutil.copy(os.path.join(path, names[0]), tmp_path / names[1])
    with pytest.raises(ValueError, match="does not match"):
        _solver(dtype).load_programs(str(tmp_path))
    head = plan_store.PlanFile(os.path.join(path, names[0])).header
    assert head["key"][:24] == names[0].split(".")[0]


def test_a_plan_restores_equal_to_the_built_one():
    TE.clear_plan_cache()
    d = _solver(torch.float64)
    prog = d._program(2, "right")
    for _, plan in prog.plans:
        meta, arrays = TE.plan_to_record(plan)
        back = TE.plan_from_record(meta, arrays)
        assert TE.plan_flops(back) == TE.plan_flops(plan)
        for b1, b2 in zip(plan["buckets"], back["buckets"]):
            for k in ("M1", "M2", "MO"):
                if b1[k] is None:
                    assert b2[k] is None
                else:
                    np.testing.assert_array_equal(b1[k], b2[k])
        x1 = torch.randn(2, plan["nnz1"], dtype=torch.float64)
        x2 = torch.randn(2, plan["nnz2"], dtype=torch.float64)
        assert torch.equal(plan["run"](x1, x2), back["run"](x1, x2))
    meta, arrays = prog.shift.to_record()
    shift = TBt.ShiftPlan.from_record(d.skeleton[2], meta, arrays)
    x = torch.randn(2, d.skeleton[2].data.shape[0], dtype=torch.float64)
    for a, b in zip(prog.shift(x), shift(x)):
        assert torch.equal(a, b)


def test_sharded_solvers_refuse_to_export(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        for kw in (dict(ep_mesh=TM.make_mesh((1,), ("ep",), device="cpu")),
                   dict(ep_mesh=TM.make_mesh((1,), ("ep",), device="cpu"),
                        ep_capacity=True),
                   dict(mesh=TM.make_mesh((1,), ("data",), device="cpu"))):
            d = _solver(torch.float64, **kw)
            for fn in (d.export_programs, d.export_programs_parallel,
                       d.load_programs):
                with pytest.raises(ValueError, match="single-device"):
                    fn(str(tmp_path / "plans"))
    finally:
        dist.destroy_process_group()
    assert not (tmp_path / "plans").exists()


def test_loaded_solver_agrees_with_the_jax_batched_programs(tmp_path):
    # N = 4: XLA compiles one program a structure, ~3 s each (58 s at N=6)
    n = 4
    _solver(torch.float64, n).export_programs(str(tmp_path))
    jskel = JBt.uniform_skeleton_mps(n, CHI, dtype=np.float64)
    j = JBatched(jskel, JBt.random_data_batch(jskel, B, seed=0),
                 JS.u1_xxz_mpo(1.0, 1.0, 0.0, n))
    j.run_one_site(num_sweeps=1)
    TE.clear_plan_cache()
    before = _builds()
    d = _solver(torch.float64, n)
    assert d.load_programs(str(tmp_path)) == len(os.listdir(tmp_path))
    d.run_one_site(num_sweeps=1)
    assert _built_since(before) == {"plans": 0, "shift_plans": 0}
    np.testing.assert_allclose(np.stack(d.energies), np.stack(j.energies),
                               rtol=1e-9)


def test_persistent_compilation_cache_moves_the_native_build(tmp_path,
                                                             monkeypatch):
    from pathlib import Path

    from tensornetwork_tpu_torch import config, native
    from tensornetwork_tpu_torch.ops import _build
    pkg = Path(config.__file__).resolve().parent
    assert _build.BUILD_ROOT == native.BUILD_ROOT == pkg / "build"
    for mod in (_build, native):
        monkeypatch.setattr(mod, "BUILD_ROOT", mod.BUILD_ROOT)
    monkeypatch.setattr(native, "_lib", None)
    config.enable_persistent_compilation_cache(str(tmp_path),
                                               min_compile_time_secs=5.0)
    assert _build.BUILD_ROOT == native.BUILD_ROOT == tmp_path
    native.load()
    assert native.lib_path() == (tmp_path / native.build_key()
                                 / "libpathsolver.so")
    assert native.lib_path().exists()
