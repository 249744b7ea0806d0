"""Rank-side code of the port's multi-rank tests, on the CPU with gloo.

A test calls :func:`spawn`, which starts ``world`` processes of this file,
each one rank of a gloo process group (``file://`` rendezvous in the
test's ``tmp_path``, ``init_process_group(timeout=60 s)``, one torch
thread), runs one job of :data:`JOBS` on the inputs the test pickled, and
pickles the rank's results: dicts of numpy arrays.  The ranks are killed
at the deadline.  This file imports torch, numpy and the port only, never
JAX, so that the ranks never load the test modules' JAX.

    python tests/torch_ranks.py JOB RANK WORLD INIT_FILE IN_PICKLE OUT_PICKLE
"""
import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def spawn(job: str, world: int, tmp_path, inputs, timeout: float = 150.0):
    """Run ``JOBS[job]`` on ``world`` gloo ranks; returns each rank's
    result, in rank order.  Raises with the ranks' output if one fails or
    the deadline passes (the ranks are killed then)."""
    tmp_path = Path(tmp_path)
    in_file = tmp_path / f"{job}.in.pkl"
    in_file.write_bytes(pickle.dumps(inputs))
    init = tmp_path / f"{job}.rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        env.pop(key, None)
    procs = []
    for r in range(world):
        out = tmp_path / f"{job}.{r}.pkl"
        log = open(tmp_path / f"{job}.{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, job, str(r), str(world), str(init),
             str(in_file), str(out)], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=REPO), out, log))
    deadline = time.monotonic() + timeout
    late = False
    for p, _, _ in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            late = True
            break
    for p, _, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    logs = "\n".join(f"--- rank {r} ---\n"
                     + (tmp_path / f"{job}.{r}.log").read_text()[-4000:]
                     for r in range(world))
    if late:
        raise RuntimeError(f"{job}: ranks passed the {timeout} s deadline\n"
                           + logs)
    if any(p.returncode != 0 for p, _, _ in procs):
        raise RuntimeError(f"{job}: a rank failed\n" + logs)
    return [pickle.loads(out.read_bytes()) for _, out, _ in procs]


# ---------------------------------------------------------------------------
# jobs: (rank, world, inputs) -> dict of numpy arrays
# ---------------------------------------------------------------------------


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _tfi(spec, N):
    from tensornetwork_tpu_torch import FiniteTFI
    return FiniteTFI(spec[0], spec[1], N=N, device="cpu")


def dense(rank, world, inp):
    """dp, tp (one- and two-site, shard shapes), sp and dp x tp."""
    from tensornetwork_tpu_torch.parallel import collectives as C
    from tensornetwork_tpu_torch.parallel import mesh as Mm
    from tensornetwork_tpu_torch.parallel.batch import BatchedDMRG
    from tensornetwork_tpu_torch.parallel.sweep import DistributedDMRG
    from tensornetwork_tpu_torch.parallel.tp import TPShardedDMRG
    out = {}
    if "dp" in inp:
        t = inp["dp"]
        As = torch.from_numpy(t["As"])
        mesh = Mm.make_mesh((world,), ("data",), device="cpu")
        bd = BatchedDMRG(As, _tfi(t["mpo"], As.shape[1]), mesh=mesh)
        out["dp_E"] = _np(bd.run_one_site(num_sweeps=t["sweeps"],
                                          num_krylov_vecs=t["m"]))
        out["dp_local_B"] = np.array(bd.As.shape[0])
    if "tp" in inp:
        t = inp["tp"]
        As = torch.from_numpy(t["As"])
        mesh = Mm.make_mesh((world,), ("model",), device="cpu")
        mpo = _tfi(t["mpo"], As.shape[0])
        d = TPShardedDMRG(As, mpo, mesh, num_krylov_vecs=t["m"])
        out["tp_shape_before"] = np.array(d.As.to_local().shape)
        C.reset_counts()
        d.run_one_site(num_sweeps=t["sweeps"], tol=0)
        out["tp_counts"] = np.array([C.counts[k] for k in
                                     ("all_reduce", "reduce_scatter",
                                      "all_gather")])
        out["tp_E"] = np.array(d.energies)
        out["tp_shape_after"] = np.array(d.As.to_local().shape)
        out["tp_state"] = _np(C.all_gather(d.As.to_local(), -1, d.group))
        d2 = TPShardedDMRG(As, mpo, mesh, num_krylov_vecs=t["m"])
        d2.run_two_site(num_sweeps=t["sweeps"])
        out["tp2_E"] = np.array(d2.energies)
    if "tp_shape" in inp:
        t = inp["tp_shape"]
        mesh = Mm.make_mesh((world,), ("model",), device="cpu")
        As = torch.from_numpy(t["As"])
        d = TPShardedDMRG(As, _tfi(t["mpo"], As.shape[0]), mesh,
                          num_krylov_vecs=t["m"])
        out["tps_before"] = np.array(d.As.to_local().shape)
        d.run_one_site(num_sweeps=1)
        out["tps_after"] = np.array(d.As.to_local().shape)
    if "sp" in inp:
        for name, t in inp["sp"].items():
            As = torch.from_numpy(t["As"])
            mesh = Mm.make_mesh((world,), ("sp",), device="cpu")
            d = DistributedDMRG(As, _tfi(t["mpo"], As.shape[0]), mesh,
                                num_krylov_vecs=t["m"],
                                inner_sweeps=t["inner"],
                                num_colors=t["colors"],
                                two_site=t["two_site"],
                                lanczos_impl="plain")
            d.run(num_iterations=t["iters"], tol=0)
            out[f"sp_{name}_E"] = np.array(d.energies)
            out[f"sp_{name}_energy"] = np.array(d.energy())
    if "dptp" in inp:
        t = inp["dptp"]
        As = torch.from_numpy(t["As"])
        mesh = Mm.make_mesh(t["shape"], ("data", "model"), device="cpu")
        d = TPShardedDMRG(As, _tfi(t["mpo"], As.shape[1]), mesh,
                          num_krylov_vecs=t["m"])
        out["dptp_local_shape"] = np.array(d.As.to_local().shape)
        out["dptp_E"] = np.asarray(d.run_one_site(
            num_sweeps=1, qr_impl="polar", ritz_impl="power",
            reorth=False))
    return out


def bst_from_spec(spec):
    """The port's U(1) ``randn`` tensor of ``spec = (charges, flows,
    seed)``, in float64 on the CPU (the JAX package's ``randn`` draws the
    same bits)."""
    import tensornetwork_tpu_torch.blocksparse as T
    charges, flows, seed = spec
    return T.randn([T.Index(T.U1Charge(np.asarray(c)), f)
                    for c, f in zip(charges, flows)], seed=seed,
                   dtype=torch.float64, device="cpu")


_bst = bst_from_spec


def ep_ops(rank, world, inp):
    """tensordot_sharded, truncated_svd_distributed, the EP executors, the
    stored env layout and the distributed two-site split."""
    from tensornetwork_tpu_torch.blocksparse import batched as Bt
    from tensornetwork_tpu_torch.blocksparse import distributed as D
    from tensornetwork_tpu_torch.blocksparse import linalg as L
    from tensornetwork_tpu_torch.blocksparse.tensor import tensordot
    from tensornetwork_tpu_torch.parallel import collectives as C
    from tensornetwork_tpu_torch.parallel import mesh as Mm
    mesh = Mm.make_mesh((world,), ("ep",), device="cpu")
    group = Mm.axis_group(mesh, "ep")
    ep = (world, group)
    out = {}
    for i, (a, b, axes) in enumerate(inp["tensordot"]):
        a, b = _bst(a), _bst(b)
        got = D.tensordot_sharded(a, b, axes, mesh)
        out[f"td{i}"] = _np(got.todense())
        out[f"td{i}_data"] = _np(got.data)
        out[f"td{i}_single"] = _np(tensordot(a, b, axes).data)
    m = _bst(inp["svd_matrix"])
    for i, kw in enumerate(inp["svd_kwargs"]):
        U, S, V, rest = D.truncated_svd_distributed(m, mesh, **kw)
        U0, S0, V0, rest0 = L.truncated_svd(m, **kw)
        out[f"svd{i}_S"] = _np(S.data)
        out[f"svd{i}_S0"] = _np(S0.data)
        out[f"svd{i}_rest"] = _np(rest)
        out[f"svd{i}_rest0"] = _np(rest0)
        rec = tensordot(tensordot(U, L.diag(S), [[1], [0]]), V, [[1], [0]])
        rec0 = tensordot(tensordot(U0, L.diag(S0), [[1], [0]]), V0,
                         [[1], [0]])
        out[f"svd{i}_rec"] = _np(rec.todense())
        out[f"svd{i}_rec0"] = _np(rec0.todense())
        out[f"svd{i}_bytes"] = np.array(D.last_bst_transfer_bytes)
    u, s, vh, kept = D.truncated_svd_distributed(
        m, mesh, output="masked", **inp["svd_kwargs"][0])
    out["masked_u"] = _np(u.full_tensor())
    out["masked_s"] = _np(s.full_tensor())
    out["masked_vh"] = _np(vh.full_tensor())
    out["masked_kept"] = _np(kept.full_tensor())
    # chains: fused EP chain, its partials, per-contraction EP executors,
    # and the single-device executors in turn
    mats = [_bst(t) for t in inp["chain"]]
    stages = [(mats[0], mats[1], [[1], [0]])] + [
        (None, x, [[1], [0]]) for x in mats[2:]]
    run, _ = Bt.chain_contraction_plan(stages, ep)
    datas = [x.data for x in mats]
    C.reset_counts()
    out["chain"] = _np(run(*datas))
    out["chain_all_reduces"] = np.array(C.counts["all_reduce"])
    runp, _ = Bt.chain_contraction_plan(stages, ep, reduce="none")
    out["chain_partial"] = _np(runp(*datas))
    cur, skel = datas[0], mats[0]
    cur_ep = datas[0]
    for x in mats[1:]:
        f, nxt = Bt.contraction_plan(skel, x, [[1], [0]])
        f_ep, _ = Bt.contraction_plan(skel, x, [[1], [0]], ep=ep)
        cur, cur_ep, skel = f(cur, x.data), f_ep(cur_ep, x.data), nxt
    out["chain_seq"] = _np(cur)
    out["chain_seq_ep"] = _np(cur_ep)
    # the stored env layout, ragged lengths
    for nnz in inp["env_nnz"]:
        parts = torch.from_numpy(inp["env_parts"][:, :, :nnz])
        stored = Bt.env_scatter_stored(parts[rank], world, group)
        out[f"env{nnz}_stored"] = _np(stored)
        out[f"env{nnz}_full"] = _np(Bt.env_gather_full(stored, nnz, group))
    # the two-site split of bond (2, 3) of a uniform skeleton, single and
    # distributed
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        _td_skeleton)
    skel = Bt.uniform_skeleton_mps(6, 10, dtype=torch.float64, device="cpu")
    theta_skel = _td_skeleton(skel[2], skel[3], [[2], [0]])
    tp = Bt.TwoSiteSplitPlan(theta_skel, skel[2], skel[3])
    theta = torch.from_numpy(np.random.default_rng(inp["split_seed"])
                             .standard_normal((3, theta_skel.data.shape[0])))
    for absorb in ("right", "left"):
        single = tp(theta, absorb)
        dist_ = tp(theta, absorb, ep=ep)
        for k in range(3):
            out[f"split_{absorb}{k}"] = _np(single[k])
            out[f"split_{absorb}{k}_ep"] = _np(dist_[k])
    return out


def ep_solver(rank, world, inp):
    """BatchedSymmetricDMRG over ep (replicated envs), capacity and DP
    meshes against its single-device run, with the collectives of the
    capacity layout counted."""
    from tensornetwork_tpu_torch.blocksparse import batched as Bt
    from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    from tensornetwork_tpu_torch.parallel import collectives as C
    from tensornetwork_tpu_torch.parallel import mesh as Mm
    N, chi, B, m = inp["N"], inp["chi"], inp["B"], inp["m"]
    skel = Bt.uniform_skeleton_mps(N, chi, dtype=torch.float64,
                                   device="cpu")
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float64, device="cpu")
    data = Bt.random_data_batch(skel, B, seed=inp["seed"], device="cpu")
    ep_mesh = Mm.make_mesh((world,), ("ep",), device="cpu")
    dp_mesh = Mm.make_mesh((world,), ("data",), device="cpu")
    out = {}

    def solver(**kw):
        return BatchedSymmetricDMRG(skel, [d.clone() for d in data], mpo,
                                    num_krylov_vecs=m, **kw)

    for name, kw in (("single", {}), ("ep", dict(ep_mesh=ep_mesh)),
                     ("cap", dict(ep_mesh=ep_mesh, ep_capacity=True)),
                     ("dp", dict(mesh=dp_mesh))):
        out[f"{name}_E"] = np.asarray(solver(**kw).run_one_site(
            num_sweeps=inp["sweeps"]))
        if name != "dp":
            s2 = solver(**kw)
            out[f"{name}_E2"] = np.asarray(s2.run_two_site(num_sweeps=1))
            out[f"{name}_terr"] = np.asarray(s2.truncation_errors[-1])
    # capacity: count the collectives of one canon step (env traffic only)
    # and of one site step (the matvec chain's all_reduces besides)
    cap = solver(ep_mesh=ep_mesh, ep_capacity=True)
    R = cap._boundary_env()
    out["cap_boundary"] = _np(R)
    C.reset_counts()
    qd, prev2, rnew = cap._canon_program(N - 1)(
        cap.data[N - 1], cap.data[N - 2], cap.mpo_data[N - 1], R)
    out["canon_counts"] = np.array([C.counts[k] for k in
                                    ("all_reduce", "reduce_scatter",
                                     "all_gather")])
    out["canon_stored_len"] = np.array(rnew.shape[1])
    out["canon_nnz"] = np.array(cap._Rskel[N - 1].data.shape[0])
    R_full = Bt.env_gather_full(rnew, int(out["canon_nnz"]),
                                cap.ep[1])
    rep = solver(ep_mesh=ep_mesh)
    _, _, r_rep = rep._canon_program(N - 1)(
        rep.data[N - 1], rep.data[N - 2], rep.mpo_data[N - 1],
        rep._boundary_env())
    out["canon_env_cap"] = _np(R_full)
    out["canon_env_rep"] = _np(r_rep)
    return out


def example_distributed(rank, world, inp):
    """``examples.distributed_symmetric_dmrg`` in the ranks' group: the
    single-device and capacity-EP energies, the files written (rank 0)
    and the programs installed."""
    from tensornetwork_tpu_torch.examples import (
        distributed_symmetric_dmrg as ex)
    es_ref, es_ep, written, loaded = ex.compare(
        inp["N"], inp["chi"], inp["B"], inp["sweeps"], inp["export_dir"],
        device="cpu")
    return dict(es_ref=np.asarray(es_ref), es_ep=np.asarray(es_ep),
                written=np.array(written), loaded=np.array(loaded))


JOBS = {"dense": dense, "ep_ops": ep_ops, "ep_solver": ep_solver,
        "example_distributed": example_distributed}


def main(argv):
    job, rank, world, init, in_file, out_file = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + init,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        inputs = pickle.loads(Path(in_file).read_bytes())
        result = JOBS[job](rank, world, inputs)
        Path(out_file).write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
