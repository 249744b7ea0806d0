"""Where the cold start of batched symmetric DMRG goes, on one card.

    python -m tensornetwork_tpu_torch.benchmarks.cold_start [--N 32]
        [--chi 1024] [--B 8] [--workers 4,8] [--cpu]

One JSON line a step, the card's name and power limit first: the imports
of a fresh process (torch, then the port); the plan build of the XXZ
chain's one-site programs (``precompile``); their serial export from the
built solver (the writes alone); ``export_programs_parallel`` from a
solver without plans at each worker count, its files held byte for byte
against the serial ones; and a fresh process that loads the files and
precompiles (it must build no plan).  Files go to a temporary directory
and are read back warm from the page cache.
"""
from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_IMPORTS = ("import json, time; t0 = time.perf_counter(); import torch; "
            "t1 = time.perf_counter(); import tensornetwork_tpu_torch; "
            "print(json.dumps(dict(torch_s=t1 - t0, "
            "port_s=time.perf_counter() - t1)))")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def solver(N: int, chi: int, B: int, device=None):
    """The XXZ chain (Jz = Jxy = 1) at N, chi with B seed-0 random states,
    float32 on ``device`` (default: the card)."""
    import torch

    from tensornetwork_tpu_torch.blocksparse import batched
    from tensornetwork_tpu_torch.models.symmetric_dmrg import u1_xxz_mpo
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    skel = batched.uniform_skeleton_mps(N, chi, dtype=torch.float32,
                                        device=device)
    data = batched.random_data_batch(skel, B, seed=0, device=device)
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float32, device=device)
    return BatchedSymmetricDMRG(skel, data, mpo)


def load(path: str, N: int, chi: int, B: int, device=None):
    """The fresh process: load, precompile, report."""
    t_start = time.perf_counter()
    from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
    d = solver(N, chi, B, device)
    before = dict(TE.build_counts)
    t0 = time.perf_counter()
    n = d.load_programs(path)
    load_s = time.perf_counter() - t0
    precompile_s = d.precompile()
    emit(step="load", installed=n, load_s=load_s, precompile_s=precompile_s,
         built={k: TE.build_counts[k] - before[k] for k in before},
         since_start_s=time.perf_counter() - t_start)


def main(N: int, chi: int, B: int, workers, device=None):
    if shutil.which("nvidia-smi"):
        emit(step="card", nvidia_smi=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    out = subprocess.run([sys.executable, "-c", _IMPORTS],
                         capture_output=True, text=True, check=True)
    emit(step="imports", **json.loads(out.stdout))
    tmp = tempfile.mkdtemp()
    try:
        d = solver(N, chi, B, device)
        plan_s = d.precompile()
        serial = os.path.join(tmp, "serial")
        t0 = time.perf_counter()
        n = d.export_programs(serial)
        files = sorted(os.listdir(serial))
        emit(step="build_then_write", N=N, chi=chi, batch=B,
             plan_build_s=plan_s, write_s=time.perf_counter() - t0,
             files=n, bytes=sum(os.path.getsize(os.path.join(serial, f))
                                for f in files))
        del d
        from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
        for w in workers:
            TE.clear_plan_cache()
            par = os.path.join(tmp, f"w{w}")
            t0 = time.perf_counter()
            n = solver(N, chi, B, device).export_programs_parallel(
                par, workers=w)
            dt = time.perf_counter() - t0
            same = sorted(os.listdir(par)) == files and all(
                filecmp.cmp(os.path.join(serial, f), os.path.join(par, f),
                            shallow=False) for f in files)
            emit(step="parallel_export", workers=w, s=dt, files=n,
                 same_bytes=same)
            shutil.rmtree(par)
        TE.clear_plan_cache()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "tensornetwork_tpu_torch.benchmarks."
             "cold_start", "--load", serial, "--N", str(N), "--chi",
             str(chi), "--B", str(B)] + (["--cpu"] if device else []),
            capture_output=True, text=True, check=True)
        child = json.loads(out.stdout.strip().splitlines()[-1])
        child.update(step="fresh_process",
                     process_s=time.perf_counter() - t0)
        emit(**child)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--chi", type=int, default=1024)
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--workers", default="4,8")
    ap.add_argument("--load", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None
    if args.load:
        load(args.load, args.N, args.chi, args.B, dev)
    else:
        main(args.N, args.chi, args.B,
             [int(w) for w in args.workers.split(",")], dev)
