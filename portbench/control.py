#!/usr/bin/env python3
"""The control of the output check: the plain reference put in the
program's place, computed in the precision below the configuration's
(float32 matmuls in TF32), on the cell's own inputs and sizes, judged by
the same comparison.  It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --sweeps K [--precision tf32|fp32] [--block n]

``--sweeps``: the warm sweep plus the window's sweeps of a run of the
cell; ``--precision fp32`` runs the reference with TF32 off (it has to
come out correct); ``--block``: instances a block (the instances are
independent).  One JSON line a seed.  Not run by the benchmark's runs.
"""
import argparse
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [CHECKOUT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE,
                                                                 CHECKOUT)]

import torch  # noqa: E402

from portbench.core import registry  # noqa: E402
from portbench.reference import judge, mps, sweep  # noqa: E402


def control(wl: dict, cfg: dict, seed: int, sweeps: int, precision: str,
            block: int, device) -> dict:
    """Run the reference sweeps on the cell's inputs; the judged numbers."""
    drv = registry.driver(wl["driver"])
    inp = drv.inputs(cfg, wl, seed, device)
    sites = mps.sites_of(inp.pop("sites"))
    B, dtype = sites[0].shape[0], sites[0].dtype
    Ws, vL, vR = judge.instance_mpos(cfg, inp["params"], B, device)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    torch.set_float32_matmul_precision("high" if precision == "tf32"
                                       else "highest")
    out_sites, energies = [], []
    t0 = time.perf_counter()
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        s = [x[b0:b1].clone() for x in sites]
        W = (Ws if Ws.dim() == 5 else Ws[b0:b1]).to(dtype)
        R = None
        for _ in range(sweeps):
            s, e, R = sweep.one_site_sweep(s, W, vL.to(dtype), vR.to(dtype),
                                           wl["krylov"], R)
        del R
        out_sites.append(s)
        energies.append(e)
    secs = time.perf_counter() - t0
    del sites
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    outputs = {"sites": [torch.cat([o[i] for o in out_sites])
                         for i in range(len(out_sites[0]))],
               "energy": torch.cat(energies), "params": inp["params"]}
    del out_sites
    checks, attempted, failed, info = judge.judge(cfg, wl, outputs)
    return {"seed": seed, "precision": precision, "sweeps": sweeps,
            "correct": failed == 0, "attempted": attempted,
            "failed": failed, "sweep_s": secs / sweeps,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "not_compared": info}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sweeps", type=int, required=True)
    p.add_argument("--precision", choices=("tf32", "fp32"), default="tf32")
    p.add_argument("--block", type=int, default=1 << 30)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        res = control(wl, cfg, seed, args.sweeps, args.precision, args.block,
                      "cuda")
        res["kind"] = torch.cuda.get_device_name(0)
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
