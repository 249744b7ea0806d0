"""Where the time of the f32 resident Lanczos kernel (K2) goes.

    python -m tensornetwork_tpu_torch.benchmarks.k2_breakdown

Builds copies of ``csrc/fused_lanczos.cu`` with one part of each Lanczos
step left out -- stage 1, stage 2, the coupling fold, or the recurrence's
two vector passes -- and times each beside the whole kernel, by CUDA
events, at the batched paths' shapes (chi=64, M=3; one-site nt=2, m=10
and two-site nt=4, m=6; B=256 and B=132).  A part's time is the whole
kernel's less the copy without it.  The copies compute wrong results by
design and serve for timing only.  One JSON line per copy.  Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import numpy as np
import torch

from tensornetwork_tpu_torch.ops import _build
from tensornetwork_tpu_torch.ops import kernels as K

CHI, M = 64, 3
# part left out -> (text in fused_lanczos.cu, the same under a guard)
PARTS = {
    "stage 1": ("    tc32::gemm_stream<TC_BM, TC_BN, true>(\n        rt1",
                "    if (LEAVE_OUT != 1)\n"
                "    tc32::gemm_stream<TC_BM, TC_BN, true>(\n        rt1"),
    "stage 2": ("    tc32::gemm_stream<TC_BM, TC_BN, true>(\n        nt * ct",
                "    if (LEAVE_OUT != 2)\n"
                "    tc32::gemm_stream<TC_BM, TC_BN, true>(\n        nt * ct"),
    "fold": ("    tc32::fold_in_place<MC, NTC>(",
             "    if (LEAVE_OUT != 3) tc32::fold_in_place<MC, NTC>("),
    "recurrence passes": (
        "    if (v4) {\n      float4* w4",
        "    if (LEAVE_OUT == 4) {\n    } else if (v4) {\n      float4* w4"),
    "recurrence passes (2)": (
        "      if (v4) {\n        const float4* w4",
        "      if (LEAVE_OUT == 4) {\n      } else if (v4) {\n        const float4* w4"),
}
COPIES = ("whole kernel", "stage 1", "stage 2", "fold", "recurrence passes")


def _build_copies():
    src = (_build.CSRC / "fused_lanczos.cu").read_text()
    for name, (text, guarded) in PARTS.items():
        if text not in src:
            raise RuntimeError(f"fused_lanczos.cu changed: no {name!r} text")
        src = src.replace(text, guarded)
    out = _build.BUILD_ROOT / "k2_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.HEADERS:
        shutil.copy(_build.CSRC / header, out / header)
    (out / "fused_lanczos.cu").write_text(src)
    procs = []
    for i in range(len(COPIES)):
        lib = out / f"lib{i}.so"
        cmd = [_build._nvcc(), *_build.FLAGS, f"-DLEAVE_OUT={i}", "-o",
               str(lib), str(out / "fused_lanczos.cu")]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib))
    libs = []
    for proc, lib in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
        libs.append(lib)
    return libs


def _operands(B, nt, seed):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, CHI, M, CHI))
    R = rng.standard_normal((B, CHI, M, CHI))
    W = rng.standard_normal((M, M, nt, nt))
    x = rng.standard_normal((B, CHI, nt, CHI))
    L = (L + L.transpose(0, 3, 2, 1)) / (2 * CHI)
    R = (R + R.transpose(0, 3, 2, 1)) / (2 * CHI)
    W = (W + W.transpose(1, 0, 3, 2)) / 2
    return K.prepare_operands(*(torch.as_tensor(a, dtype=torch.float32,
                                                device="cuda")
                                for a in (L, W, R, x)))


def _ms(fn, reps=10):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    libs = _build_copies()
    cases = [(nt, m, B, _operands(B, nt, nt)) for nt, m in ((2, 10), (4, 6))
             for B in (256, 132)]
    for name, lib in zip(COPIES, libs):
        fn = ctypes.CDLL(str(lib)).tn_fused_lanczos_f32
        fn.argtypes = K._ARGTYPES["tn_fused_lanczos"]
        fn.restype = ctypes.c_int
        row = {"left_out": None if name == "whole kernel" else name,
               "card": torch.cuda.get_device_name(0)}
        for nt, m, B, (Lt, W, Rt, xt) in cases:
            kw = dict(dtype=torch.float32, device="cuda")
            V = torch.empty((B, m, nt, CHI, CHI), **kw)
            ab = torch.empty((B, 2, m), **kw)
            P = torch.empty((B, M * nt, CHI, CHI), **kw)
            w = torch.zeros((B, nt, CHI, CHI), **kw)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = fn(W.data_ptr(), 0, Lt.data_ptr(), Rt.data_ptr(),
                         xt.data_ptr(), V.data_ptr(), ab.data_ptr(),
                         P.data_ptr(), w.data_ptr(), B, CHI, nt, M, m, 1e-8,
                         stream)
                if err:
                    raise RuntimeError(f"launch failed with error {err}")

            row[f"nt{nt}_B{B}_ms"] = _ms(run)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
