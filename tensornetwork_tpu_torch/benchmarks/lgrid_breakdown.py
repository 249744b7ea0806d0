"""Where the time of the f32 grid-wide Lanczos kernels (K3, K4) goes.

    python -m tensornetwork_tpu_torch.benchmarks.lgrid_breakdown

Builds copies of ``csrc/fused_lanczos_streamed.cu`` (K4; K3's fact runs the
same steps without the basis) whose ``lanczos_grid.cuh`` leaves one part of
each Lanczos step out -- stage 1, the coupling fold, stage 2, all three (so
that the grid barriers and the recurrence passes remain), or all three and
the recurrence passes (the barriers alone) -- and times each beside the
whole kernel, by CUDA events, at the one-site path shapes (B=1, d=2, M=3,
m=10; chi=384 and 512), at each block tile the kernel takes (128x128 at
one block an SM, 64x64 at two).  A part's time is the whole kernel's less the copy
without it.  The copies compute wrong results by design and serve for
timing only.  One JSON line per copy, with the card's name.  Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import shutil
import subprocess

import numpy as np
import torch

from tensornetwork_tpu_torch.ops import _build
from tensornetwork_tpu_torch.ops import kernels as K

D, M, KRYLOV = 2, 3, 10
CHIS = (384, 512)
# text in lanczos_grid.cuh -> the same under a guard; LEAVE_OUT = 1 stage
# 1, 2 the fold, 3 stage 2, 4 all three, 5 all three and the passes
GUARDS = (
    ("    tc_stage1<BM, BN, MODE>(a, j, vl, ring);\n",
     "    if (LEAVE_OUT != 1 && LEAVE_OUT < 4)\n"
     "      tc_stage1<BM, BN, MODE>(a, j, vl, ring);\n"),
    ("    for (int b = 0; b < a.B; ++b) {\n      if (b == 0 || a.w_stride) {",
     "    for (int b = 0; b < (LEAVE_OUT == 2 || LEAVE_OUT >= 4 ? 0 : a.B);"
     " ++b) {\n      if (b == 0 || a.w_stride) {"),
    ("    tc_stage2<BM, BN>(a, vl, ring);\n",
     "    if (LEAVE_OUT < 3) tc_stage2<BM, BN>(a, vl, ring);\n"),
    ("  const int nseg = (int)((n + SEG - 1) / SEG);\n",
     "  const int nseg = LEAVE_OUT == 5 ? 0 : (int)((n + SEG - 1) / SEG);\n"),
)
COPIES = ("whole kernel", "stage 1", "fold", "stage 2",
          "stage 1, fold and stage 2", "matvec and recurrence passes")


def _build_copies():
    header = (_build.CSRC / "lanczos_grid.cuh").read_text()
    for text, guarded in GUARDS:
        if text not in header:
            raise RuntimeError(f"lanczos_grid.cuh changed: no {text!r}")
        header = header.replace(text, guarded)
    out = _build.BUILD_ROOT / "lgrid_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    for name in _build.HEADERS:
        shutil.copy(_build.CSRC / name, out / name)
    (out / "lanczos_grid.cuh").write_text(header)
    shutil.copy(_build.CSRC / "fused_lanczos_streamed.cu", out)
    procs = []
    for i in range(len(COPIES)):
        lib = out / f"lib{i}.so"
        cmd = [_build._nvcc(), *_build.FLAGS, f"-DLEAVE_OUT={i}", "-o",
               str(lib), str(out / "fused_lanczos_streamed.cu")]
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


def _operands(chi, seed):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((1, chi, M, chi))
    R = rng.standard_normal((1, chi, M, chi))
    W = rng.standard_normal((M, M, D, D))
    x = rng.standard_normal((1, chi, D, chi))
    L = (L + L.transpose(0, 3, 2, 1)) / (2 * chi)
    R = (R + R.transpose(0, 3, 2, 1)) / (2 * chi)
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(chi, _operands(chi, chi)) for chi in CHIS]
    for name, lib in zip(COPIES, libs):
        fn = ctypes.CDLL(str(lib)).tn_fused_lanczos_streamed_f32
        fn.argtypes = K._ARGTYPES["tn_fused_lanczos_streamed"]
        fn.restype = ctypes.c_int
        row = {"left_out": None if name == "whole kernel" else name,
               "card": torch.cuda.get_device_name(0)}
        for (chi, (Lt, W, Rt, xt)), tile in itertools.product(
                cases, K._GRID_TILES):
            plan = K.lgrid_plan(chi, D, M, 1, sms, tile)
            kw = dict(dtype=torch.float32, device="cuda")
            V = torch.empty((1, KRYLOV, D, chi, chi), **kw)
            ab = torch.empty((1, 2, KRYLOV), **kw)
            scratch = K._grid_scratch(1, chi, D, M, plan.split, **kw)
            for t in scratch:
                t.zero_()
            grid = ctypes.c_int(0)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = fn(W.data_ptr(), 0, Lt.data_ptr(), Rt.data_ptr(),
                         xt.data_ptr(), V.data_ptr(), ab.data_ptr(),
                         *(t.data_ptr() for t in scratch), 1, chi, D, M,
                         KRYLOV, K._TC32_TILES.index(tile), plan.split, 1e-8,
                         ctypes.addressof(grid), stream)
                if err:
                    raise RuntimeError(f"launch failed with error {err}")

            key = f"chi{chi}_{tile[0]}x{tile[1]}"
            row[key + "_ms"] = _ms(run)
            row[key + "_grid"] = grid.value
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
