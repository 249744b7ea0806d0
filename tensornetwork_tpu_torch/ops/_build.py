"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources at once in parallel.  The libraries go into
``tensornetwork_tpu_torch/build/<key>/``, where ``key`` hashes the
sources, the headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  They are loaded with :mod:`ctypes`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"
SOURCES = ("heff_matvec.cu", "fused_lanczos.cu", "fused_lanczos_2pass.cu",
           "fused_lanczos_streamed.cu", "streamed_matvec.cu",
           "streamed_matvec_xl.cu", "fused_gauge_env.cu", "transfer_chain.cu",
           "gemm_chain.cu", "tridiag_ritz.cu")
HEADERS = ("heff.cuh", "lanczos_grid.cuh", "gemm_tc32.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build_all() did: per source, seconds and ptxas report
build_log: Dict[str, dict] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "tensornetwork_tpu_torch are built on first use "
                           "and need the CUDA toolkit")
    return path


def build_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(key: str, source: str) -> Path:
    return BUILD_ROOT / key / ("lib" + Path(source).stem + ".so")


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns (and keeps in :data:`build_log`) per source the library path,
    the build seconds (0 when it was already built) and nvcc's output
    (the ptxas register and spill report)."""
    key = build_key()
    out_dir = BUILD_ROOT / key
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in SOURCES:
        lib = _lib_path(key, src)
        if lib.exists():
            build_log[src] = {"lib": str(lib), "seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            continue
        os.replace(tmp, lib)
        build_log[src] = {"lib": str(lib),
                          "seconds": time.perf_counter() - t0, "log": out}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return build_log


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _libs.get(source)
    if lib is None:
        if source not in build_log:
            build_all()
        lib = ctypes.CDLL(build_log[source]["lib"])
        _libs[source] = lib
    return lib
