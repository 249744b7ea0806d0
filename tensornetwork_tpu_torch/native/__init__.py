"""The exact contraction-order solver in C++ (``pathsolver.cpp``), bridged
with ctypes.

A dynamic program over the connected subsets of the network (netcon
style) that extends exhaustive search from the Python branch-and-bound's
practical limit of ~8 tensors to ~20.  It runs on the host.  ``g++``
builds the shared library at first use into
``tensornetwork_tpu_torch/build/<key>/``, where ``key`` hashes the source
and the flags, as ``ops/_build.py`` keys the CUDA sources.  A failed build
raises with g++'s output: no caller falls back to another solver because
the library is missing.  Counterpart of :mod:`tensornetwork_tpu.native`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "pathsolver.cpp"
BUILD_ROOT = _SRC.parent.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC")
# the solver's own limit: 2^n subsets of doubles
MAX_OPERANDS = 26
_lib: Optional[ctypes.CDLL] = None


def build_key() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_ROOT / build_key() / "libpathsolver.so"


def load() -> ctypes.CDLL:
    """The solver's library, built by g++ on first use; raises with g++'s
    output if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = lib_path()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(_SRC)],
                                 capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native path solver of "
                               "tensornetwork_tpu_torch is built on first "
                               "use") from e
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    cdll.tn_optimal_order.restype = ctypes.c_int
    cdll.tn_optimal_order.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
    _lib = cdll
    return _lib



def available() -> bool:
    """Whether the solver's library loads, building it first if need be
    (False where g++ is missing or the build fails)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def optimal_order_masks(log_adj: np.ndarray
                        ) -> Optional[Tuple[np.ndarray, float]]:
    """Exact optimal contraction order of a log10 adjacency matrix.

    Returns ``(merges, log10_cost)`` where ``merges`` is an (n-1, 2)
    int64 array of (maskA, maskB) bitmask pairs in a valid bottom-up
    order, or ``None`` when the network is too large for the solver
    (n > :data:`MAX_OPERANDS`)."""
    adj = np.ascontiguousarray(log_adj, dtype=np.float64)
    n = adj.shape[0]
    if n > MAX_OPERANDS:
        return None
    if n == 1:
        return np.zeros((0, 2), np.int64), 0.0
    lib = load()
    pairs = np.zeros((n - 1, 2), np.int64)
    cost = ctypes.c_double(0.0)
    rc = lib.tn_optimal_order(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(cost))
    if rc != 0:
        raise RuntimeError(f"tn_optimal_order returned {rc} for n={n}")
    return pairs, float(cost.value)


def masks_to_index_pairs(merges: np.ndarray, n: int) -> np.ndarray:
    """Convert (maskA, maskB) merges to the Python solvers' convention:
    a (2, n-1) array of *current-list* index pairs (i < j), where the
    contraction result replaces position ``i`` and position ``j`` is
    deleted."""
    current = [1 << i for i in range(n)]
    out = []
    for (ma, mb) in merges:
        i = current.index(int(ma))
        j = current.index(int(mb))
        if i > j:
            i, j = j, i
        out.append((i, j))
        current[i] = int(ma) | int(mb)
        del current[j]
    return np.asarray(out, dtype=int).T.reshape(2, -1)
