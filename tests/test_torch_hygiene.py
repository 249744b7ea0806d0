"""The port stands alone: no JAX, and no silent fall back to the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tensornetwork_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
bad = [m for m in sys.modules
       if m.startswith("jax") or m == "tensornetwork_tpu"
       or m.startswith("tensornetwork_tpu.")]
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    # "tensornetwork_tpu_torch" itself starts with "tensornetwork_tpu":
    # only the package of that exact name and its submodules count
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_no_jax():
    # chip_smoke.py drives the port on the card, where JAX is not installed
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert "tensornetwork_tpu_torch" in {m.split(".")[0] for m in names}
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "tensornetwork_tpu")]


def test_entry_points_raise_without_cuda(monkeypatch):
    from tensornetwork_tpu_torch import BatchedDMRG, FiniteDMRG, FiniteTFI
    from tensornetwork_tpu_torch.config import default_device
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        FiniteTFI(1.0, 1.0, N=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_mps_stack(0, 4, 2)
    mpo = FiniteTFI(1.0, 1.0, N=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        FiniteDMRG(np.zeros((4, 2, 2, 2)), mpo)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedDMRG(np.zeros((1, 4, 2, 2, 2)), mpo)
    # an explicit CPU request, or CPU tensors, run on the CPU
    assert default_device("cpu").type == "cpu"
    assert random_mps_stack(0, 4, 2, device="cpu").device.type == "cpu"
    assert FiniteDMRG(torch.zeros((4, 2, 2, 2)), mpo).As.device.type == "cpu"


def test_highest_precision_restores_settings():
    from tensornetwork_tpu_torch.config import highest_precision

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    with highest_precision():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before


def test_kernel_build_key_covers_every_source():
    from tensornetwork_tpu_torch.ops import _build

    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()
    assert {p.name for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == set(_build.HEADERS)
    assert len(_build.build_key()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS


def test_every_kernel_has_its_source_and_a_launch_count():
    from tensornetwork_tpu_torch.ops import _build, kernels

    assert set(kernels._SOURCES) == set(kernels._ARGTYPES)
    assert set(kernels._SOURCES.values()) == set(_build.SOURCES)
    # the C entry points are tn_<name>, counted under <name>
    assert {f[3:] for f in kernels._SOURCES} == set(kernels.launch_counts)
    assert set(kernels._TYPES) == set(kernels._SOURCES)
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        assert ("Replaces: tensornetwork_tpu/ops/kernels.py" in text
                or "Replaces: benchmarks/mxu_micro.py" in text), src
        for fn in (f for f, s in kernels._SOURCES.items() if s == src):
            for dtype in kernels._TYPES[fn]:
                assert f'extern "C" int {fn}{kernels._SUFFIX[dtype]}' in text


def test_every_entry_point_takes_its_argtypes():
    # ctypes passes exactly the argtypes: each C entry point's parameter
    # list must have as many entries, or a launch passes the wrong values
    import re

    from tensornetwork_tpu_torch.ops import _build, kernels

    for fn, src in kernels._SOURCES.items():
        text = (_build.CSRC / src).read_text()
        for dtype in kernels._TYPES[fn]:
            name = fn + kernels._SUFFIX[dtype]
            params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
            assert params, name
            assert (len(params.group(1).split(","))
                    == len(kernels._ARGTYPES[fn])), name


def _port_sources():
    return sorted((REPO / "tensornetwork_tpu_torch").rglob("*.py"))


def test_port_imports_no_opt_einsum():
    # torch imports opt_einsum by itself where it is installed, so a
    # sys.modules check cannot tell; the card's machine has none
    for path in _port_sources() + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] == "opt_einsum"], \
            path


def test_port_reads_no_file_of_the_jax_package():
    """No string in the port's code (docstrings aside) names a path in
    the JAX package's directory: the port keeps its own copies, such as
    native/pathsolver.cpp."""
    import re

    component = re.compile(r"(^|[/\\])tensornetwork_tpu([/\\]|$)")
    for path in _port_sources():
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        bad = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and id(n) not in docs and component.search(n.value)]
        assert not bad, (path, bad)
    from tensornetwork_tpu_torch import native

    assert native._SRC.parent == REPO / "tensornetwork_tpu_torch" / "native"
    assert native.BUILD_ROOT == REPO / "tensornetwork_tpu_torch" / "build"


def test_graph_core_and_ncon_raise_without_cuda(monkeypatch):
    from tensornetwork_tpu_torch import (CopyNode, Node, ncon,
                                         nodes_from_json, nodes_to_json)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((2, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        Node(a)
    with pytest.raises(RuntimeError, match="CUDA"):
        ncon([a, a.T], [(-1, 1), (1, -2)])
    with pytest.raises(RuntimeError, match="CUDA"):
        CopyNode(2, 3).tensor
    text = nodes_to_json([Node(torch.ones(2, 3))])
    with pytest.raises(RuntimeError, match="CUDA"):
        nodes_from_json(text)
    # CPU tensors, or an explicit CPU request, stay on the CPU
    t = torch.from_numpy(a)
    assert Node(t).tensor.device.type == "cpu"
    assert ncon([t, t.T], [(-1, 1), (1, -2)]).device.type == "cpu"
    assert CopyNode(2, 3, device="cpu").tensor.device.type == "cpu"
    assert nodes_from_json(text, device="cpu")[0][0].tensor.device.type \
        == "cpu"


def test_block_sparse_entry_points_raise_without_cuda(monkeypatch):
    from tensornetwork_tpu_torch import (BatchedSymmetricDMRG,
                                         BlockSparseTensor, Index, U1Charge,
                                         half_filled_mps, u1_xxz_mpo)
    from tensornetwork_tpu_torch import blocksparse as bs
    from tensornetwork_tpu_torch.blocksparse import batched
    from tensornetwork_tpu_torch.blocksparse.torch_engine import to_device

    idx = [Index(U1Charge(np.array([0, 1])), False),
           Index(U1Charge(np.array([0, 1])), True)]
    skel = batched.uniform_skeleton_mps(4, 4, device="cpu")
    mpo = u1_xxz_mpo(1.0, 1.0, 0.0, 4, device="cpu")
    cpu = bs.randn(idx, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: BlockSparseTensor(np.ones(2), *_structure(idx)),
                 lambda: bs.randn(idx), lambda: bs.zeros(idx),
                 lambda: bs.eye(idx[0]),
                 lambda: BlockSparseTensor.fromdense(idx, np.eye(2)),
                 lambda: batched.uniform_skeleton_mps(4, 4),
                 lambda: batched.random_data_batch(skel, 2),
                 lambda: u1_xxz_mpo(1.0, 1.0, 0.0, 4),
                 lambda: half_filled_mps(4, 4),
                 lambda: to_device(cpu),
                 lambda: BatchedSymmetricDMRG(
                     skel, [np.zeros((2, t.data.shape[0])) for t in skel],
                     mpo)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # CPU tensors, or an explicit CPU request, stay on the CPU
    assert cpu.todense().device.type == "cpu"
    assert bs.tensordot(cpu, cpu.conj(), [[0, 1], [0, 1]]).device.type \
        == "cpu"
    data = batched.random_data_batch(skel, 2, device="cpu")
    assert BatchedSymmetricDMRG(skel, data, mpo).device.type == "cpu"


def _structure(indices):
    from tensornetwork_tpu_torch.blocksparse.tensor import _expand_indices
    return _expand_indices(indices)
