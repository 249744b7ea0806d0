"""Device, dtype and precision settings of the PyTorch port.

Counterpart of :mod:`tensornetwork_tpu.config`.  The port runs on the CUDA
card unless the caller hands it CPU tensors or asks for ``device="cpu"``;
it never drops to the CPU on its own.  ``Config`` and its stack
(:func:`get_config`, :func:`config_context`) set the precision and result
dtype of ``ncon``'s and the graph core's pairwise products.  XLA's
on-disk compilation cache has no counterpart: the port's kernels are
cached by ``ops/_build.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

# Constructor dtype when none is given: the widest float, as the JAX
# package resolves it under x64.  The main path passes float32 explicitly.
DEFAULT_DTYPE = torch.float64

Device = Union[str, torch.device]


def default_device(device: Optional[Device] = None) -> torch.device:
    """``device`` if given, else the CUDA card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tensornetwork_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' (or CPU tensors) to run "
            "on the CPU")
    return torch.device("cuda")


def as_tensor(x, device: Optional[Device] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; anything
    else (numpy arrays, lists) goes to :func:`default_device`."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    if isinstance(x, np.ndarray) and dtype is None:
        return torch.as_tensor(x, device=default_device(device))
    return torch.as_tensor(x, dtype=dtype, device=default_device(device))


@contextlib.contextmanager
def highest_precision():
    """Full fp32 in every matmul and convolution: TF32 off for cuBLAS and
    cuDNN, float32 matmul precision "highest".  Restores the caller's
    settings on exit.  Counterpart of the JAX sweeps'
    ``jax.default_matmul_precision("highest")``: reduced-precision products
    make the Lanczos projection non-variational."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


@dataclasses.dataclass(frozen=True)
class Config:
    """Framework-wide knobs, as the JAX package's ``Config``.

    Attributes:
      dot_precision: ``"highest"`` runs every pairwise product of ``ncon``
        and of the graph core with TF32 off (:func:`highest_precision`);
        ``"high"`` and ``"default"`` leave the caller's matmul settings.
      preferred_element_type: result dtype of each pairwise product
        (``None``: the operands' promoted dtype).  The product is computed
        in the wider of the two and cast to it.
      bucket_sizes: bond-dimension buckets (:func:`bucket_dim`).
      max_paths_optimal: below this operand count the ``auto`` contractor
        uses the optimal path solver.
    """
    dot_precision: str = "highest"
    preferred_element_type: Optional[torch.dtype] = None
    bucket_sizes: tuple = (8, 16, 32, 64, 128, 256, 512, 1024)
    max_paths_optimal: int = 5

    def __post_init__(self):
        if self.dot_precision not in _PRECISIONS:
            raise ValueError(f"unknown dot_precision {self.dot_precision!r}; "
                             f"expected one of {_PRECISIONS}")

    def precision(self):
        """The context every pairwise product of this config runs in."""
        if self.dot_precision == "highest":
            return highest_precision()
        return contextlib.nullcontext()

    def result_dtype(self, *tensors: torch.Tensor) -> Tuple[torch.dtype,
                                                            torch.dtype]:
        """(dtype to compute in, dtype of the result) of a product of
        ``tensors``."""
        dtype = functools.reduce(torch.promote_types,
                                 (t.dtype for t in tensors))
        out = self.preferred_element_type
        if out is None:
            return dtype, dtype
        return torch.promote_types(dtype, out), out


_PRECISIONS = ("default", "high", "highest")
_CONFIG_STACK = [Config()]


def get_config() -> Config:
    return _CONFIG_STACK[-1]


@contextlib.contextmanager
def config_context(config: Config):
    _CONFIG_STACK.append(config)
    try:
        yield config
    finally:
        _CONFIG_STACK.pop()


def bucket_dim(dim: int, config: Optional[Config] = None) -> int:
    """Round a bond dimension up to the nearest bucket boundary."""
    config = config or get_config()
    for b in config.bucket_sizes:
        if dim <= b:
            return b
    return dim


# The reference library's default-backend stack: PyTorch is the only
# execution layer here, so these validate and record the name only.
_DEFAULT_BACKEND = "pytorch"
_KNOWN_BACKENDS = ("jax", "numpy", "tensorflow", "pytorch", "symmetric")


def set_default_backend(backend: str) -> None:
    global _DEFAULT_BACKEND
    if backend not in _KNOWN_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "pytorch":
        warnings.warn(
            f"backend {backend!r} is accepted for API parity only; "
            f"execution always goes through PyTorch")
    _DEFAULT_BACKEND = backend


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


class DefaultBackend:
    """Context manager setting the default backend name."""

    def __init__(self, backend: str):
        self.backend = backend
        self._prev = None

    def __enter__(self):
        self._prev = _DEFAULT_BACKEND
        set_default_backend(self.backend)
        return self

    def __exit__(self, *a):
        global _DEFAULT_BACKEND
        _DEFAULT_BACKEND = self._prev


def enable_persistent_compilation_cache(path: str,
                                        min_compile_time_secs: float = 1.0
                                        ) -> None:
    """Point the port's on-disk build caches at ``path``: the CUDA kernels'
    libraries (``ops._build.BUILD_ROOT``) and the native path solver's
    (``native.BUILD_ROOT``), each keyed by a hash of its sources and flags
    under ``path``.  Counterpart of the JAX function that turns on XLA's
    compilation cache; without a call both stay in the package's
    ``build/``.  Libraries already loaded stay loaded.  Safe to call more
    than once.

    ``min_compile_time_secs`` is the JAX function's argument, accepted and
    ignored: every build is cached, however short."""
    from pathlib import Path

    from tensornetwork_tpu_torch import native
    from tensornetwork_tpu_torch.ops import _build
    _build.BUILD_ROOT = native.BUILD_ROOT = Path(path)
