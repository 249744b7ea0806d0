"""Device execution for block-sparse contractions.

Counterpart of :mod:`tensornetwork_tpu.blocksparse.jax_engine`.  The host
computes the sector metadata exactly as the per-sector loop of
:func:`tensornetwork_tpu_torch.blocksparse.tensor.tensordot` does (charge
fusion, block maps, matching); what runs on the device is a "sector
plan": sectors are *shape-bucketed* -- every sector whose GEMM rounds to
the same padded (R, K, C) joins one bucket, and each bucket is one gather
(``index_select`` of padded index maps), one batched GEMM
(``torch.matmul``, the bucket's sectors and a leading instance axis
folded into its batch) and one scatter (``index_copy_``).  Padding
gathers read a zero tail appended to each operand (exact zeros, no
masks); padded scatter positions all land in one dummy slot at the end of
the output, which is cut off before anything reads it.  Real positions
are written once each, so repeat runs give the same bits.

The executor takes a leading batch axis natively: operands of shape
``(B, nnz)`` (or ``(nnz,)``) give ``(B, nnz_out)``; the JAX package gets
that axis from ``vmap``.  Plans (host index arrays, and their copies on
each device they ran on) are cached per (structures, axes).  The bucket
rounding, :func:`_round_dim`, is the JAX package's TPU rule (128-wide MXU
tiles); the padded and true flops of a plan are in :func:`plan_flops`.
The JAX package's windowed (``dynamic_slice``) fetch of wide runs is a
TPU memory-system rule and is not ported: one ``index_select`` gathers
any run width.  The sector-sharded (EP) executors wait for the
multi-device slice.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, _check_contracted_legs, _lookup_key,
    _sector_triples, compute_num_nonzero, device_index, normalize_axes,
    outerproduct, tensordot_structure, transpose_perm)
from tensornetwork_tpu_torch.config import default_device, highest_precision

_PLAN_CACHE: "OrderedDict" = OrderedDict()
_PLAN_CACHE_CAPACITY = 512  # plans pin device index maps; bound the cache


def _structure_key(t: BlockSparseTensor):
    return _lookup_key(t._charges, t._flows, 0) + (
        tuple(tuple(g) for g in t._order),)


def skeleton(charges, flows, order, dtype=torch.float32,
             nnz: Optional[int] = None) -> BlockSparseTensor:
    """A structure without storage: its data lives on the ``meta``
    device, so only its length and dtype are real."""
    if nnz is None:
        nnz = compute_num_nonzero(charges, flows)
    return BlockSparseTensor(torch.empty(nnz, dtype=dtype, device="meta"),
                             charges, flows, order)


def _build_plan(t1: BlockSparseTensor, t2: BlockSparseTensor,
                axes1: List[int], axes2: List[int]):
    """Host metadata of the executor; mirrors ``tensor.tensordot`` and
    reads no data."""
    st = tensordot_structure(t1, t2, axes1, axes2)
    perm1 = (None if st["flat_perm1"] == list(range(len(t1._charges)))
             else transpose_perm(t1._charges, t1._flows, st["flat_perm1"]))
    perm2 = (None if st["flat_perm2"] == list(range(len(t2._charges)))
             else transpose_perm(t2._charges, t2._flows, st["flat_perm2"]))
    maps1, maps2, maps_out, shapes1, shapes2, triples = _sector_triples(st)
    sectors = [(maps1[s1], maps2[s2], None if so is None else maps_out[so],
                shapes1[s1], shapes2[s2]) for s1, s2, so in triples]
    out = None
    if maps_out is not None:
        out = dict(nnz=compute_num_nonzero(st["out_charges"],
                                           st["out_flows"]),
                   charges=st["out_charges"], flows=st["out_flows"],
                   order=st["out_order"])
    return dict(perm1=perm1, perm2=perm2, sectors=sectors,
                scalar=maps_out is None, out=out,
                nnz1=t1.data.shape[0], nnz2=t2.data.shape[0])


def _round_dim(x: int) -> int:
    """Bucket rounding: small dims to the next power of two (>=8), large
    dims to the next multiple of 128 (the JAX package's MXU tile)."""
    if x >= 128:
        return ((x + 127) // 128) * 128
    p = 8
    while p < x:
        p *= 2
    return p


def _build_buckets(plan):
    """Group sectors by padded GEMM shape so that each bucket executes as
    ONE batched matmul instead of one underfilled GEMM per charge sector.
    Each bucket holds padded (G, R, K), (G, K, C) and (G, R, C) index maps
    into the operands (padding: the zero slot at ``nnz``) and the output
    (padding: the dummy slot at ``nnz_out``)."""
    groups = {}
    for (m1, m2, mo, s1, s2) in plan["sectors"]:
        key = (_round_dim(s1[0]), _round_dim(s1[1]), _round_dim(s2[1]))
        groups.setdefault(key, []).append((m1, m2, mo, s1, s2))
    nnz_out = 0 if plan["scalar"] else plan["out"]["nnz"]
    buckets = []
    for (R, K, C), secs in groups.items():
        G = len(secs)
        M1 = np.full((G, R, K), plan["nnz1"], dtype=np.int64)
        M2 = np.full((G, K, C), plan["nnz2"], dtype=np.int64)
        MO = np.full((G, R, C), nnz_out, dtype=np.int64)
        for g, (m1, m2, mo, s1, s2) in enumerate(secs):
            M1[g, : s1[0], : s1[1]] = m1
            M2[g, : s2[0], : s2[1]] = m2
            if mo is not None:
                MO[g, : s1[0], : s2[1]] = mo
        buckets.append(dict(R=R, K=K, C=C, G=G, M1=M1, M2=M2,
                            MO=None if plan["scalar"] else MO))
    return buckets


def plan_flops(plan) -> Tuple[int, int]:
    """(true, padded) multiply-add flops of one instance: 2 r k c summed
    over the sectors, and over the padded bucket GEMMs."""
    true = sum(2 * s1[0] * s1[1] * s2[1]
               for (_, _, _, s1, s2) in plan["sectors"])
    padded = sum(2 * b["G"] * b["R"] * b["K"] * b["C"]
                 for b in plan["buckets"])
    return true, padded


class DeviceMaps:
    """Host int64 index arrays, and their copies on each device they were
    used on (made once)."""

    def __init__(self):
        self.host: List[np.ndarray] = []
        self._dev: Dict[str, List[torch.Tensor]] = {}

    def add(self, arr: Optional[np.ndarray]) -> Optional[int]:
        """The slot of ``arr`` (None stays None)."""
        if arr is None:
            return None
        self.host.append(arr)
        return len(self.host) - 1

    def on(self, device) -> List[torch.Tensor]:
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = [device_index(a, device) for a in self.host]
        return self._dev[key]


def _get_plan(t1, t2, axes1, axes2, precision="highest"):
    key = (_structure_key(t1), _structure_key(t2), tuple(axes1),
           tuple(axes2), precision)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan
    plan = _build_plan(t1, t2, axes1, axes2)
    plan["buckets"] = _build_buckets(plan)
    plan["precision"] = precision
    maps = plan["maps"] = DeviceMaps()
    plan["perm_slots"] = [maps.add(plan["perm1"]), maps.add(plan["perm2"])]
    for b in plan["buckets"]:
        b["slots"] = [None if b[k] is None else maps.add(b[k].reshape(-1))
                      for k in ("M1", "M2", "MO")]
    plan["run"] = _make_executor(plan)
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_CAPACITY:
        _PLAN_CACHE.popitem(last=False)
    return plan


def _make_executor(plan):
    """The contraction executor of a plan: ``run(d1, d2)`` maps data of
    shapes ``(..., nnz1)`` and ``(..., nnz2)`` (leading axes broadcast) to
    ``(..., nnz_out)``, or ``(...)`` for a full contraction."""

    def run(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        lead = torch.broadcast_shapes(d1.shape[:-1], d2.shape[:-1])
        B = int(np.prod(lead, dtype=np.int64))
        dtype = torch.promote_types(d1.dtype, d2.dtype)
        dev = d1.device
        on = plan["maps"].on(dev)

        def slot(i):
            return None if i is None else on[i]

        ctx = (highest_precision() if plan["precision"] == "highest"
               else contextlib.nullcontext())

        def operand(d, perm, nnz):
            d = d.to(dtype).expand(lead + (nnz,)).reshape(B, nnz)
            if perm is not None:
                d = d.index_select(1, perm)
            # zero tail: every padded index reads exact zeros
            return torch.cat([d, d.new_zeros(B, 1)], dim=1)

        with ctx:
            d1x = operand(d1, slot(plan["perm_slots"][0]), plan["nnz1"])
            d2x = operand(d2, slot(plan["perm_slots"][1]), plan["nnz2"])
            if plan["scalar"]:
                total = torch.zeros(B, dtype=dtype, device=dev)
            else:
                nnz_out = plan["out"]["nnz"]
                # the last slot absorbs every padded scatter position
                out = torch.zeros(B, nnz_out + 1, dtype=dtype, device=dev)
            for b in plan["buckets"]:
                M1, M2, MO = (slot(i) for i in b["slots"])
                b1 = d1x.index_select(1, M1).view(B, b["G"], b["R"], b["K"])
                b2 = d2x.index_select(1, M2).view(B, b["G"], b["K"], b["C"])
                res = torch.matmul(b1, b2)
                if plan["scalar"]:
                    total = total + res.sum(dim=(1, 2, 3))
                else:
                    out.index_copy_(1, MO, res.reshape(B, -1))
            if plan["scalar"]:
                return total.reshape(lead)
            return out[:, :nnz_out].reshape(lead + (nnz_out,))

    return run


def out_skeleton(plan, dtype=torch.float32) -> BlockSparseTensor:
    """Storage-free skeleton of a plan's output."""
    o = plan["out"]
    return skeleton([c.copy() for c in o["charges"]], list(o["flows"]),
                    [list(g) for g in o["order"]], dtype, o["nnz"])


def tensordot_device(
    t1: BlockSparseTensor,
    t2: BlockSparseTensor,
    axes: Union[int, Sequence[Sequence[int]]] = 2,
    precision: str = "highest",
):
    """Sector tensordot by the bucketed executor, on the operands' device.

    Returns a BlockSparseTensor whose data stays on that device (a 0-d
    tensor for a full contraction).  Metadata is host-cached per charge
    structure; ``precision="highest"`` runs the GEMMs with TF32 off."""
    axes1, axes2 = normalize_axes(t1, t2, axes)
    if len(axes1) == 0:
        return outerproduct(t1, t2)
    _check_contracted_legs(t1, t2, axes1, axes2)
    plan = _get_plan(t1, t2, axes1, axes2, precision)
    result = plan["run"](t1.data, t2.data)
    if plan["scalar"]:
        return result
    o = plan["out"]
    return BlockSparseTensor(result, list(o["charges"]), list(o["flows"]),
                             [list(g) for g in o["order"]])


def to_device(t: BlockSparseTensor, device=None) -> BlockSparseTensor:
    """A block-sparse tensor with its data on ``device`` (default: the
    card), so that chained contractions never copy it again."""
    return t.to(default_device(device))


def from_device(t: BlockSparseTensor) -> BlockSparseTensor:
    """A block-sparse tensor with its data on the host CPU."""
    return t.to("cpu")


def clear_plan_cache():
    _PLAN_CACHE.clear()
