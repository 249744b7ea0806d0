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
any run width.

The sector-sharded (EP) executors run each rank's share of the sectors
over ``torch.distributed``: ``ep=(ndev, group)`` in :func:`_get_plan`
gives the rank its G/P slice of every bucket and one ``all_reduce`` a
contraction (the sector outputs have disjoint support, so the sum is the
reassembly); :func:`make_chain_executor` assigns whole dependency
components of a contraction chain to ranks (:func:`_partition_chain`)
and issues one collective a chain, or none (``reduce="none"``: each rank
keeps its partial, for the capacity layout's reduce-scatter).  Both run
at every world size, 1 included.

A single-device plan can be saved and restored without its host build:
:func:`plan_to_record` gives its index maps and metadata, and a cache
miss inside :func:`preloaded` restores the plan of that key from its
record (:mod:`~tensornetwork_tpu_torch.blocksparse.plan_store` is the
file).  :func:`recording` collects the plans a block of code is handed,
and ``build_counts`` counts the host builds.
"""
from __future__ import annotations

import contextlib
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse.plan_store import charge_from_spec
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, _check_contracted_legs, _lookup_key,
    _sector_triples, compute_num_nonzero, device_index, normalize_axes,
    outerproduct, tensordot_structure, transpose_perm)
from tensornetwork_tpu_torch.config import default_device, highest_precision
from tensornetwork_tpu_torch.utils import tracing

_PLAN_CACHE: "OrderedDict" = OrderedDict()
_PLAN_CACHE_CAPACITY = 512  # plans pin device index maps; bound the cache
# host builds of plan metadata: contraction plans (every call of
# _build_plan) and the gauge shifts' plans (blocksparse.batched.ShiftPlan)
build_counts = {"plans": 0, "shift_plans": 0}
# the lists that recording() fills, and the records preloaded() offers
_RECORDERS: List[list] = []
_PENDING: Dict[str, Callable] = {}


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
    build_counts["plans"] += 1
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


def _build_buckets(plan, pad_groups_to: int = 1):
    """Group sectors by padded GEMM shape so that each bucket executes as
    ONE batched matmul instead of one underfilled GEMM per charge sector.
    Each bucket holds padded (G, R, K), (G, K, C) and (G, R, C) index maps
    into the operands (padding: the zero slot at ``nnz``) and the output
    (padding: the dummy slot at ``nnz_out``), and the true flops of each
    real group (``flops``).  ``pad_groups_to``: G is
    rounded up to a multiple of it with all-padding groups (the EP
    executor splits every bucket in equal rank slices)."""
    groups = {}
    for (m1, m2, mo, s1, s2) in plan["sectors"]:
        key = (_round_dim(s1[0]), _round_dim(s1[1]), _round_dim(s2[1]))
        groups.setdefault(key, []).append((m1, m2, mo, s1, s2))
    nnz_out = 0 if plan["scalar"] else plan["out"]["nnz"]
    buckets = []
    for (R, K, C), secs in groups.items():
        G = -(-len(secs) // pad_groups_to) * pad_groups_to
        M1 = np.full((G, R, K), plan["nnz1"], dtype=np.int64)
        M2 = np.full((G, K, C), plan["nnz2"], dtype=np.int64)
        MO = np.full((G, R, C), nnz_out, dtype=np.int64)
        for g, (m1, m2, mo, s1, s2) in enumerate(secs):
            M1[g, : s1[0], : s1[1]] = m1
            M2[g, : s2[0], : s2[1]] = m2
            if mo is not None:
                MO[g, : s1[0], : s2[1]] = mo
        buckets.append(dict(R=R, K=K, C=C, G=G, M1=M1, M2=M2,
                            MO=None if plan["scalar"] else MO,
                            flops=[2 * s1[0] * s1[1] * s2[1]
                                   for (_, _, _, s1, s2) in secs]))
    return buckets


def plan_flops(plan) -> Tuple[int, int]:
    """(true, padded) multiply-add flops of one instance: 2 r k c summed
    over the sectors, and over the padded bucket GEMMs."""
    true = sum(2 * s1[0] * s1[1] * s2[1]
               for (_, _, _, s1, s2) in plan["sectors"])
    padded = sum(2 * b["G"] * b["R"] * b["K"] * b["C"]
                 for b in plan["buckets"])
    return true, padded


def _plan_work(plan) -> Tuple[int, int, int]:
    """(true flops, padded flops, bucket GEMMs) of one instance's run of
    a plan's executor: :func:`plan_flops`, of this rank's share for a
    sector-sharded plan."""
    true, padded = plan_flops(plan)
    if plan["ep"] is not None:
        true = sum(sum(b["flops"]) for b in plan["buckets"])
    return true, padded, len(plan["buckets"])


def _count_work(B: int, work: Tuple[int, int, int]) -> None:
    """An executor run's work on ``B`` instances, in the tracing
    counters."""
    true, padded, gemms = work
    tracing.add("bs_true_flops", B * true)
    tracing.add("bs_padded_flops", B * padded)
    tracing.add("bs_gemms", gemms)


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


def plan_key_digest(key) -> str:
    """sha256 of a plan's cache key: its name in a plan file."""
    return hashlib.sha256(repr(key).encode()).hexdigest()


@contextlib.contextmanager
def recording():
    """Collects ``(key, plan)`` of every plan :func:`_get_plan` hands out
    inside the block, cached or built: the plans one program replays."""
    used: list = []
    _RECORDERS.append(used)
    try:
        yield used
    finally:
        _RECORDERS.pop()


@contextlib.contextmanager
def preloaded(records: Dict[str, Callable]):
    """Inside the block, a cache miss whose key digest is in ``records``
    (digest -> a function returning ``(meta, arrays)`` of
    :func:`plan_to_record`) restores that plan instead of building it."""
    _PENDING.update(records)
    try:
        yield
    finally:
        for digest in records:
            _PENDING.pop(digest, None)


def _get_plan(t1, t2, axes1, axes2, precision="highest", ep=None):
    """The cached plan and executor of a contraction.  ``ep=(ndev,
    group)``: the sector-sharded executor of this rank of ``group`` (its
    G/ndev slice of every bucket, one all_reduce a contraction)."""
    key = (_structure_key(t1), _structure_key(t2), tuple(axes1),
           tuple(axes2), precision, ep)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
    else:
        record = _PENDING.get(plan_key_digest(key)) if _PENDING else None
        plan = (_new_plan(t1, t2, axes1, axes2, precision, ep)
                if record is None else plan_from_record(*record()))
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAPACITY:
            _PLAN_CACHE.popitem(last=False)
    for used in _RECORDERS:
        used.append((key, plan))
    return plan


def _new_plan(t1, t2, axes1, axes2, precision, ep):
    plan = _build_plan(t1, t2, axes1, axes2)
    if ep is None:
        plan["buckets"] = _build_buckets(plan)
    else:
        from tensornetwork_tpu_torch.parallel import collectives
        ndev, group = ep
        rank = collectives.group_rank(group)
        plan["buckets"] = []
        for b in _build_buckets(plan, pad_groups_to=ndev):
            g = b["G"] // ndev
            sl = slice(rank * g, (rank + 1) * g)
            if g:
                plan["buckets"].append(dict(
                    b, G=g, M1=b["M1"][sl], M2=b["M2"][sl],
                    MO=None if b["MO"] is None else b["MO"][sl],
                    flops=b["flops"][sl]))
    # the per-sector maps live on in the buckets; keep the shapes only
    plan["sectors"] = [(None, None, None, s1, s2)
                       for (_, _, _, s1, s2) in plan["sectors"]]
    plan["precision"] = precision
    plan["ep"] = ep
    plan["work"] = _plan_work(plan)
    maps = plan["maps"] = DeviceMaps()
    plan["perm_slots"] = [maps.add(plan["perm1"]), maps.add(plan["perm2"])]
    for b in plan["buckets"]:
        b["slots"] = [None if b[k] is None else maps.add(b[k].reshape(-1))
                      for k in ("M1", "M2", "MO")]
    plan["run"] = _make_executor(plan)
    return plan


def plan_to_record(plan) -> Tuple[dict, List[np.ndarray]]:
    """``(meta, arrays)`` of a single-device plan: JSON-able metadata, and
    its host index maps, output charges and sector shapes.  The executor is
    not saved; :func:`plan_from_record` makes it anew."""
    if plan["ep"] is not None:
        raise ValueError("a sector-sharded plan belongs to its process group")
    arrays = list(plan["maps"].host)
    out = None
    if plan["out"] is not None:
        o = plan["out"]
        out = dict(nnz=int(o["nnz"]), flows=[bool(f) for f in o["flows"]],
                   order=[[int(i) for i in g] for g in o["order"]],
                   types=[[t.__name__ for t in c.charge_types]
                          for c in o["charges"]])
        arrays += [c.charges for c in o["charges"]]
    arrays.append(np.array([list(s1) + list(s2)
                            for (*_, s1, s2) in plan["sectors"]],
                           dtype=np.int64).reshape(-1, 4))
    meta = dict(n_maps=len(plan["maps"].host),
                perm_slots=plan["perm_slots"], scalar=bool(plan["scalar"]),
                nnz1=int(plan["nnz1"]), nnz2=int(plan["nnz2"]),
                precision=plan["precision"], out=out,
                buckets=[[b["R"], b["K"], b["C"], b["G"], b["slots"]]
                         for b in plan["buckets"]])
    return meta, arrays


def plan_from_record(meta: dict, arrays: Sequence[np.ndarray]):
    """The plan of :func:`plan_to_record`'s record, with a new executor:
    the same buckets in the same order, so it replays the same bits."""
    n = meta["n_maps"]
    maps = DeviceMaps()
    maps.host = list(arrays[:n])
    out, k = None, n
    if meta["out"] is not None:
        o = meta["out"]
        out = dict(nnz=o["nnz"], flows=list(o["flows"]),
                   order=[list(g) for g in o["order"]],
                   charges=[charge_from_spec(arrays[k + i], types)
                            for i, types in enumerate(o["types"])])
        k += len(o["types"])

    def host(slot):
        return None if slot is None else maps.host[slot]

    buckets = [dict(R=R, K=K, C=C, G=G,
                    M1=host(slots[0]).reshape(G, R, K),
                    M2=host(slots[1]).reshape(G, K, C),
                    MO=None if slots[2] is None
                    else host(slots[2]).reshape(G, R, C),
                    slots=list(slots))
               for R, K, C, G, slots in meta["buckets"]]
    slots = meta["perm_slots"]
    plan = dict(perm1=host(slots[0]), perm2=host(slots[1]),
                sectors=[(None, None, None, (r, c1), (r2, c))
                         for r, c1, r2, c in arrays[k].tolist()],
                scalar=meta["scalar"], out=out, nnz1=meta["nnz1"],
                nnz2=meta["nnz2"], buckets=buckets,
                precision=meta["precision"], ep=None, maps=maps,
                perm_slots=list(slots))
    plan["work"] = _plan_work(plan)
    plan["run"] = _make_executor(plan)
    return plan


def _make_executor(plan):
    """The contraction executor of a plan: ``run(d1, d2)`` maps data of
    shapes ``(..., nnz1)`` and ``(..., nnz2)`` (leading axes broadcast) to
    ``(..., nnz_out)``, or ``(...)`` for a full contraction."""

    @tracing.spanned("bs_exec")
    def run(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        lead = torch.broadcast_shapes(d1.shape[:-1], d2.shape[:-1])
        B = int(np.prod(lead, dtype=np.int64))
        _count_work(B, plan["work"])
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
            if plan["ep"] is not None:
                # disjoint sector outputs: the sum over ranks IS the
                # reassembly, one all_reduce a contraction
                from tensornetwork_tpu_torch.parallel import collectives
                group = plan["ep"][1]
                if plan["scalar"]:
                    total = collectives.all_reduce(total, group)
                else:
                    out = collectives.all_reduce(out[:, :nnz_out], group)
            if plan["scalar"]:
                return total.reshape(lead)
            return out[:, :nnz_out].reshape(lead + (nnz_out,))

    return run


# ---------------------------------------------------------------------------
# The fused EP executor of a contraction chain
# ---------------------------------------------------------------------------

_CHAIN_CACHE: "OrderedDict" = OrderedDict()
_CHAIN_CACHE_CAPACITY = 64


class _UnionFind:
    def __init__(self, n: int):
        self.p = np.arange(n)

    def find(self, i: int) -> int:
        p = self.p
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def _partition_chain(raws, ndev: int):
    """Assign every (stage, sector) of a chain to a rank.

    Components of the read/write dependency graph are FLOP-weighted and
    greedily bin-packed onto ``ndev`` ranks (heaviest first).  Sectors
    whose through-operand input is structurally never written are dead
    (they contribute exact zeros) and dropped; sectors whose output no
    live downstream sector reads are pruned backwards.

    Returns ``(assign, bins)``: a list over stages of int arrays (the rank
    of each sector, -1 = dropped) and the FLOPs of each rank."""
    n_stages = len(raws)
    counts = [len(r["sectors"]) for r in raws]
    offsets = np.cumsum([0] + counts)
    uf = _UnionFind(offsets[-1])
    live = [np.ones(c, bool) for c in counts]

    prev_writer = None
    for k, raw in enumerate(raws):
        if k > 0:
            perm = raw["perm1"]
            for t, (m1, _m2, _mo, _s1, _s2) in enumerate(raw["sectors"]):
                pos = m1.ravel()
                if perm is not None:
                    pos = perm[pos]
                ws = np.unique(prev_writer[pos])
                ws = ws[ws >= 0]
                if ws.size == 0:
                    live[k][t] = False
                    continue
                for w in ws:
                    uf.union(offsets[k] + t, offsets[k - 1] + int(w))
        wv = np.full(raw["out"]["nnz"], -1, np.int64)
        for t, (_m1, _m2, mo, _s1, _s2) in enumerate(raw["sectors"]):
            if live[k][t]:
                wv[mo.ravel()] = t
        prev_writer = wv

    # backward prune: a sector below the last stage whose output no live
    # downstream sector reads only produces dead intermediates
    for k in range(n_stages - 2, -1, -1):
        nxt = raws[k + 1]
        perm = nxt["perm1"]
        read = np.zeros(raws[k]["out"]["nnz"], bool)
        for t, (m1, _m2, _mo, _s1, _s2) in enumerate(nxt["sectors"]):
            if live[k + 1][t]:
                pos = m1.ravel()
                if perm is not None:
                    pos = perm[pos]
                read[pos] = True
        for t, (_m1, _m2, mo, _s1, _s2) in enumerate(raws[k]["sectors"]):
            if live[k][t] and not read[mo.ravel()].any():
                live[k][t] = False

    comp_weight: dict = {}
    comp_nodes: dict = {}
    for k, raw in enumerate(raws):
        for t, (_m1, _m2, _mo, s1, s2) in enumerate(raw["sectors"]):
            if not live[k][t]:
                continue
            root = uf.find(offsets[k] + t)
            w = 2 * s1[0] * s1[1] * s2[1]  # GEMM flops
            comp_weight[root] = comp_weight.get(root, 0) + w
            comp_nodes.setdefault(root, []).append((k, t))
    bins = np.zeros(ndev, np.float64)
    dev_of_comp = {}
    for root in sorted(comp_weight, key=comp_weight.get, reverse=True):
        d = int(np.argmin(bins))
        bins[d] += comp_weight[root]
        dev_of_comp[root] = d
    assign = [np.full(c, -1, np.int32) for c in counts]
    for root, nodes in comp_nodes.items():
        d = dev_of_comp[root]
        for k, t in nodes:
            assign[k][t] = d
    return assign, bins


def _stacked_stage_buckets(raw, assign_k, ndev: int):
    """Every rank's buckets of one chain stage, stacked on a leading rank
    axis: a list over bucket shapes of dicts with (ndev, G, R, K), (ndev,
    G, K, C) and (ndev, G, R, C) host index maps.  Each rank's group count
    is padded to the shape's largest with sentinel indices (reads hit the
    zero slot, writes the dummy output slot)."""
    nnz1, nnz2 = raw["nnz1"], raw["nnz2"]
    out_nnz = raw["out"]["nnz"]
    per_dev = []
    for d in range(ndev):
        sub = dict(raw)
        sub["sectors"] = [s for t, s in enumerate(raw["sectors"])
                          if assign_k[t] == d]
        per_dev.append({(b["R"], b["K"], b["C"]): b
                        for b in _build_buckets(sub)})
    keys = sorted({k for bd in per_dev for k in bd})
    stages = []
    for (R, K, C) in keys:
        gmax = max((bd[(R, K, C)]["M1"].shape[0]
                    for bd in per_dev if (R, K, C) in bd), default=0)
        if gmax == 0:
            continue
        M1 = np.full((ndev, gmax, R, K), nnz1, np.int64)
        M2 = np.full((ndev, gmax, K, C), nnz2, np.int64)
        MO = np.full((ndev, gmax, R, C), out_nnz, np.int64)
        for d, bd in enumerate(per_dev):
            b = bd.get((R, K, C))
            if b is None:
                continue
            g = b["M1"].shape[0]
            M1[d, :g] = b["M1"]
            M2[d, :g] = b["M2"]
            MO[d, :g] = b["MO"]
        stages.append(dict(R=R, K=K, C=C, G=gmax, M1=M1, M2=M2, MO=MO))
    return stages


def make_chain_executor(specs, ndev: int, group,
                        precision: str = "highest", reduce: str = "psum"):
    """Fused EP executor of a contraction chain.

    ``specs``: list of ``(skel1, skel2, axes1, axes2)``; after the first
    stage ``skel1`` may be None (the previous stage's output, the
    through-operand).  Returns ``(run, out_skel)``: ``run(d1_0, d2_0, d2_1,
    ..., d2_{n-1})`` maps data ``(..., nnz)`` to the chain's output on
    this rank of ``group`` and issues ONE ``all_reduce`` (of the final
    output) for the whole chain.  Whole dependency components are
    assigned to ranks, so the ranks' partials have disjoint support and
    their sum is the single-device chain's output exactly.

    ``reduce="none"`` skips the all_reduce and returns this rank's
    partial (full length, zero off its components): the capacity layout's
    producer, which reduce-scatters it into stored blocks
    (:func:`~tensornetwork_tpu_torch.blocksparse.batched.
    env_scatter_stored`)."""
    raws, prev_out, key_parts = [], None, []
    for k, (s1, s2, a1, a2) in enumerate(specs):
        if s1 is None:
            if k == 0:
                raise ValueError("stage 0 needs an explicit first operand")
            s1 = prev_out
        raw = _build_plan(s1, s2, list(a1), list(a2))
        if raw["scalar"]:
            raise ValueError("chain stages must produce tensors")
        key_parts.append((_structure_key(s1), _structure_key(s2),
                          tuple(a1), tuple(a2)))
        raws.append(raw)
        prev_out = out_skeleton(raw)
    key = (tuple(key_parts), ndev, group, precision, reduce)
    cached = _CHAIN_CACHE.get(key)
    if cached is not None:
        _CHAIN_CACHE.move_to_end(key)
        return cached["run"], cached["out_skel"]

    from tensornetwork_tpu_torch.parallel import collectives
    rank = collectives.group_rank(group)
    assign, _bins = _partition_chain(raws, ndev)
    maps = DeviceMaps()
    stages = []
    true = 0
    for k, raw in enumerate(raws):
        buckets = [dict(G=b["G"], R=b["R"], K=b["K"], C=b["C"],
                        slots=[maps.add(b[n][rank].reshape(-1))
                               for n in ("M1", "M2", "MO")])
                   for b in _stacked_stage_buckets(raw, assign[k], ndev)]
        stages.append(dict(buckets=buckets, nnz1=raw["nnz1"],
                           nnz2=raw["nnz2"], out_nnz=raw["out"]["nnz"],
                           perms=[maps.add(raw["perm1"]),
                                  maps.add(raw["perm2"])]))
        true += sum(2 * s1[0] * s1[1] * s2[1] for t, (*_, s1, s2)
                    in enumerate(raw["sectors"]) if assign[k][t] == rank)
    # this rank's work a run: its sectors' flops, its padded bucket GEMMs
    buckets = [b for st in stages for b in st["buckets"]]
    work = (true, sum(2 * b["G"] * b["R"] * b["K"] * b["C"] for b in buckets),
            len(buckets))

    @tracing.spanned("bs_exec")
    def run(*data):
        if len(data) != len(raws) + 1:
            raise TypeError(
                f"chain executor takes {len(raws) + 1} data vectors")
        lead = torch.broadcast_shapes(*(d.shape[:-1] for d in data))
        B = int(np.prod(lead, dtype=np.int64))
        _count_work(B, work)
        dtype = data[0].dtype
        for d in data[1:]:
            dtype = torch.promote_types(dtype, d.dtype)
        dev = data[0].device
        on = maps.on(dev)
        ctx = (highest_precision() if precision == "highest"
               else contextlib.nullcontext())

        def operand(d, perm, nnz):
            d = d.to(dtype).expand(lead + (nnz,)).reshape(B, nnz)
            if perm is not None:
                d = d.index_select(1, on[perm])
            return torch.cat([d, d.new_zeros(B, 1)], dim=1)

        with ctx:
            cur = data[0]
            for st, d2 in zip(stages, data[1:]):
                d1x = operand(cur, st["perms"][0], st["nnz1"])
                d2x = operand(d2, st["perms"][1], st["nnz2"])
                out = torch.zeros(B, st["out_nnz"] + 1, dtype=dtype,
                                  device=dev)
                for b in st["buckets"]:
                    M1, M2, MO = (on[i] for i in b["slots"])
                    b1 = d1x.index_select(1, M1).view(B, b["G"], b["R"],
                                                      b["K"])
                    b2 = d2x.index_select(1, M2).view(B, b["G"], b["K"],
                                                      b["C"])
                    out.index_copy_(1, MO, torch.matmul(b1, b2).reshape(B, -1))
                cur = out[:, :st["out_nnz"]].reshape(lead + (st["out_nnz"],))
        if reduce == "none":
            return cur
        from tensornetwork_tpu_torch.parallel import collectives
        return collectives.all_reduce(cur, group)

    _CHAIN_CACHE[key] = dict(run=run, out_skel=prev_out)
    while len(_CHAIN_CACHE) > _CHAIN_CACHE_CAPACITY:
        _CHAIN_CACHE.popitem(last=False)
    return run, prev_out


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
    _CHAIN_CACHE.clear()
