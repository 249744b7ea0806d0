"""Cross-rank block-sparse execution: the EP analog.

Counterpart of :mod:`tensornetwork_tpu.blocksparse.distributed`.  Charge
sectors are independent GEMMs; these entry points spread them over the
ranks of one mesh dimension:

* :func:`tensordot_sharded` -- the sectors are bucketed by padded GEMM
  shape and dealt round-robin to the ranks (sorted by cost); each rank
  packs and moves to its device only its own sectors' blocks, runs one
  batched GEMM a bucket, scatters its disjoint sector outputs, and one
  ``all_reduce`` reassembles the output (sectors never overlap, so the sum
  adds exact zeros);
* :func:`truncated_svd_distributed` -- each rank factors its contiguous
  share of the sector stack; the spectra are gathered (one
  ``all_gather``) and the global cross-sector ranking runs on the device,
  every rank alike (a stable argsort and the cumulative tail norms),
  giving the kept mask.  ``output="masked"``: the masked factor stacks as
  DTensors sharded over the sector axis, no host sync.  ``output="bst"``:
  the ragged BlockSparseTensor factors; the kept singular triplets are
  compacted on the device and summed over the ranks in one
  ``all_reduce`` (each rank fills its own sectors' rows), so only they
  cross to the host (:data:`last_bst_transfer_bytes`).

The solvers' EP path does not pack on the host: ``BatchedSymmetricDMRG(
ep_mesh=...)`` runs the sector-sharded executors of
:mod:`~tensornetwork_tpu_torch.blocksparse.torch_engine` and the
distributed split of :class:`~tensornetwork_tpu_torch.blocksparse.
batched.TwoSiteSplitPlan`.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse import linalg as _linalg
from tensornetwork_tpu_torch.blocksparse import torch_engine as _engine
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, device_index, normalize_axes)
from tensornetwork_tpu_torch.config import highest_precision
from tensornetwork_tpu_torch.ops.decompositions import thin_svd
from tensornetwork_tpu_torch.parallel import collectives
from tensornetwork_tpu_torch.parallel.mesh import (
    axis_group, axis_size, placements)

#: bytes moved device -> host by the last ``truncated_svd_distributed``
#: ``output="bst"`` call (the kept triplets and the discarded spectrum)
last_bst_transfer_bytes: Optional[int] = None


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tensordot_sharded(
    t1: BlockSparseTensor,
    t2: BlockSparseTensor,
    axes: Union[int, Sequence[Sequence[int]]],
    mesh,
    axis_name: str = "ep",
    precision: str = "highest",
) -> BlockSparseTensor:
    """Symmetric tensordot with the charge sectors dealt over the ranks
    of ``axis_name``; every rank calls it with the same operands and gets
    the whole output, on the mesh's device.  The host plan is the
    single-device engine's; each rank packs only its sectors' blocks into
    (G_loc, R, K) / (G_loc, K, C) stacks, and one ``all_reduce`` of ~nnz_out
    values is the only collective."""
    axes1, axes2 = normalize_axes(t1, t2, axes)
    group = axis_group(mesh, axis_name)
    ndev, rank = axis_size(mesh, axis_name), collectives.group_rank(group)
    dev = _mesh_device(mesh)
    plan = _engine._build_plan(t1, t2, axes1, axes2)
    scalar = plan["scalar"]
    nnz_out = 0 if scalar else plan["out"]["nnz"]
    d1 = t1.data.detach().cpu().numpy()
    d2 = t2.data.detach().cpu().numpy()
    if plan["perm1"] is not None:
        d1 = d1[plan["perm1"]]
    if plan["perm2"] is not None:
        d2 = d2[plan["perm2"]]
    acc = torch.promote_types(t1.dtype, t2.dtype)
    np_acc = torch.empty(0, dtype=acc).numpy().dtype

    # bucket by rounded GEMM shape; deal each bucket's sectors (heaviest
    # first) round-robin, this rank's share only
    groups = {}
    for (m1, m2, mo, s1, s2) in plan["sectors"]:
        key = (_engine._round_dim(s1[0]), _engine._round_dim(s1[1]),
               _engine._round_dim(s2[1]))
        groups.setdefault(key, []).append((m1, m2, mo, s1, s2))
    out = torch.zeros(nnz_out + 1, dtype=acc, device=dev)
    total = torch.zeros((), dtype=acc, device=dev)
    with (highest_precision() if precision == "highest"
          else contextlib.nullcontext()):
        for (R, K, C), secs in groups.items():
            secs = sorted(secs, key=lambda s: -(s[3][0] * s[3][1] * s[4][1]))
            mine = secs[rank::ndev]
            if not mine:
                continue
            B1 = np.zeros((len(mine), R, K), np_acc)
            B2 = np.zeros((len(mine), K, C), np_acc)
            IDX = np.full((len(mine), R, C), nnz_out, np.int64)
            for g, (m1, m2, mo, s1, s2) in enumerate(mine):
                B1[g, : s1[0], : s1[1]] = d1[m1]
                B2[g, : s2[0], : s2[1]] = d2[m2]
                if mo is not None:
                    IDX[g, : s1[0], : s2[1]] = mo
            res = torch.matmul(torch.as_tensor(B1, device=dev),
                               torch.as_tensor(B2, device=dev))
            if scalar:
                total = total + res.sum()
            else:
                out.index_copy_(0, device_index(IDX.reshape(-1), dev),
                                res.reshape(-1))
    if scalar:
        return collectives.all_reduce(total, group)
    result = collectives.all_reduce(out[:-1], group)
    o = plan["out"]
    return BlockSparseTensor(result, list(o["charges"]), list(o["flows"]),
                             [list(g) for g in o["order"]])


def truncated_svd_distributed(
    matrix: BlockSparseTensor,
    mesh,
    max_singular_values: Optional[int] = None,
    max_truncation_error: Optional[float] = None,
    relative: bool = False,
    axis_name: str = "ep",
    output: str = "bst",
):
    """Global cross-sector truncated SVD with the sector SVDs spread over
    the ranks of ``axis_name`` and the global ranking computed on the
    device from the gathered spectra (the distributed form of
    :func:`~tensornetwork_tpu_torch.blocksparse.linalg.truncated_svd`).

    ``output="masked"``: ``(u, s_masked, vh, kept_mask)``, DTensors on
    ``mesh`` sharded over the (padded) sector axis; discarded singular
    values are zero; no host sync.  ``output="bst"``: ``(U, S, V,
    s_rest)`` as :func:`~tensornetwork_tpu_torch.blocksparse.linalg.
    truncated_svd` (``s_rest`` the discarded values, descending, on the
    device).  Every rank calls it with the same matrix."""
    if output not in ("masked", "bst"):
        raise ValueError(f"unknown output {output!r}")
    group = axis_group(mesh, axis_name)
    ndev, rank = axis_size(mesh, axis_name), collectives.group_rank(group)
    p, common, maps, shapes, blocks = _linalg._get_blocks(matrix)
    G = len(blocks)
    if G == 0:
        return _linalg.truncated_svd(matrix, max_singular_values,
                                     max_truncation_error, relative)
    dev = matrix.device
    Rm = max(b.shape[0] for b in blocks)
    Cm = max(b.shape[1] for b in blocks)
    G_loc = -(-G // ndev)
    G_pad = G_loc * ndev
    kmax = min(Rm, Cm)
    nvals = np.zeros(G_pad, np.int64)
    nvals[:G] = [min(b.shape) for b in blocks]
    valid_np = np.arange(kmax)[None, :] < nvals[:, None]    # (G_pad, kmax)
    valid = torch.as_tensor(valid_np, device=dev)
    n_valid = int(valid_np.sum())
    k_cap = (n_valid if max_singular_values is None
             else min(int(max_singular_values), n_valid))
    # this rank's contiguous share of the padded sector stack
    g0 = rank * G_loc
    stack = torch.zeros((G_loc, Rm, Cm), dtype=matrix.dtype, device=dev)
    for g in range(g0, min(g0 + G_loc, G)):
        r, c = blocks[g].shape
        stack[g - g0, :r, :c] = blocks[g]
    with highest_precision():
        u, s, vh = thin_svd(stack)
    s = torch.where(valid[g0:g0 + G_loc], s, 0.0)
    s_all = collectives.all_gather(s, 0, group)             # (G_pad, kmax)
    # the global ranking, sector-major stable descending; padded slots
    # rank at -1, after every genuine value (zeros included)
    flat_rank = torch.where(valid, s_all, -1.0).reshape(-1)
    order = torch.argsort(-flat_rank, stable=True)
    sorted_s = torch.clamp(flat_rank[order], min=0.0)
    keep = torch.tensor(k_cap, device=dev)
    if max_truncation_error is not None:
        err = torch.tensor(float(max_truncation_error), dtype=sorted_s.dtype,
                           device=dev)
        if relative:
            err = err * sorted_s[0]
        # padded entries add 0 to the tail and are counted in drop, which
        # cancels their presence in the flat length
        tail = torch.sqrt(torch.cumsum(sorted_s.flip(0) ** 2, 0))
        drop = torch.searchsorted(tail, err.reshape(1), right=True)[0]
        keep = torch.minimum(keep, flat_rank.shape[0] - drop)
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(order.shape[0], device=dev)
    kept = (rank_of < keep).reshape(s_all.shape) & valid
    s_masked = torch.where(kept, s_all, 0.0)
    if output == "masked":
        from torch.distributed.tensor import DTensor
        spec = placements(mesh, {axis_name: 0})
        sl = slice(g0, g0 + G_loc)
        return tuple(DTensor.from_local(x, mesh, spec, run_check=False)
                     for x in (u, s_masked[sl], vh, kept[sl]))

    # the kept (sector, column) pairs in sector-major, ascending-column
    # order; each rank fills the rows of its own sectors, one all_reduce
    sel = torch.argsort((~kept.reshape(-1)).to(torch.int8), stable=True)[:k_cap]
    g_idx, c_idx = sel // kmax, sel % kmax
    mine = (g_idx >= g0) & (g_idx < g0 + G_loc)
    gl = torch.where(mine, g_idx - g0, 0)
    u_cols = torch.where(mine[:, None], u[gl, :, c_idx], 0.0)   # (k, Rm)
    vh_rows = torch.where(mine[:, None], vh[gl, c_idx, :], 0.0)  # (k, Cm)
    triplets = collectives.all_reduce(torch.cat([u_cols, vh_rows], 1), group)
    s_vals = s_all[g_idx, c_idx]
    keep_n = int(keep)
    u_cols = triplets[:keep_n, :Rm].cpu()
    vh_rows = triplets[:keep_n, Rm:].cpu()
    s_vals = s_vals[:keep_n].cpu()
    g_host = g_idx[:keep_n].cpu().numpy()
    # discarded VALID values: sorted positions [keep, n_valid)
    s_rest = sorted_s[keep_n:n_valid]
    global last_bst_transfer_bytes
    last_bst_transfer_bytes = int(
        u_cols.numel() * u_cols.element_size()
        + vh_rows.numel() * vh_rows.element_size()
        + s_vals.numel() * s_vals.element_size() + g_host.nbytes
        + s_rest.numel() * s_rest.element_size())
    new_us, new_ss, new_vs, ks = [], [], [], []
    for g in range(G):
        m = torch.as_tensor(np.nonzero(g_host == g)[0])
        r, c = blocks[g].shape
        ks.append(int(m.shape[0]))
        new_us.append(u_cols[m][:, :r].T.to(dev))
        new_ss.append(s_vals[m].to(dev))
        new_vs.append(vh_rows[m][:, :c].to(dev))
    U, S, V = _linalg._factors(matrix, p, common, new_us, new_ss, new_vs, ks)
    return U, S, V, s_rest
