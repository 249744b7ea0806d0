"""Batched-realization U(1) DMRG: many instances, one set of plans.

Counterpart of :mod:`tensornetwork_tpu.models.symmetric_dmrg_batched`: the
chi=1024 x many-disorder-realizations configuration.  Every realization
shares one charge skeleton
(:func:`tensornetwork_tpu_torch.blocksparse.batched.uniform_skeleton_mps`),
so the whole per-site step -- Lanczos local solve, completed-polar gauge
shift, bond-factor absorption, environment growth -- runs on the device as
batched sector GEMMs on a leading realization axis.  One host-built plan
per (site structure, direction) serves every realization and sweep; where
the JAX package traces and compiles one program per (site, direction) and
``vmap``\\ s it, the port replays the plan's bucketed executors eagerly
with the batch axis folded into each GEMM's batch.

Each step runs inside :func:`config.highest_precision` (TF32 off), as the
JAX step runs under ``default_matmul_precision("highest")``: reduced
precision in the Lanczos dots or the polar iterations makes the energy
non-variational.

MPO disorder: pass ``mpo_data`` as N ``(B, nnz_w)`` stacks with the MPO's
charge structure (e.g. different couplings in the XXZ W-tensors); by
default the shared MPO is broadcast.

Across ranks (``torch.distributed``, a mesh of
:func:`~tensornetwork_tpu_torch.parallel.mesh.make_mesh`): ``mesh=``
splits the realizations over ``batch_axis`` (no collective in a sweep;
the energies gathered once a sweep); ``ep_mesh=`` splits the charge
sectors of every contraction over ``ep_axis`` -- the matvec and the
environment growth as fused chains with one ``all_reduce`` each
(:func:`~tensornetwork_tpu_torch.blocksparse.batched.
chain_contraction_plan`), the two-site split's sector SVDs dealt over the
ranks -- while the small gauge solves run on every rank alike;
``ep_capacity=True`` also stores every environment as one 1/P block a
rank, reduce-scattered from the growth chain's partials (no
``all_reduce`` in the env chain) and gathered for the step that reads
it.

The cold start is the host plan build (:meth:`BatchedSymmetricDMRG.
precompile`), where the JAX package traces and compiles.  As the JAX
class serializes its traced programs, the port writes each one-site
program's plans to a file (:meth:`~BatchedSymmetricDMRG.export_programs`,
or over worker processes, :meth:`~BatchedSymmetricDMRG.
export_programs_parallel`), and a later process installs them
(:meth:`~BatchedSymmetricDMRG.load_programs`) and skips the build: its
:meth:`~BatchedSymmetricDMRG.precompile` then only copies index maps to
the device.  The files hold index maps and metadata, no pickle
(:mod:`~tensornetwork_tpu_torch.blocksparse.plan_store`).
"""
from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse import plan_store
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.blocksparse.batched import (
    ShiftPlan, TwoSiteSplitPlan, chain_contraction_plan, contraction_plan,
    env_gather_full, env_scatter_stored, env_to_stored)
from tensornetwork_tpu_torch.blocksparse.charge import U1Charge
from tensornetwork_tpu_torch.blocksparse.index import Index
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, _expand_indices, normalize_axes, tensordot_structure)
from tensornetwork_tpu_torch.config import as_tensor, highest_precision
from tensornetwork_tpu_torch.ops import krylov
from tensornetwork_tpu_torch.parallel import collectives
from tensornetwork_tpu_torch.parallel.mesh import axis_group, axis_size
from tensornetwork_tpu_torch.utils import tracing

def _skel(indices, dtype) -> BlockSparseTensor:
    return TE.skeleton(*_expand_indices(indices), dtype)


def _boundary_left_skel(dtype) -> BlockSparseTensor:
    return _skel([Index(U1Charge(np.array([0])), True),
                  Index(U1Charge(np.array([0])), True),
                  Index(U1Charge(np.array([0])), False)], dtype)


def _boundary_right_skel(last_bond, dtype) -> BlockSparseTensor:
    return _skel([Index(last_bond.copy(), False),
                  Index(U1Charge(np.array([0])), False),
                  Index(last_bond.copy(), True)], dtype)


def _meta(t: BlockSparseTensor) -> BlockSparseTensor:
    """``t``'s structure without storage."""
    return TE.skeleton(t.flat_charges, t.flat_flows,
                       [list(g) for g in t._order], t.dtype)


def _td_skeleton(t1, t2, axes) -> BlockSparseTensor:
    """Storage-free skeleton of ``tensordot(t1, t2, axes)``."""
    axes1, axes2 = normalize_axes(t1, t2, axes)
    st = tensordot_structure(t1, t2, axes1, axes2)
    return TE.skeleton(st["out_charges"], st["out_flows"], st["out_order"],
                       torch.promote_types(t1.dtype, t2.dtype))


def _grow_left_skel(L, A, W):
    t = _td_skeleton(L, A, [[0], [0]])
    t = _td_skeleton(t, W, [[0, 2], [0, 3]])
    return _td_skeleton(t, A.conj(), [[0, 3], [0, 1]])


def _grow_right_skel(R, A, W):
    t = _td_skeleton(A, R, [[2], [0]])
    t = _td_skeleton(t, W, [[1, 2], [3, 1]])
    return _td_skeleton(t, A.conj(), [[1, 3], [2, 1]])


def _chain(stages, ep=None, reduce: str = "psum"):
    """The run function of a contraction chain (``stages``: ``(skel1,
    skel2, axes)``, ``skel1`` None after the first stage, the previous
    output) and its final skeleton.  Without ``ep`` one plan a stage run
    in turn; with ``ep=(ndev, group)`` the fused EP chain (one all_reduce,
    or none with ``reduce="none"``)."""
    if ep is not None:
        return chain_contraction_plan(stages, ep, reduce=reduce)
    runs, prev = [], None
    for s1, s2, axes in stages:
        run, prev = contraction_plan(prev if s1 is None else s1, s2, axes)
        runs.append(run)

    def run_chain(d, *operands):
        for run, d2 in zip(runs, operands):
            d = run(d, d2)
        return d

    return run_chain, prev


class _Capacity:
    """The capacity layout's env traffic of one program: the whole envs
    it reads gathered from their stored blocks, the env it grows
    reduce-scattered into this rank's block.  ``None`` outside capacity
    mode, where envs are whole on every rank."""

    def __init__(self, ep, nnz_in):
        self.ndev, self.group = ep
        self.nnz_in = nnz_in

    def gather(self, *stored):
        return [env_gather_full(e, n, self.group)
                for e, n in zip(stored, self.nnz_in)]

    def scatter(self, partial):
        return env_scatter_stored(partial, self.ndev, self.group)


def _normalized(d: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d / torch.where(nrm > 0, nrm, 1.0)


def _grow_stages(direction, L_skel, R_skel, A_skel, W_skel):
    """The environment growth chain of ``A``: left env for "right",
    right env for "left"."""
    if direction == "right":
        return [(L_skel, A_skel, [[0], [0]]),
                (None, W_skel, [[0, 2], [0, 3]]),
                # conj flips all flows (metadata-only for real data;
                # layout is invariant under a global flow flip)
                (None, A_skel.conj(), [[0, 3], [0, 1]])]
    return [(A_skel, R_skel, [[2], [0]]),
            (None, W_skel, [[1, 2], [3, 1]]),
            (None, A_skel.conj(), [[1, 3], [2, 1]])]


def _grow(run, direction, dq, dw, denv):
    if direction == "right":
        return run(denv, dq, dw, dq)
    return run(dq, denv, dw, dq)


class _SiteProgram:
    """The batched one-site step of one (site structure, direction): the
    Lanczos solve over the three-contraction matvec, the sector polar
    shift, the absorption of the bond factor into the next site, and the
    three-contraction environment growth."""

    def __init__(self, A_skel, A_next_skel, W_skel, L_skel, R_skel,
                 direction: str, num_krylov_vecs: int, ritz_method: str,
                 reorth: bool = True, ep=None, ep_capacity: bool = False,
                 shift: Optional[ShiftPlan] = None):
        self.direction = direction
        self.m = num_krylov_vecs
        self.ritz = ritz_method
        self.reorth = reorth
        self.cap = (_Capacity(ep, (L_skel.data.shape[0],
                                   R_skel.data.shape[0]))
                    if ep_capacity else None)
        self.mv, y_skel = _chain([(L_skel, A_skel, [[0], [0]]),
                                  (None, W_skel, [[0, 2], [0, 3]]),
                                  (None, R_skel, [[1, 2], [0, 1]])], ep)
        if y_skel.data.shape != A_skel.data.shape:
            raise AssertionError("matvec output layout mismatch")
        self.shift = (shift if shift is not None
                      else ShiftPlan(A_skel, direction))
        bond_skel = self.shift.bond_skel
        # capacity mode absorbs on every rank alike: the operands are
        # whole there anyway, so an all_reduce would buy nothing
        ep_abs = None if ep_capacity else ep
        if direction == "right":
            # absorb P into the next site from the left: P·A_next
            self.absorb, abs_out = contraction_plan(bond_skel, A_next_skel,
                                                    [[1], [0]], ep=ep_abs)
        else:
            # absorb P into the previous site from the right: A_prev·P
            self.absorb, abs_out = contraction_plan(A_next_skel, bond_skel,
                                                    [[2], [0]], ep=ep_abs)
        if abs_out.data.shape != A_next_skel.data.shape:
            raise AssertionError("absorb output layout mismatch")
        self.grow, self.env_out_skel = _chain(
            _grow_stages(direction, L_skel, R_skel, A_skel, W_skel), ep,
            "none" if ep_capacity else "psum")

    def __call__(self, dA, dA_next, dW, dL, dR):
        """One step; in capacity mode ``dL``/``dR`` are this rank's stored
        blocks, and so is the grown env returned."""
        if self.cap is not None:
            dL, dR = self.cap.gather(dL, dR)
        with highest_precision():
            with tracing.span("local_solve"):
                evals, evecs = krylov.eigsh_lanczos(
                    lambda x: self.mv(dL, x, dW, dR), dA,
                    num_krylov_vecs=self.m, numeig=1, ritz_method=self.ritz,
                    reorthogonalize=self.reorth)
            with tracing.span("gauge_env"):
                qd, pd = self.shift(evecs[:, 0])
                if self.direction == "right":
                    nxt = self.absorb(pd, dA_next)
                else:
                    nxt = self.absorb(dA_next, pd)
                denv = _grow(self.grow, self.direction, qd, dW,
                             dL if self.direction == "right" else dR)
        if self.cap is not None:
            denv = self.cap.scatter(denv)
        return evals[:, 0], qd, _normalized(nxt), denv


class _CanonProgram:
    """The left shift of the initial right-canonicalisation at one site:
    the sector polar shift, the absorption into the previous site, the
    right environment's growth."""

    def __init__(self, A_skel, A_prev_skel, W_skel, R_skel, ep=None,
                 ep_capacity: bool = False,
                 shift: Optional[ShiftPlan] = None):
        self.cap = (_Capacity(ep, (R_skel.data.shape[0],))
                    if ep_capacity else None)
        self.shift = (shift if shift is not None
                      else ShiftPlan(A_skel, "left"))
        self.absorb, abs_out = contraction_plan(
            A_prev_skel, self.shift.bond_skel, [[2], [0]],
            ep=None if ep_capacity else ep)
        if abs_out.data.shape != A_prev_skel.data.shape:
            raise AssertionError("canon absorb layout mismatch")
        self.grow, _ = _chain(_grow_stages("left", None, R_skel, A_skel,
                                           W_skel), ep,
                              "none" if ep_capacity else "psum")

    def __call__(self, dA, dA_prev, dW, dR):
        if self.cap is not None:
            dR, = self.cap.gather(dR)
        with highest_precision(), tracing.span("gauge_env"):
            qd, pd = self.shift(dA)
            prev2 = _normalized(self.absorb(dA_prev, pd))
            denv = _grow(self.grow, "left", qd, dW, dR)
        if self.cap is not None:
            denv = self.cap.scatter(denv)
        return qd, prev2, denv


class _BondProgram:
    """The batched two-site step of one (bond structure, direction): theta
    assembly, the Lanczos solve over the four-contraction matvec, the
    sector SVD split onto the fixed bond profile, the environment growth."""

    def __init__(self, A_skel, B_skel, W1_skel, W2_skel, L_skel, R_skel,
                 direction: str, num_krylov_vecs: int, ritz_method: str,
                 reorth: bool = True, ep=None, ep_capacity: bool = False):
        self.direction = direction
        self.m = num_krylov_vecs
        self.ritz = ritz_method
        self.reorth = reorth
        self.ep = ep
        self.cap = (_Capacity(ep, (L_skel.data.shape[0],
                                   R_skel.data.shape[0]))
                    if ep_capacity else None)
        self.theta, theta_skel = contraction_plan(
            A_skel, B_skel, [[2], [0]], ep=None if ep_capacity else ep)
        # two-site effective-H matvec chain on theta (l, s, t, r)
        self.mv, y_skel = _chain([(L_skel, theta_skel, [[0], [0]]),
                                  (None, W1_skel, [[0, 2], [0, 3]]),
                                  (None, W2_skel, [[3, 1], [0, 3]]),
                                  (None, R_skel, [[1, 3], [0, 1]])], ep)
        if y_skel.data.shape != theta_skel.data.shape:
            raise AssertionError("2s matvec output layout mismatch")
        self.split = TwoSiteSplitPlan(theta_skel, A_skel, B_skel)
        if direction == "right":
            stages = _grow_stages("right", L_skel, None, A_skel, W1_skel)
        else:
            stages = _grow_stages("left", None, R_skel, B_skel, W2_skel)
        self.grow, _ = _chain(stages, ep, "none" if ep_capacity else "psum")

    def __call__(self, dA, dB, dW1, dW2, dL, dR):
        if self.cap is not None:
            dL, dR = self.cap.gather(dL, dR)
        with highest_precision():
            with tracing.span("local_solve"):
                evals, evecs = krylov.eigsh_lanczos(
                    lambda x: self.mv(dL, x, dW1, dW2, dR),
                    self.theta(dA, dB), num_krylov_vecs=self.m, numeig=1,
                    ritz_method=self.ritz, reorthogonalize=self.reorth)
            absorb = "right" if self.direction == "right" else "left"
            with tracing.span("gauge_env"):
                # EP: the sector SVDs dealt over the ranks
                ld, rd, terr = self.split(evecs[:, 0], absorb, ep=self.ep)
                if self.direction == "right":
                    denv = _grow(self.grow, "right", ld, dW1, dL)
                else:
                    denv = _grow(self.grow, "left", rd, dW2, dR)
        if self.cap is not None:
            denv = self.cap.scatter(denv)
        return evals[:, 0], ld, rd, terr, denv


class BatchedSymmetricDMRG:
    """One- and two-site DMRG over a batch of U(1) realizations on one
    device.

    Parameters
    ----------
    skeleton:   list of N skeleton tensors (shared charge structure),
                e.g. from :func:`uniform_skeleton_mps`.
    data:       list of N (B, nnz_i) data stacks (they stay on their
                device; numpy arrays go to the card).
    mpo:        list of N BlockSparseTensor MPO tensors (legs
                wl, wr, s_out, s_in as in
                :func:`~tensornetwork_tpu_torch.models.symmetric_dmrg
                .u1_xxz_mpo`).
    mpo_data:   optional list of N (B, nnz_w) stacks for per-realization
                MPO disorder (same charge structure); default broadcasts
                the shared MPO data.
    mesh:       a mesh whose ``batch_axis`` splits the realizations: each
                rank keeps its B/P rows of every stack (``data`` and
                ``mpo_data`` whole on every rank, or DTensors sharded on
                their first axis); the energies are gathered.
    ep_mesh:    a mesh whose ``ep_axis`` splits the charge sectors of every
                contraction; with ``ep_capacity`` every environment is
                stored as a 1/P block a rank.  ``mesh`` and ``ep_mesh`` do
                not go together.
    """

    def __init__(self, skeleton: Sequence[BlockSparseTensor],
                 data: Sequence, mpo: Sequence[BlockSparseTensor],
                 mpo_data: Optional[Sequence] = None,
                 num_krylov_vecs: int = 10,
                 ritz_method: str = "power",
                 reorth: bool = True,
                 mesh=None, batch_axis: str = "data",
                 ep_mesh=None, ep_axis: str = "ep",
                 ep_capacity: bool = False):
        if len(skeleton) != len(mpo):
            raise ValueError("MPS and MPO must have equal length")
        if mesh is not None and ep_mesh is not None:
            raise ValueError(
                "pass either mesh= (batch/DP sharding) or ep_mesh= "
                "(sector/EP sharding), not both")
        if ep_capacity and ep_mesh is None:
            raise ValueError("ep_capacity=True requires ep_mesh")
        self.ep, self.ep_capacity = None, bool(ep_capacity)
        self._batch_group = None
        if ep_mesh is not None:
            self.ep = (axis_size(ep_mesh, ep_axis),
                       axis_group(ep_mesh, ep_axis))
        if mesh is not None:
            self._batch_group = axis_group(mesh, batch_axis)
            data = [self._batch_block(d) for d in data]
            if mpo_data is not None:
                mpo_data = [self._batch_block(d) for d in mpo_data]
        self.data = [as_tensor(d) for d in data]
        self.device = self.data[0].device
        self.N = len(skeleton)
        self.B = int(self.data[0].shape[0])
        self.m = num_krylov_vecs
        self.ritz = ritz_method
        self.reorth = reorth
        self.skeleton = [_meta(t) for t in skeleton]
        self.mpo = [_meta(w) for w in mpo]
        if mpo_data is None:
            mpo_data = [w.data.to(self.device).expand(self.B, -1)
                        for w in mpo]
        self.mpo_data = [as_tensor(d).to(self.device) for d in mpo_data]
        # environment stacks take the promoted dtype of the growth chain
        # (data x mpo); the boundary envs agree with it
        self._env_dtype = torch.promote_types(self.data[0].dtype,
                                              self.mpo_data[0].dtype)
        self._Lskel: List[BlockSparseTensor] = [None] * (self.N + 1)
        self._Rskel: List[BlockSparseTensor] = [None] * (self.N + 1)
        self._Lskel[0] = _boundary_left_skel(self._env_dtype)
        self._Rskel[self.N] = _boundary_right_skel(
            self.skeleton[-1].flat_charges[-1], self._env_dtype)
        for k in range(self.N):
            self._Lskel[k + 1] = _grow_left_skel(
                self._Lskel[k], self.skeleton[k], self.mpo[k])
        for k in range(self.N - 1, -1, -1):
            self._Rskel[k] = _grow_right_skel(
                self._Rskel[k + 1], self.skeleton[k], self.mpo[k])
        self._programs: Dict[Tuple, object] = {}
        self.energies: List[np.ndarray] = []
        self.truncation_errors: List[np.ndarray] = []

    def _batch_block(self, d):
        """This rank's rows of a whole (B, nnz) stack (a DTensor: its
        local block)."""
        if hasattr(d, "to_local"):
            return d.to_local()
        d = as_tensor(d)
        return d.chunk(collectives.group_size(self._batch_group)
                       )[collectives.group_rank(self._batch_group)]

    def _gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """(B_local,) -> (B,) over the batch group (as it is without
        one)."""
        if self._batch_group is None:
            return x
        return collectives.all_gather(x, 0, self._batch_group)

    # -- plans, keyed on the charge structure ------------------------------
    def _structure_sig(self, *tensors):
        return tuple(TE._structure_key(t) for t in tensors)

    def _install(self, key, make):
        """``self._programs[key] = make()``, the program keeping the
        ``(key, plan)`` list of the plans it replays (``plans``)."""
        with TE.recording() as used:
            prog = make()
        prog.plans = used
        self._programs[key] = prog
        return prog

    def _canon_sig(self, site: int):
        return self._structure_sig(
            self.skeleton[site], self.skeleton[site - 1], self.mpo[site],
            self._Rskel[site + 1])

    def _site_sig(self, site: int, direction: str):
        nxt = site + 1 if direction == "right" else site - 1
        return self._structure_sig(
            self.skeleton[site], self.skeleton[nxt], self.mpo[site],
            self._Lskel[site], self._Rskel[site + 1])

    def _canon_program(self, site: int,
                       shift: Optional[ShiftPlan] = None) -> _CanonProgram:
        """The canonicalising program of ``site``; with ``shift`` (a
        restored plan) made anew around it."""
        key = ("canon", self._canon_sig(site))
        if key not in self._programs or shift is not None:
            self._install(key, lambda: _CanonProgram(
                self.skeleton[site], self.skeleton[site - 1],
                self.mpo[site], self._Rskel[site + 1], self.ep,
                self.ep_capacity, shift))
        return self._programs[key]

    def _program(self, site: int, direction: str,
                 shift: Optional[ShiftPlan] = None) -> _SiteProgram:
        # keyed on the charge STRUCTURE, not the site index: sites of a
        # smooth bond profile may share structures
        nxt = site + 1 if direction == "right" else site - 1
        key = (direction, self._site_sig(site, direction))
        if key not in self._programs or shift is not None:
            self._install(key, lambda: _SiteProgram(
                self.skeleton[site], self.skeleton[nxt], self.mpo[site],
                self._Lskel[site], self._Rskel[site + 1], direction,
                self.m, self.ritz, self.reorth, self.ep, self.ep_capacity,
                shift))
        return self._programs[key]

    def _bond_program(self, bond: int, direction: str) -> _BondProgram:
        key = ("2s", direction, self._structure_sig(
            self.skeleton[bond], self.skeleton[bond + 1],
            self.mpo[bond], self.mpo[bond + 1],
            self._Lskel[bond], self._Rskel[bond + 2]))
        if key not in self._programs:
            self._install(key, lambda: _BondProgram(
                self.skeleton[bond], self.skeleton[bond + 1],
                self.mpo[bond], self.mpo[bond + 1],
                self._Lskel[bond], self._Rskel[bond + 2], direction,
                self.m, self.ritz, self.reorth, self.ep, self.ep_capacity))
        return self._programs[key]

    def precompile(self, two_site: bool = False, verbose: int = 0) -> float:
        """Build every plan of the one-site sweep (and of the two-site
        sweep with ``two_site``) and copy its index maps to the data's
        device: the cold start that the first sweep would otherwise pay.
        After :meth:`load_programs` only the copies are left to make.
        Returns the seconds spent."""
        t0 = time.perf_counter()
        n0 = TE.build_counts["plans"]
        for site in range(self.N - 1, 0, -1):
            self._canon_program(site)
        for site in range(self.N - 1):
            self._program(site, "right")
            self._program(site + 1, "left")
            if two_site:
                self._bond_program(site, "right")
                self._bond_program(site, "left")
        for prog in self._programs.values():
            for _, plan in prog.plans:
                plan["maps"].on(self.device)
            for shift in (getattr(prog, "shift", None),
                          getattr(prog, "split", None)):
                if shift is not None:
                    shift.maps.on(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if verbose:
            print(f"precompile: {len(self._programs)} programs, "
                  f"{TE.build_counts['plans'] - n0} plans built in "
                  f"{dt:.1f} s")
        return dt

    # -- the cold-start cache: each one-site program's plans in a file -----
    def _export_sig(self, kind: str, sig) -> str:
        """sha256 (hex) naming a program's file, over the fields of the
        JAX key with torch's version and the plan-file format in place of
        JAX's version: the kind, the structure signature, the data and MPO
        dtypes, m, the Ritz method and reorthogonalisation.  B is left
        out: a plan is index maps of the charge structure, the same for
        every batch.  The dtypes and solver settings change no plan
        either; they stay, as in the JAX key, so that a file names the
        solver it was written for.  A file's name is the first 24 hex
        digits; its header holds all 64."""
        payload = repr((torch.__version__, plan_store.FORMAT, kind, sig,
                        str(self.data[0].dtype), str(self.mpo_data[0].dtype),
                        self.m, self.ritz, self.reorth))
        return hashlib.sha256(payload.encode()).hexdigest()

    def _program_file(self, path: str, key: str) -> str:
        return os.path.join(path, key[:24] + ".tnplan")

    def _iter_program_keys(self):
        """(kind, sig, ref) for every one-site program, deduplicated by
        structure: the canonicalising programs for site N-1 ... 1, then
        the "right" and "left" site programs.  ``sig`` is the program's
        key in ``_programs``; ``ref`` the site, or (site, direction)."""
        seen = set()
        for site in range(self.N - 1, 0, -1):
            sig = ("canon", self._canon_sig(site))
            if sig not in seen:
                seen.add(sig)
                yield ("canon", sig, site)
        for direction, sites in (("right", range(self.N - 1)),
                                 ("left", range(self.N - 1, 0, -1))):
            for site in sites:
                sig = (direction, self._site_sig(site, direction))
                if sig not in seen:
                    seen.add(sig)
                    yield ("site", sig, (site, direction))

    def _single_device(self, what: str):
        if self.ep is not None or self._batch_group is not None:
            raise ValueError(f"{what} is for the single-device path")

    def export_programs(self, path: str, verbose: int = 0,
                        subset: Optional[Sequence[int]] = None) -> int:
        """Write every one-site program's plans to ``path``, one file a
        program (named by :meth:`_export_sig`): the contraction plans of
        its matvec, absorption and environment growth, and its gauge
        shift's plan, from which the output skeletons the step checks are
        made again.  Builds the plans a program lacks; skips files that
        exist.  ``subset``: indices into :meth:`_iter_program_keys`, the
        share of one worker of :meth:`export_programs_parallel`.  Returns
        the number of files written."""
        self._single_device("export")
        os.makedirs(path, exist_ok=True)
        n = 0
        for idx, (kind, sig, ref) in enumerate(self._iter_program_keys()):
            if subset is not None and idx not in subset:
                continue
            key = self._export_sig(kind, sig)
            fname = self._program_file(path, key)
            if os.path.exists(fname):
                continue
            prog = (self._canon_program(ref) if kind == "canon"
                    else self._program(*ref))
            _write_program(fname, key, kind, prog)
            n += 1
            if verbose:
                print(f"exported {kind} program -> {fname}")
        return n

    def _worker_spec(self) -> dict:
        """Picklable reconstruction spec for export workers: the charge
        structures, dtypes and solver settings (the data's values change
        no plan, so workers rebuild with zeros)."""
        def spec(t):
            return ([plan_store.charge_spec(c) for c in t.flat_charges],
                    [bool(f) for f in t.flat_flows],
                    [[int(i) for i in g] for g in t._order],
                    str(t.dtype).split(".")[-1])

        return dict(skeleton=[spec(t) for t in self.skeleton],
                    mpo=[spec(w) for w in self.mpo],
                    data_dtype=str(self.data[0].dtype).split(".")[-1],
                    mpo_dtype=str(self.mpo_data[0].dtype).split(".")[-1],
                    m=self.m, ritz=self.ritz, reorth=self.reorth)

    def export_programs_parallel(self, path: str, workers: int = 2,
                                 verbose: int = 0,
                                 timeout: float = 1800.0) -> int:
        """:meth:`export_programs` for the missing files, over ``workers``
        processes (``spawn``), each given an index-stride slice of the
        program keys.  A worker rebuilds the solver on the CPU with zero
        data (a plan is host work, the same on every device) and writes
        the files :meth:`export_programs` would, byte for byte.  Raises
        ``RuntimeError`` if a worker fails or outlives ``timeout``
        seconds (it is killed).  Returns the number of files written."""
        import multiprocessing as mp
        self._single_device("export")
        os.makedirs(path, exist_ok=True)
        keys = list(self._iter_program_keys())
        files = [self._program_file(path, self._export_sig(kind, sig))
                 for kind, sig, _ in keys]
        missing = [i for i, f in enumerate(files) if not os.path.exists(f)]
        if not missing:
            return 0
        workers = max(1, min(workers, len(missing)))
        if workers == 1:
            return self.export_programs(path, verbose=verbose,
                                        subset=set(missing))
        ctx = mp.get_context("spawn")
        # the spec goes by queue: as an argument (~1 MB at chi=1024) it
        # would hold each start until the worker before had imported the
        # package, and the workers would run one after another
        specs = ctx.Queue()
        procs = [ctx.Process(target=_export_worker,
                             args=(specs, path, set(missing[i::workers]),
                                   timeout))
                 for i in range(workers)]
        for p in procs:
            p.start()
        spec = self._worker_spec()
        for _ in procs:
            specs.put(spec)
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            # specs a dead worker never took must not hold this process
            specs.cancel_join_thread()
            specs.close()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"export workers failed or timed out after "
                               f"{timeout} s: exit codes {codes}")
        n = sum(os.path.exists(files[i]) for i in missing)
        if verbose:
            print(f"parallel export: {n}/{len(missing)} programs via "
                  f"{workers} workers")
        return n

    def load_programs(self, path: str, verbose: int = 0) -> int:
        """Install the programs whose files are in ``path`` (written by
        :meth:`export_programs`, possibly by another process) into
        ``_programs``, and their plans into the plan cache, without
        building any: each program's executors are made anew around the
        restored plans, which replay the same buckets in the same order as
        built ones.  A file whose stored key differs from this solver's
        raises ``ValueError``.  Returns the number installed."""
        self._single_device("load")
        n = 0
        for kind, sig, ref in self._iter_program_keys():
            key = self._export_sig(kind, sig)
            fname = self._program_file(path, key)
            if not os.path.exists(fname):
                continue
            pf = plan_store.PlanFile(fname)
            head = pf.header
            if (head.get("format"), head.get("key"), head.get("kind")) != (
                    plan_store.FORMAT, key, kind):
                raise ValueError(
                    f"{fname}: stored key {head.get('key')} ({head.get('kind')}"
                    f", format {head.get('format')}) does not match this "
                    f"solver's {key} ({kind}, format {plan_store.FORMAT})")
            records = {p["digest"]: (lambda p=p: (p["meta"],
                                                  pf.record(p["record"])))
                       for p in head["plans"]}
            site = ref if kind == "canon" else ref[0]
            shift = ShiftPlan.from_record(
                self.skeleton[site], head["shift"]["meta"],
                pf.record(head["shift"]["record"]))
            with TE.preloaded(records):
                if kind == "canon":
                    self._canon_program(site, shift)
                else:
                    self._program(site, ref[1], shift)
            n += 1
            if verbose:
                print(f"loaded {kind} program <- {fname}")
        return n

    def _boundary_env(self) -> torch.Tensor:
        """The trivial (B, 1) boundary environment, in capacity mode this
        rank's (B, L) block of its stored layout."""
        e = torch.ones((self.B, 1), dtype=self._env_dtype,
                       device=self.device)
        if self.ep_capacity:
            ndev, group = self.ep
            e = env_to_stored(e, ndev)[:, collectives.group_rank(group)]
        return e

    @tracing.spanned("canon")
    def right_canonicalize(self) -> List[torch.Tensor]:
        """Left shifts from the right end (the prepass of every run);
        returns the right environments, index N the boundary."""
        Rdata: List[Optional[torch.Tensor]] = [None] * (self.N + 1)
        Rdata[self.N] = self._boundary_env()
        for site in range(self.N - 1, 0, -1):
            with tracing.span("program_lookup"):
                prog = self._canon_program(site)
            qd, prev2, rnew = prog(self.data[site], self.data[site - 1],
                                   self.mpo_data[site], Rdata[site + 1])
            self.data[site] = qd
            self.data[site - 1] = prev2
            Rdata[site] = rnew
        return Rdata

    @tracing.spanned("sweep")
    def sweep_one_site(self, Rdata: List[torch.Tensor]) -> torch.Tensor:
        """One left-to-right-to-left one-site sweep from the right envs
        ``Rdata`` (updated in place, as the data); returns the (B,)
        energies of its last step, on the device."""
        Ldata: List[Optional[torch.Tensor]] = [None] * (self.N + 1)
        Ldata[0] = self._boundary_env()
        es = None
        for site in range(self.N - 1):
            with tracing.span("program_lookup"):
                prog = self._program(site, "right")
            es, qd, nxt, lnew = prog(
                self.data[site], self.data[site + 1], self.mpo_data[site],
                Ldata[site], Rdata[site + 1])
            self.data[site] = qd
            self.data[site + 1] = nxt
            Ldata[site + 1] = lnew
        for site in range(self.N - 1, 0, -1):
            with tracing.span("program_lookup"):
                prog = self._program(site, "left")
            es, qd, prv, rnew = prog(
                self.data[site], self.data[site - 1], self.mpo_data[site],
                Ldata[site], Rdata[site + 1])
            self.data[site] = qd
            self.data[site - 1] = prv
            Rdata[site] = rnew
        return es

    @tracing.spanned("sweep")
    def sweep_two_site(self, Rdata: List[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One two-site sweep from the right envs ``Rdata`` (updated in
        place); returns the (B,) energies of its last step and the summed
        squared discarded weights, on the device."""
        terr_total = torch.zeros(self.B, dtype=self.data[0].dtype,
                                 device=self.device)
        Ldata: List[Optional[torch.Tensor]] = [None] * (self.N + 1)
        Ldata[0] = self._boundary_env()
        es = None
        for bond in range(self.N - 1):
            with tracing.span("program_lookup"):
                prog = self._bond_program(bond, "right")
            es, ld, rd, terr, lnew = prog(
                self.data[bond], self.data[bond + 1], self.mpo_data[bond],
                self.mpo_data[bond + 1], Ldata[bond], Rdata[bond + 2])
            self.data[bond] = ld
            self.data[bond + 1] = rd
            Ldata[bond + 1] = lnew
            terr_total = terr_total + terr
        for bond in range(self.N - 2, -1, -1):
            with tracing.span("program_lookup"):
                prog = self._bond_program(bond, "left")
            es, ld, rd, terr, rnew = prog(
                self.data[bond], self.data[bond + 1], self.mpo_data[bond],
                self.mpo_data[bond + 1], Ldata[bond], Rdata[bond + 2])
            self.data[bond] = ld
            self.data[bond + 1] = rd
            Rdata[bond + 1] = rnew
            terr_total = terr_total + terr
        return es, terr_total

    def run_one_site(self, num_sweeps: int = 4, tol: float = 1e-10,
                     verbose: int = 0) -> np.ndarray:
        """Right-canonicalize, then sweep until the mean energy moves by
        less than ``tol``.  Returns the per-realization energies (B,) of
        the last sweep."""
        Rdata = self.right_canonicalize()
        e_prev = None
        es = None
        for sweep in range(num_sweeps):
            es = self._gather_batch(self.sweep_one_site(Rdata)).cpu().numpy()
            self.energies.append(es)
            if verbose:
                print(f"sweep {sweep}: E mean {es.mean():.10f} "
                      f"span [{es.min():.8f}, {es.max():.8f}]")
            e_mean = float(es.mean())
            if e_prev is not None and abs(e_mean - e_prev) < tol:
                break
            e_prev = e_mean
        return es

    def run_two_site(self, num_sweeps: int = 4, tol: float = 1e-10,
                     verbose: int = 0) -> np.ndarray:
        """Two-site batched sweeps: sector SVD truncation back onto the
        fixed bond profile (per-sector static ranks).  Returns the
        per-realization energies (B,) of the last sweep; each sweep's
        summed squared discarded weights go to ``truncation_errors``."""
        Rdata = self.right_canonicalize()
        e_prev = None
        es = None
        for sweep in range(num_sweeps):
            es, terr = self.sweep_two_site(Rdata)
            es = self._gather_batch(es).cpu().numpy()
            self.energies.append(es)
            self.truncation_errors.append(
                self._gather_batch(terr).cpu().numpy())
            if verbose:
                print(f"2s sweep {sweep}: E mean {es.mean():.10f} "
                      f"terr mean {float(terr.mean()):.3e}")
            e_mean = float(es.mean())
            if e_prev is not None and abs(e_mean - e_prev) < tol:
                break
            e_prev = e_mean
        return es


def _write_program(fname: str, key: str, kind: str, prog) -> int:
    """One program's file: the records of its distinct plans, in the order
    it was handed them, then its gauge shift's."""
    head = dict(format=plan_store.FORMAT, key=key, kind=kind, plans=[])
    records, seen = [], set()
    for pkey, plan in prog.plans:
        digest = TE.plan_key_digest(pkey)
        if digest in seen:
            continue
        seen.add(digest)
        meta, arrays = TE.plan_to_record(plan)
        head["plans"].append(dict(digest=digest, meta=meta,
                                  record=len(records)))
        records.append(arrays)
    meta, arrays = prog.shift.to_record()
    head["shift"] = dict(meta=meta, record=len(records))
    records.append(arrays)
    return plan_store.write(fname, head, records)


def _export_worker(specs, path: str, subset, timeout: float):
    """Process entry of :meth:`BatchedSymmetricDMRG.
    export_programs_parallel`: the solver rebuilt on the CPU with zero
    data from the spec taken off the queue ``specs``, exporting the given
    key subset."""
    torch.set_num_threads(1)
    spec = specs.get(timeout=timeout)

    def skel(s):
        charges, flows, order, dtype = s
        return TE.skeleton([plan_store.charge_from_spec(*c) for c in charges],
                           flows, order, getattr(torch, dtype))

    skeleton = [skel(s) for s in spec["skeleton"]]
    mpo = [skel(s) for s in spec["mpo"]]
    data = [torch.zeros((1, t.data.shape[0]),
                        dtype=getattr(torch, spec["data_dtype"]))
            for t in skeleton]
    mpo_data = [torch.zeros((1, w.data.shape[0]),
                            dtype=getattr(torch, spec["mpo_dtype"]))
                for w in mpo]
    solver = BatchedSymmetricDMRG(skeleton, data, mpo, mpo_data=mpo_data,
                                  num_krylov_vecs=spec["m"],
                                  ritz_method=spec["ritz"],
                                  reorth=spec["reorth"])
    solver.export_programs(path, subset=subset)
