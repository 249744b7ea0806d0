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
default the shared MPO is broadcast.  The multi-device options of the JAX
class (``mesh=``, ``ep_mesh=``, ``ep_capacity=``) wait for the
multi-device slice, and its serialized-trace cache
(``export_programs``/``load_programs``) has no counterpart: the port has
no traced program, and its cold start is the host plan build
(:meth:`BatchedSymmetricDMRG.precompile`).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.blocksparse.batched import (
    ShiftPlan, TwoSiteSplitPlan, contraction_plan)
from tensornetwork_tpu_torch.blocksparse.charge import U1Charge
from tensornetwork_tpu_torch.blocksparse.index import Index
from tensornetwork_tpu_torch.blocksparse.tensor import (
    BlockSparseTensor, _expand_indices, normalize_axes, tensordot_structure)
from tensornetwork_tpu_torch.config import as_tensor, highest_precision
from tensornetwork_tpu_torch.ops import krylov

_MULTI_DEVICE = ("waits for the multi-device slice of the port "
                 "(ROADMAP.md Queue 1 item 10)")


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


def _chain(stages):
    """Plans of a contraction chain: ``stages`` is a list of ``(skel1,
    skel2, axes)``, ``skel1`` None after the first stage (the previous
    output).  Returns the run functions and the final skeleton."""
    runs, prev = [], None
    for s1, s2, axes in stages:
        run, prev = contraction_plan(prev if s1 is None else s1, s2, axes)
        runs.append(run)
    return runs, prev


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


def _grow(runs, direction, dq, dw, denv):
    g1, g2, g3 = runs
    if direction == "right":
        return g3(g2(g1(denv, dq), dw), dq)
    return g3(g2(g1(dq, denv), dw), dq)


class _SiteProgram:
    """The batched one-site step of one (site structure, direction): the
    Lanczos solve over the three-contraction matvec, the sector polar
    shift, the absorption of the bond factor into the next site, and the
    three-contraction environment growth."""

    def __init__(self, A_skel, A_next_skel, W_skel, L_skel, R_skel,
                 direction: str, num_krylov_vecs: int, ritz_method: str,
                 reorth: bool = True):
        self.direction = direction
        self.m = num_krylov_vecs
        self.ritz = ritz_method
        self.reorth = reorth
        self.mv, y_skel = _chain([(L_skel, A_skel, [[0], [0]]),
                                  (None, W_skel, [[0, 2], [0, 3]]),
                                  (None, R_skel, [[1, 2], [0, 1]])])
        if y_skel.data.shape != A_skel.data.shape:
            raise AssertionError("matvec output layout mismatch")
        self.shift = ShiftPlan(A_skel, direction)
        bond_skel = self.shift.bond_skel
        if direction == "right":
            # absorb P into the next site from the left: P·A_next
            self.absorb, abs_out = contraction_plan(bond_skel, A_next_skel,
                                                    [[1], [0]])
        else:
            # absorb P into the previous site from the right: A_prev·P
            self.absorb, abs_out = contraction_plan(A_next_skel, bond_skel,
                                                    [[2], [0]])
        if abs_out.data.shape != A_next_skel.data.shape:
            raise AssertionError("absorb output layout mismatch")
        self.grow, self.env_out_skel = _chain(
            _grow_stages(direction, L_skel, R_skel, A_skel, W_skel))

    def __call__(self, dA, dA_next, dW, dL, dR):
        mv1, mv2, mv3 = self.mv
        with highest_precision():
            evals, evecs = krylov.eigsh_lanczos(
                lambda x: mv3(mv2(mv1(dL, x), dW), dR), dA,
                num_krylov_vecs=self.m, numeig=1, ritz_method=self.ritz,
                reorthogonalize=self.reorth)
            qd, pd = self.shift(evecs[:, 0])
            if self.direction == "right":
                nxt = self.absorb(pd, dA_next)
            else:
                nxt = self.absorb(dA_next, pd)
            denv = _grow(self.grow, self.direction, qd, dW,
                         dL if self.direction == "right" else dR)
            return evals[:, 0], qd, _normalized(nxt), denv


class _CanonProgram:
    """The left shift of the initial right-canonicalisation at one site:
    the sector polar shift, the absorption into the previous site, the
    right environment's growth."""

    def __init__(self, A_skel, A_prev_skel, W_skel, R_skel):
        self.shift = ShiftPlan(A_skel, "left")
        self.absorb, abs_out = contraction_plan(
            A_prev_skel, self.shift.bond_skel, [[2], [0]])
        if abs_out.data.shape != A_prev_skel.data.shape:
            raise AssertionError("canon absorb layout mismatch")
        self.grow, _ = _chain(_grow_stages("left", None, R_skel, A_skel,
                                           W_skel))

    def __call__(self, dA, dA_prev, dW, dR):
        with highest_precision():
            qd, pd = self.shift(dA)
            prev2 = _normalized(self.absorb(dA_prev, pd))
            return qd, prev2, _grow(self.grow, "left", qd, dW, dR)


class _BondProgram:
    """The batched two-site step of one (bond structure, direction): theta
    assembly, the Lanczos solve over the four-contraction matvec, the
    sector SVD split onto the fixed bond profile, the environment growth."""

    def __init__(self, A_skel, B_skel, W1_skel, W2_skel, L_skel, R_skel,
                 direction: str, num_krylov_vecs: int, ritz_method: str,
                 reorth: bool = True):
        self.direction = direction
        self.m = num_krylov_vecs
        self.ritz = ritz_method
        self.reorth = reorth
        self.theta, theta_skel = contraction_plan(A_skel, B_skel,
                                                  [[2], [0]])
        # two-site effective-H matvec chain on theta (l, s, t, r)
        self.mv, y_skel = _chain([(L_skel, theta_skel, [[0], [0]]),
                                  (None, W1_skel, [[0, 2], [0, 3]]),
                                  (None, W2_skel, [[3, 1], [0, 3]]),
                                  (None, R_skel, [[1, 3], [0, 1]])])
        if y_skel.data.shape != theta_skel.data.shape:
            raise AssertionError("2s matvec output layout mismatch")
        self.split = TwoSiteSplitPlan(theta_skel, A_skel, B_skel)
        if direction == "right":
            stages = _grow_stages("right", L_skel, None, A_skel, W1_skel)
        else:
            stages = _grow_stages("left", None, R_skel, B_skel, W2_skel)
        self.grow, _ = _chain(stages)

    def __call__(self, dA, dB, dW1, dW2, dL, dR):
        mv1, mv2, mv3, mv4 = self.mv
        with highest_precision():
            evals, evecs = krylov.eigsh_lanczos(
                lambda x: mv4(mv3(mv2(mv1(dL, x), dW1), dW2), dR),
                self.theta(dA, dB), num_krylov_vecs=self.m, numeig=1,
                ritz_method=self.ritz, reorthogonalize=self.reorth)
            absorb = "right" if self.direction == "right" else "left"
            ld, rd, terr = self.split(evecs[:, 0], absorb)
            if self.direction == "right":
                denv = _grow(self.grow, "right", ld, dW1, dL)
            else:
                denv = _grow(self.grow, "left", rd, dW2, dR)
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
        for name, value in (("mesh", mesh), ("ep_mesh", ep_mesh),
                            ("ep_capacity", ep_capacity or None)):
            if value is not None:
                raise NotImplementedError(f"{name}= {_MULTI_DEVICE}")
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

    # -- plans, keyed on the charge structure ------------------------------
    def _structure_sig(self, *tensors):
        return tuple(TE._structure_key(t) for t in tensors)

    def _canon_program(self, site: int) -> _CanonProgram:
        key = ("canon", self._structure_sig(
            self.skeleton[site], self.skeleton[site - 1], self.mpo[site],
            self._Rskel[site + 1]))
        if key not in self._programs:
            self._programs[key] = _CanonProgram(
                self.skeleton[site], self.skeleton[site - 1],
                self.mpo[site], self._Rskel[site + 1])
        return self._programs[key]

    def _program(self, site: int, direction: str) -> _SiteProgram:
        # keyed on the charge STRUCTURE, not the site index: sites of a
        # smooth bond profile may share structures
        nxt = site + 1 if direction == "right" else site - 1
        key = (direction, self._structure_sig(
            self.skeleton[site], self.skeleton[nxt], self.mpo[site],
            self._Lskel[site], self._Rskel[site + 1]))
        if key not in self._programs:
            self._programs[key] = _SiteProgram(
                self.skeleton[site], self.skeleton[nxt], self.mpo[site],
                self._Lskel[site], self._Rskel[site + 1], direction,
                self.m, self.ritz, self.reorth)
        return self._programs[key]

    def _bond_program(self, bond: int, direction: str) -> _BondProgram:
        key = ("2s", direction, self._structure_sig(
            self.skeleton[bond], self.skeleton[bond + 1],
            self.mpo[bond], self.mpo[bond + 1],
            self._Lskel[bond], self._Rskel[bond + 2]))
        if key not in self._programs:
            self._programs[key] = _BondProgram(
                self.skeleton[bond], self.skeleton[bond + 1],
                self.mpo[bond], self.mpo[bond + 1],
                self._Lskel[bond], self._Rskel[bond + 2], direction,
                self.m, self.ritz, self.reorth)
        return self._programs[key]

    def precompile(self, two_site: bool = False, verbose: int = 0) -> float:
        """Build every plan of the one-site sweep (and of the two-site
        sweep with ``two_site``) and copy its index maps to the data's
        device: the cold start that the first sweep would otherwise pay.
        Returns the seconds spent."""
        t0 = time.perf_counter()
        n0 = len(TE._PLAN_CACHE)
        for site in range(self.N - 1, 0, -1):
            self._canon_program(site)
        for site in range(self.N - 1):
            self._program(site, "right")
            self._program(site + 1, "left")
            if two_site:
                self._bond_program(site, "right")
                self._bond_program(site, "left")
        for plan in list(TE._PLAN_CACHE.values()):
            plan["maps"].on(self.device)
        for prog in self._programs.values():
            for shift in (getattr(prog, "shift", None),
                          getattr(prog, "split", None)):
                if shift is not None:
                    shift.maps.on(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if verbose:
            print(f"precompile: {len(self._programs)} programs, "
                  f"{len(TE._PLAN_CACHE) - n0} new plans in {dt:.1f} s")
        return dt

    def _boundary_env(self) -> torch.Tensor:
        """The trivial (B, 1) boundary environment."""
        return torch.ones((self.B, 1), dtype=self._env_dtype,
                          device=self.device)

    def right_canonicalize(self) -> List[torch.Tensor]:
        """Left shifts from the right end (the prepass of every run);
        returns the right environments, index N the boundary."""
        Rdata: List[Optional[torch.Tensor]] = [None] * (self.N + 1)
        Rdata[self.N] = self._boundary_env()
        for site in range(self.N - 1, 0, -1):
            qd, prev2, rnew = self._canon_program(site)(
                self.data[site], self.data[site - 1], self.mpo_data[site],
                Rdata[site + 1])
            self.data[site] = qd
            self.data[site - 1] = prev2
            Rdata[site] = rnew
        return Rdata

    def sweep_one_site(self, Rdata: List[torch.Tensor]) -> torch.Tensor:
        """One left-to-right-to-left one-site sweep from the right envs
        ``Rdata`` (updated in place, as the data); returns the (B,)
        energies of its last step, on the device."""
        Ldata: List[Optional[torch.Tensor]] = [None] * (self.N + 1)
        Ldata[0] = self._boundary_env()
        es = None
        for site in range(self.N - 1):
            es, qd, nxt, lnew = self._program(site, "right")(
                self.data[site], self.data[site + 1], self.mpo_data[site],
                Ldata[site], Rdata[site + 1])
            self.data[site] = qd
            self.data[site + 1] = nxt
            Ldata[site + 1] = lnew
        for site in range(self.N - 1, 0, -1):
            es, qd, prv, rnew = self._program(site, "left")(
                self.data[site], self.data[site - 1], self.mpo_data[site],
                Ldata[site], Rdata[site + 1])
            self.data[site] = qd
            self.data[site - 1] = prv
            Rdata[site] = rnew
        return es

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
            es, ld, rd, terr, lnew = self._bond_program(bond, "right")(
                self.data[bond], self.data[bond + 1], self.mpo_data[bond],
                self.mpo_data[bond + 1], Ldata[bond], Rdata[bond + 2])
            self.data[bond] = ld
            self.data[bond + 1] = rd
            Ldata[bond + 1] = lnew
            terr_total = terr_total + terr
        for bond in range(self.N - 2, -1, -1):
            es, ld, rd, terr, rnew = self._bond_program(bond, "left")(
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
            es = self.sweep_one_site(Rdata).cpu().numpy()
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
            es = es.cpu().numpy()
            self.energies.append(es)
            self.truncation_errors.append(terr.cpu().numpy())
            if verbose:
                print(f"2s sweep {sweep}: E mean {es.mean():.10f} "
                      f"terr mean {float(terr.mean()):.3e}")
            e_mean = float(es.mean())
            if e_prev is not None and abs(e_mean - e_prev) < tol:
                break
            e_prev = e_mean
        return es
