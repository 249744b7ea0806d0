"""Two results of chip_smoke.py held against the JAX package, from the states
the card made.

1. The f32 ``qr_impl="polar_express"`` sweep.  chip_smoke.py's
   ``polar_express_batched`` phase runs 4 batched one-site sweeps (TFI
   N=32, chi=64, m=10, f32, B=256, start states from seed 11 on the card)
   and reports how many instances end outside [DE_LO, DE_HI].  Here the
   worst K of them are swept again: on the card alone in a batch of K, and
   on the CPU by the JAX package's f32 batched sweep (x64 off, its off-TPU
   Lanczos) and by the port.  Both packages also sweep FRESH_B start
   states made with numpy on the CPU, and factor PANELS random panels
   with one ``ns_polar_express`` each.
2. ``InfiniteMPS.canonicalize`` of the critical VUMPS state (the f64
   chi=64 state of chip_smoke.py's ``vumps_converge`` phase).  With the
   default 30 Krylov vectors neither package resolves its right fixed
   point.  Here both canonicalise the same cell with 30 to 50 vectors, and
   the port once more with the JAX package's restart shifts in place of
   its own.

Two steps:

    python tests/jax_witness.py card --out witness.npz
        on the card, the port only: makes both states, sweeps as above,
        and saves the K start states and the VUMPS cell;
    python tests/jax_witness.py cpu --in witness.npz
        on the CPU, with the JAX package.

Every energy is <psi|H|psi>/<psi|psi> of the returned state, evaluated in
float64 by the port on the CPU, minus REFERENCE_ENERGY.  Each run prints
one JSON line.
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

# the repo's root, for both packages when run as a script
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# chip_smoke.py's constants for the two phases
REFERENCE_ENERGY = -40.384313161218365
N, CHI, D, KRYLOV, BATCH, SWEEPS = 32, 64, 2, 10, 256, 4
DE_LO, DE_HI = -1e-5, 1e-4
SEED = 11
VUMPS_F64 = dict(num_iterations=60, tol=1e-5, gmres_m=40, gmres_restarts=8)
IMPS_KRYLOV = (30, 35, 40, 50)
FRESH_SEED, FRESH_B, PANELS = 13, 96, 20
DEVICE = "cuda"


def _delta_e(As_batch):
    """E - REFERENCE_ENERGY of every instance, in float64 on the CPU."""
    from tensornetwork_tpu_torch import FiniteTFI
    from tensornetwork_tpu_torch.models.dmrg import mps_mpo_expectation
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device="cpu")
    As_batch = torch.as_tensor(np.array(As_batch)).double()
    return [float(mps_mpo_expectation(a, mpo.Ws, mpo.vL, mpo.vR))
            - REFERENCE_ENERGY for a in As_batch]


def _port_sweeps(start, qr_impl, device):
    """SWEEPS batched one-site sweeps of the port from ``start`` (B, N,
    chi, d, chi) f32; returns the energies after every sweep."""
    from tensornetwork_tpu_torch import FiniteTFI, batched_one_site_sweep
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float32, device=device)
    As, renvs, out = start, None, []
    for _ in range(SWEEPS):
        res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=KRYLOV,
                                     qr_impl=qr_impl, renvs=renvs)
        As, renvs = res.As, res.renvs
        out.append(_delta_e(As.cpu()))
    return out


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _outside(de):
    de = np.asarray(de)
    return int(np.sum((de < DE_LO) | (de > DE_HI)))


def card(out_path, keep):
    from tensornetwork_tpu_torch import FiniteTFI
    from tensornetwork_tpu_torch.models import vumps as V
    from tensornetwork_tpu_torch.models.dmrg import random_mps_stack
    if not torch.cuda.is_available():
        sys.exit("the card step needs a CUDA device")
    start = random_mps_stack(SEED, BATCH * N, CHI, D, dtype=torch.float32,
                             device=DEVICE).reshape(BATCH, N, CHI, D, CHI)
    t = time.perf_counter()
    full = _port_sweeps(start, "polar_express", DEVICE)
    last = np.array(full[-1])
    worst = np.argsort(-last)[:keep]
    _emit(run="card_port_polar_express_B256", seconds=time.perf_counter() - t,
          outside_window=_outside(last), delta_e_max=float(last.max()),
          worst=worst.tolist(), delta_e=[[s[i] for i in worst] for s in full])
    polar = np.array(_port_sweeps(start, "polar", DEVICE)[-1])
    _emit(run="card_port_polar_B256", outside_window=_outside(polar),
          delta_e_max=float(polar.max()),
          delta_e_worst=[float(polar[i]) for i in worst])
    sub = start[torch.as_tensor(worst, device=DEVICE)]
    for qr_impl in ("polar_express", "polar"):
        _emit(run=f"card_port_{qr_impl}_worst", qr_impl=qr_impl,
              delta_e=_port_sweeps(sub, qr_impl, DEVICE))
    W = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64,
                  device=DEVICE).Ws[N // 2]
    state = V.vumps(W, chi=CHI, dtype=torch.float64, seed=0,
                    **VUMPS_F64).state
    _emit(run="card_vumps_f64", chi=CHI)
    np.savez(out_path, start=sub.cpu().numpy(), worst=worst,
             delta_e=np.array([[s[i] for i in worst] for s in full]),
             AL=state.AL.cpu().numpy())


def _jax_sweeps(start, qr_impl):
    """The JAX package's f32 batched sweeps from ``start``, on the CPU;
    returns the energies after every sweep."""
    import jax
    import jax.numpy as jnp
    from tensornetwork_tpu.models import mpo as jmpo
    from tensornetwork_tpu.parallel import batch as jbatch
    # the JAX package's schedule coefficients are numpy float64 scalars,
    # which promote an f32 panel under x64: its f32 sweep runs with x64 off
    with jax.enable_x64(False):
        jm = jmpo.FiniteTFI(1.0, 1.0, N=N, dtype=jnp.float32)
        As, renvs, out = jnp.asarray(start), None, []
        for _ in range(SWEEPS):
            res = jbatch.batched_one_site_sweep(
                As, jm.Ws, jm.vL, jm.vR, num_krylov_vecs=KRYLOV,
                qr_impl=qr_impl, paired=False, renvs=renvs)
            As, renvs = res.As, res.renvs
            out.append(_delta_e(np.asarray(As)))
    return out


def _jumps(out):
    """Instance-sweeps after the first whose energy sits above 1e-3."""
    return int(np.sum(np.asarray(out[1:]) > 1e-3))


def _sweeps_cpu(start):
    for qr_impl in ("polar_express", "polar"):
        out = _jax_sweeps(start, qr_impl)
        _emit(run=f"cpu_jax_{qr_impl}_worst", qr_impl=qr_impl,
              outside_window=_outside(out[-1]), delta_e=out)
    out = _port_sweeps(torch.from_numpy(start), "polar_express", "cpu")
    _emit(run="cpu_port_polar_express_worst", qr_impl="polar_express",
          outside_window=_outside(out[-1]), delta_e=out)
    # fresh start states from numpy, the same for both packages
    rng = np.random.default_rng(FRESH_SEED)
    fresh = (rng.standard_normal((FRESH_B, N, CHI, D, CHI))
             / np.sqrt(D * CHI)).astype(np.float32)
    for name, out in (
            ("jax", _jax_sweeps(fresh, "polar_express")),
            ("port", _port_sweeps(torch.from_numpy(fresh), "polar_express",
                                  "cpu"))):
        last = np.asarray(out[-1])
        _emit(run=f"cpu_{name}_polar_express_fresh", batch=FRESH_B,
              seed=FRESH_SEED, outside_window=_outside(last),
              delta_e_max=float(last.max()), jumps_above_1e_3=_jumps(out),
              instance_sweeps=FRESH_B * (SWEEPS - 1))


def _panels_cpu():
    """One f32 ns_polar_express of (dchi, chi) = (128, 64) panels with
    singular values uniform in [0.01, 1], in both packages: the largest
    |Q P - m| and |Q Q^T m - m| of PANELS panels."""
    import jax
    import jax.numpy as jnp
    from tensornetwork_tpu.ops import decompositions as jdec
    from tensornetwork_tpu_torch.ops import decompositions as tdec
    rng = np.random.default_rng(0)
    err = {"jax": [], "port": []}
    with jax.enable_x64(False):
        for _ in range(PANELS):
            U, _ = np.linalg.qr(rng.standard_normal((D * CHI, CHI)))
            V, _ = np.linalg.qr(rng.standard_normal((CHI, CHI)))
            m = ((U * rng.uniform(0.01, 1.0, CHI)) @ V.T).astype(np.float32)
            q, p = jdec.ns_polar_express(jnp.asarray(m))
            err["jax"].append((np.asarray(q, np.float64),
                               np.asarray(p, np.float64)))
            q, p = tdec.ns_polar_express(torch.from_numpy(m))
            err["port"].append((q.double().numpy(), p.double().numpy()))
            for name in err:
                q, p = err[name][-1]
                m64 = m.astype(np.float64)
                err[name][-1] = (np.linalg.norm(q @ p - m64),
                                 np.linalg.norm(q @ (q.T @ m64) - m64))
    for name, e in err.items():
        e = np.array(e)
        _emit(run=f"cpu_{name}_ns_polar_express_panels", panels=PANELS,
              max_qp_minus_m=float(e[:, 0].max()),
              max_projection_error=float(e[:, 1].max()))


def _canonicalize_cpu(AL):
    import jax
    import jax.numpy as jnp
    from tensornetwork_tpu.models import infinite_mps as jimps
    from tensornetwork_tpu.ops import krylov as jkrylov
    from tensornetwork_tpu_torch.models import infinite_mps as timps
    from tensornetwork_tpu_torch.ops import krylov as tkrylov
    own = tkrylov._small_eig

    def jax_shifts(Hm, hermitian):
        """The JAX package's restart shifts: the eigenvalues of its fixed
        count of double-shift QR steps without deflation."""
        _, _, lasts = own(Hm, hermitian)
        T = jkrylov._real_schur_qr(jnp.asarray(Hm.numpy()),
                                   max(40, 4 * Hm.shape[0]))
        jre, jim = jkrylov._quasi_tri_eigvals(T)
        return (torch.from_numpy(np.array(jre)),
                torch.from_numpy(np.array(jim)), lasts)

    with jax.enable_x64(True):
        for k in IMPS_KRYLOV:
            row = dict(run="cpu_canonicalize_vumps_f64", krylov=k)
            jm = jimps.InfiniteMPS(jnp.asarray(AL[None]))
            eta, _ = jm.canonicalize(k)
            row.update(jax_eta_minus_1=eta - 1,
                       jax_residual=jm.check_right_canonical())
            for name, small_eig in (("port", own),
                                    ("port_jax_shifts", jax_shifts)):
                tkrylov._small_eig = small_eig
                try:
                    tm = timps.InfiniteMPS(torch.from_numpy(AL[None].copy()))
                    eta, _ = tm.canonicalize(k)
                finally:
                    tkrylov._small_eig = own
                row[f"{name}_eta_minus_1"] = eta - 1
                row[f"{name}_residual"] = tm.check_right_canonical()
            _emit(**row)


def cpu(in_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    saved = np.load(in_path)
    _panels_cpu()
    _sweeps_cpu(saved["start"])
    _canonicalize_cpu(saved["AL"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="step", required=True)
    c = sub.add_parser("card")
    c.add_argument("--out", required=True)
    c.add_argument("--keep", type=int, default=8)
    h = sub.add_parser("cpu")
    h.add_argument("--in", dest="inp", required=True)
    args = ap.parse_args()
    if args.step == "card":
        card(args.out, args.keep)
    else:
        cpu(args.inp)


if __name__ == "__main__":
    main()
