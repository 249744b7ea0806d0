"""One file a model, named by a configuration's ``model``: its MPO written
from the Hamiltonian's equations, float64 numpy, and where a closed form
gives it, its exact ground energy.  Each file holds

    mpo(cfg, params, instance) -> (Ws (N, M, M, d, d), vL (M,), vR (M,))
    exact_energy(cfg) -> float          (optional)

with W[w, v, s, t] = <s| O |t> on the left (w) and right (v) MPO bonds;
vL picks the left boundary's row, vR the right one's column.  ``params``
holds per-instance couplings (arrays of length B) where the configuration
draws them.  The files are found by ``core/registry.py`` under the run's
root, and import nothing of the port."""
