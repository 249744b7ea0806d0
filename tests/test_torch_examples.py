"""The repo's examples on the port (``tensornetwork_tpu_torch/examples``)
against ``tests/test_examples.py``'s cases at its sizes, on the CPU.

Where an example takes inputs, the JAX example runs on the same numpy
inputs: ``fft_via_network`` within 1e-10 of it (complex128) and 1e-8 of
``np.fft.fft``, ``sat_count`` exactly, the ladder's solved path cost
exactly.  The rest hold what the JAX cases hold: the TFI energy within
1e-6 relative of exact diagonalisation (float64), the XXZ energies
negative and never rising across sweeps (above the sector's exact energy
less 1e-9), the TEBD fidelity above 0.999, the classifier's accuracy
above 0.22 after 300 steps and its parameters through the checkpoint
bit for bit, the disorder study's energies finite of shape (B,), and the
distributed example on two gloo ranks (``tests/torch_ranks.py``, init and
join timeouts) with capacity EP equal to the single-device run.  Without
a card, every example raises unless asked for the CPU.  The
classifier also starts from the JAX example's Flax init, carried in by
``interop.load_flax_params``: untrained, both reach the same test
accuracy.  Beside the JAX cases: the MERA example at two layers and 20
iterations stays above -4/pi."""
import importlib.util
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetwork_tpu_torch.examples import (
    disorder_study, distributed_symmetric_dmrg, dmrg_tfi, fft,
    image_classifier, path_solvers, sat, simple_mera, symmetric_dmrg,
    wavefunctions)
from tensornetwork_tpu_torch.models.mpo import FiniteTFI, mpo_to_dense
from tensornetwork_tpu_torch.utils.checkpoint import load_pytree, save_pytree

from tests import torch_ranks
from tests.test_torch_symmetric_dmrg import sector_ground_energy

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_example(name):
    """The JAX example module, loaded by path without its __main__."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fft_example():
    jfft = _jax_example("fft")
    rng = np.random.default_rng(1)
    for n in (8, 32):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        y = fft.fft_via_network(x, device="cpu")
        assert y.dtype == np.complex128
        np.testing.assert_allclose(y, np.fft.fft(x), atol=1e-8)
        np.testing.assert_allclose(y, jfft.fft_via_network(x), rtol=0,
                                   atol=1e-10)


def test_sat_example():
    jsat = _jax_example("sat")
    assert sat.sat_count([(1, 2, 3)], device="cpu") == 7
    assert sat.sat_count([(1, 2, 3), (-1, -2, -3)], device="cpu") == 6
    clauses = [(1, 2, 3), (2, 3, 4), (-1, -2, 4)]
    brute = sum(all(any((bits[abs(l) - 1] == 1) == (l > 0) for l in c)
                    for c in clauses)
                for bits in itertools.product([0, 1], repeat=4))
    for formula in ([(1, 2, 3)], [(1, 2, 3), (-1, -2, -3)], clauses):
        assert sat.sat_count(formula, device="cpu") == jsat.sat_count(
            formula)
    assert sat.sat_count(clauses, device="cpu") == brute


def test_dmrg_example_small():
    e = dmrg_tfi.main(N=8, chi=16, sweeps=4, device="cpu",
                      dtype=torch.float64)
    exact = float(np.linalg.eigvalsh(mpo_to_dense(FiniteTFI(
        Jx=1.0, Bz=1.0, N=8, dtype=torch.float64, device="cpu")))[0])
    np.testing.assert_allclose(e, exact, rtol=1e-6)


def test_symmetric_dmrg_example_small():
    dmrg = symmetric_dmrg.solve(N=8, chi=16, sweeps=5, device="cpu",
                                verbose=0)
    es = np.array(dmrg.energies)
    assert symmetric_dmrg.main(N=4, chi=4, sweeps=1, device="cpu") < 0
    assert np.all(np.isfinite(es)) and es[-1] < 0
    assert np.all(np.diff(es) <= 1e-10)
    assert es[-1] >= sector_ground_energy(8, 1.0, 1.0, 0.0, 4) - 1e-9


def test_wavefunctions_example_small():
    fid = wavefunctions.main(N=6, dt=0.02, steps=10, device="cpu")
    assert fid > 0.999


def test_simple_mera_example_small():
    e = simple_mera.main(num_layers=2, iterations=20, device="cpu")
    assert -4 / np.pi - 1e-9 <= e < -1.2


@pytest.fixture(scope="module")
def flax_init():
    """The JAX example's init as numpy arrays (one jitted init)."""
    jex = _jax_example("image_classifier")
    x = jnp.zeros((2, 28, 28), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jex.TNClassifier().init)(jax.random.PRNGKey(0), x))
    x_test, y_test = jex.synthetic_mnist(1024, seed=1)
    acc = float(jnp.mean(jnp.argmax(jax.jit(jex.TNClassifier().apply)(
        params, x_test), -1) == y_test))
    return params, acc


def test_image_classifier_learns_and_checkpoints(tmp_path):
    acc, params = image_classifier.main(steps=300, batch=128, device="cpu")
    assert acc > 0.22  # 10-class chance is 0.1
    # params round-trip through the generic checkpoint
    path = str(tmp_path / "clf")
    save_pytree(path, params)
    restored = load_pytree(path)
    assert sorted(restored) == sorted(params)
    for k in params:
        assert torch.equal(restored[k], params[k])


def test_image_classifier_takes_the_jax_example_weights(flax_init):
    params, jax_acc = flax_init
    acc, state = image_classifier.main(steps=0, device="cpu",
                                       params=params)
    np.testing.assert_array_equal(
        state["head.weight"].numpy(),
        np.asarray(params["params"]["Dense_0"]["kernel"]).T)
    assert abs(acc - jax_acc) <= 1 / 1024


def test_path_solvers_example():
    jps = _jax_example("path_solvers")
    cost = path_solvers.main(device="cpu")
    assert cost > 0
    assert cost == jps.main()
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for t, jt in zip(*(m.ladder_network(r)[0] for m, r in
                       ((path_solvers, rng), (jps, jrng)))):
        np.testing.assert_array_equal(t, jt)


def test_disorder_study_example():
    es = disorder_study.main(N=6, chi=10, B=3, num_sweeps=3, verbose=0,
                             device="cpu")
    assert es.shape == (3,)
    assert np.all(np.isfinite(es))
    d = disorder_study.solve(N=6, chi=10, B=3, num_sweeps=3, verbose=0,
                             device="cpu")
    np.testing.assert_array_equal(d.energies[-1], es)
    assert np.all(np.diff(np.stack(d.energies), axis=0) <= 1e-4)


def test_distributed_symmetric_dmrg_example(tmp_path):
    export_dir = tmp_path / "plans"
    res = torch_ranks.spawn("example_distributed", 2, tmp_path, dict(
        N=6, chi=10, B=2, sweeps=2, export_dir=str(export_dir)))
    files = len(list(export_dir.iterdir()))
    assert int(res[0]["written"]) == files > 0
    assert int(res[1]["written"]) == 0
    for r in res:
        assert int(r["loaded"]) == files
        assert r["es_ep"].shape == (2,) and np.all(np.isfinite(r["es_ep"]))
        # disjoint sector sums: capacity EP is the single-device run
        np.testing.assert_array_equal(r["es_ep"], r["es_ref"])
    np.testing.assert_array_equal(res[0]["es_ep"], res[1]["es_ep"])


@pytest.mark.parametrize("call", [
    lambda: dmrg_tfi.main(N=4, chi=2, sweeps=1),
    lambda: symmetric_dmrg.main(N=4, chi=4, sweeps=1),
    lambda: disorder_study.main(N=4, chi=4, B=1, num_sweeps=1, verbose=0),
    lambda: wavefunctions.main(N=4, steps=1),
    lambda: simple_mera.main(num_layers=1, iterations=1),
    lambda: fft.fft_via_network(np.ones(4)),
    lambda: sat.sat_count([(1, 2, 3)]),
    lambda: path_solvers.main(),
    lambda: image_classifier.main(steps=0),
    lambda: distributed_symmetric_dmrg.main(N=4, chi=4, B=1, sweeps=1),
], ids=["dmrg_tfi", "symmetric_dmrg", "disorder_study", "wavefunctions",
        "simple_mera", "fft", "sat", "path_solvers", "image_classifier",
        "distributed_symmetric_dmrg"])
def test_examples_run_on_the_card_unless_asked(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()
