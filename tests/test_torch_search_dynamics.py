"""scripts/search_dynamics_ab_torch.py, the port's search-dynamics A/B, on
the CPU: its copy of the pymoo-0.4.2-style host loop against the JAX
package's script's (bitwise, on a numpy toy fitness), the port's engine
curves (elitist survival: the best F0 never rises), and the table a 2-seed,
3-generation run prints.
"""

import importlib.util
import os
import types

import numpy as np
import pytest

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ("| config | gen | device best F0 (mean+/-sd) | host-pymoo (mean+/-sd) | Welch z "
          "| fresh-noise (mean+/-sd) | z vs device |")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ab():
    return _load("search_dynamics_ab_torch")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(n_obj):
    """A numpy fitness of n_obj objectives with ties broken by the values."""
    def f(X):
        f0 = np.sum((X - 0.5) ** 2, axis=1)
        cols = [f0, np.sum((X + 0.5) ** 2, axis=1)][:n_obj]
        return np.stack(cols, 1)
    return f


@pytest.mark.parametrize("use_nsga2", [False, True])
def test_host_loop_is_the_jax_scripts(ab, use_nsga2):
    jax_ab = _load("search_dynamics_ab")
    config = types.SimpleNamespace(pop_size=8, n_var=6, xl=-10.0, xu=10.0)
    fit = _toy(2 if use_nsga2 else 1)
    got = ab.host_minimize(fit, config, seed=3, n_gen=6, use_nsga2=use_nsga2)
    want = jax_ab.host_minimize(fit, config, seed=3, n_gen=6, use_nsga2=use_nsga2)
    assert got.shape == (7,)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def rows(ab):
    return ab.run(2, 3, "cpu")


def test_engine_curves_never_rise(rows):
    for r in rows:
        for loop in ("device", "fresh-noise"):
            curves = r["curves"][loop]
            assert curves.shape == (2, 4), (r["name"], loop)
            assert np.isfinite(curves).all()
            assert (np.diff(curves, axis=1) <= 0).all(), (r["name"], loop, curves)
        assert r["curves"]["host"].shape == (2, 4)
        assert r["z"].shape == r["zf"].shape == (4,)


def test_fresh_noise_differs_from_fixed_noise(rows):
    """noise_scale 0.3 makes the noise matter: the fresh-noise loop's curves
    are not the fixed-noise engine's."""
    for r in rows:
        assert not np.array_equal(r["curves"]["device"], r["curves"]["fresh-noise"]), r["name"]


def test_two_seed_run_prints_the_table(ab, capsys):
    assert ab.main(["--seeds", "2", "--gens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert HEADER in out
    assert "## Search-dynamics A/B (2 seeds, 3 generations, TINY models, pop 8)" in out
    for name in ("StyleGAN2_ffhq_nod", "StyleGAN2_ffhq_d"):
        assert f"| {name} | max-z over all gens |" in out
