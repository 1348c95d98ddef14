"""The rules of the clip_glass_torch package: it stands alone (no JAX, nothing
of the JAX package), its entry points refuse to fall back to the CPU, its
kernel wrappers take the plain version only for CPU tensors, and its copy
of the config registry equals the JAX package's."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch

import clip_glass_torch
from clip_glass_torch import config as tconfig
from clip_glass_torch.ops import bias_act, cuda, modulated_conv, s2d, upfirdn

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "clip_glass_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "clip_glass_tpu")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_leaves_out_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "import chip_smoke, run_torch, bench_torch\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(len(sys.modules)); print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


# every port-side file outside the package
PORT_FILES = sorted(
    [ROOT / "chip_smoke.py", ROOT / "run_torch.py", ROOT / "bench_torch.py",
     *(ROOT / "scripts").glob("*_torch.py"), *(ROOT / "examples").glob("*_torch.py")]
    + [ROOT / "scripts" / f"{n}.py" for n in ("profile_torch_flagship", "wrapper_host_cost",
                                              "conv_s8_ablation", "projector_step_cost")])


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [n for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_default_device_needs_a_gpu(monkeypatch):
    """Without a card, an entry point given no device raises instead of
    carrying on on the CPU."""
    from clip_glass_torch.evolve.algorithm import make_algorithm
    from clip_glass_torch.fitness.generator import Generator
    from clip_glass_torch.fitness.problem import GenerationProblem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.get_config("StyleGAN2_ffhq_d")
    for build in (lambda: GenerationProblem(cfg), lambda: Generator(cfg),
                  lambda: make_algorithm(cfg, lambda X: X)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_kernel_wrappers_take_the_plain_version_on_cpu(rng):
    counts = (bias_act.noise_bias_lrelu.launches, upfirdn.upsample2x.launches,
              modulated_conv.modulated_matmul.launches, s2d.s2d_conv2x2.launches)
    x = torch.from_numpy(rng.normal(size=(2, 4, 5, 8)).astype(np.float32))
    noise, ns, b = torch.randn(4, 5), torch.tensor(0.3), torch.randn(8)
    torch.testing.assert_close(bias_act.noise_bias_lrelu(x, noise, ns, b),
                               bias_act.noise_bias_lrelu_plain(x, noise, ns, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(upfirdn.upsample2x(x), upfirdn.upsample2x_plain(x),
                               rtol=0, atol=0)
    xm, s, w, d, bo = (torch.randn(2, 20, 8), torch.randn(2, 8), torch.randn(8, 3),
                       torch.randn(2, 3), torch.randn(3))
    torch.testing.assert_close(modulated_conv.modulated_matmul(xm, s, w, d, bo),
                               modulated_conv.modulated_matmul_plain(xm, s, w, d, bo),
                               rtol=0, atol=0)
    xs, K, st, dm = (torch.randn(2, 5, 5, 8), torch.randn(2, 2, 8, 8), torch.randn(2, 8),
                     torch.randn(2, 8))
    for pad0 in (0, 1):
        torch.testing.assert_close(s2d.s2d_conv2x2(xs, K, st, dm, pad0),
                                   s2d.s2d_conv2x2_plain(xs, K, st, dm, pad0),
                                   rtol=0, atol=0)
    assert counts == (bias_act.noise_bias_lrelu.launches, upfirdn.upsample2x.launches,
                      modulated_conv.modulated_matmul.launches, s2d.s2d_conv2x2.launches)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing falls back."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda, "build_dir", lambda: tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_library_name_follows_the_sources():
    path = cuda.library_path()
    assert path.parent == ROOT / "build" / "clip_glass_torch"
    assert path.name.startswith("libclip_glass_kernels_") and path.suffix == ".so"
    for name in cuda.SOURCES + cuda.HEADERS:
        assert (cuda.CSRC / name).is_file()


def test_config_registry_matches_jax():
    from clip_glass_tpu import config as jconfig

    assert tconfig.list_configs() == jconfig.list_configs()
    for name in tconfig.list_configs():
        assert dataclasses.asdict(tconfig.get_config(name)) == \
            dataclasses.asdict(jconfig.get_config(name)), name


def test_version():
    assert clip_glass_torch.__version__


def test_port_files_outside_the_package_exist():
    assert all(p.is_file() for p in PORT_FILES)
    names = {p.name for p in PORT_FILES}
    assert {"bench_torch.py", "bench_matrix_torch.py", "bench_serving_torch.py",
            "bench_serving_curve_torch.py", "bench_wallclock_torch.py",
            "api_search_torch.py"} <= names


def test_build_root_is_the_checkout_build_dir():
    """In a checkout the libraries go to build/clip_glass_torch beside the
    package, which .gitignore lists."""
    from clip_glass_torch.core.cache import build_root
    from clip_glass_torch.tokenizers import native

    assert cuda.build_dir() == build_root() == ROOT / "build" / "clip_glass_torch"
    assert native.library_path().parent == build_root()
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()


def _installed_package(tmp_path):
    site = tmp_path / "site-packages"
    pkg = site / "clip_glass_torch"
    pkg.mkdir(parents=True)
    return site, pkg


def test_build_root_leaves_a_read_only_parent(tmp_path, monkeypatch):
    """An installed package whose parent is read-only builds under
    $XDG_CACHE_HOME/clip_glass_torch, or ~/.cache/clip_glass_torch."""
    from clip_glass_torch.core.cache import build_root

    site, pkg = _installed_package(tmp_path)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert build_root(pkg) == site / "build" / "clip_glass_torch"   # writable: beside it
    site.chmod(0o555)
    try:
        assert build_root(pkg) == tmp_path / "xdg" / "clip_glass_torch"
        monkeypatch.delenv("XDG_CACHE_HOME")
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        assert build_root(pkg) == tmp_path / "home" / ".cache" / "clip_glass_torch"
    finally:
        site.chmod(0o755)


def test_build_root_takes_an_existing_writable_build_dir(tmp_path, monkeypatch):
    """A writable build/clip_glass_torch decides even under a read-only
    parent; a read-only one sends the build to the cache."""
    from clip_glass_torch.core.cache import build_root

    site, pkg = _installed_package(tmp_path)
    local = site / "build" / "clip_glass_torch"
    local.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    site.chmod(0o555)
    try:
        assert build_root(pkg) == local
        local.chmod(0o555)
        assert build_root(pkg) == tmp_path / "xdg" / "clip_glass_torch"
    finally:
        local.chmod(0o755)
        site.chmod(0o755)


def test_package_data_ships_the_sources_built_at_run_time():
    """A wheel carries what the package compiles at first use: the CUDA
    sources and the native BPE core (as the JAX package ships its own)."""
    import fnmatch
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]
    for rel in [*(p.relative_to(PKG) for p in (PKG / "csrc").iterdir()),
                *(p.relative_to(PKG) for p in (PKG / "native").glob("*.cpp"))]:
        assert any(fnmatch.fnmatch(str(rel), pat) for pat in data["clip_glass_torch"]), rel
    assert "native/*.cpp" in data["clip_glass_torch"]
    assert (PKG / "native" / "bpe_core.cpp").is_file()
