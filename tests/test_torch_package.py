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
            "import chip_smoke, run_torch\n"
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


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
                             ROOT / "chip_smoke.py", ROOT / "run_torch.py",
                             ROOT / "scripts" / "quant_fidelity_torch.py",
                             ROOT / "examples" / "project_image_torch.py",
                             ROOT / "examples" / "train_stylegan2_torch.py"],
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
