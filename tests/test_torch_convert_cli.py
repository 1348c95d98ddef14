"""The port's convert CLI (`python -m clip_glass_torch.weights.convert_weights`)
against the JAX package's `scripts/convert_weights.py` on the same TINY
files: every `.npz` it writes holds the same arrays (keys, dtypes, bits)
and every `<stem>_cfg.json` sidecar the same bytes. Then each package's
Generator loads the other's output, and the two fitnesses agree at 1e-4 of
their scale (fp32)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.biggan import model as jbg

from clip_glass_torch.config import get_config
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.weights import convert_weights, synthesize

import biggan_hf_oracle
from test_torch_weights import CLIP_RN, jax_synth
from torch_parity import N, T, assert_close_scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("sources")
    js = jax_synth()
    src = {"gpt2": str(root / "gpt2.bin"), "stylegan2-tf": str(root / "sg2.pkl"),
           "biggan": str(root / "biggan.bin"), "stylegan2": str(root / "pth"),
           "clip-vit": str(root / "ViT-B-32.pt"), "clip-rn": str(root / "RN50.pt")}
    js.synth_gpt2(src["gpt2"], n_embd=64)
    js.synth_stylegan2_pkl(src["stylegan2-tf"])
    torch.save(biggan_hf_oracle.make_random_oracle(jbg.TINY, seed=2).state_dict(),
               src["biggan"])
    synthesize.write_stylegan2_pth(src["stylegan2"], tsg2.TINY, seed=5)
    synthesize.write_clip(src["clip-vit"], tclip.TINY, seed=6)
    synthesize.write_clip(src["clip-rn"], CLIP_RN, seed=7, jit=False)
    return src


# kind (the CLI's), source, destination (a file for the one-tree kinds)
CASES = {
    "clip-vit": ("clip", "clip.npz", []),
    "clip-rn": ("clip", "clip_rn.npz", []),
    "gpt2": ("gpt2", "gpt2.npz", []),
    "biggan": ("biggan", "biggan.npz", ["--model-name", "auto"]),
    "stylegan2": ("stylegan2", "out", []),
    "stylegan2-tf": ("stylegan2-tf", "out", []),
}


def _run_jax_script(args):
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "convert_weights.py"),
                        *args], capture_output=True, text=True, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _convert_both(sources, case, tmp_path):
    kind, dst, extra = CASES[case]
    outs = {}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        args = [kind, sources[case], str(tmp_path / side / dst), *extra]
        if side == "jax":
            _run_jax_script(args)
        else:
            assert convert_weights.main(args) == 0
        outs[side] = tmp_path / side
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_cli_writes_what_the_jax_script_writes(sources, case, tmp_path):
    outs = _convert_both(sources, case, tmp_path)
    names = _files(outs["jax"])
    assert names == _files(outs["port"]) and names
    for name in names:
        a, b = outs["jax"] / name, outs["port"] / name
        if name.endswith(".json"):
            assert a.read_bytes() == b.read_bytes(), name
            continue
        with np.load(a) as ja, np.load(b) as pa:
            assert sorted(ja.files) == sorted(pa.files), name
            for k in ja.files:
                assert ja[k].dtype == pa[k].dtype and np.array_equal(ja[k], pa[k]), (name, k)


def test_cli_runs_as_a_module(sources, tmp_path):
    r = subprocess.run([sys.executable, "-m", "clip_glass_torch.weights.convert_weights",
                        "gpt2", sources["gpt2"], str(tmp_path / "g.npz")],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "GPT-2" in r.stdout and (tmp_path / "g_cfg.json").exists()


@pytest.mark.parametrize("kind", ["lpips", "inception"])
def test_metric_kinds_exit_2_naming_their_item(kind, capsys):
    with pytest.raises(SystemExit) as e:
        convert_weights.main([kind, "a.pth", "b.npz"])
    assert e.value.code == 2 and "item 15" in capsys.readouterr().err


def test_stylegan2_dir_without_checkpoints_exits(tmp_path):
    with pytest.raises(SystemExit, match="no G.pth/D.pth/Gs.pth"):
        convert_weights.main(["stylegan2", str(tmp_path), str(tmp_path / "out")])


def test_each_generator_loads_the_others_output(sources, tmp_path):
    """The TF pickle's G/D/Gs with their noise planes and a CLIP .pt,
    converted by each package's CLI; the JAX package's Generator reads the
    port's output and the port's reads the JAX package's."""
    outs = {}
    for case in ("stylegan2-tf", "clip-vit"):
        for side, root in _convert_both(sources, case, tmp_path / case).items():
            outs.setdefault(side, {})[case] = root

    def config(get, side):
        return get("StyleGAN2_ffhq_d").replace(
            pop_size=8, batch_size=4, dim_z=32, n_var=32, target="a red flower",
            compute_dtype="float32", weights=str(outs[side]["stylegan2-tf"] / "out"))

    jgen = JProblem(config(jget_config, "port"),
                    clip_weights=str(outs["port"]["clip-vit"] / "clip.npz")).generator
    tgen = GenerationProblem(config(get_config, "jax"), device="cpu",
                             clip_weights=str(outs["jax"]["clip-vit"] / "clip.npz")).generator
    assert tgen.model_cfg.resolution == 8 and len(tgen.noise) == len(jgen.noise) == 3
    for a, b in zip(tgen.noise, jgen.noise):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    X = np.random.default_rng(2).normal(size=(8, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jgen.eval_population)(jnp.asarray(X), jgen.bundle))
    got = N(tgen.eval_population(T(X)))
    assert got.shape == (8, 2) and np.isfinite(got).all()
    for j in range(2):
        assert_close_scaled(got[:, j], want[:, j], 1e-4)
