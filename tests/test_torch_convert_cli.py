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
    src["vgg16"], src["lpips-linear"] = str(root / "vgg16.pth"), str(root / "vgg.pth")
    src["inception"] = str(root / "pt_inception.pth")
    synthesize.write_vgg16(src["vgg16"], div=8, seed=8)
    synthesize.write_lpips_linear(src["lpips-linear"], div=8, seed=9)
    synthesize.write_inception(src["inception"], seed=10)
    return src


# kind (the CLI's), source, destination (a file for the one-tree kinds)
CASES = {
    "clip-vit": ("clip", "clip.npz", []),
    "clip-rn": ("clip", "clip_rn.npz", []),
    "gpt2": ("gpt2", "gpt2.npz", []),
    "biggan": ("biggan", "biggan.npz", ["--model-name", "auto"]),
    "stylegan2": ("stylegan2", "out", []),
    "stylegan2-tf": ("stylegan2-tf", "out", []),
    "vgg16": ("lpips", "lpips.npz", ["--linear", "lpips-linear"]),
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
    # a source named in `extra` (the lpips kind's --linear file)
    extra = [sources.get(e, e) for e in extra]
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
def test_metric_kinds_exit_2_naming_their_item(kind, sources, capsys):
    """The metric kinds are ported (ROADMAP item 15a); what they cannot
    convert exits 2 naming the item missing: the lpips kind without its
    --linear file, the inception kind on a file that is not an InceptionV3
    state dict (here the vgg16 one)."""
    args = {"lpips": ["lpips", sources["vgg16"], "b.npz"],
            "inception": ["inception", sources["vgg16"], "b.npz"]}[kind]
    with pytest.raises(SystemExit) as e:
        convert_weights.main(args)
    want = {"lpips": "--linear", "inception": "Conv2d_1a_3x3"}[kind]
    assert e.value.code == 2 and want in capsys.readouterr().err


def test_inception_kind_writes_the_jax_converters_tree(sources, tmp_path, monkeypatch):
    """The inception kind's npz holds, key for key and bitwise, the JAX
    package's `convert_torch_inception` of the same pt_inception file (real
    geometry). In-process: the JAX converter walks the structure of its
    `init`, which is jitted here (eager, it draws 22M values op by op)."""
    from clip_glass_tpu.core import pytree as jpytree
    from clip_glass_tpu.metrics import inception as jinc

    monkeypatch.setattr(jinc, "init", jax.jit(jinc.init))
    want = jpytree.flatten(jax.tree.map(np.asarray, jinc.convert_torch_inception(
        torch.load(sources["inception"], weights_only=False))))
    dst = str(tmp_path / "inception.npz")
    assert convert_weights.main(["inception", sources["inception"], dst]) == 0
    with np.load(dst) as got:
        assert sorted(got.files) == sorted(want)
        for k in got.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_metric_npz_load_into_the_metrics(sources, tmp_path):
    """What the lpips and inception kinds write loads through the metrics'
    `load_npz` into the trees their forwards read: OIHW convs, LPIPS's heads
    a list, Inception's BN folded (scale = gamma / sqrt(var + 1e-3))."""
    from clip_glass_torch.metrics import inception, lpips

    assert convert_weights.main(["lpips", sources["vgg16"], str(tmp_path / "l.npz"),
                                 "--linear", sources["lpips-linear"]]) == 0
    assert convert_weights.main(["inception", sources["inception"],
                                 str(tmp_path / "i.npz")]) == 0
    lp = lpips.load_npz(str(tmp_path / "l.npz"))
    sd = torch.load(sources["vgg16"])
    assert torch.equal(lp["convs"]["28"]["w"], sd["features.28.weight"])
    assert [h.shape[0] for h in lp["heads"]] == [c // 8 for c in lpips._SLICE_OUT]
    inc = inception.load_npz(str(tmp_path / "i.npz"))
    sd = torch.load(sources["inception"])
    p = inc["Mixed_6e"]["branch7x7_2"]
    assert torch.equal(p["w"], sd["Mixed_6e.branch7x7_2.conv.weight"])
    scale = sd["Mixed_6e.branch7x7_2.bn.weight"] / torch.sqrt(
        sd["Mixed_6e.branch7x7_2.bn.running_var"] + 1e-3)
    torch.testing.assert_close(p["bn_scale"], scale, rtol=1e-6, atol=0)
    x = torch.rand(1, 3, 48, 48, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(lpips.lpips(lp, x, x.flip(-1))).all()


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
