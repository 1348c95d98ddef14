"""The port's CLI (`run_torch.py`, clip_glass_torch.cli) on the CPU.

- End to end with --tiny --device cpu for the NSGA-II (`_d`) and the GA
  (`_nod`) configs: the reference artifact set that tests/test_cli.py
  expects of the JAX CLI, plus the periodic dump and `ga_state.npz`.
- Resume: 2 generations and `--resume` to 4 equal 4 uninterrupted, bitwise
  (the whole `ga_state.npz`, the result pickle and the latents).
- `_final_artifacts` of both packages from the same final population and
  the same weights (fp32): `genetic_result` and `ls_result.npz` equal, the
  same decision row, and the rendered `output.jpg` image (before JPEG) at
  rtol = atol = 1e-4, the tolerance of tests/test_torch_fitness.py.
- Every flag and config the port does not run exits 2 naming its ROADMAP
  item; without --device cpu and without a card the CLI raises.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu import cli as jcli
from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.core import checkpoint as jcheckpoint
from clip_glass_tpu.evolve.algorithm import GAState as JState
from clip_glass_tpu.evolve.algorithm import extract_result as jextract
from clip_glass_tpu.fitness.generator import _quantize_u8 as jquantize
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch import cli
from clip_glass_torch.config import get_config
from clip_glass_torch.evolve.algorithm import extract_result
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.weights import from_jax

from torch_parity import T

CONFIGS = {"StyleGAN2_ffhq_d": 2, "StyleGAN2_ffhq_nod": 1}
ARTIFACTS = {"genetic-it-2.jpg", "genetic-it-final.jpg", "genetic_result",
             "ls_result.npz", "output.jpg", "ga_state.npz"}
POP = 8


def _run(folder, config, generations, *extra):
    argv = ["--config", config, "--target", "a red flower",
            "--generations", str(generations), "--save-each", "2",
            "--tmp-folder", str(folder), "--tiny", "--pop-size", str(POP),
            "--device", "cpu", *extra]
    assert cli.main(argv) == 0


def _result(folder):
    with open(os.path.join(folder, "genetic_result"), "rb") as f:
        return pickle.load(f)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cli_tiny_end_to_end(tmp_path, config):
    """The artifact set, and with --profile a Chrome trace of the search."""
    import json

    from PIL import Image

    trace = tmp_path.parent / f"{tmp_path.name}_trace"
    _run(tmp_path, config, 4, "--profile", str(trace))
    with open(trace / "trace.json") as f:
        assert any(e.get("name", "").startswith("aten::")
                   for e in json.load(f)["traceEvents"])
    n_obj = CONFIGS[config]
    assert set(os.listdir(tmp_path)) == ARTIFACTS | ({"F.jpg"} if n_obj == 2 else set())
    res = _result(tmp_path)
    assert set(res) == {"X", "F", "G", "CV"}
    state = _npz(tmp_path / "ga_state.npz")
    assert int(state["gen"]) == 4 and str(state["rng_device"]) == "cpu"
    ls = _npz(tmp_path / "ls_result.npz")
    assert ls["z"].shape == (POP, 32)
    if n_obj == 2:
        assert np.atleast_2d(res["F"]).shape[1] == 2
        np.testing.assert_array_equal(ls["z"], state["X"])
    else:  # the single best row; the latents sorted by fitness
        assert res["X"].shape == (32,) and res["F"].shape == (1,)
        order = np.argsort(state["F"][:, 0], kind="stable")
        np.testing.assert_array_equal(ls["z"], state["X"][order])
        np.testing.assert_array_equal(res["X"], ls["z"][0])
    # a grid of 8 16 px images in one row, 2 px padding; one 16 px image
    assert Image.open(tmp_path / "genetic-it-2.jpg").size == (2 + 8 * 18, 20)
    assert Image.open(tmp_path / "output.jpg").size == (16, 16)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cli_resume_is_bit_exact(tmp_path, config, capsys):
    """2 generations, then --resume to 4, against 4 uninterrupted."""
    a, b = tmp_path / "a", tmp_path / "b"
    _run(a, config, 2, "--resume")
    assert "no checkpoint found; starting fresh" in capsys.readouterr().out
    _run(a, config, 4, "--resume")
    _run(b, config, 4)
    sa, sb = _npz(a / "ga_state.npz"), _npz(b / "ga_state.npz")
    assert sa.keys() == sb.keys() and int(sa["gen"]) == 4
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    ra, rb = _result(a), _result(b)
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])
    np.testing.assert_array_equal(_npz(a / "ls_result.npz")["z"],
                                  _npz(b / "ls_result.npz")["z"])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_final_artifacts_match_jax(tmp_path, config):
    n_obj = CONFIGS[config]
    kw = dict(pop_size=POP, dim_z=32, n_var=32, weights="random:0",
              target="a red flower", compute_dtype="float32")
    jcfg = jget_config(config).replace(**kw)
    tcfg = get_config(config).replace(**kw)
    jprob = JProblem(jcfg, clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
    # ToRGB weights / 100: random weights saturate ~all pixels at 0 or 1,
    # where the image comparison would test nothing
    jprob.generator.g_params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf * 0.01 if jax.tree_util.keystr(path).startswith(
            "['synthesis']['to_rgb']") and jax.tree_util.keystr(path).endswith("['w']")
        else leaf, jprob.generator.g_params)
    tprob = GenerationProblem(
        tcfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
        bundle=from_jax.convert_bundle(jax.tree.map(np.asarray, jprob.generator.bundle)))
    rng = np.random.default_rng(7)
    pop_X = rng.normal(size=(POP, 32)).astype(np.float32)
    pop_F = rng.normal(size=(POP, n_obj)).astype(np.float32)
    pop_F[2, 0] = pop_F[6, 0] = pop_F[:, 0].min() - 0.5  # a tie for the best
    rendered = {}
    jprob.generator.save = lambda g, path: rendered.setdefault("jax", np.asarray(g))
    generate = tprob.generator.generate

    def tgenerate(X, *a):  # the port quantizes before save: hold the render
        g = generate(X, *a)
        rendered["port"] = g.numpy()
        return g

    tprob.generator.generate = tgenerate
    tprob.generator.save = lambda u8, path: rendered.setdefault("port_u8", u8)
    fj, ft = tmp_path / "jax", tmp_path / "port"
    fj.mkdir(), ft.mkdir()
    gen_fn = jax.jit(lambda X, ctx: jprob.generator.generate(X, ctx))
    jcli._final_artifacts(jprob, jcfg, jextract(pop_X, pop_F, jcfg.algorithm, None),
                          str(fj), gen_fn)
    cli._final_artifacts(tprob, tcfg, extract_result(T(pop_X), T(pop_F), tcfg.algorithm,
                                                     None), str(ft))
    rj, rt = _result(fj), _result(ft)
    assert rj.keys() == rt.keys()
    for k in rj:
        assert np.asarray(rj[k]).shape == rt[k].shape, k
        np.testing.assert_array_equal(rt[k], rj[k])
    np.testing.assert_array_equal(_npz(ft / "ls_result.npz")["z"],
                                  _npz(fj / "ls_result.npz")["z"])
    assert (ft / "F.jpg").exists() == (fj / "F.jpg").exists() == (n_obj == 2)
    assert rendered["port"].shape == rendered["jax"].shape == (1, 3, 16, 16)
    assert 0 < rendered["port"].min() and rendered["port"].max() < 1
    np.testing.assert_allclose(rendered["port"], rendered["jax"], rtol=1e-4, atol=1e-4)
    assert rendered["port_u8"].dtype == np.uint8
    np.testing.assert_array_equal(rendered["port_u8"],
                                  np.asarray(jquantize(jnp.asarray(rendered["port"]))))


def test_dump_quantize_and_grid_match_jax(tmp_path, rng):
    """quantize_u8 against the JAX package's _quantize_u8 (equal), and the
    uint8 grid written by both packages' save_grid (the same JPEG bytes)."""
    from clip_glass_tpu.utils.image import save_grid as jsave_grid

    from clip_glass_torch.fitness.generator import quantize_u8
    from clip_glass_torch.utils.image import save_grid

    x = rng.uniform(-0.1, 1.1, size=(5, 3, 12, 10)).astype(np.float32)
    x[0, 0, 0, :4] = [0.0, 1.0, 0.5 / 255, 254.5 / 255]
    u8 = quantize_u8(T(x)).numpy()
    np.testing.assert_array_equal(u8, np.asarray(jquantize(jnp.asarray(x))))
    for n in (5, 1):
        save_grid(u8[:n], str(tmp_path / f"t{n}.jpg"))
        jsave_grid(u8[:n], str(tmp_path / f"j{n}.jpg"))
        assert (tmp_path / f"t{n}.jpg").read_bytes() == (tmp_path / f"j{n}.jpg").read_bytes()


def test_generation_meter_and_timer():
    from clip_glass_torch.core.profiling import GenerationMeter, Timer

    meter = GenerationMeter(pop_size=16)
    meter.set_generation(4, rebaseline=True)
    assert meter.generation == 4 and meter.gens_per_sec == 0.0
    with Timer() as t:
        meter.set_generation(6)
    assert meter.generation == 6 and t.seconds > 0
    assert meter.gens_per_sec > 0 and meter.candidates_per_sec > 0


def test_scatter_without_matplotlib(tmp_path):
    """F.jpg is Pillow's drawing: red points on axes."""
    from PIL import Image

    from clip_glass_torch.utils.plotting import save_scatter

    F = np.array([[-0.3, 0.0], [-0.2, 0.5], [-0.1, 2.0]])
    save_scatter(F, str(tmp_path / "F.jpg"))
    img = np.asarray(Image.open(tmp_path / "F.jpg").convert("RGB"))
    assert img.shape == (480, 480, 3)
    red = (img[..., 0] > 150) & (img[..., 1] < 120) & (img[..., 2] < 120)
    assert red.sum() >= 3 * 20  # three points of 7 px across


@pytest.mark.parametrize("argv,why", [
    (["--serve", "targets.txt"], "item 12"),
    (["--slots", "8"], "item 12"),
    (["--search-microbatch", "2"], "item 12"),
    (["--target", "a", "--target", "b"], "item 12"),
    (["--quantize", "int8"], "item 13"),
    (["--mesh"], "item 16"),
    (["--distributed", "auto"], "item 16"),
    (["--config", "DeepMindBigGAN512"], "item 9"),
    (["--config", "DeepMindBigGAN256"], "item 9"),
    (["--config", "GPT2"], "item 10"),
    (["--config", "StyleGAN3"], "unknown"),
], ids=lambda v: v if isinstance(v, str) else "_".join(v).lstrip("-"))
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, argv, why):
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", "StyleGAN2_ffhq_d", "--tiny", "--device", "cpu",
                  "--tmp-folder", str(tmp_path), *argv])
    assert e.value.code == 2
    assert why in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_cli_resume_refuses_a_jax_checkpoint(tmp_path, capsys):
    js = JState(X=jnp.zeros((POP, 32)), F=jnp.zeros((POP, 2)),
                key=jax.random.PRNGKey(0), gen=jnp.int32(2))
    jcheckpoint.save_state(js, str(tmp_path), "StyleGAN2_ffhq_d")
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, "StyleGAN2_ffhq_d", 4, "--resume")
    assert e.value.code == 2 and "JAX PRNG key" in capsys.readouterr().err


@pytest.mark.parametrize("config,extra,why", [
    ("StyleGAN2_ffhq_nod", (), "written by a StyleGAN2_ffhq_d search"),
    ("StyleGAN2_car_d", (), "written by a StyleGAN2_ffhq_d search"),
    ("StyleGAN2_ffhq_d", ("--pop-size", str(POP // 2)), "do not fit"),
], ids=["ffhq_nod", "car_d", "ffhq_d_pop4"])
def test_cli_resume_refuses_another_configs_checkpoint(tmp_path, capsys, config, extra, why):
    """A StyleGAN2_ffhq_d checkpoint resumes neither another config's search
    (same shapes for car_d) nor one of another population size."""
    _run(tmp_path, "StyleGAN2_ffhq_d", 2)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, config, 4, "--resume", *extra)
    assert e.value.code == 2 and why in capsys.readouterr().err


def test_cli_no_verbose_is_quiet(tmp_path, capsys):
    _run(tmp_path, "StyleGAN2_ffhq_nod", 2, "--no-verbose")
    assert capsys.readouterr().out == ""
    assert (tmp_path / "output.jpg").exists()


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """The default device is the card: no fallback to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "StyleGAN2_ffhq_nod", "--tiny",
                  "--tmp-folder", str(tmp_path)])
    assert not (tmp_path / "ga_state.npz").exists()
