"""The port's CLI (`run_torch.py`, clip_glass_torch.cli) on the CPU.

- End to end with --tiny --device cpu for the NSGA-II (`_d`) and the GA
  (`_nod`) configs: the reference artifact set that tests/test_cli.py
  expects of the JAX CLI, plus the periodic dump and `ga_state.npz`.
- Resume: 2 generations and `--resume` to 4 equal 4 uninterrupted, bitwise
  (the whole `ga_state.npz`, the result pickle and the latents); also with
  --quantize int8, whose resumed run recalibrates from the seed.
- `_final_artifacts` of both packages from the same final population and
  the same weights (fp32): `genetic_result` and `ls_result.npz` equal, the
  same decision row, and the rendered `output.jpg` image (before JPEG) at
  rtol = atol = 1e-4, the tolerance of tests/test_torch_fitness.py.
- GPT2 (img2txt): the `.txt` artifact set, int32 token ids in ls_result,
  bit-exact resume, and with tied fitness (an overflowed batch) the JAX
  CLI's order of ls_result.npz and of the periodic dump (numpy's default
  argsort on the host), at pop 100.
- Every flag and config the port does not run exits 2 naming its ROADMAP
  item; without --device cpu and without a card the CLI raises.
"""

import dataclasses
import os
import pickle
import socket

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
from clip_glass_torch.parallel import distributed as dist
from clip_glass_torch.weights import from_jax

from torch_parity import T

CONFIGS = {"StyleGAN2_ffhq_d": 2, "StyleGAN2_ffhq_nod": 1}
ARTIFACTS = {"genetic-it-2.jpg", "genetic-it-final.jpg", "genetic_result",
             "ls_result.npz", "output.jpg", "ga_state.npz"}
POP = 8
DOG = os.path.join(os.path.dirname(__file__), "..", "examples", "gpt2_images", "dog.jpeg")
GPT2_ARTIFACTS = {"genetic-it-2.txt", "genetic-it-final.txt", "genetic_result",
                  "ls_result.npz", "output.txt", "ga_state.npz"}


def _run(folder, config, generations, *extra):
    target = DOG if config == "GPT2" else "a red flower"
    argv = ["--config", config, "--target", target,
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
        order = np.argsort(state["F"][:, 0])
        np.testing.assert_array_equal(ls["z"], state["X"][order])
        np.testing.assert_array_equal(res["X"], ls["z"][0])
    # a grid of 8 16 px images in one row, 2 px padding; one 16 px image
    assert Image.open(tmp_path / "genetic-it-2.jpg").size == (2 + 8 * 18, 20)
    assert Image.open(tmp_path / "output.jpg").size == (16, 16)


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["DeepMindBigGAN512", "GPT2"])
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


@pytest.mark.parametrize("config", ["StyleGAN2_ffhq_d", "DeepMindBigGAN512"])
def test_cli_int8_resume_is_bit_exact(tmp_path, monkeypatch, config):
    """--quantize int8 with every TINY conv a call site (quantize_min_ch = 1;
    BigGAN's in its s2d mid segments): 2 generations, then --resume to 4,
    against 4 uninterrupted, bitwise (the resumed run recalibrates from the
    seed); the int8 search is not the float one."""
    tinyfy = cli._tinyfy

    def tiny_int8(config):
        config, clip_cfg, model_cfg = tinyfy(config)
        if config.model == "biggan":
            model_cfg = dataclasses.replace(model_cfg, s2d_min_res=4)
        return config.replace(quantize_min_ch=1), clip_cfg, model_cfg

    monkeypatch.setattr(cli, "_tinyfy", tiny_int8)
    a, b, f = tmp_path / "a", tmp_path / "b", tmp_path / "f"
    _run(a, config, 2, "--quantize", "int8")
    _run(a, config, 4, "--quantize", "int8", "--resume")
    _run(b, config, 4, "--quantize", "int8")
    sa, sb = _npz(a / "ga_state.npz"), _npz(b / "ga_state.npz")
    assert sa.keys() == sb.keys() and int(sa["gen"]) == 4
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    for k, v in _result(a).items():
        np.testing.assert_array_equal(v, _result(b)[k])
    _run(f, config, 4)
    assert not np.array_equal(_npz(f / "ga_state.npz")["F"], sa["F"])


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
    # item 12 is ported: serve mode, --slots and --search-microbatch (which
    # ask for nothing without their mode) and several --target now run
    pytest.param(["--serve", "targets.txt"], None, id="serve_targets.txt-item 12"),
    pytest.param(["--slots", "8"], None, id="slots_8-item 12"),
    pytest.param(["--search-microbatch", "2"], None, id="search-microbatch_2-item 12"),
    pytest.param(["--target", "a", "--target", "b"], None, id="target_a_--target_b-item 12"),
    # item 13 is ported: the int8 fitness runs (a no-op at TINY's widths,
    # below quantize_min_ch = 64, as in the JAX CLI)
    pytest.param(["--quantize", "int8"], None, id="quantize_int8-item 13"),
    # item 16 is ported: --mesh splits the evaluation over the mesh (one CPU
    # here); --distributed auto joins torchrun's group (one rank here, set
    # up by the test)
    pytest.param(["--mesh"], None, id="mesh-item 16"),
    pytest.param(["--distributed", "auto"], None, id="distributed_auto-item 16"),
    # item 9 is ported: these two configs now run (why = None)
    pytest.param(["--config", "DeepMindBigGAN512"], None, id="config_DeepMindBigGAN512-item 9"),
    pytest.param(["--config", "DeepMindBigGAN256"], None, id="config_DeepMindBigGAN256-item 9"),
    # item 10 is ported: GPT2 runs and writes the .txt artifact set
    pytest.param(["--config", "GPT2", "--target", DOG], None, id="config_GPT2-item 10"),
    (["--config", "StyleGAN3"], "unknown"),
], ids=lambda v: v if isinstance(v, str) else "_".join(v).lstrip("-"))
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, monkeypatch, argv, why):
    """Exit 2 naming the ROADMAP item, or, for the flags and configs of a
    ported item, a one-generation run that writes the artifact set: serve
    mode one `request-NNNN/` folder per line of the file, several --target
    one `search-NN/` folder per target and the batch's ga_state.npz."""
    base = ["--config", "StyleGAN2_ffhq_d", "--tiny", "--device", "cpu",
            "--tmp-folder", str(tmp_path)]
    if why is None:
        monkeypatch.chdir(tmp_path)
        if argv[0] == "--serve":
            (tmp_path / argv[1]).write_text("a red flower\na blue car\n")
        if argv[0] == "--distributed":
            for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                             RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
                monkeypatch.setenv(k, v)
        try:
            assert cli.main([*base, "--generations", "1", "--save-each", "1",
                             "--no-verbose", *argv]) == 0
        finally:
            dist.shutdown()
        config = argv[1] if argv[0] == "--config" else "StyleGAN2_ffhq_d"
        want = GPT2_ARTIFACTS if config == "GPT2" else ARTIFACTS
        want = {a for a in want if "-it-2." not in a}
        want |= {"F.jpg"} if config.endswith("_d") else set()
        if argv[0] == "--serve":   # the result artifacts, no dumps, no state
            final = {"F.jpg", "genetic_result", "ls_result.npz", "output.jpg"}
            assert set(os.listdir(tmp_path)) == {argv[1], "request-0000", "request-0001"}
            for i, target in enumerate(["a red flower", "a blue car"]):
                folder = tmp_path / f"request-{i:04d}"
                assert set(os.listdir(folder)) == final | {"target.txt"}
                assert (folder / "target.txt").read_text() == target
            return
        if argv.count("--target") > 1:
            assert set(os.listdir(tmp_path)) == {"ga_state.npz", "search-00", "search-01"}
            for i, target in enumerate(["a", "b"]):
                folder = tmp_path / f"search-{i:02d}"
                assert set(os.listdir(folder)) == (want - {"ga_state.npz"}) | {"target.txt"}
                assert (folder / "target.txt").read_text() == target
            assert _npz(tmp_path / "ga_state.npz")["X"].shape == (2, 16, 32)
        else:
            assert set(os.listdir(tmp_path)) == want
        assert str(_npz(tmp_path / "ga_state.npz")["config"]) == config
        return
    with pytest.raises(SystemExit) as e:
        cli.main([*base, *argv])
    assert e.value.code == 2
    assert why in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("argv,why", [
    (["--serve", "targets.txt"], "--serve is one process"),
    (["--config", "GPT2", "--target", DOG], "GPT2's host round trip"),
], ids=["serve", "gpt2"])
def test_cli_refuses_under_a_process_group(tmp_path, capsys, monkeypatch, argv, why):
    """Under a process group of several ranks --serve and GPT2's host round
    trip exit 2, as the JAX CLI's (cli.py:366-371, 395-398); the group is
    stood in for here (the two-process runs: tests/test_torch_parallel.py)."""
    monkeypatch.setattr(dist, "initialize", lambda *a, **k: True)
    monkeypatch.setattr(dist, "active", lambda: True)
    (tmp_path / "targets.txt").write_text("a red flower\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--tiny", "--device", "cpu", "--tmp-folder", str(tmp_path / "out"), *argv])
    assert e.value.code == 2 and why in capsys.readouterr().err


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


# ------------------------------------------------------------ BigGAN


def test_cli_default_config_is_biggan512(tmp_path):
    """No --config: DeepMindBigGAN512 (the reference's default) with the
    TINY BigGAN, the GA's artifact set; ls_result holds z (clipped) and the
    class vector (the softmax of the class genes), sorted by fitness."""
    from PIL import Image

    assert cli.main(["--tiny", "--device", "cpu", "--generations", "2", "--save-each", "1",
                     "--tmp-folder", str(tmp_path), "--no-verbose"]) == 0
    assert set(os.listdir(tmp_path)) == {
        "genetic-it-1.jpg", "genetic-it-final.jpg", "genetic_result", "ls_result.npz",
        "output.jpg", "ga_state.npz"}
    state = _npz(tmp_path / "ga_state.npz")
    assert str(state["config"]) == "DeepMindBigGAN512" and int(state["gen"]) == 2
    X = state["X"][np.argsort(state["F"][:, 0])]
    assert X.shape == (32, 26)   # DeepMindBigGAN512's pop; the TINY genome, 16 + 10
    ls = _npz(tmp_path / "ls_result.npz")
    assert set(ls) == {"z", "class_labels"}
    np.testing.assert_array_equal(ls["z"], np.clip(X[:, :16], -2, 2))
    e = np.exp(X[:, 16:] - X[:, 16:].max(1, keepdims=True))
    np.testing.assert_allclose(ls["class_labels"], e / e.sum(1, keepdims=True), rtol=1e-6)
    res = _result(tmp_path)
    assert res["X"].shape == (26,) and res["F"].shape == (1,)
    assert Image.open(tmp_path / "output.jpg").size == (8, 8)


def test_cli_biggan_npz_weights_give_the_same_search(tmp_path, monkeypatch):
    """A converted npz + _cfg.json of the same seeded tree that random:0
    draws (bg.init_tree from a generator seeded 0) gives a bitwise-equal
    search: the whole ga_state.npz, the result and the latents."""
    import dataclasses
    import json

    from clip_glass_torch.core import pytree
    from clip_glass_torch.models.biggan import model as tbg

    w = tmp_path / "w"
    pytree.save_npz(str(w / "G.npz"), tbg.init_tree(torch.Generator().manual_seed(0), tbg.TINY))
    with open(w / "G_cfg.json", "w") as f:
        json.dump(dataclasses.asdict(tbg.TINY), f)
    argv = ["--config", "DeepMindBigGAN256", "--tiny", "--device", "cpu", "--generations",
            "2", "--save-each", "2", "--no-verbose", "--pop-size", str(POP)]
    assert cli.main([*argv, "--tmp-folder", str(tmp_path / "a")]) == 0
    tinyfy = cli._tinyfy
    # --tiny draws random:0; keep the TINY sizes and read the npz instead
    monkeypatch.setattr(cli, "_tinyfy", lambda c: (tinyfy(c)[0].replace(
        weights=str(w / "G.npz")), *tinyfy(c)[1:]))
    assert cli.main([*argv, "--tmp-folder", str(tmp_path / "b")]) == 0
    a, b = tmp_path / "a", tmp_path / "b"
    for load in (lambda d: _npz(d / "ga_state.npz"), _result,
                 lambda d: _npz(d / "ls_result.npz")):
        got, want = load(b), load(a)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_final_artifacts_match_jax_biggan(tmp_path):
    """`_final_artifacts` of both packages for the TINY DeepMindBigGAN512
    GA from the same final population and weights: genetic_result equal,
    ls_result's z equal and class_labels at rtol 1e-6 (two softmaxes), the
    rendered output at the fitness tests' 1e-4."""
    from clip_glass_tpu.models.biggan import model as jbg

    from clip_glass_torch.models.biggan import model as tbg

    kw = dict(pop_size=POP, dim_z=16, num_classes=10, n_var=26, resolution=8,
              weights="random:0", target="a red flower", compute_dtype="float32")
    jcfg = jget_config("DeepMindBigGAN512").replace(**kw)
    tcfg = get_config("DeepMindBigGAN512").replace(**kw)
    jprob = JProblem(jcfg, clip_cfg=jclip.TINY, model_cfg=jbg.TINY)
    tprob = GenerationProblem(
        tcfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tbg.TINY,
        bundle=from_jax.convert_bundle(jax.tree.map(np.asarray, jprob.generator.bundle)))
    rng = np.random.default_rng(8)
    pop_X = np.concatenate([rng.normal(size=(POP, 16)), rng.uniform(size=(POP, 10)) < 0.3],
                           1).astype(np.float32)
    pop_F = rng.normal(size=(POP, 1)).astype(np.float32)
    rendered = {}
    jprob.generator.save = lambda g, path: rendered.setdefault("jax", np.asarray(g))
    generate = tprob.generator.generate
    tprob.generator.generate = lambda X: rendered.setdefault("port", generate(X))
    tprob.generator.save = lambda u8, path: None
    fj, ft = tmp_path / "jax", tmp_path / "port"
    fj.mkdir(), ft.mkdir()
    gen_fn = jax.jit(lambda X, ctx: jprob.generator.generate(X, ctx))
    jcli._final_artifacts(jprob, jcfg, jextract(pop_X, pop_F, "ga", None), str(fj), gen_fn)
    cli._final_artifacts(tprob, tcfg, extract_result(T(pop_X), T(pop_F), "ga", None), str(ft))
    rj, rt = _result(fj), _result(ft)
    for k in rj:
        np.testing.assert_array_equal(rt[k], rj[k])
    lj, lt = _npz(fj / "ls_result.npz"), _npz(ft / "ls_result.npz")
    assert lj.keys() == lt.keys() == {"z", "class_labels"}
    np.testing.assert_array_equal(lt["z"], lj["z"])
    np.testing.assert_allclose(lt["class_labels"], lj["class_labels"], rtol=1e-6, atol=1e-7)
    assert rendered["port"].shape == rendered["jax"].shape == (1, 3, 8, 8)
    np.testing.assert_allclose(rendered["port"].numpy(), rendered["jax"], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ GPT-2 img2txt


def test_cli_gpt2_txt_artifacts(tmp_path):
    """GPT2 --tiny: the .txt artifact set; the captions start with the init
    text and have at most 50 characters; ls_result holds the int32 ids of
    the population sorted by fitness; output.txt is the best row's caption."""
    _run(tmp_path, "GPT2", 4)
    assert set(os.listdir(tmp_path)) == GPT2_ARTIFACTS
    state = _npz(tmp_path / "ga_state.npz")
    assert state["X"].shape == (POP, 6) and np.array_equal(state["X"], np.round(state["X"]))
    for name in ("genetic-it-2.txt", "genetic-it-final.txt"):
        lines = (tmp_path / name).read_text().split("\n")
        assert len(lines) == POP
        assert all(t.startswith("the picture of") and len(t) <= 50 for t in lines)
    ls = _npz(tmp_path / "ls_result.npz")
    assert ls["z"].dtype == np.int32
    np.testing.assert_array_equal(ls["z"], state["X"][np.argsort(state["F"][:, 0])])
    out = (tmp_path / "output.txt").read_text()
    assert "\n" not in out and out.startswith("the picture of")
    res = _result(tmp_path)
    assert res["X"].shape == (6,) and res["F"].shape == (1,)


def _tied_F(n):
    """A GA population's fitness after an overflowed generation: most rows
    tied at 0, every 7th from a generation that scored."""
    F = np.zeros((n, 1), np.float32)
    F[::7, 0] = -0.125
    assert not np.array_equal(np.argsort(F[:, 0]), np.argsort(F[:, 0], kind="stable"))
    return F


def test_tie_order_matches_the_jax_cli(tmp_path, monkeypatch):
    """Tied fitness at n = 100 (GPT2's population): `_final_artifacts` of
    both packages on the same population and weights give the same
    genetic_result, ls_result.npz and output.txt (JAX cli.py:162); and the
    port's periodic dump renders the population in the JAX CLI's dump order
    (cli.py:390: np.argsort of the host F), which a stable sort would not."""
    from clip_glass_tpu.models.gpt2 import model as jg2

    from clip_glass_torch.fitness.generator import Generator
    from clip_glass_torch.models.gpt2 import model as tg2

    n = 100
    kw = dict(pop_size=n, dim_z=6, n_var=6, max_tokens_len=5, weights="random:0",
              target=DOG, compute_dtype="float32")
    jcfg, tcfg = jget_config("GPT2").replace(**kw), get_config("GPT2").replace(**kw)
    jprob = JProblem(jcfg, clip_cfg=jclip.TINY, model_cfg=jg2.TINY)
    tprob = GenerationProblem(
        tcfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tg2.TINY,
        bundle=from_jax.convert_bundle(jax.tree.map(np.asarray, jprob.generator.bundle)))
    rng = np.random.default_rng(9)
    pop_X = rng.integers(0, 50257, (n, 6)).astype(np.float32)
    pop_F = _tied_F(n)
    fj, ft = tmp_path / "jax", tmp_path / "port"
    fj.mkdir(), ft.mkdir()
    gen_fn = jax.jit(lambda X, ctx: jprob.generator.generate(X, ctx))
    jcli._final_artifacts(jprob, jcfg, jextract(pop_X, pop_F, "ga", None), str(fj), gen_fn)
    cli._final_artifacts(tprob, tcfg, extract_result(T(pop_X), T(pop_F), "ga", None), str(ft))
    rj, rt = _result(fj), _result(ft)
    for k in rj:
        np.testing.assert_array_equal(rt[k], rj[k])
    np.testing.assert_array_equal(_npz(ft / "ls_result.npz")["z"],
                                  _npz(fj / "ls_result.npz")["z"])
    assert (ft / "output.txt").read_text() == (fj / "output.txt").read_text()

    # the dump: the search hands its callback the initial population, whose
    # every evaluation ties as above (a search's own survivors come sorted);
    # record what gets rendered
    from clip_glass_torch.evolve import algorithm as talg

    def search(algorithm, n_gen, generator, callback, save_each, verbose, state):
        state = talg.GAState(state.X, state.F, n_gen)
        callback(state)
        return talg.extract_result(state.X.cpu(), state.F.cpu(), "ga", state)

    monkeypatch.setattr(talg, "minimize", search)
    monkeypatch.setattr(Generator, "eval_population",
                        lambda self, X, bundle=None: torch.from_numpy(_tied_F(X.shape[0])))
    rendered = []
    render = Generator.render
    monkeypatch.setattr(Generator, "render",
                        lambda self, X: rendered.append(X.numpy().copy()) or render(self, X))
    folder = tmp_path / "run"
    assert cli.main(["--config", "GPT2", "--target", DOG, "--tiny", "--device", "cpu",
                     "--pop-size", str(n), "--generations", "1", "--save-each", "1",
                     "--tmp-folder", str(folder), "--no-verbose"]) == 0
    state = _npz(folder / "ga_state.npz")
    np.testing.assert_array_equal(state["F"], _tied_F(n))
    np.testing.assert_array_equal(rendered[0], state["X"][np.argsort(state["F"][:, 0])])
