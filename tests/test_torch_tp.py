"""CLIP tensor parallelism on the port's 2-D (pop, model) mesh
(clip_glass_torch/parallel/mesh.py) against the JAX package, on the CPU,
fp32, TINY sizes: the counterparts of tests/test_parallel.py:54 (the image
tower), :106 (the GA step on the 2-D mesh) and :188 (the text tower).

- The towers: the JAX package's unsharded `encode_image` / `encode_text`
  against the port's on a one-process (2, 2) mesh of four host shards and
  on a (1, 2) mesh, the images' rows split over the pop axis and each
  shard's CLIP slice from `shard_clip_tp`, at rtol 1e-5 / atol 1e-6, for
  the TINY towers (2 heads: one a shard) and a narrow 4-head config (two
  heads a shard, which a head-order fault would move).
- The control: the literal copy of the JAX spec, in_proj_weight split on
  its last axis (`P(None, None, "model")`: shard 0 then holds all of q and
  half of k), moves the features far past that tolerance.
- Two NSGA-II generations of TINY StyleGAN2_ffhq_d: the JAX package's
  single-device trajectory against the port's evaluation on the (2, 2)
  mesh and its survival, fed the JAX package's variation (its draws), X
  within 1e-6 and F within rtol 1e-5 / atol 1e-6.
- The fitness on the (2, 2) mesh against the unsharded run (rtol 1e-5 /
  atol 1e-6): `_d` in both domains, `_nod` and the int8 mode.
- Four gloo ranks (tests/torch_parallel_worker.py), one card each, on
  `make_global_mesh(2)`: two model groups of two ranks each, the fitness
  and two generations against the one-process run.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.evolve import algorithm as jalg
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch.core.dtypes import FP32
from clip_glass_torch.evolve.algorithm import minimize
from clip_glass_torch.evolve.survival import nsga2_survival
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.parallel import mesh as pmesh
from clip_glass_torch.parallel import make_mesh, population_sharding
from clip_glass_torch.weights import from_jax

from test_torch_fitness import _perturb
from test_torch_parallel import RUN_TIMEOUT_S, _free_port, search_config_j
from test_torch_parallel import _problem as _sg2_problem
from test_torch_parallel import sg2  # noqa: F401 (a fixture)
from test_torch_training import _repair_dense
from torch_parallel_worker import search_config
from torch_parity import N, T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POP = 8
TOL = dict(rtol=1e-5, atol=1e-6)
# a narrow config with 4 heads in both towers: two heads a shard at tp 2
NARROW4 = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=256,
               vision_patch_size=8, transformer_width=64, transformer_heads=4,
               transformer_layers=2)
MESHES = {"2x2": (["cpu"] * 4, (2, 2)), "1x2": (["cpu"] * 2, (1, 2))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["tiny", "narrow4"])
def towers(request):
    """(name, JAX config, port config, JAX params, port params)."""
    if request.param == "tiny":
        jcfg, tcfg = jclip.TINY, tclip.TINY
    else:
        jcfg = dataclasses.replace(jclip.TINY, **NARROW4)
        tcfg = dataclasses.replace(tclip.TINY, **NARROW4)
    jp = jax.jit(lambda k: jclip.init(k, jcfg))(jax.random.PRNGKey(0))
    return request.param, jcfg, tcfg, jp, from_jax.convert_clip(jax.tree.map(np.asarray, jp))


def _images(n=8):
    return np.random.default_rng(0).uniform(0, 1, (n, 3, 32, 32)).astype(np.float32)


def _ids(n=8):
    ids = np.zeros((n, 77), np.int64)
    ids[:, 0] = 49406
    ids[:, 1] = 42 + np.arange(n)
    ids[:, 2] = 300 + 7 * np.arange(n)
    ids[:, 3] = 49407
    return ids


def _tp_tower(mesh, params, rows, fn, shards=None):
    """fn(the card's CLIP shard, its row block, tp=, reduce=) over the mesh,
    gathered."""
    shards = shards if shards is not None else pmesh.shard_clip_tp(params, mesh)
    sharding = population_sharding(mesh)
    out = mesh.map(lambda i, x: fn(shards[i], x, tp=mesh.tp, reduce=pmesh.model_sum),
                   sharding.split(rows))
    return sharding.gather(out)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_encode_image_tensor_parallel_equals_jax(towers, mesh_name):
    name, jcfg, tcfg, jp, tp = towers
    devices, shape = MESHES[mesh_name]
    mesh = make_mesh(devices, model_axis_size=2)
    assert mesh.shape == shape and mesh.axis_names == ("pop", "model")
    imgs = _images()
    want = np.asarray(jclip.encode_image(jp, jnp.asarray(imgs), jcfg, JFP32))
    got = _tp_tower(mesh, tp, T(imgs),
                    lambda p, x, **kw: tclip.encode_image(p, x, tcfg, FP32, **kw))
    np.testing.assert_allclose(N(got), want, **TOL)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_encode_text_tensor_parallel_equals_jax(towers, mesh_name):
    name, jcfg, tcfg, jp, tp = towers
    mesh = make_mesh(MESHES[mesh_name][0], model_axis_size=2)
    ids = _ids()
    want = np.asarray(jclip.encode_text(jp, jnp.asarray(ids, jnp.int32), jcfg, JFP32))
    got = _tp_tower(mesh, tp, torch.as_tensor(ids),
                    lambda p, t, **kw: tclip.encode_text(p, t, tcfg, FP32, **kw))
    np.testing.assert_allclose(N(got), want, **TOL)


def test_shards_hold_their_slices(towers):
    """Shard j of tp 2: c_fc's and the q/k/v heads' columns, c_proj's and
    out_proj's rows, the output biases whole; the tree has the whole
    one's keys alone, and its towers refuse to run without the group's
    sum."""
    name, jcfg, tcfg, jp, tp = towers
    w = tcfg.vision_width
    s0, s1 = (pmesh.clip_shard(tp, 2, j) for j in range(2))
    b, b0 = tp["visual"]["blocks"][0], s0["visual"]["blocks"][0]
    assert set(s0) == set(tp) and set(s0["visual"]) == set(tp["visual"])
    with pytest.raises(ValueError, match="model group"):
        tclip.encode_image(s0, T(_images()), tcfg, FP32, tp=2)
    assert b0["mlp"]["c_fc_weight"].shape == (w, 2 * w)
    assert b0["mlp"]["c_proj_weight"].shape == (2 * w, w)
    assert b0["attn"]["in_proj_weight"].shape == (w, 3 * w // 2)
    assert b0["attn"]["out_proj_weight"].shape == (w // 2, w)
    assert b0["attn"]["out_proj_bias"] is b["attn"]["out_proj_bias"]
    assert b0["mlp"]["c_proj_bias"] is b["mlp"]["c_proj_bias"]
    q1 = s1["visual"]["blocks"][0]["attn"]["in_proj_weight"][:, :w // 2]
    assert torch.equal(q1, b["attn"]["in_proj_weight"][:, w // 2:w])   # shard 1's q heads
    k0 = b0["attn"]["in_proj_weight"][:, w // 2:w]
    assert torch.equal(k0, b["attn"]["in_proj_weight"][:, w:w + w // 2])  # shard 0's k heads


@pytest.mark.parametrize("tower", ["image", "text"])
def test_literal_in_proj_split_moves_the_features(towers, tower):
    """The control: in_proj_weight / in_proj_bias split on their last axis
    as one block (the literal P(None, None, "model")) instead of by heads."""
    name, jcfg, tcfg, jp, tp = towers
    mesh = make_mesh(["cpu"] * 2, model_axis_size=2)

    def literal(j):
        s = pmesh.clip_shard(tp, 2, j)
        for key in ("visual", "text"):
            for b, whole in zip(s[key]["blocks"], tp[key]["blocks"]):
                for k in ("in_proj_weight", "in_proj_bias"):
                    b["attn"][k] = whole["attn"][k].chunk(2, dim=-1)[j].contiguous()
        return s

    shards = pmesh.ModelShards(literal(j) for j in range(2))
    if tower == "image":
        rows = T(_images())
        fn = lambda p, x, **kw: tclip.encode_image(p, x, tcfg, FP32, **kw)  # noqa: E731
        want = np.asarray(jclip.encode_image(jp, jnp.asarray(_images()), jcfg, JFP32))
    else:
        rows = torch.as_tensor(_ids())
        fn = lambda p, t, **kw: tclip.encode_text(p, t, tcfg, FP32, **kw)  # noqa: E731
        want = np.asarray(jclip.encode_text(jp, jnp.asarray(_ids(), jnp.int32), jcfg, JFP32))
    got = N(_tp_tower(mesh, tp, rows, fn, shards))
    err = np.abs(got - want) - (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert err.max() > 100 * TOL["atol"], err.max()


def test_heads_must_split_over_the_model_axis():
    cfg = dataclasses.replace(tclip.TINY, transformer_heads=3)
    with pytest.raises(ValueError, match="do not split"):
        pmesh.clip_heads_divide(cfg, 2)
    with pytest.raises(RuntimeError, match="inside Mesh.map"):
        pmesh.model_sum(torch.ones(2))


def test_mesh_2d_layout():
    m = make_mesh(["cpu"] * 4, model_axis_size=2)
    assert (m.dp, m.tp, m.shape) == (2, 2, (2, 2))
    assert [m.pop_index(i) for i in range(4)] == [0, 0, 1, 1]
    assert [m.model_index(i) for i in range(4)] == [0, 1, 0, 1]
    assert population_sharding(m).slices(8) == [slice(0, 4), slice(0, 4), slice(4, 8),
                                                 slice(4, 8)]
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(["cpu"] * 3, model_axis_size=2)
    # ranks 2 and 3 of a (2, 2) mesh of one card a rank: the second model group
    r = pmesh.Mesh((torch.device("cpu"),), ("pop", "model"), world=4, rank=3, tp=2)
    assert r.model_spans_ranks and (r.pop_ranks, r.pop_rank) == (2, 1)
    assert population_sharding(r).slices(8) == [slice(4, 8)]


# ------------------------------------------------------------ the GA step

@pytest.fixture(scope="module")
def nsga2():
    """The JAX TINY StyleGAN2_ffhq_d problem on repaired, perturbed weights
    (D's hinge live, as tests/test_torch_parallel.py's), with the port's
    bundle of the same weights."""
    name = "StyleGAN2_ffhq_d"
    jprob = JProblem(search_config_j(name), clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
    jb = dict(jprob.generator.bundle)
    for k in ("g", "d"):
        jb[k] = jax.tree.map(jnp.asarray, _repair_dense(jb[k]))
    jb = _perturb(jb, np.random.default_rng(2))
    return jprob, jb, from_jax.convert_bundle(jax.tree.map(np.asarray, jb))


def test_nsga2_two_generations_on_2d_mesh_equal_jax(nsga2):
    """Two generations: JAX's vary (its draws) on the port's state, the
    port's evaluation on the (2, 2) mesh (CLIP tensor-parallel, G and D on
    each model group's rows, D's minibatch-std gathered over the pop axis)
    and the port's NSGA-II survival, against the JAX package's own
    single-device trajectory."""
    jprob, jb, tb = nsga2
    jev = jax.jit(lambda X: jprob.generator.eval_population(X, jb))
    ops = jalg.operators_for_config(jprob.config)
    vary, survive = jalg.make_step_halves(ops, POP, "nsga2")
    X0 = np.random.default_rng(4).normal(size=(POP, 32)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jalg.GAState(jnp.asarray(X0), jev(jnp.asarray(X0)), key, jnp.int32(0))

    mesh = make_mesh(["cpu"] * 4, model_axis_size=2)
    prob = GenerationProblem(search_config("StyleGAN2_ffhq_d", POP), device="cpu",
                             clip_cfg=tclip.TINY, model_cfg=tsg2.TINY, bundle=tb, mesh=mesh)
    ev = prob.generator.eval_population
    X, F = T(X0), ev(T(X0))
    np.testing.assert_allclose(N(F), np.asarray(want.F), **TOL)
    for _ in range(2):
        off_j, _, k_next = vary(want)
        want = survive(want, off_j, jev(off_j), k_next)
        off, _, _ = vary(jalg.GAState(jnp.asarray(N(X)), jnp.asarray(N(F)), key, jnp.int32(0)))
        X, F = nsga2_survival(torch.cat([X, T(off)]), torch.cat([F, ev(T(off))]), POP)[:2]
        key = k_next
        np.testing.assert_allclose(N(X), np.asarray(want.X), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(N(F), np.asarray(want.F), **TOL)


@pytest.mark.parametrize("case", ["d_plain", "d_s2d", "nod", "d_int8"])
def test_fitness_on_2d_mesh_equals_unsharded(sg2, case):  # noqa: F811
    """The port's fitness on the (2, 2) mesh (CLIP tensor-parallel, G and D
    on each model group's rows) against its unsharded run: both StyleGAN2
    domains, the GA config and the int8 mode (its calibration through the
    CLIP shards, an int8 scope a thread)."""
    name = "StyleGAN2_ffhq_nod" if case == "nod" else "StyleGAN2_ffhq_d"
    model_cfg = dataclasses.replace(tsg2.TINY, s2d_min_res=8) if case == "d_s2d" else tsg2.TINY
    kw = dict(quantize="int8", quantize_min_ch=1) if case == "d_int8" else {}
    X = T(np.random.default_rng(5).normal(size=(POP, 32)).astype(np.float32))
    F = [_sg2_problem(sg2, name, model_cfg=model_cfg, mesh=mesh, **kw)
         .generator.eval_population(X)
         for mesh in (None, make_mesh(["cpu"] * 4, model_axis_size=2))]
    np.testing.assert_allclose(N(F[1]), N(F[0]), **TOL)


# ------------------------------------------------------------ four ranks

def test_four_gloo_ranks_on_make_global_mesh_2(nsga2, tmp_path):
    """Four processes of one card each on make_global_mesh(2): model groups
    {0, 1} and {2, 3} (dist.new_group), pop groups {0, 2} and {1, 3}. Each
    rank's F of one evaluation and its two generations equal the one-process
    run's (tests/test_parallel.py's tolerances; D's hinge live, so its
    minibatch-std gather over the pop axis counts); a run's time limit turns
    a hang into a failure."""
    name, tb = "StyleGAN2_ffhq_d", nsga2[2]
    one = GenerationProblem(search_config(name, POP), device="cpu", clip_cfg=tclip.TINY,
                            model_cfg=tsg2.TINY, bundle=tb)
    X = torch.randn((POP, 32), generator=torch.Generator().manual_seed(3))
    want_F = one.generator.eval_population(X)
    assert (want_F[:, 1] > 0).any()
    inp = tmp_path / "in.pt"
    torch.save({"X": X, "bundles": {name: tb}, "pop": POP, "generations": 2, "seed": 6}, inp)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_worker.py"), "--rank",
         str(r), "--world", "4", "--port", str(port), "--inputs", str(inp), "--out",
         str(tmp_path), "--model-axis", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    res = torch.load(tmp_path / "results.pt", weights_only=False)
    assert res["mesh_shape"] == (2, 2) and res["world"] == 4
    np.testing.assert_allclose(N(res[f"{name}/F"]), N(want_F), **TOL)
    r = minimize(one.make_algorithm(), 2, 6)
    np.testing.assert_allclose(N(res[f"{name}/X_gen"]), N(r.pop_X), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(res[f"{name}/F_gen"]), N(r.pop_F), **TOL)
    # one block a model group: ranks 0 and 2 of the four [2, 3] blocks
    assert torch.equal(res["fetch"], torch.cat([torch.full((2, 3), 0.0),
                                                torch.full((2, 3), 2.0)]))
