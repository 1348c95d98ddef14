"""The port's population sharding and multi-process runs
(clip_glass_torch/parallel) on the CPU, TINY models, fp32: distribution is
scheduling, not semantics.

- One process, a mesh of ["cpu", "cpu"] (two shards on the host, one
  thread each): the sharded fitness, whole GA runs (StyleGAN2 `_d` and
  `_nod`, BigGAN's mixed genome, GPT-2's host round trip), K searches
  batched and the server equal the unsharded run (X 1e-6, F rtol 1e-5,
  atol 1e-6: tests/test_parallel.py's tolerances) and the JAX package's
  fitness on the same weights (1e-4 of each objective's scale,
  tests/test_torch_fitness.py's). The naive split (each half of the
  population evaluated as a population of its own) moves D's hinge far
  past that tolerance: D's minibatch-std groups are strided, so a split
  must gather them (the trap these tests are there to see).
- Two processes in a gloo group (tests/torch_parallel_worker.py, one card
  a rank on the host): the sharded fitness and a GA run, the data-parallel
  trainer (batch 8, TINY, mbstd_group_size 2, so groups span the ranks) and
  the dcp checkpoint; scripts/dryrun_multihost_torch.py's CLI search and
  trainer steps. The trainer's steps are held one at a time: each step of
  the two ranks against the single process's step from the same state
  (the ranks' previous checkpoint) and draws; the logs and pl_avg within
  1e-4, the gradients (Adam's first moment, beta1 = 0) leaf by leaf within
  a relative L2 of 1e-4, the leaves tests/test_training_distributed.py
  holds (mapping dense 0, D's fromRGB) within rtol 1e-4, atol 1e-5. Over
  several steps Adam flips the elements whose gradient is within its
  rounding of zero (an update of +-lr), so a free-running comparison would
  measure that, not the sharding. One step fed the JAX package's draws is
  held against the JAX trainer's step (tests/test_torch_training.py's
  `_check_state`).
Every multi-process run has its own time limit: a hang fails the test.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch import cli
from clip_glass_torch.config import get_config
from clip_glass_torch.core.checkpoint import (load_state, load_state_dcp, save_state,
                                              save_state_dcp)
from clip_glass_torch.evolve.algorithm import GAState, minimize
from clip_glass_torch.evolve.batched import make_batched
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.parallel import distributed as dist
from clip_glass_torch.parallel import mesh as pmesh
from clip_glass_torch.parallel import make_mesh, population_sharding, shard_state
from clip_glass_torch.serving import SearchServer
from clip_glass_torch.training import trainer as ttr
from clip_glass_torch.weights import from_jax

from test_torch_fitness import _perturb, bg_problems, g2_problems  # noqa: F401 (fixtures)
from test_torch_fitness import _bg_config, _bg_X, _g2_config, _g2_X
from test_torch_training import (CFG, _assert_logs, _check_state,  # noqa: F401
                                 _repair_dense, jax_draws, jtrainer, weights)
from torch_parallel_worker import search_config
from torch_parity import N, T, assert_close_scaled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POP = 8
NAMES = ("StyleGAN2_ffhq_d", "StyleGAN2_ffhq_nod")
TINY_S2D = dataclasses.replace(tsg2.TINY, s2d_min_res=8)
# a multi-process run's time limit (each takes about 10 s here)
RUN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the lane runs six test processes on the
    machine's cores, and these TINY computations gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh2():
    return make_mesh(["cpu", "cpu"])


def _same(got_X, got_F, want_X, want_F):
    np.testing.assert_allclose(N(got_X), N(want_X), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(got_F), N(want_F), rtol=1e-5, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ the problems

@pytest.fixture(scope="module")
def sg2():
    """name -> (JAX problem, JAX bundle, port bundle): the TINY StyleGAN2
    problems on weights whose dense layers are repaired (the JAX init's
    fault, ROADMAP §3) and whose biases and noise strengths are drawn, so D's
    hinge is live: on the raw init D's logits are in the thousands and the
    hinge is zero for every candidate."""
    out = {}
    for name in NAMES:
        jprob = JProblem(search_config_j(name), clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
        jb = dict(jprob.generator.bundle)
        for k in ("g", "d"):
            if k in jb:
                jb[k] = jax.tree.map(jnp.asarray, _repair_dense(jb[k]))
        jb = _perturb(jb, np.random.default_rng(2))
        out[name] = (jprob, jb, from_jax.convert_bundle(jax.tree.map(np.asarray, jb)))
    return out


def search_config_j(name):
    return jget_config(name).replace(pop_size=POP, batch_size=4, dim_z=32, n_var=32,
                                     weights="random:0", target="a red flower",
                                     compute_dtype="float32")


def _problem(sg2, name, model_cfg=tsg2.TINY, mesh=None, **kw):
    return GenerationProblem(search_config(name, POP).replace(**kw), device="cpu",
                             clip_cfg=tclip.TINY, model_cfg=model_cfg,
                             bundle=sg2[name][2], mesh=mesh)


def _X(seed=0, n=POP):
    return T(np.random.default_rng(seed).normal(size=(n, 32)).astype(np.float32))


# ------------------------------------------------------------ the mesh

def test_mesh_splits_rows_rank_first():
    m = pmesh.Mesh((torch.device("cpu"),) * 2, ("pop",), world=3, rank=1)
    assert m.size == 6 and m.local_size == 2
    assert population_sharding(m).slices(12) == [slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        population_sharding(m).slices(8)
    with pytest.raises(ValueError, match="not an axis"):
        population_sharding(m, "batch")


def test_make_mesh_devices_and_state():
    m = make_mesh(["cpu", "cpu"], axis="batch")
    assert m.devices == (torch.device("cpu"),) * 2 and m.axis_names == ("batch",)
    assert (m.world, m.rank) == (1, 0)
    s = shard_state(GAState(torch.ones(4, 2), torch.zeros(4, 1), 3), m)
    assert s.gen == 3 and torch.equal(s.X, torch.ones(4, 2))
    with pytest.raises(ValueError, match="must divide"):
        dist.make_global_mesh(model_axis_size=2, devices=["cpu"])
    assert dist.make_global_mesh(devices=["cpu"]).size == 1
    m2 = dist.make_global_mesh(model_axis_size=2, devices=["cpu"] * 4)
    assert m2.axis_names == ("pop", "model") and m2.shape == (2, 2)


def test_gather_rows_meets_in_map():
    m = _mesh2()
    with pytest.raises(RuntimeError, match="inside Mesh.map"):
        pmesh.gather_rows(torch.zeros(2, 1), m)
    blocks = [torch.full((2, 1), float(i)) for i in range(2)]
    got = m.map(lambda i, x: (pmesh.gather_rows(x, m), pmesh.own_rows(
        pmesh.gather_rows(x, m), 2, m)), blocks)
    for i, (full, own) in enumerate(got):
        assert torch.equal(full, torch.cat(blocks)) and torch.equal(own, blocks[i])
    assert pmesh.gather_rows(blocks[0], None) is blocks[0]


def test_map_raises_a_shard_error_and_frees_the_others():
    m = _mesh2()

    def fn(i, x):
        if i == 1:
            raise KeyError("shard 1")
        return pmesh.gather_rows(x, m)   # shard 0 waits here until released

    with pytest.raises(KeyError, match="shard 1"):
        m.map(fn, [torch.zeros(1, 1)] * 2)


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("domain", ["plain", "s2d"])
@pytest.mark.parametrize("name", NAMES)
def test_population_sharding_is_transparent(sg2, name, domain):
    """F over meshes of 2 and 4 shards equals the unsharded F and the JAX
    package's; D's minibatch-std groups (2 here: rows b and b + 4) span the
    shards."""
    cfg = tsg2.TINY if domain == "plain" else TINY_S2D
    X = _X(1)
    want = _problem(sg2, name, cfg).generator.eval_population(X)
    for devices in (["cpu"] * 2, ["cpu"] * 4):
        got = _problem(sg2, name, cfg, make_mesh(devices)).generator.eval_population(X)
        np.testing.assert_allclose(N(got), N(want), rtol=1e-5, atol=1e-6)
    jprob, jb, _ = sg2[name]
    jF = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(N(X)), jb))
    for j in range(jF.shape[1]):
        assert_close_scaled(N(want)[:, j], jF[:, j], 2e-3 if domain == "s2d" else 1e-4)
    if name.endswith("_d"):
        assert (N(want)[:, 1] > 0).any()   # a live hinge


@pytest.mark.parametrize("domain", ["plain", "s2d"])
def test_naive_split_moves_the_hinge(sg2, domain):
    """Each half evaluated as a population of its own, with no mesh: D pools
    rows b and b + 2 instead of b and b + 4, and the hinge moves far past
    the sharded run's tolerance; the CLIP objective (per row) does not."""
    cfg = tsg2.TINY if domain == "plain" else TINY_S2D
    gen = _problem(sg2, "StyleGAN2_ffhq_d", cfg).generator
    X = _X(1)
    whole = N(gen.eval_population(X))
    naive = N(torch.cat([gen.eval_population(X[:4]), gen.eval_population(X[4:])]))
    np.testing.assert_allclose(naive[:, 0], whole[:, 0], rtol=1e-5, atol=1e-6)
    assert np.abs(naive[:, 1] - whole[:, 1]).max() > 1e3 * (1e-6 + 1e-5 * np.abs(whole).max())


@pytest.mark.parametrize("name", NAMES)
def test_full_ga_sharded_equals_single_process(sg2, name):
    """Two GA / NSGA-II generations (selection, variation, dedup, fitness,
    survival) over the mesh equal the unsharded run, and the sharded fitness
    of the final population is the JAX package's on the same weights (the
    survivors' F came from the evaluations of their own generations, whose
    D groups differ)."""
    want = minimize(_problem(sg2, name).make_algorithm(), 2, 7)
    sharded = _problem(sg2, name, mesh=_mesh2())
    got = minimize(sharded.make_algorithm(), 2, 7)
    _same(got.pop_X, got.pop_F, want.pop_X, want.pop_F)
    jprob, jb, _ = sg2[name]
    jF = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(N(got.pop_X)), jb))
    F = N(sharded.generator.eval_population(got.pop_X))
    for j in range(jF.shape[1]):
        assert_close_scaled(F[:, j], jF[:, j], 1e-4)


def test_biggan_mixed_genome_sharded_equals_single_process(bg_problems):  # noqa: F811
    jprob, jbundle, tbundle = bg_problems
    from clip_glass_torch.models.biggan import model as tbg

    def run(mesh):
        prob = GenerationProblem(_bg_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                                 model_cfg=tbg.TINY, bundle=tbundle, mesh=mesh)
        return minimize(prob.make_algorithm(), 2, 2)

    want, got = run(None), run(_mesh2())
    _same(got.pop_X, got.pop_F, want.pop_X, want.pop_F)
    X = _bg_X(6)
    jF = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(X), jbundle))
    sharded = GenerationProblem(_bg_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                                model_cfg=tbg.TINY, bundle=tbundle, mesh=_mesh2())
    assert_close_scaled(N(sharded.generator.eval_population(T(X))), jF, 1e-4)


def test_gpt2_host_staged_sharded_equals_single_process(g2_problems):  # noqa: F811
    """The decode and the text tower split over the mesh, the host round trip
    on the whole population: int genomes exact, F within 1e-5 (and the JAX
    package's host_eval_population)."""
    from clip_glass_torch.models.gpt2 import model as tg2

    jprob, jbundle, tbundle = g2_problems

    def prob(mesh):
        return GenerationProblem(_g2_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                                 model_cfg=tg2.TINY, bundle=tbundle, mesh=mesh)

    want, got = minimize(prob(None).make_algorithm(), 2, 3), \
        minimize(prob(_mesh2()).make_algorithm(), 2, 3)
    np.testing.assert_array_equal(N(got.pop_X), N(want.pop_X))
    np.testing.assert_allclose(N(got.pop_F), N(want.pop_F), rtol=1e-5, atol=1e-6)
    X = _g2_X(1)
    jF = np.asarray(jprob.generator.host_eval_population(jnp.asarray(X), jbundle))
    np.testing.assert_allclose(N(prob(_mesh2()).generator.eval_population(T(X))), jF,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,smb", [(4, None), (2, None), (4, 1)])
def test_batched_searches_sharded_equal_unsharded(sg2, K, smb):
    """K searches batched over two shards: whole searches a shard (K = 4),
    or each search split over both (K = 2, or chunks of one search), where
    D's groups gather across the shards."""
    targets = [f"face {i}" for i in range(K)]
    Xb = _X(3, K * POP).reshape(K, POP, 32)

    def F(mesh):
        prob = _problem(sg2, "StyleGAN2_ffhq_d", mesh=mesh)
        return make_batched(prob, targets, search_microbatch=smb).evaluate(Xb)

    np.testing.assert_allclose(N(F(_mesh2())), N(F(None)), rtol=1e-5, atol=1e-6)


def test_int8_fitness_sharded_equals_unsharded(sg2):
    """--quantize int8 over the mesh: each shard runs its evaluation in an
    int8 scope of its own thread (the scales are per call site, in call
    order), so F equals the unsharded int8 F."""
    X = _X(2)
    F = [_problem(sg2, "StyleGAN2_ffhq_d", mesh=mesh, quantize="int8",
                  quantize_min_ch=1).generator.eval_population(X)
         for mesh in (None, _mesh2())]
    np.testing.assert_allclose(N(F[1]), N(F[0]), rtol=1e-5, atol=1e-6)


def test_server_sharded_equals_unsharded(sg2):
    """The same request stream (5 requests, 4 slots, churn) through a server
    whose slots split over two shards (whole searches a shard)."""
    def serve(mesh):
        server = SearchServer(_problem(sg2, "StyleGAN2_ffhq_nod"), n_slots=4, chunk=2,
                              seed=7, mesh=mesh)
        tickets = [server.submit(f"portrait {i}", n_gen=4) for i in range(5)]
        server.run()
        return [server.results[t] for t in tickets]

    for r0, r1 in zip(serve(None), serve(_mesh2())):
        _same(r1.pop_X, r1.pop_F, r0.pop_X, r0.pop_F)


def test_server_mesh_rejects_bad_fit(sg2):
    with pytest.raises(ValueError, match="must divide"):
        SearchServer(_problem(sg2, "StyleGAN2_ffhq_nod"), n_slots=3, chunk=2, mesh=_mesh2())


# ------------------------------------------------------------ the process group

def test_parse_spec_forms(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert dist.parse_spec("localhost:1234,4,2") == ("tcp://localhost:1234", 4, 2, 2)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert dist.parse_spec("10.0.0.1:99,2,1") == ("tcp://10.0.0.1:99", 2, 1, 0)
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="5", RANK="3", WORLD_SIZE="8",
                     LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    assert dist.parse_spec("auto") == ("env://", 8, 3, 1)


@pytest.mark.parametrize("spec", ["localhost:1,2", "localhost,2,0", "h:1,2,2", "h:x,2,0",
                                  "h:1,0,0", "auto"])
def test_bad_specs_raise(monkeypatch, spec):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError):
        dist.initialize(spec)


def test_initialize_no_op_and_idempotent(monkeypatch):
    monkeypatch.delenv(dist.ENV_SPEC, raising=False)
    assert dist.initialize() is False and dist.initialize("") is False
    assert not dist.active() and dist.is_primary() and dist.world_size() == 1
    x = torch.ones(2, 1)
    assert dist.fetch(x) is x and dist.fetch_tree({"a": [x]})["a"][0] is x
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    assert dist.initialize("not a spec") is True   # a group exists: nothing is parsed


def test_nccl_refuses_ranks_beyond_the_cards(monkeypatch):
    """Two ranks on a host of one card: NCCL raises before touching the
    card; only an explicit gloo backend lets them share it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        dist.initialize("localhost:1,2,1")


def test_cli_distributed_spec_errors_exit_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--tiny", "--device", "cpu", "--distributed", "nonsense",
                  "--tmp-folder", str(tmp_path)])
    assert e.value.code == 2 and "--distributed" in capsys.readouterr().err


def test_trainer_mesh_rules():
    with pytest.raises(ValueError, match="one process a card"):
        ttr.Trainer(tsg2.TINY, mesh=_mesh2())
    with pytest.raises(ValueError, match="not axes"):
        ttr.Trainer(tsg2.TINY, mesh=make_mesh(["cpu"]), batch_axes=("model",))
    with pytest.raises(ValueError, match="pass the mesh"):
        ttr.Trainer(tsg2.TINY, batch_axes=("pop",), device="cpu")
    tr = ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(batch_size=4, subdivisions=2),
                     mesh=make_mesh(["cpu"], axis="batch"))
    assert tr.device == torch.device("cpu") and tr.batch_axes == ("batch",)
    x = torch.arange(4.0)
    assert torch.equal(tr.local_rows(x), x)   # one rank: the whole batch


def test_dcp_checkpoint_round_trip_equals_npz(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.rand(3, generator=gen)
    state = GAState(_X(0), torch.randn(POP, 2), 11)
    save_state(state, gen, str(tmp_path), "cfg")
    save_state_dcp(state, gen, str(tmp_path), "cfg")
    a, ga = load_state(str(tmp_path), torch.Generator()), torch.Generator()
    b = load_state_dcp(str(tmp_path), ga)
    assert torch.equal(a.X, b.X) and torch.equal(a.F, b.F) and a.gen == b.gen == 11
    assert torch.equal(ga.get_state(), gen.get_state())
    assert load_state_dcp(str(tmp_path / "nope"), ga) is None
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    batched = GAState(torch.randn(2, 4, 3), torch.randn(2, 4, 1), (5, 5))
    save_state_dcp(batched, gens, str(tmp_path / "b"))
    got = load_state_dcp(str(tmp_path / "b"), [torch.Generator(), torch.Generator()])
    assert got.gen == (5, 5) and torch.equal(got.X, batched.X)
    with pytest.raises(ValueError, match="batched search"):
        load_state_dcp(str(tmp_path / "b"), torch.Generator())


# ------------------------------------------------------------ two processes

TRAIN_CASES = {
    # the batch-sharded step (R1 and the path length penalty at step 0)
    "step": (dict(batch_size=8, checkpoint_every=0, seed=5), 1, None),
    # R1 every step, two subdivisions (the chunks' groups span the ranks)
    "r1": (dict(batch_size=8, checkpoint_every=0, seed=7, d_reg_interval=1,
                g_reg_interval=10 ** 6, subdivisions=2), 3, None),
    # the path length penalty every step: pl_avg over both ranks' rows
    "pl": (dict(batch_size=8, checkpoint_every=0, seed=9, g_reg_interval=1,
                d_reg_interval=10 ** 6), 3, None),
    # 2 steps, a new trainer from the checkpoint, 1 more
    "resume": (dict(batch_size=8, checkpoint_every=0, seed=3), 3, 2),
}


def _reals(n, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, (batch, 3, 16, 16)).astype(np.float32))
            for _ in range(n)]


def _step_draws(cfg: dict, steps: int, seed: int):
    """Every step's draws of the global batch, from a trainer's generator."""
    tr = ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(**cfg), device="cpu")
    tr.state = tr.state._replace(key=torch.Generator().manual_seed(seed))
    S = cfg.get("subdivisions", 1)
    pl = cfg.get("g_reg_interval", 4)
    return [tr.draw(cfg["batch_size"] // S, S, i % pl == 0) for i in range(steps)]


def _torch_weights(weights):  # noqa: F811
    g, d = weights
    return from_jax.convert_generator(g), from_jax.convert_discriminator(d)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, sg2, weights, jtrainer):  # noqa: F811
    """Two gloo ranks of tests/torch_parallel_worker.py on every case."""
    out = tmp_path_factory.mktemp("two_ranks")
    g, d = _torch_weights(weights)
    cases = {}
    for i, (name, (cfg, steps, resume_at)) in enumerate(TRAIN_CASES.items()):
        cases[name] = dict(cfg=cfg, reals=_reals(steps, seed=i),
                           draws=_step_draws(cfg, steps, 40 + i), resume_at=resume_at)
    S = CFG["subdivisions"]
    cases["jax"] = dict(cfg=CFG, reals=[T(_jax_reals())],
                        draws=[jax_draws(jtrainer.state.key, 4, S, True)], resume_at=None)
    inputs = dict(g=g, d=d, trainer=cases, X=_X(1), pop=POP, generations=2, seed=3,
                  bundles={n: sg2[n][2] for n in NAMES})
    torch.save(inputs, out / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_worker.py"),
         "--rank", str(r), "--world", "2", "--port", str(port),
         "--inputs", str(out / "inputs.pt"), "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    return out, inputs, torch.load(out / "results.pt", weights_only=False)


def _jax_reals():
    return np.random.default_rng(12).uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)


def test_two_ranks_fetch_and_dcp(two_ranks):
    _, _, res = two_ranks
    assert res["world"] == 2 and res["mesh_size"] == 2
    assert torch.equal(res["fetch"], torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
    assert res["ckpt_equal"]


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_search_equals_single_process(two_ranks, sg2, name):
    _, inputs, res = two_ranks
    prob = _problem(sg2, name)
    np.testing.assert_allclose(N(res[f"{name}/F"]), N(prob.generator.eval_population(
        inputs["X"])), rtol=1e-5, atol=1e-6)
    want = minimize(prob.make_algorithm(), 2, 3)
    _same(res[f"{name}/X_gen"], res[f"{name}/F_gen"], want.pop_X, want.pop_F)


def _leaf_pair(state):
    return N(state.g_params["mapping"]["dense"][0]["w"]), N(state.d_params["from_rgb"]["w"])


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_two_ranks_trainer_steps_equal_single_process(two_ranks, weights, name):  # noqa: F811
    """Each step of the two ranks against the single process's step from the
    ranks' previous state (their checkpoint) with the same reals and draws."""
    out, inputs, res = two_ranks
    case = inputs["trainer"][name]
    g, d = _torch_weights(weights)
    folder = out / "trainer" / name
    for i, (reals, draws) in enumerate(zip(case["reals"], case["draws"])):
        single = ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(**case["cfg"]), g, d, device="cpu")
        if i:
            single.load_checkpoint(str(folder / f"step-{i}"))
        logs = single.train_step(reals, draws)
        ranks = ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(**case["cfg"]), g, d, device="cpu")
        ranks.load_checkpoint(str(folder / f"step-{i + 1}"))
        got, want = ranks.state, single.state
        assert got.step == want.step == i + 1
        for k, v in res[f"trainer/{name}/logs"][i].items():
            assert v == pytest.approx(float(logs[k]), rel=1e-4, abs=1e-9), (i, k)
        assert float(got.pl_avg) == pytest.approx(float(want.pl_avg), rel=1e-4, abs=1e-6)
        for opt in ("g_opt", "d_opt"):
            jlike = [N(t) for t in getattr(want, opt).mu]
            errs = [np.linalg.norm(N(a) - w) / max(np.linalg.norm(w),
                                                   1e-3 * max(map(np.linalg.norm, jlike)))
                    for a, w in zip(getattr(got, opt).mu, jlike)]
            assert max(errs) <= 1e-4, (i, opt, max(errs))
        for a, b in zip(_leaf_pair(got), _leaf_pair(want)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_two_ranks_trainer_step_matches_jax(two_ranks, weights, jtrainer):  # noqa: F811
    """Step 0 (R1, the path length penalty, two subdivisions, batch 4: one
    row a rank a chunk, so every minibatch-std group spans both ranks) fed
    the JAX package's draws, against the JAX trainer's step."""
    out, _, res = two_ranks
    g, d = _torch_weights(weights)
    new, jlogs = jtrainer._train_step(jtrainer.state, jnp.asarray(_jax_reals()))
    tr = ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(**CFG), g, d, device="cpu")
    tr.load_checkpoint(str(out / "trainer" / "jax" / "step-1"))
    _assert_logs({k: torch.tensor(v) for k, v in res["trainer/jax/logs"][0].items()}, jlogs)
    _check_state(tr, new)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     "dryrun_multihost_torch.py"),
                        "--nprocs", "2", "--generations", "4", "--out", out,
                        "--timeout", str(RUN_TIMEOUT_S)],
                       capture_output=True, text=True, timeout=RUN_TIMEOUT_S + 30)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-1000:]
    return out, json.loads(r.stdout.strip().splitlines()[-1])


def test_dryrun_two_processes_write_the_artifacts_once(dryrun):
    _, v = dryrun
    assert v["ok"] and v["processes"] == 2 and v["mesh_size"] == 2
    assert v["search_gens"] == 4 and v["pop_shape"] == [POP, 32]
    assert v["trainer_steps"] == 2 and np.isfinite(v["trainer_d_loss"])
    final = {"genetic_result", "F.jpg", "ls_result.npz", "output.jpg", "genetic-it-final.jpg",
             "genetic-it-2.jpg"}
    assert final | {"ga_state.npz"} <= set(v["artifacts"])
    rank0, rank1 = v["writes_by_rank"]
    assert rank1 == {}                       # rank 1 wrote nothing in the folder
    assert all(rank0[f] == 1 for f in final)  # rank 0 each artifact once
    assert rank0["ga_state.npz.tmp"] == 2    # the state at generations 2 and 4


def test_dryrun_trajectory_equals_single_process(dryrun, tmp_path):
    out, _ = dryrun
    single = str(tmp_path / "single")
    assert cli.main(["--config", "StyleGAN2_ffhq_d", "--target", "a red flower",
                     "--generations", "4", "--save-each", "2", "--tmp-folder", single,
                     "--tiny", "--pop-size", str(POP), "--device", "cpu", "--no-verbose"]) == 0
    with np.load(os.path.join(out, "search", "ga_state.npz")) as d2, \
            np.load(os.path.join(single, "ga_state.npz")) as d1:
        assert int(d2["gen"]) == int(d1["gen"]) == 4
        np.testing.assert_allclose(d2["X"], d1["X"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d2["F"], d1["F"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(d2["rng_state"], d1["rng_state"])
