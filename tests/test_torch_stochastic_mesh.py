"""A sampled GPT-2 decode (config.stochastic) is independent of the mesh, on
the CPU with TINY GPT-2 and TINY CLIP in fp32.

The JAX package's random bits belong to the logical array: its
`host_eval_population` gives one F whether X is sharded or not. The port
draws every row's uniforms on the host, from the evaluation seed and the
row's place in the whole population (`generator.decode_draws`: chunk c of
the decode from a CPU generator seeded search_seed(seed, c)), and each shard
decodes its rows with theirs. So F and the decoded ids over a mesh of 2 or 4
positions, with decode chunks that cross a shard boundary, for K batched
searches and for the server's slots, are bitwise the one-device ones; on a
(2, 2) mesh the ids are, and F is up to the tensor-parallel text tower's
summation order.

The sampling rule itself (`gpt2.model._select_next`): the kept tokens are
the JAX package's (every logit below the k-th floored, so ties at the k-th
all stay), the draw inverts their CDF in token-id order, and its frequencies
over a grid of uniforms match the JAX package's categorical draws.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.gpt2 import model as jg2

from clip_glass_torch.config import get_config
from clip_glass_torch.evolve import batched
from clip_glass_torch.fitness.generator import decode_draws
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.parallel import make_mesh
from clip_glass_torch.serving import SearchServer
from clip_glass_torch.weights import from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_DIR = os.path.join(ROOT, "examples", "gpt2_images")
IMAGES = [os.path.join(IMG_DIR, n) for n in ("dog.jpeg", "goldfish.jpeg")]
SEEDS = (11, 12, 2 ** 40 + 3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, **kw):
    return get("GPT2").replace(**{**dict(
        pop_size=4, dim_z=6, n_var=6, max_tokens_len=5, weights="random:0",
        target=IMAGES[0], compute_dtype="float32", stochastic=True), **kw})


@pytest.fixture(scope="module")
def jprob():
    return JProblem(_cfg(jget_config), clip_cfg=jclip.TINY, model_cfg=jg2.TINY)


@pytest.fixture(scope="module")
def bundle(jprob):
    """The JAX problem's weights in the port's layout."""
    return from_jax.convert_bundle(jax.tree.map(np.asarray, jprob.generator.bundle))


def _problem(bundle, mesh=None, **kw):
    return GenerationProblem(_cfg(get_config, **kw), device="cpu", clip_cfg=tclip.TINY,
                             model_cfg=tg2.TINY, bundle=bundle, mesh=mesh)


def _X(pop, seed=3):
    return np.random.default_rng(seed).integers(0, 50257, (pop, 6)).astype(np.float32)


@pytest.mark.parametrize("mb", [None, 2])
def test_jax_host_eval_is_sharding_invariant(jprob, mb):
    """(a) The JAX reference: F of X on 2 of the host's devices is F of X
    unsharded, under one key (pop 4; whole, and in decode chunks of 2)."""
    gen = jprob.generator if mb is None else \
        JProblem(_cfg(jget_config, eval_microbatch=mb), clip_cfg=jclip.TINY,
                 model_cfg=jg2.TINY).generator
    X = jnp.asarray(_X(4))
    mesh = JMesh(np.array(jax.devices()[:2]), ("pop",))
    Xs = jax.device_put(X, NamedSharding(mesh, P("pop")))
    assert len(Xs.sharding.device_set) == 2
    key = jax.random.PRNGKey(11)
    F = np.asarray(gen.host_eval_population(X, key=key))
    Fs = np.asarray(gen.host_eval_population(Xs, key=key))
    np.testing.assert_array_equal(Fs, F)


# (mesh positions, pop, eval_microbatch): whole populations; decode chunks of
# 4 over shards of 2 rows; chunks of 3 on shards of 3; chunks of 2 over
# shards of 3, where chunk 1 (rows 2-3) crosses the shard boundary
MESH_CASES = [(2, 4, None), (4, 8, None), (4, 8, 4), (2, 6, 3), (2, 6, 2)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,pop,mb", MESH_CASES)
def test_mesh_F_and_ids_are_the_one_device_ones(bundle, n, pop, mb, seed):
    """(b) F and the decoded ids over a mesh of n CPU positions are bitwise
    the one-device ones, under three evaluation seeds."""
    one = _problem(bundle, eval_microbatch=mb).generator
    mesh = make_mesh(["cpu"] * n)
    sharded = _problem(bundle, mesh, eval_microbatch=mb).generator
    X = torch.from_numpy(_X(pop))
    rows = one._decode_chunk(pop)
    ids = one._decode_rows(X, one.bundle, rows, None, seed)
    assert torch.equal(sharded._decode_rows(X, sharded.bundle, rows, mesh, seed), ids)
    F = one.eval_population(X, seed=seed)
    assert torch.equal(sharded.eval_population(X, seed=seed), F)
    assert not torch.equal(one.eval_population(X, seed=seed + 1), F)


@pytest.mark.parametrize("seed", SEEDS)
def test_2d_mesh_ids_and_F_are_the_one_device_ones(bundle, seed):
    """(c) On a (2, 2) mesh (GPT-2 on each model group's rows, CLIP's text
    tower tensor-parallel over the group), decode chunks of 2 over row
    blocks of 3: the decoded ids bitwise the one-device ids; F within
    tests/test_torch_tp.py's tolerance, since the tower's partial sums over
    the model axis round apart from the whole tower's (1.5e-7 here; the
    argmax decode's F moves alike)."""
    one = _problem(bundle, eval_microbatch=2).generator
    mesh = make_mesh(["cpu"] * 4, model_axis_size=2)
    tp = _problem(bundle, mesh, eval_microbatch=2).generator
    X = torch.from_numpy(_X(6))
    ids = one._decode_rows(X, one.bundle, 2, None, seed)
    assert torch.equal(tp._decode_rows(X, tp.bundle, 2, mesh, seed), ids)
    F = one.eval_population(X, seed=seed)
    np.testing.assert_allclose(tp.eval_population(X, seed=seed).numpy(), F.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_batched_searches_on_a_mesh_are_the_one_device_ones(bundle):
    """(c) K = 2 batched stochastic searches on a 2-position mesh: bitwise
    the same searches on one device."""
    def run(mesh):
        balgo = batched.make_batched(_problem(bundle, mesh), IMAGES)
        return batched.minimize_batched(balgo, 2, 11)

    for i, (got, want) in enumerate(zip(run(make_mesh(["cpu"] * 2)), run(None))):
        assert torch.equal(got.pop_X, want.pop_X), i
        assert torch.equal(got.pop_F, want.pop_F), i


def test_server_slots_on_a_mesh_are_the_one_device_ones(bundle):
    """(c) A 2-slot SearchServer given a 2-position mesh (the problem's own
    is none): each request's result bitwise the one-device server's."""
    def serve(mesh):
        return SearchServer(_problem(bundle), n_slots=2, chunk=1, seed=13,
                            mesh=mesh).map(IMAGES[::-1], 2)

    for t, (got, want) in enumerate(zip(serve(make_mesh(["cpu"] * 2)), serve(None))):
        assert torch.equal(got.pop_X, want.pop_X), t
        assert torch.equal(got.pop_F, want.pop_F), t


@pytest.mark.parametrize("n", [None, 2, 4])
def test_identical_genomes_decode_to_different_rows(bundle, n):
    """(d) A population of one genome repeated, in decode chunks of 2: every
    row decodes differently, on one device and on meshes of 2 and 4
    positions (equal to the one-device ids), so row i and row i + pop/2 no
    longer share their draws."""
    pop = 8
    one = _problem(bundle, eval_microbatch=2).generator
    X = torch.from_numpy(np.repeat(_X(1), pop, axis=0))
    ids = one._decode_rows(X, one.bundle, 2, None, 5)
    if n is not None:
        mesh = make_mesh(["cpu"] * n)
        sharded = _problem(bundle, mesh, eval_microbatch=2).generator
        got = sharded._decode_rows(X, sharded.bundle, 2, mesh, 5)
        assert torch.equal(got, ids)
        ids = got
    rows = [tuple(r) for r in ids.tolist()]
    assert len(set(rows)) == pop
    assert all(rows[i] != rows[i + pop // 2] for i in range(pop // 2))


# one rank of a gloo group: the problem on a one-position mesh that spans
# the ranks, F and the decoded ids of the inputs' X (rank 0 saves them)
RANK_CODE = """
import sys, torch
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.parallel import distributed as dist, make_mesh
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.initialize(f"localhost:{port},2,{rank}", backend="gloo", timeout_s=120)
inp = torch.load(path, weights_only=False)
mesh = make_mesh(["cpu"])
gen = GenerationProblem(inp["config"], device="cpu", clip_cfg=tclip.TINY, model_cfg=tg2.TINY,
                        bundle=inp["bundle"], mesh=mesh).generator
out = {"F": gen.eval_population(inp["X"], seed=inp["seed"]),
       "ids": gen._decode_rows(inp["X"], gen.bundle, 2, mesh, inp["seed"])}
if dist.is_primary():
    torch.save(out, path + ".out")
dist.barrier()
dist.shutdown()
"""


def test_two_ranks_decode_as_one_device(bundle, tmp_path):
    """Under a process group (two gloo ranks, 3 rows a rank, decode chunks
    of 2, so chunk 1 spans both ranks) F and the ids are bitwise the
    one-device ones; a run's time limit turns a hang into a failure."""
    one = _problem(bundle, eval_microbatch=2).generator
    X = torch.from_numpy(_X(6))
    path = str(tmp_path / "in.pt")
    torch.save({"config": one.config, "bundle": bundle, "X": X, "seed": 11}, path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r), port, path], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    got = torch.load(path + ".out", weights_only=False)
    assert torch.equal(got["ids"], one._decode_rows(X, one.bundle, 2, None, 11))
    assert torch.equal(got["F"], one.eval_population(X, seed=11))


def test_decode_draws_depend_on_the_row_of_the_whole_population():
    """The uniforms of rows [a, b) are those rows of the whole population's,
    whatever the split; chunk c is search_seed(seed, c)'s stream."""
    whole = decode_draws(11, 10, 5, 4)
    assert whole.shape == (10, 5) and whole.dtype == torch.float32
    chunk1 = torch.rand((4, 5), generator=torch.Generator().manual_seed(
        batched.search_seed(11, 1)))
    assert torch.equal(whole[4:8], chunk1)
    assert not torch.equal(whole[:4], whole[4:8])
    assert torch.equal(decode_draws(11, 10, 5, 4), whole)
    assert not torch.equal(decode_draws(12, 10, 5, 4), whole)


def _planted_logits(seed=0, B=3, V=64):
    """Logits with a tie at the k-th (k = 8) value in row 0 (5 tokens share
    it, 3 of them inside the top 8) and a tie at the maximum in row 1."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, V)).astype(np.float32)
    logits[0, :] = np.minimum(logits[0, :], 0.5)
    logits[0, [3, 9, 20, 33, 60]] = [4.0, 3.0, 2.0, 1.5, 1.2]
    logits[0, [5, 14, 41, 50, 62]] = 1.0     # the k-th value, 5 tokens
    logits[1, [7, 30]] = 6.0
    return logits


def _kept(logits, k, temperature=0.7):
    """The JAX package's rule (clip_glass_tpu/models/gpt2/model.py:
    _select_next): temperature, logits below the k-th floored."""
    lt = jnp.asarray(logits) / temperature
    kth = jax.lax.top_k(lt, k)[0][:, -1]
    return np.asarray(jnp.where(lt < kth[:, None], jg2.NEG_BIG, lt))


def test_sampling_keeps_every_tie_at_the_kth_and_matches_jax():
    """Over a grid of N uniforms a row's pick frequencies are the JAX rule's
    probabilities to within 2 / N (row 0 keeps all 5 tokens tied at the
    k-th value: 10 tokens for k = 8), every pick a kept token, and within
    the sampling noise of JAX's own categorical draws of N rows."""
    k, N = 8, 4000
    logits = _planted_logits()
    masked = _kept(logits, k)
    p = np.asarray(jax.nn.softmax(jnp.asarray(masked), axis=-1))
    assert (p[0] > 0).sum() == 10
    u = (torch.arange(N, dtype=torch.float32) + 0.5) / N
    jkey = jax.random.PRNGKey(0)
    for b in range(logits.shape[0]):
        rows = torch.from_numpy(np.repeat(logits[b:b + 1], N, axis=0))
        got = tg2._select_next(rows, 0.7, k, True, u).numpy()
        assert set(np.unique(got)) <= set(np.flatnonzero(p[b] > 0))
        freq = np.bincount(got, minlength=logits.shape[1]) / N
        np.testing.assert_allclose(freq, p[b], rtol=0, atol=2 / N)
        jgot = np.asarray(jg2._select_next(jnp.asarray(rows.numpy()), 0.7, k, True,
                                           jax.random.fold_in(jkey, b)))
        jfreq = np.bincount(jgot, minlength=logits.shape[1]) / N
        np.testing.assert_allclose(freq, jfreq, rtol=0, atol=5 * np.sqrt(0.25 / N))


def test_a_rows_pick_depends_on_its_row_alone():
    """A row's pick is the same alone, in any batch and at any place in it;
    its uniform walks the kept tokens in id order."""
    logits = torch.from_numpy(_planted_logits(1, B=6))
    u = torch.rand(6, generator=torch.Generator().manual_seed(2))
    batch = tg2._select_next(logits, 0.7, 8, True, u)
    alone = torch.stack([tg2._select_next(logits[i:i + 1], 0.7, 8, True, u[i:i + 1])[0]
                         for i in range(6)])
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    assert torch.equal(batch, alone)
    assert torch.equal(tg2._select_next(logits[perm], 0.7, 8, True, u[perm]), batch[perm])
    row = logits[:1].expand(3, -1)
    first, last = tg2._select_next(row, 0.7, 8, True, torch.tensor([0.0, 0.5, 1 - 2 ** -24]))[
        [0, 2]]
    kept = np.flatnonzero(_kept(logits[:1].numpy(), 8)[0] > jg2.NEG_BIG / 2)
    assert (first.item(), last.item()) == (kept[0], kept[-1])
    with pytest.raises(ValueError, match="draws"):
        tg2.sample_sequence(tg2.init(torch.Generator().manual_seed(0), tg2.TINY),
                            torch.zeros((2, 3), dtype=torch.int32), 4, tg2.TINY,
                            temperature=0.7, top_k=8, sample=True)
