"""The port's continuous-batching server (clip_glass_torch/serving.py) and
the CLI's serve mode, on the CPU with TINY models in fp32.

A request served through the resident slots equals an independent
`minimize` of the same problem with its target and the generator
`search_generator(seed, ticket)`, under slot churn (more requests than
slots), staggered admission, threaded submission and for GPT-2's img2txt
(X rtol = atol = 1e-5, F rtol 1e-4 atol 1e-5: tests/test_serving.py's
tolerances; the evaluation batch differs from the independent run's, so
the sums do). Modelled on tests/test_serving.py, which holds the JAX
package's server to the same contract.
"""

import dataclasses
import io
import os
import re
import threading
import time

import numpy as np
import pytest

import torch

from clip_glass_torch import cli
from clip_glass_torch.config import get_config
from clip_glass_torch.core.profiling import TRACER
from clip_glass_torch.evolve.algorithm import minimize
from clip_glass_torch.evolve.batched import search_generator
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.serving import SearchServer

IMG_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "gpt2_images")
FINAL = {"F.jpg", "genetic_result", "ls_result.npz", "output.jpg", "target.txt"}



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the lane runs six test processes on the
    machine's cores, and these TINY computations gain nothing from more
    threads but lose much to their contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def problems():
    def make(name):
        cfg = get_config(name).replace(pop_size=8, dim_z=32, n_var=32, weights="random:0",
                                       target="a face", compute_dtype="float32")
        return GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)
    return {True: make("StyleGAN2_ffhq_d"), False: make("StyleGAN2_ffhq_nod")}


def _oracle(problem, server, target, ticket, n_gen):
    """The independent search: the same problem scored against `target`'s
    features, seeded search_generator(server seed, ticket)."""
    gen = problem.generator
    row = gen.encode_targets([target])
    algo = dataclasses.replace(
        problem.make_algorithm(),
        eval_fn=lambda X: gen.eval_population(X, {**gen.bundle, "target": row}))
    return minimize(algo, n_gen, search_generator(server.seed, ticket, "cpu"))


def _same(res, ref):
    np.testing.assert_allclose(res.pop_X.numpy(), ref.pop_X.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.pop_F.numpy(), ref.pop_F.numpy(), rtol=1e-4, atol=1e-5)


def test_server_churn_matches_independent_runs(problems):
    """5 requests through 2 slots: every result, those admitted into
    recycled slots included, equals its independent run."""
    prob = problems[True]
    server = SearchServer(prob, n_slots=2, chunk=2, seed=11)
    targets = [f"face variant {i}" for i in range(5)]
    tickets = [server.submit(t, n_gen=4) for t in targets]
    server.run()
    assert server.stats.completed == 5
    assert server.pending() == 0 and server.active() == 0
    assert server.stats.admission_evals == 5 * 8
    for t, ticket in zip(targets, tickets):
        res = server.results[ticket]
        assert res.state.gen == 4 and server.meta[ticket] == t
        _same(res, _oracle(prob, server, t, ticket, 4))


def test_server_staggered_admission(problems):
    """A request submitted while another is mid-flight starts at generation
    0 in its own slot and still equals its independent run."""
    prob = problems[False]
    server = SearchServer(prob, n_slots=2, chunk=2, seed=3)
    t0 = server.submit("early bird", n_gen=6)
    server.tick()                               # t0 at gen 2, slot 1 idle
    assert server.state.gen == (2, 2)           # the idle slot evolves too
    t1 = server.submit("late comer", n_gen=2)
    server.run()
    for ticket, target, n in [(t0, "early bird", 6), (t1, "late comer", 2)]:
        res = server.results[ticket]
        assert res.state.gen == n
        _same(res, _oracle(prob, server, target, ticket, n))


def test_server_rounds_n_gen_up_to_chunk(problems):
    server = SearchServer(problems[False], n_slots=1, chunk=4, seed=0)
    ticket = server.submit("round me", n_gen=5)     # -> 8
    server.run()
    assert server.results[ticket].state.gen == 8
    assert server.stats.occupancy == 1.0            # one slot, always busy
    assert server.stats.ticks == 2 and server.stats.total_evals == 2 * 4 * 8


def test_server_threaded_submission(problems):
    """submit() from another thread while the pump runs forever."""
    prob = problems[False]
    server = SearchServer(prob, n_slots=2, chunk=2, seed=9)
    tickets = []

    def client():
        tickets.append(server.submit("from a thread", n_gen=2))
        while len(server.results) < 1:
            time.sleep(0.001)
        server.stop()

    th = threading.Thread(target=client)
    th.start()
    server.run(forever=True)
    th.join(timeout=60)
    assert not th.is_alive()
    _same(server.results[tickets[0]], _oracle(prob, server, "from a thread", tickets[0], 2))


def test_server_img2txt():
    """Captioning requests (GPT-2 img2txt): the decode at the slots' batch,
    the host round trip per slot; each request equals its independent run."""
    imgs = [os.path.join(IMG_DIR, n) for n in ("dog.jpeg", "goldfish.jpeg", "zebra.jpeg")]
    cfg = get_config("GPT2").replace(weights="random:0", target=imgs[0], pop_size=4, dim_z=6,
                                     n_var=6, max_tokens_len=5, compute_dtype="float32")
    prob = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tg2.TINY)
    server = SearchServer(prob, n_slots=2, chunk=1, seed=2)
    tickets = [server.submit(p, n_gen=2) for p in imgs]
    server.run()
    for ticket, path in zip(tickets, imgs):
        _same(server.results[ticket], _oracle(prob, server, path, ticket, 2))


def test_server_map_and_occupancy(problems):
    server = SearchServer(problems[False], n_slots=2, chunk=2, seed=4)
    out = server.map(["one", "two", "three"], n_gen=2)
    assert len(out) == 3 and server.stats.completed == 3
    # 3 requests through 2 slots: the idle slot's work is counted
    s = server.stats
    assert s.ticks == 2 and s.useful_evals == 3 * 2 * 8 and s.total_evals == 2 * 2 * 2 * 8
    assert s.occupancy == 0.75


def test_server_refuses_a_mesh_and_bad_sizes(problems):
    # a mesh runs (tests/test_torch_parallel.py); slots that do not split
    # over it are a bad fit
    from clip_glass_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="must divide"):
        SearchServer(problems[False], n_slots=3, mesh=make_mesh(["cpu", "cpu"]))
    with pytest.raises(ValueError):
        SearchServer(problems[False], n_slots=0)
    server = SearchServer(problems[False], n_slots=1, chunk=1)
    with pytest.raises(ValueError):
        server.submit("nothing", n_gen=0)


# ------------------------------------------------------------ the CLI's serve mode


def _serve(tmp_path, source, *extra):
    return cli.main(["--config", "StyleGAN2_ffhq_d", "--tiny", "--device", "cpu",
                     "--pop-size", "8", "--serve", source, "--slots", "2",
                     "--generations", "2", "--save-each", "1",
                     "--tmp-folder", str(tmp_path / "out"), *extra])


def test_cli_serve_file(tmp_path, capsys):
    """--serve FILE: each non-empty line is a request; each gets
    request-NNNN/ with target.txt and the result artifacts. With --profile
    the trace holds the server's ticks, each with its slots' tickets."""
    import json

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red flower\na blue car\n\nan old house\n")
    trace = tmp_path / "trace"
    TRACER.reset()   # the trace holds the ring: this serve's spans alone
    assert _serve(tmp_path, str(prompts), "--profile", str(trace)) == 0
    with open(trace / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ticks = [e for e in events if e.get("name") == "serve.tick"]
    assert ticks and {t for e in ticks for t in e["args"]["tickets"]} >= {0, 1, 2}
    assert any(e.get("name") == "serve.admit" for e in events)
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == [f"request-{i:04d}" for i in range(3)]
    for i, target in enumerate(["a red flower", "a blue car", "an old house"]):
        assert set(os.listdir(out / f"request-{i:04d}")) == FINAL
        assert (out / f"request-{i:04d}" / "target.txt").read_text() == target
    printed = capsys.readouterr().out
    assert "slot occupancy" in printed and "mean queue wait" in printed
    # each finished request's line gives its queue wait and service time
    done = [line for line in printed.splitlines() if line.startswith("[serve] done #")]
    assert len(done) == 3 and all(re.search(r"\(queued [0-9.]+s, served [0-9.]+s\)$", line)
                                  for line in done)


def test_cli_serve_stdin(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("a red flower\na blue car\n"))
    assert _serve(tmp_path, "-", "--no-verbose") == 0
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["request-0000", "request-0001"]
    assert (out / "request-0001" / "target.txt").read_text() == "a blue car"


@pytest.mark.parametrize("extra,why", [(["--resume"], "does not take --resume"),
                                       ([], "not found")])
def test_cli_serve_refusals(tmp_path, capsys, extra, why):
    """--serve with --resume, and a --serve file that does not exist: exit
    2 before anything is built or written."""
    source = str(tmp_path / ("missing.txt" if not extra else "p.txt"))
    if extra:
        open(source, "w").write("a red flower\n")
    with pytest.raises(SystemExit) as e:
        _serve(tmp_path, source, *extra)
    assert e.value.code == 2
    assert why in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("extra,why", [
    (["--slots", "0"], "n_slots"),
    (["--slots", "4", "--search-microbatch", "3"], "must divide")])
def test_cli_serve_refuses_bad_slots(tmp_path, capsys, extra, why):
    """--slots 0, and a --search-microbatch that does not divide --slots:
    exit 2 naming the fault, nothing served."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red flower\n")
    with pytest.raises(SystemExit) as e:
        _serve(tmp_path, str(prompts), *extra)
    assert e.value.code == 2
    assert why in capsys.readouterr().err
    assert not os.listdir(tmp_path / "out")


def test_cli_serve_writer_error_ends_the_serve(tmp_path, monkeypatch):
    """A failing artifact writer ends the serve with its error, not after
    the stream drains."""
    def broken(*a):
        raise OSError("disk full")
    monkeypatch.setattr(cli, "_final_artifacts", broken)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a\nb\nc\nd\ne\n")
    with pytest.raises(OSError, match="disk full"):
        _serve(tmp_path, str(prompts), "--no-verbose")
