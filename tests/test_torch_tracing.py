"""The port's tracer (`clip_glass_torch.core.profiling.TRACER`): spans,
their parents across threads, the ring and the totals that outlast it, the
switch, the counters and the Chrome export; the spans a tiny CPU search and
a tiny CPU server leave at every layer boundary; the kernel library's load
span and build counter; the benchmark's readers of the spans
(`benchmark/metrics/`). One `gpu` test shows on the card that the spans and
torch.profiler's device events share one clock: run it with
`python -m pytest --noconftest -m gpu tests/test_torch_tracing.py`. This
file imports no JAX, so that it runs on the card's machine."""

import importlib.util
import json
import os
import pathlib
import stat
import threading
import types

import pytest

import torch

from clip_glass_torch.config import get_config
from clip_glass_torch.core import profiling
from clip_glass_torch.core.profiling import TRACER, Tracer
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.ops import cuda
from clip_glass_torch.serving import SearchServer

ROOT = pathlib.Path(__file__).resolve().parent.parent
POP = 8
METRICS = ("search.vary_ms_per_gen", "search.survive_ms_per_gen", "fitness.host_ms_per_eval",
           "setup.stage_s", "setup.first_eval_s")


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Every test starts from an empty process tracer, switched on."""
    TRACER.reset()
    TRACER.enabled = True
    yield
    TRACER.enabled = True


@pytest.fixture(scope="module")
def problem():
    cfg = get_config("StyleGAN2_ffhq_d").replace(pop_size=POP, dim_z=32, n_var=32,
                                                 weights="random:0", target="a face",
                                                 compute_dtype="float32")
    return GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_per_thread():
    """A span's parent is the innermost span open on its own thread: a span
    on another thread, opened while the main thread's is open, has none."""
    tracer = Tracer()
    seen = threading.Event()

    def other():
        with tracer.span("other", side=1):
            with tracer.span("other.child"):
                pass
        seen.set()

    with tracer.span("outer"):
        with tracer.span("inner", rows=3) as attrs:
            attrs["late"] = True
            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive() and seen.is_set()
    got = {r.name: r for r in tracer.records()}
    assert got["inner"].parent == "outer" and got["outer"].parent is None
    assert got["other"].parent is None and got["other.child"].parent == "other"
    assert got["inner"].attrs == {"rows": 3, "late": True}
    assert got["outer"].t0_ns <= got["inner"].t0_ns <= got["inner"].t1_ns <= got["outer"].t1_ns
    # in the order the spans ended: a child before its parent
    names = [r.name for r in tracer.records()]
    assert names.index("inner") < names.index("outer")
    assert names.index("other.child") < names.index("other")


def test_span_is_recorded_when_its_block_raises():
    tracer = Tracer()
    with pytest.raises(ValueError):
        with tracer.span("failing"):
            raise ValueError("no")
    with tracer.span("after"):
        pass
    got = {r.name: r for r in tracer.records()}
    assert set(got) == {"failing", "after"} and got["after"].parent is None


def test_ring_is_bounded_and_totals_outlast_it():
    tracer = Tracer(capacity=4)
    for i in range(10):
        with tracer.span("step", i=i):
            pass
    with tracer.span("other"):
        pass
    records = tracer.records()
    assert len(records) == 4 and [r.attrs.get("i") for r in records] == [7, 8, 9, None]
    totals = tracer.totals()
    assert totals["step"].count == 10 and totals["step"].first.attrs == {"i": 0}
    assert totals["step"].ns >= sum(r.t1_ns - r.t0_ns for r in records[:3])
    tracer.reset()
    assert tracer.records() == [] and tracer.totals() == {} and tracer.counters() == {}


def test_disabled_tracer_records_nothing():
    tracer = Tracer()
    tracer.enabled = False
    with tracer.span("off", rows=1) as attrs:
        attrs["x"] = 1   # the block may still write its attrs
        tracer.count("things")
    assert tracer.records() == [] and tracer.totals() == {} and tracer.counters() == {}
    tracer.enabled = True
    with tracer.span("on"):
        pass
    assert [r.name for r in tracer.records()] == ["on"]
    assert tracer.records()[0].parent is None


def test_counters_add_across_threads():
    tracer = Tracer()
    threads = [threading.Thread(target=lambda: [tracer.count("n") for _ in range(1000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    tracer.count("m", 5)
    assert tracer.counters() == {"n": 4000, "m": 5}


def test_export_chrome_writes_spans_and_profiler_events(tmp_path):
    """The spans as "X" events on the program's track, the profiler's on
    theirs, in us from the earliest stamp of either, on one clock."""
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("outer", tickets=[0, None]):
            with tracer.span("inner"):
                torch.ones(4) + 1
    tracer.export_chrome(str(tmp_path / "trace.json"), prof)
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert names == {"program spans", "host activity", "device"}
    spans = {e["name"]: e for e in events if e["ph"] == "X" and e["pid"] == 0}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"]["args"] == {"parent": "outer"}
    assert spans["outer"]["args"] == {"parent": None, "tickets": [0, None]}
    base = trace["otherData"]["base_ns"]
    outer = {r.name: r for r in tracer.records()}["outer"]
    assert spans["outer"]["ts"] == pytest.approx((outer.t0_ns - base) / 1e3, abs=1e-3)
    assert spans["outer"]["dur"] == pytest.approx((outer.t1_ns - outer.t0_ns) / 1e3, abs=1e-3)
    ops = [e for e in events if e["ph"] == "X" and e["pid"] == 1]
    add = [e for e in ops if e["name"] == "aten::add"]
    assert add and min(e["ts"] for e in events if e["ph"] == "X") >= 0
    # the operator ran inside the span that issued it
    s = spans["inner"]
    assert s["ts"] <= add[0]["ts"] and add[0]["ts"] + add[0]["dur"] <= s["ts"] + s["dur"]
    tracer.export_chrome(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        assert {e["pid"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"} == {0}


def test_tiny_search_leaves_every_span(problem):
    """Set-up's spans, and each step's vary, evaluation (its models within)
    and survive with their parents and rows."""
    TRACER.reset()
    problem.generator.encode_targets(["a red flower", "a blue car"])
    algorithm = problem.make_algorithm()
    gen = algorithm.generator(0)
    state = algorithm.init(gen)
    step = algorithm.step_fn()
    for _ in range(2):
        state = step(state, gen)
    got = _by_name(TRACER.records())
    assert [r.attrs for r in got["setup.targets"]] == [{"n": 2}]
    steps = got["search.step"]
    assert len(steps) == 2 and all(r.parent is None for r in steps)
    for name in ("search.vary", "search.survive"):
        assert [(r.parent, r.attrs) for r in got[name]] == [("search.step", {"search": 0})] * 2
    evals = got["fitness.eval"]
    assert [(r.parent, r.attrs) for r in evals] == (
        [(None, {"rows": POP})] + [("search.step", {"rows": POP})] * 2)
    for name in ("models.G", "models.CLIP", "models.D"):
        assert [(r.parent, r.attrs) for r in got[name]] == [("fitness.eval", {"rows": POP})] * 3
    for s in steps:   # each step's children lie inside it
        inside = [r for r in TRACER.records() if s.t0_ns <= r.t0_ns and r.t1_ns <= s.t1_ns
                  and r != s]
        assert sorted({r.name for r in inside}) == [
            "fitness.eval", "models.CLIP", "models.D", "models.G", "search.survive",
            "search.vary"]


def test_generator_setup_spans():
    """Generator.__init__ stages its weights under `setup.stage` and encodes
    its target under `setup.targets`, outside it."""
    cfg = get_config("StyleGAN2_ffhq_nod").replace(pop_size=POP, dim_z=32, n_var=32,
                                                   weights="random:0", target="a face",
                                                   compute_dtype="float32")
    GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)
    got = _by_name(TRACER.records())
    assert [(r.parent, r.attrs) for r in got["setup.stage"]] == [(None, {})]
    assert [(r.parent, r.attrs) for r in got["setup.targets"]] == [(None, {"n": 1})]
    assert got["setup.stage"][0].t1_ns <= got["setup.targets"][0].t0_ns
    assert TRACER.totals()["setup.stage"].count == 1


def test_tiny_server_spans_tickets_and_queue_wait(problem):
    """Two slots, three requests: the third waits a tick in the queue. The
    ticks, admissions and harvests carry their tickets; each batched step
    has a vary and a survive a slot; the server counts the admissions and
    their queue waits."""
    server = SearchServer(problem, n_slots=2, chunk=1, seed=0)
    TRACER.reset()
    tickets = [server.submit(t, n_gen=1) for t in ("a red flower", "a blue car", "an owl")]
    server.run()
    assert sorted(server.results) == tickets
    got = _by_name(TRACER.records())
    assert [r.attrs for r in got["serve.admit"]] == [{"tickets": [0, 1]}, {"tickets": [2]}]
    assert [r.attrs for r in got["serve.harvest"]] == [{"tickets": [0, 1]}, {"tickets": [2]}]
    ticks = [r.attrs["tickets"] for r in got["serve.tick"]]
    assert ticks[:3] == [[0, 1], [2, None], [None, None]]
    assert all(r.parent == "serve.tick" for n in ("serve.admit", "serve.harvest", "search.step")
               for r in got[n])
    assert {(r.parent, r.attrs["search"]) for r in got["search.vary"]} == {
        ("search.step", 0), ("search.step", 1)}
    assert len(got["search.survive"]) == len(got["search.vary"]) == 2 * len(got["search.step"])
    evals = [(r.parent, r.attrs["rows"]) for r in got["fitness.eval"]]
    assert evals.count(("serve.admit", 2 * POP)) == 1 and evals.count(("serve.admit", POP)) == 1
    assert evals.count(("search.step", 2 * POP)) == len(got["search.step"])
    assert [r.attrs for r in got["setup.targets"]] == [{"n": 2}, {"n": 1}]
    stats = server.stats
    assert stats.admissions == 3
    waits = [server.times[t][1] - server.times[t][0] for t in tickets]
    assert stats.queue_wait_ns == sum(waits) and waits[2] > max(waits[:2]) > 0
    assert all(s <= a <= h for s, a, h in server.times.values())
    assert all(isinstance(v, int) for v in vars(stats).values())


def test_kernels_load_span_and_build_counter(tmp_path, monkeypatch):
    """The library's first load is a `kernels.load` span, `built` when nvcc
    ran; each nvcc run (one a source, one link) counts in `kernels.builds`.
    nvcc is a script here that writes its output file, and the library a
    stand-in."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; '
                    'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(cuda, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(**{
                            n: types.SimpleNamespace() for n in (*cuda._SIGNATURES,
                                                                 "cg_error_string")}))
    for built in (True, False):
        monkeypatch.setattr(cuda, "_lib", None)
        TRACER.reset()
        lib = cuda.library()
        assert cuda.library() is lib
        loads = [r for r in TRACER.records() if r.name == "kernels.load"]
        assert [r.attrs for r in loads] == [{"built": built}]
        assert TRACER.counters() == ({"kernels.builds": len(cuda.SOURCES) + 1} if built else {})
    assert os.path.exists(cuda.library_path())


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"tracing_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _filled_tracer(monkeypatch) -> Tracer:
    """A tracer on a clock the test moves: set-up staged in 3 s and 1 s,
    a first evaluation of 5 s, then three steps of two searches: vary
    (2 + 3, 1 + 5, 50 + 50 ms), evaluation (7, 9, 8 ms), survive
    (0.5 + 0.5, 1 + 1, 1 + 2 ms)."""
    clock = [10 ** 18]
    monkeypatch.setattr(profiling, "now_ns", lambda: clock[0])
    tracer = Tracer()
    monkeypatch.setattr(profiling, "TRACER", tracer)

    def span(name, ms, **attrs):
        with tracer.span(name, **attrs):
            clock[0] += int(ms * 1e6)

    span("setup.stage", 3000)
    span("setup.targets", 2)
    span("setup.stage", 1000, part="int8")
    span("fitness.eval", 5000, rows=16)
    for vary, ev, survive in (((2, 3), 7, (0.5, 0.5)), ((1, 5), 9, (1, 1)),
                              ((50, 50), 8, (1, 2))):
        with tracer.span("search.step"):
            for i, ms in enumerate(vary):
                span("search.vary", ms, search=i)
            span("fitness.eval", ev, rows=16)
            for i, ms in enumerate(survive):
                span("search.survive", ms, search=i)
    span("fitness.eval", 11, rows=8)   # an admission's: no step holds it
    return tracer


@pytest.mark.parametrize("name,want", list(zip(METRICS, (6.0, 2.0, 8.0, 4.0, 5.0))))
def test_metric_reads_the_program_spans(monkeypatch, name, want):
    _filled_tracer(monkeypatch)
    assert _reader(name)({}) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_none_without_spans(monkeypatch, name):
    """An empty tracer, and a port without one (the parent commit's), read
    None and raise nothing."""
    monkeypatch.setattr(profiling, "TRACER", Tracer())
    read = _reader(name)
    assert read({}) is None
    monkeypatch.delattr(profiling, "TRACER")
    assert read({}) is None


@pytest.mark.gpu
def test_spans_and_device_events_share_one_clock():
    """A span around a sleep kernel and a synchronize, under a profiler
    that records CUDA activity alone: the kernel's device interval lies
    inside the span's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracer.span("sleep"):
            torch.cuda._sleep(100_000_000)
            torch.cuda.synchronize()
    (span,) = tracer.records()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler saw no device activity"
    for s, e in kernels:
        assert span.t0_ns <= s < e <= span.t1_ns, (span, s, e)
    # the sleep is most of the span: the clocks agree to far less than it
    assert max(e for _, e in kernels) - min(s for s, _ in kernels) > 0.5 * (
        span.t1_ns - span.t0_ns)
