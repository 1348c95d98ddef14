"""The port's bench (bench_torch.py), its entry points (clip_glass_torch/
entry.py) and the port's bench scripts (scripts/bench_*_torch.py) on the CPU,
at TINY sizes: bench.py's schema, the rate's arithmetic, the checksum
against `minimize`, the refusal without a card, the entry's draw and config
against the JAX package's `__graft_entry__.entry`. The full-size entry
against JAX's is `slow`."""

import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import clip_glass_tpu.fitness.problem as jproblem

import bench_torch
import clip_glass_torch.fitness.problem as tproblem
from clip_glass_torch import entry as tentry
from clip_glass_torch.core import flops
from clip_glass_torch.evolve.algorithm import minimize
from clip_glass_torch.evolve.batched import make_batched, minimize_batched
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = {"clip_cfg": tclip.TINY, "model_cfg": tsg2.TINY}
# bench.py's keys (bench.py:169-189, 191-197)
SCHEMA = {"metric", "value", "unit", "vs_baseline", "model_gflops_per_candidate",
          "model_tflops_per_sec_per_chip", "device_kind", "mfu"}


def _tiny_config(pop=8):
    return bench_torch.bench_config("StyleGAN2_ffhq_d", pop).replace(dim_z=32, n_var=32)


def _measure(n_targets=1, repeats=2, gens=2, **kw):
    return bench_torch.measure(_tiny_config(), 8, gens, repeats, n_targets=n_targets,
                               device="cpu", **TINY, **kw)


@pytest.fixture(scope="module")
def single():
    return _measure(checksum=True)


def test_measure_gives_bench_schema_on_the_cpu(single):
    assert SCHEMA <= set(single) and "checksum_F" in single
    assert single["vs_baseline"] is None and single["mfu"] is None
    assert single["device_kind"] == "cpu" and single["unit"] == "candidates/s/chip"
    assert single["metric"].startswith("candidates_scored_per_sec_per_chip (StyleGAN2_ffhq_d")
    fpc = flops.fitness_flops_per_candidate(_tiny_config(), tsg2.TINY, tclip.TINY)
    assert single["model_gflops_per_candidate"] == fpc / 1e9
    assert single["model_tflops_per_sec_per_chip"] == fpc * single["value"] / 1e12
    # the plain versions run on the CPU: no kernel launches
    assert set(single["launches_per_evaluation"].values()) == {0.0}
    json.dumps(single)


def test_rate_is_candidates_over_the_fastest_window(single):
    assert len(single["repeat_s"]) == 2 and single["best_s"] == min(single["repeat_s"])
    assert single["value"] == 8 * 1 * 2 / single["best_s"]
    assert single["evaluations_timed"] == 4


def test_rate_counts_every_batched_search():
    out = _measure(n_targets=2, repeats=1)
    assert out["value"] == 8 * 2 * 2 / out["best_s"]
    assert out["metric"].endswith("2 searches batched)")


def _f_sum(F):
    return f"{float(np.asarray(F, dtype=np.float64).sum()):.17g}"


def _assert_checksums_of(out, F):
    F = np.ascontiguousarray(F, dtype=np.float32)
    assert out["checksum_F"] == _f_sum(F)
    assert out["checksum_F_columns"] == [_f_sum(F[..., j]) for j in range(F.shape[-1])]
    assert out["sha256_F"] == hashlib.sha256(F.tobytes()).hexdigest()


def test_checksum_equals_minimize_from_the_same_seed():
    """Warm-up + gens generations of `minimize` from seed 0 end at the bench's F."""
    out = _measure(repeats=1, checksum=True)
    problem = tproblem.GenerationProblem(_tiny_config(), device="cpu", **TINY)
    res = minimize(problem.make_algorithm(), bench_torch.WARMUP + 2, 0)
    _assert_checksums_of(out, res.pop_F.numpy())


def test_checksum_batched_equals_minimize_batched():
    out = _measure(n_targets=2, repeats=1, checksum=True)
    problem = tproblem.GenerationProblem(_tiny_config(), device="cpu", **TINY)
    balgo = make_batched(problem, bench_torch._targets(_tiny_config(), 2))
    res = minimize_batched(balgo, bench_torch.WARMUP + 2, 0)
    _assert_checksums_of(out, np.stack([r.pop_F.numpy() for r in res]))


def test_hash_sees_what_the_sum_does_not():
    """A change below the float64 sum's spacing, as in one similarity beside
    a hinge of 1e21, leaves checksum_F as it was; the column sums and the
    hash see it."""
    F = torch.tensor([[-0.25, 1.2e21], [-0.5, 0.0]])
    G = F.clone()
    G[1, 0] = torch.nextafter(G[1, 0], torch.tensor(0.0))
    a, b = bench_torch.checksums(F), bench_torch.checksums(G)
    assert a["checksum_F"] == b["checksum_F"]
    assert a["checksum_F_columns"][0] != b["checksum_F_columns"][0]
    assert a["checksum_F_columns"][1] == b["checksum_F_columns"][1]
    assert a["sha256_F"] != b["sha256_F"]
    assert bench_torch.checksums(F.clone()) == a


def test_bench_config_follows_bench_py():
    c = bench_torch.bench_config()
    assert (c.name, c.pop_size, c.compute_dtype, c.weights, c.eval_microbatch) == \
        ("StyleGAN2_ffhq_d", 16, "bfloat16", "random:0", None)
    assert bench_torch.bench_config(pop=64).eval_microbatch == 32
    assert bench_torch.bench_config(pop=64, microbatch=16).eval_microbatch == 16
    assert bench_torch.bench_config("DeepMindBigGAN512", 256).eval_microbatch == 32
    assert bench_torch.bench_config("DeepMindBigGAN256", 64).eval_microbatch is None
    g = bench_torch.bench_config("GPT2")
    assert g.pop_size == 100 and g.target.endswith("dog.jpeg")
    q = bench_torch.bench_config(quant="int8", quant_min_ch=32)
    assert (q.quantize, q.quantize_min_ch) == ("int8", 32)


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_GENS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


class _Captured:
    """A GenerationProblem that keeps its config and builds no model."""
    configs = []

    def __init__(self, config, device=None, **_):
        self.configs.append(config)
        self.generator = types.SimpleNamespace(
            eval_population=lambda X, bundle=None: X, bundle={"g": None},
            device=torch.device("cpu"))


def test_entry_draw_and_config_equal_jax(monkeypatch):
    _Captured.configs = []
    monkeypatch.setattr(tproblem, "GenerationProblem", _Captured)
    monkeypatch.setattr(jproblem, "GenerationProblem", _Captured)
    _, (tX, _) = tentry.entry(device="cpu")
    _, (jX, _) = jentry.entry()
    jX = np.asarray(jX)
    assert tX.dtype == torch.float32 and jX.dtype == np.float32
    assert tX.shape == (4, 512) and np.array_equal(tX.numpy(), jX)
    tcfg, jcfg = _Captured.configs
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.name, tcfg.pop_size, tcfg.weights, tcfg.compute_dtype) == \
        ("StyleGAN2_ffhq_d", 4, "random:0", "bfloat16")


def test_entry_takes_fp32_for_the_agreement_checks(monkeypatch):
    _Captured.configs = []
    monkeypatch.setattr(tproblem, "GenerationProblem", _Captured)
    tentry.entry(device="cpu", compute_dtype="float32")
    (cfg,) = _Captured.configs
    assert (cfg.compute_dtype, cfg.pop_size, cfg.weights) == ("float32", 4, "random:0")


def test_entry_module_exports_the_dry_run():
    from clip_glass_torch.parallel.dryrun import dryrun_multichip

    assert tentry.dryrun_multichip is dryrun_multichip


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


# random:0 saturates the images and drives D's logits to ~1e20 (ROADMAP item
# 19), so each entry is held on its own scale. In fp32 each -similarity and
# each hinge lies within ENTRY_FP32_RTOL of JAX's; the port's card (TF32
# convs) and its CPU differed by up to 2.6e-2 and 6.3e-2 there
# (scripts/entry_agreement_torch.py; PERF.md §6, PR 16). In bf16 the roundings of ~60 saturated layers decide: the card and
# the CPU differed by up to 0.47 of a similarity and 0.63 of a hinge, more
# than the spread between candidates, so bf16 is held only to the shape,
# finite values and which hinges are 0 (D's logit at or above 1).
ENTRY_FP32_RTOL = 1e-2


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_full_size_F_against_jax(monkeypatch, dtype):
    # JAX's entry() has no dtype: its problem is built in `dtype`
    jcls = jproblem.GenerationProblem
    monkeypatch.setattr(jproblem, "GenerationProblem",
                        lambda config, *a, **kw: jcls(config.replace(compute_dtype=dtype),
                                                      *a, **kw))
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    fn, (X, bundle) = tentry.entry(device="cpu", compute_dtype=dtype)
    with torch.inference_mode():
        got = fn(X, bundle).float().numpy()
    jfn, (jX, jbundle) = jentry.entry()
    want = np.asarray(jfn(jX, jbundle), dtype=np.float32)
    assert got.shape == want.shape == (4, 2)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert ((got[:, 1] == 0) == (want[:, 1] == 0)).all(), (got, want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=ENTRY_FP32_RTOL, atol=0)


def _script(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("argv", [
    ["bench_torch.py", "--help"],
    ["scripts/bench_matrix_torch.py", "--list"],
    ["scripts/bench_serving_torch.py", "--help"],
    ["scripts/bench_serving_curve_torch.py", "--help"],
    ["scripts/bench_wallclock_torch.py", "--help"],
], ids=lambda a: a[0])
def test_scripts_start(argv):
    res = _script(*argv)
    assert res.returncode == 0, res.stderr
    if argv[1] == "--list":
        assert set(json.loads(res.stdout)) == {
            "flagship16", "flagship32", "flagship64", "biggan256", "biggan512", "gpt2",
            "batched_k4", "batched_k8", "batched_k16_mb8"}
    else:
        assert "usage" in res.stdout


def test_wallclock_script_gives_its_fields():
    res = _script("scripts/bench_wallclock_torch.py", "--tiny", "--device", "cpu", "--runs",
                  "2", "--generations", "2", "--save-each", "1", timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["runs"] == 2 and len(out["per_run_s"]) == 2
    assert out["min_s"] <= out["median_s"] <= out["max_s"]
    assert out["median_rate_gen_s"] > 0
    assert {"setup", "init(gen0)", "search+dumps", "final_artifacts"} <= set(
        out["median_phase_s"])


def test_serving_script_gives_its_fields():
    env = {"SERVE_SLOTS": "2", "SERVE_CHUNK": "1", "SERVE_REQUESTS": "3", "SERVE_GENS": "2",
           "SERVE_POP": "8"}
    res = subprocess.run([sys.executable, "scripts/bench_serving_torch.py", "--tiny",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), **env), timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["completed"] == 3 and out["occupancy"] == 0.75
    assert 0 < out["value"] <= out["raw_incl_padding"]


def _curve_module():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import bench_serving_curve_torch
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return bench_serving_curve_torch


def test_curve_ceiling_pays_each_admission():
    """K x pop x L useful candidates a wave of K requests, over one admission
    and L generations; with an admission as dear as a generation it is
    steady x L / (L + 1)."""
    curve = _curve_module()
    p = curve.curve_point(20, [90.0, 100.0, 95.0], slots=4, pop=16, gen_s=0.25, admit_s=0.25)
    steady = 4 * 16 / 0.25
    assert p["ceiling_adjusted"] == pytest.approx(steady * 20 / 21, rel=1e-12)
    assert p["median_useful_cand_s"] == 95.0 and (p["min"], p["max"]) == (90.0, 100.0)
    assert p["pct_of_steady"] == pytest.approx(100 * 95.0 / steady, rel=1e-12)
    cheap = curve.curve_point(20, [95.0], slots=4, pop=16, gen_s=0.25, admit_s=0.1)
    assert cheap["ceiling_adjusted"] == pytest.approx(4 * 16 * 20 / (0.1 + 20 * 0.25), rel=1e-12)
    assert cheap["ceiling_adjusted"] > p["ceiling_adjusted"]
    assert cheap["pct_of_adjusted_ceiling"] < p["pct_of_adjusted_ceiling"]
