"""One run of one cell: set-up, the measured window, the traced phases, the
output check, and the result line's fields.

Everything a cell needs is found by name: `BENCHMARK.json`'s workload
names its configuration (`benchmark/configs/<config>.json`, whose `family`
names its model family's module, `benchmark/families/<family>.py`) and
traffic mix (`benchmark/traffic/<traffic>.json`); the cell's limits are in
`benchmark/limits/<workload>.json`; each per-layer metric's reader is
`benchmark/metrics/<metric>.py`.

A model family may add (benchmark/families/__init__.py): `draw_targets`,
the run's targets in place of text prompts (image files, written into a
directory the run owns and removes when it ends), `GENERATOR_OUTPUT`,
the port's call whose results the window keeps for the output check, and
`LAYER_FUNCTIONS`, the port's functions whose device time a traced run
reads beside the harness's own (harness/trace.py).
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import random
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, Optional

import torch

from benchmark.families import family, replace_fields
from benchmark.harness import check, prompts, weights
from benchmark.harness.drivers import DRIVERS
from benchmark.harness.trace import Tap, busy_intervals, device_timeline, idle_gaps_by_span
from benchmark.yardstick import kernels, peaks

BENCH = Path(__file__).resolve().parents[1]
NAME = 160   # characters of a kernel's name kept in the breakdown
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def reader(metric: str, bench: Path = BENCH):
    """The `read(ctx)` of benchmark/metrics/<metric>.py."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ------------------------------------------------------------------ set-up

def make_weights(config: dict, seed: int, device, log=None) -> dict:
    """The models' trees for `config`, drawn on `device` from `seed`: CLIP's,
    then the model family's (benchmark/families/); `log` takes the
    family's lines about its draw."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    out = {"clip": weights.materialize(weights.clip_spec(config["clip"], config["assumed"]),
                                       gen)}
    out.update(family(config).make_weights(config, gen, log))
    return out


def draw_targets(config: dict, seed: int, n: int, workdir: Path) -> list:
    """The run's n targets, from the seed's "prompts" stream: the family's
    `draw_targets(config, rng, n, workdir)` where it has one, else n text
    prompts (harness/prompts.py)."""
    rng = random.Random(sub_seed(seed, "prompts"))
    fam = family(config)
    if hasattr(fam, "draw_targets"):
        return fam.draw_targets(config, rng, n, workdir)
    return prompts.draw(rng, n)


def build_problem(config: dict, traffic: dict, bundle: dict, target: str, seed: int, device):
    """The port's GenerationProblem of `config` at the traffic's population,
    its weights handed in as a bundle; every field of the port's search
    config that the file's `search` group names (`quantize` among them) is
    taken as it stands."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model

    cfg = replace_fields(get_config(config["registry"]), config["search"]).replace(
        target=target, pop_size=traffic["pop"], compute_dtype=config["dtype"],
        seed=seed % 2 ** 31)
    clip_cfg = replace_fields(clip_model.VIT_B_32, config["clip"])
    model_cfg = replace_fields(family(config).model_config(config), config.get("program", {}))
    return GenerationProblem(cfg, device=device, clip_cfg=clip_cfg, model_cfg=model_cfg,
                             bundle=bundle)


# -------------------------------------------------------------------- run

@dataclasses.dataclass
class Run:
    """What a run measured and checked, for the result line."""
    metrics: Dict[str, dict]
    checks: Dict[str, dict]
    attempted: int
    failed: int
    device: dict
    breakdown: Optional[dict]
    notes: Dict[str, float]
    # every number compared or not, and the controls' (readings.py)
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    controls: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # each checked row's gaps, the port's and the controls' (readings.py)
    rows: Dict[str, Dict[str, list]] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(c["ok"] for c in self.checks.values())


def run_cell(bench: dict, workload: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: torch.device, bench_dir: Path = BENCH, log=print,
             controls=()) -> Run:
    """One run. Each of `controls` (reference precisions, "fp8") puts the
    reference at that precision in the port's place on the same genomes,
    its numbers judged alike (`Run.controls`): the readings the limits are
    set from. The run's target files live in a temporary directory that
    is removed when the run ends."""
    with tempfile.TemporaryDirectory(prefix="benchmark-targets-") as workdir:
        return _run_cell(bench, workload, seed, seconds, trace, t_start, device, bench_dir,
                         log, controls, Path(workdir))


def _run_cell(bench: dict, workload: dict, seed: int, seconds: float, trace: bool,
              t_start: float, device: torch.device, bench_dir: Path, log, controls,
              workdir: Path) -> Run:
    config = load_json(bench_dir / "configs" / f"{workload['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{workload['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{workload['name']}.json")
    fam = family(config)
    search_seed = sub_seed(seed, "search")
    targets = draw_targets(config, seed, traffic.get("requests", 1), workdir)

    trees = make_weights(config, seed, device, log)
    problem = build_problem(config, traffic, trees, targets[0], search_seed, device)
    # the reference's copy waits on the host, so that the window holds only
    # what the port holds
    ref_weights = check.to_device(trees, "cpu")
    del trees
    tap = Tap(device, getattr(fam, "LAYER_FUNCTIONS", ()))
    driver = DRIVERS[traffic["kind"]](problem, traffic, targets, search_seed, tap)
    driver.setup()
    tap.sync()
    X_start = driver.population().clone()
    counters0 = driver.counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    tap.recording = True
    units = cands = 0
    with tap.phase("timed") if trace else nullcontext(), \
            tap.capture(getattr(fam, "GENERATOR_OUTPUT", None)):
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            cands += driver.advance()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        tap.sync()
        window_s = time.perf_counter() - t0
    tap.recording = False
    mem_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counters = {k: v - counters0[k] for k, v in driver.counters().items()}
    X_end = driver.population().clone()
    rate = cands / window_s
    ctx = {"rate": rate, "counters": counters, "gens": tap.gens, "mem_peak": mem_peak,
           "fpc": fam.flops_per_candidate(config),
           "peak": peaks.bf16_peak(torch.cuda.get_device_name(device))
           if device.type == "cuda" else None}
    breakdown = None
    if trace:
        ctx["spans"] = {name: tap.device_seconds(name) for name in list(tap.events)}
        ctx.update(_profiled(driver, tap, traffic))
        breakdown = ctx.pop("breakdown")

    # the output check, on a sample of the window's evaluations
    rng = random.Random(sub_seed(seed, "check"))
    n = len(tap.evals)
    attempted = sum(F.shape[0] * (F.shape[1] if F.dim() == 3 else 1) for _, F, *_ in tap.evals)
    failed = sum(int((~torch.isfinite(F).all(-1)).sum()) for _, F, *_ in tap.evals)
    # evaluations drawn from the seed among the window's first
    # `check_window`, so that the generations checked do not depend on how
    # fast the port is (the gaps grow as a search moves); none when the
    # window evaluated nothing, and then no number compares
    reach = min(n, traffic["check_window"])
    picked = sorted(rng.sample(range(reach), min(traffic["check_evaluations"], reach)))
    sample = [_checked(*tap.evals[i]) for i in picked]
    moved = check.moved_rows(X_start, X_end)
    tap.evals = None
    driver.close()
    del driver, problem, X_start, X_end
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = check.to_device(ref_weights, device)
    rows: Dict[str, list] = {}
    control_rows: Dict[str, Dict[str, list]] = {c: {} for c in controls}
    share = []
    logit = []
    block = traffic["check_block"]
    for X, F_prog, per_search, outputs in sample:
        X = X.to(device)
        out = check.reference_fitness(config, ref, X, per_search, block,
                                      outputs=None if outputs is None else outputs.to(device))
        F_ref = out["F"].cpu()
        _gather(rows, check.row_gaps(F_prog, F_ref), out["margins"])
        for c in controls:
            out_c = check.reference_fitness(config, ref, X, per_search, block, precision=c)
            base, margins = F_ref, None
            if out_c["outputs"] is not None:
                # the control's own generator outputs, judged as the port's are
                judged = check.reference_fitness(config, ref, X, per_search, block,
                                                 outputs=out_c["outputs"])
                base, margins = judged["F"].cpu(), judged["margins"]
            _gather(control_rows[c], check.row_gaps(out_c["F"].cpu(), base), margins)
        if out["clip_share"] is not None:
            share.append(out["clip_share"].item())
        if out["logit_max"] is not None:
            logit.append(out["logit_max"].item())
    del ref
    clip_share = sum(share) / len(share) if share else None
    logit_max = max(logit) if logit else None
    log(json.dumps({"draw": {"clip_share": clip_share, "d_logit_max": logit_max,
                             "saturated": check.saturated(clip_share, logit_max)}}))
    if check.saturated(clip_share, logit_max):
        raise RuntimeError(f"the weights drawn from seed {seed} saturate: {clip_share} of "
                           f"the pixels at the clip limits, D's largest logit {logit_max}")
    row_gaps = {k: torch.cat(v) for k, v in rows.items()}
    control_row_gaps = {c: {k: torch.cat(v) for k, v in g.items()}
                        for c, g in control_rows.items()}
    values = {**check.summarize(row_gaps), "moved_rows": moved}
    log(json.dumps({"values": values}))
    checks = check.judge(values, limits)
    control_values = {c: {**check.summarize(g), "moved_rows": moved}
                      for c, g in control_row_gaps.items()}

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": workload["chips"], "memory_peak_bytes": int(mem_peak)}
    if trace:
        dev["busy_s"], dev["window_s"] = ctx["busy_s"], ctx["window_s"]
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and workload["name"] not in m["workloads"]:
                continue
            value = reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"cand_per_s": {"value": rate, "unit": "cand/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    return Run(metrics=metrics, checks=checks, attempted=attempted, failed=failed, device=dev,
               breakdown=breakdown, values=values, controls=control_values,
               rows={"port": _per_row(row_gaps),
                     **{c: _per_row(g) for c, g in control_row_gaps.items()}},
               notes={"window_s": window_s, "units": units, "setup_s": setup_s,
                      "evaluations": n, "checked": len(sample)})


def result_line(run: Run) -> dict:
    """The result line's object: the keys the contract reads, then the run's
    notes, then the compared numbers beside their limits, last."""
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": run.metrics, "device": run.device}
    if run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["notes"] = run.notes
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in run.checks.items()}
    return out


def _searches(t: torch.Tensor) -> torch.Tensor:
    """An evaluation's tensor with a leading search axis."""
    return t if t.dim() == 3 else t[None]


def _checked(X, F, targets, outputs):
    """A recorded evaluation on the host for the check: X and F with a
    leading search axis, the targets, and the generator outputs joined and
    laid out [K, pop, ...] (None where none were captured)."""
    X, F = _searches(X).cpu(), _searches(F).cpu()
    if outputs is not None:
        outputs = torch.cat(outputs).reshape(*X.shape[:2], -1).cpu()
    return X, F, targets, outputs


def _gather(rows: Dict[str, list], gaps: Dict[str, torch.Tensor], margins) -> None:
    """Add an evaluation's row gaps, and its decode margins [rows, steps]
    where the family judges generator outputs, to `rows`."""
    for k, v in gaps.items():
        rows.setdefault(k, []).append(v)
    if margins is not None:
        rows.setdefault("margin", []).append(
            torch.nan_to_num(margins.cpu().double(), nan=float("inf")))


def _per_row(gaps: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """Each row's gaps, a row's decode margin its largest step's."""
    return {k: (v.amax(-1) if k == "margin" else v).tolist() for k, v in gaps.items()}


def _profiled(driver, tap: Tap, traffic: dict) -> dict:
    """The profiled phase: `profile_units` units (at least one) under
    torch.profiler with CUDA activity only."""
    from torch.profiler import ProfilerActivity, profile

    # CUDA activity only on the card: host-side operator records slow the host
    cuda = tap.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with tap.phase("profiled"):
            tap.sync()
            t0 = time.time_ns()
            for _ in range(traffic["profile_units"]):
                driver.advance()
            tap.sync()
            t1 = time.time_ns()
    timeline = [t for t in device_timeline(prof) if t[2] > t0 and t[1] < t1]
    busy = busy_intervals(timeline)
    busy_s = sum(min(e, t1) - max(s, t0) for s, e in busy) / 1e9
    by_name: Dict[str, float] = {}
    for name, s, e in timeline:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    gaps = idle_gaps_by_span(busy, tap.host, t0, t1)
    kernel_s = {k: sum(v for n, v in by_name.items() if k in n) for k in kernels.COSTS}
    least = {k: sum(kernels.least_seconds(*kernels.COSTS[k](*rec)) for rec in recs)
             for k, recs in tap.kernel_calls.items()}
    return {"busy_s": busy_s, "window_s": (t1 - t0) / 1e9, "kernel_s": kernel_s,
            "kernel_least_s": least,
            "breakdown": {
                "device_ops": sorted(([n[:NAME], s] for n, s in by_name.items()),
                                     key=lambda t: -t[1])[:10],
                "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda t: -t[1])[:10]}}
