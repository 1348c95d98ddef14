#!/usr/bin/env python3
"""The port's CLI wall clock: the median of N hot `run_torch.py` runs.

The counterpart of scripts/bench_wallclock.py. One pre-warm run, discarded
(it builds the kernels into build/ and fills the file caches), then N timed
runs of the same command (`run_torch.py --config C --target "the face of a
man with brown eyes" --generations G --save-each S --tmp-folder <tmp>
--verbose --device D`, with `--weights random:0`, or `--tiny`). Each run's
time is the CLI's own `wallclock: total=` line, from the start of its
`main()`: the package's imports included (its `imports` phase), the
interpreter's start left out; its steady rate the last `rate: X gen/s`
line (it needs a dump after the first).

Prints one JSON line: median, min and max seconds, the spread, each run's
seconds, the median steady rate, the median of each wall-clock phase.

  python3 scripts/bench_wallclock_torch.py [--runs 5] [--generations 200]
      [--save-each 50] [--config StyleGAN2_ffhq_d] [--tiny] [--device cuda]
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_once(args, idx: int) -> dict:
    with tempfile.TemporaryDirectory(prefix=f"wallclock{idx}_") as tmp:
        argv = [sys.executable, os.path.join(ROOT, "run_torch.py"),
                "--config", args.config, "--target", "the face of a man with brown eyes",
                "--generations", str(args.generations), "--save-each", str(args.save_each),
                "--tmp-folder", tmp, "--verbose", "--device", args.device]
        argv += ["--tiny"] if args.tiny else ["--weights", "random:0"]
        r = subprocess.run(argv, capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"run {idx} rc {r.returncode}: {r.stderr[-800:]}")
    total = re.search(r"wallclock: total=([0-9.]+)s", r.stdout)
    if not total:
        raise RuntimeError(f"run {idx}: no wallclock line in its output:\n{r.stdout[-800:]}")
    rate = re.findall(r"rate: ([0-9.]+) gen/s", r.stdout)
    line = r.stdout[total.start():].splitlines()[0]
    phases = {k: float(v) for k, v in re.findall(r" ([\w+()]+)=([0-9.]+)s", line)
              if k != "total"}
    return {"total_s": float(total.group(1)), "rate_gen_s": float(rate[-1]) if rate else None,
            "phases": phases}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--generations", type=int, default=200)
    p.add_argument("--save-each", type=int, default=50)
    p.add_argument("--config", default="StyleGAN2_ffhq_d")
    p.add_argument("--tiny", action="store_true",
                   help="the TINY models (a smoke run of the protocol, not the claim)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; the CLI raises without a card) or cpu")
    args = p.parse_args(argv)

    print(f"# pre-warm (discarded): {args.config} {args.generations} gens", file=sys.stderr)
    run_once(args, -1)
    results = []
    for i in range(args.runs):
        results.append(run_once(args, i))
        print(f"# run {i}: {results[-1]}", file=sys.stderr)

    totals = [r["total_s"] for r in results]
    rates = [r["rate_gen_s"] for r in results if r["rate_gen_s"]]
    median = statistics.median(totals)
    out = {
        "metric": (f"cli_wallclock ({args.config}, {args.generations} gens, "
                   f"{'TINY, ' if args.tiny else ''}--device {args.device}, median of "
                   f"{len(totals)} hot runs)"),
        "median_s": median,
        "min_s": min(totals),
        "max_s": max(totals),
        "spread_pct": 100 * (max(totals) - min(totals)) / median,
        "median_rate_gen_s": statistics.median(rates) if rates else None,
        "per_run_s": totals,
        "median_phase_s": {k: statistics.median(r["phases"].get(k, 0.0) for r in results)
                           for k in results[0]["phases"]},
        "runs": len(totals),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
