"""The readings that the output check's limits are set from: run a cell on
many seeds in one process, the port as the configuration states it, and
print each run's numbers as a JSON line, beside those of the control: the
reference computed with fp8 operands (`--controls fp8`, the default; one
precision below the configuration's bf16), put in the port's place on the
same genomes and judged alike. `--rows FILE` adds each run's per-row gaps.

    python3 benchmark/tools/readings.py --workload <name> --seconds 30 \\
        --seeds 11 12 13 [--rows FILE]
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rows", help="a file to which each run's per-row gaps are added")
    p.add_argument("--controls", nargs="*", default=["fp8"],
                   help="reference operand precisions judged on the same genomes")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.cell import run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = next(w for w in bench["workloads"] if w["name"] == args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = run_cell(bench, workload, seed, args.seconds, False, t0, torch.device("cuda", 0),
                       log=lambda s: print(s, file=sys.stderr), controls=tuple(args.controls))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": run.correct,
                          "values": run.values, "controls": run.controls,
                          "cand_per_s": run.metrics["cand_per_s"]["value"],
                          "setup_s": run.metrics["setup_s"]["value"],
                          "memory_peak_bytes": run.device["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        if args.rows:
            with open(args.rows, "a") as f:
                f.write(json.dumps({"seed": seed, "rows": run.rows}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
