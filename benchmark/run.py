"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
the port (`clip_glass_torch`). The cell's configuration, traffic, limits and
per-layer readers are found by name (benchmark/harness/cell.py).

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics. The last line of standard output is
the result, one JSON object; the last lines of standard error are the
numbers the output check compared, each beside its limit. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits 2; when the process holds JAX or the JAX package after the window,
it names them and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# nothing of the benchmark may load JAX (compared by top-level name: the
# port's name starts with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "clip_glass_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    workload = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if workload is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"the cell needs {workload['chips']} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from benchmark.harness.cell import result_line, run_cell

    print(json.dumps({"card": card_line(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), file=sys.stderr, flush=True)
    run = run_cell(bench, workload, args.seed, args.seconds, bool(args.trace), T_START,
                   torch.device("cuda", 0), log=lambda s: print(s, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"this process loaded {found}: the benchmark may not load JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    for name, c in run.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result = result_line(run)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
