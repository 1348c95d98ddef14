#!/usr/bin/env python3
"""Run the port's benchmark matrix and print one consolidated JSON table.

The counterpart of scripts/bench_matrix.py for the PyTorch/CUDA port. Each
row is a `bench_torch.py` subprocess (one process a row) over the same
rows: the flagship StyleGAN2_ffhq_d at pop 16 / 32 / 64,
both BigGAN-deep configs, GPT-2 img2txt, K searches batched, and with
--int8 each row again under BENCH_QUANT=int8 (not GPT2: no eligible conv).

  python3 scripts/bench_matrix_torch.py [--rows flagship16,gpt2,...] [--int8]
                                        [--out table.json] [--device cuda]
  python3 scripts/bench_matrix_torch.py --list

Ambient BENCH_* variables are dropped, so a row gets only its own.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = {
    # name: BENCH_* variables for bench_torch.py (scripts/bench_matrix.py:25-35)
    "flagship16": {},
    "flagship32": {"BENCH_POP": "32", "BENCH_MICROBATCH": "32"},
    "flagship64": {"BENCH_POP": "64"},
    "biggan256": {"BENCH_CONFIG": "DeepMindBigGAN256", "BENCH_POP": "64"},
    "biggan512": {"BENCH_CONFIG": "DeepMindBigGAN512", "BENCH_POP": "256"},
    "gpt2": {"BENCH_CONFIG": "GPT2"},
    "batched_k4": {"BENCH_TARGETS": "4"},
    "batched_k8": {"BENCH_TARGETS": "8"},
    "batched_k16_mb8": {"BENCH_TARGETS": "16", "BENCH_SEARCH_MB": "8"},
}


def run_row(name: str, extra: dict, device: str) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(ROWS[name])
    env.update(extra)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                           "--device", device], env=env, capture_output=True, text=True)
    line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")),
                None)
    if proc.returncode or line is None:
        return {"error": proc.returncode, "tail": proc.stderr.splitlines()[-3:]}
    return json.loads(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated row names (default: all)")
    ap.add_argument("--int8", action="store_true",
                    help="also run each row with BENCH_QUANT=int8")
    ap.add_argument("--out", default="", help="write the table here too")
    ap.add_argument("--device", default="cuda", help="passed to bench_torch.py")
    ap.add_argument("--list", action="store_true", help="print the rows and exit")
    args = ap.parse_args(argv)
    if args.list:
        print(json.dumps(ROWS, indent=1))
        return 0
    rows = [r.strip() for r in args.rows.split(",") if r.strip()]
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        ap.error(f"unknown rows: {unknown}; known: {list(ROWS)}")

    variants = [("bf16", {})] + ([("int8", {"BENCH_QUANT": "int8"})] if args.int8 else [])
    table = {}
    for name in rows:
        for vname, venv in variants:
            if name == "gpt2" and vname == "int8":
                continue
            key = name if vname == "bf16" else f"{name}_{vname}"
            table[key] = run_row(name, venv, args.device)
            v = table[key].get("value")
            print(f"{key}: {v if v is not None else table[key]}", file=sys.stderr, flush=True)
    out = json.dumps(table, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
