#!/usr/bin/env python3
"""entry()'s F on the card against the port's own CPU F, entry by entry.

`clip_glass_torch.entry.entry()` (the flagship evaluation at pop 4, random
weights from seed 0) in fp32 and in bf16, once on the card and once on the
host with the kernels' plain versions. Prints one JSON line a dtype: both
F [4, 2], each entry's relative difference |card - cpu| / |cpu| and each
side's seconds (the card's first call builds its kernels). It shows how far
two correct implementations' F fall apart under random:0's saturation
(ROADMAP item 19): the scale on which the full-size agreement test of
tests/test_torch_bench.py holds the port to JAX.

  python3 scripts/entry_agreement_torch.py
"""

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from clip_glass_torch.entry import entry  # noqa: E402


def evaluate(device: str, compute_dtype: str):
    t = time.perf_counter()
    fn, (X, bundle) = entry(device=device, compute_dtype=compute_dtype)
    with torch.inference_mode():
        F = fn(X, bundle).float().cpu().numpy()
    return F, time.perf_counter() - t


def main() -> int:
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    for dtype in ("float32", "bfloat16"):
        card, card_s = evaluate("cuda", dtype)
        host, host_s = evaluate("cpu", dtype)
        rel = np.abs(card - host) / np.maximum(np.abs(host), np.finfo(np.float32).tiny)
        print(json.dumps({"compute_dtype": dtype, "F_card": card.tolist(),
                          "F_cpu": host.tolist(), "rel_diff": rel.tolist(),
                          "max_rel_diff_by_objective": rel.max(axis=0).tolist(),
                          "seconds": {"card": card_s, "cpu": host_s},
                          "device_kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
