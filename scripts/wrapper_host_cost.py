#!/usr/bin/env python3
"""Host cost of one call of the `upsample2x` and `modulated_matmul` wrappers
on one GPU, for one or more checkouts of the repo in turn.

Each checkout runs in a process of its own (its own `clip_glass_torch`, its
own kernel build) and times 1000 calls of each wrapper at the flagship's
4 px shapes with `chip_smoke.host_us` of this checkout: the wall clock with
no synchronisation inside the loop and one after. Prints one JSON line per
checkout. To compare two trees on the same card, name both, e.g. the parent
unpacked by `git archive` and this tree, in the order parent, change,
change, parent:

    python3 scripts/wrapper_host_cost.py build/parent . . build/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str) -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's timing loop (imports torch only)
    import torch

    sys.path.insert(0, os.path.abspath(root))  # the package under test
    from clip_glass_torch.ops import modulated_conv, upfirdn

    gen = torch.Generator(device="cuda").manual_seed(0)
    ups = chip_smoke._ups_case((16, 4, 4, 3), torch.bfloat16, gen)
    rgb = chip_smoke._rgb_case((16, 16, 512, 3), torch.bfloat16, gen)
    return {"root": root,
            "package": os.path.dirname(os.path.dirname(upfirdn.__file__)),
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": chip_smoke.smi_line(),
            "host_us_per_call": {
                "upsample2x": chip_smoke.host_us(lambda: upfirdn.upsample2x(*ups)),
                "modulated_matmul": chip_smoke.host_us(
                    lambda: modulated_conv.modulated_matmul(*rgb))}}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    for root in argv or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
