#!/usr/bin/env python3
"""Where conv_s8's wgmma route spends its time: ablation builds on the card.

Builds copies of clip_glass_torch/csrc/conv_s8.cu, each with one part of the
wgmma route cut or resized, and times each copy's `cg_conv_s8_wgmma` (bf16
activation, bf16 output, the wrapper's packed weights) at the int8
flagship's largest sites. A cut copy computes wrong outputs; only its time
means something. The variants:

  base        the source as it is;
  no_load     the producers' global loads replaced by zeros (the gather's
              memory traffic gone, its quantization kept);
  no_quant    the bf16 quantization replaced by a bit mix of the loads;
  no_store    the epilogue's global stores skipped;
  no_epilogue the whole epilogue skipped (no dequantization, no stores);
  skeleton    no loads, no quantization, no epilogue: the rings, the
              barriers and the products alone;
  no_mma      the consumers' wgmma skipped;
  stages2/4   a ring of 2 or 4 stages instead of 6;
  producers3  three producer warpgroups instead of two.

Prints one JSON line per site ({"site": ..., "ms": {variant: ms}}) and the
card's name and power limit. Needs one CUDA card and nvcc.

Run: python3 scripts/conv_s8_ablation.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from clip_glass_torch.ops import cuda  # noqa: E402
from clip_glass_torch.ops.conv_s8 import (  # noqa: E402
    OUT_CODES, X_CODES, out_size, pack_weights, phases)

STAGES = "constexpr int STAGES = 6;\nconstexpr int SMEM_BYTES"
NO_LOAD = ("          v[r] = ok ? G::load(", "          v[r] = false ? G::load(")
NO_QUANT = ("    cg::Pack16<__nv_bfloat16>::unpack(v, f);\n"
            "    return make_uint2(quant4(f[0], f[1], f[2], f[3], inv), "
            "quant4(f[4], f[5], f[6], f[7], inv));",
            "    return make_uint2(v.x ^ v.y, v.z ^ v.w);")
NO_EPILOGUE = ("    if (leader && prev >= 0) cg::mbar_arrive(empty + 8 * prev);\n",
               "    if (leader && prev >= 0) cg::mbar_arrive(empty + 8 * prev);\n"
               "    if (p.stride > 0) continue;\n")
VARIANTS = {
    "base": [],
    "no_load": [NO_LOAD],
    "no_quant": [NO_QUANT],
    "no_epilogue": [NO_EPILOGUE],
    "skeleton": [NO_LOAD, NO_QUANT, NO_EPILOGUE],
    "no_store": [("          store_pair(dst, v0, v1);",
                  "          if (__float_as_uint(float(v0)) == 0x7f800001u) "
                  "store_pair(dst, v0, v1);")],
    "no_mma": [("        wgmma_s8(acc, cg::sw128_desc(a + 32 * kk), cg::sw128_desc(w + 32 * kk), "
                "ks > 0 || kk > 0);",
                "        if (p.O < 0) wgmma_s8(acc, cg::sw128_desc(a + 32 * kk), "
                "cg::sw128_desc(w + 32 * kk), ks > 0 || kk > 0);")],
    "stages2": [(STAGES, STAGES.replace("= 6;", "= 2;"))],
    "stages4": [(STAGES, STAGES.replace("= 6;", "= 4;"))],
    "producers3": [("constexpr int CONSUMERS = 2, PRODUCERS = 2;",
                    "constexpr int CONSUMERS = 2, PRODUCERS = 3;")],
}
# (x, w OIHW, stride, pad0, pad1, lhs_dilation): the int8 flagship's 512 px
# [2,2] fold, its s2d 2x-up conv (polyphase), a 3x3 at 32 px (36 K steps a
# tile) and one at 256 px (O = 64)
SITES = [((16, 512, 512, 128), (128, 128, 2, 2), 1, 1, 1, 1),
         ((16, 257, 257, 128), (128, 128, 4, 4), 1, 1, 1, 2),
         ((16, 32, 32, 512), (512, 512, 3, 3), 1, 1, 1, 1),
         ((16, 256, 256, 128), (64, 128, 3, 3), 1, 1, 1, 1)]


def build(out_dir: str) -> dict:
    """Compile every variant (one nvcc each, started together); returns
    variant -> bound C function."""
    src = (cuda.CSRC / "conv_s8.cu").read_text()
    nvcc = cuda.find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: csrc/conv_s8.cu no longer has {old!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"conv_s8_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libconv_s8_{name}.so")
        cmd = [nvcc, *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{err[-4000:]}")
        fn = ctypes.CDLL(lib).cg_conv_s8_wgmma
        fn.argtypes = list(cuda._SIGNATURES["cg_conv_s8_wgmma"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def site_call(x_shape, w_shape, stride, pad0, pad1, d):
    """A closure launching one variant's kernel on seeded operands."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (3.0 * torch.randn(x_shape, generator=gen, device="cuda")).bfloat16()
    wq = torch.randint(-127, 128, w_shape, generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand(w_shape[0], generator=gen, device="cuda")
    B, H, W, I = x_shape
    O, _, kh, kw = w_shape
    Ho, Wo = out_size(H, kh, stride, pad0, pad1, d), out_size(W, kw, stride, pad0, pad1, d)
    plist = phases(kh, kw, stride, pad0, d, Ho, Wo)
    packed = pack_weights(wq, plist, d)
    table = (ctypes.c_int * (8 * len(plist)))(*(v for ph in plist for v in ph[2:]))
    out = torch.empty((B, Ho, Wo, O), dtype=torch.bfloat16, device="cuda")

    def call(fn):
        status = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), B, H, W,
                    I, Ho, Wo, O, packed.shape[2], stride, d, len(plist), table,
                    X_CODES[x.dtype], 2.0, OUT_CODES[out.dtype],
                    torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"launch failed with error {status}")
    return call


def time_ms(call, fn, iters: int = 20) -> float:
    for _ in range(3):
        call(fn)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call(fn)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_s8_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    fns = build(os.path.join(ROOT, "build", "conv_s8_ablation"))
    for site in SITES:
        call = site_call(*site)
        print(json.dumps({"site": {"x": site[0], "w": site[1], "stride": site[2],
                                   "pad0": site[3], "pad1": site[4], "lhs_dilation": site[5]},
                          "ms": {name: time_ms(call, fn) for name, fn in fns.items()}}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
