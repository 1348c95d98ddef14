#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from the sources in this checkout;
  3. kernels: each kernel against its plain PyTorch version at every call
     shape of both flagship paths of phase 5 (bf16), at the largest of them
     in fp32 and at odd shapes (bf16 and fp32). Per flagship shape two
     times of the kernel: `kernel_ms`, back-to-back calls of the wrapper
     between CUDA events (the slower of the host's issue rate and the
     device), and `device_ms`, the same calls captured into a CUDA graph
     and replayed (the device alone); beside them the plain version, the
     one PyTorch call that computes the same function where there is one,
     and the bound. Kernels 2-4 also record the variant each shape took,
     which must be the one `expected_variant` names for it (phase 5 must
     launch those), and the first design's kernel at the same shape,
     checked and timed the same two ways (`previous_ms`,
     `previous_device_ms`): where the wrapper launches another kernel than
     the first design's, its `device_ms` may be at most 10% above that
     one's. Kernel 3's variants must fold their weights in fp32. Then the
     host's cost of one call of the wrappers of kernels 2 and 3 at their
     4 px shapes (`host_us_per_call`);
  4. agreement: the TINY search's fitness on the GPU (kernels) against the
     CPU (plain versions), fp32, in the plain domain (TINY) and in the s2d
     domain (TINY with s2d_min_res=8);
  5. main path: a StyleGAN2_ffhq_d NSGA-II search at full width
     (config-f 1024px G + D, CLIP ViT-B/32, pop 16, bf16, random weights
     from seed 0), init + 3 generations, with the kernels' launch counts:
     first the default path (the 512 and 1024 px levels in the s2d domain),
     then the plain domain (s2d_min_res=2**30);
  6. domains: one fp32 full-width evaluation of one population in both
     domains, and their largest difference (printed, not asserted);
  7. cli: the CLI (`clip_glass_torch.cli.main`, what run_torch.py runs)
     in-process at full width (config-f 1024px, ViT-B/32, pop 16, bf16,
     random weights from seed 0, --device cuda), five runs, each in its own
     folder: A1 StyleGAN2_ffhq_d for 2 generations; A2 A1's folder resumed
     to 4; B 4 uninterrupted, whose ga_state.npz must equal A2's bitwise; C
     as A1 but from converted checkpoints written here (the same seeded
     draws in the JAX layout: Gs.npz, Gs_cfg.json, D.npz, Gs_noise.npz and a
     CLIP .npz with its sidecar), whose ga_state.npz must equal A1's
     bitwise; D StyleGAN2_ffhq_nod (the GA) for 2 generations. Every run
     must write the artifact set, and launch every kernel on the variants
     phase 3 saw the main path take; one line per run with the `wallclock:`
     phases, seconds per generation and the periodic dumps' times.
Then the BigGAN-deep paths, whose one kernel is kernel 4 at the bottleneck
blocks' s2d mid segments (C' = 4 * mid, one weight set for every sample):
  8. biggan kernels: kernel 4 at every call shape of DeepMindBigGAN256
     (pop 64) and DeepMindBigGAN512 (pop 32) (`biggan_shapes`), bf16, as
     phase 3 measures the flagship's, on the variant `expected_variant`
     names (wmma at C' = 256, wgmma at 128);
  9. biggan agreement: the TINY BigGAN GA fitness on the GPU against the
     CPU, fp32, plain (bg.TINY) and with both blocks' mid segments in the
     s2d domain (s2d_min_res=4);
 10. biggan main: both configs' GA at full width (bf16, CLIP ViT-B/32,
     random weights from seed 0), init + 2 generations each, with kernel
     4's launches by variant, then G and CLIP stage times (CUDA events);
 11. biggan domains: one fp32 DeepMindBigGAN256 evaluation of one
     population in both domains, and their largest difference (printed);
 12. biggan cli: `cli.main` with no --config (DeepMindBigGAN512), random
     weights, 2 generations: the artifact set, ls_result.npz with z and
     class_labels.
Then GPT-2's image-to-text search, which runs no kernel of the package
(GPT-2 and CLIP's text tower are cuBLAS matmuls and PyTorch ops, with the
BPE round trip on the host between them):
 13. gpt2 agreement: the TINY GPT2 fitness and sample_sequence on the GPU
     against the CPU, fp32: the ids token-exact, F within 1e-6; both
     tokenizers took the native merge core;
 14. gpt2 main: GPT2 at full width (GPT-2 124M, CLIP ViT-B/32, pop 100,
     bf16, random weights from seed 0, the example dog photo as target),
     init + 2 generations: per evaluation the decode, host round trip and
     text tower times, seconds a generation, peak memory, the evaluations
     that an overflow zeroed, the decode's launches a token (profiler) and
     its bounds from the shapes, the round trip on the native merge core
     against the Python loop; no kernel of the package launches;
 15. gpt2 cli: `cli.main --config GPT2` at full width: F1 2 generations, F2
     F1's folder resumed to 4, G 4 straight; the .txt artifact set, and F2's
     ga_state.npz equal to G's bitwise.
Then the reference's own checkpoint formats (random weights from seed 0,
written at the published geometries by weights/synthesize.py, about 2.4 GB in
a temporary directory):
 16. checkpoints: (a) each file loaded directly equals, leaf by leaf and
     bitwise, the npz the port's convert CLI wrote from it (StyleGAN2
     config-f Gs/G/D.pth, the TF pickle's G/D/Gs and noise planes, CLIP
     ViT-B/32 and RN50 as TorchScript archives and pickled state dicts in
     fp16, BigGAN-deep-512's and GPT-2 124M's .bin), with each file's size
     and load seconds; (b) `cli.main --config StyleGAN2_ffhq_d` from
     Gs.pth + D.pth + ViT-B-32.pt (H1) and from the converted npz files
     (H2), 2 generations each: every kernel on the variants of phase 3, and
     H1's ga_state.npz equal to H2's bitwise; (c) the same search with
     RN50.pt (I), and both towers' CLIP stage (CUDA events); (d) one
     full-width evaluation of DeepMindBigGAN512 from its .bin (kernel 4
     launches, F finite) and of GPT2 from its .bin (no kernel launches),
     with BigGAN's largest F difference between its final-BN affine staged
     in bf16 and kept in fp32 (printed).
The last lines are the script's seconds, the kernels' summary (JSON; kernel
4's entry carries a `biggan` record per config), the card's name and power
limit, and {"ok": true, "device": {...}}.

Run: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM data sheet: 3.35 TB/s HBM3; 67 TFLOP/s float32 outside the tensor
# cores, where kernels 1-3 compute (bf16 inputs widen to fp32) and so does
# kernel 4 in fp32; 989 TFLOP/s dense bf16 on the tensor cores, where kernel
# 4 computes in bf16
MEM_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_TC_OPS_PER_S = 989e12
TARGET = "the face of a man with brown eyes"
POP = 16
GENERATIONS = 3
# fp32: the kernel and the plain version differ only in summation order and
# FMA contraction; bf16: one to two bf16 ulps where roundings fall apart
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one call of `fn`: `iters` calls captured into a CUDA
    graph (the wrappers launch on the current stream, which is the capture
    stream) and the replay timed, so that no host work sits between two
    launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, 3, warmup=1) / iters
    del graph
    return ms


def host_us(fn, calls: int = 1000) -> float:
    """Host time of one call of `fn` in microseconds: the wall clock over
    `calls` calls with no synchronisation inside the loop and one after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def bound_ms(n_bytes: int, n_ops: int, peak: float = PEAK_FP32_OPS_PER_S) -> tuple:
    """The least time for the work, and whether bytes or operations set it."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ------------------------------------------------------------ phase 1-2

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    log({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
         "nvidia_smi": smi_line(), "torch": torch.__version__,
         "cuda": torch.version.cuda})
    # fp32 comparisons and references run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from clip_glass_torch.ops import cuda

    t = time.perf_counter()
    path = cuda.build()
    cuda.library()
    log({"phase": "build", "seconds": time.perf_counter() - t,
         "library": os.path.relpath(path, ROOT)})


# ------------------------------------------------------------ phase 3

def flagship_shapes(cfg, pop: int = POP):
    """Per-evaluation call shapes of the four kernels for model config
    `cfg`: the plain levels below s2d_min_res run kernels 1-3; the s2d
    levels run kernel 1 on the packed tensor viewed as [B, nh, 4*nw, C] and
    kernel 4 on the [2,2] folds between opposite lattices, (B, n, C', pad0,
    modulated): G's second layer of each s2d level (lattice 0 -> -1) and
    D's conv0 of each s2d level (-1 -> 0)."""
    nbl, ups, rgb, s2d = [], [], [], []
    res = cfg.base_size
    for bi, (_, out_ch, up, n_layers) in enumerate(cfg.block_channels()):
        if up:
            res *= 2
        if res >= cfg.s2d_min_res:
            n = res // 2
            # offsets alternate 0 (up conv output), -1 (second layer)
            nbl += [(pop, n, 4 * n, out_ch), (pop, n + 1, 4 * (n + 1), out_ch)]
            s2d.append((pop, n, 4 * out_ch, 1, True))
            continue
        nbl += [(pop, res, res, out_ch)] * n_layers
        if bi:
            ups.append((pop, res // 2, res // 2, cfg.data_channels))
        rgb.append((pop, res * res, out_ch, cfg.data_channels))
    ch = list(cfg.channels)
    res = cfg.resolution
    for i in range(len(ch) - 1):
        if res >= cfg.s2d_min_res:
            s2d.append((pop, res // 2 + 1, 4 * ch[i], 0, False))
        res //= 2
    return nbl, ups, rgb, s2d


def _counts(shapes):
    out = {}
    for s in shapes:
        out[s] = out.get(s, 0) + 1
    return out


def _check(name, got, want, dtype, shape, scaled: bool = False):
    """Kernel against plain version at TOL; `scaled` takes the absolute
    tolerance relative to the output's scale (kernel 4's outputs are sums
    of 4C' products)."""
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    atol = tol * max(1.0, want.float().abs().max().item()) if scaled else tol
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=tol)
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees with "
                             f"the plain version, max abs err {err}")
    return err


def _nbl_case(shape, dtype, gen):
    B, H, W, C = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    noise = torch.randn((H, W), generator=gen, device="cuda").to(dtype)
    ns = torch.tensor(0.7, device="cuda").to(dtype)
    bias = torch.randn((C,), generator=gen, device="cuda").to(dtype)
    return x, noise, ns, bias


def _ups_case(shape, dtype, gen):
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),)


def _rgb_case(shape, dtype, gen, demod: bool = False):
    B, P, I, O = shape
    x = torch.randn((B, P, I), generator=gen, device="cuda").to(dtype)
    style = (1.0 + 0.5 * torch.randn((B, I), generator=gen, device="cuda")).to(dtype)
    w = (torch.randn((I, O), generator=gen, device="cuda") / math.sqrt(I)).to(dtype)
    d = ((0.5 + torch.rand((B, O), generator=gen, device="cuda")).to(dtype)
         if demod else None)
    bias = torch.randn((O,), generator=gen, device="cuda").to(dtype)
    return x, style, w, d, bias


def _s2d_case(shape, dtype, gen):
    B, n, C, pad0, modulated = shape
    x = torch.randn((B, n, n, C), generator=gen, device="cuda").to(dtype)
    K = torch.randn((2, 2, C, C), generator=gen, device="cuda") / math.sqrt(4 * C)
    if modulated:
        style = 1.0 + 0.5 * torch.randn((B, C), generator=gen, device="cuda")
        demod = 0.5 + torch.rand((B, C), generator=gen, device="cuda")
    else:  # one weight set for every sample, as D calls it
        style = demod = None
    return x, K, style, demod, pad0


def _s2d_cost(shape, args):
    B, n, C, pad0, _ = shape
    x, K, style, demod, _ = args
    n_out = n + 1 if pad0 else n - 1
    return (nbytes(x, K, style, demod) + B * n_out * n_out * C * x.element_size(),
            2 * B * n_out * n_out * 4 * C * C)


def _s2d_library(args):
    """One cuDNN conv of the same function: the shared folded kernel for an
    unmodulated call, a grouped conv over the per-sample Kb otherwise."""
    from clip_glass_torch.ops import s2d

    x, K, style, demod, pad0 = args
    B, n, _, C = x.shape
    Kb = s2d._fold_style(K, style, demod).to(x.dtype)      # [B or 1,2,2,C,C]
    if style is None and demod is None:
        w = Kb[0].permute(3, 2, 0, 1).contiguous()          # OIHW
        xn = x.permute(0, 3, 1, 2)

        def fn():
            return F.conv2d(xn, w, padding=pad0)
    else:
        w = Kb.permute(0, 4, 3, 1, 2).reshape(B * C, C, 2, 2).contiguous()
        xn = x.permute(0, 3, 1, 2).reshape(1, B * C, n, n).contiguous()

        def fn():
            return F.conv2d(xn, w, padding=pad0, groups=B).reshape(B, C, n + 2 * pad0 - 1, -1)

    def check(got):
        _check("conv2d", fn().permute(0, 2, 3, 1), got, x.dtype, tuple(x.shape),
               scaled=True)
    return fn, check


def _s2d_previous(args):
    """The first design's bf16 kernel (wmma) on the same call, weights
    folded as it takes them: kept in the library for other widths, timed
    beside the wgmma variant at the flagship shapes."""
    from clip_glass_torch.ops import s2d

    x, K, style, demod, pad0 = args

    def fn():
        Kb = s2d.conv2x2_weights(K, style, demod, x.dtype, "wmma")
        return s2d.conv2x2_launch(x, Kb, pad0, "wmma")
    return fn


def _ups_previous(args):
    """Kernel 2's first design ("rows": one thread per output value)."""
    from clip_glass_torch.ops import upfirdn

    (x,) = args
    taps = upfirdn.polyphase_taps()
    return lambda: upfirdn.upsample2x_launch(x, taps, "rows")


def _rgb_previous(args):
    """Kernel 3's first design ("chunked": weights in shared memory)."""
    from clip_glass_torch.ops import modulated_conv

    return lambda: modulated_conv.modulated_matmul_launch(*args, "chunked")


def _rgb_fold_is_fp32(widths) -> None:
    """Kernel 3 folds s*w in fp32, as its plain version does, in both
    variants: with s = 1 + 2^-7 on even k (1 on odd), w = 1 + 2^-7 and
    x = +1, -1 alternating, the sum is I/2 * (2^-7 + 2^-14), a bf16 value
    that folds rounded to bf16 (I/2 * 2^-7) would miss."""
    from clip_glass_torch.ops import modulated_conv

    e = 2.0 ** -7
    for I in widths:
        k = torch.arange(I, device="cuda")
        x = (1.0 - 2.0 * (k % 2)).expand(POP, 1031, I).contiguous().bfloat16()
        s = (1.0 + e * (1 - k % 2)).expand(POP, I).contiguous().bfloat16()
        w = torch.full((I, 3), 1.0 + e, device="cuda").bfloat16()
        bias = torch.zeros(3, device="cuda").bfloat16()
        want = modulated_conv.modulated_matmul_plain(x, s, w, None, bias)
        if not (want.float() == I / 2 * (e + e * e)).all():
            raise AssertionError(f"modulated_matmul_plain I={I}: not the fp32 fold")
        for variant in ("mma", "chunked"):
            got = modulated_conv.modulated_matmul_launch(x, s, w, None, bias, variant)
            if not torch.equal(got, want):
                raise AssertionError(f"modulated_matmul {variant} I={I}: folded weights "
                                     "lose precision against the fp32 fold")
    log({"phase": "kernels", "check": "modulated_matmul folds s*w in fp32",
         "variants": ["mma", "chunked"], "I": list(widths), "max_abs_err": 0.0})


def _iters(n_bytes: int) -> int:
    """Launches per timing: about 20 GB of traffic, 10 to 200 launches."""
    return int(min(200, max(10, 2e10 / max(n_bytes, 1))))


def _measure(kernel, plain, args, dtype, shape, n_bytes, n_ops, library=None,
             scaled=False, peak=PEAK_FP32_OPS_PER_S, previous=None,
             device_time=False):
    """One shape: the kernel checked against the plain version and timed;
    with `device_time` also through a CUDA graph; `previous` (a callable:
    the first design's kernel on the same operands) checked and timed the
    same ways."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = _check(kernel.__name__, got, want, dtype, shape, scaled)
    iters = _iters(n_bytes)
    rec = {"kernel": kernel.__name__, "shape": list(shape), "dtype": str(dtype),
           "max_abs_err": err,
           "kernel_ms": time_ms(lambda: kernel(*args), iters),
           "plain_ms": time_ms(lambda: plain(*args), iters)}
    if device_time:
        rec["device_ms"] = graph_ms(lambda: kernel(*args), iters)
        rec["previous_ms"] = rec["previous_device_ms"] = None
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_ops, peak)
    rec["library_ms"] = None
    if library is not None:
        lib_fn, lib_check = library
        lib_check(got)
        rec["library_ms"] = time_ms(lib_fn, iters)
    if previous is not None:
        _check(f"{kernel.__name__} (first design)", previous(), want, dtype, shape,
               scaled)
        rec["previous_ms"] = time_ms(previous, iters)
        rec["previous_device_ms"] = graph_ms(previous, iters)
    del got, want
    return rec


SUM_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "previous_ms",
            "previous_device_ms")


def _path_sum(counts, recs, peak: float):
    """One evaluation's sums over a path's call shapes: times weighted by
    the launches at each shape, and the bound of the summed work."""
    tot = {"max_abs_err": 0.0}
    work = [0, 0]  # bytes and operations
    for key in SUM_KEYS:  # a time that some shape lacks has no sum
        rec_key = "kernel_ms" if key == "ms" else key
        times = [count * recs[shape][0][rec_key] for shape, count in counts.items()
                 if recs[shape][0][rec_key] is not None]
        tot[key] = sum(times) if len(times) == len(counts) else None
    for shape, count in counts.items():
        rec, n_bytes, n_ops = recs[shape]
        tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
        work[0] += count * n_bytes
        work[1] += count * n_ops
    tot["bound_ms"], tot["bound_by"] = bound_ms(*work, peak)
    return tot


def phase_kernels():
    """Kernels vs plain versions at every call shape that either flagship
    path (s2d default, plain) gives them, bf16, each shape measured once;
    returns per-kernel, per-path summaries over one evaluation."""
    from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn

    gen = torch.Generator(device="cuda").manual_seed(0)
    path_shapes = {p: flagship_shapes(_model_cfg(p)) for p in PER_EVAL}
    k1 = upfirdn.polyphase_taps()
    fir_t = torch.tensor([[a * b for b in k1] for a in k1], device="cuda")

    def nbl_cost(shape, args):
        B, H, W, C = shape
        return nbytes(*args) + nbytes(args[0]), 5 * B * H * W * C

    def ups_cost(shape, args):
        B, H, W, C = shape
        return 5 * nbytes(args[0]), 8 * 4 * B * H * W * C

    def rgb_cost(shape, args):
        B, P, I, O = shape
        x, style, w, d, bias = args
        return (nbytes(x, style, w, d, bias) + B * P * O * x.element_size(),
                2 * B * P * I * O)

    def ups_library(args):
        (x,) = args
        B, H, W, C = x.shape
        wt = fir_t.flip(0, 1).to(x.dtype)[None, None].expand(C, 1, 4, 4)
        xn = x.permute(0, 3, 1, 2)

        def fn():
            return F.conv_transpose2d(xn, wt, stride=2, groups=C)[:, :, :2 * H, :2 * W]

        def check(got):
            _check("conv_transpose2d", fn().permute(0, 2, 3, 1), got, x.dtype,
                   tuple(x.shape))
        return fn, check

    def rgb_library(args):
        x, style, w, d, bias = args
        dd = d if d is not None else torch.ones_like(style[:, :1])
        wb = style[:, :, None] * w[None] * dd[:, None, :]

        def fn():
            return torch.baddbmm(bias[None, None], x, wb)

        def check(got):
            # the folded weight rounds s*w*d to bf16 once more: compare at
            # twice the bf16 tolerance
            err = (fn().float() - got.float()).abs().max().item()
            scale = got.float().abs().max().item()
            if not err <= 2 * TOL[x.dtype] * max(1.0, scale):
                raise AssertionError(f"baddbmm disagrees: {err}")
        return fn, check

    # (name, kernel, plain, case, cost, library, first design, index in
    # flagship_shapes, odd shapes)
    specs = [
        ("noise_bias_lrelu", bias_act.noise_bias_lrelu, bias_act.noise_bias_lrelu_plain,
         _nbl_case, nbl_cost, None, None, 0, [(3, 5, 7, 20), (2, 3, 5, 7)]),
        # odd shapes: ragged rows, C = 3 and not, a tile's last rows (H = 21:
        # 8 + 8 + 5), rows of 16-byte multiples (W*C = 24, 96, 128) and not
        ("upsample2x", upfirdn.upsample2x, upfirdn.upsample2x_plain,
         _ups_case, ups_cost, ups_library, _ups_previous, 1,
         [(3, 5, 7, 3), (2, 4, 6, 16), (1, 21, 8, 3), (3, 9, 32, 3), (2, 11, 8, 16),
          (1, 13, 5, 7)]),
        # odd shapes: O = 3 on scalar rows and on rows of 3 vectors, O != 3,
        # launch-sized runs that end inside a warp's tile, and the same
        # above 2 Mi input values (bf16: the tensor-core variant)
        ("modulated_matmul", modulated_conv.modulated_matmul,
         modulated_conv.modulated_matmul_plain, _rgb_case, rgb_cost, rgb_library,
         _rgb_previous, 2,
         [(3, 37, 24, 3), (2, 50, 20, 12), (2, 33, 7, 5), (3, 1037, 32, 3),
          (1, 77, 512, 3), (3, 30011, 32, 3), (1, 4099, 512, 3), (2, 16411, 64, 3)]),
        ("s2d_conv2x2", s2d.s2d_conv2x2, s2d.s2d_conv2x2_plain, _s2d_case, _s2d_cost,
         _s2d_library, _s2d_previous, 3,
         [(3, 13, 20, 1, True), (2, 11, 20, 0, False), (2, 13, 64, 0, True),
          (3, 11, 64, 1, False), (2, 13, 128, 1, False), (2, 11, 128, 0, True),
          # ragged rows of 32-cell tiles (n_out 69-71, 128-130), both widths
          # of the wgmma variant, both halos, B of 1 and 3, both weight kinds
          (1, 70, 64, 1, True), (3, 70, 128, 0, False), (3, 129, 64, 0, False),
          (1, 129, 128, 1, True)]),
    ]
    summary = {}
    for name, kernel, plain, make, cost, library, previous, idx, odd in specs:
        # kernel 4: outputs checked relative to their scale; bf16 on the
        # tensor cores, fp32 on the CUDA cores
        scaled = name == "s2d_conv2x2"

        def peak(dtype):
            return (PEAK_BF16_TC_OPS_PER_S if scaled and dtype == torch.bfloat16
                    else PEAK_FP32_OPS_PER_S)
        counts = {p: _counts(path_shapes[p][idx]) for p in PER_EVAL}
        shapes = list(dict.fromkeys(s for p in PER_EVAL for s in counts[p]))
        recs = {}  # shape -> (record, bytes, operations)
        for shape in shapes:
            args = make(shape, torch.bfloat16, gen)
            n_bytes, n_ops = cost(shape, args)
            rec = _measure(kernel, plain, args, torch.bfloat16, shape, n_bytes,
                           n_ops, library(args) if library else None, scaled,
                           peak(torch.bfloat16), previous(args) if previous else None,
                           device_time=True)
            if name in FIRST_DESIGN:
                rec["variant"] = _variant_of(kernel, args)
                _check_variant(name, shape, rec)
            rec["launches_per_evaluation"] = {p: counts[p].get(shape, 0)
                                              for p in PER_EVAL}
            log(rec)
            recs[shape] = (rec, n_bytes, n_ops)
            del args
        summary[name] = {p: _path_sum(counts[p], recs, peak(torch.bfloat16))
                         for p in PER_EVAL}
        if name in FIRST_DESIGN:
            for p in PER_EVAL:  # launches per evaluation by variant
                by = summary[name][p]["launches_by_variant"] = {}
                for shape, count in counts[p].items():
                    v = recs[shape][0]["variant"]
                    by[v] = by.get(v, 0) + count
        # the largest flagship shape in fp32, and the odd shapes in both types
        extra = [(max(shapes, key=lambda s: math.prod(s[:3])), torch.float32)]
        extra += [(s, dt) for s in odd for dt in (torch.bfloat16, torch.float32)]
        for shape, dtype in extra:
            if name == "modulated_matmul" and shape in odd[1:]:
                args = _rgb_case(shape, dtype, gen, demod=True)
            else:
                args = make(shape, dtype, gen)
            n_bytes, n_ops = cost(shape, args)
            rec = _measure(kernel, plain, args, dtype, shape, n_bytes, n_ops,
                           scaled=scaled, peak=peak(dtype))
            if name in FIRST_DESIGN:
                rec["variant"] = _variant_of(kernel, args)
            log(rec)
            del args
        torch.cuda.empty_cache()
    _rgb_fold_is_fp32(sorted({s[2] for s in path_shapes["plain"][2]}))
    return summary


# the first design's variant of each kernel that was redesigned
FIRST_DESIGN = {"upsample2x": "rows", "modulated_matmul": "chunked", "s2d_conv2x2": "wmma"}


def expected_variant(name: str, shape) -> str:
    """The variant a call shape must take: the redesigned one from 32 px up
    (kernel 2: the input's height; kernel 3: the pixels), the first design's
    on launch-sized inputs below; kernel 4's redesign at C' = 64 and 128
    (every flagship call, BigGAN-deep-512's last blocks), its first design
    at BigGAN-deep's C' = 256, whose weights do not fit shared memory."""
    if name == "s2d_conv2x2":
        return "wgmma" if shape[2] in (64, 128) else "wmma"
    if name == "upsample2x":
        return "tiled" if shape[1] >= 32 else "rows"
    return "mma" if shape[1] >= 32 * 32 else "chunked"


def _check_variant(name: str, shape, rec: dict) -> None:
    """A flagship shape took the variant expected of it, and where that is
    not the first design's kernel, it is at most 10% slower on the device
    than that kernel at the same shape."""
    if rec["variant"] != expected_variant(name, shape):
        raise AssertionError(f"{name} {shape}: took {rec['variant']}, not "
                             f"{expected_variant(name, shape)}")
    if (rec["variant"] != FIRST_DESIGN[name]
            and rec["device_ms"] > 1.1 * rec["previous_device_ms"]):
        raise AssertionError(f"{name} {shape}: {rec['variant']} takes "
                             f"{rec['device_ms']} ms on the device, the first design "
                             f"{rec['previous_device_ms']} ms")


def _variant_of(kernel, args) -> str:
    """The variant that one call of the wrapper launches."""
    before = dict(kernel.launches_by_variant)
    kernel(*args)
    return "+".join(v for v, n in kernel.launches_by_variant.items() if n != before[v])


def phase_host():
    """The host's cost of one call of the wrappers of kernels 2 and 3, at
    the 4 px shapes of the flagship, where the device has next to nothing
    to do: what a launch-sized call costs to issue."""
    from clip_glass_torch.ops import modulated_conv, upfirdn

    gen = torch.Generator(device="cuda").manual_seed(0)
    ups = _ups_case((POP, 4, 4, 3), torch.bfloat16, gen)
    rgb = _rgb_case((POP, 16, 512, 3), torch.bfloat16, gen)
    out = {"upsample2x": host_us(lambda: upfirdn.upsample2x(*ups)),
           "modulated_matmul": host_us(lambda: modulated_conv.modulated_matmul(*rgb))}
    log({"phase": "host", "host_us_per_call": out, "calls": 1000,
         "shapes": {"upsample2x": [POP, 4, 4, 3], "modulated_matmul": [POP, 16, 512, 3]}})
    return out


# ------------------------------------------------------------ phase 4


def _kernels():
    from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn

    return (bias_act.noise_bias_lrelu, upfirdn.upsample2x,
            modulated_conv.modulated_matmul, s2d.s2d_conv2x2)


def _zero_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
        for v in getattr(k, "launches_by_variant", {}):
            k.launches_by_variant[v] = 0


def _agreement(family: str, cfg, X, models: dict, bundle=None) -> None:
    """The fitness of `X` on the GPU (kernels) against the CPU (plain
    versions) for each model config of `models` (label -> (config, the four
    kernels' launches per GPU evaluation)); the CPU evaluation launches none.
    fp32 on both sides with TF32 off: cuDNN/cuBLAS sum in another order than
    the CPU kernels over ~20 layers, hence rtol 1e-3, atol 1e-4."""
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model

    kernels = _kernels()
    for label, (model_cfg, want) in models.items():
        Fs = {}
        for dev in ("cpu", "cuda"):
            p = GenerationProblem(cfg, device=dev, clip_cfg=clip_model.TINY,
                                  model_cfg=model_cfg, bundle=bundle)
            before = [k.launches for k in kernels]
            Fs[dev] = p.generator.eval_population(X.to(dev)).cpu()
            moved = tuple(k.launches - n for k, n in zip(kernels, before))
            if moved != (want if dev == "cuda" else (0, 0, 0, 0)):
                raise AssertionError(f"{family} {label} {dev}: kernel launches {moved}")
        err = (Fs["cuda"] - Fs["cpu"]).abs().max().item()
        if not torch.allclose(Fs["cuda"], Fs["cpu"], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"{family} {label} fitness on the GPU disagrees with the "
                                 f"CPU: {Fs['cuda']} vs {Fs['cpu']}")
        log({"phase": "agreement", "config": f"{family} {label} fp32", "max_abs_err": err,
             "fitness_spread": (Fs["cpu"].max(0).values - Fs["cpu"].min(0).values).tolist(),
             "launches": dict(zip([k.__name__ for k in kernels], want))})


def phase_agreement():
    """TINY problem's fitness on the GPU (kernels) against the CPU (plain
    versions), fp32, in both domains; the GPU evaluation launches each
    kernel at every call site, the CPU one none. tests/test_torch_cuda.py
    runs this same check."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = get_config("StyleGAN2_ffhq_d").replace(
        pop_size=8, dim_z=32, n_var=32, weights="random:0", target=TARGET,
        compute_dtype="float32")
    X = torch.randn((8, 32), generator=torch.Generator().manual_seed(1))
    # launches per evaluation. TINY (plain): 5 synthesis layers, 2 skip
    # upsamples, 3 ToRGB. TINY_S2D (levels 8 and 16 in the s2d domain): 5
    # layer epilogues, ToRGB at 4 px only, two [2,2] folds in G and two in D
    _agreement("StyleGAN2", cfg, X, {
        "TINY": (sg2.TINY, (5, 2, 3, 0)),
        "TINY_S2D": (dataclasses.replace(sg2.TINY, s2d_min_res=8), (5, 0, 1, 4))})


# ------------------------------------------------------------ phase 5

# launches per evaluation of the flagship on each path
PER_EVAL = {
    "s2d": {"noise_bias_lrelu": 17, "upsample2x": 6, "modulated_matmul": 7,
            "s2d_conv2x2": 4},
    "plain": {"noise_bias_lrelu": 17, "upsample2x": 8, "modulated_matmul": 9,
              "s2d_conv2x2": 0},
}


def _model_cfg(path: str):
    from clip_glass_torch.models.stylegan2 import model as sg2

    # the plain domain through the config's own switch ("2**30 disables")
    return sg2.CONFIG_F if path == "s2d" else dataclasses.replace(
        sg2.CONFIG_F, s2d_min_res=2 ** 30)


def phase_main(kind: str, smi: str, path: str, generations: int, summary: dict):
    """The flagship search on one path; returns the kernels' launch counts
    of that run (counts set to 0 just before it, read just after). Each
    kernel with variants must have launched them as the kernel phase saw
    the wrapper choose at the path's call shapes (`summary`)."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    config = get_config("StyleGAN2_ffhq_d").replace(
        target=TARGET, weights="random:0", pop_size=POP)
    t = time.perf_counter()
    problem = GenerationProblem(config, device="cuda", model_cfg=_model_cfg(path))
    if problem.generator._s2d_active != (path == "s2d"):
        raise AssertionError(f"{path}: the fitness took the other domain")
    algorithm = problem.make_algorithm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    gen = algorithm.generator(0)
    _zero_counts(kernels)
    t = time.perf_counter()
    state = algorithm.init(gen)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    init_s = stamps[0] - t

    def on_generation(_state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = minimize(algorithm, generations, gen, callback=on_generation,
                   save_each=1, state=state)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    variants = {k.__name__: dict(k.launches_by_variant) for k in kernels
                if k.__name__ in FIRST_DESIGN}

    Fp = res.pop_F
    if tuple(Fp.shape) != (POP, 2) or not torch.isfinite(Fp).all():
        raise AssertionError(f"bad fitness: shape {tuple(Fp.shape)}, {Fp}")
    if not (Fp[:, 1] >= 0).all():
        raise AssertionError(f"negative hinge: {Fp[:, 1]}")
    if not (Fp[:, 0].abs() <= 1.0 + 1e-6).all():
        raise AssertionError(f"|cos| > 1: {Fp[:, 0]}")
    n_eval = generations + 1
    for name, n in PER_EVAL[path].items():
        if launches[name] != n * n_eval:
            raise AssertionError(f"{path}: {name}: {launches[name]} launches, "
                                 f"expected {n} x {n_eval} evaluations")
    for name in FIRST_DESIGN:
        want = {v: n * n_eval
                for v, n in summary[name][path]["launches_by_variant"].items()}
        if {v: n for v, n in variants[name].items() if n} != want:
            raise AssertionError(f"{path}: {name} launches by variant "
                                 f"{variants[name]}, expected {want}")
    gen_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    log({"phase": "main", "path": path, "config": "StyleGAN2_ffhq_d",
         "model": "CONFIG_F 1024px" + ("" if path == "s2d" else ", s2d_min_res=2**30"),
         "clip": "VIT_B_32", "pop": POP, "compute_dtype": config.compute_dtype,
         "generations": generations, "setup_s": setup_s, "init_eval_s": init_s,
         "generation_s": gen_s,
         "candidates_per_s": [POP / s for s in gen_s],
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "best_cos": -Fp[:, 0].min().item(), "hinge_min": Fp[:, 1].min().item(),
         "launches": launches, "launches_by_variant": variants,
         "device": kind, "nvidia_smi": smi})
    del problem, algorithm, res, state
    torch.cuda.empty_cache()
    return launches, variants


# ------------------------------------------------------------ phase 6

def phase_domains():
    """One fp32 full-width evaluation of the same population in the s2d and
    the plain domain (TF32 off): the two are exact rewrites of each other,
    so they differ by summation order only. Printed, not asserted."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem

    config = get_config("StyleGAN2_ffhq_d").replace(
        target=TARGET, weights="random:0", pop_size=POP, compute_dtype="float32")
    X = torch.randn((POP, config.n_var), generator=torch.Generator().manual_seed(2))
    Fs = {}
    for path in ("s2d", "plain"):
        problem = GenerationProblem(config, device="cuda", model_cfg=_model_cfg(path))
        Fs[path] = problem.generator.eval_population(X.cuda()).cpu().double()
        del problem
        torch.cuda.empty_cache()
    diff = (Fs["s2d"] - Fs["plain"]).abs()
    rel = diff / Fs["plain"].abs().max(dim=0).values
    log({"phase": "domains", "config": "StyleGAN2_ffhq_d fp32", "pop": POP,
         "max_abs_diff": [diff[:, j].max().item() for j in range(2)],
         "max_rel_diff_to_scale": [rel[:, j].max().item() for j in range(2)],
         "objective_scale": Fs["plain"].abs().max(dim=0).values.tolist()})


# ------------------------------------------------------------ phase 7

CLI_ARTIFACTS = {"genetic-it-final.jpg", "genetic_result", "ls_result.npz",
                 "output.jpg", "ga_state.npz"}


def _npz(path):
    import numpy as np

    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _same_state(label, got, want) -> None:
    """Two ga_state.npz contents equal bitwise, field by field."""
    import numpy as np

    if got.keys() != want.keys():
        raise AssertionError(f"{label}: fields {sorted(got)} vs {sorted(want)}")
    for k in got:
        if not np.array_equal(got[k], want[k]):
            diff = (np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)).max()
                    if got[k].dtype.kind == "f" else "-")
            raise AssertionError(f"{label}: {k} differs (max abs {diff})")


def _write_converted(root: str) -> None:
    """The seeded random weights of `random:0` in the converted layout: G and
    D drawn from one generator seeded 0 (fitness.generator.load_bundle), the
    noise planes from NOISE_SEED, CLIP from its own generator seeded 0."""
    from clip_glass_torch.core import pytree
    from clip_glass_torch.fitness.generator import NOISE_SEED
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = sg2.CONFIG_F
    gm = torch.Generator().manual_seed(0)
    pytree.save_npz(os.path.join(root, "Gs.npz"), sg2.generator_tree(gm, cfg))
    pytree.save_npz(os.path.join(root, "D.npz"), sg2.discriminator_tree(gm, cfg))
    gn = torch.Generator().manual_seed(NOISE_SEED)
    pytree.save_npz(os.path.join(root, "Gs_noise.npz"),
                    {str(i): torch.randn(s, generator=gn)
                     for i, s in enumerate(cfg.noise_shapes())})
    pytree.save_npz(os.path.join(root, "clip.npz"),
                    clip_model.init_tree(torch.Generator().manual_seed(0),
                                         clip_model.VIT_B_32))
    for name, c in (("Gs_cfg.json", cfg), ("clip_cfg.json", clip_model.VIT_B_32)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(dataclasses.asdict(c), f)


def _cli_run(label: str, folder: str, config, generations: int, want_variants: dict,
             *extra, first_gen: int = 0, pop=POP, target: str = TARGET) -> dict:
    """One in-process CLI run with the kernels' counts set to 0 just before
    it; checks its artifacts and that each kernel of `want_variants` (name
    -> the variants it must launch, or None for a kernel without variants)
    launched on those variants, and no other kernel. `config` None runs
    the CLI's default config, `pop` None the config's population."""
    import contextlib
    import io
    import pickle

    from clip_glass_torch import cli

    kernels = _kernels()
    _zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    argv = ["--target", target, "--generations", str(generations), "--save-each", "2",
            "--tmp-folder", folder, "--device", "cuda", "--seed", "0", *extra]
    if config is not None:
        argv += ["--config", config]
    if pop is not None:
        argv += ["--pop-size", str(pop)]
    if "--weights" not in extra:
        argv += ["--weights", "random:0", "--clip-weights", "random:0"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"cli {label}: exit {rc}: {lines[-5:]}")
    # a periodic dump per 2 generations run, the last one named "final";
    # GPT-2's captions are text
    ext = "txt" if config == "GPT2" else "jpg"
    want = {a.replace(".jpg", f".{ext}") for a in CLI_ARTIFACTS} | {
        f"genetic-it-{g}.{ext}" for g in range(first_gen + 2, generations, 2)}
    if (config or "").endswith("_d"):
        want.add("F.jpg")
    if set(os.listdir(folder)) != want:
        raise AssertionError(f"cli {label}: artifacts {sorted(os.listdir(folder))}")
    with open(os.path.join(folder, "genetic_result"), "rb") as f:
        res = pickle.load(f)
    if set(res) != {"X", "F", "G", "CV"}:
        raise AssertionError(f"cli {label}: genetic_result holds {sorted(res)}")
    launches = {k.__name__: k.launches for k in kernels}
    variants = {k.__name__: dict(k.launches_by_variant) for k in kernels
                if k.__name__ in FIRST_DESIGN}
    for name, n in launches.items():
        if bool(n) != (name in want_variants):
            raise AssertionError(f"cli {label}: {name} launched {n} times, expected "
                                 f"{'some' if name in want_variants else 'none'}")
        missing = [v for v in want_variants.get(name) or () if not variants[name].get(v)]
        if missing:
            raise AssertionError(f"cli {label}: {name} did not launch {missing}")
    wall = next(line for line in lines if line.startswith("wallclock:"))
    phases = {k: float(v.rstrip("s")) for k, v in
              (part.split("=") for part in wall.split()[1:])}
    dumps = [line for line in lines if line.startswith("dump ")]
    run_gens = generations - first_gen
    rec = {"phase": "cli", "run": label, "config": config or "(default)",
           "extra_args": list(extra), "wallclock": phases, "generations": [first_gen, generations],
           "search_s_per_generation": phases["search+dumps"] / run_gens,
           "dumps": dumps, "rate": [line.strip() for line in lines if "rate:" in line],
           "launches": launches, "launches_by_variant": variants,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(rec)
    return rec


def _flagship_variants(summary: dict) -> dict:
    """Every kernel, on the variants phase 3 saw the flagship's s2d path
    take."""
    return {name: ({v for v, n in summary[name]["s2d"]["launches_by_variant"].items() if n}
                   if name in FIRST_DESIGN else None) for name in KERNEL_META}


def phase_cli(summary: dict) -> None:
    import pickle
    import tempfile

    import numpy as np

    want = _flagship_variants(summary)
    with tempfile.TemporaryDirectory() as tmp:
        a, b, c, d, w = (os.path.join(tmp, x) for x in "abcdw")
        _cli_run("A1", a, "StyleGAN2_ffhq_d", 2, want)
        a1 = _npz(os.path.join(a, "ga_state.npz"))
        _cli_run("A2", a, "StyleGAN2_ffhq_d", 4, want, "--resume", first_gen=2)
        _cli_run("B", b, "StyleGAN2_ffhq_d", 4, want)
        a2, sb = _npz(os.path.join(a, "ga_state.npz")), _npz(os.path.join(b, "ga_state.npz"))
        if int(a2["gen"]) != 4 or int(sb["gen"]) != 4:
            raise AssertionError(f"cli: gen {a2['gen']} / {sb['gen']}, expected 4")
        _same_state("cli: resumed A2 vs uninterrupted B", a2, sb)
        os.makedirs(w)
        t = time.perf_counter()
        _write_converted(w)
        write_s = time.perf_counter() - t
        _cli_run("C", c, "StyleGAN2_ffhq_d", 2, want, "--weights", w,
                 "--clip-weights", os.path.join(w, "clip.npz"))
        _same_state("cli: converted checkpoints C vs random:0 A1",
                    _npz(os.path.join(c, "ga_state.npz")), a1)
        _cli_run("D", d, "StyleGAN2_ffhq_nod", 2, want)
        sd = _npz(os.path.join(d, "ga_state.npz"))
        with open(os.path.join(d, "genetic_result"), "rb") as f:
            res = pickle.load(f)
        ls = _npz(os.path.join(d, "ls_result.npz"))
        order = np.argsort(sd["F"][:, 0])
        if not np.array_equal(ls["z"], sd["X"][order]):
            raise AssertionError("cli D: ls_result is not the population sorted by fitness")
        if res["X"].shape != (sd["X"].shape[1],) or res["F"].shape != (1,):
            raise AssertionError(f"cli D: genetic_result X {res['X'].shape}, "
                                 f"F {res['F'].shape}: not a single row")
        log({"phase": "cli", "check": "A2 == B and C == A1 bitwise; D's GA artifacts",
             "converted_write_s": write_s, "converted_bytes": sum(
                 os.path.getsize(os.path.join(w, f)) for f in os.listdir(w))})
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 8-12: BigGAN-deep

# the configs' own populations (clip_glass_torch/config.py)
BIGGAN_POP = {"DeepMindBigGAN256": 64, "DeepMindBigGAN512": 32}
BIGGAN_GENERATIONS = 2


def _biggan_cfg(name: str):
    from clip_glass_torch.config import get_config
    from clip_glass_torch.models.biggan import model as bg

    return bg.CONFIGS[f"biggan-deep-{get_config(name).resolution}"]


def biggan_shapes(cfg, pop: int):
    """Per-evaluation call shapes of kernel 4 for BigGAN-deep config `cfg`,
    (B, n, C', pad0, modulated): the [2,2] folds of each block whose mid
    segment runs in the s2d domain (output resolution >= s2d_min_res and
    4 * mid <= 512; C' = 4 * mid), one weight set for every sample. A
    same-resolution block folds conv_1 (lattice 0 -> -1, pad0 1) and conv_2
    (-1 -> 0, pad0 0); an up block only conv_2 (-1 -> 0): its conv_1 is the
    nearest-up fold, a cuDNN conv."""
    shapes = []
    res = 4
    for up, in_m, _ in cfg.layers:
        out_res = 2 * res if up else res
        mid = cfg.channel_width * in_m // 4
        if out_res >= cfg.s2d_min_res and 4 * mid <= 512:
            n = out_res // 2
            if not up:
                shapes.append((pop, n, 4 * mid, 1, False))
            shapes.append((pop, n + 1, 4 * mid, 0, False))
        res = out_res
    return shapes


def phase_kernels_biggan(summary: dict) -> None:
    """Kernel 4 at every BigGAN call shape, bf16, measured as phase 3
    measures the flagship's (the first design beside the wgmma variant);
    the per-evaluation sums of each config go to summary["s2d_conv2x2"]
    ["biggan"]."""
    from clip_glass_torch.ops import s2d

    gen = torch.Generator(device="cuda").manual_seed(3)
    k4 = s2d.s2d_conv2x2
    out = {}
    for name, pop in BIGGAN_POP.items():
        counts = _counts(biggan_shapes(_biggan_cfg(name), pop))
        recs = {}
        for shape in counts:
            args = _s2d_case(shape, torch.bfloat16, gen)
            n_bytes, n_ops = _s2d_cost(shape, args)
            first = expected_variant("s2d_conv2x2", shape) == FIRST_DESIGN["s2d_conv2x2"]
            rec = _measure(k4, s2d.s2d_conv2x2_plain, args, torch.bfloat16, shape, n_bytes,
                           n_ops, _s2d_library(args), scaled=True,
                           peak=PEAK_BF16_TC_OPS_PER_S,
                           previous=None if first else _s2d_previous(args), device_time=True)
            rec["variant"] = _variant_of(k4, args)
            _check_variant("s2d_conv2x2", shape, rec)
            rec.update(config=name, launches_per_evaluation=counts[shape])
            log(rec)
            recs[shape] = (rec, n_bytes, n_ops)
            del args
            torch.cuda.empty_cache()
        tot = _path_sum(counts, recs, PEAK_BF16_TC_OPS_PER_S)
        tot["launches_by_variant"] = {}
        for shape, count in counts.items():
            v = recs[shape][0]["variant"]
            tot["launches_by_variant"][v] = tot["launches_by_variant"].get(v, 0) + count
        out[name] = tot
    summary["s2d_conv2x2"]["biggan"] = out


def lively_biggan(cfg, seed: int):
    """BigGAN weights with no near-flat term, for comparisons: the random
    tree's leaves redrawn from a generator seeded `seed` (weights at
    1/sqrt(fan_in), running variances in [0.5, 1.5), BN gains around 1,
    running means, biases and the attention gain at 0.3 N(0, 1))."""
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.weights import from_jax

    g = torch.Generator().manual_seed(seed)

    def draw(t, key=""):
        if isinstance(t, dict):
            return {k: draw(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [draw(v) for v in t]
        r = torch.randn(t.shape, generator=g)
        if key == "w":
            return r / math.sqrt(math.prod(t.shape[:-1]))
        if key == "running_vars":
            return 0.5 + torch.rand(t.shape, generator=g)
        return 1.0 + 0.2 * r if key == "weight" else 0.3 * r

    return from_jax.convert_biggan(draw(bg.init_tree(g, cfg)))


def phase_agreement_biggan() -> None:
    """The TINY BigGAN GA fitness on the GPU (kernels) against the CPU
    (plain versions), fp32, on lively weights: plain (bg.TINY, no kernel)
    and with both blocks' mid segments in the s2d domain (s2d_min_res=4:
    kernel 4 twice in the 4 px block, once in the up block).
    tests/test_torch_cuda.py runs this same check."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.sampling import mixed_biggan_sampling
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model

    cfg = get_config("DeepMindBigGAN512").replace(
        pop_size=8, dim_z=16, num_classes=10, n_var=26, resolution=8, weights="random:0",
        target=TARGET, compute_dtype="float32")
    X = mixed_biggan_sampling(torch.Generator().manual_seed(1), 8, 16, 10, bool_prob=0.3)
    bundle = {"clip": clip_model.init(torch.Generator().manual_seed(0), clip_model.TINY),
              "g": lively_biggan(bg.TINY, 1)}
    _agreement("BigGAN", cfg, X, {
        "TINY": (bg.TINY, (0, 0, 0, 0)),
        "TINY_S2D": (dataclasses.replace(bg.TINY, s2d_min_res=4), (0, 0, 0, 3))}, bundle)


def phase_main_biggan(name: str, kind: str, smi: str, summary: dict):
    """The config's GA at full width (its own population, bf16, ViT-B/32,
    random weights from seed 0), init + BIGGAN_GENERATIONS generations,
    with kernel 4's counts set to 0 just before and read just after: it must
    launch as phase 8 saw the wrapper choose at the config's call shapes,
    and kernels 1-3 never. Then the G and CLIP stage times of one
    evaluation of the final population (CUDA events, mean of 3)."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    config = get_config(name).replace(target=TARGET, weights="random:0")
    pop = config.pop_size
    t = time.perf_counter()
    problem = GenerationProblem(config, device="cuda")
    algorithm = problem.make_algorithm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    gen = algorithm.generator(0)
    _zero_counts(kernels)
    t = time.perf_counter()
    state = algorithm.init(gen)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    init_s = stamps[0] - t

    def on_generation(_state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = minimize(algorithm, BIGGAN_GENERATIONS, gen, callback=on_generation, save_each=1,
                   state=state)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    variants = dict(kernels[3].launches_by_variant)
    peak = torch.cuda.max_memory_allocated()

    Fp = res.pop_F
    if tuple(Fp.shape) != (pop, 1) or not torch.isfinite(Fp).all():
        raise AssertionError(f"{name}: bad fitness: shape {tuple(Fp.shape)}, {Fp}")
    if not (Fp[:, 0].abs() <= 1.0 + 1e-6).all():
        raise AssertionError(f"{name}: |cos| > 1: {Fp[:, 0]}")
    n_eval = BIGGAN_GENERATIONS + 1
    want = {v: n * n_eval
            for v, n in summary["s2d_conv2x2"]["biggan"][name]["launches_by_variant"].items()}
    if {v: n for v, n in variants.items() if n} != want:
        raise AssertionError(f"{name}: s2d_conv2x2 launches by variant {variants}, "
                             f"expected {want}")
    if any(launches[k.__name__] for k in kernels[:3]):
        raise AssertionError(f"{name}: a StyleGAN2 kernel launched: {launches}")

    X = res.pop_X.cuda()
    with torch.inference_mode():
        imgs = problem.generator.generate(X)
        stage_ms = {"G": time_ms(lambda: problem.generator.generate(X), 3, warmup=1),
                    "CLIP": time_ms(lambda: problem.generator.clip_similarity(imgs), 3,
                                    warmup=1),
                    "evaluation": time_ms(lambda: problem.generator.eval_population(X), 3,
                                          warmup=1)}
    gen_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    log({"phase": "main", "path": "biggan", "config": name,
         "model": f"BigGAN-deep {config.resolution}px (s2d mid segments from "
                  f"{_biggan_cfg(name).s2d_min_res} px)",
         "clip": "VIT_B_32", "pop": pop, "compute_dtype": config.compute_dtype,
         "generations": BIGGAN_GENERATIONS, "setup_s": setup_s, "init_eval_s": init_s,
         "generation_s": gen_s, "candidates_per_s": [pop / s for s in gen_s],
         "stage_ms": stage_ms, "max_memory_allocated_bytes": peak,
         "best_cos": -Fp[:, 0].min().item(), "launches": launches,
         "launches_by_variant": {"s2d_conv2x2": variants},
         "launches_by_variant_per_evaluation": {v: n // n_eval for v, n in want.items()},
         "device": kind, "nvidia_smi": smi})
    del problem, algorithm, res, state, X, imgs
    torch.cuda.empty_cache()
    return launches["s2d_conv2x2"], variants


def phase_domains_biggan() -> None:
    """One fp32 DeepMindBigGAN256 evaluation (random weights from seed 0,
    its pop 64) of one population in both domains (s2d mid segment at 256
    px; s2d_min_res=2**30), TF32 off: exact rewrites of each other, so they
    differ by summation order only. Printed, not asserted."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.sampling import mixed_biggan_sampling
    from clip_glass_torch.fitness.problem import GenerationProblem

    config = get_config("DeepMindBigGAN256").replace(
        target=TARGET, weights="random:0", compute_dtype="float32")
    X = mixed_biggan_sampling(torch.Generator().manual_seed(2), config.pop_size)
    base = _biggan_cfg("DeepMindBigGAN256")
    Fs = {}
    for path, model_cfg in (("s2d", base),
                            ("plain", dataclasses.replace(base, s2d_min_res=2 ** 30))):
        problem = GenerationProblem(config, device="cuda", model_cfg=model_cfg)
        Fs[path] = problem.generator.eval_population(X.cuda()).cpu().double()
        del problem
        torch.cuda.empty_cache()
    diff = (Fs["s2d"] - Fs["plain"]).abs()
    log({"phase": "domains", "config": "DeepMindBigGAN256 fp32", "pop": config.pop_size,
         "max_abs_diff": diff.max().item(),
         "max_rel_diff_to_scale": (diff.max() / Fs["plain"].abs().max()).item(),
         "objective_scale": Fs["plain"].abs().max().item(),
         "objective_spread": (Fs["plain"].max() - Fs["plain"].min()).item()})


def phase_cli_biggan() -> None:
    """`cli.main` with no --config: DeepMindBigGAN512 at full width, its
    pop 32, random weights from seed 0, 2 generations; only kernel 4
    launches, on both variants."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "e")
        _cli_run("E", folder, None, 2, {"s2d_conv2x2": {"wmma", "wgmma"}}, pop=None)
        ls = _npz(os.path.join(folder, "ls_result.npz"))
        shapes = {k: v.shape for k, v in ls.items()}
        if shapes != {"z": (32, 128), "class_labels": (32, 1000)}:
            raise AssertionError(f"cli E: ls_result.npz holds {shapes}")
        if not abs(float(ls["class_labels"].sum()) - 32.0) < 1e-3:
            raise AssertionError("cli E: class_labels are not softmax rows")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 13-15: GPT-2 img2txt

DOG = os.path.join(ROOT, "examples", "gpt2_images", "dog.jpeg")
GPT2_GENERATIONS = 2


def _gpt2_tiny_config():
    from clip_glass_torch.config import get_config

    return get_config("GPT2").replace(pop_size=8, dim_z=6, n_var=6, max_tokens_len=5,
                                      weights="random:0", target=DOG, compute_dtype="float32")


def phase_agreement_gpt2() -> None:
    """The TINY GPT2 problem (random weights drawn on the CPU, so the same on
    both devices) on the GPU against the CPU, fp32, TF32 off: the decoded
    ids of `generate` and of a longer `sample_sequence` token-exact, the
    fitness within 1e-6; both tokenizers on the native merge core; no kernel
    of the package launches. tests/test_torch_cuda.py runs this same check."""
    from clip_glass_torch.evolve.sampling import int_random_sampling
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.gpt2 import model as g2
    from clip_glass_torch.tokenizers import get_clip_tokenizer, get_gpt2_tokenizer

    routes = {"gpt2": get_gpt2_tokenizer().native is not None,
              "clip": get_clip_tokenizer().native is not None}
    if not all(routes.values()):
        raise AssertionError(f"a tokenizer fell back to the Python merge loop: {routes}")
    cfg = _gpt2_tiny_config()
    X = int_random_sampling(torch.Generator().manual_seed(1), 8, 6, 0, 50256)
    kernels = _kernels()
    _zero_counts(kernels)
    out = {}
    for dev in ("cpu", "cuda"):
        gen = GenerationProblem(cfg, device=dev, clip_cfg=clip_model.TINY,
                                model_cfg=g2.TINY).generator
        Xd = X.to(dev)
        with torch.inference_mode():
            ctx = torch.cat([Xd[:, :3].to(torch.int32), gen.init_tokens.expand(8, -1)], 1)
            out[dev] = (gen.generate(Xd).cpu(), gen.eval_population(Xd).cpu(),
                        g2.sample_sequence(gen.g_params, ctx, 24, g2.TINY).cpu())
    launches = {k.__name__: k.launches for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"gpt2 agreement: a kernel launched: {launches}")
    for i, what in ((0, "generate"), (2, "sample_sequence")):
        if not torch.equal(out["cuda"][i], out["cpu"][i]):
            raise AssertionError(f"gpt2 {what}: ids on the GPU differ from the CPU: "
                                 f"{out['cuda'][i]} vs {out['cpu'][i]}")
    err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    if not err <= 1e-6:
        raise AssertionError(f"gpt2 fitness: GPU {out['cuda'][1]} vs CPU {out['cpu'][1]}")
    log({"phase": "agreement", "config": "GPT2 TINY fp32", "max_abs_err": err,
         "ids_equal": True, "native_bpe": routes,
         "fitness": out["cpu"][1][:, 0].tolist()})


def gpt2_bounds(cfg, pop: int, T0: int, length: int, itemsize: int = 2) -> dict:
    """The least times of one decode from the shapes (bytes over 3.35 TB/s,
    operations over 989 TFLOP/s bf16): a decode step reads every block
    weight and the tied embedding once and the cache written so far; the
    prefill does 2 operations a parameter a token (the LM head included)."""
    D, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    block = L * (12 * D * D + 13 * D)               # attn + mlp weights and biases, LNs
    params = block + V * D + cfg.n_positions * D + 2 * D
    step_bytes = (block + V * D) * itemsize
    cache_bytes = L * 2 * pop * (T0 + length) * D * itemsize
    steps_ms = sum(bound_ms(step_bytes + cache_bytes * (T0 + s) // (T0 + length),
                            2 * (block + V * D) * pop, PEAK_BF16_TC_OPS_PER_S)[0]
                   for s in range(1, length))
    prefill_ops = 2 * (block + V * D) * pop * T0
    prefill = bound_ms(step_bytes + cache_bytes * T0 // (T0 + length), prefill_ops,
                       PEAK_BF16_TC_OPS_PER_S)
    return {"parameters": params, "weights_bf16_bytes": params * itemsize,
            "decode_step_bytes": step_bytes, "kv_cache_bytes": cache_bytes,
            "decode_step_ms": bound_ms(step_bytes, 0)[0],
            "decode_steps": length - 1, "decode_steps_ms": steps_ms,
            "prefill_tokens": pop * T0, "prefill_ops": prefill_ops,
            "prefill_ms": prefill[0], "prefill_bound_by": prefill[1],
            "decode_ms": prefill[0] + steps_ms}


def _decode_launches(generator, X) -> dict:
    """Kernels on the device and kernel launches issued by the host over one
    decode (torch.profiler), per generated token; the device's busy time
    (the kernels' durations) and its idle share between the first kernel's
    start and the last one's end."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        generator.generate(X)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e.time_range for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                               "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    n = generator.config.max_tokens_len
    out = {"device_kernels": len(kernels), "host_launch_calls": host, "tokens": n,
           "device_kernels_per_token": len(kernels) / n, "host_launch_calls_per_token": host / n,
           "device_busy_ms": None, "device_span_ms": None, "idle_share": None}
    if kernels:
        busy = sum(r.end - r.start for r in kernels) / 1e3
        span = (max(r.end for r in kernels) - min(r.start for r in kernels)) / 1e3
        out.update(device_busy_ms=busy, device_span_ms=span, idle_share=1.0 - busy / span)
    return out


def _round_trip_routes(gen, ids, reps: int = 3) -> dict:
    """The host round trip (`_texts_to_clip_tokens`) on one population's
    decoded ids by each merge route, on the host clock: `cold` with the
    tokenizers' per-token caches emptied first (a search's first
    evaluation), `warm` right after on the same ids (every pre-token
    cached). Both routes must give the same CLIP tokens."""
    import numpy as np

    from clip_glass_torch.tokenizers import get_clip_tokenizer, get_gpt2_tokenizer
    from clip_glass_torch.tokenizers.clip_bpe import SPECIALS

    toks = (get_gpt2_tokenizer(), get_clip_tokenizer())
    native = [t.native for t in toks]
    out, want = {}, None
    try:
        for route in ("native", "python"):
            rec = {"cold_ms": [], "warm_ms": []}
            for _ in range(reps):
                for t, n in zip(toks, native):
                    t.native = n if route == "native" else None
                    t._id_cache = {}
                toks[1]._cache = {s: s for s in SPECIALS}
                for phase in ("cold_ms", "warm_ms"):
                    t0 = time.perf_counter()
                    got = gen._texts_to_clip_tokens(ids)
                    rec[phase].append((time.perf_counter() - t0) * 1e3)
                    want = got if want is None else want
                    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                        raise AssertionError(f"round trip: the {route} route's tokens differ")
            out[route] = rec
    finally:
        for t, n in zip(toks, native):
            t.native = n
    return out


def phase_main_gpt2(kind: str, smi: str) -> None:
    """GPT2 at full width: GPT-2 124M and CLIP ViT-B/32 (random weights from
    seed 0), pop 100, bf16, init + GPT2_GENERATIONS generations with the
    kernels' counts set to 0 just before (none may launch). Each evaluation
    records whether an overflow zeroed it. Then, on the final population,
    three evaluations split with CUDA events and the host clock: the
    decode (prefill + 29 steps), the host round trip (copy, GPT-2 decode,
    CLIP encode, copy back) and the CLIP text tower; and the round trip on
    the native merge core against the Python loop, on the same ids."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    config = get_config("GPT2").replace(target=DOG, weights="random:0")
    pop = config.pop_size
    t = time.perf_counter()
    problem = GenerationProblem(config, device="cuda")
    algorithm = problem.make_algorithm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    gen = problem.generator
    zeroed = []
    evaluate = algorithm.eval_fn

    def recording_eval(X):
        F = evaluate(X)
        zeroed.append(bool((F == 0).all().item()))
        return F

    algorithm.eval_fn = recording_eval
    torch.cuda.reset_peak_memory_stats()
    rng = algorithm.generator(0)
    _zero_counts(kernels)
    t = time.perf_counter()
    state = algorithm.init(rng)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    init_s = stamps[0] - t

    def on_generation(_state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = minimize(algorithm, GPT2_GENERATIONS, rng, callback=on_generation, save_each=1,
                   state=state)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise AssertionError(f"gpt2 main: a kernel launched: {launches}")
    Fp = res.pop_F
    if tuple(Fp.shape) != (pop, 1) or not torch.isfinite(Fp).all() \
            or not (Fp.abs() <= 1.0 + 1e-6).all():
        raise AssertionError(f"gpt2 main: bad fitness {tuple(Fp.shape)}: {Fp}")
    X = res.pop_X.cuda()
    if not torch.equal(X, X.round()) or X.min() < 0 or X.max() > 50256:
        raise AssertionError("gpt2 main: genes are not token ids")

    bundle = gen.bundle
    split = []
    with torch.inference_mode():
        for _ in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            ids = gen.generate(X)
            ev[1].record()
            ev[1].synchronize()
            t1 = time.perf_counter()
            toks, ok = gen._place_like(X, *gen._texts_to_clip_tokens(ids.cpu().numpy()))
            t2 = time.perf_counter()
            ev[2].record()
            gen._text_similarity(toks, ok, bundle)
            ev[3].record()
            ev[3].synchronize()
            split.append({"decode_ms": ev[0].elapsed_time(ev[1]),
                          "decode_host_ms": (t1 - t0) * 1e3,
                          "host_round_trip_ms": (t2 - t1) * 1e3,
                          "clip_text_ms": ev[2].elapsed_time(ev[3]),
                          "evaluation_ms": (time.perf_counter() - t0) * 1e3})
        split = split[1:]   # the first is a warm-up
        texts = gen.decode_texts(ids.cpu().numpy())
        routes = _round_trip_routes(gen, ids.cpu().numpy())
    launch = _decode_launches(gen, X)
    gen_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    T0 = config.dim_z + len(gen.init_tokens)
    log({"phase": "main", "path": "gpt2", "config": "GPT2",
         "model": "GPT-2 124M, argmax decode of 30 tokens", "clip": "VIT_B_32", "pop": pop,
         "compute_dtype": config.compute_dtype, "generations": GPT2_GENERATIONS,
         "setup_s": setup_s, "init_eval_s": init_s, "generation_s": gen_s,
         "candidates_per_s": [pop / s for s in gen_s], "evaluation_split": split,
         "round_trip_by_route": routes,
         "overflow_zeroed_evaluations": zeroed, "max_memory_allocated_bytes": peak,
         "best_cos": -Fp[:, 0].min().item(), "decode_launches": launch,
         "bounds": gpt2_bounds(gen.model_cfg, pop, T0, config.max_tokens_len),
         "captions_sample": texts[:3], "launches": launches, "device": kind,
         "nvidia_smi": smi})
    del problem, algorithm, res, state, X, gen, bundle
    torch.cuda.empty_cache()


def phase_cli_gpt2() -> None:
    """`cli.main --config GPT2` at full width (its pop 100, random weights):
    F1 2 generations, F2 F1's folder resumed to 4, G 4 straight; the .txt
    artifact set, int32 ids in ls_result.npz, and F2's whole ga_state.npz
    equal to G's bitwise. No kernel of the package launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        f, g = os.path.join(tmp, "f"), os.path.join(tmp, "g")
        _cli_run("F1", f, "GPT2", 2, {}, pop=None, target=DOG)
        _cli_run("F2", f, "GPT2", 4, {}, "--resume", first_gen=2, pop=None, target=DOG)
        _cli_run("G", g, "GPT2", 4, {}, pop=None, target=DOG)
        sf, sg = _npz(os.path.join(f, "ga_state.npz")), _npz(os.path.join(g, "ga_state.npz"))
        if int(sf["gen"]) != 4 or int(sg["gen"]) != 4:
            raise AssertionError(f"cli gpt2: gen {sf['gen']} / {sg['gen']}, expected 4")
        _same_state("cli: resumed F2 vs uninterrupted G", sf, sg)
        ls = _npz(os.path.join(g, "ls_result.npz"))["z"]
        if ls.dtype.name != "int32" or ls.shape != (100, 20):
            raise AssertionError(f"cli G: ls_result z {ls.dtype} {ls.shape}")
        with open(os.path.join(g, "genetic-it-final.txt")) as fh:
            lines = fh.read().split("\n")
        if len(lines) != 100 or not all(t.startswith("the picture of") for t in lines):
            raise AssertionError(f"cli G: genetic-it-final.txt holds {lines[:3]}...")
        log({"phase": "cli", "check": "GPT2: F2 == G bitwise; the .txt artifact set",
             "captions_sample": lines[:3]})
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 16: checkpoints


def _same_params(label: str, got, want) -> None:
    """Two parameter trees equal leaf by leaf, dtypes and bits."""
    from clip_glass_torch.core import pytree

    fg, fw = pytree.flatten(got), pytree.flatten(want)
    if fg.keys() != fw.keys():
        raise AssertionError(f"{label}: keys differ: {sorted(set(fg) ^ set(fw))[:5]}")
    for k in fg:
        if fg[k].dtype != fw[k].dtype or not torch.equal(fg[k], fw[k]):
            raise AssertionError(f"{label}: {k} differs")


def _timed(fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t


def _convert_cli(kind: str, src: str, dst: str, *extra) -> float:
    """The port's convert CLI in-process; its seconds."""
    import contextlib
    import io

    from clip_glass_torch.weights import convert_weights

    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = convert_weights.main([kind, src, dst, *extra])
    if rc != 0:
        raise AssertionError(f"convert_weights {kind} {src}: exit {rc}")
    return time.perf_counter() - t


def _npz_tree(path: str):
    from clip_glass_torch.core import pytree

    return pytree.restore_lists(pytree.load_npz(path))


def direct_vs_converted(paths: dict, conv: str) -> list:
    """Phase 16 (a): for every file `weights.synthesize.write_all` wrote
    (`paths`), the direct load against the load of the npz the convert CLI
    wrote from it into `conv`: equal leaf by leaf (torch.equal), with equal
    configs; each at its published geometry. Returns one record a file:
    its size, the direct load's seconds, the conversion's, the npz load's."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.generator import _load_biggan, _load_gpt2
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.gpt2 import model as g2
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.weights import convert_stylegan2, convert_stylegan2_tf, from_jax, load

    recs = []

    def record(name, direct_s, convert_s, npz_s, **extra):
        rec = {"phase": "checkpoints", "check": "direct == converted", "file": name,
               "bytes": os.path.getsize(paths[name]), "direct_load_s": direct_s,
               "convert_s": convert_s, "npz_load_s": npz_s, **extra}
        log(rec)
        recs.append(rec)

    def stylegan2_tree(tree, kind):
        return (from_jax.convert_generator if kind == "G" else from_jax.convert_discriminator)(tree)

    # StyleGAN2 config-f .pth: Gs, G (EMA and training generators) and D
    out = os.path.join(conv, "stylegan2")
    convert_s = _convert_cli("stylegan2", os.path.dirname(paths["stylegan2/Gs.pth"]), out)
    for stem in ("Gs", "G", "D"):
        name = f"stylegan2/{stem}.pth"
        (tree, cfg, kind), direct_s = _timed(convert_stylegan2.load_pth, paths[name])
        direct = stylegan2_tree(tree, kind)
        npz = os.path.join(out, f"{stem}.npz")
        tree, npz_s = _timed(_npz_tree, npz)
        if load.read_cfg_sidecar(npz, sg2.SG2Config) != cfg:
            raise AssertionError(f"{name}: the sidecar's config differs")
        if kind == "G" and cfg != sg2.CONFIG_F:
            raise AssertionError(f"{name}: {cfg} is not config-f")
        _same_params(name, direct, stylegan2_tree(tree, kind))
        record(name, direct_s, convert_s / 3, npz_s)

    # the TF pickle: G, D, Gs and the generators' noise planes
    name = "stylegan2-ffhq-config-f.pkl"
    out = os.path.join(conv, "stylegan2-tf")
    convert_s = _convert_cli("stylegan2-tf", paths[name], out)
    nets, direct_s = _timed(convert_stylegan2_tf.convert_pkl, paths[name])
    t = time.perf_counter()
    for key, net in nets.items():
        npz = os.path.join(out, f"{key}.npz")
        tree, cfg = net[0], net[1]
        kind = "D" if key == "D" else "G"
        if load.read_cfg_sidecar(npz, sg2.SG2Config) != cfg:
            raise AssertionError(f"{name} {key}: the sidecar's config differs")
        _same_params(f"{name} {key}", stylegan2_tree(tree, kind),
                     stylegan2_tree(_npz_tree(npz), kind))
        if kind == "G":
            _same_params(f"{name} {key} noise", from_jax.convert_noise(net[2]),
                         from_jax.convert_noise(_npz_tree(os.path.join(out, f"{key}_noise.npz"))))
    record(name, direct_s, convert_s, time.perf_counter() - t,
           resolution=nets["Gs"][1].resolution, noise_planes=len(nets["Gs"][2]))
    del nets

    # CLIP ViT-B/32 and RN50: TorchScript archives and pickled state dicts, fp16
    for name in ("clip/ViT-B-32.pt", "clip/ViT-B-32-state-dict.pt", "clip/RN50.pt",
                 "clip/RN50-state-dict.pt"):
        npz = os.path.join(conv, name.replace("/", "_").replace(".pt", ".npz"))
        convert_s = _convert_cli("clip", paths[name], npz)
        (direct, cfg), direct_s = _timed(load.load_clip, paths[name])
        (got, got_cfg), npz_s = _timed(load.load_clip, npz)
        want_cfg = clip_model.RN50 if "RN50" in name else clip_model.VIT_B_32
        if not cfg == got_cfg == want_cfg:
            raise AssertionError(f"{name}: configs {cfg} / {got_cfg}")
        _same_params(name, direct, got)
        record(name, direct_s, convert_s, npz_s)

    # BigGAN-deep-512 and GPT-2 124M `.bin`s through the fitness loaders
    for name, loader, config, kind, want_cfg, extra in (
            ("biggan-deep-512-pytorch_model.bin", _load_biggan,
             get_config("DeepMindBigGAN512"), "biggan", bg.BIGGAN_DEEP_512,
             ("--model-name", "biggan-deep-512")),
            ("gpt2-pytorch_model.bin", _load_gpt2, get_config("GPT2"), "gpt2",
             g2.GPT2_124M, ())):
        npz = os.path.join(conv, f"{kind}.npz")
        convert_s = _convert_cli(kind, paths[name], npz, *extra)
        (direct, cfg), direct_s = _timed(loader, config.replace(weights=paths[name]), None)
        (got, got_cfg), npz_s = _timed(loader, config.replace(weights=npz), None)
        if not cfg == got_cfg == want_cfg:
            raise AssertionError(f"{name}: configs {cfg} / {got_cfg}")
        _same_params(name, direct, got)
        record(name, direct_s, convert_s, npz_s)
    return recs


def _clip_stage(g_dir: str, clip_file: str) -> dict:
    """The flagship's CLIP stage with the CLIP of `clip_file` (pop POP, bf16,
    G from `g_dir`): the phase-aware resize + image tower + cosine of one
    packed population (`clip_similarity_packed`), and the whole evaluation,
    CUDA events, mean of 10 and 3 calls."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem

    config = get_config("StyleGAN2_ffhq_d").replace(target=TARGET, weights=g_dir, pop_size=POP)
    gen = GenerationProblem(config, device="cuda", clip_weights=clip_file).generator
    X = torch.randn((POP, config.n_var), generator=torch.Generator().manual_seed(3)).cuda()
    with torch.inference_mode():
        img = gen.generate_packed(X)
        out = {"clip": gen.clip_cfg.vision_kind, "clip_ms": time_ms(
                   lambda: gen.clip_similarity_packed(img), 10),
               "evaluation_ms": time_ms(lambda: gen.eval_population(X), 3, warmup=1)}
    del gen, img
    torch.cuda.empty_cache()
    return out


def _one_evaluation(config, clip_file: str, X, label: str):
    """One full-width evaluation with the kernels' counts set to 0 just
    before and read just after; F must be finite, of the config's shape."""
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    gen = GenerationProblem(config, device="cuda", clip_weights=clip_file).generator
    _zero_counts(kernels)
    with torch.inference_mode():
        Fp = gen.eval_population(X.cuda())
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    if tuple(Fp.shape) != (X.shape[0], 1) or not torch.isfinite(Fp).all():
        raise AssertionError(f"{label}: bad fitness: shape {tuple(Fp.shape)}, {Fp}")
    return gen, Fp, launches


def phase_checkpoints(kind: str, smi: str, summary: dict) -> None:
    """Phase 16: the reference's checkpoint formats at their published
    geometries, written from seed 0 by weights/synthesize.py into one
    temporary directory (deleted at the end): (a) direct_vs_converted; (b)
    `cli.main --config StyleGAN2_ffhq_d` (pop 16, bf16) for 2 generations
    from Gs.pth + D.pth + ViT-B-32.pt, launching every kernel on the
    variants phase 3 saw, and the same run from the converted npz files,
    whose ga_state.npz must be equal bitwise; (c) the same search with
    RN50.pt, and the CLIP stage of both towers; (d) one full-width
    evaluation of DeepMindBigGAN512 from its .bin (kernel 4 launches) and of
    GPT2 from its .bin (no kernel launches), and the largest difference in
    BigGAN's F between its final-BN affine staged in bf16 (the rule of both
    packages) and kept in fp32 (printed, not asserted)."""
    import tempfile

    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.sampling import mixed_biggan_sampling
    from clip_glass_torch.weights import convert_biggan, from_jax, synthesize

    want = _flagship_variants(summary)
    with tempfile.TemporaryDirectory() as tmp:
        ref, conv = os.path.join(tmp, "ref"), os.path.join(tmp, "conv")
        paths, write_s = _timed(synthesize.write_all, ref, 0)
        log({"phase": "checkpoints", "written_s": write_s, "files": {
            name: os.path.getsize(p) for name, p in paths.items()}})
        direct_vs_converted(paths, conv)

        g_ref = os.path.dirname(paths["stylegan2/Gs.pth"])
        runs = {}
        for label, g_dir, clip_file in (
                ("H1", g_ref, paths["clip/ViT-B-32.pt"]),
                ("H2", os.path.join(conv, "stylegan2"), os.path.join(conv, "clip_ViT-B-32.npz")),
                ("I", g_ref, paths["clip/RN50.pt"])):
            folder = os.path.join(tmp, label)
            runs[label] = _cli_run(label, folder, "StyleGAN2_ffhq_d", 2, want,
                                   "--weights", g_dir, "--clip-weights", clip_file)
            runs[label]["state"] = _npz(os.path.join(folder, "ga_state.npz"))
        _same_state("checkpoints: .pth + .pt H1 vs converted npz H2",
                    runs["H1"]["state"], runs["H2"]["state"])
        log({"phase": "checkpoints", "check": "H1 == H2 bitwise; RN50 search I completed",
             "clip_stage": [_clip_stage(g_ref, paths[f"clip/{n}.pt"])
                            for n in ("ViT-B-32", "RN50")], "device": kind, "nvidia_smi": smi})

        name = "DeepMindBigGAN512"
        bin_path = paths["biggan-deep-512-pytorch_model.bin"]
        config = get_config(name).replace(target=TARGET, weights=bin_path)
        X = mixed_biggan_sampling(torch.Generator().manual_seed(4), config.pop_size)
        gen, Fp, launches = _one_evaluation(config, paths["clip/ViT-B-32.pt"], X, name)
        if not launches["s2d_conv2x2"] or any(
                n for k, n in launches.items() if k != "s2d_conv2x2"):
            raise AssertionError(f"{name} from its .bin: launches {launches}")
        raw = from_jax.convert_biggan(
            convert_biggan.load_torch_checkpoint(bin_path, "biggan-deep-512")[0])["bn"]
        g32 = {**gen.g_params, "bn": {**gen.g_params["bn"],
                                      **{k: raw[k].cuda() for k in ("weight", "bias")}}}
        with torch.inference_mode():
            F32 = gen.eval_population(X.cuda(), {**gen.bundle, "g": g32})
        staged = gen.g_params["bn"]["weight"].dtype
        log({"phase": "checkpoints", "config": name, "weights": os.path.basename(bin_path),
             "pop": config.pop_size, "launches": launches, "best_cos": -Fp.min().item(),
             "final_bn_affine_staged": str(staged),
             "max_abs_dF_bf16_vs_fp32_affine": (Fp - F32).abs().max().item(),
             "F_spread": (Fp.max() - Fp.min()).item()})
        del gen, g32, F32, raw
        torch.cuda.empty_cache()

        config = get_config("GPT2").replace(target=DOG,
                                            weights=paths["gpt2-pytorch_model.bin"])
        X = torch.randint(0, 50257, (config.pop_size, config.n_var),
                          generator=torch.Generator().manual_seed(5)).float()
        gen, Fp, launches = _one_evaluation(config, paths["clip/ViT-B-32.pt"], X, "GPT2")
        if any(launches.values()):
            raise AssertionError(f"GPT2 from its .bin: a kernel launched: {launches}")
        log({"phase": "checkpoints", "config": "GPT2", "weights": "gpt2-pytorch_model.bin",
             "pop": config.pop_size, "launches": launches, "best_cos": -Fp.min().item(),
             "zeroed_by_overflow": bool((Fp == 0).all())})
        del gen
    torch.cuda.empty_cache()


KERNEL_META = {
    "noise_bias_lrelu": ("clip_glass_torch/csrc/noise_bias_lrelu.cu",
                         "clip_glass_tpu/ops/pallas/fused_bias_act.py:33"),
    "upsample2x": ("clip_glass_torch/csrc/upsample2x.cu",
                   "clip_glass_tpu/ops/pallas/upfirdn2d.py:49"),
    "modulated_matmul": ("clip_glass_torch/csrc/modulated_matmul.cu",
                         "clip_glass_tpu/ops/pallas/modulated_matmul.py:35"),
    "s2d_conv2x2": ("clip_glass_torch/csrc/s2d_conv2x2.cu",
                    "clip_glass_tpu/ops/pallas/s2d_conv2x2.py:77"),
}


def main() -> int:
    t0 = time.perf_counter()
    kind = phase_device()
    smi = smi_line()
    phase_build()
    summary = phase_kernels()
    host = phase_host()
    phase_agreement()
    launches, variants = phase_main(kind, smi, "s2d", GENERATIONS, summary)
    plain_launches, _ = phase_main(kind, smi, "plain", GENERATIONS, summary)
    phase_domains()
    phase_cli(summary)
    phase_kernels_biggan(summary)
    phase_agreement_biggan()
    biggan = {name: phase_main_biggan(name, kind, smi, summary) for name in BIGGAN_POP}
    phase_domains_biggan()
    phase_cli_biggan()
    phase_agreement_gpt2()
    phase_main_gpt2(kind, smi)
    phase_cli_gpt2()
    phase_checkpoints(kind, smi, summary)
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        s, p = summary[name]["s2d"], summary[name]["plain"]
        keys = [k for k in s if k.endswith("ms") or k == "bound_by"]
        # the variant the main path ran (kernel 1 has one design)
        variant = ("+".join(v for v, n in variants[name].items() if n)
                   if name in variants else None)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(s["max_abs_err"], p["max_abs_err"]),
                        **{k: s[k] for k in keys}, "variant": variant,
                        "host_us_per_call": host.get(name),
                        "plain_path": {"launches": plain_launches[name],
                                       **{k: p[k] for k in keys}},
                        **({"biggan": {
                            cfg: {"launches": biggan[cfg][0],
                                  "launches_by_variant": biggan[cfg][1],
                                  "launches_per_evaluation": bs["launches_by_variant"],
                                  **{k: bs[k] for k in keys}, "max_abs_err": bs["max_abs_err"]}
                            for cfg, bs in summary[name]["biggan"].items()}}
                           if name == "s2d_conv2x2" else {}),
                        "scope": f"launches: init + {GENERATIONS} generations of each "
                                 f"path (main: s2d; plain_path: s2d_min_res=2**30); "
                                 f"times: sum over the call shapes of one evaluation "
                                 f"(pop {POP}, bf16); ms: back-to-back wrapper calls; "
                                 f"device_ms: the same calls replayed from a CUDA "
                                 f"graph; previous_ms, previous_device_ms: the first "
                                 f"design's kernel, the same two ways; "
                                 f"host_us_per_call: the wrapper's host time at its "
                                 f"4 px shape; max_abs_err: over both paths' shapes; "
                                 f"biggan: each config's GA, init + "
                                 f"{BIGGAN_GENERATIONS} generations (launches), sums over "
                                 f"its call shapes of one evaluation (its pop, bf16)"})
    log({"script_s": time.perf_counter() - t0})
    log({"kernels": kernels})
    log(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
