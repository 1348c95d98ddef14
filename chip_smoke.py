#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from the sources in this checkout;
  3. kernels: each kernel against its plain PyTorch version at every call
     shape of both flagship paths of phase 5 (bf16), at the largest of them
     in fp32 and at odd shapes (bf16 and fp32), with
     CUDA-event times of the kernel, the plain version and, where one
     PyTorch call computes the same function, that call; kernel 4 also
     records the variant each shape took (every flagship shape must take
     the TMA/wgmma one) and, at the flagship shapes, the time of the first
     design's bf16 kernel (`previous_ms`);
  4. agreement: the TINY search's fitness on the GPU (kernels) against the
     CPU (plain versions), fp32, in the plain domain (TINY) and in the s2d
     domain (TINY with s2d_min_res=8);
  5. main path: a StyleGAN2_ffhq_d NSGA-II search at full width
     (config-f 1024px G + D, CLIP ViT-B/32, pop 16, bf16, random weights
     from seed 0), init + 3 generations, with the kernels' launch counts:
     first the default path (the 512 and 1024 px levels in the s2d domain),
     then the plain domain (s2d_min_res=2**30);
  6. domains: one fp32 full-width evaluation of one population in both
     domains, and their largest difference (printed, not asserted).
The last lines are the kernels' summary (JSON), the card's name and power
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


def _iters(n_bytes: int) -> int:
    """Launches per timing: about 20 GB of traffic, 10 to 200 launches."""
    return int(min(200, max(10, 2e10 / max(n_bytes, 1))))


def _measure(kernel, plain, args, dtype, shape, n_bytes, n_ops, library=None,
             scaled=False, peak=PEAK_FP32_OPS_PER_S):
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = _check(kernel.__name__, got, want, dtype, shape, scaled)
    iters = _iters(n_bytes)
    rec = {"kernel": kernel.__name__, "shape": list(shape), "dtype": str(dtype),
           "max_abs_err": err,
           "kernel_ms": time_ms(lambda: kernel(*args), iters),
           "plain_ms": time_ms(lambda: plain(*args), iters)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_ops, peak)
    rec["library_ms"] = None
    if library is not None:
        lib_fn, lib_check = library
        lib_check(got)
        rec["library_ms"] = time_ms(lib_fn, iters)
    del got, want
    return rec


def _path_sum(counts, recs, has_library: bool, peak: float):
    """One evaluation's sums over a path's call shapes: times weighted by
    the launches at each shape, and the bound of the summed work."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0 if has_library else None,
           "max_abs_err": 0.0}
    if any("previous_ms" in rec for rec, _, _ in recs.values()):
        tot["previous_ms"] = 0.0
    work = [0, 0]  # bytes and operations
    for shape, count in counts.items():
        rec, n_bytes, n_ops = recs[shape]
        tot["ms"] += count * rec["kernel_ms"]
        tot["plain_ms"] += count * rec["plain_ms"]
        if has_library:
            tot["library_ms"] += count * rec["library_ms"]
        if "previous_ms" in tot:
            tot["previous_ms"] += count * rec["previous_ms"]
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

    # (name, kernel, plain, case, cost, library, index in flagship_shapes, odd shapes)
    specs = [
        ("noise_bias_lrelu", bias_act.noise_bias_lrelu, bias_act.noise_bias_lrelu_plain,
         _nbl_case, nbl_cost, None, 0, [(3, 5, 7, 20), (2, 3, 5, 7)]),
        ("upsample2x", upfirdn.upsample2x, upfirdn.upsample2x_plain,
         _ups_case, ups_cost, ups_library, 1, [(3, 5, 7, 3), (2, 4, 6, 16)]),
        ("modulated_matmul", modulated_conv.modulated_matmul,
         modulated_conv.modulated_matmul_plain, _rgb_case, rgb_cost, rgb_library,
         2, [(3, 37, 24, 3), (2, 50, 20, 12), (2, 33, 7, 5)]),
        ("s2d_conv2x2", s2d.s2d_conv2x2, s2d.s2d_conv2x2_plain, _s2d_case, _s2d_cost,
         _s2d_library, 3,
         [(3, 13, 20, 1, True), (2, 11, 20, 0, False), (2, 13, 64, 0, True),
          (3, 11, 64, 1, False), (2, 13, 128, 1, False), (2, 11, 128, 0, True),
          # ragged rows of 32-cell tiles (n_out 69-71, 128-130), both widths
          # of the wgmma variant, both halos, B of 1 and 3, both weight kinds
          (1, 70, 64, 1, True), (3, 70, 128, 0, False), (3, 129, 64, 0, False),
          (1, 129, 128, 1, True)]),
    ]
    summary = {}
    for name, kernel, plain, make, cost, library, idx, odd in specs:
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
            before = _variant_counts()
            rec = _measure(kernel, plain, args, torch.bfloat16, shape, n_bytes,
                           n_ops, library(args) if library else None, scaled,
                           peak(torch.bfloat16))
            if name == "s2d_conv2x2":
                rec["variant"] = _moved(before, _variant_counts())
                if rec["variant"] != "wgmma":
                    raise AssertionError(f"s2d_conv2x2 {shape}: a flagship shape took "
                                         f"{rec['variant']}, not wgmma")
                previous = _s2d_previous(args)
                _check("s2d_conv2x2 (wmma)", previous(), plain(*args), torch.bfloat16,
                       shape, scaled=True)
                rec["previous_ms"] = time_ms(previous, _iters(n_bytes))
            rec["launches_per_evaluation"] = {p: counts[p].get(shape, 0)
                                              for p in PER_EVAL}
            log(rec)
            recs[shape] = (rec, n_bytes, n_ops)
            del args
        summary[name] = {p: _path_sum(counts[p], recs, library is not None,
                                      peak(torch.bfloat16)) for p in PER_EVAL}
        # the largest flagship shape in fp32, and the odd shapes in both types
        extra = [(max(shapes, key=lambda s: math.prod(s[:3])), torch.float32)]
        extra += [(s, dt) for s in odd for dt in (torch.bfloat16, torch.float32)]
        for shape, dtype in extra:
            if name == "modulated_matmul" and shape in odd[1:]:
                args = _rgb_case(shape, dtype, gen, demod=True)
            else:
                args = make(shape, dtype, gen)
            n_bytes, n_ops = cost(shape, args)
            before = _variant_counts()
            rec = _measure(kernel, plain, args, dtype, shape, n_bytes, n_ops,
                           scaled=scaled, peak=peak(dtype))
            if name == "s2d_conv2x2":
                rec["variant"] = _moved(before, _variant_counts())
            log(rec)
            del args
        torch.cuda.empty_cache()
    return summary


def _variant_counts() -> dict:
    from clip_glass_torch.ops import s2d

    return dict(s2d.s2d_conv2x2.launches_by_variant)


def _moved(before: dict, after: dict) -> str:
    """The kernel-4 variants launched between two counts, joined by '+'."""
    return "+".join(v for v in after if after[v] != before[v])


# ------------------------------------------------------------ phase 4


def _kernels():
    from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn

    return (bias_act.noise_bias_lrelu, upfirdn.upsample2x,
            modulated_conv.modulated_matmul, s2d.s2d_conv2x2)


def phase_agreement():
    """TINY problem's fitness on the GPU (kernels) against the CPU (plain
    versions), fp32, in both domains; the GPU evaluation launches each
    kernel at every call site, the CPU one none. tests/test_torch_cuda.py
    runs this same check."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    kernels = _kernels()
    cfg = get_config("StyleGAN2_ffhq_d").replace(
        pop_size=8, dim_z=32, n_var=32, weights="random:0", target=TARGET,
        compute_dtype="float32")
    X = torch.randn((8, 32), generator=torch.Generator().manual_seed(1))
    # launches per evaluation. TINY (plain): 5 synthesis layers, 2 skip
    # upsamples, 3 ToRGB. TINY_S2D (levels 8 and 16 in the s2d domain): 5
    # layer epilogues, ToRGB at 4 px only, two [2,2] folds in G and two in D
    models = {"TINY": (sg2.TINY, (5, 2, 3, 0)),
              "TINY_S2D": (dataclasses.replace(sg2.TINY, s2d_min_res=8), (5, 0, 1, 4))}
    for label, (model_cfg, want) in models.items():
        Fs = {}
        for dev in ("cpu", "cuda"):
            p = GenerationProblem(cfg, device=dev, clip_cfg=clip_model.TINY,
                                  model_cfg=model_cfg)
            before = [k.launches for k in kernels]
            Fs[dev] = p.generator.eval_population(X.to(dev)).cpu()
            moved = tuple(k.launches - n for k, n in zip(kernels, before))
            if moved != (want if dev == "cuda" else (0, 0, 0, 0)):
                raise AssertionError(f"{label} {dev}: kernel launches {moved}")
        err = (Fs["cuda"] - Fs["cpu"]).abs().max().item()
        # fp32 on both sides with TF32 off: cuDNN/cuBLAS sum in another order
        # than the CPU kernels over ~20 layers
        if not torch.allclose(Fs["cuda"], Fs["cpu"], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"{label} fitness on the GPU disagrees with the CPU: "
                                 f"{Fs['cuda']} vs {Fs['cpu']}")
        log({"phase": "agreement", "config": f"{label} fp32", "max_abs_err": err,
             "launches": dict(zip([k.__name__ for k in kernels], want))})


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


def phase_main(kind: str, smi: str, path: str, generations: int):
    """The flagship search on one path; returns the kernels' launch counts
    of that run (counts set to 0 just before it, read just after)."""
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
    for k in kernels:
        k.launches = 0
    by_variant = kernels[-1].launches_by_variant
    for v in by_variant:
        by_variant[v] = 0
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
    variants = dict(by_variant)

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
    if variants["wgmma"] != launches["s2d_conv2x2"]:
        raise AssertionError(f"{path}: s2d_conv2x2 launches by variant {variants}")
    gen_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    log({"phase": "main", "path": path, "config": "StyleGAN2_ffhq_d",
         "model": "CONFIG_F 1024px" + ("" if path == "s2d" else ", s2d_min_res=2**30"),
         "clip": "VIT_B_32", "pop": POP, "compute_dtype": config.compute_dtype,
         "generations": generations, "setup_s": setup_s, "init_eval_s": init_s,
         "generation_s": gen_s,
         "candidates_per_s": [POP / s for s in gen_s],
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "best_cos": -Fp[:, 0].min().item(), "hinge_min": Fp[:, 1].min().item(),
         "launches": launches, "s2d_conv2x2_launches_by_variant": variants,
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
    kind = phase_device()
    smi = smi_line()
    phase_build()
    summary = phase_kernels()
    phase_agreement()
    launches, variants = phase_main(kind, smi, "s2d", GENERATIONS)
    plain_launches, _ = phase_main(kind, smi, "plain", GENERATIONS)
    phase_domains()
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        s, p = summary[name]["s2d"], summary[name]["plain"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        extra = {"variant": None}
        if name == "s2d_conv2x2":  # the variant the main path ran, and the
            # first design's bf16 kernel at the same shapes
            extra = {"variant": "+".join(v for v, n in variants.items() if n),
                     "previous_ms": s["previous_ms"]}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(s["max_abs_err"], p["max_abs_err"]),
                        **{k: s[k] for k in keys}, **extra,
                        "plain_path": {"launches": plain_launches[name],
                                       **{k: p[k] for k in keys}},
                        "scope": f"launches: init + {GENERATIONS} generations of each "
                                 f"path (main: s2d; plain_path: s2d_min_res=2**30); "
                                 f"times: sum over the call shapes of one evaluation "
                                 f"(pop {POP}, bf16); max_abs_err: over both paths' "
                                 f"shapes"})
    log({"kernels": kernels})
    log(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
