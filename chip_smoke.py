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
  3b. gradients (`phase_gradients`): each of kernels 1-4 under autograd,
     fp32 and bf16, at one flagship shape (kernel 4 also at C' = 256 with
     one shared set): a grad_fn, input gradients within TOL of the plain
     version's autograd on the card, the direct launch under
     inference_mode, and in fp32 a second derivative equal to the plain
     version's; the TINY G's latent gradient (plain domain) on the card
     against the CPU; conv_s8 raising under grad;
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
     names (wgmma_stream at C' = 256, wgmma at 128; the first design,
     wmma, beside each as `previous_*`, and at no fold of either config);
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
Then K searches of one config batched in one evaluation a generation
(evolve/batched.py) and the server over them (serving.py):
 17. batched kernels: kernels 1-4 against their plain versions at every
     call shape of one batched flagship evaluation, 4 searches x pop 16 =
     64 rows, bf16, both paths (the largest reach and pass 2**31
     elements), measured as phase 3 measures them, on the variants
     `expected_variant` names;
 18. batched agreement: K = 3 searches' batched fitness on the GPU against
     the CPU, TINY models, fp32: StyleGAN2 `_d` plain and s2d, `_nod`,
     BigGAN (s2d mid segments) and GPT-2; each kernel once per call site;
 19. batched main: StyleGAN2_ffhq_d at full width as 4 searches x pop 16
     (init + 2 generations, s2d path): each kernel once per call site and
     batched evaluation on phase 17's variants, each search's X0 its
     search_generator's bitwise, the batched F against the per-search
     evaluations and against search_microbatch=2 within BATCHED_BF16_TOL,
     s a generation, cand/s and peak memory beside phase 5's single search,
     the host time of the 4 `vary` halves; GPT2 as 2 searches x pop 100 (no
     kernel, F finite; the difference from per-search evaluation and the
     rows whose ids differ, printed; the decode and round trip in one group
     and in groups of one search); DeepMindBigGAN512 as 2 searches x pop 32
     (one batched evaluation: kernel 4, 1 wgmma_stream + 3 wgmma);
 20. batched and serve cli: `cli.main` at full width, M1 StyleGAN2_ffhq_d
     with 4 --target for 2 generations, M2 resumed to 4, M3 4 straight (M2's
     ga_state.npz equal to M3's bitwise; every search-NN/ with target.txt
     and the artifact set), S --serve of 3 prompts with --slots 2 (three
     request-NNNN/ folders with target.txt and the result artifacts, the
     slots' occupancy); every kernel on phase 17's variants.
Then the int8 quantized fitness (--quantize int8, ops/quant.py), whose
int8 convs run the hand-written conv_s8 (csrc/conv_s8.cu):
 21. int8 kernels: conv_s8 against its plain version, bitwise (int32
     accumulators and bf16 outputs), both entries (the fused one on a bf16
     activation with its x_inv_scale, as the int8 path calls it, and the
     int8 one), at every call shape of one int8 flagship evaluation (s2d
     path, pop 16) and at odd shapes (I = 3, O = 5, stride 2, lhs_dilation
     2 with k 1, 3 and 4, negative pads); per shape its route
     (`conv_s8_variant`), `kernel_ms`, `device_ms`, the first design's
     route (`previous_*`), the quantize passes it needed and those left, the
     weights' quantize and pack, the plain version, the bound (bytes of the
     bf16 activation, the int8 weights and the bf16 output over 3.35 TB/s,
     or the real products over 1,979 TOPS), and as yardsticks the port
     never calls an im2col copy + torch._int_mm and the bf16 conv the site
     replaces (cuDNN, kernel 4 at the [2,2] folds); launches per evaluation
     by route;
 22. int8 agreement: the TINY int8 fitness (quantize_min_ch = 1) on the GPU
     against the CPU with the CPU's scales: StyleGAN2 `_d` plain and s2d,
     `_nod`, BigGAN with s2d mid segments, `_d` s2d as K = 3 searches
     batched; conv_s8 once per call site, kernel 4 at none;
 23. int8 main: StyleGAN2_ffhq_d --quantize int8 at full width (init + 3
     generations): the calibration's call sites and seconds, conv_s8 at
     every site, kernel 4 at none, s a generation, cand/s and peak memory
     beside phase 5's bf16 run; collect_fidelity (4 pops x 16: Spearman,
     top-8 and NSGA-II survival overlap, |dF|, as measured on random
     weights); one DeepMindBigGAN256 int8 evaluation at pop 64 (conv_s8 at
     the s2d mid segments' sites only); GPT2 int8 (no site, F bitwise the
     bf16 F);
 24. int8 cli: `cli.main --quantize int8` on the flagship: Q1 2
     generations, Q2 resumed to 4, Q3 4 straight (Q2 == Q3 bitwise), S
     --serve of 2 prompts through 2 slots; each run's artifact set.
Then the projector and the metrics, on config-f 1024 px from a `Gs.pth` that
weights/synthesize.py writes (seed 0: random weights at a checkpoint's
scale; `random:0`'s images saturate, so a projection through the clamp gets
no gradient), fp32, with LPIPS-VGG16 and the FID InceptionV3 at their real
geometries, written in the reference's layouts and read back through the
convert CLI:
 25. projector: `Projector.project` for 20 steps, B = 1: each step's seconds
     and launches, every launch of kernels 1-3 recorded under grad through
     `cuda._KernelGrad` (17, 8 and 9 a step) and none of kernel 4 (the plain
     domain), the final render in the default domain (kernel 4), peak
     memory, the distance at the first step and after the last (it must
     fall); kernels 1-3 at the step's fp32 shapes, output and gradient
     against the plain versions; the loss's dlatent gradient through the
     kernels against the plain route; one first step, card against CPU, on
     config-f cut to 256 px;
 26. ppl: `PPL.evaluate`, 2 batches of 8 pairs, epsilon 1e-4, LPIPS: the
     value, s a batch, kernels 1-4 launched (kernel 4 at 512 and 1024 px);
 27. fid: `FID` over 2 x 64 G samples: s an Inception batch and a G batch,
     FID(A, A) about 0, FID(A, B).
Then the trainer (`training/trainer.py`), fp32, from the reference's resume
files (G.pth, Gs.pth and D.pth that weights/synthesize.py writes, seed 0):
 28. trainer: config-f 1024 px, batch 4, `TrainerConfig` defaults, 5 steps
     (R1 and the path length penalty at step 0, the penalty at step 4): per
     step its seconds, phases, peak memory, the launches of kernels 1-3, those
     under grad and the backward passes that kept their graph (the
     penalty's second derivative through kernels 2 and 3), the five logs
     (finite); G and D moved, Gs less than G; a checkpoint round trip,
     bitwise; one TrainLogger grid from Gs (kernel 4); the penalty's G
     gradient through the kernels vs the plain route; step 0 card vs CPU on
     config-f cut to 256 px.
Then population sharding and multi-process runs (clip_glass_torch/parallel),
from phase 28's config-f files, the flagship at pop 16, bf16, s2d path:
 29. sharded: (a) a one-process mesh over the box's cards, its evaluation
     bitwise the unsharded one; (b) two ranks of this script on the card
     (`--sharded-rank`, gloo), 8 rows a rank: F against the one-process F
     within BATCHED_BF16_TOL, the naive split (each half a population of
     its own) past it, then init + 3 generations with each rank's launches,
     s a generation and peak memory; (c) NCCL at world size 1, one
     generation; (d) `cli.main --distributed` in the two ranks: rank 0
     writes each artifact once, rank 1 nothing; (e) the data-parallel
     trainer in the two ranks, config-f cut to 256 px, batch 4, fp32, 2
     steps, each held against the one-process step.
 30. tp: CLIP tensor parallelism on the 2-D (pop, model) mesh and the
     memory from shapes alone: (a) two gloo ranks on the card as a (1, 2)
     mesh, CLIP split over them (12 -> 6 heads, 3072 -> 1536 MLP columns;
     text 8 -> 4 heads): the hinge bitwise the one-process hinge, the CLIP
     objective within BATCHED_BF16_TOL, fp32 image features within 1e-4 of
     the whole tower's, kernels 1-4 in each rank; (b) one process whose
     mesh lists the card 4 times, a (2, 2) mesh: F within BATCHED_BF16_TOL,
     init + 2 generations, kernels 1-4 in each position; (c)
     `dryrun_multichip(4)` on the card, and the estimates from shapes of the
     flagship evaluation (pop 16) and of the regularized training step
     (config-f 1024 px, batch 4, fp32), cuDNN's TF32 off and allowed, each
     within 1.0-1.15 of its measured allocated peak (an upper bound), with
     what the tracker did not see on the same run.
Then the port's contract entry point and its bench, on the flagship:
 31. bench: (a) `clip_glass_torch.entry.entry()` on the card, F [4, 2]
     finite with kernels 1-4's launches of one evaluation; (b)
     `bench_torch.py` twice, each in its own process (BENCH_GENS=3,
     BENCH_REPEATS=2, BENCH_CHECKSUM=1): bench.py's fields, 0 < mfu <= 1,
     the FLOP count of core/flops.py, the launches a timed evaluation; (c)
     the two runs' checksum_F, column sums and sha256_F, and whether F is
     bitwise equal across them: the hashes equal (noted);
     (d) `bench_torch.py` with BENCH_QUANT=int8 (conv_s8 at every site).
The last lines are the script's seconds, the kernels' summary (JSON; kernel
4's entry carries a `biggan` record per config, every entry a `batched`
record: phase 19's launches and phase 17's per-path sums, a `projector`
record: phase 25's launches, those under grad and, for kernels 1-3, the
errors at the step's shapes, a `ppl` record: phase 26's launches, and a
`trainer` record: phase 28's launches, under grad and under a second
derivative, kernel 4's in the grid, a `sharded` record: phase 29's
launches per rank in (b)'s generations and in (e)'s trainer steps, and a
`tp` record: phase 30's launches per rank in (a) and per position in (b), and
a `bench` record: phase 31's launches a timed evaluation in (b) and (d)), the
card's name and power limit, and {"ok": true, "device": {...}}.

Run: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
             device_time=False, iters=None):
    """One shape: the kernel checked against the plain version and timed
    (`iters` launches, default `_iters`); with `device_time` also through a
    CUDA graph; `previous` (a callable: the first design's kernel on the
    same operands) checked and timed the same ways."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = _check(kernel.__name__, got, want, dtype, shape, scaled)
    iters = iters or _iters(n_bytes)
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


def _nbl_cost(shape, args):
    B, H, W, C = shape
    return nbytes(*args) + nbytes(args[0]), 5 * B * H * W * C


def _ups_cost(shape, args):
    B, H, W, C = shape
    return 5 * nbytes(args[0]), 8 * 4 * B * H * W * C


def _rgb_cost(shape, args):
    B, P, I, O = shape
    x, style, w, d, bias = args
    return (nbytes(x, style, w, d, bias) + B * P * O * x.element_size(),
            2 * B * P * I * O)


def _ups_library(args):
    """One cuDNN transposed conv of the same function (groups=C)."""
    from clip_glass_torch.ops import upfirdn

    (x,) = args
    B, H, W, C = x.shape
    k1 = upfirdn.polyphase_taps()
    fir_t = torch.tensor([[a * b for b in k1] for a in k1], device="cuda")
    wt = fir_t.flip(0, 1).to(x.dtype)[None, None].expand(C, 1, 4, 4)
    xn = x.permute(0, 3, 1, 2)

    def fn():
        return F.conv_transpose2d(xn, wt, stride=2, groups=C)[:, :, :2 * H, :2 * W]

    def check(got):
        _check("conv_transpose2d", fn().permute(0, 2, 3, 1), got, x.dtype,
               tuple(x.shape))
    return fn, check


def _rgb_library(args):
    """One cuBLAS batched GEMM of the same function, the weights folded."""
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


def _kernel_specs():
    """(name, kernel, plain, case, cost, library, first design, index in
    flagship_shapes, odd shapes) of the four kernels."""
    from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn

    return [
        ("noise_bias_lrelu", bias_act.noise_bias_lrelu, bias_act.noise_bias_lrelu_plain,
         _nbl_case, _nbl_cost, None, None, 0, [(3, 5, 7, 20), (2, 3, 5, 7)]),
        # odd shapes: ragged rows, C = 3 and not, a tile's last rows (H = 21:
        # 8 + 8 + 5), rows of 16-byte multiples (W*C = 24, 96, 128) and not
        ("upsample2x", upfirdn.upsample2x, upfirdn.upsample2x_plain,
         _ups_case, _ups_cost, _ups_library, _ups_previous, 1,
         [(3, 5, 7, 3), (2, 4, 6, 16), (1, 21, 8, 3), (3, 9, 32, 3), (2, 11, 8, 16),
          (1, 13, 5, 7)]),
        # odd shapes: O = 3 on scalar rows and on rows of 3 vectors, O != 3,
        # launch-sized runs that end inside a warp's tile, and the same
        # above 2 Mi input values (bf16: the tensor-core variant)
        ("modulated_matmul", modulated_conv.modulated_matmul,
         modulated_conv.modulated_matmul_plain, _rgb_case, _rgb_cost, _rgb_library,
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


def _peak(name: str, dtype) -> float:
    """Kernel 4 computes bf16 on the tensor cores; the others, and kernel 4
    in fp32, on the CUDA cores."""
    return (PEAK_BF16_TC_OPS_PER_S if name == "s2d_conv2x2" and dtype == torch.bfloat16
            else PEAK_FP32_OPS_PER_S)


def phase_kernels():
    """Kernels vs plain versions at every call shape that either flagship
    path (s2d default, plain) gives them, bf16, each shape measured once;
    returns per-kernel, per-path summaries over one evaluation."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_shapes = {p: flagship_shapes(_model_cfg(p)) for p in PER_EVAL}
    specs = _kernel_specs()
    summary = {}
    for name, kernel, plain, make, cost, library, previous, idx, odd in specs:
        # kernel 4: outputs checked relative to their scale
        scaled = name == "s2d_conv2x2"

        def peak(dtype, name=name):
            return _peak(name, dtype)
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


# the input values up to which kernels 2 and 3 take their first design (the
# launch is the cost there), and kernel 2's tiled stage
UPS_LAUNCH_SIZED = 16 * 1024
RGB_LAUNCH_SIZED = 2 * 1024 * 1024
UPS_STAGE_BYTES = 32 * 1024


def expected_variant(name: str, shape) -> str:
    """The variant a bf16 call shape must take: kernels 2 and 3 their
    redesign above their launch-sized inputs (kernel 2 beyond 16 Ki input
    values with five input rows in a 32 KB stage, kernel 3 beyond 2 Mi with
    O = 3 and I of 32-512), the first design's up to them: at pop 16 the
    redesigns from 32 px up, at 64 rows from 16 px up; kernel 4's redesign
    at C' = 64 and 128 (every flagship call, BigGAN-deep-512's last blocks),
    the weight-streaming redesign at BigGAN-deep's C' = 256 (one shared
    set, which does not fit shared memory), the first design at other
    widths."""
    if name == "s2d_conv2x2":
        if shape[2] in (64, 128):
            return "wgmma"
        return "wgmma_stream" if shape[2] == 256 and not shape[4] else "wmma"
    if name == "upsample2x":
        B, H, W, C = shape
        return ("tiled" if B * H * W * C > UPS_LAUNCH_SIZED and 5 * W * C * 2 <= UPS_STAGE_BYTES
                else "rows")
    B, P, I, O = shape
    return ("mma" if B * P * I > RGB_LAUNCH_SIZED and O == 3 and I in (32, 64, 128, 256, 512)
            else "chunked")


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


# ------------------------------------------------------------ phase 3b

# one flagship call shape of each kernel (s2d path at 1024 px for kernel 4,
# the plain path's 1024 px layer for kernels 1-3), and kernel 4 at C' = 256
# with one shared weight set (BigGAN-deep's block 11, cut to 8 samples)
GRAD_SHAPES = [("noise_bias_lrelu", (POP, 128, 128, 64)),
               ("upsample2x", (POP, 256, 256, 3)),
               ("modulated_matmul", (POP, 256 * 256, 64, 3)),
               ("s2d_conv2x2", (POP, 257, 128, 1, True)),
               ("s2d_conv2x2", (8, 129, 256, 0, False))]


def _grad_inputs(args):
    return [a for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()]


def _wrapper_cases() -> dict:
    """name -> (wrapper, plain version, operand maker) of kernels 1-4."""
    from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn

    return {"noise_bias_lrelu": (bias_act.noise_bias_lrelu, bias_act.noise_bias_lrelu_plain,
                                 _nbl_case),
            "upsample2x": (upfirdn.upsample2x, upfirdn.upsample2x_plain, _ups_case),
            "modulated_matmul": (modulated_conv.modulated_matmul,
                                 modulated_conv.modulated_matmul_plain, _rgb_case),
            "s2d_conv2x2": (s2d.s2d_conv2x2, s2d.s2d_conv2x2_plain, _s2d_case)}


def _second_derivative_case(name, shape, gen):
    """A second derivative through the kernel's wrapper on fp32 operands
    (every float operand requiring grad): d/dinputs of sum_i (g_i * v_i),
    g = d sum(out^2 * r) / dinputs taken with create_graph, r and v seeded;
    through the wrapper (the kernel's forward, `cuda._KernelGrad`'s graph)
    and through the plain version on the same operands. Returns the largest
    difference relative to the plain second derivative's scale, after
    checking that the wrapper launched its kernel once and its backward kept
    its graph once."""
    from clip_glass_torch.ops import cuda

    wrapper, plain, make = _wrapper_cases()[name]
    args = make(shape, torch.float32, gen)
    inputs = _grad_inputs(args)
    for t in inputs:
        t.requires_grad_(True)
    out_shape = plain(*args).shape
    r = torch.randn(out_shape, generator=gen, device="cuda")
    v = [torch.randn(t.shape, generator=gen, device="cuda") for t in inputs]

    def second(fn):
        grads = torch.autograd.grad((fn(*args).square() * r).sum(), inputs, create_graph=True)
        total = sum((g * vv).sum() for g, vv in zip(grads, v))
        return torch.autograd.grad(total, inputs, allow_unused=True)

    key = plain.__name__.removesuffix("_plain")
    n0, d0 = wrapper.launches, cuda.with_grad.double.get(key, 0)
    got = second(wrapper)
    if wrapper.launches != n0 + 1 or cuda.with_grad.double.get(key, 0) != d0 + 1:
        raise AssertionError(f"{name} {shape}: {wrapper.launches - n0} launches, "
                             f"{cuda.with_grad.double.get(key, 0) - d0} graph-keeping "
                             f"backward passes")
    want = second(plain)
    torch.cuda.synchronize()
    err, scale = 0.0, 0.0
    for g, w in zip(got, want):
        if w is None:
            if g is not None and g.abs().max().item() > 0:
                raise AssertionError(f"{name}: a second derivative where the plain has none")
            continue
        err = max(err, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
    return err / max(scale, 1e-30)


def _grad_case(name, shape, dtype, gen):
    """The kernel's wrapper and its plain version on one set of operands,
    every float operand requiring grad: loss = sum(out * r) with a seeded r.
    Returns the largest gradient difference relative to the largest plain
    gradient, the inputs' shapes and the output's max abs error, after
    checking that the wrapper launched its kernel once and returned a result
    with a grad_fn that agrees with the plain version's output (`_check`)."""
    wrapper, plain, make = _wrapper_cases()[name]
    args = make(shape, dtype, gen)
    inputs = _grad_inputs(args)
    for t in inputs:
        t.requires_grad_(True)
    n0 = wrapper.launches
    out = wrapper(*args)
    if wrapper.launches != n0 + 1 or out.grad_fn is None:
        raise AssertionError(f"{name} {shape} {dtype}: {wrapper.launches - n0} launches, "
                             f"grad_fn {out.grad_fn}")
    r = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    plain_out = plain(*args)
    out_err = _check(name, out.detach(), plain_out.detach(), dtype, shape,
                     scaled=name == "s2d_conv2x2")
    got = torch.autograd.grad((out.float() * r.float()).sum(), inputs)
    want = torch.autograd.grad((plain_out.float() * r.float()).sum(), inputs)
    torch.cuda.synchronize()
    err, scale = 0.0, 0.0
    for g, w in zip(got, want):
        err = max(err, (g.float() - w.float()).abs().max().item())
        scale = max(scale, w.float().abs().max().item())
    with torch.inference_mode():  # no gradient: the direct launch, no grad_fn
        if wrapper(*args).grad_fn is not None or wrapper.launches != n0 + 2:
            raise AssertionError(f"{name}: inference_mode did not launch directly")
    return err / max(scale, 1e-30), [tuple(t.shape) for t in inputs], out_err


def _tiny_g_latent_grad(device: str):
    """d sum(G(z) * r) / dz of the TINY StyleGAN2 G in the plain domain,
    fp32, weights, noise, z and r from seeds (the same on every device)."""
    import numpy as np

    from clip_glass_torch.core.dtypes import FP32, tree_to
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = dataclasses.replace(sg2.TINY, s2d_min_res=2 ** 30)
    params = tree_to(sg2.generator_init(torch.Generator().manual_seed(0), cfg), device)
    rng = np.random.default_rng(25)
    noise = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
             for s in cfg.noise_shapes()]
    z = torch.from_numpy(rng.normal(size=(4, cfg.latent_size)).astype(np.float32)).to(device)
    r = torch.from_numpy(rng.normal(size=(4, 3, 16, 16)).astype(np.float32)).to(device)
    z.requires_grad_(True)
    out = sg2.generator_apply(params, z, cfg, noise=noise, policy=FP32)
    (grad,) = torch.autograd.grad((out * r).sum(), [z])
    return grad.cpu()


def phase_gradients() -> dict:
    """Phase 3b: each of kernels 1-4 under autograd on the card, fp32 and
    bf16, at GRAD_SHAPES: the wrapper launches its kernel and returns a
    result with a grad_fn, whose input gradients equal the plain version's
    autograd on the card within TOL of their scale (the backward is that
    autograd, on the kernel's forward); under inference_mode the direct
    launch; in fp32 a second derivative through the wrapper equals the
    plain version's within TOL (`_second_derivative_case`). Then the TINY
    G's latent gradient on the card against the CPU's
    (plain versions) within GRAD_G_TOL of its scale, and conv_s8 raising
    under grad."""
    from clip_glass_torch.ops import s2d
    from clip_glass_torch.ops.conv_s8 import conv_s8

    gen = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    for name, shape in GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            v0 = dict(s2d.s2d_conv2x2.launches_by_variant)
            err, shapes, _ = _grad_case(name, shape, dtype, gen)
            rec = {"phase": "gradients", "kernel": name, "shape": list(shape),
                   "dtype": str(dtype), "inputs": shapes, "max_rel_err": err,
                   "tolerance": TOL[dtype]}
            if name == "s2d_conv2x2":
                rec["variants"] = {v: n - v0[v] for v, n in
                                   s2d.s2d_conv2x2.launches_by_variant.items() if n != v0[v]}
            log(rec)
            if not err <= TOL[dtype]:
                raise AssertionError(f"gradient of {name} {shape} {dtype}: {err} of its "
                                     f"scale, tolerance {TOL[dtype]}")
            out[name] = max(out.get(name, 0.0), err)
            torch.cuda.empty_cache()
        err2 = _second_derivative_case(name, shape, gen)
        log({"phase": "gradients", "kernel": name, "shape": list(shape),
             "dtype": str(torch.float32), "check": "second derivative (create_graph) vs the "
             "plain version's", "max_rel_err": err2, "tolerance": TOL[torch.float32]})
        if not err2 <= TOL[torch.float32]:
            raise AssertionError(f"second derivative of {name} {shape}: {err2}")
        out[f"{name}_second"] = max(out.get(f"{name}_second", 0.0), err2)
        torch.cuda.empty_cache()
    got, want = _tiny_g_latent_grad("cuda"), _tiny_g_latent_grad("cpu")
    g_err = ((got - want).abs().max() / want.abs().max()).item()
    log({"phase": "gradients", "check": "TINY StyleGAN2 G (plain domain, fp32): latent "
         "gradient on the card vs the CPU", "max_rel_err": g_err, "tolerance": GRAD_G_TOL})
    if not g_err <= GRAD_G_TOL:
        raise AssertionError(f"TINY G latent gradient: card vs CPU {g_err}")
    x = torch.randn((2, 8, 8, 64), device="cuda", requires_grad=True)
    wq = torch.randint(-127, 128, (64, 64, 3, 3), device="cuda").to(torch.int8)
    try:
        conv_s8(x, wq, torch.ones(64, device="cuda"), pad0=1, pad1=1, x_inv_scale=10.0)
    except RuntimeError as e:
        log({"phase": "gradients", "check": "conv_s8 raises under grad", "error": str(e)})
    else:
        raise AssertionError("conv_s8 returned a result under grad")
    return {**out, "tiny_g": g_err}


# the TINY G's gradient, card against CPU: the forwards differ by the
# kernels' fp32 rounding (TOL), which the backward carries through a few
# layers
GRAD_G_TOL = 1e-4


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
    rec = {"phase": "main", "path": path, "config": "StyleGAN2_ffhq_d",
         "model": "CONFIG_F 1024px" + ("" if path == "s2d" else ", s2d_min_res=2**30"),
         "clip": "VIT_B_32", "pop": POP, "compute_dtype": config.compute_dtype,
         "generations": generations, "setup_s": setup_s, "init_eval_s": init_s,
         "generation_s": gen_s,
         "candidates_per_s": [POP / s for s in gen_s],
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "best_cos": -Fp[:, 0].min().item(), "hinge_min": Fp[:, 1].min().item(),
         "launches": launches, "launches_by_variant": variants,
         "device": kind, "nvidia_smi": smi}
    log(rec)
    del problem, algorithm, res, state
    torch.cuda.empty_cache()
    return launches, variants, rec


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
             *extra, first_gen: int = 0, pop=POP, target: str = TARGET, layout=None) -> dict:
    """One in-process CLI run with the kernels' counts set to 0 just before
    it; checks its artifacts and that each kernel of `want_variants` (name
    -> the variants it must launch, or None for a kernel without variants)
    launched on those variants, and no other kernel. `config` None runs
    the CLI's default config, `pop` None the config's population.
    `layout`: ("search", K) for K --target (`search-NN/` folders with
    target.txt and the artifacts, ga_state.npz at the root), ("request", N)
    for serve mode (N `request-NNNN/` folders with target.txt and the
    result artifacts)."""
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
    kind, n = layout or (None, 0)
    subs = {"search": [f"search-{i:02d}" for i in range(n)],
            "request": [f"request-{i:04d}" for i in range(n)]}.get(kind, [""])
    if layout is not None:
        root = {"ga_state.npz"} if kind == "search" else set()
        if kind == "request":   # the result artifacts only
            want = {a for a in want if not a.startswith("genetic-it")} - {"ga_state.npz"}
        want = (want - {"ga_state.npz"}) | {"target.txt"}
        if set(os.listdir(folder)) != root | set(subs):
            raise AssertionError(f"cli {label}: folders {sorted(os.listdir(folder))}")
    for sub in subs:
        got = set(os.listdir(os.path.join(folder, sub)))
        if got != want:
            raise AssertionError(f"cli {label}: artifacts {sorted(got)} in {sub or '.'}")
        with open(os.path.join(folder, sub, "genetic_result"), "rb") as f:
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
    run_gens = generations - first_gen
    if kind == "request":
        served = next(line for line in lines if "slot occupancy" in line)
        rec = {"phase": "cli", "run": label, "config": config, "extra_args": list(extra),
               "generations": generations, "serve": served,
               "occupancy": float(served.rsplit(" ", 1)[1].rstrip("%")) / 100,
               "launches": {k.__name__: k.launches for k in kernels},
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        log(rec)
        return rec
    wall = next(line for line in lines if line.startswith("wallclock:"))
    phases = {k: float(v.rstrip("s")) for k, v in
              (part.split("=") for part in wall.split()[1:])}
    dumps = [line for line in lines if line.startswith("dump ")]
    rec = {"phase": "cli", "run": label, "config": config or "(default)",
           "extra_args": list(extra), "wallclock": phases, "generations": [first_gen, generations],
           "search_s_per_generation": phases["search+dumps"] / run_gens,
           "dumps": dumps, "rate": [line.strip() for line in lines if "rate:" in line],
           "launches": launches, "launches_by_variant": variants,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(rec)
    return rec


def _flagship_variants(summary: dict, batched: bool = False) -> dict:
    """Every kernel, on the variants phase 3 (or, `batched`, phase 17) saw
    the flagship's s2d path take."""
    def by(name):
        rec = summary[name]["batched"] if batched else summary[name]
        return rec["s2d"]["launches_by_variant"]
    return {name: ({v for v, n in by(name).items() if n} if name in FIRST_DESIGN else None)
            for name in KERNEL_META}


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
        if tot["launches_by_variant"].get("wmma"):
            raise AssertionError(f"{name}: kernel 4 takes wmma at a fold: "
                                 f"{tot['launches_by_variant']}")
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
        _cli_run("E", folder, None, 2, {"s2d_conv2x2": {"wgmma_stream", "wgmma"}}, pop=None)
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


# ------------------------------------------------------------ phases 17-20: K searches batched

K_SEARCH = 4
BATCH_TARGETS = [TARGET, "a red flower in a glass vase", "a wolf at night with the moon",
                 "the face of a woman with red hair"]
# a batched bf16 evaluation against the per-search ones: other batch sizes
# may take other cuDNN / cuBLAS algorithms, whose bf16 roundings fall apart
# over ~40 layers; 5e-2 of each objective's population scale (about 13 bf16
# ulps there). Exact agreement is held in fp32 by phase 18.
BATCHED_BF16_TOL = 5e-2
INT32_LIMIT = 2 ** 31 - 1


def phase_kernels_batched(summary: dict) -> None:
    """Phase 17: kernels 1-4 against their plain versions at every call
    shape of one batched flagship evaluation, K_SEARCH searches x POP rows
    = 64, bf16, in both domains (the plain levels' [64, 1024, 1024, 32] and
    the s2d levels' [64, 512, 2048, 32] reach 2**31 elements, the 513-cell
    ones pass it), measured as phase 3 measures them (`ms`, `device_ms`,
    bound, library). Each shape must take the variant `expected_variant`
    names: kernels 2 and 3 count input values, so at 64 rows their 16 px
    calls take the redesigns that pop 16 leaves to the first designs (the
    variants' launches by path are recorded). A library call
    whose one sample holds more than 2**31 - 1 elements (kernel 4's grouped
    form of a per-sample fold) is not made; its time is null. The
    per-kernel, per-path sums go to summary[name]["batched"]."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = K_SEARCH * POP
    path_shapes = {p: flagship_shapes(_model_cfg(p), rows) for p in PER_EVAL}
    for name, kernel, plain, make, cost, library, _, idx, _ in _kernel_specs():
        counts = {p: _counts(path_shapes[p][idx]) for p in PER_EVAL}
        recs = {}
        for shape in dict.fromkeys(s for p in PER_EVAL for s in counts[p]):
            args = make(shape, torch.bfloat16, gen)
            n_bytes, n_ops = cost(shape, args)
            lib = library(args) if library else None
            skip_lib = (name == "s2d_conv2x2" and shape[4]
                        and args[0].numel() > INT32_LIMIT)
            rec = _measure(kernel, plain, args, torch.bfloat16, shape, n_bytes, n_ops,
                           None if skip_lib else lib, name == "s2d_conv2x2",
                           _peak(name, torch.bfloat16), device_time=True,
                           iters=max(3, min(20, int(4e9 / n_bytes))))
            rec["elements"] = args[0].numel()
            if skip_lib:
                rec["library_note"] = ("not made: the grouped conv holds one sample of "
                                       f"{args[0].numel()} elements")
            if name in FIRST_DESIGN:
                rec["variant"] = _variant_of(kernel, args)
                if rec["variant"] != expected_variant(name, shape):
                    raise AssertionError(f"batched {name} {shape}: took {rec['variant']}, "
                                         f"not {expected_variant(name, shape)}")
            rec.update(phase="batched_kernels", launches_per_evaluation={
                p: counts[p].get(shape, 0) for p in PER_EVAL})
            log(rec)
            recs[shape] = (rec, n_bytes, n_ops)
            del args, lib
            torch.cuda.empty_cache()
        out = {}
        for p in PER_EVAL:
            out[p] = _path_sum(counts[p], recs, _peak(name, torch.bfloat16))
            out[p]["max_elements"] = max(recs[s][0]["elements"] for s in counts[p]) \
                if counts[p] else 0
            if name in FIRST_DESIGN:
                by = out[p]["launches_by_variant"] = {}
                for shape, count in counts[p].items():
                    v = recs[shape][0]["variant"]
                    by[v] = by.get(v, 0) + count
        summary[name]["batched"] = out
        log({"phase": "batched_kernels", "kernel": name, "rows": rows, "sums": out})


def _batched_agreement(family: str, cfg, Xb, targets, models: dict, bundle=None) -> None:
    """Each model config's batched fitness of Xb [K, pop, n_var] against
    `targets` on the GPU (kernels) against the CPU (plain versions), fp32,
    TF32 off, at _agreement's tolerance (rtol 1e-3, atol 1e-4; GPT-2 1e-6),
    with the four kernels' launches of one batched GPU evaluation."""
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model

    kernels = _kernels()
    for label, (model_cfg, want) in models.items():
        Fs = {}
        for dev in ("cpu", "cuda"):
            gen = GenerationProblem(cfg, device=dev, clip_cfg=clip_model.TINY,
                                    model_cfg=model_cfg, bundle=bundle).generator
            before = [k.launches for k in kernels]
            feats = gen.encode_targets(targets)
            Fs[dev] = gen.eval_population_batched(Xb.to(dev), feats).cpu()
            moved = tuple(k.launches - n for k, n in zip(kernels, before))
            if moved != (want if dev == "cuda" else (0, 0, 0, 0)):
                raise AssertionError(f"batched {family} {label} {dev}: launches {moved}")
        err = (Fs["cuda"] - Fs["cpu"]).abs().max().item()
        tol = dict(rtol=1e-6, atol=1e-6) if family == "GPT2" else dict(rtol=1e-3, atol=1e-4)
        if Fs["cpu"].shape != Xb.shape[:2] + (cfg.n_obj,) or \
                not torch.allclose(Fs["cuda"], Fs["cpu"], **tol):
            raise AssertionError(f"batched {family} {label}: GPU {Fs['cuda']} vs CPU "
                                 f"{Fs['cpu']}")
        log({"phase": "batched_agreement", "config": f"{family} {label} fp32",
             "searches": Xb.shape[0], "pop": Xb.shape[1], "max_abs_err": err,
             "launches_per_batched_evaluation": dict(zip([k.__name__ for k in kernels], want))})


def phase_agreement_batched() -> None:
    """Phase 18: each family's batched fitness (K = 3 searches, so that D's
    groups would cross searches if pooled over the whole batch) on the GPU
    against the CPU, TINY models, fp32: StyleGAN2 `_d` plain and s2d
    (s2d_min_res=8), `_nod`, BigGAN (s2d mid segments) and GPT-2 (no kernel;
    fitness within 1e-6). One batched evaluation launches each kernel once
    per call site, as one single-search evaluation does.
    tests/test_torch_cuda.py runs this same check."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.sampling import int_random_sampling, mixed_biggan_sampling
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.gpt2 import model as g2
    from clip_glass_torch.models.stylegan2 import model as sg2

    targets = ["a red flower", "a blue car", "an old house"]
    g = torch.Generator().manual_seed(18)
    for name in ("StyleGAN2_ffhq_d", "StyleGAN2_ffhq_nod"):
        cfg = get_config(name).replace(pop_size=8, dim_z=32, n_var=32, weights="random:0",
                                       target=targets[0], compute_dtype="float32")
        models = {"TINY": (sg2.TINY, (5, 2, 3, 0))}
        if name.endswith("_d"):
            models["TINY_S2D"] = (dataclasses.replace(sg2.TINY, s2d_min_res=8), (5, 0, 1, 4))
        _batched_agreement(name, cfg, torch.randn((3, 8, 32), generator=g), targets, models)
    cfg = get_config("DeepMindBigGAN512").replace(
        pop_size=8, dim_z=16, num_classes=10, n_var=26, resolution=8, weights="random:0",
        target=targets[0], compute_dtype="float32")
    Xb = torch.stack([mixed_biggan_sampling(g, 8, 16, 10, bool_prob=0.3) for _ in range(3)])
    bundle = {"clip": clip_model.init(torch.Generator().manual_seed(0), clip_model.TINY),
              "g": lively_biggan(bg.TINY, 1)}
    _batched_agreement("BigGAN", cfg, Xb, targets, {
        "TINY_S2D": (dataclasses.replace(bg.TINY, s2d_min_res=4), (0, 0, 0, 3))}, bundle)
    dogs = [DOG, os.path.join(ROOT, "examples", "gpt2_images", "goldfish.jpeg"),
            os.path.join(ROOT, "examples", "gpt2_images", "zebra.jpeg")]
    Xb = torch.stack([int_random_sampling(g, 8, 6, 0, 50256) for _ in range(3)])
    _batched_agreement("GPT2", _gpt2_tiny_config(), Xb, dogs, {"TINY": (g2.TINY, (0, 0, 0, 0))})


def _close_to_scale(label: str, got, want, tol: float) -> dict:
    """|got - want| <= tol * (each objective's largest |want|); returns the
    largest differences per objective, absolute and over that scale."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().flatten(0, -2).max(dim=0).values.clamp_min(1e-6)
    err = diff.flatten(0, -2).max(dim=0).values
    if not (err <= tol * scale).all() or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: differences {err.tolist()} beyond {tol} of the "
                             f"scale {scale.tolist()}")
    return {"max_abs": err.tolist(), "max_rel_to_scale": (err / scale).tolist(),
            "scale": scale.tolist()}


def _timed_generations(step, state, generations: int):
    """`generations` steps with the host clock around each, synchronised."""
    times = []
    for _ in range(generations):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return state, times


def phase_main_batched(kind: str, smi: str, summary: dict, single: dict) -> tuple:
    """Phase 19a: StyleGAN2_ffhq_d at full width (config-f, ViT-B/32, bf16,
    random weights from seed 0, the s2d path) as K_SEARCH searches of POP,
    one target each, init + 2 generations, the kernels' counts set to 0 just
    before and read just after: each kernel launches once per call site and
    batched evaluation, on phase 17's variants. Each search's X0 is its
    search_generator's first sample, bitwise; the batched F of the final
    population equals the K per-search evaluations of the same rows within
    BATCHED_BF16_TOL, and so does one evaluation with search_microbatch=2.
    Beside phase 5's single search (`single`, the same call): s a
    generation, cand/s, peak memory; and the host time of the K `vary`
    halves of a step."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.batched import make_batched, search_generator, slice_state
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    config = get_config("StyleGAN2_ffhq_d").replace(
        target=TARGET, weights="random:0", pop_size=POP)
    t = time.perf_counter()
    problem = GenerationProblem(config, device="cuda", model_cfg=_model_cfg("s2d"))
    balgo = make_batched(problem, BATCH_TARGETS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    gens = balgo.generators(0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    t = time.perf_counter()
    state = balgo.init(gens)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    X0 = state.X
    state, gen_s = _timed_generations(lambda s: balgo.step(s, gens), state, 2)
    launches = {k.__name__: k.launches for k in kernels}
    variants = {k.__name__: dict(k.launches_by_variant) for k in kernels
                if k.__name__ in FIRST_DESIGN}
    peak = torch.cuda.max_memory_allocated()
    for name, n in PER_EVAL["s2d"].items():
        if launches[name] != 3 * n:
            raise AssertionError(f"batched main: {name} {launches[name]} launches, expected "
                                 f"{n} x 3 batched evaluations")
    for name in FIRST_DESIGN:
        want = {v: 3 * n for v, n in
                summary[name]["batched"]["s2d"]["launches_by_variant"].items()}
        if {v: n for v, n in variants[name].items() if n} != want:
            raise AssertionError(f"batched main: {name} by variant {variants[name]}, "
                                 f"expected phase 17's {want}")
    for i in range(K_SEARCH):
        if not torch.equal(X0[i], balgo.sample(search_generator(0, i, "cuda"))):
            raise AssertionError(f"batched main: search {i}'s X0 is not its generator's")
    if tuple(state.F.shape) != (K_SEARCH, POP, 2) or not torch.isfinite(state.F).all():
        raise AssertionError(f"batched main: bad fitness {tuple(state.F.shape)}")

    gen = problem.generator
    with torch.inference_mode():
        Fb = balgo.evaluate(state.X)
        Fi = torch.stack([gen.eval_population(state.X[i], {**gen.bundle,
                                                          "target": balgo.targets[i:i + 1]})
                          for i in range(K_SEARCH)])
        Fm = gen.eval_population_batched(state.X, balgo.targets, search_microbatch=2)
        vary = balgo._halves[0]
        vary_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i, g in enumerate(balgo.generators(1)):
                vary(slice_state(state, i), g)
            torch.cuda.synchronize()
            vary_ms.append((time.perf_counter() - t) * 1e3)
    err_single = _close_to_scale("batched vs per-search F", Fb, Fi, BATCHED_BF16_TOL)
    err_mb = _close_to_scale("search_microbatch=2 vs unchunked F", Fm, Fb, BATCHED_BF16_TOL)
    rec = {"phase": "batched_main", "config": "StyleGAN2_ffhq_d", "model": "CONFIG_F 1024px",
           "clip": "VIT_B_32", "searches": K_SEARCH, "pop": POP,
           "compute_dtype": config.compute_dtype, "generations": 2, "setup_s": setup_s,
           "init_eval_s": init_s, "generation_s": gen_s,
           "candidates_per_s": [K_SEARCH * POP / s for s in gen_s],
           "single_search": {k: single[k] for k in ("generation_s", "candidates_per_s",
                                                    "max_memory_allocated_bytes")},
           "max_memory_allocated_bytes": peak, "vary_halves_host_ms": vary_ms,
           "diff_vs_per_search": err_single, "diff_search_microbatch_2": err_mb,
           "tolerance_of_scale": BATCHED_BF16_TOL,
           "launches": launches, "launches_by_variant": variants,
           "device": kind, "nvidia_smi": smi}
    log(rec)
    del problem, balgo, state, gen, X0, Fb, Fi, Fm
    torch.cuda.empty_cache()
    return launches, variants


def phase_main_batched_gpt2(kind: str, smi: str) -> None:
    """Phase 19b: GPT2 at full width (GPT-2 124M, ViT-B/32, bf16, random
    weights from seed 0) as 2 searches x pop 100 (two example photos): one
    batched evaluation of each search's initial population, no kernel of
    the package launched, F finite; against the two single-search
    evaluations of the same rows (printed: the largest difference and the
    rows whose decoded ids differ; a bf16 argmax may flip at another batch
    size, and phase 18 holds the exact agreement in fp32). Then each
    grouping's decode (CUDA events) and host round trip (host clock),
    mean of 3 after a warm-up: `_auto_search_microbatch(2)` is None, one
    group of 200 rows, against groups of one search."""
    import numpy as np

    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.batched import _auto_search_microbatch, make_batched
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    targets = [DOG, os.path.join(ROOT, "examples", "gpt2_images", "goldfish.jpeg")]
    config = get_config("GPT2").replace(target=DOG, weights="random:0")
    problem = GenerationProblem(config, device="cuda")
    balgo = make_batched(problem, targets)
    gen = problem.generator
    _zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        state = balgo.init(balgo.generators(0))
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        if any(launches.values()):
            raise AssertionError(f"batched gpt2: a kernel launched: {launches}")
        X, Fb = state.X, state.F
        if tuple(Fb.shape) != (2, 100, 1) or not torch.isfinite(Fb).all():
            raise AssertionError(f"batched gpt2: bad fitness {tuple(Fb.shape)}")
        Fi = torch.stack([gen.eval_population(X[i], {**gen.bundle,
                                                    "target": balgo.targets[i:i + 1]})
                          for i in range(2)])
        ids_b = gen.generate(X.reshape(200, -1)).cpu().numpy()
        ids_i = np.concatenate([gen.generate(X[i]).cpu().numpy() for i in range(2)])
        timing = {}
        for label, smb in (("one_group", None), ("groups_of_1", 1)):
            rows = 100 * (smb or 2)
            recs = []
            for _ in range(4):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                groups = [gen.generate(X.reshape(200, -1)[r:r + rows])
                          for r in range(0, 200, rows)]
                ev[1].record()
                ev[1].synchronize()
                t1 = time.perf_counter()
                for ids in groups:
                    ids = ids.cpu().numpy()
                    for s in range(0, ids.shape[0], 100):
                        gen._texts_to_clip_tokens(ids[s:s + 100])
                recs.append({"decode_ms": ev[0].elapsed_time(ev[1]),
                             "decode_host_ms": (t1 - t0) * 1e3,
                             "host_round_trip_ms": (time.perf_counter() - t1) * 1e3})
                del groups
            t = time.perf_counter()
            balgo.generator.eval_population_batched(X, balgo.targets, smb)
            torch.cuda.synchronize()
            timing[label] = {"search_microbatch": smb, "splits": recs[1:],
                             "batched_evaluation_ms": (time.perf_counter() - t) * 1e3}
    log({"phase": "batched_main", "config": "GPT2", "searches": 2, "pop": 100,
         "compute_dtype": config.compute_dtype,
         "auto_search_microbatch": _auto_search_microbatch(2),
         "max_abs_diff_vs_per_search": (Fb - Fi).abs().max().item(),
         "rows_with_other_ids": int((ids_b != ids_i).any(axis=1).sum()),
         "grouping": timing, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "launches": launches, "device": kind, "nvidia_smi": smi})
    del problem, balgo, state, gen, X
    torch.cuda.empty_cache()


def phase_main_batched_biggan(kind: str, smi: str, summary: dict) -> None:
    """Phase 19c: DeepMindBigGAN512 at full width (bf16, ViT-B/32, random
    weights from seed 0) as 2 searches x its pop 32: one batched evaluation
    of the initial populations, kernel 4 alone launching on phase 8's
    variants (1 wgmma_stream + 3 wgmma), F finite."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.batched import make_batched
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = _kernels()
    config = get_config("DeepMindBigGAN512").replace(target=TARGET, weights="random:0")
    problem = GenerationProblem(config, device="cuda")
    balgo = make_batched(problem, BATCH_TARGETS[:2])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    t = time.perf_counter()
    state = balgo.init(balgo.generators(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in kernels}
    variants = {v: n for v, n in kernels[3].launches_by_variant.items() if n}
    want = summary["s2d_conv2x2"]["biggan"]["DeepMindBigGAN512"]["launches_by_variant"]
    if variants != want or any(launches[k.__name__] for k in kernels[:3]):
        raise AssertionError(f"batched biggan: launches {launches}, {variants}; expected "
                             f"s2d_conv2x2 {want} only")
    if tuple(state.F.shape) != (2, 32, 1) or not torch.isfinite(state.F).all():
        raise AssertionError(f"batched biggan: bad fitness {tuple(state.F.shape)}")
    log({"phase": "batched_main", "config": "DeepMindBigGAN512", "searches": 2,
         "pop": config.pop_size, "compute_dtype": config.compute_dtype, "init_eval_s": init_s,
         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
         "launches": launches, "launches_by_variant": {"s2d_conv2x2": variants},
         "device": kind, "nvidia_smi": smi})
    del problem, balgo, state
    torch.cuda.empty_cache()


def phase_cli_batched(summary: dict) -> None:
    """Phase 20: `cli.main` in-process at full width (StyleGAN2_ffhq_d,
    config-f, ViT-B/32, pop 16, bf16, random weights from seed 0): M1 with
    K_SEARCH --target for 2 generations; M2 M1's folder resumed to 4; M3 4
    straight, whose ga_state.npz (X [4, 16, 512], the four generators'
    states) must equal M2's bitwise; every search-NN/ with target.txt and
    the artifact set. S: --serve with a file of 3 prompts, --slots 2, 2
    generations, --save-each 1: three request-NNNN/ folders with
    target.txt and the result artifacts, and the slots' occupancy. Every
    run launches each kernel on the variants phase 17 saw."""
    import tempfile

    want = _flagship_variants(summary, batched=True)
    more = [a for t in BATCH_TARGETS[1:] for a in ("--target", t)]
    with tempfile.TemporaryDirectory() as tmp:
        m, m3, srv = (os.path.join(tmp, x) for x in ("m", "m3", "s"))
        _cli_run("M1", m, "StyleGAN2_ffhq_d", 2, want, *more, layout=("search", K_SEARCH))
        _cli_run("M2", m, "StyleGAN2_ffhq_d", 4, want, *more, "--resume", first_gen=2,
                 layout=("search", K_SEARCH))
        _cli_run("M3", m3, "StyleGAN2_ffhq_d", 4, want, *more, layout=("search", K_SEARCH))
        s2, s3 = _npz(os.path.join(m, "ga_state.npz")), _npz(os.path.join(m3, "ga_state.npz"))
        if list(s3["gen"]) != [4] * K_SEARCH or s3["X"].shape != (K_SEARCH, POP, 512):
            raise AssertionError(f"cli M3: gen {s3['gen']}, X {s3['X'].shape}")
        _same_state("cli: resumed M2 vs uninterrupted M3", s2, s3)
        prompts = os.path.join(tmp, "prompts.txt")
        with open(prompts, "w") as f:
            f.write("\n".join(BATCH_TARGETS[:3]) + "\n")
        _cli_run("S", srv, "StyleGAN2_ffhq_d", 2, want, "--serve", prompts, "--slots", "2",
                 "--save-each", "1", layout=("request", 3))
        for i, target in enumerate(BATCH_TARGETS[:3]):
            with open(os.path.join(srv, f"request-{i:04d}", "target.txt")) as f:
                if f.read() != target:
                    raise AssertionError(f"cli S: request {i}'s target.txt")
        log({"phase": "cli", "check": "M2 == M3 bitwise; every search-NN/ and request-NNNN/ "
                                      "with its artifact set"})
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 21-24: the int8 fitness

# H100 SXM data sheet: 1,979 TOPS dense int8 on the tensor cores
PEAK_INT8_OPS_PER_S = 1979e12
# the CPU parity tolerance of tests/test_torch_quant.py (f): the similarity
# absolute, the hinge relative to max(|hinge|, 1)
INT8_TOL = {"similarity": 5e-3, "hinge": 1e-2}
# odd shapes (B, H, W, I, O, k, stride, pad0, pad1, lhs_dilation): I = 3,
# O = 5, stride 2, lhs_dilation 2, negative pads, ragged tiles
CONV_S8_ODD = [
    (2, 7, 5, 3, 5, 3, 1, 1, 1, 1),
    (2, 8, 8, 16, 24, 3, 2, 1, 0, 1),
    (1, 5, 6, 8, 7, 3, 1, 2, 2, 2),
    (2, 9, 9, 32, 16, 2, 1, 0, -1, 1),
    (1, 6, 6, 12, 4, 4, 1, 2, 1, 2),
    (2, 10, 10, 20, 9, 1, 2, -1, -1, 1),
    (1, 33, 31, 48, 65, 3, 2, 1, 1, 1),
    # the polyphase split: k 4 and 3, k 1 (phases without a tap), odd extents
    (2, 9, 7, 32, 40, 4, 1, 1, 1, 2),
    (1, 8, 9, 16, 16, 3, 1, 2, 2, 2),
    (2, 5, 6, 16, 8, 1, 1, 0, 0, 2),
]


def _conv_s8():
    from clip_glass_torch.ops.conv_s8 import conv_s8

    return conv_s8


def _int8_flagship_config():
    from clip_glass_torch.config import get_config

    return get_config("StyleGAN2_ffhq_d").replace(target=TARGET, weights="random:0",
                                                  pop_size=POP, quantize="int8")


def _conv_s8_calls(generator, X) -> dict:
    """One int8 evaluation of X with every conv_s8 call recorded: (x shape,
    w shape, geometry) -> calls. Every call hands conv_s8 the float
    activation and its x_inv_scale (the fused entry)."""
    from clip_glass_torch.ops import modulated_conv

    calls = {}
    real = modulated_conv.conv_s8

    def record(x, wq, scale, **kw):
        if not x.is_floating_point() or kw.get("x_inv_scale") is None:
            raise AssertionError(f"int8 site {tuple(x.shape)}: conv_s8 got {x.dtype} x, "
                                 f"not the fused entry's float x and x_inv_scale")
        key = (tuple(x.shape), tuple(wq.shape),
               tuple((k, v) for k, v in sorted(kw.items())
                     if k not in ("out_dtype", "x_inv_scale")))
        calls[key] = calls.get(key, 0) + 1
        return real(x, wq, scale, **kw)

    modulated_conv.conv_s8 = record
    try:
        generator.eval_population(X)
        torch.cuda.synchronize()
    finally:
        modulated_conv.conv_s8 = real
    return calls


def _int8_operands(gen, x_shape, w_shape):
    xq = torch.randint(-127, 128, x_shape, generator=gen, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, w_shape, generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand(w_shape[0], generator=gen, device="cuda") * 1e-4
    return xq, wq, scale


# x_inv_scale of the float activations in phase 21: x ~ 3 N(0, 1) in bf16
# against sx = 6, so that some values saturate and some fall on .5
INT8_SX = 6.0


def _float_activation(gen, x_shape):
    return (3.0 * torch.randn(x_shape, generator=gen, device="cuda")).bfloat16()


def _conv_s8_bitwise(x, wq, scale, geometry, x_inv_scale=None) -> float:
    """The kernel's int32 accumulators and its bf16 outputs equal the plain
    version's bitwise: of x itself (int8), or of x quantized by x_inv_scale
    (a float x: the fused entry). Returns the largest |got - want| over both
    (int32 in float64, exact)."""
    conv_s8 = _conv_s8()
    from clip_glass_torch.ops.conv_s8 import conv_s8_plain, quantize

    xq = x if x_inv_scale is None else quantize(x, x_inv_scale)
    err = 0.0
    for out_dtype in (torch.int32, torch.bfloat16):
        got = conv_s8(x, wq, scale, out_dtype=out_dtype, x_inv_scale=x_inv_scale, **geometry)
        want = conv_s8_plain(xq, wq, scale, out_dtype=out_dtype, **geometry)
        torch.cuda.synchronize()
        what = (f"conv_s8 {tuple(x.shape)} {x.dtype} x {tuple(wq.shape)} {geometry} "
                f"{out_dtype}")
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)}, plain "
                                 f"{tuple(want.shape)}")
        bad = (got.double() - want.double()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from its plain version ({bad})")
        err = max(err, bad)
    return err


def _real_taps(n_in, n_out, k, stride, pad0, d) -> int:
    """Along one spatial axis, the (output, tap) pairs whose input row
    p = o*stride + t - pad0 is a real sample of the d-dilated input (p >= 0,
    p % d == 0, p / d < n_in): the products that padding and dilation holes
    do not zero."""
    return sum(1 for o in range(n_out) for t in range(k)
               if (p := o * stride + t - pad0) >= 0 and p % d == 0 and p // d < n_in)


def _im2col_int_mm(xq, wq, stride, pad0, pad1, lhs_dilation):
    """The library yardstick: an im2col copy of the dilated, padded input and
    one torch._int_mm against the K-major weights (int32 out). _int_mm takes
    K and N in multiples of 8: the copy zero-pads K (D's minibatch-std
    channel makes I = 513), the weights K and N."""
    B, H, W, I = xq.shape
    O, _, kh, kw = wq.shape
    x = xq
    if lhs_dilation > 1:
        d = lhs_dilation
        x = xq.new_zeros((B, (H - 1) * d + 1, (W - 1) * d + 1, I))
        x[:, ::d, ::d] = xq
    x = F.pad(x, (0, 0, pad0, pad1, pad0, pad1))
    Ho = (x.shape[1] - kh) // stride + 1
    Wo = (x.shape[2] - kw) // stride + 1
    K, M = kh * kw * I, B * Ho * Wo
    Kp, Op = -(-K // 8) * 8, -(-O // 8) * 8
    cols = x.new_zeros((B, Ho, Wo, kh * kw, I) if Kp == K else (M, Kp))
    taps = (cols.view(B, Ho, Wo, kh * kw, I) if Kp == K
            else cols[:, :K].view(B, Ho, Wo, kh * kw, I))
    for ky in range(kh):
        for kx in range(kw):
            taps[:, :, :, ky * kw + kx] = x[:, ky:ky + stride * (Ho - 1) + 1:stride,
                                            kx:kx + stride * (Wo - 1) + 1:stride]
    wk = wq.new_zeros((Op, Kp))
    wk[:O, :K] = wq.permute(0, 2, 3, 1).reshape(O, K)
    return torch._int_mm(cols.view(M, Kp), wk.t())[:, :O].reshape(B, Ho, Wo, O)


def _route_ops(x_shape, w_shape, geometry) -> int:
    """The products the route `conv_s8_variant` names runs: for wgmma the
    phases' GEMMs (their taps only: padding multiplied, no dilation hole),
    for mma_sync the dilated GEMM."""
    from clip_glass_torch.ops.conv_s8 import conv_s8_variant, out_size, phases

    B, H, W, I = x_shape
    O, _, kh, kw = w_shape
    st, p0, p1, d = (geometry[k] for k in ("stride", "pad0", "pad1", "lhs_dilation"))
    Ho, Wo = out_size(H, kh, st, p0, p1, d), out_size(W, kw, st, p0, p1, d)
    if conv_s8_variant(I, st, d) != "wgmma":
        return 2 * B * Ho * Wo * O * kh * kw * I
    return sum(2 * B * Hp * Wp * O * khp * kwp * I
               for _, _, khp, kwp, _, _, Hp, Wp, _, _ in phases(kh, kw, st, p0, d, Ho, Wo))


def _conv_s8_site(gen, x_shape, w_shape, geometry, calls: int) -> dict:
    """One call shape of the int8 flagship: the fused entry (bf16 x and its
    x_inv_scale, as the int8 path calls it) and the int8 entry, each bitwise
    against the plain version; then timed: the fused call (`kernel_ms` back
    to back, `device_ms` replayed from a CUDA graph: the weights' packing,
    at an mma_sync site the quantize pass, and the kernel), the first design
    on the int8 x (`previous_ms`, `previous_device_ms`: mma_sync, no
    quantize pass), the activation's quantize passes as that design ran them at
    every site (`quantize_ms`) and as they are left (`quantize_left_ms`:
    at the mma_sync sites only), the weights' quantize and pack
    (`weights_ms`), its plain version, the bound, and as yardsticks never
    called by the port the im2col + torch._int_mm pair and the bf16 conv
    the site replaces (cuDNN; for a [2,2] fold also kernel 4, per-sample
    weights at pad0 = 1 as G's folds, one shared set at pad0 = 0 as D's)."""
    from clip_glass_torch.ops import quant, s2d
    from clip_glass_torch.ops.conv_s8 import (conv_s8_launch, conv_s8_plain, conv_s8_variant,
                                              out_size, pack_weights, quantize)
    from clip_glass_torch.ops.modulated_conv import _conv_float

    conv_s8 = _conv_s8()
    xq, wq, scale = _int8_operands(gen, x_shape, w_shape)
    xb = _float_activation(gen, x_shape)
    inv = quant.activation_inv_scale(INT8_SX)
    err = max(_conv_s8_bitwise(xq, wq, scale, geometry),
              _conv_s8_bitwise(xb, wq, scale, geometry, inv))
    B, H, W, I = x_shape
    O, _, kh, kw = w_shape
    Ho = out_size(H, kh, geometry["stride"], geometry["pad0"], geometry["pad1"],
                  geometry["lhs_dilation"])
    Wo = out_size(W, kw, geometry["stride"], geometry["pad0"], geometry["pad1"],
                  geometry["lhs_dilation"])
    M, K = B * Ho * Wo, kh * kw * I
    st, p0, d = geometry["stride"], geometry["pad0"], geometry["lhs_dilation"]
    variant = conv_s8_variant(I, st, d)
    # the products with real inputs (the routes also multiply the zeros of
    # padding, mma_sync those of dilation holes too: `route_ops`)
    n_ops = 2 * B * I * O * _real_taps(H, Ho, kh, st, p0, d) * _real_taps(W, Wo, kw, st, p0, d)
    # the bytes of the fused work: the bf16 activation read once, the int8
    # weights and fp32 scales, the bf16 output written once
    n_bytes = 2 * xb.numel() + wq.numel() + 4 * O + 2 * M * O
    iters = _iters(n_bytes)

    def kernel():
        return conv_s8(xb, wq, scale, out_dtype=torch.bfloat16, x_inv_scale=inv, **geometry)

    def previous():
        return conv_s8_launch(xq, wq, scale, geometry, torch.bfloat16, None, "mma_sync")

    if not torch.equal(previous(), conv_s8_plain(xq, wq, scale, out_dtype=torch.bfloat16,
                                                 **geometry)):
        raise AssertionError(f"conv_s8 mma_sync route disagrees at {x_shape}")
    lib = _im2col_int_mm(xq, wq, **geometry)
    if not torch.equal(lib, conv_s8(xq, wq, scale, out_dtype=torch.int32, **geometry)):
        raise AssertionError(f"im2col + _int_mm disagrees with conv_s8 at {x_shape}")
    del lib
    wb = wq.bfloat16()
    quantize_ms = time_ms(lambda: quantize(xb, inv), iters)
    rec = {"x": list(x_shape), "w": list(w_shape), "geometry": geometry, "variant": variant,
           "launches_per_evaluation": calls, "M": M, "N": O, "K": K, "max_abs_err": err,
           "bytes": n_bytes, "ops": n_ops, "gemm_ops": 2 * M * O * K,
           "route_ops": _route_ops(x_shape, w_shape, geometry),
           "kernel_ms": time_ms(kernel, iters), "device_ms": graph_ms(kernel, iters),
           "previous_ms": time_ms(previous, iters),
           "previous_device_ms": graph_ms(previous, iters),
           "plain_ms": time_ms(lambda: conv_s8_plain(xq, wq, scale, out_dtype=torch.bfloat16,
                                                     **geometry), 2, warmup=1),
           "library_ms": time_ms(lambda: _im2col_int_mm(xq, wq, **geometry), iters),
           "bf16_cudnn_ms": time_ms(lambda: _conv_float(xb, wb, **geometry), iters),
           # the PyTorch passes around the kernel: the activation's quantize
           # passes (the first design ran them at every site; now only the mma_sync sites
           # do, inside the fused call), the weights' quantize and pack
           "quantize_ms": quantize_ms,
           "quantize_left_ms": quantize_ms if variant == "mma_sync" else 0.0,
           "weights_ms": time_ms(lambda: pack_weights(quant.quantize_weights(wb)[0]), iters)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, rec["ops"], PEAK_INT8_OPS_PER_S)
    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    fold = (kh == kw == 2 and I == O and geometry["stride"] == 1
            and geometry["lhs_dilation"] == 1 and geometry["pad0"] in (0, 1))
    if fold:
        K4 = wb.permute(2, 3, 1, 0).contiguous()
        sty = dm = None
        if geometry["pad0"] == 1:
            sty = 1.0 + 0.1 * torch.randn((B, I), generator=gen, device="cuda")
            dm = 1.0 + 0.1 * torch.randn((B, O), generator=gen, device="cuda")
        rec["bf16_kernel4_ms"] = time_ms(lambda: s2d.s2d_conv2x2(xb, K4, sty, dm,
                                                                 geometry["pad0"]), iters)
    del xq, wq, scale, xb, wb
    return rec


def phase_kernels_int8(kind: str, smi: str) -> dict:
    """Phase 21: conv_s8 against its plain version, bitwise (int32
    accumulators and bf16 outputs; the fused entry on bf16 x and the int8
    entry), at every call shape of one int8 flagship evaluation (s2d path,
    pop 16, bf16, random weights from seed 0) and at the odd shapes of
    CONV_S8_ODD; each flagship shape measured by `_conv_s8_site`. Returns
    the sums over one evaluation, with the launches by route."""
    from clip_glass_torch.evolve.sampling import normal_sampling
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.ops import quant

    problem = GenerationProblem(_int8_flagship_config(), device="cuda")
    scales = problem.generator._quant_scales
    X = normal_sampling(torch.Generator(device="cuda").manual_seed(21), POP, 512)
    calls = _conv_s8_calls(problem.generator, X)
    del problem
    torch.cuda.empty_cache()
    live = int(((scales > 0) & (scales < float("inf"))).sum())
    if sum(calls.values()) != live:
        raise AssertionError(f"int8 kernels: {sum(calls.values())} conv_s8 calls an "
                             f"evaluation, {live} live call sites of {len(scales)}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    recs = []
    for (x_shape, w_shape, geom), n in calls.items():
        rec = _conv_s8_site(gen, x_shape, w_shape, dict(geom), n)
        recs.append(rec)
        log({"phase": "int8_kernels", "kernel": "conv_s8", **rec})
        torch.cuda.empty_cache()
    err = max(r["max_abs_err"] for r in recs)
    inv = quant.activation_inv_scale(INT8_SX)
    for B, H, W, I, O, k, stride, pad0, pad1, d in CONV_S8_ODD:
        xq, wq, scale = _int8_operands(gen, (B, H, W, I), (O, I, k, k))
        geometry = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=d)
        err = max(err, _conv_s8_bitwise(xq, wq, scale, geometry),
                  _conv_s8_bitwise(_float_activation(gen, (B, H, W, I)), wq, scale, geometry,
                                   inv))

    def total(key):
        return sum(r[key] * r["launches_per_evaluation"] for r in recs)

    by_route = {}
    for r in recs:
        by_route[r["variant"]] = by_route.get(r["variant"], 0) + r["launches_per_evaluation"]
    out = {"shapes": len(recs), "launches_per_evaluation": sum(calls.values()),
           "launches_by_variant": by_route, "call_sites": len(scales), "max_abs_err": err,
           **{k: total(k) for k in ("kernel_ms", "device_ms", "previous_ms",
                                    "previous_device_ms", "plain_ms", "library_ms",
                                    "bf16_cudnn_ms", "quantize_ms", "quantize_left_ms",
                                    "weights_ms", "ops", "gemm_ops", "route_ops")},
           # the bf16 path's conv at each site: kernel 4 at the [2,2] folds
           "bf16_site_ms": sum(r.get("bf16_kernel4_ms", r["bf16_cudnn_ms"])
                               * r["launches_per_evaluation"] for r in recs),
           "odd_shapes_bitwise": len(CONV_S8_ODD)}
    out["bound_ms"], out["bound_by"] = bound_ms(total("bytes"), out["ops"],
                                                PEAK_INT8_OPS_PER_S)
    out["bound_share"] = out["bound_ms"] / out["device_ms"]
    # the int8 path's conv work an evaluation, now and in the first design
    out["int8_conv_work_ms"] = out["device_ms"] + out["weights_ms"]
    out["previous_int8_conv_work_ms"] = (out["previous_device_ms"] + out["quantize_ms"]
                                         + out["weights_ms"])
    log({"phase": "int8_kernels", "kernel": "conv_s8", "sums": out, "device": kind,
         "nvidia_smi": smi})
    return out


def _int8_gpu_vs_cpu(family: str, cfg, X, models: dict, bundle=None, targets=None) -> None:
    """Each model config's int8 fitness (quantize_min_ch in `cfg`) on the
    GPU (conv_s8 and the kernels) against the CPU (plain versions), fp32,
    TF32 off, with the CPU's scales handed to the GPU problem; within
    INT8_TOL. One GPU evaluation launches conv_s8 once per call site and
    kernel 4 at none (every [2,2] fold is a call site); the launches of
    each kernel in it are logged. `targets`: K searches' batched fitness
    of X [K, pop, n_var]."""
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model

    kernels = (*_kernels(), _conv_s8())
    for label, model_cfg in models.items():
        gens = {dev: GenerationProblem(cfg, device=dev, clip_cfg=clip_model.TINY,
                                       model_cfg=model_cfg, bundle=bundle).generator
                for dev in ("cpu", "cuda")}
        scales = gens["cpu"]._quant_scales
        gens["cuda"]._quant_scales = scales
        Fs, launches = {}, {}
        for dev, gen in gens.items():
            _zero_counts(kernels)
            if targets is None:
                Fs[dev] = gen.eval_population(X.to(dev)).cpu()
            else:
                Fs[dev] = gen.eval_population_batched(X.to(dev), gen.encode_targets(targets)).cpu()
            launches[dev] = {k.__name__: k.launches for k in kernels}
        if any(launches["cpu"].values()):
            raise AssertionError(f"int8 {family} {label}: the CPU launched {launches['cpu']}")
        got = launches["cuda"]
        if got["conv_s8"] != len(scales) or got["s2d_conv2x2"]:
            raise AssertionError(f"int8 {family} {label}: launches {got} for {len(scales)} "
                                 f"call sites")
        d = (Fs["cuda"] - Fs["cpu"]).abs()
        sim_err = d[..., 0].max().item()
        hinge_err = (d[..., 1] / Fs["cpu"][..., 1].abs().clamp_min(1.0)).max().item() \
            if cfg.n_obj == 2 else 0.0
        if not (torch.isfinite(Fs["cuda"]).all() and sim_err <= INT8_TOL["similarity"]
                and hinge_err <= INT8_TOL["hinge"]):
            raise AssertionError(f"int8 {family} {label}: GPU {Fs['cuda']} vs CPU {Fs['cpu']}")
        log({"phase": "int8_agreement", "config": f"{family} {label} fp32 int8",
             "searches": 1 if targets is None else X.shape[0], "call_sites": len(scales),
             "similarity_max_abs_err": sim_err, "hinge_max_rel_err": hinge_err,
             "tolerance": INT8_TOL, "launches_per_evaluation": got,
             "conv_s8_launches_per_call_site": got["conv_s8"] / len(scales)})


def phase_agreement_int8() -> None:
    """Phase 22: the TINY int8 fitness (quantize_min_ch = 1, every conv a
    call site, as the CPU tests run it) on the GPU against the CPU:
    StyleGAN2 `_d` plain and s2d (s2d_min_res=8), `_nod`, BigGAN with s2d
    mid segments (s2d_min_res=4, lively weights) and the `_d` s2d fitness
    of K = 3 searches batched. tests/test_torch_cuda.py runs this same
    check."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.sampling import mixed_biggan_sampling
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    g = torch.Generator().manual_seed(22)
    tiny_s2d = dataclasses.replace(sg2.TINY, s2d_min_res=8)
    for name in ("StyleGAN2_ffhq_d", "StyleGAN2_ffhq_nod"):
        cfg = get_config(name).replace(pop_size=8, dim_z=32, n_var=32, weights="random:0",
                                       target=TARGET, compute_dtype="float32",
                                       quantize="int8", quantize_min_ch=1)
        models = {"TINY": sg2.TINY}
        if name.endswith("_d"):
            models["TINY_S2D"] = tiny_s2d
        _int8_gpu_vs_cpu(name, cfg, torch.randn((8, 32), generator=g), models)
        if name.endswith("_d"):
            _int8_gpu_vs_cpu(name, cfg, torch.randn((3, 8, 32), generator=g),
                             {"TINY_S2D": tiny_s2d},
                             targets=["a red flower", "a blue car", "an old house"])
    cfg = get_config("DeepMindBigGAN512").replace(
        pop_size=8, dim_z=16, num_classes=10, n_var=26, resolution=8, weights="random:0",
        target=TARGET, compute_dtype="float32", quantize="int8", quantize_min_ch=1)
    bundle = {"clip": clip_model.init(torch.Generator().manual_seed(0), clip_model.TINY),
              "g": lively_biggan(bg.TINY, 1)}
    _int8_gpu_vs_cpu("BigGAN", cfg, mixed_biggan_sampling(g, 8, 16, 10, bool_prob=0.3),
                     {"TINY_S2D": dataclasses.replace(bg.TINY, s2d_min_res=4)}, bundle)


def phase_main_int8(kind: str, smi: str, single: dict, int8_kernels: dict) -> dict:
    """Phase 23a: StyleGAN2_ffhq_d with --quantize int8 at full width
    (config-f 1024 px G + D, ViT-B/32, pop 16, bf16, random weights from
    seed 0, s2d path), init + GENERATIONS generations: the calibration's
    call sites and seconds (a second calibration, which must give the same
    scales), conv_s8 at every call site of every evaluation, kernel 4 at
    none, kernels 1-3 as in phase 5; s a generation, cand/s and peak memory
    beside phase 5's bf16 run (`single`, this same call); conv_s8's
    launches by route those of phase 21's evaluation (`int8_kernels`), so
    every site of the wgmma route runs no separate quantize pass. Counts
    set to 0 just before the search, read just after."""
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.problem import GenerationProblem

    kernels = (*_kernels(), _conv_s8())
    t = time.perf_counter()
    problem = GenerationProblem(_int8_flagship_config(), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    gen = problem.generator
    scales = gen._quant_scales.copy()
    t = time.perf_counter()
    gen._calibrate_quant()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t
    if not (gen._quant_scales == scales).all():
        raise AssertionError("int8 main: a second calibration gave other scales")
    algorithm = problem.make_algorithm()
    rng = algorithm.generator(0)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    t = time.perf_counter()
    state = algorithm.init(rng)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    init_s = stamps[0] - t

    def on_generation(_state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = minimize(algorithm, GENERATIONS, rng, callback=on_generation, save_each=1,
                   state=state)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    routes = dict(kernels[-1].launches_by_variant)
    n_eval = GENERATIONS + 1
    live = int(((scales > 0) & (scales < float("inf"))).sum())
    want = {**{k: n * n_eval for k, n in PER_EVAL["s2d"].items()}, "s2d_conv2x2": 0,
            "conv_s8": live * n_eval}
    # kernel 3 at every ToRGB (O = 3, no call site), kernels 1 and 2 unchanged
    if launches != want:
        raise AssertionError(f"int8 main: launches {launches}, expected {want}")
    want_routes = {v: n * n_eval for v, n in int8_kernels["launches_by_variant"].items()}
    if {v: n for v, n in routes.items() if n} != want_routes:
        raise AssertionError(f"int8 main: conv_s8 launches by route {routes}, expected "
                             f"{want_routes}")
    Fp = res.pop_F
    if tuple(Fp.shape) != (POP, 2) or not torch.isfinite(Fp).all() or (Fp[:, 1] < 0).any():
        raise AssertionError(f"int8 main: bad fitness {Fp}")
    gen_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    rec = {"phase": "int8_main", "config": "StyleGAN2_ffhq_d --quantize int8",
           "model": "CONFIG_F 1024px", "clip": "VIT_B_32", "pop": POP,
           "compute_dtype": problem.config.compute_dtype,
           "quantize_min_ch": problem.config.quantize_min_ch,
           "quantize_margin": problem.config.quantize_margin,
           "call_sites": len(scales), "live_call_sites": live, "calibration_s": calib_s,
           "setup_s": setup_s, "init_eval_s": init_s, "generation_s": gen_s,
           "candidates_per_s": [POP / s for s in gen_s],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "bf16": {k: single[k] for k in ("generation_s", "candidates_per_s",
                                           "max_memory_allocated_bytes")},
           "launches": launches, "launches_by_variant": {"conv_s8": routes},
           "device": kind, "nvidia_smi": smi}
    log(rec)
    del problem, algorithm, res, state, gen
    torch.cuda.empty_cache()
    return rec


def _quant_fidelity_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quant_fidelity_torch", os.path.join(ROOT, "scripts", "quant_fidelity_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_fidelity_int8(kind: str, smi: str) -> None:
    """Phase 23b: scripts/quant_fidelity_torch.py's collect_fidelity on the
    flagship (4 populations x 16, bf16 against int8, random weights from
    seed 0): per population Spearman and top-8 overlap of each objective,
    the NSGA-II survival overlap, max / mean |dF|. Printed as measured; on
    random weights they decide nothing (the gate reads them BLOCKED)."""
    from clip_glass_torch.config import get_config

    qft = _quant_fidelity_module()
    cfg = get_config("StyleGAN2_ffhq_d").replace(target=TARGET, weights="random:0",
                                                 pop_size=POP)
    t = time.perf_counter()
    fid = qft.collect_fidelity(cfg, 4, {"device": "cuda"}, log=lambda *a, **k: None)
    log({"phase": "int8_fidelity", "config": "StyleGAN2_ffhq_d", "weights": "random:0",
         "seconds": time.perf_counter() - t, **fid, "device": kind, "nvidia_smi": smi})
    torch.cuda.empty_cache()


def phase_other_configs_int8(kind: str, smi: str) -> None:
    """Phase 23c: one DeepMindBigGAN256 int8 evaluation at its pop 64 (bf16,
    random weights from seed 0): conv_s8 once per call site and F finite;
    the call sites are those of the s2d mid segments alone (with the s2d
    domain off the config has none: BigGAN's plain convs are never
    quantized). GPT2 int8: no call site, F bitwise the bf16 F."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.algorithm import operators_for_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.biggan import model as bg

    conv_s8 = _conv_s8()
    config = get_config("DeepMindBigGAN256").replace(target=TARGET, weights="random:0",
                                                     quantize="int8")
    problem = GenerationProblem(config, device="cuda")
    gen = problem.generator
    X = operators_for_config(config).sample(torch.Generator(device="cuda").manual_seed(23),
                                            config.pop_size)
    conv_s8.launches = 0
    t = time.perf_counter()
    F = gen.eval_population(X)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    sites = len(gen._quant_scales)
    if conv_s8.launches != sites or not torch.isfinite(F).all():
        raise AssertionError(f"int8 biggan: {conv_s8.launches} launches, {sites} call sites")
    del problem, gen
    plain = GenerationProblem(config, device="cuda", model_cfg=dataclasses.replace(
        bg.CONFIGS["biggan-deep-256"], s2d_min_res=2 ** 30)).generator
    if plain._quant_scales is not None:
        raise AssertionError("int8 biggan: a plain conv became a call site")
    del plain
    torch.cuda.empty_cache()
    log({"phase": "int8_main", "config": "DeepMindBigGAN256 --quantize int8", "pop": 64,
         "call_sites": sites, "conv_s8_launches": sites, "evaluation_s": eval_s,
         "plain_domain_call_sites": 0, "device": kind, "nvidia_smi": smi})

    Fs = {}
    for q in ("int8", ""):
        cfg = get_config("GPT2").replace(target=DOG, weights="random:0", quantize=q)
        gen = GenerationProblem(cfg, device="cuda").generator
        if q and gen._quant_scales is not None:
            raise AssertionError("int8 gpt2: call sites in img2txt")
        Xg = operators_for_config(cfg).sample(torch.Generator(device="cuda").manual_seed(23),
                                              cfg.pop_size)
        conv_s8.launches = 0
        Fs[q or "bf16"] = gen.eval_population(Xg).cpu()
        if conv_s8.launches:
            raise AssertionError("int8 gpt2: conv_s8 launched")
        del gen
    if not torch.equal(Fs["int8"], Fs["bf16"]):
        raise AssertionError("int8 gpt2: F differs from bf16")
    torch.cuda.empty_cache()
    log({"phase": "int8_main", "config": "GPT2 --quantize int8", "pop": 100, "call_sites": 0,
         "F_bitwise_bf16": True, "device": kind, "nvidia_smi": smi})


def phase_cli_int8(summary: dict) -> None:
    """Phase 24: `cli.main --quantize int8` on the flagship at full width
    (random weights from seed 0): Q1 2 generations, Q2 Q1's folder resumed
    to 4, Q3 4 straight, whose ga_state.npz must equal Q2's bitwise (the
    resumed run recalibrates from the seed); S --serve of 2 prompts with
    --slots 2. Each run writes its artifact set and launches conv_s8; its
    renders stay bf16, so kernel 4 launches there on phase 3's variants."""
    import tempfile

    conv_s8 = _conv_s8()
    want = _flagship_variants(summary)
    with tempfile.TemporaryDirectory() as tmp:
        q, q3, srv = (os.path.join(tmp, x) for x in ("q", "q3", "s"))
        prompts = os.path.join(tmp, "prompts.txt")
        with open(prompts, "w") as f:
            f.write("\n".join(BATCH_TARGETS[:2]) + "\n")
        runs = [("Q1", q, 2, (), {}), ("Q2", q, 4, ("--resume",), {"first_gen": 2}),
                ("Q3", q3, 4, (), {}),
                ("S", srv, 2, ("--serve", prompts, "--slots", "2", "--save-each", "1"),
                 {"layout": ("request", 2)})]
        for label, folder, n_gen, extra, kw in runs:
            conv_s8.launches = 0
            _cli_run(label, folder, "StyleGAN2_ffhq_d", n_gen, want, "--quantize", "int8",
                     *extra, **kw)
            if not conv_s8.launches:
                raise AssertionError(f"cli {label}: conv_s8 never launched")
            log({"phase": "cli", "run": label, "conv_s8_launches": conv_s8.launches})
        _same_state("cli: resumed int8 Q2 vs uninterrupted Q3",
                    _npz(os.path.join(q, "ga_state.npz")), _npz(os.path.join(q3, "ga_state.npz")))
        log({"phase": "cli", "check": "int8: Q2 == Q3 bitwise; the artifact sets; S served 2"})
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 25-27: the projector and the metrics

# the projector's steps at full width, PPL's batches of pairs and epsilon,
# FID's samples per set and G batch
PROJ_STEPS = 20
PPL_PAIRS, PPL_BATCHES, PPL_EPS = 8, 2, 1e-4
FID_SET, FID_BATCH = 64, 16
# a projector's first step, card against CPU (`projector_step_card_vs_cpu`):
# the loss, the distance and the state relative to their scale, 1e-5; the
# gradient (Adam's first moment; the second, its square, at twice the
# tolerance) relative to its scale, 5e-3: the dlatents' gradient is a sum
# with much cancellation, whose fp32 rounding follows the summation order
# (the JAX package's own jitted and eager gradients differ by 1.4e-4 of
# their scale at 16 px, tests/test_torch_projector.py), while a missing or
# wrong term moves it by its own size
STEP_TOL = 1e-5
STEP_GRAD_TOL = 5e-3
# the dlatent gradient through kernels 1-3 against the plain versions on the
# card: the kernels' forwards differ from the plain versions' by their fp32
# rounding (TOL), which that same sum with cancellation magnifies (4.1e-5 to
# 2.4e-4 of its scale from run to run at 1024 px on an H100); held as the
# card-vs-CPU gradient is
PROJ_GRAD_TOL = STEP_GRAD_TOL


def synth_generator(root: str, cfg):
    """(G, config) from a reference-format `Gs.pth` of `cfg` written by
    weights/synthesize.py (seed 0) and read by the port's loader: random
    weights at a checkpoint's scale. The random init of `generator_init`
    ("random:0") is not one for a projection: its images saturate (|x| near
    1e13 at 64 and 256 px on the CPU), so the clamp to [0, 1] passes no
    gradient."""
    from clip_glass_torch.weights import convert_stylegan2, from_jax, synthesize

    path = os.path.join(root, "Gs.pth")
    torch.save(synthesize.stylegan2_generator_state(cfg, 0), path)
    tree, got_cfg, _ = convert_stylegan2.load_pth(path)
    # the execution domain (s2d_min_res) is the caller's, not the file's
    if dataclasses.replace(got_cfg, s2d_min_res=cfg.s2d_min_res) != cfg:
        raise AssertionError(f"Gs.pth read back as {got_cfg}")
    return from_jax.convert_generator(tree), cfg


def lpips_weights(root: str, div: int = 1):
    """LPIPS-VGG16 at channels / div: torchvision's vgg16 file and the LPIPS
    linear heads written by weights/synthesize.py, converted by the convert
    CLI (`lpips --linear`), read by `metrics.lpips.load_npz`."""
    from clip_glass_torch.metrics import lpips
    from clip_glass_torch.weights import synthesize

    vgg, lin, npz = (os.path.join(root, n) for n in ("vgg16.pth", "vgg.pth", "lpips.npz"))
    synthesize.write_vgg16(vgg, div=div)
    synthesize.write_lpips_linear(lin, div=div)
    _convert_cli("lpips", vgg, npz, "--linear", lin)
    return lpips.load_npz(npz)


def inception_weights(root: str):
    """The FID InceptionV3 at its real geometry: pytorch-fid's pt_inception
    file written by weights/synthesize.py, converted by the convert CLI
    (`inception`), read by `metrics.inception.load_npz`."""
    from clip_glass_torch.metrics import inception
    from clip_glass_torch.weights import synthesize

    pth, npz = os.path.join(root, "pt_inception.pth"), os.path.join(root, "inception.npz")
    synthesize.write_inception(pth)
    _convert_cli("inception", pth, npz)
    return inception.load_npz(npz)


def _rel(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _rel_l2(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def projector_step_card_vs_cpu(g_params, cfg, lpips_params, seed: int = 3) -> dict:
    """The first step of a projection (t = 0, as `project` takes it) on the
    card and on the CPU from the same start: dlatent statistics of one CPU
    draw, noise planes, jitter draw and a [0, 1] target from a seed. At t = 0
    the learning rate is 0, so the state moves by the noise renormalization
    alone and the gradient shows in Adam's moments (at a rate above 0 Adam's
    first update is lr * sign(g), which flips where g is within its rounding
    noise). Returns the largest differences: loss and distance relative,
    dlatents, noises and both moments relative to their scale (the first
    moment also as a relative L2 norm, `mu_l2`); raises past STEP_TOL
    (STEP_GRAD_TOL for the first moment, twice that for the second)."""
    from clip_glass_torch import projector as P

    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((256, cfg.latent_size), generator=gen)
    noises = [torch.randn(s, generator=gen) for s in cfg.noise_shapes()]
    draw = torch.randn((1, cfg.num_latents, cfg.latent_size), generator=gen)
    target = torch.rand((1, cfg.data_channels, cfg.resolution, cfg.resolution), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        proj = P.Projector(g_params, cfg, cfg=P.ProjectorConfig(dlatent_samples=8),
                           lpips_params=lpips_params, device=dev)
        proj.dlatent_avg, proj.dlatent_std = P.dlatent_statistics(
            proj.g_params["mapping"], z.to(dev), cfg)
        start = (proj.dlatent_avg[None, None, :].expand(draw.shape).clone(),
                 [n.to(dev) for n in noises])
        t = time.perf_counter()
        (dl, ns), state, loss, dist = proj.step(start, P.adam_init([start[0], *start[1]]),
                                                 target.to(dev), draw.to(dev), 0.0)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"s": time.perf_counter() - t, "loss": loss, "dist": dist, "dlatents": dl,
                    "noises": ns, "mu": state.mu, "nu": state.nu}
    c, g = out["cpu"], out["cuda"]
    rec = {"loss": _rel(g["loss"], c["loss"]), "dist": _rel(g["dist"], c["dist"]),
           "dlatents": _rel(g["dlatents"], c["dlatents"]),
           "noises": max(_rel(a, b) for a, b in zip(g["noises"], c["noises"])),
           "mu": max(_rel(a, b) for a, b in zip(g["mu"], c["mu"])),
           "nu": max(_rel(a, b) for a, b in zip(g["nu"], c["nu"])),
           "mu_l2": max(_rel_l2(a, b) for a, b in zip(g["mu"], c["mu"])),
           "cpu_step_s": c["s"], "card_step_s": g["s"], "loss_value": c["loss"].item(),
           "tolerance": STEP_TOL, "moments_tolerance": [STEP_GRAD_TOL, 2 * STEP_GRAD_TOL]}
    bad = [k for k in ("loss", "dist", "dlatents", "noises") if not rec[k] <= STEP_TOL]
    bad += [k for k, tol in (("mu", STEP_GRAD_TOL), ("nu", 2 * STEP_GRAD_TOL))
            if not rec[k] <= tol]
    if bad:
        raise AssertionError(f"projector step, card vs CPU, past the tolerance: {bad}: {rec}")
    return rec


def projector_grad_kernels_vs_plain(proj, target01, seed: int = 4) -> float:
    """d loss / d dlatents of one projector loss on the card through kernels
    1-3 (`cuda.with_grad`) against the same with every wrapper taking its
    plain version (`cuda.takes_plain` forced), twice: returns the largest
    difference of the kernels' gradient from the first plain one, and of
    the second plain one from the first (the card's own spread), each
    relative to the gradient's scale. Each kernel must record gradients in
    the kernels' run and none in the plain ones."""
    from clip_glass_torch.ops import cuda

    cfg = proj.model_cfg
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dl = proj.dlatent_avg[None, None, :].expand(1, cfg.num_latents, cfg.latent_size).clone()
    noises = [torch.randn(s, generator=gen, device="cuda") for s in cfg.noise_shapes()]
    draw = torch.randn(dl.shape, generator=gen, device="cuda")
    grads, recorded = {}, {}
    for route in ("kernels", "plain", "plain again"):
        leaf = dl.clone().requires_grad_(True)
        before = dict(cuda.with_grad.recorded)
        saved = cuda.takes_plain
        if route != "kernels":
            cuda.takes_plain = lambda t: True
        try:
            loss, _ = proj.loss(leaf, noises, target01, draw, 0.0)
            (grads[route],) = torch.autograd.grad(loss, [leaf])
        finally:
            cuda.takes_plain = saved
        recorded[route] = {k: v - before.get(k, 0) for k, v in cuda.with_grad.recorded.items()
                           if v != before.get(k, 0)}
    if set(recorded["kernels"]) != {"noise_bias_lrelu", "upsample2x", "modulated_matmul"} \
            or recorded["plain"] or recorded["plain again"]:
        raise AssertionError(f"gradients recorded through the kernels: {recorded}")
    return (_rel(grads["kernels"], grads["plain"]),
            _rel(grads["plain again"], grads["plain"]))


def _plain_kernel_shapes(cfg, pop: int):
    """Kernels 1-3 at the call shapes of a differentiated synthesis of `cfg`
    (the projector's, B = 1; the trainer's, its batch): the plain domain."""
    nbl, ups, rgb, _ = flagship_shapes(dataclasses.replace(cfg, s2d_min_res=2 ** 30), pop=pop)
    return [("noise_bias_lrelu", s) for s in dict.fromkeys(nbl)] + \
        [("upsample2x", s) for s in dict.fromkeys(ups)] + \
        [("modulated_matmul", s) for s in dict.fromkeys(rgb)]


def _grad_cases(label: str, shapes, seed: int) -> dict:
    """`_grad_case` in fp32 at each (kernel, shape) of `shapes`: by kernel,
    the largest output error and gradient error; raises past TOL."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for name, shape in shapes:
        err, _, out_err = _grad_case(name, shape, torch.float32, gen)
        if not err <= TOL[torch.float32]:
            raise AssertionError(f"{label} shapes: gradient of {name} {shape}: {err}")
        prev = errs.get(name, {"max_abs_err": 0.0, "gradient_max_rel_err": 0.0})
        errs[name] = {"max_abs_err": max(prev["max_abs_err"], out_err),
                      "gradient_max_rel_err": max(prev["gradient_max_rel_err"], err)}
        torch.cuda.empty_cache()
    return errs


def synthesis_launches(cfg) -> dict:
    """The four kernels' launches in one synthesis of `cfg` (any batch):
    flagship_shapes' G part (kernel 4: G's modulated folds)."""
    nbl, ups, rgb, s2d = flagship_shapes(cfg, pop=1)
    n = {"noise_bias_lrelu": len(nbl), "upsample2x": len(ups), "modulated_matmul": len(rgb),
         "s2d_conv2x2": sum(1 for shape in s2d if shape[4])}
    return {k: v for k, v in n.items() if v}


def _counters():
    from clip_glass_torch.ops import cuda

    return ({k.__name__: k.launches for k in _kernels()}, dict(cuda.with_grad.recorded))


def _delta(a, b) -> dict:
    return {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b) if b.get(k, 0) != a.get(k, 0)}


def phase_projector(kind: str, smi: str, root: str, g_params, cfg, lpips_params) -> dict:
    """Phase 25: the projector at full width: config-f 1024 px (`g_params`,
    from the synthesized Gs.pth), fp32, B = 1, LPIPS-VGG16 at its real
    geometry (lpips_weights), the target a G sample of another latent.
    `Projector.project` for PROJ_STEPS steps: per step its seconds and the
    kernels' launches, every launch of kernels 1-3 recorded through
    `cuda._KernelGrad` and none of kernel 4 (the plain domain); the final
    render in the default domain (kernel 4 at 512 and 1024 px); peak memory;
    the distance at the first step and after the last, which must be
    lower. Then kernels 1-3 at the step's fp32 call shapes, output and
    gradient against the plain versions; the loss's dlatent gradient through
    the kernels against the plain route (PROJ_GRAD_TOL); and one first
    step, card against CPU, on a 256 px cut of config-f (the top two levels
    left out) with LPIPS at channels / 8. Returns the launches."""
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.projector import Projector, ProjectorConfig

    gen = torch.Generator().manual_seed(1)
    z = torch.randn((1, cfg.latent_size), generator=gen)
    noise = [torch.randn(s, generator=gen) for s in cfg.noise_shapes()]
    t = time.perf_counter()
    proj = Projector(g_params, cfg, cfg=ProjectorConfig(num_steps=PROJ_STEPS),
                     lpips_params=lpips_params, device="cuda")
    with torch.inference_mode():
        target01 = ((sg2.generator_apply(proj.g_params, z.cuda(), cfg,
                                         noise=[n.cuda() for n in noise]) + 1.0) / 2.0
                    ).clamp(0.0, 1.0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    steps = []
    real_step = proj.step

    def timed_step(*args):
        torch.cuda.synchronize()
        c0, t0 = _counters(), time.perf_counter()
        out = real_step(*args)
        torch.cuda.synchronize()
        c1 = _counters()
        steps.append({"s": time.perf_counter() - t0, "dist": out[3].item(),
                      "loss": out[2].item(), "launches": _delta(c0[0], c1[0]),
                      "recorded": _delta(c0[1], c1[1])})
        return out

    proj.step = timed_step
    _zero_counts(_kernels())
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    dlatents, images01 = proj.project(target01)
    torch.cuda.synchronize()
    project_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in _kernels()}
    with torch.inference_mode():
        d_last = proj.distance(images01, target01).sum().item()
        inside = ((images01 > 0) & (images01 < 1)).float().mean().item()
    # one plain-domain synthesis a step (config-f: 17, 8 and 9)
    per_step = synthesis_launches(proj.plain_cfg)
    for i, st in enumerate(steps):
        if st["launches"] != per_step or st["recorded"] != per_step:
            raise AssertionError(f"projector step {i}: launches {st['launches']}, recorded "
                                 f"through _KernelGrad {st['recorded']}, expected {per_step}")
    render = {k: n - PROJ_STEPS * per_step.get(k, 0) for k, n in launches.items()
              if n - PROJ_STEPS * per_step.get(k, 0)}
    if render != synthesis_launches(cfg) or not all(math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"projector: the final render launched {render}, expected "
                             f"{synthesis_launches(cfg)}")
    if not (tuple(dlatents.shape) == (1, cfg.num_latents, cfg.latent_size)
            and tuple(images01.shape) == (1, 3, cfg.resolution, cfg.resolution)
            and torch.isfinite(images01).all()):
        raise AssertionError(f"projector: bad output {tuple(dlatents.shape)} "
                             f"{tuple(images01.shape)}")
    if not d_last < steps[0]["dist"]:
        raise AssertionError(f"projector: the distance did not fall: {steps[0]['dist']} "
                             f"-> {d_last}")
    rec = {"phase": "projector", "model": "CONFIG_F 1024px (synthesized Gs.pth, seed 0)",
           "distance": "LPIPS-VGG16 (real geometry)", "dtype": "float32", "batch": 1,
           "steps": PROJ_STEPS, "setup_s": setup_s, "project_s": project_s,
           "step_s": [s["s"] for s in steps],
           "step_s_after_first": sum(s["s"] for s in steps[1:]) / (PROJ_STEPS - 1),
           "max_memory_allocated_bytes": peak, "dist_first_step": steps[0]["dist"],
           "dist_after": d_last, "dist_by_step": [s["dist"] for s in steps],
           "final_pixels_inside_0_1": inside,
           "launches_per_step": per_step, "recorded_per_step": steps[0]["recorded"],
           "final_render_launches": render, "launches": launches,
           "device": kind, "nvidia_smi": smi}
    log(rec)

    shapes = _plain_kernel_shapes(cfg, pop=1)
    kernel_errs = _grad_cases("projector", shapes, 41)
    log({"phase": "projector", "check": "kernels 1-3 at the step's fp32 shapes (B = 1, plain "
         "domain): output and input gradients against the plain version",
         "shapes": len(shapes), "kernels": kernel_errs, "tolerance": TOL[torch.float32]})

    g_err, g_spread = projector_grad_kernels_vs_plain(proj, target01)
    log({"phase": "projector", "check": "dlatent gradient of the loss through kernels 1-3 "
         "vs the plain versions, on the card (1024 px)", "max_rel_err": g_err,
         "plain_vs_plain": g_spread, "tolerance": PROJ_GRAD_TOL})
    if not g_err <= PROJ_GRAD_TOL:
        raise AssertionError(f"projector gradient through the kernels: {g_err}")
    del proj, dlatents, images01, target01
    torch.cuda.empty_cache()

    small = dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg2.CONFIG_F.channels[2:]))
    g_small, small = synth_generator(root, small)
    step = projector_step_card_vs_cpu(g_small, small, lpips_weights(root, div=8))
    log({"phase": "projector", "check": "first step, card vs CPU (config-f cut to 256 px, "
         "LPIPS at channels / 8, fp32, TF32 off)", **step})
    under_grad = {k: sum(st["recorded"].get(k, 0) for st in steps) for k in per_step}
    return {"launches": launches, "under_grad": under_grad, "kernels": kernel_errs}


def phase_ppl(kind: str, smi: str, g_params, cfg, lpips_params) -> dict:
    """Phase 26: PPL (`metrics.ppl.PPL.evaluate`) of config-f 1024 px (G from
    the synthesized Gs.pth), fp32, LPIPS-VGG16 at its real geometry on [0, 1]
    images, epsilon PPL_EPS, PPL_BATCHES batches of PPL_PAIRS pairs: the
    value, each batch's seconds and the kernels' launches (the default
    domain under inference_mode: kernels 1-4, kernel 4 at 512 and 1024 px;
    nothing recorded for a gradient)."""
    from clip_glass_torch.core.dtypes import tree_to
    from clip_glass_torch.metrics import lpips
    from clip_glass_torch.metrics.ppl import PPL

    lp = tree_to(lpips_params, "cuda")

    def distance(a, b):
        return lpips.lpips(lp, a, b, pixel_min=0.0, pixel_max=1.0)

    ppl = PPL(g_params, cfg, distance, num_samples=PPL_PAIRS * PPL_BATCHES,
              batch_size=PPL_PAIRS, epsilon=PPL_EPS, device="cuda")
    batches = []
    real = ppl.batch_distances

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = real(*args)
        torch.cuda.synchronize()
        batches.append({"s": time.perf_counter() - t0, "distances": d.tolist()})
        return d

    ppl.batch_distances = timed
    c0 = _counters()
    value = ppl.evaluate()
    c1 = _counters()
    launches, recorded = _delta(c0[0], c1[0]), _delta(c0[1], c1[1])
    if len(batches) != PPL_BATCHES or not math.isfinite(value) or not value > 0:
        raise AssertionError(f"ppl: {len(batches)} batches, value {value}")
    want = {k: PPL_BATCHES * n for k, n in synthesis_launches(cfg).items()}
    if launches != want or recorded:
        raise AssertionError(f"ppl: launches {launches} (expected {want}), recorded for a "
                             f"gradient {recorded}")
    rec = {"phase": "ppl", "model": "CONFIG_F 1024px (synthesized Gs.pth, seed 0)",
           "distance": "LPIPS-VGG16 (real geometry)", "dtype": "float32",
           "epsilon": PPL_EPS, "pairs_per_batch": PPL_PAIRS, "value": value,
           "batch_s": [b["s"] for b in batches],
           "distances": [d for b in batches for d in b["distances"]],
           "launches": launches, "device": kind, "nvidia_smi": smi}
    log(rec)
    return launches


def phase_fid(kind: str, smi: str, root: str, g_params, cfg) -> dict:
    """Phase 27: FID (`metrics.fid.FID`) with the FID InceptionV3 at its real
    geometry (inception_weights) over G samples of config-f 1024 px (G from
    the synthesized Gs.pth, fp32, the default domain, FID_BATCH a batch): the
    features of set A (FID_SET samples, seed 5) as the reference statistics,
    FID(A, A), which must be 0 within 1e-4 of the trace of A's covariance,
    and FID(A, B) with set B from seed 6, which must be larger. Prints each
    Inception batch's seconds and the G batches'."""
    from clip_glass_torch.metrics import inception
    from clip_glass_torch.core.dtypes import tree_to
    from clip_glass_torch.metrics.fid import FID
    from clip_glass_torch.models.stylegan2 import model as sg2

    g_params = tree_to(g_params, "cuda")
    inc = tree_to(inception_weights(root), "cuda")
    g_s, inc_s = [], []

    def samples(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(FID_SET // FID_BATCH):
            z = torch.randn((FID_BATCH, cfg.latent_size), generator=gen, device="cuda")
            noise = [torch.randn(s, generator=gen, device="cuda") for s in cfg.noise_shapes()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                img = sg2.generator_apply(g_params, z, cfg, noise=noise)
            torch.cuda.synchronize()
            g_s.append(time.perf_counter() - t0)
            yield ((img + 1.0) / 2.0).clamp(0.0, 1.0)

    def features(images01):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            f = inception.features(inc, images01)
        torch.cuda.synchronize()
        inc_s.append(time.perf_counter() - t0)
        return f

    fid = FID(features, num_samples=FID_SET, batch_size=FID_BATCH)
    t = time.perf_counter()
    fid.set_real_stats(samples(5))
    same = fid.evaluate(samples(5))
    other = fid.evaluate(samples(6))
    total_s = time.perf_counter() - t
    trace = float(fid._real_stats[1].trace())
    if not abs(same) <= 1e-4 * trace or not other > abs(same):
        raise AssertionError(f"fid: FID(A, A) {same}, FID(A, B) {other}, trace {trace}")
    rec = {"phase": "fid", "model": "CONFIG_F 1024px (synthesized Gs.pth, seed 0)",
           "features": "FID InceptionV3 (real geometry, synthesized pt_inception)",
           "samples_per_set": FID_SET, "batch": FID_BATCH, "fid_same_set": same,
           "fid_other_set": other, "trace_sigma": trace, "inception_batch_s": inc_s,
           "g_batch_s": g_s, "total_s": total_s, "device": kind, "nvidia_smi": smi}
    log(rec)
    return rec


# ------------------------------------------------------------ phase 28

TRAIN_STEPS = 5
# the trainer's step, card against CPU (`trainer_step_card_vs_cpu`), at the
# projector step's tolerances: the losses relative, STEP_TOL; the gradients
# (Adam's first moment: with beta1 = 0 it is the step's gradient; the second,
# its square, at twice the tolerance), the grad norms and pl_avg (a norm of
# J^T y) relative to their scale, STEP_GRAD_TOL


def trainer_weights(root: str, cfg):
    """(G, Gs, D, config): the reference's own resume files of `cfg`
    (`weights/synthesize.write_stylegan2_pth`, seed 0: G.pth, Gs.pth, D.pth,
    random weights at a checkpoint's scale) read by
    `convert_stylegan2.load_pth` and `from_jax`. `generator_init`'s dense
    layers are N(0, 1) (ROADMAP §3): config-f from it trains nothing."""
    from clip_glass_torch.weights import synthesize

    return read_trainer_weights(synthesize.write_stylegan2_pth(root, cfg, 0), cfg)


def read_trainer_weights(paths: dict, cfg):
    """(G, Gs, D, config) from the stem -> path map `trainer_weights` writes."""
    from clip_glass_torch.weights import convert_stylegan2, from_jax

    trees = {}
    for stem, path in paths.items():
        tree, got_cfg, kind = convert_stylegan2.load_pth(path)
        if dataclasses.replace(got_cfg, s2d_min_res=cfg.s2d_min_res) != cfg \
                or kind != stem[0]:
            raise AssertionError(f"{stem}.pth read back as {kind} {got_cfg}")
        trees[stem] = tree
    return (from_jax.convert_generator(trees["G"]), from_jax.convert_generator(trees["Gs"]),
            from_jax.convert_discriminator(trees["D"]), cfg)


def _draws_to(x, dev):
    """A trainer's StepDraws (nested NamedTuples and lists) on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_draws_to(v, dev) for v in x))
    if isinstance(x, list):
        return [_draws_to(v, dev) for v in x]
    return x


def _tree_rel(got, want) -> float:
    """max |got - want| over a list of tensors relative to max |want|."""
    err = max((a.detach().float().cpu() - b.detach().float().cpu()).abs().max().item()
              for a, b in zip(got, want))
    return err / max(max(b.abs().max().item() for b in want), 1e-30)


def _assert_adam_moved_alike(label, got, want, got_g, want_g, names, lr) -> tuple:
    """A first Adam step (beta1 = 0: the update is -lr * g / (|g| + eps)) on
    the card (`got`, from gradient `got_g`) against the CPU's (`want`,
    `want_g`), element by element, `dlatent_avg` aside (an EMA, not an Adam
    update). Where the two gradients have one sign the update moves by at
    most lr * eps * |dg| / (min |g| + eps)^2 (its slope between them), plus
    1e-6 * lr and an fp32 spacing for the roundings: past that it raises.
    Where their signs differ (a gradient within the card's difference from
    the CPU's of zero) the update flips, by up to 2 * lr: those elements are
    counted and must be under 1e-2 of all. Returns (flipped, total)."""
    flipped = total = 0
    for name, g, w, gg, wg in zip(names, got, want, got_g, want_g):
        if name == ("dlatent_avg",):
            continue
        g, w, gg, wg = (t.detach().double().cpu() for t in (g, w, gg, wg))
        spacing = torch.nextafter(w.float().abs(), torch.tensor(float("inf"))).double() \
            - w.float().abs().double()
        m = torch.minimum(gg.abs(), wg.abs())
        bound = 1e-6 * lr + spacing + lr * 1e-8 * (gg - wg).abs() / (m + 1e-8) ** 2
        apart = (g - w).abs() > bound
        same = torch.sign(gg) == torch.sign(wg)
        if (apart & same).any():
            worst = ((g - w).abs() - bound)[apart & same].max().item()
            raise AssertionError(f"{label} {name}: {int((apart & same).sum())} elements "
                                 f"past the Adam step's bound (by {worst}, lr {lr})")
        flipped += int((apart & ~same).sum())
        total += g.numel()
    if not flipped <= 1e-2 * total:
        raise AssertionError(f"{label}: {flipped} of {total} elements flipped")
    return flipped, total


def _leaf_names(tree) -> list:
    from clip_glass_torch.core.dtypes import map_tree

    names = []
    map_tree(lambda path, _: names.append(path), tree)
    return names


def trainer_step_card_vs_cpu(g_params, d_params, cfg, seed: int = 5) -> dict:
    """Step 0 of a trainer (R1 and the path length penalty, batch 4,
    `TrainerConfig` defaults) on the card and on the CPU from the same
    weights, reals and draws (the CPU trainer's), twice: at both learning
    rates 0, then at the defaults.

    At a rate of 0 the parameters stay, as the projector's step at t = 0
    keeps its dlatents, so the G phase runs against the same D on both: the
    gradients show in Adam's moments (with beta1 = 0 the first is the step's
    gradient). Its record holds the largest differences: the losses
    relative, pl_avg and the grad norms relative, G's and D's first and
    second moments and the parameters after the step (Gs and dlatent_avg
    move) relative to their scale; raises past STEP_TOL (the losses, the
    parameters) or STEP_GRAD_TOL (twice it for the second moments).

    At the default rates (`real_rate`), the Adam update applied: G's and D's
    parameters by `_assert_adam_moved_alike` (an update of lr * sign(g)
    flips where g is within its rounding noise: counted), Gs by its EMA (it
    moves by (1 - ema_beta) of G's difference, plus two fp32 spacings),
    d_loss within STEP_TOL (the D phase precedes every update) and the G
    phase's logs within STEP_GRAD_TOL (G's loss and gradient run through
    the updated D, whose logits move with the flips)."""
    from clip_glass_torch.core.dtypes import tree_leaves
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    gen = torch.Generator().manual_seed(seed)
    reals = torch.rand((4, cfg.data_channels, cfg.resolution, cfg.resolution),
                       generator=gen) * 2 - 1
    rates = {"zero": TrainerConfig(g_lr=0.0, d_lr=0.0, checkpoint_every=0),
             "real": TrainerConfig(checkpoint_every=0)}
    out, draws = {}, None
    for rate, tcfg in rates.items():
        for dev in ("cpu", "cuda"):
            tr = Trainer(cfg, tcfg, g_params, d_params, device=dev)
            if draws is None:
                draws = tr.draw(4, 1, path_length=True)
            t = time.perf_counter()
            logs = tr.train_step(reals.to(dev), _draws_to(draws, dev))
            if dev == "cuda":
                torch.cuda.synchronize()
            out[rate, dev] = {"s": time.perf_counter() - t, "state": tr.state,
                              "lr": {"g": tr.g_adam[0], "d": tr.d_adam[0]},
                              "logs": {k: v.item() for k, v in logs.items()}}
            del tr

    def log_rel(rate):
        c, g = out[rate, "cpu"]["logs"], out[rate, "cuda"]["logs"]
        return {k: abs(g[k] - c[k]) / max(abs(c[k]), 1e-30) for k in c}

    c, g = out["zero", "cpu"], out["zero", "cuda"]
    sc, sg = c["state"], g["state"]
    rec = log_rel("zero")
    rec.update({"g_mu": _tree_rel(sg.g_opt.mu, sc.g_opt.mu),
                "d_mu": _tree_rel(sg.d_opt.mu, sc.d_opt.mu),
                "g_nu": _tree_rel(sg.g_opt.nu, sc.g_opt.nu),
                "d_nu": _tree_rel(sg.d_opt.nu, sc.d_opt.nu),
                "params": max(_tree_rel(tree_leaves(getattr(sg, k)), tree_leaves(getattr(sc, k)))
                              for k in ("g_params", "d_params", "gs_params")),
                "cpu_step_s": c["s"], "card_step_s": g["s"], "logs_cpu": c["logs"],
                "tolerance": STEP_TOL, "gradient_tolerance": [STEP_GRAD_TOL, 2 * STEP_GRAD_TOL]})
    bad = [k for k in ("d_loss", "g_loss", "params") if not rec[k] <= STEP_TOL]
    bad += [k for k in ("pl_avg", "g_grad_norm", "d_grad_norm", "g_mu", "d_mu")
            if not rec[k] <= STEP_GRAD_TOL]
    bad += [k for k in ("g_nu", "d_nu") if not rec[k] <= 2 * STEP_GRAD_TOL]
    if bad:
        raise AssertionError(f"trainer step, card vs CPU, past the tolerance: {bad}: {rec}")

    c, g = out["real", "cpu"], out["real", "cuda"]
    sc, sg = c["state"], g["state"]
    real = log_rel("real")
    bad = [k for k in ("d_loss",) if not real[k] <= STEP_TOL]
    bad += [k for k in ("g_loss", "pl_avg", "g_grad_norm", "d_grad_norm")
            if not real[k] <= STEP_GRAD_TOL]
    if bad:
        raise AssertionError(f"trainer step at the default rates, card vs CPU: {bad}: {real}")
    lazy = c["lr"]                     # the interval-scaled rates (`_lazy_lr`)
    for k in ("g", "d"):
        params = f"{k}_params"
        flipped, total = _assert_adam_moved_alike(
            f"trainer step, {params}", tree_leaves(getattr(sg, params)),
            tree_leaves(getattr(sc, params)), getattr(sg, f"{k}_opt").mu,
            getattr(sc, f"{k}_opt").mu, _leaf_names(getattr(sc, params)), lazy[k])
        real[f"{k}_flipped"], real[f"{k}_elements"] = flipped, total
    one_minus_beta = 1 - rates["real"].ema_beta
    for gs_a, gs_b, g_a, g_b in zip(tree_leaves(sg.gs_params), tree_leaves(sc.gs_params),
                                    tree_leaves(sg.g_params), tree_leaves(sc.g_params)):
        gs_a, gs_b, g_a, g_b = (t.detach().double().cpu() for t in (gs_a, gs_b, g_a, g_b))
        bound = one_minus_beta * (g_a - g_b).abs() \
            + 2.0 ** -22 * (gs_b.abs() + one_minus_beta * g_b.abs()) + 1e-30
        if ((gs_a - gs_b).abs() > bound).any():
            raise AssertionError("trainer step at the default rates: Gs moved apart past "
                                 "(1 - ema_beta) of G's difference")
    real.update({"cpu_step_s": c["s"], "card_step_s": g["s"], "logs_cpu": c["logs"],
                 "learning_rates": lazy, "tolerance": STEP_TOL,
                 "gradient_tolerance": STEP_GRAD_TOL, "flipped_bound": 1e-2})
    rec["real_rate"] = real
    return rec


def trainer_grad_kernels_vs_plain(trainer, phase: str, g_params=None, d_params=None,
                                  seed: int = 6) -> tuple:
    """A G gradient of the trainer (`phase` "g": `Trainer.g_loss`, D's
    logistic loss of fakes drawn with noise; "pl": `Trainer.g_reg`, the path
    length penalty scaled by its interval) at `g_params` / `d_params` (the
    state's by default), on the card through kernels 1-3 against the same
    with every wrapper taking its plain version (`cuda.takes_plain` forced),
    twice: the largest difference of the kernels' gradient from the first
    plain one, and of the second plain one from the first, relative to the
    gradient's scale; and the counts of the kernels' run (launches under
    grad, backward passes that kept their graph), which the plain runs must
    not have: a synthesis's launches of kernels 1-3 under grad, none keeping
    its graph, for "g"; kernels 2 and 3 (no noise) under grad and keeping
    their graph (the second derivative) for "pl".

    Only "g" holds the kernels' outputs: the fakes go through D, which is
    not linear in them. The penalty's gradient does not see them: without
    noise kernels 2 and 3 are linear in the skip image, the only operand
    they produce, and `_KernelGrad`'s backward recomputes the plain version,
    so "pl" checks the Function's double backward wiring."""
    from clip_glass_torch.ops import cuda
    from clip_glass_torch.training.trainer import ChunkDraws, value_and_grad

    cfg, B = trainer.model_cfg, trainer.cfg.batch_size
    g_params = trainer.state.g_params if g_params is None else g_params
    d_params = trainer.state.d_params if d_params is None else d_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if phase == "g":
        draw = ChunkDraws(trainer._latents(gen, B), trainer._noise(gen))

        def fn(p):
            return trainer.g_loss(p, d_params, draw)
    else:
        draw = ChunkDraws(trainer._latents(gen, B), y=torch.randn(
            (B, cfg.data_channels, cfg.resolution, cfg.resolution), generator=gen,
            device="cuda"))
        pl_avg = torch.tensor(0.1, device="cuda")

        def fn(p):
            return trainer.g_reg(p, draw, pl_avg)[0]
    grads, counts = {}, {}
    for route in ("kernels", "plain", "plain again"):
        before = (dict(cuda.with_grad.recorded), dict(cuda.with_grad.double))
        saved = cuda.takes_plain
        if route != "kernels":
            cuda.takes_plain = lambda t: True
        try:
            _, grads[route] = value_and_grad(fn, g_params)
        finally:
            cuda.takes_plain = saved
        counts[route] = [_delta(b, dict(a)) for b, a in
                         zip(before, (cuda.with_grad.recorded, cuda.with_grad.double))]
        torch.cuda.empty_cache()
    syn = synthesis_launches(trainer.plain_cfg)
    if phase == "g":
        want = [syn, {}]
    else:
        no_noise = {k: v for k, v in syn.items() if k != "noise_bias_lrelu"}
        want = [no_noise, no_noise]
    if counts["kernels"] != want or any(any(c) for c in counts["plain"]) \
            or any(any(c) for c in counts["plain again"]):
        raise AssertionError(f"{phase} gradient: recorded / kept the graph {counts}, "
                             f"expected {want}")
    return (_tree_rel(grads["kernels"], grads["plain"]),
            _tree_rel(grads["plain again"], grads["plain"]), counts["kernels"])


def phase_trainer(kind: str, smi: str, root: str) -> dict:
    """Phase 28: the trainer at full width: config-f 1024 px, fp32,
    `TrainerConfig` defaults (batch 4, R1 every 16 steps, the path length
    penalty every 4, one subdivision), G, Gs and D from the reference's resume
    files (`trainer_weights`), reals seeded uniform noise in [-1, 1].
    TRAIN_STEPS steps: step 0 runs R1 and the path length penalty, step 4
    the penalty again. Per step its seconds, the phases it ran, the peak
    memory, the launches of kernels 1-3 (a plain-domain synthesis under
    no_grad for D's fakes, one under grad for G's loss, one without noise
    under grad for the penalty: 17/8/9, 17/8/9, 0/8/9), those through
    `cuda._KernelGrad` and the backward passes of those that kept their
    graph (the penalty's second derivative: 8 and 9), and the five logs,
    which must be finite. Then: G's and D's parameters moved and Gs less
    than G; a checkpoint written and read back bitwise; one TrainLogger grid
    from Gs (the default domain: kernel 4 at 512 and 1024 px); kernels 1-3
    at the step's fp32 shapes, output and input gradients against the plain
    version (TOL); G's loss gradient at the weights before step 0, which
    goes through D and so through the kernels' outputs, and the penalty's G
    gradient, each through the kernels against the plain route on the card
    (STEP_GRAD_TOL, and the plain route against itself); step 0 card vs CPU
    on config-f cut to 256 px (the top two levels left out) at learning
    rates 0 and at the defaults. Returns the kernels' records."""
    from clip_glass_torch.core.dtypes import tree_leaves, tree_unflatten
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.ops import cuda
    from clip_glass_torch.training.logging import TrainLogger
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    t = time.perf_counter()
    g, gs, d, cfg = trainer_weights(os.path.join(root, "trainer"), sg2.CONFIG_F)
    tcfg = TrainerConfig(checkpoint_every=0, checkpoint_dir=os.path.join(root, "ckpt"))
    tr = Trainer(cfg, tcfg, g, d, device="cuda")
    tr.load_state(tr.state.g_params, tr.state.d_params, gs, tr.state.g_opt, tr.state.d_opt,
                  0.0, 0)
    del g, gs, d
    gen = torch.Generator(device="cuda").manual_seed(7)
    reals = torch.rand((tcfg.batch_size, 3, cfg.resolution, cfg.resolution), generator=gen,
                       device="cuda") * 2 - 1
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    def leaves(key):
        return [x.clone() for x in tree_leaves(getattr(tr.state, key))]

    before = {k: leaves(k) for k in ("g_params", "d_params", "gs_params")}
    plain = dataclasses.replace(cfg, s2d_min_res=2 ** 30)
    syn = synthesis_launches(plain)                       # 17/8/9 at 1024 px
    no_noise = {k: v for k, v in syn.items() if k != "noise_bias_lrelu"}
    steps = []
    _zero_counts(_kernels())
    for i in range(TRAIN_STEPS):
        phases = ["d", "g"] + (["r1"] if i % tcfg.d_reg_interval == 0 else []) + \
            (["pl"] if i % tcfg.g_reg_interval == 0 else [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0, d0 = _counters(), dict(cuda.with_grad.double)
        t0 = time.perf_counter()
        logs = tr.train_step(reals)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        c1 = _counters()
        rec = {"step": i, "s": s, "phases": phases,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": _delta(c0[0], c1[0]), "under_grad": _delta(c0[1], c1[1]),
               "under_double_grad": _delta(d0, dict(cuda.with_grad.double)),
               "logs": {k: v.item() for k, v in logs.items()}}
        steps.append(rec)
        pl = "pl" in phases
        want = {k: 2 * syn[k] + (no_noise.get(k, 0) if pl else 0) for k in syn}
        want_grad = {k: syn[k] + (no_noise.get(k, 0) if pl else 0) for k in syn}
        if rec["launches"] != want or rec["under_grad"] != want_grad \
                or rec["under_double_grad"] != (no_noise if pl else {}) \
                or not all(math.isfinite(v) for v in rec["logs"].values()):
            raise AssertionError(f"trainer step {i}: {rec}; expected launches {want}, under "
                                 f"grad {want_grad}, kept the graph {no_noise if pl else {}}")
    moved = {k: max((a - b).abs().max().item() for a, b in zip(leaves(k), before[k]))
             for k in before}
    if not (moved["g_params"] > 0 and moved["d_params"] > 0
            and 0 < moved["gs_params"] < moved["g_params"]):
        raise AssertionError(f"trainer: the largest moves {moved}")
    log({"phase": "trainer", "model": "CONFIG_F 1024px (synthesized G.pth, Gs.pth, D.pth, "
         "seed 0)", "dtype": "float32", "batch": tcfg.batch_size, "steps": TRAIN_STEPS,
         "setup_s": setup_s, "step_s": [r["s"] for r in steps], "first_step_s": steps[0]["s"],
         "by_step": steps, "largest_move": moved, "device": kind, "nvidia_smi": smi})

    t = time.perf_counter()
    folder = tr.save_checkpoint()
    save_s = time.perf_counter() - t
    saved = tr.state
    t = time.perf_counter()
    tr.load_checkpoint(folder)
    load_s = time.perf_counter() - t
    for key in ("g_params", "d_params", "gs_params"):
        for a, b in zip(tree_leaves(getattr(tr.state, key)), tree_leaves(getattr(saved, key))):
            if not torch.equal(a, b):
                raise AssertionError(f"trainer: checkpoint round trip changed {key}")
    for key in ("g_opt", "d_opt"):
        a, b = getattr(tr.state, key), getattr(saved, key)
        if a.count != b.count or not all(torch.equal(x, y) for x, y in
                                         zip(a.mu + a.nu, b.mu + b.nu)):
            raise AssertionError(f"trainer: checkpoint round trip changed {key}")
    if not (torch.equal(tr.state.pl_avg, saved.pl_avg) and tr.state.step == saved.step):
        raise AssertionError("trainer: checkpoint round trip changed pl_avg or step")
    del saved
    size = sum(os.path.getsize(os.path.join(folder, f)) for f in os.listdir(folder))

    sinks = TrainLogger(os.path.join(root, "logs"), image_every=1, n_image_latents=4)
    c0 = _counters()
    t = time.perf_counter()
    grid = sinks.maybe_log_images(tr, tr.state.step)
    grid_s = time.perf_counter() - t
    grid_launches = _delta(c0[0], _counters()[0])
    want_grid = {k: v for k, v in synthesis_launches(cfg).items() if k != "noise_bias_lrelu"}
    if not (grid and os.path.getsize(grid) > 0) or grid_launches != want_grid:
        raise AssertionError(f"trainer: grid {grid}, launches {grid_launches}, expected "
                             f"{want_grid}")
    log({"phase": "trainer", "check": "checkpoint round trip (bitwise) and a Gs grid",
         "checkpoint_bytes": size, "save_s": save_s, "load_s": load_s,
         "grid": os.path.basename(grid), "grid_s": grid_s, "grid_launches": grid_launches})

    shapes = _plain_kernel_shapes(cfg, pop=tcfg.batch_size)
    kernel_errs = _grad_cases("trainer", shapes, 42)
    log({"phase": "trainer", "check": "kernels 1-3 at the step's fp32 shapes (batch 4, plain "
         "domain): output and input gradients against the plain version",
         "shapes": len(shapes), "kernels": kernel_errs, "tolerance": TOL[torch.float32]})

    start = {k: tree_unflatten(getattr(tr.state, k), before[k])
             for k in ("g_params", "d_params")}
    err, spread, kern = trainer_grad_kernels_vs_plain(tr, "g", start["g_params"],
                                                      start["d_params"])
    log({"phase": "trainer", "check": "G loss's G gradient (through D) with kernels 1-3 vs the "
         "plain versions, on the card (1024 px, batch 4, the weights before step 0)",
         "max_rel_err": err, "plain_vs_plain": spread, "under_grad": kern[0],
         "tolerance": STEP_GRAD_TOL})
    if not err <= STEP_GRAD_TOL:
        raise AssertionError(f"trainer: G loss gradient through the kernels: {err}")
    del start
    err, spread, kern = trainer_grad_kernels_vs_plain(tr, "pl")
    log({"phase": "trainer", "check": "path length penalty's G gradient through kernels 2 and "
         "3 (second derivative) vs the plain versions, on the card (1024 px, batch 4; the "
         "kernels' outputs do not reach it: this checks _KernelGrad's wiring)",
         "max_rel_err": err, "plain_vs_plain": spread, "under_grad": kern[0],
         "under_double_grad": kern[1], "tolerance": STEP_GRAD_TOL})
    if not err <= STEP_GRAD_TOL:
        raise AssertionError(f"trainer: path length gradient through the kernels: {err}")
    del tr, reals, before
    torch.cuda.empty_cache()

    small = dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg2.CONFIG_F.channels[2:]))
    g, _, d, small = trainer_weights(os.path.join(root, "trainer_256"), small)
    step = trainer_step_card_vs_cpu(g, d, small)
    log({"phase": "trainer", "check": "step 0, card vs CPU (config-f cut to 256 px, batch 4, "
         "fp32, TF32 off)", **step})
    out = {name: {f: sum(r[f].get(name, 0) for r in steps)
                  for f in ("launches", "under_grad", "under_double_grad")} for name in syn}
    for name in syn:
        out[name].update(kernel_errs[name])
    out["s2d_conv2x2"] = {"launches": 0, "grid_launches": grid_launches["s2d_conv2x2"]}
    return out


# ------------------------------------------------------------ phase 29

SHARDED_RANKS = 2
SHARDED_GENERATIONS = 3
SHARDED_TRAIN_STEPS = 2
# a rank process's time limit: a hang fails the phase instead of the script's
RANK_TIMEOUT_S = 300


def _sharded_config(weights: str):
    from clip_glass_torch.config import get_config

    return get_config("StyleGAN2_ffhq_d").replace(target=TARGET, weights=weights, pop_size=POP)


def _small_cfg():
    """Config-f cut to 256 px (its top two levels left out; the widths kept)."""
    from clip_glass_torch.models.stylegan2 import model as sg2

    return dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg2.CONFIG_F.channels[2:]))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, backend: str, cases: str, inputs: str, out: str) -> list:
    """`world` rank processes of this script (`sharded_rank`) in one process
    group; each must exit 0 within RANK_TIMEOUT_S. Returns their records."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r), "--world",
         str(world), "--port", str(port), "--backend", backend, "--cases", cases,
         "--inputs", inputs, "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs + [""] * world)):
        if p.returncode != 0:
            raise AssertionError(f"{backend} rank {r} of {world} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    return [torch.load(os.path.join(out, f"rank-{r}.pt"), weights_only=False)
            for r in range(world)]


def _count_writes(root: str) -> dict:
    """scripts/dryrun_multihost_torch.py's `count_writes`: path under `root`
    -> the times this process opens it for writing from here on."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dryrun_multihost_torch", os.path.join(ROOT, "scripts", "dryrun_multihost_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count_writes(root)


def sharded_rank(argv) -> int:
    """One rank of phase 29 (`python3 chip_smoke.py --sharded-rank R ...`):
    joins the process group on the card (the given backend), the mesh of its
    card, and runs its cases: "search" (one flagship evaluation of the
    inputs' X, then init + SHARDED_GENERATIONS generations with the kernels'
    launches, seconds and peak memory), "cli" (`cli.main --distributed`, 2
    generations, its writes counted) and "train" (SHARDED_TRAIN_STEPS
    data-parallel trainer steps at 256 px from the inputs' reals and
    draws, a rank-0 checkpoint after each). Saves its record to
    <out>/rank-R.pt."""
    import argparse

    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.ops import cuda
    from clip_glass_torch.parallel import distributed as dist
    from clip_glass_torch.parallel import make_mesh

    ap = argparse.ArgumentParser()
    for flag in ("--sharded-rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--backend", "--cases", "--inputs", "--out"):
        ap.add_argument(flag, required=True)
    args = ap.parse_args(argv)
    spec = f"localhost:{args.port},{args.world},{args.sharded_rank}"
    dist.initialize(spec, backend=args.backend, timeout_s=RANK_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(args.inputs, weights_only=False)
    mesh = make_mesh()
    rank = dist.rank()
    rec = {"rank": rank, "backend": torch.distributed.get_backend(), "mesh_size": mesh.size,
           "device": str(mesh.device)}
    cases = args.cases.split(",")
    kernels = _kernels()
    if "search" in cases:
        t = time.perf_counter()
        problem = GenerationProblem(_sharded_config(inp["weights"]), device="cuda", mesh=mesh)
        algorithm = problem.make_algorithm()
        torch.cuda.synchronize()
        rec["setup_s"] = time.perf_counter() - t
        rec["F"] = problem.generator.eval_population(inp["X"]).cpu()
        gen = algorithm.generator(0)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        t = time.perf_counter()
        state = algorithm.init(gen)
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        rec["init_eval_s"] = stamps[0] - t

        def on_generation(_state):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        res = minimize(algorithm, inp["generations"], gen, callback=on_generation,
                       save_each=1, state=state)
        rec["launches"] = {k.__name__: k.launches for k in kernels}
        rec["launches_by_variant"] = {k.__name__: {v: n for v, n in
                                                   k.launches_by_variant.items() if n}
                                      for k in kernels if hasattr(k, "launches_by_variant")}
        rec["generation_s"] = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        rec["pop_F"], rec["pop_X"] = res.pop_F, res.pop_X
        del problem, algorithm, res, state
        torch.cuda.empty_cache()
    if "tp" in cases:
        _tp_rank_case(inp, rec, kernels)
    if "cli" in cases:
        from clip_glass_torch import cli

        folder = os.path.join(args.out, "cli")
        writes = _count_writes(folder)
        rc = cli.main(["--config", "StyleGAN2_ffhq_d", "--target", TARGET, "--weights",
                       inp["weights"], "--pop-size", str(POP), "--generations", "2",
                       "--save-each", "1", "--tmp-folder", folder, "--distributed", spec,
                       "--no-verbose"])
        rec["cli_rc"], rec["cli_writes"] = rc, dict(writes)
        torch.cuda.empty_cache()
    if "train" in cases:
        from clip_glass_torch.training.trainer import Trainer, TrainerConfig

        g, _, d, small = read_trainer_weights(inp["train_weights"], _small_cfg())
        tr = Trainer(small, TrainerConfig(checkpoint_every=0), g, d, mesh=mesh)
        steps = []
        for i, (reals, draws) in enumerate(zip(inp["reals"], inp["draws"])):
            c0, d0 = _counters(), dict(cuda.with_grad.double)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs = tr.train_step(tr.local_rows(reals), draws)
            torch.cuda.synchronize()
            c1 = _counters()
            steps.append({"s": time.perf_counter() - t, "launches": _delta(c0[0], c1[0]),
                          "under_grad": _delta(c0[1], c1[1]),
                          "under_double_grad": _delta(d0, dict(cuda.with_grad.double)),
                          "logs": {k: v.item() for k, v in logs.items()}})
            tr.save_checkpoint(os.path.join(args.out, "train", f"step-{i + 1}"))
        rec["train"] = steps
    torch.save(rec, os.path.join(args.out, f"rank-{rank}.pt"))
    dist.barrier()
    dist.shutdown()
    return 0


def _trainer_steps_vs_ranks(steps: list, inp: dict, folder: str) -> list:
    """Each step of the ranks (their checkpoints) against the one-process
    step on the card from the same state (the ranks' checkpoint before it),
    reals and draws: d_loss within STEP_TOL, g_loss, pl_avg and the grad
    norms within STEP_GRAD_TOL (G's phase runs through the updated D), G's
    and D's gradients (Adam's first moment, beta1 = 0) within
    STEP_GRAD_TOL of their scale, and at step 0 the Adam update element by
    element (`_assert_adam_moved_alike`)."""
    from clip_glass_torch.core.dtypes import tree_leaves
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    g, _, d, small = read_trainer_weights(inp["train_weights"], _small_cfg())
    tcfg = TrainerConfig(checkpoint_every=0)
    out = []
    for i, (reals, draws) in enumerate(zip(inp["reals"], inp["draws"])):
        single = Trainer(small, tcfg, g, d, device="cuda")
        if i:
            single.load_checkpoint(os.path.join(folder, f"step-{i}"))
        logs = {k: v.item() for k, v in single.train_step(reals, draws).items()}
        ranks = Trainer(small, tcfg, g, d, device="cuda")
        ranks.load_checkpoint(os.path.join(folder, f"step-{i + 1}"))
        got, want = ranks.state, single.state
        rel = {k: abs(steps[i]["logs"][k] - v) / max(abs(v), 1e-30) for k, v in logs.items()}
        rec = {"step": i, "logs_rel": rel, "g_mu": _tree_rel(got.g_opt.mu, want.g_opt.mu),
               "d_mu": _tree_rel(got.d_opt.mu, want.d_opt.mu)}
        bad = [k for k in ("d_loss",) if not rel[k] <= STEP_TOL]
        bad += [k for k in ("g_loss", "pl_avg", "g_grad_norm", "d_grad_norm")
                if not rel[k] <= STEP_GRAD_TOL]
        bad += [k for k in ("g_mu", "d_mu") if not rec[k] <= STEP_GRAD_TOL]
        if got.step != want.step:
            bad.append("step")
        if i == 0:
            for k, lr in (("g", single.g_adam[0]), ("d", single.d_adam[0])):
                params = f"{k}_params"
                rec[f"{k}_flipped"], rec[f"{k}_elements"] = _assert_adam_moved_alike(
                    f"sharded trainer step 0, {params}", tree_leaves(getattr(got, params)),
                    tree_leaves(getattr(want, params)), getattr(got, f"{k}_opt").mu,
                    getattr(want, f"{k}_opt").mu, _leaf_names(getattr(want, params)), lr)
        if bad:
            raise AssertionError(f"sharded trainer step {i}, two ranks vs one process: "
                                 f"{bad}: {rec}")
        out.append(rec)
        del single, ranks
    return out


def phase_sharded(kind: str, smi: str, root: str) -> dict:
    """Phase 29: population sharding and multi-process runs
    (clip_glass_torch/parallel) on the one card, from the reference-format
    config-f files phase 28 wrote (G.pth, Gs.pth, D.pth, seed 0: random
    weights at a checkpoint's scale; CLIP ViT-B/32 random:0), the flagship
    StyleGAN2_ffhq_d at 1024 px, pop 16, bf16, the s2d path:
      (a) a one-process mesh over the box's cards (one): the evaluation
          bitwise the unsharded one, with its launches;
      (b) two ranks on the card, gloo: F of one evaluation (8 rows a rank,
          D's minibatch-std gathered across the ranks) against the
          single process's within BATCHED_BF16_TOL of each objective's scale
          (cuDNN may take other algorithms at 8 rows than at 16), and the
          control, each half evaluated as a population of its own with no
          mesh, which must move F past that tolerance; then init +
          SHARDED_GENERATIONS generations: per rank the launches of kernels
          1-4, seconds a generation and peak memory;
      (c) NCCL at world size 1: one generation of the same search;
      (d) `cli.main --distributed` in the two gloo ranks, 2 generations:
          rank 0 writes each artifact once, rank 1 nothing;
      (e) the data-parallel trainer in the two gloo ranks: config-f cut to
          256 px, batch 4 (2 a rank), fp32, SHARDED_TRAIN_STEPS steps (R1 and
          the path length penalty at step 0), each step held against the
          one-process step on the card (`_trainer_steps_vs_ranks`), kernels
          1-3 under grad in each rank.
    Returns each kernel's launches per rank in (b)'s generations."""
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.parallel import make_mesh
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig
    from clip_glass_torch.weights import synthesize

    t_phase = time.perf_counter()
    kernels = _kernels()
    weights = os.path.join(root, "trainer")          # phase 28's config-f files
    problem = GenerationProblem(_sharded_config(weights), device="cuda")
    gen = problem.generator
    if not gen._s2d_active:
        raise AssertionError("sharded: the flagship fitness took the plain domain")
    X = torch.randn((POP, gen.config.n_var), generator=torch.Generator().manual_seed(11))
    X = X.cuda()
    whole = gen.eval_population(X)
    gen.mesh = make_mesh()
    _zero_counts(kernels)
    meshed = gen.eval_population(X)
    launches_a = {k.__name__: k.launches for k in kernels}
    gen.mesh = None
    if not torch.equal(meshed, whole) or launches_a != PER_EVAL["s2d"]:
        raise AssertionError(f"sharded (a): a one-process mesh of {torch.cuda.device_count()} "
                             f"card(s) changed F ({(meshed - whole).abs().max().item()}) or "
                             f"launched {launches_a}")
    naive = torch.cat([gen.eval_population(X[:POP // 2]), gen.eval_population(X[POP // 2:])])
    log({"phase": "sharded", "check": "(a) one-process mesh over the box's cards: F bitwise "
         "the unsharded evaluation", "cards": torch.cuda.device_count(), "bitwise": True,
         "launches": launches_a, "hinge": whole[:, 1].tolist()})
    del problem, gen
    torch.cuda.empty_cache()

    small = _small_cfg()
    train_weights = synthesize.write_stylegan2_pth(os.path.join(root, "sharded_256"), small, 0)
    g, _, d, small = read_trainer_weights(train_weights, small)
    drawer = Trainer(small, TrainerConfig(checkpoint_every=0), g, d, device="cuda")
    tgen = torch.Generator(device="cuda").manual_seed(8)
    reals = [torch.rand((4, 3, small.resolution, small.resolution), generator=tgen,
                        device="cuda") * 2 - 1 for _ in range(SHARDED_TRAIN_STEPS)]
    draws = [drawer.draw(4, 1, path_length=i % drawer.cfg.g_reg_interval == 0)
             for i in range(SHARDED_TRAIN_STEPS)]
    del drawer, g, d
    inputs = os.path.join(root, "sharded_inputs.pt")
    torch.save({"X": X, "weights": weights, "generations": SHARDED_GENERATIONS,
                "train_weights": train_weights, "reals": reals, "draws": draws}, inputs)

    out_b = os.path.join(root, "sharded_gloo")
    os.makedirs(out_b, exist_ok=True)
    t = time.perf_counter()
    ranks = _run_ranks(SHARDED_RANKS, "gloo", "search,cli,train", inputs, out_b)
    gloo_s = time.perf_counter() - t
    if any(r["backend"] != "gloo" or r["mesh_size"] != SHARDED_RANKS for r in ranks):
        raise AssertionError(f"sharded (b): {[(r['backend'], r['mesh_size']) for r in ranks]}")
    F_ranks = ranks[0]["F"]
    if not all(torch.equal(r["F"], F_ranks) for r in ranks):
        raise AssertionError("sharded (b): the ranks' F differ")
    want = whole.float().cpu()
    b = _close_to_scale("sharded (b): two ranks vs one process", F_ranks, want,
                        BATCHED_BF16_TOL)
    scale = want.abs().max(dim=0).values.clamp_min(1e-6)
    control = ((naive.float().cpu() - want).abs().max(dim=0).values / scale).tolist()
    if not max(control) > BATCHED_BF16_TOL:
        raise AssertionError(f"sharded (b): the naive split moved F by only {control} of the "
                             f"scale, within the tolerance {BATCHED_BF16_TOL}: the check "
                             "cannot see a missing minibatch-std gather")
    per_gen = {name: n * (SHARDED_GENERATIONS + 1) for name, n in PER_EVAL["s2d"].items()}
    for r in ranks:
        if r["launches"] != per_gen:
            raise AssertionError(f"sharded (b) rank {r['rank']}: launches {r['launches']}, "
                                 f"expected {per_gen}")
        if not torch.isfinite(r["pop_F"]).all() or not torch.equal(r["pop_X"],
                                                                   ranks[0]["pop_X"]):
            raise AssertionError(f"sharded (b) rank {r['rank']}: the state is not replicated")
    log({"phase": "sharded", "check": "(b) two ranks on the card (gloo), 8 rows a rank: F "
         "against the one-process F, and the naive split (no gather) as control",
         **b, "tolerance": BATCHED_BF16_TOL, "naive_split_max_rel_to_scale": control,
         "by_rank": [{k: r[k] for k in ("rank", "device", "setup_s", "init_eval_s",
                                         "generation_s", "max_memory_allocated_bytes",
                                         "launches", "launches_by_variant")} for r in ranks],
         "generations": SHARDED_GENERATIONS, "ranks_s": gloo_s, "device": kind,
         "nvidia_smi": smi})

    folder = os.path.join(out_b, "cli")
    final = {"genetic_result", "F.jpg", "ls_result.npz", "output.jpg", "genetic-it-1.jpg",
             "genetic-it-final.jpg"}
    files = set(os.listdir(folder))
    w0, w1 = ranks[0]["cli_writes"], ranks[1]["cli_writes"]
    if any(r["cli_rc"] for r in ranks) or not (final | {"ga_state.npz"}) <= files \
            or w1 or any(w0.get(f) != 1 for f in final):
        raise AssertionError(f"sharded (d): rc {[r['cli_rc'] for r in ranks]}, files {files}, "
                             f"writes {w0} / {w1}")
    log({"phase": "sharded", "check": "(d) cli.main --distributed, two ranks (gloo), 2 "
         "generations: rank 0 writes each artifact once, rank 1 nothing",
         "artifacts": sorted(files), "writes_rank0": w0, "writes_rank1": w1})

    plain_small = dataclasses.replace(small, s2d_min_res=2 ** 30)
    syn = synthesis_launches(plain_small)
    no_noise = {k: v for k, v in syn.items() if k != "noise_bias_lrelu"}
    for r in ranks:
        for i, step in enumerate(r["train"]):
            pl = i % TrainerConfig().g_reg_interval == 0
            want_l = {k: 2 * syn[k] + (no_noise.get(k, 0) if pl else 0) for k in syn}
            want_g = {k: syn[k] + (no_noise.get(k, 0) if pl else 0) for k in syn}
            if step["launches"] != want_l or step["under_grad"] != want_g \
                    or not all(math.isfinite(v) for v in step["logs"].values()):
                raise AssertionError(f"sharded (e) rank {r['rank']} step {i}: {step}; expected "
                                     f"launches {want_l}, under grad {want_g}")
    steps = _trainer_steps_vs_ranks(ranks[0]["train"], torch.load(inputs, weights_only=False),
                                    os.path.join(out_b, "train"))
    log({"phase": "sharded", "check": "(e) the data-parallel trainer, two ranks (gloo): "
         "config-f cut to 256 px, batch 4 (2 a rank), fp32, each step against the one-process "
         "step on the card", "steps": steps,
         "by_rank": [{"rank": r["rank"], "step_s": [s["s"] for s in r["train"]],
                      "launches": [s["launches"] for s in r["train"]],
                      "under_grad": [s["under_grad"] for s in r["train"]],
                      "under_double_grad": [s["under_double_grad"] for s in r["train"]]}
                     for r in ranks],
         "tolerance": STEP_TOL, "gradient_tolerance": STEP_GRAD_TOL})

    out_c = os.path.join(root, "sharded_nccl")
    os.makedirs(out_c, exist_ok=True)
    torch.save({"X": X, "weights": weights, "generations": 1}, inputs)
    (c,) = _run_ranks(1, "nccl", "search", inputs, out_c)
    one = {name: n * 2 for name, n in PER_EVAL["s2d"].items()}
    if c["backend"] != "nccl" or c["launches"] != one or not torch.isfinite(c["pop_F"]).all():
        raise AssertionError(f"sharded (c): {c['backend']}, launches {c['launches']}")
    log({"phase": "sharded", "check": "(c) NCCL at world size 1: one generation",
         "backend": c["backend"], "launches": c["launches"], "generation_s": c["generation_s"],
         "F_vs_one_process_max_abs": (c["F"].float() - want).abs().max().item()})
    log({"phase": "sharded", "seconds": time.perf_counter() - t_phase})
    return {name: {"launches_per_rank": ranks[0]["launches"][name],
                   "trainer_launches_per_rank": sum(s["launches"].get(name, 0)
                                                    for s in ranks[0]["train"])}
            for name in PER_EVAL["s2d"]}


# ------------------------------------------------------------ phase 30

TP_GENERATIONS = 2
# (c): an estimate from shapes alone within these shares of the measured
# peak: at least the peak, and at most 15% above it
ESTIMATE_RANGE = (1.0, 1.15)
# (a): CLIP's fp32 image features, tensor-parallel against the whole tower
TP_FEATURE_TOL = 1e-4


def _vit_fp32():
    """CLIP ViT-B/32 random:0, fp32, on the card."""
    from clip_glass_torch.core.dtypes import tree_to
    from clip_glass_torch.models.clip import model as clip_model

    return tree_to(clip_model.init(torch.Generator().manual_seed(0), clip_model.VIT_B_32), "cuda")


def _tp_rank_case(inp: dict, rec: dict, kernels) -> None:
    """Phase 30 (a) in one rank: the (1, world) mesh (a model group of the
    ranks, CLIP split over them), one flagship evaluation of the inputs' X
    with the kernels' launches, and CLIP's fp32 image features of the
    inputs' images through this rank's shard."""
    from clip_glass_torch.core.dtypes import FP32
    from clip_glass_torch.core.memory import tree_bytes
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.parallel import distributed as dist
    from clip_glass_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(model_axis_size=dist.world_size())
    problem = GenerationProblem(_sharded_config(inp["weights"]), device="cuda", mesh=mesh)
    _zero_counts(kernels)
    rec["tp_F"] = problem.generator.eval_population(inp["X"]).cpu()
    rec["tp_launches"] = {k.__name__: k.launches for k in kernels}
    rec["tp_mesh_shape"] = mesh.shape
    rec["tp_clip_bytes"] = tree_bytes(problem.generator.clip_params)
    del problem
    shard = pmesh.clip_shard(_vit_fp32(), mesh.tp, mesh.model_index(0))
    images = inp["images"].cuda()
    rec["tp_features"] = mesh.map(lambda i, x: clip_model.encode_image(
        shard, x, clip_model.VIT_B_32, FP32, tp=mesh.tp, reduce=pmesh.model_sum),
        [images])[0].cpu()
    del shard
    torch.cuda.empty_cache()


def _count_by_shard(kernels):
    """Wrap each kernel's checked launch so that it counts by the mesh
    position of the calling thread; returns (counts, undo)."""
    import threading

    from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn
    from clip_glass_torch.parallel import mesh as pmesh

    counts, lock, undo = {}, threading.Lock(), []
    for module, name, kernel in ((bias_act, "_noise_bias_lrelu_cuda", "noise_bias_lrelu"),
                                 (upfirdn, "_upsample2x_cuda", "upsample2x"),
                                 (modulated_conv, "_modulated_matmul_cuda", "modulated_matmul"),
                                 (s2d, "_s2d_conv2x2_cuda", "s2d_conv2x2")):
        real = getattr(module, name)

        def counted(*args, _real=real, _kernel=kernel):
            pos = getattr(pmesh._shard, "index", None)
            with lock:
                row = counts.setdefault(pos, {})
                row[_kernel] = row.get(_kernel, 0) + 1
            return _real(*args)

        setattr(module, name, counted)
        undo.append((module, name, real))

    def restore():
        for module, name, real in undo:
            setattr(module, name, real)

    return counts, restore


def _measured_peak(fn) -> dict:
    """While fn() builds and runs its work, above what was there before: the
    card's allocated bytes at their peak (`allocated`, what
    torch.cuda.max_memory_allocated reads: the caching allocator's blocks)
    and its requested bytes at their peak (`requested`); the tracker's
    requested and block peaks over the same run's CUDA storages; and
    `untracked`, the allocated peak less the tracker's requested bytes (the
    libraries' workspaces and the allocator's unsplit blocks). cuBLAS's
    workspaces are freed first, so the work makes them, as in a fresh
    process."""
    from clip_glass_torch.core.memory import PeakMemory

    class CudaPeak(PeakMemory):
        def track(self, t):
            if t.device.type == "cuda":
                super().track(t)

    def requested():
        return torch.cuda.memory_stats().get("requested_bytes.all.peak", 0)

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    torch.cuda.reset_peak_memory_stats()
    with CudaPeak() as m:
        fn()
    torch.cuda.synchronize()
    allocated = torch.cuda.max_memory_allocated() - base
    return {"allocated": allocated, "requested": requested() - base_req,
            "tracker_requested": m.requested_peak, "tracker_blocks": m.peak,
            "untracked": allocated - m.requested_peak}


def phase_tp(kind: str, smi: str, root: str) -> dict:
    """Phase 30: CLIP tensor parallelism on the 2-D (pop, model) mesh and
    the memory from shapes alone (clip_glass_torch/parallel/mesh.py,
    parallel/dryrun.py, core/memory.py), from phase 28's config-f files and
    CLIP ViT-B/32 random:0, the flagship at 1024 px, pop 16, bf16, the s2d
    path:
      (a) two ranks of this script on the card (gloo), a (1, 2) mesh: one
          model group, ViT-B/32 split 12 -> 6 heads and 3072 -> 1536 MLP
          columns a rank, the text tower 8 -> 4 heads. F of one evaluation
          (both ranks run G and D on all 16 rows): the hinge bitwise the
          one-process hinge, the CLIP objective within BATCHED_BF16_TOL of
          its scale; CLIP's image features at fp32 within TP_FEATURE_TOL of
          the whole tower's (relative to their largest); kernels 1-4's
          launches in each rank; the time of a rank's c_proj partial
          product by route (noted);
      (b) one process whose mesh lists the card 4 times, a (2, 2) mesh (one
          thread a position, 8 rows a model group): F of one evaluation
          within BATCHED_BF16_TOL of each objective's scale, then init +
          TP_GENERATIONS generations with each position's launches and the
          seconds a generation (noted; four positions on one card are no
          speed);
      (c) `dryrun_multichip(4)` on the card (the TINY live part on the card
          listed 4 times, the full-size estimates of one rank of 4 against
          the card's memory), then each estimate of the one-process work
          beside its measured peak (`_measured_peak`: allocated and
          requested, the tracker on the same run, what it did not see):
          the flagship's evaluation at pop 16, and the trainer's
          regularized step (R1 and the path length penalty) at config-f
          1024 px, batch 4, fp32, each with cuDNN's TF32 off (as this
          script runs) and allowed (PyTorch's default); each estimate /
          allocated peak within ESTIMATE_RANGE: an upper bound.
    Returns each kernel's launches per rank in (a) and per position in (b)."""
    from clip_glass_torch.core.dtypes import FP32
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.ops import attention
    from clip_glass_torch.parallel import make_mesh
    from clip_glass_torch.parallel.dryrun import (dryrun_multichip, evaluation_bytes,
                                                  train_step_bytes)
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    kernels = _kernels()
    weights = os.path.join(root, "trainer")          # phase 28's config-f files
    config = _sharded_config(weights)
    problem = GenerationProblem(config, device="cuda")
    X = torch.randn((POP, config.n_var), generator=torch.Generator().manual_seed(12)).cuda()
    whole = problem.generator.eval_population(X).float().cpu()
    del problem
    images = torch.rand((4, 3, 224, 224), generator=torch.Generator().manual_seed(13))
    params = _vit_fp32()
    want_feats = clip_model.encode_image(params, images.cuda(), clip_model.VIT_B_32,
                                         FP32).cpu()
    del params
    torch.cuda.empty_cache()

    # (a) two ranks, one model group
    inputs = os.path.join(root, "tp_inputs.pt")
    torch.save({"X": X, "weights": weights, "images": images}, inputs)
    out_a = os.path.join(root, "tp_gloo")
    os.makedirs(out_a, exist_ok=True)
    t = time.perf_counter()
    ranks = _run_ranks(2, "gloo", "tp", inputs, out_a)
    ranks_s = time.perf_counter() - t
    F_a = ranks[0]["tp_F"].float()
    if any(tuple(r["tp_mesh_shape"]) != (1, 2) for r in ranks) or \
            not all(torch.equal(r["tp_F"], ranks[0]["tp_F"]) for r in ranks):
        raise AssertionError(f"tp (a): meshes {[r['tp_mesh_shape'] for r in ranks]}, or the "
                             "ranks' F differ")
    if not torch.equal(F_a[:, 1], whole[:, 1]):
        raise AssertionError(f"tp (a): the hinge moved by "
                             f"{(F_a[:, 1] - whole[:, 1]).abs().max().item()}")
    clip_a = _close_to_scale("tp (a): the CLIP objective, two ranks vs one process",
                             F_a[:, :1], whole[:, :1], BATCHED_BF16_TOL)
    feats = {}
    for r in ranks:
        err = (r["tp_features"] - want_feats).abs().max().item()
        feats[r["rank"]] = err / want_feats.abs().max().item()
        if not feats[r["rank"]] <= TP_FEATURE_TOL:
            raise AssertionError(f"tp (a) rank {r['rank']}: fp32 features {feats[r['rank']]} "
                                 f"of their scale from the whole tower's")
        if r["tp_launches"] != PER_EVAL["s2d"]:
            raise AssertionError(f"tp (a) rank {r['rank']}: launches {r['tp_launches']}")
    log({"phase": "tp", "check": "(a) two ranks on the card (gloo), a (1, 2) mesh: CLIP "
         "split over the ranks, G and D on all 16 rows in each", "hinge_bitwise": True,
         "clip_objective": clip_a, "tolerance": BATCHED_BF16_TOL,
         "features_fp32_max_rel": feats, "features_tolerance": TP_FEATURE_TOL,
         "by_rank": [{"rank": r["rank"], "launches": r["tp_launches"],
                      "clip_bytes": r["tp_clip_bytes"]} for r in ranks],
         "ranks_s": ranks_s, "device": kind, "nvidia_smi": smi})

    # the partial product of (a)'s c_proj on one rank (16 images x 50
    # tokens, 1536 of ViT-B/32's 3072 MLP columns), bf16: the route the
    # shard takes (tensor cores, fp32 out), fp32 operands, and the whole
    # layer's bf16 matmul
    g = torch.Generator(device="cuda").manual_seed(14)
    h = torch.randn((POP, 50, 3072), generator=g, device="cuda").bfloat16()
    w = (torch.randn((3072, 768), generator=g, device="cuda") * 0.02).bfloat16()
    hs, ws = h[..., :1536].contiguous(), w[:1536].contiguous()
    part = {"tensor_cores_fp32_out": time_ms(lambda: attention._fp32_product(hs, ws), 50),
            "fp32_operands": time_ms(lambda: hs.float() @ ws.float(), 50),
            "whole_layer_bf16": time_ms(lambda: h @ w, 50)}
    part_err = (attention._fp32_product(hs, ws) - hs.float() @ ws.float()).abs().max().item()
    del g, h, w, hs, ws
    log({"phase": "tp", "check": "(a) c_proj's partial product on a rank, [16, 50, 1536] x "
         "[1536, 768] bf16", "ms": part, "max_abs_diff_of_routes": part_err,
         "device": kind, "nvidia_smi": smi})

    # (b) one process, the card listed 4 times
    mesh = make_mesh(["cuda:0"] * 4, model_axis_size=2)
    problem = GenerationProblem(config, device="cuda", mesh=mesh)
    F_b = problem.generator.eval_population(X).float().cpu()
    close_b = _close_to_scale("tp (b): a (2, 2) mesh vs one process", F_b, whole,
                              BATCHED_BF16_TOL)
    counts, restore = _count_by_shard(kernels)
    stamps = []
    try:
        _zero_counts(kernels)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

        def on_generation(_state):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        res = minimize(problem.make_algorithm(), TP_GENERATIONS, 0, callback=on_generation,
                       save_each=1)
    finally:
        restore()
    launches_b = {k.__name__: k.launches for k in kernels}
    per_shard = {name: n * (TP_GENERATIONS + 1) for name, n in PER_EVAL["s2d"].items()}
    if sorted(counts) != [0, 1, 2, 3] or any(counts[i] != per_shard for i in counts) or \
            not torch.isfinite(res.pop_F).all():
        raise AssertionError(f"tp (b): launches by position {counts}, expected {per_shard} "
                             "in each")
    # the positions' calls are the kernels' own launches, each counted once
    summed = {name: sum(counts[i][name] for i in counts) for name in per_shard}
    if any(launches_b[name] != summed[name] for name in per_shard):
        raise AssertionError(f"tp (b): the kernels counted {launches_b} launches, the "
                             f"positions' calls sum to {summed}")
    log({"phase": "tp", "check": "(b) one process, the card listed 4 times: a (2, 2) mesh, "
         "8 rows a model group", **close_b, "tolerance": BATCHED_BF16_TOL,
         "launches_by_position": counts, "launches": launches_b,
         "generation_s_noted": [b - a for a, b in zip(stamps[:-1], stamps[1:])],
         "generation_s_scope": "the first with the init", "generations": TP_GENERATIONS})
    del problem, res
    torch.cuda.empty_cache()

    # (c) the dry run on the card, then the estimates against measured peaks
    t = time.perf_counter()
    dry = dryrun_multichip(4)
    dry_s = time.perf_counter() - t
    flagship = config.replace(pop_size=POP, compute_dtype="bfloat16")
    est_eval = evaluation_bytes(flagship)
    est_train = train_step_bytes(sg2.CONFIG_F, 4)

    def run_eval():
        gen = GenerationProblem(flagship, device="cuda").generator
        gen.eval_population(X)

    def run_train():
        tr = Trainer(sg2.CONFIG_F, TrainerConfig(checkpoint_every=0), device="cuda")
        reals = torch.rand((4, 3, 1024, 1024), device="cuda") * 2 - 1
        tr.train_step(reals)

    measured = {}
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            label = "tf32_allowed" if tf32 else "tf32_off"
            measured[f"flagship_pop16_bf16_{label}"] = (est_eval, _measured_peak(run_eval))
            measured[f"train_config_f_batch4_fp32_{label}"] = (est_train,
                                                              _measured_peak(run_train))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    ratios = {k: e["total"] / m["allocated"] for k, (e, m) in measured.items()}
    log({"phase": "tp", "check": "(c) dryrun_multichip(4) on the card; estimates from shapes "
         "of the one-process work beside its measured peak", "mesh": dry["mesh"],
         "live": dry["live"], "fullsize_one_rank_of_4": dry["fullsize"],
         "budget_bytes": dry["budget_bytes"], "dryrun_s": dry_s,
         "estimate_vs_measured": {k: {"estimate": e, "measured": m, "ratio": ratios[k],
                                      "requested_ratio": e["requested"] / m["requested"]}
                                  for k, (e, m) in measured.items()},
         "range": ESTIMATE_RANGE, "device": kind, "nvidia_smi": smi})
    bad = {k: r for k, r in ratios.items() if not ESTIMATE_RANGE[0] <= r <= ESTIMATE_RANGE[1]}
    if bad:
        raise AssertionError(f"tp (c): estimate / measured peak outside {ESTIMATE_RANGE}: {bad}")
    log({"phase": "tp", "seconds": time.perf_counter() - t_phase})
    return {name: {"launches_per_rank": ranks[0]["tp_launches"][name],
                   "launches_per_position": counts[0][name]} for name in PER_EVAL["s2d"]}


# ------------------------------------------------------------ phase 31

# (b): bench_torch.py on the flagship, cut to fit the script's time limit
BENCH_ENV = {"BENCH_GENS": "3", "BENCH_REPEATS": "2", "BENCH_CHECKSUM": "1"}
# (d): the int8 flagship, one window
BENCH_INT8_ENV = {"BENCH_QUANT": "int8", "BENCH_GENS": "2", "BENCH_REPEATS": "1"}
# bench.py's fields (bench.py:169-197) and the launches a timed evaluation
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "model_gflops_per_candidate",
                "model_tflops_per_sec_per_chip", "device_kind", "mfu",
                "launches_per_evaluation")


def _bench_run(label: str, env: dict) -> dict:
    """`python3 bench_torch.py` in a process of its own with `env` (ambient
    BENCH_* dropped); its JSON line, with the process's wall seconds."""
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(env)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          env=full, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t
    line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")), None)
    if proc.returncode or line is None:
        raise AssertionError(f"bench {label}: rc {proc.returncode}, {proc.stderr[-2000:]}")
    out = json.loads(line)
    missing = [k for k in BENCH_FIELDS if k not in out]
    if missing or out["vs_baseline"] is not None:
        raise AssertionError(f"bench {label}: fields missing {missing}, or a baseline: {out}")
    out["process_s"] = wall
    return out


def phase_bench(kind: str, smi: str, int8_main: dict) -> dict:
    """Phase 31: the port's contract entry point and its bench (clip_glass_torch/
    entry.py, bench_torch.py), on the flagship at full width:
      (a) `entry()` on the card: F of its pop-4 bf16 evaluation is [4, 2]
          and finite, with kernels 1-4's launches of one s2d evaluation;
      (b) `bench_torch.py` twice, each in a process of its own, with
          BENCH_ENV: each JSON line holds bench.py's fields, device_kind the
          card's name, 0 < mfu <= 1, model_gflops_per_candidate equal to
          core.flops.fitness_flops_per_candidate at the bench's config / 1e9,
          and each kernel's launches a timed evaluation those of the s2d
          path (PER_EVAL);
      (c) both runs' checksum_F, checksum_F_columns and sha256_F, and
          whether F is bitwise equal: the same search from the same seed in
          two processes, equal where the hashes are (noted, not asserted;
          the float64 sum alone cannot see the similarities beside a hinge
          of 1e21);
      (d) `bench_torch.py` once with BENCH_INT8_ENV: conv_s8 at every live
          site of phase 23's evaluation, kernel 4 at none.
    Returns each kernel's launches a timed evaluation in (b) and (d)."""
    import bench_torch
    from clip_glass_torch.core import flops
    from clip_glass_torch.entry import entry
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    t_phase = time.perf_counter()
    kernels = (*_kernels(), _conv_s8())
    fn, (X, bundle) = entry()
    _zero_counts(kernels)
    F_a = fn(X, bundle)
    torch.cuda.synchronize()
    launches_a = {k.__name__: k.launches for k in kernels}
    if tuple(F_a.shape) != (4, 2) or not torch.isfinite(F_a).all():
        raise AssertionError(f"bench (a): entry() gave F {tuple(F_a.shape)}: {F_a}")
    if launches_a != {**PER_EVAL["s2d"], "conv_s8": 0}:
        raise AssertionError(f"bench (a): entry()'s evaluation launched {launches_a}")
    log({"phase": "bench", "check": "(a) entry() on the card", "F": F_a.float().cpu().tolist(),
         "launches": launches_a, "device": kind, "nvidia_smi": smi})
    del fn, X, bundle, F_a
    torch.cuda.empty_cache()

    fpc = flops.fitness_flops_per_candidate(bench_torch.bench_config(), sg2.CONFIG_F,
                                            clip_model.VIT_B_32)
    runs = [_bench_run(f"(b) run {i}", BENCH_ENV) for i in (1, 2)]
    want_b = {**{k: float(n) for k, n in PER_EVAL["s2d"].items()}, "conv_s8": 0.0}
    for i, r in enumerate(runs, 1):
        if r["device_kind"] != kind or r["mfu"] is None or not 0 < r["mfu"] <= 1:
            raise AssertionError(f"bench (b) run {i}: device {r['device_kind']}, mfu "
                                 f"{r['mfu']}")
        if r["model_gflops_per_candidate"] != fpc / 1e9:
            raise AssertionError(f"bench (b) run {i}: {r['model_gflops_per_candidate']} "
                                 f"GFLOP a candidate, core.flops says {fpc / 1e9}")
        if r["launches_per_evaluation"] != want_b:
            raise AssertionError(f"bench (b) run {i}: launches an evaluation "
                                 f"{r['launches_per_evaluation']}, expected {want_b}")
        log({"phase": "bench", "check": f"(b) bench_torch.py run {i}", **r,
             "env": BENCH_ENV, "nvidia_smi": smi})
    hashes = [r["sha256_F"] for r in runs]
    log({"phase": "bench", "check": "(c) F of the two processes (noted)",
         "checksum_F": [r["checksum_F"] for r in runs],
         "checksum_F_columns": [r["checksum_F_columns"] for r in runs],
         "sha256_F": hashes, "bitwise_equal": hashes[0] == hashes[1]})

    int8 = _bench_run("(d) int8", BENCH_INT8_ENV)
    n_eval = GENERATIONS + 1
    want_d = {**{k: float(n) for k, n in PER_EVAL["s2d"].items()}, "s2d_conv2x2": 0.0,
              "conv_s8": int8_main["launches"]["conv_s8"] / n_eval}
    if int8["launches_per_evaluation"] != want_d or int8["device_kind"] != kind or \
            not 0 < (int8["mfu"] or 0) <= 1:
        raise AssertionError(f"bench (d): launches an evaluation "
                             f"{int8['launches_per_evaluation']}, expected {want_d}; mfu "
                             f"{int8['mfu']}")
    log({"phase": "bench", "check": "(d) bench_torch.py, int8", **int8,
         "env": BENCH_INT8_ENV, "nvidia_smi": smi})
    log({"phase": "bench", "seconds": time.perf_counter() - t_phase})
    return {name: {"launches_per_evaluation": runs[0]["launches_per_evaluation"][name],
                   "int8_launches_per_evaluation": int8["launches_per_evaluation"][name],
                   "entry_launches": launches_a[name]}
            for name in launches_a}


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
    if sys.argv[1:2] == ["--sharded-rank"]:
        return sharded_rank(sys.argv[1:])
    t0 = time.perf_counter()
    kind = phase_device()
    smi = smi_line()
    phase_build()
    summary = phase_kernels()
    host = phase_host()
    grads = phase_gradients()
    phase_agreement()
    launches, variants, single = phase_main(kind, smi, "s2d", GENERATIONS, summary)
    plain_launches, _, _ = phase_main(kind, smi, "plain", GENERATIONS, summary)
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
    phase_kernels_batched(summary)
    phase_agreement_batched()
    batched, batched_variants = phase_main_batched(kind, smi, summary, single)
    phase_main_batched_gpt2(kind, smi)
    phase_main_batched_biggan(kind, smi, summary)
    phase_cli_batched(summary)
    int8_kernels = phase_kernels_int8(kind, smi)
    phase_agreement_int8()
    int8_main = phase_main_int8(kind, smi, single, int8_kernels)
    phase_fidelity_int8(kind, smi)
    phase_other_configs_int8(kind, smi)
    phase_cli_int8(summary)
    with tempfile.TemporaryDirectory() as tmp:
        from clip_glass_torch.models.stylegan2 import model as sg2

        g_params, g_cfg = synth_generator(tmp, sg2.CONFIG_F)
        lp = lpips_weights(tmp)
        projector = phase_projector(kind, smi, tmp, g_params, g_cfg, lp)
        ppl_launches = phase_ppl(kind, smi, g_params, g_cfg, lp)
        phase_fid(kind, smi, tmp, g_params, g_cfg)
        del g_params, lp
        torch.cuda.empty_cache()
        trainer = phase_trainer(kind, smi, tmp)
        sharded = phase_sharded(kind, smi, tmp)
        tp = phase_tp(kind, smi, tmp)
    bench = phase_bench(kind, smi, int8_main)
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
                        "launches_by_variant": variants.get(name),
                        "gradient_max_rel_err": grads[name],
                        "second_derivative_max_rel_err": grads[f"{name}_second"],
                        "plain_path": {"launches": plain_launches[name],
                                       **{k: p[k] for k in keys}},
                        "batched": {
                            "launches": batched[name],
                            "launches_by_variant": batched_variants.get(name),
                            **{path: {k: v for k, v in summary[name]["batched"][path].items()
                                      if k in keys or k in ("max_abs_err", "max_elements")}
                               for path in PER_EVAL}},
                        "projector": {"launches": projector["launches"][name],
                                      "under_grad": projector["under_grad"].get(name, 0),
                                      **projector["kernels"].get(name, {})},
                        "ppl": {"launches": ppl_launches[name]},
                        "trainer": trainer[name],
                        "sharded": sharded[name],
                        "tp": tp[name],
                        "bench": bench[name],
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
                                 f"its call shapes of one evaluation (its pop, bf16); "
                                 f"batched: {K_SEARCH} searches x pop {POP}, init + 2 "
                                 f"generations of the s2d path (launches), sums over "
                                 f"each path's call shapes of one batched evaluation "
                                 f"({K_SEARCH * POP} rows, bf16); projector: "
                                 f"Projector.project, config-f 1024 px, fp32, B = 1, "
                                 f"{PROJ_STEPS} steps (kernels 1-3 under grad in each "
                                 f"step, the plain domain) and the final render (the "
                                 f"default domain), max_abs_err and "
                                 f"gradient_max_rel_err at the step's fp32 shapes; "
                                 f"ppl: PPL.evaluate, {PPL_BATCHES} batches of "
                                 f"{PPL_PAIRS} pairs at 1024 px, fp32; trainer: "
                                 f"Trainer.train_step, config-f 1024 px, fp32, batch 4, "
                                 f"{TRAIN_STEPS} steps (launches; under_grad: through "
                                 f"cuda._KernelGrad; under_double_grad: its backward "
                                 f"passes that kept their graph, the path length "
                                 f"penalty's), max_abs_err and gradient_max_rel_err at "
                                 f"the step's fp32 shapes, grid_launches: one "
                                 f"TrainLogger grid of 4 from Gs (the default domain); "
                                 f"sharded: {SHARDED_RANKS} gloo ranks on the card, "
                                 f"init + {SHARDED_GENERATIONS} generations of the "
                                 f"flagship s2d path, {POP // SHARDED_RANKS} rows a rank "
                                 f"(launches_per_rank), and {SHARDED_TRAIN_STEPS} "
                                 f"data-parallel trainer steps at 256 px, batch 4 "
                                 f"(trainer_launches_per_rank); tp: one flagship "
                                 f"evaluation in each of 2 gloo ranks of a (1, 2) mesh "
                                 f"(launches_per_rank), and init + {TP_GENERATIONS} "
                                 f"generations on a (2, 2) mesh of the card listed 4 "
                                 f"times (launches_per_position); bench: a timed "
                                 f"evaluation of bench_torch.py on the flagship "
                                 f"(launches_per_evaluation), of its int8 run "
                                 f"(int8_launches_per_evaluation), and entry()'s "
                                 f"evaluation (entry_launches)"})
    kernels.append({
        "name": "conv_s8", "route": "cuda", "source": "clip_glass_torch/csrc/conv_s8.cu",
        "replaces": "XLA's int8 conv, clip_glass_tpu/ops/quant.py:137",
        "launches": int8_main["launches"]["conv_s8"],
        "launches_by_variant": int8_main["launches_by_variant"]["conv_s8"],
        "max_abs_err": int8_kernels["max_abs_err"], "ms": int8_kernels["kernel_ms"],
        **{k: int8_kernels[k] for k in ("device_ms", "previous_ms", "previous_device_ms",
                                        "plain_ms", "bound_ms", "bound_by", "bound_share",
                                        "library_ms", "bf16_site_ms", "quantize_ms",
                                        "quantize_left_ms", "weights_ms", "int8_conv_work_ms",
                                        "previous_int8_conv_work_ms", "ops", "route_ops",
                                        "gemm_ops", "shapes", "launches_per_evaluation")},
        "gradient": "raises (inference only)",
        "sharded": {"launches_per_rank": 0},   # phases 29 and 30 run the bf16 path
        "tp": {"launches_per_rank": 0, "launches_per_position": 0},
        "bench": bench["conv_s8"],
        "scope": f"launches: init + {GENERATIONS} generations of the int8 flagship "
                 f"(--quantize int8, s2d path, pop {POP}); times: sums over the call shapes "
                 f"of one int8 evaluation; ms, device_ms: the fused entry on the bf16 "
                 f"activation (wgmma: quantized in the gather; mma_sync: a quantize pass "
                 f"first); previous_*: the first design (mma_sync) on the int8 activation; "
                 f"quantize_ms: the activation's quantize passes as that design ran them at "
                 f"every site; quantize_left_ms: those still run (mma_sync sites); "
                 f"weights_ms: the weights' quantize and pack; max_abs_err: the largest "
                 f"|got - want| of the int32 and bf16 outputs of both entries against the "
                 f"plain version at every shape (any difference fails the run); "
                 f"bound_ms: the products with real inputs (none with padding or dilation "
                 f"holes) and the fused work's bytes (bf16 activation, int8 weights, bf16 "
                 f"output); route_ops: the products the routes run (no dilation hole on "
                 f"wgmma); library_ms: an im2col copy + torch._int_mm; bf16_site_ms: the "
                 f"bf16 path's conv at the same sites (cuDNN, kernel 4 at the [2,2] "
                 f"folds)"})
    log({"script_s": time.perf_counter() - t0})
    log({"kernels": kernels})
    log(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
