"""Build, load and launch the package's hand-written CUDA kernels.

The sources in `clip_glass_torch/csrc/*.cu` have a plain C interface. At the
first CUDA use they are compiled for Hopper (`sm_90a`) by `nvcc`, one
process per source started together, linked into one shared library under
`build/clip_glass_torch/` beside the package (or a cache directory where
the package's parent is read-only: core/cache.py), and bound with `ctypes`. The
library's name carries a hash of the sources and flags, so an edit
rebuilds it. A missing `nvcc` or a failed build raises: there is no
fallback for a CUDA tensor.

Launch status: every C entry point returns `cudaGetLastError()` after its
launch, and `check` raises on anything but 0.

TMA: kernels that load by the Tensor Memory Accelerator encode their tensor
maps on the host at each call, through `cuTensorMapEncodeTiled`, which they
look up at run time by `cudaGetDriverEntryPoint`; the library links no
libcuda.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from clip_glass_torch.core.cache import build_root
from clip_glass_torch.core.profiling import TRACER

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("noise_bias_lrelu.cu", "upsample2x.cu", "modulated_matmul.cu",
           "s2d_conv2x2.cu", "conv_s8.cu", "fir.cu", "cond_bn_relu.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_INT = ctypes.c_int
_SIGNATURES = {
    # x, noise, ns, bias, out, n, hw, c, alpha, gain, dtype, vec, stream
    "cg_noise_bias_lrelu": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _F, _F,
                            _INT, _INT, _P),
    # x, out, B, H, W, C, k0, k1, k2, k3, dtype, stream (kernel 2: the "rows"
    # variant, then the "tiled" one)
    "cg_upsample2x": (_P, _P, _I64, _I64, _I64, _I64, _F, _F, _F, _F, _INT, _P),
    "cg_upsample2x_tiled": (_P, _P, _I64, _I64, _I64, _I64, _F, _F, _F, _F,
                            _INT, _P),
    # x, style, w, demod, bias, out, B, P, I, O, dtype, vec, stream (kernel 3:
    # the "chunked" variant)
    "cg_modulated_matmul": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                            _INT, _INT, _P),
    # x, style, w, demod, bias, out, B, P, I, stream (kernel 3: the "mma"
    # variant, bf16, O = 3, I in {32, 64, 128, 256, 512})
    "cg_modulated_matmul_mma": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    # x, kb, out, B, n, n_out, C, pad0, kb_sets, dtype, vec, stream (kernel
    # 4: the wmma and fp32 variants; kb_sets = B, or 1 shared by every
    # sample; each tap [in, out])
    "cg_s2d_conv2x2": (_P, _P, _P, _I64, _I64, _I64, _I64, _INT, _I64, _INT, _INT, _P),
    # x, kt, out, B, n, n_out, C, pad0, kt_sets, stream (kernel 4: the wgmma
    # variant, bf16, C in {64, 128}; kt_sets = B, or 1 shared by every
    # sample; each tap [out, in])
    "cg_s2d_conv2x2_wgmma": (_P, _P, _P, _I64, _I64, _I64, _I64, _INT, _I64, _P),
    # x, kt, out, B, n, n_out, C, pad0, stream (kernel 4: the wgmma_stream
    # variant, bf16, C = 256, one weight set [2, 2, out, in] for every sample)
    "cg_s2d_conv2x2_wgmma_stream": (_P, _P, _P, _I64, _I64, _I64, _I64, _INT, _P),
    # x, w, scale, out, B, H, W, I, Ho, Wo, O, kh, kw, ldw, stride, pad0,
    # lhs_dilation, out dtype (0 fp32, 1 bf16, 2 int32), vec16, stream (the
    # int8 conv of ops/conv_s8.py)
    "cg_conv_s8": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                   _I64, _INT, _INT, _INT, _INT, _INT, _P),
    # x, w, scale, out, B, H, W, I, Ho, Wo, O, ldw, stride, ostep, n_phases,
    # phase table (host int[8 * n_phases]), x dtype (0 fp32, 1 bf16, 2 int8),
    # x_inv_scale, out dtype, stream (conv_s8's wgmma route)
    "cg_conv_s8_wgmma": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                         _INT, _INT, _INT, _P, _INT, _F, _INT, _P),
    # x, out, B, H, W, C, pad0, pad1, k0, k1, k2, k3, dtype, vec, stream (the
    # stride-1 4-tap FIR of ops/upfirdn.py; vec 16 / itemsize or 1)
    "cg_fir": (_P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _F, _F, _F, _F, _INT, _INT, _P),
    # x, b_conv (or null), mean, rstd, weight, bias, out, B, H, W, Cx, C, x's
    # strides b, h, w, the affine's row stride (C or 0), dtype, the affine's
    # dtype, vec, stream (BigGAN-deep's batch norm + ReLU of ops/norms.py)
    "cg_cond_bn_relu": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                        _I64, _I64, _I64, _INT, _INT, _INT, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    return build_root()


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (neither CUDA_HOME/bin/nvcc nor PATH); "
                       "the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libclip_glass_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile the kernels into the shared library (no-op when the library
    for these exact sources exists). Returns its path. Each run of nvcc
    counts in the tracer's `kernels.builds`."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            TRACER.count("kernels.builds")
        failures, log = [], []
        for cmd, _, p in procs:
            stdout, stderr = p.communicate()
            log.append(f"$ {' '.join(cmd)}\n{stdout}{stderr}")
            if p.returncode != 0:
                failures.append(log[-1])
        # ptxas' register, shared-memory and spill report of every kernel
        out.with_suffix(".log").write_text("\n".join(log))
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        tmp_lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
               *[obj for _, obj, _ in procs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        TRACER.count("kernels.builds")
        if res.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed:\n$ {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, out)  # atomic: concurrent builders agree
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; the lock guards only
    that first build and load, the span `kernels.load`, whose `built` says
    whether nvcc ran)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            with TRACER.span("kernels.load", built=not library_path().exists()):
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.cg_error_string.argtypes = [ctypes.c_int]
                lib.cg_error_string.restype = ctypes.c_char_p
                _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().cg_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {status} ({msg})")


# the current stream's handle as an int, without building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(t: torch.Tensor) -> int:
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


_get_device = getattr(torch._C, "_cuda_getDevice", None)
_CURRENT = contextlib.nullcontext()


def launch_device(t: torch.Tensor):
    """The wrappers' device guard: a context in which t's card is the
    current device, so that a launch runs where t's memory is (the kernels
    launch on the current device, with the stream of t's device). Costs one
    device query when that card is current already."""
    idx = t.device.index
    current = _get_device() if _get_device is not None else torch.cuda.current_device()
    return _CURRENT if idx is None or idx == current else torch.cuda.device(idx)


def require_cuda(name: str, *tensors: Optional[torch.Tensor],
                 dtype: torch.dtype) -> None:
    """Validate the CUDA-kernel arguments in one pass: one CUDA device, the
    kernel's dtype, contiguous (None entries are skipped). Raises on
    anything the kernel does not take."""
    dev = tensors[0].device
    ok = dtype in DTYPE_CODES and dev.type == "cuda"
    for t in tensors:
        if t is not None and not (t.dtype == dtype and t.device == dev
                                  and t.is_contiguous()):
            ok = False
    if not ok:
        _raise_invalid(name, [t for t in tensors if t is not None], dtype)


def _raise_invalid(name: str, tensors, dtype: torch.dtype) -> None:
    """The error for arguments that `require_cuda` refused."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, not on a CUDA device")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    raise AssertionError(f"{name}: refused arguments that pass every check")


def vector_width(dtype: torch.dtype, n_inner: int, *tensors: torch.Tensor) -> int:
    """Elements per 16-byte access when the inner extent and every pointer
    allow it, else 1."""
    vec = 16 // dtype.itemsize
    if n_inner % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


# ------------------------------------------------------------ gradients


def takes_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's plain version for `t`: a tensor
    on the CPU. A CUDA tensor launches the kernel or raises; a meta tensor
    takes the kernel's shape rule."""
    return t.device.type == "cpu"


def dispatch(x: torch.Tensor, launch, rule, plain, *args) -> torch.Tensor:
    """A wrapper's route for its first operand x: on the CPU `plain(*args)`;
    on a card the checked launch `launch(*args)` through `with_grad`; on
    `meta` the shape rule `rule(*args)`, the counterpart of a Pallas call's
    abstract evaluation, which allocates the kernel's output and nothing
    else. Under grad the rule goes through `_KernelGrad` as a launch does,
    so a meta tensor records the plain version's backward, but it is not
    counted in `with_grad.recorded`: it launches nothing."""
    if takes_plain(x):
        return plain(*args)
    if x.is_meta:
        return _KernelGrad.apply(rule, plain, *args) if grad_wanted(*args) else rule(*args)
    return with_grad(launch, plain, *args)


def grad_wanted(*args) -> bool:
    """Whether a call on `args` must record a gradient: grad mode is on and
    a tensor argument requires grad (never under `torch.no_grad()` or
    `torch.inference_mode()`)."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class _KernelGrad(torch.autograd.Function):
    """The forward launches the hand-written kernel; the backward is the
    gradient of its plain version, recomputed on the saved inputs on their
    device. The TPU kernels have no VJP either: the JAX package
    differentiates the lax ops of their plain counterparts.

    The plain version runs on views of the saved inputs themselves, made
    with grad mode on; the views keep each input's gradient a partial
    derivative where one input depends on another. Under `create_graph=True`
    the gradient it returns carries the graph of the plain version's
    backward, so a second derivative (R1, the path length penalty) goes
    through the plain version's autograd as JAX's goes through lax ops;
    under a plain `backward()` it carries none (a projector step costs the
    same as with detached copies: scripts/projector_step_cost.py)."""

    @staticmethod
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.args = [None if i in ctx.tensor_at else a for i, a in enumerate(args)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return launch(*args)

    @staticmethod
    def backward(ctx, grad_out):
        create_graph = torch.is_grad_enabled()
        args = list(ctx.args)
        wanted = [i for i in ctx.tensor_at if ctx.needs_input_grad[2 + i]]
        grads = [None] * len(args)
        if wanted and create_graph and not grad_out.is_meta:
            name = ctx.plain.__name__.removesuffix("_plain")
            with_grad.double[name] = with_grad.double.get(name, 0) + 1
        if wanted:
            with torch.enable_grad():
                for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
                    args[i] = t.view_as(t) if i in wanted else t
                out = ctx.plain(*args)
                found = torch.autograd.grad(out, [args[i] for i in wanted], grad_out,
                                            create_graph=create_graph, allow_unused=True)
            for i, g in zip(wanted, found):
                grads[i] = g
        return (None, None, *grads)


def with_grad(launch, plain, *args) -> torch.Tensor:
    """`launch(*args)`, the kernel's wrapper on checked CUDA operands; when a
    gradient is wanted (`grad_wanted`), through `_KernelGrad`, so that the
    result's gradient is that of `plain(*args)`, and counted in
    `with_grad.recorded` under the wrapper's name (`plain`'s less
    "_plain"). Otherwise the launch is direct and costs the host nothing
    more."""
    if grad_wanted(*args):
        name = plain.__name__.removesuffix("_plain")
        with_grad.recorded[name] = with_grad.recorded.get(name, 0) + 1
        return _KernelGrad.apply(launch, plain, *args)
    return launch(*args)


# launches that recorded a gradient, by kernel wrapper name
with_grad.recorded = {}
# backward passes of those that kept their graph (create_graph=True: the
# inner derivative of a second derivative), by kernel wrapper name; a meta
# tensor's shape rule launched nothing and counts in neither
with_grad.double = {}
