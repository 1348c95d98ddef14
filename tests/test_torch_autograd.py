"""Gradients through the hand-written kernels' wrappers (ops/cuda.with_grad),
on the CPU.

On the card each of the five kernel wrappers (noise_bias_lrelu, upsample2x,
modulated_matmul, s2d_conv2x2, fir) records a gradient through
`cuda._KernelGrad` when grad mode is on and an input requires grad: the
forward launches the kernel, the backward is the gradient of the plain
version. Here there is no card, so the wrappers are driven down their CUDA
branch with `cuda.takes_plain` patched to False and the checked launch
patched to the plain version (`_*_cuda`), in float64:

- `torch.autograd.gradcheck` passes. The plain versions compute in fp32
  inside, so the finite differences take eps = 1e-2 with a relative
  tolerance of 1e-3: every function here is linear in each single input
  (the leaky ReLU piecewise, its inputs kept 0.3 or more from the kink), so
  a central difference of that size is exact but for fp32 rounding;
- the gradients equal plain autograd's bitwise (the backward is that
  autograd);
- under torch.no_grad() and torch.inference_mode() the wrapper launches
  directly and never enters the Function;
- a second derivative (create_graph) equals the plain version's, and
  `torch.autograd.gradgradcheck` passes;
- conv_s8 raises under grad, on the CPU as on the card.

Then the port's TINY StyleGAN2 G in the plain domain against the JAX
package: the gradient of sum(out * r) with respect to the latents, the
port's autograd (CPU, the plain versions) against jax.grad of
clip_glass_tpu's G (Pallas off, as its tests run it), fp32, inputs from
numpy with a seed; within 1e-4 of the gradient's scale, the forward's
tolerance in tests/test_torch_stylegan2.py.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch.core.dtypes import FP32
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.ops import bias_act, cuda, modulated_conv, quant, s2d, upfirdn
from clip_glass_torch.ops.conv_s8 import conv_s8
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, assert_close_scaled

D = torch.float64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the lane runs six test processes on the
    machine's cores, and these TINY computations gain nothing from more
    threads but lose much to their contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r(gen, *shape, scale=1.0, offset=0.0):
    return (offset + scale * torch.randn(shape, generator=gen, dtype=D))


def _nbl_args(gen):
    # |x + ns * noise + bias| >= 0.3: away from the leaky ReLU's kink
    sign = torch.where(torch.rand((2, 4, 5, 3), generator=gen) < 0.5, -1.0, 1.0).to(D)
    x = sign * (0.5 + torch.rand((2, 4, 5, 3), generator=gen, dtype=D))
    noise = _r(gen, 4, 5, scale=0.05)
    return x, noise, torch.tensor(0.7, dtype=D), _r(gen, 3, scale=0.05), 0.2, math.sqrt(2)


def _ups_args(gen):
    return _r(gen, 2, 4, 5, 3), (1, 3, 3, 1), 1.0


def _fir_args(gen, gain, pad0, pad1):
    return _r(gen, 2, 5, 6, 3), (1, 3, 3, 1), gain, pad0, pad1, 1


def _rgb_args(gen, modulated=True):
    style = _r(gen, 2, 4, scale=0.5, offset=1.0) if modulated else None
    demod = _r(gen, 2, 3, scale=0.2, offset=1.0) if modulated else None
    return _r(gen, 2, 6, 4), style, _r(gen, 4, 3, scale=0.5), demod, _r(gen, 3)


def _s2d_args(gen, pad0, modulated=True):
    style = _r(gen, 2, 4, scale=0.5, offset=1.0) if modulated else None
    demod = _r(gen, 2, 4, scale=0.2, offset=1.0) if modulated else None
    return _r(gen, 2, 5, 5, 4), _r(gen, 2, 2, 4, 4, scale=0.3), style, demod, pad0


# (wrapper, its module, the patched launch, plain version, operands)
CASES = {
    "noise_bias_lrelu": (bias_act.noise_bias_lrelu, bias_act, "_noise_bias_lrelu_cuda",
                         bias_act.noise_bias_lrelu_plain, _nbl_args),
    "upsample2x": (upfirdn.upsample2x, upfirdn, "_upsample2x_cuda", upfirdn.upsample2x_plain,
                   _ups_args),
    "modulated_matmul": (modulated_conv.modulated_matmul, modulated_conv,
                         "_modulated_matmul_cuda", modulated_conv.modulated_matmul_plain,
                         _rgb_args),
    "modulated_matmul_unmodulated": (
        modulated_conv.modulated_matmul, modulated_conv, "_modulated_matmul_cuda",
        modulated_conv.modulated_matmul_plain, lambda g: _rgb_args(g, modulated=False)),
    "s2d_conv2x2_pad1": (s2d.s2d_conv2x2, s2d, "_s2d_conv2x2_cuda", s2d.s2d_conv2x2_plain,
                         lambda g: _s2d_args(g, 1)),
    "s2d_conv2x2_pad0_shared": (s2d.s2d_conv2x2, s2d, "_s2d_conv2x2_cuda",
                                s2d.s2d_conv2x2_plain,
                                lambda g: _s2d_args(g, 0, modulated=False)),
    # G's up levels and D's down convs
    "fir_up": (upfirdn.fir, upfirdn, "_fir_cuda", upfirdn.fir_plain,
               lambda g: _fir_args(g, 4.0, 1, 1)),
    "fir_down": (upfirdn.fir, upfirdn, "_fir_cuda", upfirdn.fir_plain,
                 lambda g: _fir_args(g, 1.0, 2, 2)),
}


@pytest.fixture
def card_branch(monkeypatch):
    """The wrappers take their CUDA branch on CPU tensors, each launch being
    its plain version; returns the launches counted per patched launch and the
    Function's entries (key "function")."""
    launches = {"function": 0}
    monkeypatch.setattr(cuda, "takes_plain", lambda t: False)
    for _, module, launch, plain, _ in CASES.values():
        def stub(*args, plain=plain, launch=launch):
            launches[launch] = launches.get(launch, 0) + 1
            return plain(*args)
        monkeypatch.setattr(module, launch, stub)
    real = cuda._KernelGrad.apply

    def counted(*args):
        launches["function"] += 1
        return real(*args)
    monkeypatch.setattr(cuda._KernelGrad, "apply", counted)
    return launches


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_gradient_passes_gradcheck(card_branch, name):
    wrapper, _, _, _, make = CASES[name]
    args = make(torch.Generator().manual_seed(1))
    for t in _tensors(args):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda *a: wrapper(*a), args, eps=1e-2, atol=1e-5,
                                    rtol=1e-3)
    assert card_branch["function"] > 0 and card_branch[CASES[name][2]] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_gradient_equals_plain_autograd(card_branch, name):
    wrapper, _, _, plain, make = CASES[name]
    args = make(torch.Generator().manual_seed(2))
    tensors = _tensors(args)
    for t in tensors:
        t.requires_grad_(True)
    out = wrapper(*args)
    assert out.grad_fn is not None and card_branch["function"] == 1
    r = torch.randn(out.shape, generator=torch.Generator().manual_seed(3), dtype=D)
    got = torch.autograd.grad((out * r).sum(), tensors)
    want = torch.autograd.grad((plain(*args) * r).sum(), tensors)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_only_inputs_that_require_grad_get_one(card_branch, name):
    """The first operand alone requires grad: it gets plain autograd's
    gradient and the rest none."""
    wrapper, _, _, plain, make = CASES[name]
    args = make(torch.Generator().manual_seed(4))
    x = args[0].requires_grad_(True)
    out = wrapper(*args)
    (got,) = torch.autograd.grad(out.sum(), [x])
    (want,) = torch.autograd.grad(plain(*args).sum(), [x])
    assert torch.equal(got, want)
    assert all(t.grad is None for t in _tensors(args))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_requires_grad"])
@pytest.mark.parametrize("name", list(CASES))
def test_direct_launch_without_a_gradient(card_branch, name, mode):
    wrapper, _, _, plain, make = CASES[name]
    args = make(torch.Generator().manual_seed(5))
    if mode != "no_input_requires_grad":
        for t in _tensors(args):
            t.requires_grad_(True)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        mode, torch.enable_grad)
    with ctx():
        out = wrapper(*args)
    assert card_branch["function"] == 0 and card_branch[CASES[name][2]] == 1
    assert out.grad_fn is None
    assert torch.equal(out, plain(*args).detach())


def _second_derivative(fn, args, tensors, r):
    """d/dinputs of sum(g_i * v_i), g = d sum(fn(*args)^2 * r) / dinputs (a
    gradient that depends on the inputs, so that its own gradient is not 0
    for the functions linear in x), v_i seeded: the second derivative that
    R1 and the path length penalty take."""
    out = fn(*args)
    grads = torch.autograd.grad((out.square() * r).sum(), tensors, create_graph=True)
    gen = torch.Generator().manual_seed(9)
    total = sum((g * torch.randn(g.shape, generator=gen, dtype=D)).sum() for g in grads)
    return torch.autograd.grad(total, tensors, allow_unused=True)


@pytest.mark.parametrize("name", list(CASES))
def test_second_derivative_equals_the_plain_version(card_branch, name):
    """The Function is twice differentiable: under create_graph its backward
    is the plain version's autograd graph on the saved inputs, so a gradient
    of its gradient equals the plain version's, input by input, and the
    kernel still launches once. Within 1e-6 of the scale: the plain versions
    compute in fp32 inside, and the Function's graph adds the same terms in
    another order (5e-8 apart here)."""
    wrapper, _, launch, plain, make = CASES[name]
    args = make(torch.Generator().manual_seed(8))
    tensors = _tensors(args)
    for t in tensors:
        t.requires_grad_(True)
    r = torch.randn(plain(*args).shape, generator=torch.Generator().manual_seed(3), dtype=D)
    key = plain.__name__.removesuffix("_plain")
    kept = cuda.with_grad.double.get(key, 0)
    got = _second_derivative(wrapper, args, tensors, r)
    assert card_branch["function"] == 1 and card_branch[launch] == 1
    assert cuda.with_grad.double.get(key, 0) == kept + 1   # its backward kept the graph
    want = _second_derivative(plain, args, tensors, r)
    assert any(w is not None and w.abs().max() > 0 for w in want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None or not g.any()
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * w.abs().max().item())


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_passes_gradgradcheck(card_branch, name):
    """`torch.autograd.gradgradcheck` through the CUDA branch. The first
    gradient is linear in each single input too (the leaky ReLU's kink
    stays out of reach), so a central difference is exact at any step but
    for rounding: the step is 0.1, ten times gradcheck's, because the fp32
    rounding of a gradient, a sum of several products, divided by the step
    would pass 1e-5 at 1e-2 for kernel 4."""
    wrapper, _, _, _, make = CASES[name]
    args = make(torch.Generator().manual_seed(10))
    for t in _tensors(args):
        t.requires_grad_(True)
    assert torch.autograd.gradgradcheck(lambda *a: wrapper(*a), args, eps=1e-1, atol=1e-5,
                                        rtol=1e-3)
    assert card_branch["function"] > 0


def test_plain_backward_keeps_no_graph(card_branch):
    """Under a plain backward the gradient the Function returns has no
    graph, so a projector step builds none; under create_graph it has one,
    and the graph-keeping backward is counted."""
    wrapper, _, _, _, make = CASES["modulated_matmul"]
    args = make(torch.Generator().manual_seed(11))
    for t in _tensors(args):
        t.requires_grad_(True)
    x = args[0]
    (g,) = torch.autograd.grad(wrapper(*args).sum(), [x])
    assert g.grad_fn is None and not g.requires_grad
    kept = dict(cuda.with_grad.double)
    (g2,) = torch.autograd.grad(wrapper(*args).sum(), [x], create_graph=True)
    assert g2.requires_grad
    assert cuda.with_grad.double["modulated_matmul"] == kept.get("modulated_matmul", 0) + 1


def test_cpu_tensors_take_the_plain_version_with_its_gradient():
    """Unpatched, a CPU tensor takes the plain version, which PyTorch
    differentiates itself: no Function."""
    wrapper, _, _, plain, make = CASES["s2d_conv2x2_pad1"]
    args = make(torch.Generator().manual_seed(6))
    x = args[0].requires_grad_(True)
    out = wrapper(*args)
    assert type(out.grad_fn).__name__ != "_KernelGradBackward"
    (got,) = torch.autograd.grad(out.sum(), [x])
    (want,) = torch.autograd.grad(plain(*args).sum(), [x])
    assert torch.equal(got, want)


@pytest.mark.parametrize("x_dtype,grad_on", [(torch.float32, "x"), (torch.float32, "scale"),
                                             (torch.int8, "scale")])
def test_conv_s8_raises_under_grad(x_dtype, grad_on):
    gen = torch.Generator().manual_seed(7)
    wq = torch.randint(-127, 128, (4, 16, 3, 3), generator=gen).to(torch.int8)
    scale = torch.rand(4, generator=gen)
    if x_dtype == torch.int8:   # an int8 tensor cannot require grad
        x, inv = torch.randint(-127, 128, (1, 5, 5, 16), generator=gen).to(torch.int8), None
    else:
        x, inv = torch.randn((1, 5, 5, 16), generator=gen), quant.activation_inv_scale(3.0)
    (x if grad_on == "x" else scale).requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        conv_s8(x, wq, scale, pad0=1, pad1=1, x_inv_scale=inv)
    with torch.no_grad():
        assert conv_s8(x, wq, scale, pad0=1, pad1=1, x_inv_scale=inv).shape == (1, 5, 5, 4)
    with torch.inference_mode():
        assert conv_s8(x, wq, scale, pad0=1, pad1=1, x_inv_scale=inv).grad_fn is None


# ------------------------------------------------------------ TINY G vs jax.grad

TINY = jsg2.TINY
PORT_TINY_PLAIN = dataclasses.replace(tsg2.TINY, s2d_min_res=2 ** 30)


@pytest.fixture(scope="module")
def g_params():
    rng = np.random.default_rng(21)

    def perturb(path, leaf):   # random biases and noise scales (the init leaves them 0)
        key = getattr(path[-1], "key", None)
        if key in ("b", "noise_scale") and "style" not in str(path):
            return jnp.asarray(rng.normal(size=np.shape(leaf)).astype(np.float32) * 0.5)
        return leaf
    gp = jax.tree_util.tree_map_with_path(perturb, jsg2.generator_init(jax.random.PRNGKey(5),
                                                                       TINY))
    noise = [rng.normal(size=s).astype(np.float32) for s in TINY.noise_shapes()]
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"jg": gp, "jnoise": [jnp.asarray(n) for n in noise],
            "tg": from_jax.convert_generator(to_np(gp)),
            "tnoise": from_jax.convert_noise(noise)}


@pytest.mark.parametrize("per_layer", [False, True], ids=["one_latent", "per_layer"])
def test_tiny_generator_latent_gradient_matches_jax(g_params, per_layer):
    rng = np.random.default_rng(22 + per_layer)
    shape = (3, TINY.num_latents, TINY.latent_size) if per_layer else (3, TINY.latent_size)
    z = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=(3, 3, 16, 16)).astype(np.float32)

    def jloss(zz):
        out = jsg2.generator_apply(g_params["jg"], zz, TINY, noise=g_params["jnoise"],
                                   policy=JFP32, s2d=False)
        return (out * jnp.asarray(r)).sum()
    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(z)))
    zt = T(z).requires_grad_(True)
    out = tsg2.generator_apply(g_params["tg"], zt, PORT_TINY_PLAIN, noise=g_params["tnoise"],
                               policy=FP32)
    (got,) = torch.autograd.grad((out * T(r)).sum(), [zt])
    assert np.abs(want).max() > 0
    assert_close_scaled(N(got), want, 1e-4)
