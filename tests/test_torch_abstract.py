"""Memory from shapes alone (clip_glass_torch/core/memory.py,
weights="abstract", Trainer(abstract=True), parallel/dryrun.py) on the CPU.

- Every config but img2txt (whose host round trip reads values): the
  abstract `eval_population` at full size gives F's shape, as the JAX
  package's eval_shape does (tests/test_resize_and_configs.py:85-100), and
  at TINY sizes the real evaluation's shape and dtype.
- Each kernel wrapper's meta rule gives its plain version's shape and dtype
  at every call shape of a TINY evaluation (both StyleGAN2 domains and
  BigGAN; conv_s8 at its geometries), and never runs the plain version's
  forward.
- The tracker counts the same bytes on meta as on real CPU tensors,
  exactly: a TINY trainer step (both regularizers) and TINY evaluations.
- Trainer(abstract=True) holds the real trainer's state bytes and no data;
  on an abstract mesh of 4 it runs one rank's step with no process group
  (the counterpart of tests/test_training_distributed.py:117).
- dryrun_multichip(4) at TINY on the host; its full-size part is `slow`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from clip_glass_torch.config import get_config, list_configs
from clip_glass_torch.core import memory
from clip_glass_torch.core.dtypes import tree_leaves
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.biggan import model as tbg
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.ops import bias_act, conv_s8, cuda, modulated_conv, s2d, upfirdn
from clip_glass_torch.parallel import distributed as dist
from clip_glass_torch.parallel.dryrun import dryrun_multichip, fullsize_estimates
from clip_glass_torch.parallel.mesh import abstract_mesh, make_mesh
from clip_glass_torch.training.trainer import Trainer, TrainerConfig

META = torch.device("meta")
TINY_S2D = dataclasses.replace(tsg2.TINY, s2d_min_res=8)
TXT2IMG = [n for n in list_configs() if get_config(n).task == "txt2img"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_config(name, **kw):
    base = dict(weights="random:0", target="a red flower", compute_dtype="float32")
    if name.startswith("StyleGAN2"):
        base.update(pop_size=8, dim_z=32, n_var=32)
    else:
        base.update(pop_size=8, dim_z=16, num_classes=10, n_var=26, resolution=8)
    return get_config(name).replace(**{**base, **kw})


def _tiny_model(name):
    return tsg2.TINY if name.startswith("StyleGAN2") else tbg.TINY


def _problem(config, model_cfg, clip_weights="random:0"):
    return GenerationProblem(config, device="cpu", clip_cfg=tclip.TINY, model_cfg=model_cfg,
                             clip_weights=clip_weights)


def _X(config, device="cpu"):
    g = torch.Generator().manual_seed(0)
    X = torch.rand((config.pop_size, config.n_var), generator=g)
    return X.to(device)


# ------------------------------------------------------------ abstract evaluations

@pytest.mark.parametrize("name", TXT2IMG)
def test_abstract_evaluation_gives_F_shape(name):
    """Full size: F's shape from the configs alone, every tree on meta."""
    config = get_config(name).replace(weights="abstract", target="a shape check")
    gen = GenerationProblem(config, clip_weights="abstract").generator
    assert gen.abstract and all(t.is_meta for t in tree_leaves(gen.bundle))
    F = gen.eval_population(torch.empty((config.pop_size, config.n_var), device=META))
    assert F.is_meta and F.dtype == torch.float32
    assert tuple(F.shape) == (config.pop_size, config.n_obj)
    # at TINY sizes the real evaluation's shape and dtype
    tiny = _tiny_config(name)
    want = _problem(tiny, _tiny_model(name)).generator.eval_population(_X(tiny))
    got = _problem(tiny.replace(weights="abstract"), _tiny_model(name)).generator \
        .eval_population(_X(tiny, META))
    assert (got.shape, got.dtype) == (want.shape, want.dtype)


def test_abstract_refuses_what_needs_values():
    from test_torch_fitness import DOG

    config = get_config("GPT2").replace(weights="abstract", target=DOG, pop_size=4)
    from clip_glass_torch.models.gpt2 import model as tg2

    gen = GenerationProblem(config, clip_cfg=tclip.TINY, model_cfg=tg2.TINY,
                            clip_weights="abstract").generator
    with pytest.raises(NotImplementedError, match="round trip"):
        gen.eval_population(torch.empty((4, config.n_var), device=META))
    with pytest.raises(ValueError, match="abstract mesh"):
        GenerationProblem(_tiny_config("StyleGAN2_ffhq_d", weights="abstract"),
                          clip_cfg=tclip.TINY, model_cfg=tsg2.TINY, mesh=make_mesh(["cpu"]))


# ------------------------------------------------------------ meta rules

def _record_calls(monkeypatch, fn):
    """The (rule, plain, args) of every dispatch while fn() runs."""
    calls, real = [], cuda.dispatch

    def record(x, launch, rule, plain, *args):
        calls.append((rule, plain, args))
        return real(x, launch, rule, plain, *args)

    monkeypatch.setattr(cuda, "dispatch", record)
    fn()
    monkeypatch.setattr(cuda, "dispatch", real)
    return calls


def _to_meta(a):
    return a.to(META) if isinstance(a, torch.Tensor) else a


@pytest.mark.parametrize("case", ["stylegan2_plain", "stylegan2_s2d", "biggan"])
def test_meta_rules_match_the_plain_versions(monkeypatch, case):
    name = "DeepMindBigGAN256" if case == "biggan" else "StyleGAN2_ffhq_d"
    model_cfg = {"stylegan2_plain": tsg2.TINY, "stylegan2_s2d": TINY_S2D,
                 "biggan": dataclasses.replace(tbg.TINY, s2d_min_res=4)}[case]
    config = _tiny_config(name)
    gen = _problem(config, model_cfg).generator
    calls = _record_calls(monkeypatch, lambda: gen.eval_population(_X(config)))
    seen = set()
    for rule, plain, args in calls:
        want = plain(*args)
        got = rule(*map(_to_meta, args))
        assert got.is_meta and got.is_contiguous()
        assert (got.shape, got.dtype) == (want.shape, want.dtype), plain.__name__
        seen.add(plain.__name__)
    expected = {"stylegan2_plain": {"noise_bias_lrelu_plain", "upsample2x_plain",
                                    "modulated_matmul_plain"},
                "stylegan2_s2d": {"noise_bias_lrelu_plain", "modulated_matmul_plain",
                                  "s2d_conv2x2_plain"},
                "biggan": {"s2d_conv2x2_plain"}}[case]
    assert expected <= seen, seen


@pytest.mark.parametrize("geometry", [dict(stride=1, pad0=1, pad1=1, lhs_dilation=1),
                                      dict(stride=2, pad0=1, pad1=1, lhs_dilation=1),
                                      dict(stride=1, pad0=2, pad1=2, lhs_dilation=2)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_conv_s8_meta_rule_matches_the_plain_version(geometry, out_dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 5, 7, 16), generator=g)
    wq = torch.randint(-127, 128, (8, 16, 3, 3), generator=g, dtype=torch.int8)
    scale = torch.rand(8, generator=g)
    want = conv_s8.conv_s8(x, wq, scale, out_dtype=out_dtype, x_inv_scale=20.0, **geometry)
    got = conv_s8.conv_s8(x.to(META), wq.to(META), scale.to(META), out_dtype=out_dtype,
                          x_inv_scale=20.0, **geometry)
    assert got.is_meta and (got.shape, got.dtype) == (want.shape, want.dtype)


def _wrapper_cases():
    x4 = torch.randn(2, 4, 4, 8)
    return {
        "noise_bias_lrelu": (bias_act, bias_act.noise_bias_lrelu,
                             (x4, torch.randn(4, 4), torch.tensor(0.5), torch.randn(8))),
        "upsample2x": (upfirdn, upfirdn.upsample2x, (torch.randn(2, 4, 4, 3),)),
        "modulated_matmul": (modulated_conv, modulated_conv.modulated_matmul,
                             (torch.randn(2, 16, 8), torch.randn(2, 8), torch.randn(8, 3),
                              torch.randn(2, 3), torch.randn(3))),
        "s2d_conv2x2": (s2d, s2d.s2d_conv2x2, (x4, torch.randn(2, 2, 8, 8), torch.randn(2, 8),
                                               torch.randn(2, 8), 1)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_cases()))
@pytest.mark.parametrize("grad", [False, True])
def test_meta_never_runs_the_plain_forward(monkeypatch, name, grad):
    """On meta the wrapper allocates the kernel's output; under grad it goes
    through cuda._KernelGrad, whose backward is the plain version's."""
    module, wrapper, args = _wrapper_cases()[name]

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta")

    plain = getattr(module, f"{name}_plain")
    want = plain(*args)
    monkeypatch.setattr(module, f"{name}_plain", refuse)
    margs = [_to_meta(a) for a in args]
    if grad:
        margs[0].requires_grad_(True)
    with torch.set_grad_enabled(grad):
        out = wrapper(*margs)
    assert out.is_meta and (out.shape, out.dtype) == (want.shape, want.dtype)
    assert out.requires_grad == grad


# ------------------------------------------------------------ the tracker

def test_peak_memory_counts_live_storages():
    """Requested bytes, and the caching allocator's 512-byte blocks."""
    w = torch.empty(100, device=META)                      # from before the block
    with memory.PeakMemory() as m:
        aliases = (w.view(10, 10), w.to(torch.float32), w.detach(), w.add_(1))
        assert m.live == m.requested_live == 0              # nothing allocated
        del aliases
        a = torch.empty(1000, device=META)               # 4000 bytes, a 4096-byte block
        b = torch.empty(500, dtype=torch.bfloat16, device=META)     # 1000, 1024
        v = a[10:]                                          # a view: no new storage
        del a
        assert (m.requested_live, m.live) == (5000, 5120)   # the view keeps a alive
        del v
        c = b.float()                                       # 2000, 2048
    assert (m.requested_peak, m.requested_live) == (5000, 1000 + 2000)
    assert (m.peak, m.live) == (5120, 1024 + 2048)
    del b, c
    assert m.live == m.requested_live == 0
    tree = {"x": [torch.empty(3), torch.empty(2, dtype=torch.int8)]}
    assert memory.tree_bytes(tree, requested=True) == 14
    assert memory.tree_bytes(tree) == 2 * 512


@pytest.mark.parametrize("n,block", [(0, 0), (1, 512), (511, 512), (512, 512), (513, 1024),
                                     (4000, 4096), (2 ** 20 + 1, 2 ** 20 + 512)])
def test_allocator_bytes_rounds_to_the_caching_allocators_block(n, block):
    assert memory.allocator_bytes(n) == block
    with memory.PeakMemory() as m:
        t = torch.empty(n, dtype=torch.uint8, device=META)
    assert (m.requested_peak, m.peak) == (n, block)
    del t


def _peak(fn):
    with memory.PeakMemory() as m:
        fn()
    return m.peak


class _PlainAsKernels(memory.PeakMemory):
    """A PeakMemory under which a kernel wrapper's plain version on the CPU
    counts as its kernel does on the card and its meta rule on meta: its
    output alone (a copy where the output is a view of a larger buffer),
    its intermediates unseen, and under grad through cuda._KernelGrad,
    which saves the inputs as a launch does. The real-CPU side of the
    meta peak's equality."""

    def __init__(self, monkeypatch):
        super().__init__()
        self._inside = 0
        real = cuda.dispatch

        def dispatch(x, launch, rule, plain, *args):
            if not cuda.takes_plain(x):
                return real(x, launch, rule, plain, *args)
            kernel = self._as_kernel(plain)
            if cuda.grad_wanted(*args):
                return cuda._KernelGrad.apply(kernel, plain, *args)
            return kernel(*args)

        monkeypatch.setattr(cuda, "dispatch", dispatch)

    def _as_kernel(self, fn):
        def run(*args):
            self._inside += 1
            try:
                out = fn(*args)
                if out.untyped_storage().nbytes() != out.numel() * out.element_size():
                    out = out.clone()
            finally:
                self._inside -= 1
            self.track(out)
            return out

        run.__name__ = fn.__name__
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._inside:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _peak_as_kernels(monkeypatch, fn):
    with _PlainAsKernels(monkeypatch) as m:
        fn()
    return m.peak


@pytest.mark.parametrize("case", ["stylegan2_d_plain", "stylegan2_d_s2d", "biggan"])
def test_tracker_meta_peak_equals_real_cpu_peak_evaluation(monkeypatch, case):
    name = "DeepMindBigGAN256" if case == "biggan" else "StyleGAN2_ffhq_d"
    model_cfg = {"stylegan2_d_plain": tsg2.TINY, "stylegan2_d_s2d": TINY_S2D,
                 "biggan": tbg.TINY}[case]
    config = _tiny_config(name)
    real = _problem(config, model_cfg).generator
    abstract = _problem(config.replace(weights="abstract"), model_cfg).generator
    assert memory.tree_bytes(real.bundle) == memory.tree_bytes(abstract.bundle)
    # a first evaluation each fills the per-device caches of constants
    # (core.device.constant), which another test may have filled already
    real.eval_population(_X(config))
    abstract.eval_population(_X(config, META))
    want = _peak_as_kernels(monkeypatch, lambda: real.eval_population(_X(config)))
    got = _peak(lambda: abstract.eval_population(_X(config, META)))
    assert got == want > 0


def _reals(batch, device="cpu"):
    r = tsg2.TINY.resolution
    x = torch.rand((batch, 3, r, r), generator=torch.Generator().manual_seed(2)) * 2 - 1
    return x.to(device)


def test_tracker_meta_peak_equals_real_cpu_peak_trainer_step(monkeypatch):
    """Step 0: the D phase with R1 and the G phase with the path length
    penalty (their second derivatives through cuda._KernelGrad on both)."""
    cfg = TrainerConfig(batch_size=4, checkpoint_every=0)
    for device in ("cpu", META):   # fill the per-device caches of constants first
        Trainer(tsg2.TINY, cfg, device="cpu", abstract=device == META).train_step(
            _reals(4, device))
    real, abstract = Trainer(tsg2.TINY, cfg, device="cpu"), Trainer(tsg2.TINY, cfg, abstract=True)
    want = _peak_as_kernels(monkeypatch, lambda: real.train_step(_reals(4)))
    got = _peak(lambda: abstract.train_step(_reals(4, META)))
    assert got == want > 0


def test_meta_rules_under_grad_count_no_launch():
    """An abstract trainer step records the plain versions' backward
    through cuda._KernelGrad, and launches nothing: with_grad.recorded,
    the card's count of launches that recorded a gradient, stays as it
    was."""
    cfg = TrainerConfig(batch_size=4, checkpoint_every=0)
    before = (dict(cuda.with_grad.recorded), dict(cuda.with_grad.double))
    logs = Trainer(tsg2.TINY, cfg, abstract=True).train_step(_reals(4, META))
    assert logs and all(v.is_meta for v in logs.values())
    assert (cuda.with_grad.recorded, cuda.with_grad.double) == before


def test_abstract_trainer_state_is_the_real_ones_in_shapes_alone():
    cfg = TrainerConfig(batch_size=4, checkpoint_every=0)
    real, abstract = Trainer(tsg2.TINY, cfg, device="cpu"), Trainer(tsg2.TINY, cfg, abstract=True)
    st = abstract.state
    assert st.key is None and all(t.is_meta for t in tree_leaves(
        [st.g_params, st.d_params, st.gs_params, st.g_opt.mu, st.d_opt.nu, st.pl_avg]))
    assert memory.tree_bytes(list(st[:6])) == memory.tree_bytes(list(real.state[:6])) > 0
    for a, b in zip(tree_leaves(list(st[:6])), tree_leaves(list(real.state[:6]))):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


def test_abstract_mesh_of_four_needs_no_process_group():
    """One rank of four: its batch / 4 rows, D's minibatch-std gather and the
    gradients' all_reduce allocate their outputs and move nothing."""
    assert not torch.distributed.is_initialized()
    cfg = TrainerConfig(batch_size=8, checkpoint_every=0)
    mesh = abstract_mesh(4)
    tr = Trainer(tsg2.TINY, cfg, mesh=mesh, abstract=True)
    assert tr.world == 4 and dist.world_size() == 1
    with memory.PeakMemory() as m:
        logs = tr.train_step(_reals(2, META))
    assert all(v.is_meta and v.shape == () for v in logs.values())
    one = _peak(lambda: Trainer(tsg2.TINY, cfg, abstract=True).train_step(_reals(8, META)))
    assert 0 < m.peak < one
    with pytest.raises(ValueError, match="abstract mesh"):
        Trainer(tsg2.TINY, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="1-D mesh"):
        Trainer(tsg2.TINY, cfg, mesh=abstract_mesh(4, 2), abstract=True)


def test_abstract_evaluation_on_a_2d_mesh_holds_a_clip_shard():
    """One rank of a (2, 2) abstract mesh: half of each CLIP block, half
    the rows of G and D, F whole."""
    config = _tiny_config("StyleGAN2_ffhq_d", weights="abstract")
    one = _problem(config, tsg2.TINY).generator
    rank = GenerationProblem(config, clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
                             mesh=abstract_mesh(4, 2)).generator
    assert memory.tree_bytes(rank.bundle) < memory.tree_bytes(one.bundle)
    F = rank.eval_population(_X(config, META))
    assert tuple(F.shape) == (config.pop_size, 2)


# ------------------------------------------------------------ the dry run

def test_dryrun_multichip_tiny_on_the_host():
    out = dryrun_multichip(4, budget_bytes=2 ** 40, device="cpu", full_size=False)
    assert out["mesh"] == {"pop": 2, "model": 2}
    assert set(out["live"]) == {"nsga2_step", "StyleGAN2_ffhq_d", "biggan_mixed_genome",
                                "gpt2_img2txt", "microbatch", "batched", "serving"}
    with pytest.raises(ValueError, match="budget_bytes"):
        if not torch.cuda.is_available():
            dryrun_multichip(4, device="cpu", full_size=False)
        else:
            raise ValueError("budget_bytes")


@pytest.mark.slow
def test_dryrun_multichip_full_size_estimates():
    """The full-size part: each rank's bytes below a budget, and the (2, 2)
    mesh's flagship rank holds less than the one process's."""
    est = fullsize_estimates(4)
    assert est["mesh"] == {"pop": 2, "model": 2}
    for k, v in est.items():
        if k != "mesh":
            assert 0 < v["resident"] < v["total"], k
    with pytest.raises(AssertionError, match="over the budget"):
        dryrun_multichip(4, budget_bytes=2 ** 30, device="cpu")
    assert np.isfinite(est["flagship_pop16_bf16"]["total"])


def test_estimates_add_the_workspace_margin_in_allocator_blocks():
    """An estimate's total is its blocks (resident and work peak, multiples
    of 512) plus the workspace margin of its kind of work."""
    from clip_glass_torch.parallel import dryrun

    est = dryrun.evaluation_bytes(_tiny_config("StyleGAN2_ffhq_d"), clip_cfg=tclip.TINY,
                                  model_cfg=tsg2.TINY)
    assert est["workspace"] == dryrun.WORKSPACE_BYTES["evaluation"]
    assert est["total"] == est["resident"] + est["work_peak"] + est["workspace"]
    assert est["resident"] % memory.ALLOCATOR_BLOCK == est["work_peak"] % 512 == 0
    assert 0 < est["requested"] <= est["resident"] + est["work_peak"]
    step = dryrun.train_step_bytes(tsg2.TINY, 4)
    assert step["workspace"] == dryrun.WORKSPACE_BYTES["train_step"]
    assert step["total"] == step["resident"] + step["work_peak"] + step["workspace"]


@pytest.mark.parametrize("total,refused", [(99, False), (100, True), (101, True)])
def test_dryrun_multichip_refuses_a_rank_over_budget(monkeypatch, total, refused):
    """A rank whose estimate (workspace margin included) reaches the budget
    is refused; one just under it passes."""
    from clip_glass_torch.parallel import dryrun

    fake = {"mesh": {"pop": 2, "model": 2},
            "flagship_pop16_bf16": {"total": 10},
            "train_config_f_batch8_fp32": {"total": total}}
    monkeypatch.setattr(dryrun, "live_checks", lambda mesh, device: {})
    monkeypatch.setattr(dryrun, "fullsize_estimates", lambda n: fake)
    if refused:
        with pytest.raises(AssertionError, match="over the budget of 100 bytes"):
            dryrun.dryrun_multichip(4, budget_bytes=100, device="cpu")
    else:
        assert dryrun.dryrun_multichip(4, budget_bytes=100, device="cpu")["fullsize"] == fake
