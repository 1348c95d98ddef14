#!/usr/bin/env python3
"""Pretrained-checkpoint validation harness of the PyTorch/CUDA port.

Pointed at a directory of the reference's checkpoints (the layout that
`scripts/download_weights.sh` writes), this runs, for every family found:

  1. the port's converter CLI (`python -m clip_glass_torch.weights.
     convert_weights`) with download_weights.sh's own arguments;
  2. numerical parity of the port's forward, on `--device`, against an
     independent implementation evaluated on the SAME file: the reference's
     torch modules (`--reference`) for CLIP, GPT-2 and the TF pickle; the
     transcribed HF module (tests/biggan_hf_oracle.py) for BigGAN-deep; a
     walk of the files' own state dicts in torch for LPIPS and Inception;
  3. a rendered artifact per model (images / text) in `--out`.

A check whose input file or reference tree is missing is a SKIP; a check
whose inputs are present FAILs on any error. The exit code is 1 if and only
if a check failed. The port runs on the card unless `--device cpu`; without
a card it raises. Matmuls and convolutions run in true fp32 (TF32 off)
while the harness runs.

Usage:
  python scripts/validate_pretrained_torch.py --weights-dir ./weights
  python scripts/validate_pretrained_torch.py --synthetic --device cpu --no-cli

`--synthetic` first writes download_weights.sh's tree at a small geometry
(`clip_glass_torch.weights.synthesize.write_layout`) into `--weights-dir`,
so the whole chain (files -> converter CLI -> loaders -> CLI) runs with no
download. `--geometry published` writes it at the published geometries
instead (about 3 GB; meant for the card).

`main(argv)` can be called in-process: `RESULTS` then holds one dict per
check (name, status, detail, seconds and the check's numbers).

Reference counterparts: download-weights.sh:1-41 (acquisition),
clip/clip.py:24-53 (sha256 gate); the JAX package's harness is
scripts/validate_pretrained.py.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# the torch-only oracles: biggan_hf_oracle, reference_oracle
sys.path.insert(1, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RESULTS = []        # one dict per check: name, status, detail, seconds, numbers
CONVERT_WORKERS = 4
CONVERT_TIMEOUT_S = 1200
BIGGAN_TOL = 2e-2
STYLEGAN2_TOL = 2e-2
GPT2_LOGITS_TOL = 5e-3
METRIC_TOL = 1e-4
CLIP_MIN_COSINE = 0.999


class Skip(Exception):
    pass


def record(name, status, detail="", seconds=0.0, **numbers):
    RESULTS.append({"name": name, "status": status, "detail": detail,
                    "seconds": seconds, **numbers})
    print(f"[{status:>4s}] {name}" + (f" — {detail}" if detail else "") +
          f" ({seconds:.2f} s)", flush=True)


def kernel_launches() -> dict:
    """The launch counters of the port's kernels 1-4, the FIR and BigGAN's
    batch norm (each wrapper counts the launches of its CUDA kernel; none
    on the CPU)."""
    from clip_glass_torch.ops import bias_act, modulated_conv, norms, s2d, upfirdn

    return {k.__name__: k.launches for k in (bias_act.noise_bias_lrelu, upfirdn.upsample2x,
                                             modulated_conv.modulated_matmul, s2d.s2d_conv2x2,
                                             upfirdn.fir, norms.cond_bn_relu)}


def check(name):
    """Decorator: run the check and record PASS / FAIL / SKIP. A check
    returns a detail string, or (detail, {number: value}), or raises Skip
    (an input absent) or anything else (FAIL). A PASS records the kernel
    launches the check made, where it made any."""
    def deco(fn):
        def run(*a, **k):
            t0, before = time.perf_counter(), kernel_launches()
            try:
                out = fn(*a, **k)
                detail, numbers = out if isinstance(out, tuple) else (out or "", {})
                launched = {n: c - before[n] for n, c in kernel_launches().items()
                            if c != before[n]}
                if launched:
                    numbers = {**numbers, "launches": launched}
                record(name, "PASS", detail, time.perf_counter() - t0, **numbers)
            except Skip as e:
                record(name, "SKIP", str(e), time.perf_counter() - t0)
            except Exception as e:
                traceback.print_exc()
                record(name, "FAIL", f"{type(e).__name__}: {e}", time.perf_counter() - t0)
        return run
    return deco


def require(ok, message: str) -> None:
    """A check's condition; fails the check (AssertionError) when false, also
    under `python -O`."""
    if not ok:
        raise AssertionError(message)


def need(path):
    if not os.path.exists(path):
        raise Skip(f"not found: {path}")
    return path


def need_reference(ref_dir):
    if not os.path.isdir(ref_dir):
        raise Skip(f"reference source not found at {ref_dir}")
    import reference_oracle
    reference_oracle.REFERENCE = ref_dir
    reference_oracle.add_reference_path()
    return reference_oracle


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach().double().cpu() - want.detach().double().cpu()).abs().max())


def save_images(imgs: torch.Tensor, path: str) -> None:
    """[-1, 1] NCHW images -> a jpg grid."""
    from clip_glass_torch.fitness.generator import biggan_norm, quantize_u8
    from clip_glass_torch.utils.image import save_grid

    save_grid(quantize_u8(biggan_norm(imgs)).cpu().numpy(), path)


# --------------------------------------------------------------------- CLIP

def _load_clip_sd(path):
    """State dict from either official container format: TorchScript archive
    or plain pickle (reference clip/clip.py:60-78 handles both)."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        return sd.state_dict() if hasattr(sd, "state_dict") else sd


def validate_clip(wdir, out, ref_dir, model_name, fname, dev, synthetic=False):
    @check(f"clip/{model_name}: sha256")
    def _sha(path):
        if synthetic:
            raise Skip("synthetic checkpoint (no official hash)")
        from clip_glass_torch.models.clip import api
        require(api.verify_checkpoint(path, model_name), "sha256 mismatch")
        return "official hash matched (reference clip/clip.py:45-53)"

    @check(f"clip/{model_name}: convert + torch parity")
    def _parity(path):
        need_reference(ref_dir)
        from clip.model import build_model

        from clip_glass_torch.core.dtypes import FP32, tree_to
        from clip_glass_torch.models.clip import model as tclip
        from clip_glass_torch.tokenizers import tokenize
        from clip_glass_torch.weights.load import load_clip

        params, cfg = load_clip(path)
        params = tree_to(params, dev)
        m = build_model(_load_clip_sd(path)).float().eval()   # fp32 oracle (jit=False path)

        rng = np.random.default_rng(0)
        imgs = rng.uniform(0, 1, (2, 3, cfg.image_resolution,
                                  cfg.image_resolution)).astype(np.float32)
        toks = np.asarray(tokenize(["a diagram", "a photo of a cat"]))
        with torch.no_grad():
            want_i = m.encode_image(torch.from_numpy(imgs)).numpy()
            want_t = m.encode_text(torch.from_numpy(toks.astype(np.int64))).numpy()
        with torch.inference_mode():
            got_i = tclip.encode_image(params, torch.from_numpy(imgs).to(dev), cfg, FP32)
            got_t = tclip.encode_text(params, torch.from_numpy(toks).to(dev), cfg, FP32)
        ci, ct = cos(got_i.cpu(), want_i), cos(got_t.cpu(), want_t)
        require(ci > CLIP_MIN_COSINE and ct > CLIP_MIN_COSINE, f"cosine image {ci}, text {ct}")
        return (f"embedding cosine: image {ci:.6f}, text {ct:.6f}",
                {"cosine_image": ci, "cosine_text": ct})

    path = os.path.join(wdir, "clip", fname)
    if not os.path.exists(path):
        record(f"clip/{model_name}", "SKIP", f"not found: {path}")
        return
    _sha(path)
    _parity(path)


# --------------------------------------------------------------------- GPT-2

@check("gpt2: convert + logits/decode parity")
def validate_gpt2(wdir, out, ref_dir, dev):
    path = need(os.path.join(wdir, "gpt2", "gpt2-pytorch_model.bin"))
    need_reference(ref_dir)
    from gpt2.config import GPT2Config as RefConfig
    from gpt2.model import GPT2LMHeadModel
    from gpt2.utils import load_weight

    from clip_glass_torch.core.dtypes import FP32, tree_to
    from clip_glass_torch.models.gpt2 import model as tg2
    from clip_glass_torch.tokenizers import get_gpt2_tokenizer
    from clip_glass_torch.weights import convert_gpt2, from_jax

    tree, cfg = convert_gpt2.load_torch_checkpoint(path)
    params = tree_to(from_jax.convert_gpt2(tree), dev)

    # the oracle's geometry from the inferred config (the identity for the
    # real 124M checkpoint; lets the synthetic files run the same code)
    m = GPT2LMHeadModel(RefConfig(n_embd=cfg.n_embd, n_layer=cfg.n_layer, n_head=cfg.n_head,
                                  n_positions=cfg.n_positions, n_ctx=cfg.n_positions))
    m = load_weight(m, torch.load(path, map_location="cpu"))
    m.eval()

    enc = get_gpt2_tokenizer()
    ids = np.asarray([enc.encode("The picture of a dog")], np.int64)
    with torch.no_grad():
        want, _ = m(torch.from_numpy(ids))
    ids_dev = torch.from_numpy(ids).to(dev)
    with torch.inference_mode():
        got = tg2.forward(params, ids_dev, cfg, policy=FP32)[0]
        got_seq = tg2.sample_sequence(params, ids_dev, 20, cfg, sample=False,
                                      policy=FP32)[0, ids.shape[1]:].cpu().tolist()
    err = max_abs(got, want)
    require(err < GPT2_LOGITS_TOL, f"logits max abs err {err}")

    # the 20-token argmax decode must match the reference's loop
    prev, past, outs = torch.from_numpy(ids), None, []
    with torch.no_grad():
        for _ in range(20):
            logits, past = m(prev, past=past)
            prev = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
            outs.append(int(prev))
    require(got_seq == outs, f"decode mismatch: {got_seq} vs {outs}")
    with open(os.path.join(out, "gpt2_decode.txt"), "w") as f:
        f.write(enc.decode(list(ids[0]) + outs) + "\n")
    return (f"logits max|Δ| {err:.2e}; 20-token argmax decode identical",
            {"max_abs_err": err})


# ----------------------------------------------------------------- StyleGAN2

def _ref_convert_from_tf():
    """The reference's convert_from_tf module, loaded as
    tests/test_tf_converter.py loads it (that file imports JAX)."""
    import importlib

    from reference_oracle import _stub, import_reference_stylegan2

    ref_models, _ = import_reference_stylegan2()
    try:
        import requests  # noqa: F401  (the real package, if installed)
    except ImportError:
        _stub("requests")
    sys.modules["stylegan2"].models = ref_models
    import stylegan2.utils as _u
    sys.modules["stylegan2"].utils = _u
    return importlib.import_module("stylegan2.convert_from_tf")


def _stylegan2_weights(sdir, pkl):
    """(G tree, cfg, noise planes) of the TF pickle, preferring the EMA
    generator Gs as the searches do, or of a converted Gs/G npz."""
    from clip_glass_torch.core import pytree
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.weights import convert_stylegan2_tf as tfc
    from clip_glass_torch.weights import from_jax
    from clip_glass_torch.weights.load import read_cfg_sidecar

    if os.path.exists(pkl):
        nets = tfc.convert_pkl(pkl)
        tree, cfg, noises = nets.get("Gs") or nets["G"]
        return from_jax.convert_generator(tree), cfg, from_jax.convert_noise(noises), noises
    stem = next((s for s in ("Gs", "G") if os.path.exists(os.path.join(sdir, f"{s}.npz"))),
                None)
    if stem is None:
        raise Skip(f"no {pkl} or Gs/G npz under {sdir}")
    cfg = read_cfg_sidecar(os.path.join(sdir, f"{stem}.npz"), sg2.SG2Config)
    if cfg is None:
        raise Skip(f"missing {stem}_cfg.json sidecar")
    tree = pytree.restore_lists(pytree.load_npz(os.path.join(sdir, f"{stem}.npz")))
    with np.load(os.path.join(sdir, f"{stem}_noise.npz")) as data:
        noises = [data[k] for k in sorted(data.files, key=int)]
    return from_jax.convert_generator(tree), cfg, from_jax.convert_noise(noises), noises


def validate_stylegan2(wdir, out, ref_dir, config, dev):
    sdir = os.path.join(wdir, "stylegan2", config)
    pkl = os.path.join(sdir, f"stylegan2-{config}.pkl")
    rendered = {}

    @check(f"stylegan2/{config}: TF convert + render")
    def _render():
        from clip_glass_torch.core.dtypes import FP32, tree_to
        from clip_glass_torch.models.stylegan2 import model as sg2

        need(sdir)
        g, cfg, noise, noises = _stylegan2_weights(sdir, pkl)
        rng = np.random.default_rng(11)
        z = rng.normal(size=(2, cfg.latent_size)).astype(np.float32)
        with torch.inference_mode():
            imgs = sg2.generator_apply(tree_to(g, dev), torch.from_numpy(z).to(dev), cfg,
                                       noise=tree_to(noise, dev), policy=FP32)
        require(torch.isfinite(imgs).all(), "non-finite image")
        save_images(imgs, os.path.join(out, f"stylegan2_{config}.jpg"))
        rendered.update(z=z, imgs=imgs, noises=noises)
        source = "the TF pickle" if os.path.exists(pkl) else "npz"
        return f"rendered {imgs.shape[-1]}px grid from {source}"

    @check(f"stylegan2/{config}: torch parity")
    def _parity():
        need(pkl)
        need_reference(ref_dir)
        if not rendered:
            raise AssertionError("the render failed")
        ref_tf = _ref_convert_from_tf()
        state = ref_tf.load_tf_models_file(pkl)
        gs = state[-1] if isinstance(state, (list, tuple)) else state
        G_t = ref_tf.convert_from_tf(gs).float().eval()
        G_t.static_noise(noise_tensors=[torch.from_numpy(np.asarray(n))[None, None]
                                        for n in rendered["noises"]])
        G_t.set_truncation(truncation_psi=1.0)
        with torch.no_grad():
            want = G_t(torch.from_numpy(rendered["z"]))
        err = max_abs(rendered["imgs"], want)
        require(err < STYLEGAN2_TOL, f"image max abs err {err}")
        return f"vs reference convert_from_tf max|Δ| {err:.2e}", {"max_abs_err": err}

    _render()
    _parity()


# -------------------------------------------------------------------- BigGAN

def validate_biggan(wdir, out, name, dev, auto=False):
    @check(f"biggan/{name}: convert + HF-oracle parity + render")
    def _run():
        path = need(os.path.join(wdir, "biggan", f"{name}-pytorch_model.bin"))
        import biggan_hf_oracle as oracle

        from clip_glass_torch.core.dtypes import FP32, tree_to
        from clip_glass_torch.models.biggan import model as bg
        from clip_glass_torch.weights import convert_biggan, from_jax

        # small synthetic files: "auto" reads the geometry off the shapes
        # (convert_biggan.infer_config)
        tree, cfg = convert_biggan.load_torch_checkpoint(path, "auto" if auto else name)
        params = tree_to(from_jax.convert_biggan(tree), dev)

        rng = np.random.default_rng(5)
        z = np.clip(rng.normal(size=(2, cfg.z_dim)), -2, 2).astype(np.float32)
        cls = np.zeros((2, cfg.num_classes), np.float32)
        # golden retriever, hen (clamped for small synthetic class tables)
        cls[0, min(207, cfg.num_classes - 1)] = 1.0
        cls[1, min(8, cfg.num_classes - 1)] = 1.0
        z_dev, cls_dev = torch.from_numpy(z).to(dev), torch.from_numpy(cls).to(dev)
        with torch.inference_mode():
            imgs = bg.apply(params, z_dev, cls_dev, 1.0, cfg, FP32)
        save_images(imgs, os.path.join(out, f"biggan_{name}.jpg"))

        # the transcribed HF implementation loaded with the same file, on
        # the same device
        m = oracle.build_oracle(torch.load(path, map_location="cpu", weights_only=False),
                                cfg).to(dev)
        with torch.no_grad():
            want = m(z_dev, cls_dev, 1.0)
        err = max_abs(imgs, want)
        require(err < BIGGAN_TOL, f"image max abs err {err}")
        return (f"rendered {imgs.shape[-1]}px grid; vs transcribed HF oracle max|Δ| {err:.2e}",
                {"max_abs_err": err, "resolution": int(imgs.shape[-1])})

    _run()


# ------------------------------------------------------------ metric models

@check("lpips/VGG16: convert + torch-oracle parity")
def validate_lpips(wdir, out, dev):
    """The LPIPS pair (torchvision's vgg16 zoo file + richzhang's v0.1 linear
    heads) through the converted npz and the port's forward, against torch
    walking the files' own state dicts (reference external_models/
    lpips.py:60-78)."""
    import torch.nn.functional as Fnn

    from clip_glass_torch.core.dtypes import tree_to
    from clip_glass_torch.metrics import lpips as tlp

    vgg = need(os.path.join(wdir, "metrics", "vgg16-397923af.pth"))
    lin = need(os.path.join(wdir, "metrics", "lpips_vgg_v0.1.pth"))
    npz = need(os.path.join(wdir, "metrics", "lpips_vgg16.npz"))
    params = tree_to(tlp.load_npz(npz), dev)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    x1 = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    a_dev, b_dev = torch.from_numpy(x0).to(dev), torch.from_numpy(x1).to(dev)
    with torch.inference_mode():
        got = tlp.lpips(params, a_dev, b_dev)
        same = tlp.lpips(params, a_dev, a_dev)
    require(torch.isfinite(got).all(), "non-finite distances")
    require((same.abs() < 1e-5).all(), f"self-distance nonzero: {same}")

    sd = torch.load(vgg, map_location="cpu", weights_only=False)
    heads = list(torch.load(lin, map_location="cpu", weights_only=False).values())
    shift = torch.tensor([-.030, -.088, -.188]).view(1, -1, 1, 1)
    scale = torch.tensor([.458, .448, .450]).view(1, -1, 1, 1)
    a = (torch.from_numpy(x0) - shift) / scale
    b = (torch.from_numpy(x1) - shift) / scale
    dist = torch.zeros(2)
    with torch.no_grad():
        for (conv_ids, pre_pool), head in zip(tlp._SLICES, heads):
            if pre_pool:
                a, b = Fnn.max_pool2d(a, 2, 2), Fnn.max_pool2d(b, 2, 2)
            for ci in conv_ids:
                w, bias = sd[f"features.{ci}.weight"], sd[f"features.{ci}.bias"]
                a = Fnn.relu(Fnn.conv2d(a, w, bias, padding=1))
                b = Fnn.relu(Fnn.conv2d(b, w, bias, padding=1))
            na = a * torch.rsqrt((a ** 2).sum(1, keepdim=True) + 1e-8)
            nb = b * torch.rsqrt((b ** 2).sum(1, keepdim=True) + 1e-8)
            sq = ((na - nb) ** 2).mean(dim=[-1, -2])
            dist = dist + (sq * head.view(1, -1)).sum(1)
    err = max_abs(got, dist)
    require(err < METRIC_TOL, f"lpips max abs err {err}")
    return f"self-distance 0, vs state-dict torch oracle max|Δ| {err:.2e}", {"max_abs_err": err}


@check("inception/pytorch-fid: convert + BN-fold parity + features")
def validate_inception(wdir, out, dev):
    """pytorch-fid's Inception through the converted npz and the port's
    whole-trunk features, with the stem conv + BN held against torch on the
    file's raw arrays (the converter's BN fold, eps 1e-3, reference
    external_models/inception.py:134-158)."""
    import torch.nn.functional as Fnn

    from clip_glass_torch.core.dtypes import tree_to
    from clip_glass_torch.metrics import inception as tinc

    pth = need(os.path.join(wdir, "metrics", "pt_inception-2015-12-05-6726825d.pth"))
    npz = need(os.path.join(wdir, "metrics", "inception.npz"))
    params = tree_to(tinc.load_npz(npz), dev)
    rng = np.random.default_rng(9)
    imgs = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with torch.inference_mode():
        feats = tinc.features(params, torch.from_numpy(imgs).to(dev))
    require(tuple(feats.shape) == (2, 2048), f"features shape {tuple(feats.shape)}")
    require(torch.isfinite(feats).all(), "non-finite features")

    sd = torch.load(pth, map_location="cpu", weights_only=False)
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, 33, 33)).astype(np.float32))
    with torch.no_grad():
        y = Fnn.conv2d(x, sd["Conv2d_1a_3x3.conv.weight"], stride=2)
        y = Fnn.batch_norm(y, sd["Conv2d_1a_3x3.bn.running_mean"],
                           sd["Conv2d_1a_3x3.bn.running_var"],
                           sd["Conv2d_1a_3x3.bn.weight"], sd["Conv2d_1a_3x3.bn.bias"],
                           eps=1e-3)
        want = Fnn.relu(y)
    with torch.inference_mode():
        got = tinc._conv_bn(x.to(dev), params["Conv2d_1a_3x3"], stride=2)
    err = max_abs(got, want)
    require(err < METRIC_TOL, f"stem conv+BN max abs err {err}")
    return (f"[2,2048] features finite; stem BN-fold vs torch max|Δ| {err:.2e}",
            {"max_abs_err": err})


# ------------------------------------------------------------ converter CLI

def convert_invocations(wdir, auto=False):
    """(label, argv, source) of every conversion download_weights.sh issues
    (download_weights.sh:102-174), with its arguments; `auto`: BigGAN's
    `--model-name auto` for files of a small geometry."""
    clip_dir, mdir = os.path.join(wdir, "clip"), os.path.join(wdir, "metrics")
    out = [(f"clip {name}", ["clip", os.path.join(clip_dir, f"{stem}.pt"),
                             os.path.join(clip_dir, f"{stem}.npz")],
            os.path.join(clip_dir, f"{stem}.pt"))
           for name, stem in (("ViT-B/32", "ViT-B-32"), ("RN50", "RN50"))]
    gpt2_bin = os.path.join(wdir, "gpt2", "gpt2-pytorch_model.bin")
    out.append(("gpt2", ["gpt2", gpt2_bin, os.path.join(wdir, "gpt2", "gpt2.npz")], gpt2_bin))
    for config in ("ffhq-config-f", "car-config-f", "church-config-f"):
        pkl = os.path.join(wdir, "stylegan2", config, f"stylegan2-{config}.pkl")
        out.append((f"stylegan2-tf {config}",
                    ["stylegan2-tf", pkl, os.path.join(wdir, "stylegan2", config)], pkl))
    for name in ("biggan-deep-256", "biggan-deep-512"):
        src = os.path.join(wdir, "biggan", f"{name}-pytorch_model.bin")
        out.append((f"biggan {name}",
                    ["biggan", src, os.path.join(wdir, "biggan", f"{name}.npz"),
                     "--model-name", "auto" if auto else name], src))
    vgg = os.path.join(mdir, "vgg16-397923af.pth")
    out.append(("lpips vgg16", ["lpips", vgg, os.path.join(mdir, "lpips_vgg16.npz"),
                                "--linear", os.path.join(mdir, "lpips_vgg_v0.1.pth")], vgg))
    pt = os.path.join(mdir, "pt_inception-2015-12-05-6726825d.pth")
    out.append(("inception pytorch-fid",
                ["inception", pt, os.path.join(mdir, "inception.npz")], pt))
    return out


def run_convert_cli(wdir, auto=False):
    """The port's converter CLI on every file present, CONVERT_WORKERS
    processes at a time; the checks are recorded in download_weights.sh's
    order."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}

    def convert(argv, src):
        """(rc, stdout, stderr, seconds), or None for a missing source."""
        if not os.path.exists(src):
            return None
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-m",
                                "clip_glass_torch.weights.convert_weights", *argv],
                               capture_output=True, text=True, timeout=CONVERT_TIMEOUT_S,
                               env=env, cwd=REPO)
        except subprocess.TimeoutExpired:
            return -1, "", f"timed out after {CONVERT_TIMEOUT_S} s", time.perf_counter() - t0
        return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0

    jobs = convert_invocations(wdir, auto)
    with ThreadPoolExecutor(CONVERT_WORKERS) as pool:
        runs = list(pool.map(lambda job: convert(job[1], job[2]), jobs))
    for (label, _, src), run in zip(jobs, runs):
        name = f"convert CLI: {label}"
        if run is None:
            record(name, "SKIP", f"not found: {src}")
            continue
        rc, out, err, seconds = run
        if rc:
            print(err[-2000:], file=sys.stderr)
            record(name, "FAIL", f"rc {rc}: {err[-800:]}", seconds)
        else:
            record(name, "PASS", (out.strip().splitlines() or ["ok"])[-1], seconds)


def run_cli_drive(wdir, out, device):
    """`clip_glass_torch.cli.main` (what run_torch.py runs) on the CONVERTED
    weights, in this process: one txt2img search (StyleGAN2_ffhq_d: G and D
    objectives, jpg artifacts) and one img2txt search (GPT2: caption
    artifacts), each asserting the reference's artifact set (reference
    run.py:79-125)."""
    from clip_glass_torch import cli

    def drive(label, argv, folder, artifacts):
        @check(f"CLI drive: {label}")
        def _run():
            try:
                rc = cli.main(argv + ["--generations", "4", "--save-each", "2",
                                      "--pop-size", "8", "--tmp-folder", folder,
                                      "--device", device])
            except SystemExit as e:   # the CLI's argument errors
                rc = e.code
            require(not rc, f"rc {rc}")
            missing = [a for a in artifacts if not os.path.exists(os.path.join(folder, a))]
            require(not missing, f"missing artifacts: {missing}")
            return f"artifacts complete under {folder}"
        _run()

    clip_npz = os.path.join(wdir, "clip", "ViT-B-32.npz")
    sg2_dir = os.path.join(wdir, "stylegan2", "ffhq-config-f")
    if os.path.exists(clip_npz) and os.path.exists(os.path.join(sg2_dir, "Gs.npz")):
        drive("StyleGAN2_ffhq_d txt2img",
              ["--config", "StyleGAN2_ffhq_d", "--target", "the face of a man",
               "--weights", sg2_dir, "--clip-weights", clip_npz],
              os.path.join(out, "cli_sg2"),
              ["genetic_result", "F.jpg", "ls_result.npz", "output.jpg", "genetic-it-final.jpg"])
    else:
        record("CLI drive: StyleGAN2_ffhq_d txt2img", "SKIP", "converted weights absent")

    gpt2_bin = os.path.join(wdir, "gpt2", "gpt2-pytorch_model.bin")
    demo = os.path.join(REPO, "examples", "gpt2_images")
    imgs = sorted(os.listdir(demo)) if os.path.isdir(demo) else []
    if os.path.exists(gpt2_bin) and os.path.exists(clip_npz) and imgs:
        drive("GPT2 img2txt",
              ["--config", "GPT2", "--target", os.path.join(demo, imgs[0]),
               "--weights", gpt2_bin, "--clip-weights", clip_npz],
              os.path.join(out, "cli_gpt2"),
              ["genetic_result", "ls_result.npz", "output.txt", "genetic-it-final.txt"])
    else:
        record("CLI drive: GPT2 img2txt", "SKIP", "converted weights or demo images absent")


# ---------------------------------------------------------------------- main

def build_parser():
    from clip_glass_torch.weights.synthesize import GEOMETRIES

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights-dir", default=os.path.join(REPO, "weights"))
    p.add_argument("--reference", default=None,
                   help="the reference's source tree, for the torch oracles "
                        "(default: tests/reference_oracle.py's REFERENCE)")
    p.add_argument("--out", default=os.path.join(REPO, "build", "validation_out"))
    p.add_argument("--synthetic", action="store_true",
                   help="write download_weights.sh's tree with random weights into "
                        "--weights-dir first, and run the whole chain on it")
    p.add_argument("--geometry", choices=GEOMETRIES, default="small",
                   help="--synthetic's geometry")
    p.add_argument("--no-cli", action="store_true", help="skip the end-to-end CLI drive")
    p.add_argument("--device", default="cuda",
                   help="where the port runs (default: the card; raises without one)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from clip_glass_torch.core.device import resolve_device

    if args.reference is None:
        import reference_oracle
        args.reference = reference_oracle.REFERENCE

    dev = resolve_device(args.device)
    RESULTS.clear()
    os.makedirs(args.out, exist_ok=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if args.synthetic:
            @check("synthesize reference-format checkpoints")
            def _synth():
                from clip_glass_torch.weights import synthesize

                paths = synthesize.write_layout(args.weights_dir, args.geometry)
                return f"{len(paths)} {args.geometry} checkpoints under {args.weights_dir}"
            _synth()

        # a small synthetic tree is no published variant: BigGAN reads "auto"
        auto = args.synthetic and args.geometry == "small"
        run_convert_cli(args.weights_dir, auto)
        validate_clip(args.weights_dir, args.out, args.reference, "ViT-B/32", "ViT-B-32.pt",
                      dev, synthetic=args.synthetic)
        validate_clip(args.weights_dir, args.out, args.reference, "RN50", "RN50.pt", dev,
                      synthetic=args.synthetic)
        validate_gpt2(args.weights_dir, args.out, args.reference, dev)
        for config in ("ffhq-config-f", "car-config-f", "church-config-f"):
            validate_stylegan2(args.weights_dir, args.out, args.reference, config, dev)
        for name in ("biggan-deep-256", "biggan-deep-512"):
            validate_biggan(args.weights_dir, args.out, name, dev, auto)
        validate_lpips(args.weights_dir, args.out, dev)
        validate_inception(args.weights_dir, args.out, dev)
        if not args.no_cli:
            run_cli_drive(args.weights_dir, args.out, args.device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    print("\n=== summary ===")
    counts = {"PASS": 0, "FAIL": 0, "SKIP": 0}
    for r in RESULTS:
        counts[r["status"]] += 1
        print(f"  {r['status']:>4s}  {r['name']}")
    print(f"{counts['PASS']} passed, {counts['FAIL']} failed, {counts['SKIP']} skipped")
    return 1 if counts["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
