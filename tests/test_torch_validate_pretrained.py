"""scripts/validate_pretrained_torch.py, the port's pretrained-checkpoint
harness, in-process on the CPU at the small geometry.

`--synthetic` writes download_weights.sh's tree (weights/synthesize.py's
`write_layout`), the port's converter CLI converts every file, and the
checks hold the port's forwards against independent torch code on the same
files: BigGAN-deep against the transcribed HF module, LPIPS and Inception
against their state dicts. Without the reference's source tree its CLIP,
GPT-2 and TF-pickle parity checks SKIP; nothing else may. A perturbed port
output FAILs with exit code 1, and the port's BigGAN render of a synthetic
file equals the JAX package's on the same file (tests/test_torch_biggan.py's
tolerance, rtol = atol = 2e-4).
"""

import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.models.biggan import model as jbg
from clip_glass_tpu.weights import convert_biggan as jconvert_biggan

from clip_glass_torch.models.biggan import model as bg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
REFERENCE_CHECKS = ("clip/ViT-B/32: convert + torch parity", "clip/RN50: convert + torch parity",
                    "gpt2: convert + logits/decode parity",
                    *(f"stylegan2/{c}-config-f: torch parity" for c in ("ffhq", "car", "church")))
MUST_PASS = ("synthesize reference-format checkpoints",
             *(f"convert CLI: {x}" for x in (
                 "clip ViT-B/32", "clip RN50", "gpt2", "stylegan2-tf ffhq-config-f",
                 "stylegan2-tf car-config-f", "stylegan2-tf church-config-f",
                 "biggan biggan-deep-256", "biggan biggan-deep-512", "lpips vgg16",
                 "inception pytorch-fid")),
             *(f"stylegan2/{c}-config-f: TF convert + render" for c in ("ffhq", "car", "church")),
             "biggan/biggan-deep-256: convert + HF-oracle parity + render",
             "biggan/biggan-deep-512: convert + HF-oracle parity + render",
             "lpips/VGG16: convert + torch-oracle parity",
             "inception/pytorch-fid: convert + BN-fold parity + features")


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "validate_pretrained_torch", os.path.join(ROOT, "scripts", "validate_pretrained_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harness():
    return _load_script()


@pytest.fixture(scope="module")
def synthetic(harness, tmp_path_factory):
    """One `--synthetic --device cpu --no-cli` run: its exit code, its
    results, its weights directory and a missing reference tree."""
    root = tmp_path_factory.mktemp("vp")
    missing = str(root / "no-reference")
    rc = harness.main(["--synthetic", "--device", "cpu", "--no-cli", "--weights-dir",
                       str(root / "w"), "--out", str(root / "out"), "--reference", missing])
    return rc, list(harness.RESULTS), str(root / "w"), missing


def _status(results):
    return {r["name"]: r for r in results}


def test_synthetic_run_passes_all_but_the_reference_checks(synthetic):
    rc, results, _, missing = synthetic
    by = _status(results)
    assert rc == 0, [r for r in results if r["status"] == "FAIL"]
    for name in MUST_PASS:
        assert by[name]["status"] == "PASS", by[name]
    for name in REFERENCE_CHECKS:
        assert by[name]["status"] == "SKIP", by[name]
        assert by[name]["detail"] == f"reference source not found at {missing}", by[name]
    for model in ("ViT-B/32", "RN50"):
        assert by[f"clip/{model}: sha256"]["status"] == "SKIP"
    assert set(by) == set(MUST_PASS) | set(REFERENCE_CHECKS) | {
        "clip/ViT-B/32: sha256", "clip/RN50: sha256"}
    for name in ("biggan/biggan-deep-256: convert + HF-oracle parity + render",
                 "lpips/VGG16: convert + torch-oracle parity"):
        assert 0 <= by[name]["max_abs_err"] < 1e-4, by[name]
    assert all(r["seconds"] >= 0 for r in results)


def test_perturbed_port_output_fails(synthetic, harness, monkeypatch, tmp_path):
    """BigGAN's port output shifted by 1: both BigGAN checks FAIL, the rest
    still pass, and the exit code is 1."""
    missing = synthetic[3]
    apply = bg.apply
    monkeypatch.setattr(bg, "apply", lambda *a, **k: apply(*a, **k) + 1)
    rc = harness.main(["--device", "cpu", "--no-cli", "--synthetic", "--weights-dir",
                       str(tmp_path / "w"), "--out", str(tmp_path / "out"),
                       "--reference", missing])
    by = _status(harness.RESULTS)
    assert rc == 1
    for name in ("biggan-deep-256", "biggan-deep-512"):
        r = by[f"biggan/{name}: convert + HF-oracle parity + render"]
        assert r["status"] == "FAIL" and "image max abs err" in r["detail"], r
    assert by["lpips/VGG16: convert + torch-oracle parity"]["status"] == "PASS"


def test_biggan_render_equals_the_jax_package(synthetic, harness, monkeypatch, tmp_path):
    """The port's render of the synthetic biggan-deep-256 file, as the harness
    computes it, against the JAX package's bg.apply on the same file converted
    by the JAX converter, fp32."""
    wdir = synthetic[2]
    seen = []
    apply = bg.apply

    def recording(params, z, cls, trunc, cfg, policy):
        out = apply(params, z, cls, trunc, cfg, policy)
        seen.append((z.numpy(), cls.numpy(), trunc, out.numpy()))
        return out

    monkeypatch.setattr(bg, "apply", recording)
    harness.validate_biggan(wdir, str(tmp_path), "biggan-deep-256", torch.device("cpu"),
                            auto=True)
    assert harness.RESULTS[-1]["status"] == "PASS", harness.RESULTS[-1]
    (z, cls, trunc, got), = seen
    params, cfg = jconvert_biggan.load_torch_checkpoint(
        os.path.join(wdir, "biggan", "biggan-deep-256-pytorch_model.bin"), "auto")
    want = np.asarray(jbg.apply(params, jnp.asarray(z), jnp.asarray(cls), trunc, cfg, JFP32))
    assert got.shape == want.shape == (2, 3, cfg.output_dim, cfg.output_dim)
    np.testing.assert_allclose(got, want, **TOL)


def test_cli_drive_writes_the_artifact_sets(synthetic, harness, tmp_path):
    """The CLI drive on the converted small files: StyleGAN2_ffhq_d and GPT2
    at pop 8 for 4 generations, each with the reference's artifact set."""
    wdir = synthetic[2]
    harness.RESULTS.clear()
    harness.run_cli_drive(wdir, str(tmp_path), "cpu")
    by = _status(harness.RESULTS)
    for name in ("CLI drive: StyleGAN2_ffhq_d txt2img", "CLI drive: GPT2 img2txt"):
        assert by[name]["status"] == "PASS", by[name]
    assert os.path.exists(tmp_path / "cli_gpt2" / "output.txt")


def test_missing_card_raises(harness, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--no-cli"])


def test_missing_files_skip(harness, tmp_path):
    """An empty weights directory: every check SKIPs, the exit code is 0."""
    rc = harness.main(["--device", "cpu", "--weights-dir", str(tmp_path / "none"),
                       "--out", str(tmp_path / "out"), "--reference", str(tmp_path / "r")])
    assert rc == 0
    assert {r["status"] for r in harness.RESULTS} == {"SKIP"}
